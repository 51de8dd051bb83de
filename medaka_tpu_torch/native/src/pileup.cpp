// Pileup count accumulation (host side), copied from
// medaka_tpu/native/src/pileup.cpp for medaka_tpu_torch.
//
// Native equivalent of the reference's C kernel
// (src/medaka_counts.c:199-372): walks reads' CIGARs and accumulates
// per-column base counts, including insertion (minor) columns and
// strand-split deletion channels. The Python featurizer
// (medaka_tpu/features.py:pileup_counts) prepares flat read arrays and
// post-processes (normalisation, sym_indels) — this kernel is only the
// O(reads x bases) accumulation loop.
//
// Channel layout per column: featlen(10) * num_dtypes * num_qstrat with
// base channels from the nt16 LUT (acgtACGTdD order as in
// medaka_counts.h:19-30).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

const int FEATLEN = 10;
const int FWD_DEL = 9;
const int REV_DEL = 8;

// nt16 (+16 reverse) -> channel, mirroring common.py NT16_TO_CHANNEL
int8_t NT16_CHAN[32];
struct LutInit {
    LutInit() {
        memset(NT16_CHAN, -1, sizeof NT16_CHAN);
        // A C G T -> fwd channels 4..7 (upper case), rev 0..3 (lower)
        const int codes[4] = {1, 2, 4, 8};
        for (int i = 0; i < 4; ++i) {
            NT16_CHAN[codes[i]] = 4 + i;
            NT16_CHAN[16 + codes[i]] = i;
        }
    }
} lut_init_;

// cigar op consumption tables (op ids as in BAM)
inline bool consumes_q(int op) {
    return op == 0 || op == 1 || op == 4 || op == 7 || op == 8;
}
inline bool consumes_r(int op) {
    return op == 0 || op == 2 || op == 3 || op == 7 || op == 8;
}
inline bool is_aligned(int op) { return op == 0 || op == 7 || op == 8; }

}  // namespace


extern "C" {

// Release arrays this library returned (malloc'd).
void mt_free(void* p) { free(p); }

// Same as mt_pileup_counts but consuming raw BAM record bytes (layout
// as stored in the BAM body, without the leading block_size field):
// fixed 32-byte header, then read_name, packed cigar, 4-bit packed
// seq, quals. This skips the Python-side per-record array creation.
int mt_pileup_counts_raw(
        int n_reads,
        const uint8_t* records,     // concatenated raw records
        const int64_t* rec_off,     // n_reads+1 offsets
        const int32_t* read_dtype,  // datatype index per read
        int64_t start, int64_t end,
        int num_dtypes, int num_qstrat,
        int32_t** counts_out, int64_t** majors_out, int64_t** minors_out,
        int64_t* n_cols_out) {
    const int64_t span = end - start;
    if (span <= 0) return 1;
    const int col_feat = FEATLEN * num_dtypes * num_qstrat;

    struct View {
        int64_t pos;
        bool rev;
        // cigar words sit at an odd offset inside the BAM record buffer
        // (32 + l_read_name), so they must be read unaligned
        const uint8_t* cigar;
        int n_cigar;
        const uint8_t* seq;   // packed nt16
        const uint8_t* qual;
        int l_seq;
    };
    std::vector<View> views(n_reads);
    for (int r = 0; r < n_reads; ++r) {
        const uint8_t* p = records + rec_off[r];
        View& v = views[r];
        int32_t pos;
        memcpy(&pos, p + 4, 4);
        v.pos = pos;
        uint8_t l_read_name = p[8];
        uint16_t n_cigar;
        memcpy(&n_cigar, p + 12, 2);
        uint16_t flag;
        memcpy(&flag, p + 14, 2);
        uint32_t l_seq;
        memcpy(&l_seq, p + 16, 4);
        v.rev = flag & 16;
        v.n_cigar = n_cigar;
        v.l_seq = (int)l_seq;
        const uint8_t* q = p + 32 + l_read_name;
        v.cigar = q;
        q += 4 * n_cigar;
        v.seq = q;
        q += (l_seq + 1) / 2;
        v.qual = q;
    }

    // phase 1: coverage and max insertion
    std::vector<int32_t> cover(span + 1, 0);
    std::vector<int64_t> max_ins(span, 0);
    for (int r = 0; r < n_reads; ++r) {
        const View& v = views[r];
        int64_t ref_end = v.pos;
        for (int ci = 0; ci < v.n_cigar; ++ci) {
            uint32_t c;
            memcpy(&c, v.cigar + 4 * (size_t)ci, 4);
            int op = c & 0xf;
            int64_t len = c >> 4;
            if (op == 1) {
                int64_t anchor = ref_end - 1;
                if (anchor >= v.pos && anchor >= start && anchor < end)
                    max_ins[anchor - start] =
                        std::max(max_ins[anchor - start], len);
            }
            if (consumes_r(op)) ref_end += len;
        }
        int64_t cs = std::max(v.pos, start);
        int64_t ce = std::min(ref_end, end);
        if (ce > cs) {
            cover[cs - start] += 1;
            cover[ce - start] -= 1;
        }
    }
    std::vector<int64_t> col_of_pos(span, -1);
    int64_t n_cols = 0, running = 0;
    std::vector<int64_t> cov_pos;
    for (int64_t p = 0; p < span; ++p) {
        running += cover[p];
        if (running > 0) {
            col_of_pos[p] = n_cols;
            cov_pos.push_back(p);
            n_cols += 1 + max_ins[p];
        }
    }
    if (n_cols == 0) {
        *counts_out = nullptr; *majors_out = nullptr;
        *minors_out = nullptr; *n_cols_out = 0;
        return 0;
    }
    int32_t* counts = (int32_t*)calloc(n_cols * col_feat, sizeof(int32_t));
    int64_t* majors = (int64_t*)malloc(n_cols * sizeof(int64_t));
    int64_t* minors = (int64_t*)malloc(n_cols * sizeof(int64_t));
    if (!counts || !majors || !minors) {
        free(counts); free(majors); free(minors);
        return 1;
    }
    for (int64_t p : cov_pos) {
        int64_t c0 = col_of_pos[p];
        for (int64_t m = 0; m <= max_ins[p]; ++m) {
            majors[c0 + m] = start + p;
            minors[c0 + m] = m;
        }
    }

    // phase 2
    auto seq_at = [](const uint8_t* seq, int64_t i) -> int {
        uint8_t b = seq[i >> 1];
        return (i & 1) ? (b & 0xf) : (b >> 4);
    };
    for (int r = 0; r < n_reads; ++r) {
        const View& v = views[r];
        const int strand16 = v.rev ? 16 : 0;
        const int del_chan = v.rev ? REV_DEL : FWD_DEL;
        const int dtype_off = FEATLEN * read_dtype[r] * num_qstrat;
        int64_t ref_pos = v.pos;
        int64_t q = 0;
        for (int ci = 0; ci < v.n_cigar; ++ci) {
            uint32_t c;
            memcpy(&c, v.cigar + 4 * (size_t)ci, 4);
            int op = c & 0xf;
            int64_t len = c >> 4;
            if (is_aligned(op)) {
                int64_t lo = std::max(ref_pos, start);
                int64_t hi = std::min(ref_pos + len, end);
                for (int64_t p = lo; p < hi; ++p) {
                    int chan = NT16_CHAN[
                        seq_at(v.seq, q + (p - ref_pos)) + strand16];
                    if (chan < 0) continue;
                    int qs = 0;
                    if (num_qstrat > 1) {
                        int qq = v.qual[q + (p - ref_pos)];
                        if (qq == 0xff) qq = 0;
                        qs = std::max(0, std::min(qq, num_qstrat) - 1);
                    }
                    counts[col_of_pos[p - start] * col_feat + dtype_off
                           + FEATLEN * qs + chan] += 1;
                }
            } else if (op == 2) {
                int64_t lo = std::max(ref_pos, start);
                int64_t hi = std::min(ref_pos + len, end);
                for (int64_t p = lo; p < hi; ++p)
                    counts[col_of_pos[p - start] * col_feat
                           + dtype_off + del_chan] += 1;
            } else if (op == 1) {
                int64_t anchor = ref_pos - 1;
                if (anchor >= v.pos && anchor >= start && anchor < end) {
                    int64_t base_col = col_of_pos[anchor - start];
                    for (int64_t j = 0; j < len; ++j) {
                        int chan = NT16_CHAN[
                            seq_at(v.seq, q + j) + strand16];
                        if (chan < 0) continue;
                        int qs = 0;
                        if (num_qstrat > 1) {
                            int qq = v.qual[q + j];
                            if (qq == 0xff) qq = 0;
                            qs = std::max(
                                0, std::min(qq, num_qstrat) - 1);
                        }
                        counts[(base_col + 1 + j) * col_feat + dtype_off
                               + FEATLEN * qs + chan] += 1;
                    }
                }
            }
            if (consumes_q(op)) q += len;
            if (consumes_r(op)) ref_pos += len;
        }
    }
    *counts_out = counts;
    *majors_out = majors;
    *minors_out = minors;
    *n_cols_out = n_cols;
    return 0;
}

// "total" depth normalisation of a counts matrix (the default
// CountsFeatureEncoder post-process, features.py:_post_process_pileup):
// depth is the row sum, minor (insertion) columns inherit their anchor
// major column's depth, features = counts / max(1, depth) as float32.
// Columns arrive ordered, so the anchor is simply the last minor==0
// row seen — no searchsorted needed.
int mt_counts_norm_total(
        const int32_t* counts, const int64_t* minors,
        int64_t n_cols, int col_feat,
        float* feats_out, int64_t* depth_out) {
    if (n_cols <= 0) return 0;
    int64_t anchor_depth = 0;
    for (int64_t c = 0; c < n_cols; ++c) {
        const int32_t* row = counts + c * col_feat;
        int64_t d = 0;
        for (int f = 0; f < col_feat; ++f) d += row[f];
        if (minors[c] == 0) anchor_depth = d;
        else d = anchor_depth;
        depth_out[c] = d;
        const float inv = 1.0f / (float)(d > 1 ? d : 1);
        float* out = feats_out + c * col_feat;
        for (int f = 0; f < col_feat; ++f) out[f] = row[f] * inv;
    }
    return 0;
}

}  // extern "C"
