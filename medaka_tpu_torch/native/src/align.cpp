// Pairwise alignment kernels (host side), copied from
// medaka_tpu/native/src/align.cpp for medaka_tpu_torch.
//
// Replaces the reference's external parasail (SIMD SW/NW,
// medaka/align.py:63-97), edlib (chunked large alignments,
// medaka/align.py:198-330) and the trivial uses of minimap2-style
// realignment. One engine: banded affine-gap (Gotoh) dynamic programming
// with three modes and optional band-doubling, emitting =/X/I/D cigars.
//
// Modes:
//   0 NW: global in both sequences.
//   1 HW: query global, reference free at both ends ("infix"; edlib HW).
//   2 SW: local in both.
//
// The band is measured as net diagonal drift: cells (i, j) with
// lo(i) <= j <= hi(i), lo/hi spanning the corner-to-corner diagonal
// +/- band. band <= 0 means full DP.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int NEG_INF = INT32_MIN / 4;

struct Cell {
    int32_t h, e, f;
};

// traceback codes packed per cell
enum : uint8_t {
    H_FROM_DIAG = 0,
    H_FROM_E = 1,       // gap in query (deletion, consumes ref)
    H_FROM_F = 2,       // gap in ref (insertion, consumes query)
    H_FROM_ZERO = 3,    // SW local start
    E_OPEN = 0 << 2,
    E_EXT = 1 << 2,
    F_OPEN = 0 << 3,
    F_EXT = 1 << 3,
};

struct Bander {
    int qlen, rlen, band;
    Bander(int q, int r, int b) : qlen(q), rlen(r), band(b) {}
    inline int lo(int i) const {
        if (band <= 0) return 0;
        int d = std::min(0, rlen - qlen);
        return std::max(0, i + d - band);
    }
    inline int hi(int i) const {
        if (band <= 0) return rlen;
        int d = std::max(0, rlen - qlen);
        return std::min(rlen, i + d + band);
    }
};

}  // namespace

extern "C" {

typedef struct {
    int32_t score;
    int32_t ref_start;
    int32_t ref_end;    // exclusive
    int32_t query_start;
    int32_t query_end;  // exclusive
    char* cigar;        // malloc'd; free with mt_free
} mt_alignment;

void mt_free(void* p) { free(p); }

// Returns 0 on success, 1 on allocation failure / bad args.
int mt_align(const char* query, int qlen, const char* ref, int rlen,
             int match, int mismatch, int gap_open, int gap_extend,
             int mode, int band, mt_alignment* out) {
    if (qlen < 0 || rlen < 0 || out == nullptr) return 1;
    out->cigar = nullptr;
    if (qlen == 0 || rlen == 0) {
        // degenerate: pure indel (NW/HW) or empty local alignment
        std::string cig;
        char buf[32];
        if (mode == 2 || (qlen == 0 && rlen == 0)) {
            cig = "";
            out->score = 0;
        } else if (qlen == 0) {
            if (mode == 1 || mode == 3) { cig = ""; out->score = 0; }
            else {
                snprintf(buf, sizeof buf, "%dD", rlen);
                cig = buf;
                out->score = -(gap_open + gap_extend * rlen);
            }
        } else {
            snprintf(buf, sizeof buf, "%dI", qlen);
            cig = buf;
            out->score = -(gap_open + gap_extend * qlen);
        }
        out->ref_start = 0; out->ref_end = (mode == 0) ? rlen : 0;
        out->query_start = 0; out->query_end = (mode == 2) ? 0 : qlen;
        out->cigar = strdup(cig.c_str());
        return out->cigar ? 0 : 1;
    }

    Bander bb(qlen, rlen, band);
    std::vector<Cell> prev(rlen + 1), cur(rlen + 1);
    std::vector<int> los(qlen + 1), his(qlen + 1);
    int max_span = 0;
    for (int i = 0; i <= qlen; ++i) {
        los[i] = bb.lo(i);
        his[i] = bb.hi(i);
        max_span = std::max(max_span, his[i] - los[i]);
    }
    // traceback bytes: dense for small problems, band-packed otherwise
    const int64_t tb_size = (int64_t)(qlen + 1) * (rlen + 1);
    const bool full_tb = band <= 0 || tb_size <= (int64_t)1 << 26;
    const int64_t tb_stride = full_tb ? (rlen + 1) : (max_span + 2);
    std::vector<uint8_t> tb((int64_t)(qlen + 1) * tb_stride, 0);
    auto TB = [&](int i, int j) -> uint8_t& {
        if (full_tb) return tb[(int64_t)i * tb_stride + j];
        return tb[(int64_t)i * tb_stride + (j - los[i] + 1)];
    };

    // mode 3 (SHW): ref start anchored, ref end free (edlib prefix)
    const bool free_ref_start = (mode == 1) || (mode == 2);
    const bool free_ref_end =
        (mode == 1) || (mode == 2) || (mode == 3);
    const bool local = (mode == 2);

    // row 0
    for (int j = 0; j <= rlen; ++j) {
        prev[j].e = NEG_INF;
        prev[j].f = NEG_INF;
        prev[j].h = free_ref_start ? 0
            : (j == 0 ? 0 : -(gap_open + gap_extend * j));
        // no TB(0, j) writes: the traceback never reads row 0 (the
        // i == 0 case emits 'D's directly), and under banded packing
        // the row-0 stride would spill into later rows' slots
    }

    int best_score = NEG_INF, best_i = qlen, best_j = rlen;
    for (int i = 1; i <= qlen; ++i) {
        const char qc = query[i - 1];
        const int jlo = std::max(1, los[i]);
        const int jhi = his[i];
        // out-of-band init (one extra on each side: the next row reads
        // prev[j-1]/prev[j] at its own, shifted band)
        for (int j = std::max(0, jlo - 1); j <= std::min(rlen, jhi + 1); ++j)
            cur[j] = {NEG_INF, NEG_INF, NEG_INF};
        if (jlo - 1 == 0) {
            cur[0].h = local ? 0 : -(gap_open + gap_extend * i);
            cur[0].e = NEG_INF;
            cur[0].f = NEG_INF;
            if (!local) TB(i, 0) = H_FROM_F | F_EXT;
        }
        for (int j = jlo; j <= jhi; ++j) {
            uint8_t code = 0;
            // E: gap in query (consume ref)
            const Cell& left = cur[j - 1];
            int32_t e_open = (left.h == NEG_INF) ? NEG_INF
                : left.h - gap_open - gap_extend;
            int32_t e_ext =
                (left.e == NEG_INF) ? NEG_INF : left.e - gap_extend;
            int32_t e = std::max(e_open, e_ext);
            if (e_ext > e_open) code |= E_EXT;
            // F: gap in ref (consume query)
            const Cell& up = prev[j];
            int32_t f_open = (up.h == NEG_INF) ? NEG_INF
                : up.h - gap_open - gap_extend;
            int32_t f_ext = (up.f == NEG_INF) ? NEG_INF
                : up.f - gap_extend;
            int32_t f = std::max(f_open, f_ext);
            if (f_ext > f_open) code |= F_EXT;
            // H
            const Cell& diag = prev[j - 1];
            int32_t sub = (qc == ref[j - 1]) ? match : -mismatch;
            int32_t h_diag = (diag.h == NEG_INF) ? NEG_INF : diag.h + sub;
            int32_t h = h_diag;
            uint8_t hsrc = H_FROM_DIAG;
            if (e > h) { h = e; hsrc = H_FROM_E; }
            if (f > h) { h = f; hsrc = H_FROM_F; }
            if (local && h < 0) { h = 0; hsrc = H_FROM_ZERO; }
            cur[j] = {h, e, f};
            TB(i, j) = code | hsrc;
            if (local && h > best_score) {
                best_score = h; best_i = i; best_j = j;
            }
        }
        std::swap(prev, cur);
    }
    // `prev` now holds the last computed row (qlen)
    if (!local) {
        if (free_ref_end) {
            // best over the last row
            best_score = NEG_INF;
            for (int j = los[qlen]; j <= his[qlen]; ++j) {
                if (prev[j].h > best_score) {
                    best_score = prev[j].h; best_j = j;
                }
            }
            best_i = qlen;
        } else {
            best_score = prev[rlen].h;
            best_i = qlen; best_j = rlen;
        }
    }

    // traceback: state 0 = H, 1 = E (deletion run), 2 = F (insertion run)
    std::vector<std::pair<char, int>> ops;  // (op, len) reversed
    auto push = [&](char op) {
        if (!ops.empty() && ops.back().first == op) ops.back().second++;
        else ops.emplace_back(op, 1);
    };
    int i = best_i, j = best_j;
    int state = 0;
    while (true) {
        if (state == 0) {
            if (i == 0 && j == 0) break;
            if (local && i > 0 && j > 0
                    && (TB(i, j) & 3) == H_FROM_ZERO) break;
            if (i == 0) {
                if (free_ref_start || local) break;  // free ref prefix
                push('D'); --j; continue;      // NW/SHW: consume ref
            }
            if (j == 0) {
                if (local) break;
                push('I'); --i; continue;
            }
            switch (TB(i, j) & 3) {
                case H_FROM_DIAG:
                    push(query[i - 1] == ref[j - 1] ? '=' : 'X');
                    --i; --j;
                    break;
                case H_FROM_E: state = 1; break;
                case H_FROM_F: state = 2; break;
                default: goto done;  // H_FROM_ZERO safety
            }
        } else if (state == 1) {
            bool ext = TB(i, j) & E_EXT;
            push('D'); --j;
            state = ext ? 1 : 0;
        } else {
            bool ext = TB(i, j) & F_EXT;
            push('I'); --i;
            state = ext ? 2 : 0;
        }
    }
done:
    out->score = best_score;
    out->query_end = best_i;
    out->ref_end = best_j;
    out->query_start = i;
    out->ref_start = j;
    // build cigar string (ops are reversed)
    std::string cig;
    char buf[32];
    for (auto it = ops.rbegin(); it != ops.rend(); ++it) {
        snprintf(buf, sizeof buf, "%d%c", it->second, it->first);
        cig += buf;
    }
    out->cigar = strdup(cig.c_str());
    return out->cigar ? 0 : 1;
}

// Unit-cost edit distance with band doubling (edlib-style contract:
// returns distance, or -1 if > max_k and max_k >= 0).
int mt_edit_distance(const char* a, int alen, const char* b, int blen,
                     int max_k) {
    if (alen == 0) return (max_k >= 0 && blen > max_k) ? -1 : blen;
    if (blen == 0) return (max_k >= 0 && alen > max_k) ? -1 : alen;
    int diff = std::abs(alen - blen);
    if (max_k >= 0 && diff > max_k) return -1;  // distance >= diff
    int band = std::max(16, diff + 1);
    const int INF = INT32_MAX / 2;
    while (true) {
        int d = std::max(0, blen - alen), dd = std::min(0, blen - alen);
        std::vector<int> prev(blen + 1, INF), cur(blen + 1, INF);
        for (int j = 0; j <= std::min(blen, d + band); ++j) prev[j] = j;
        for (int i = 1; i <= alen; ++i) {
            int jlo = std::max(0, i + dd - band);
            int jhi = std::min(blen, i + d + band);
            for (int j = jlo; j <= jhi; ++j) cur[j] = INF;
            if (jlo == 0) cur[0] = i;
            for (int j = std::max(1, jlo); j <= jhi; ++j) {
                int sub = prev[j - 1] + (a[i - 1] != b[j - 1]);
                int del = (j - 1 >= jlo) ? cur[j - 1] + 1 : INF;
                int ins = prev[j] + 1;
                cur[j] = std::min(sub, std::min(del, ins));
            }
            std::swap(prev, cur);
        }
        int result = prev[blen];
        if (result <= band || band >= std::max(alen, blen)) {
            // a banded pass whose result fits the band is exact
            if (max_k >= 0 && result > max_k) return -1;
            return result;
        }
        // result was clipped, so the true distance exceeds the band;
        // no point widening past a satisfied max_k
        if (max_k >= 0 && band >= max_k) return -1;
        band *= 2;  // path may have been clipped by the band
    }
}

}  // extern "C"
