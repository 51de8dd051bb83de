// In-payload BAM record scan + filter for medaka_tpu (host side).
//
// Walks the *inflated* BGZF payload of a region's index chunks and
// returns the payload offsets of records passing the reference's read
// filters (medaka_bamiter.c:16-48: flag mask, mapq, optional integer
// tag match, optional read group). This replaces the Python-side
// BamRecord object creation + filter_read loop in the featurization
// hot path: the offsets feed mt_pileup_counts_raw directly, so a
// region goes BGZF bytes -> counts without materialising records in
// Python at all (reference context: features.py:199-255 / P1).
//
// BAM record framing (SAM spec 4.2): each record is
//   int32 block_size | int32 refID | int32 pos | uint8 l_read_name |
//   uint8 mapq | uint16 bin | uint16 n_cigar_op | uint16 flag |
//   uint32 l_seq | int32 next_refID | int32 next_pos | int32 tlen |
//   read_name | cigar | 4-bit seq | quals | aux tags
// The returned offsets point at the refID field (block_size skipped),
// matching the layout mt_pileup_counts_raw consumes.

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

const uint16_t EXCLUDE_FLAGS = 4 | 256 | 512 | 1024 | 2048;

inline bool consumes_r_op(int op) {
    return op == 0 || op == 2 || op == 3 || op == 7 || op == 8;
}

// Size in bytes of a fixed-width aux value; -1 for variable (Z/H/B).
inline int aux_size(uint8_t type) {
    switch (type) {
        case 'A': case 'c': case 'C': return 1;
        case 's': case 'S': return 2;
        case 'i': case 'I': case 'f': return 4;
        case 'd': return 8;
        default: return -1;
    }
}

struct AuxHit {
    bool found;
    bool is_int;
    int64_t ival;
    const uint8_t* str;   // for Z-type values (nul-terminated)
};

// Find an aux tag by its 2-char name; returns found=false when the
// aux section is malformed (caller then rejects the record and the
// Python layer's fallback parser raises as it would have before).
AuxHit find_tag(const uint8_t* aux, const uint8_t* aux_end,
                const char* name) {
    AuxHit hit = {false, false, 0, nullptr};
    const uint8_t* p = aux;
    while (p + 3 <= aux_end) {
        uint8_t t0 = p[0], t1 = p[1], type = p[2];
        const uint8_t* val = p + 3;
        int sz = aux_size(type);
        int64_t skip;
        if (sz > 0) {
            skip = sz;
        } else if (type == 'Z' || type == 'H') {
            const uint8_t* q = val;
            while (q < aux_end && *q) ++q;
            if (q >= aux_end) return hit;  // unterminated
            skip = (q - val) + 1;
        } else if (type == 'B') {
            if (val + 5 > aux_end) return hit;
            int esz = aux_size(val[0]);
            if (esz <= 0) return hit;
            uint32_t n;
            memcpy(&n, val + 1, 4);
            skip = 5 + (int64_t)esz * n;
        } else {
            return hit;  // unknown type: stop, malformed
        }
        if (val + skip > aux_end) return hit;
        if (t0 == (uint8_t)name[0] && t1 == (uint8_t)name[1]) {
            hit.found = true;
            switch (type) {
                case 'c': hit.is_int = true;
                          hit.ival = *(const int8_t*)val; break;
                case 'C': hit.is_int = true; hit.ival = *val; break;
                case 's': { int16_t v; memcpy(&v, val, 2);
                            hit.is_int = true; hit.ival = v; break; }
                case 'S': { uint16_t v; memcpy(&v, val, 2);
                            hit.is_int = true; hit.ival = v; break; }
                case 'i': { int32_t v; memcpy(&v, val, 4);
                            hit.is_int = true; hit.ival = v; break; }
                case 'I': { uint32_t v; memcpy(&v, val, 4);
                            hit.is_int = true; hit.ival = v; break; }
                case 'Z': hit.str = val; break;
                default: break;  // A/f/d/H/B: present but not int/str
                                 // (the Python filter rejects these)
            }
            return hit;
        }
        p = val + skip;
    }
    return hit;
}

}  // namespace


extern "C" {

// Scan filtered record offsets in [seg_start[i], seg_end[i]) payload
// windows. Returns the number of records written to rec_off_out, or
//   -1  malformed record framing / truncated payload / cap exceeded
//   -2  a passing record carries a CG-style long cigar (the caller
//       must use the cigar-expanding fallback path)
int64_t mt_bam_scan_filter(
        const uint8_t* payload, int64_t payload_len,
        const int64_t* seg_start, const int64_t* seg_end, int n_seg,
        int32_t tid, int64_t start, int64_t end,
        int min_mapq,
        const char* tag_name, int64_t tag_value, int keep_missing,
        const char* read_group,
        int64_t* rec_off_out, int64_t cap) {
    const bool want_tag = tag_name && tag_name[0];
    const bool want_rg = read_group && read_group[0];
    int64_t n_out = 0;
    for (int s = 0; s < n_seg; ++s) {
        int64_t off = seg_start[s];
        const int64_t stop = std::min(seg_end[s], payload_len);
        while (off < stop) {
            if (off + 4 > payload_len) return -1;
            int32_t block_size;
            memcpy(&block_size, payload + off, 4);
            if (block_size < 32 || off + 4 + block_size > payload_len)
                return -1;
            const uint8_t* rec = payload + off + 4;
            const int64_t rec_payload_off = off + 4;
            off += 4 + block_size;

            int32_t ref_id, pos;
            memcpy(&ref_id, rec, 4);
            memcpy(&pos, rec + 4, 4);
            if (ref_id != tid) continue;
            if (pos >= end) break;  // sorted within an index chunk
            uint8_t l_read_name = rec[8];
            uint8_t mapq = rec[9];
            uint16_t n_cigar, flag;
            memcpy(&n_cigar, rec + 12, 2);
            memcpy(&flag, rec + 14, 2);
            uint32_t l_seq;
            memcpy(&l_seq, rec + 16, 4);
            if (flag & EXCLUDE_FLAGS) continue;
            if (mapq < min_mapq) continue;

            const uint8_t* cigar = rec + 32 + l_read_name;
            if ((const uint8_t*)cigar + 4 * (int64_t)n_cigar >
                    rec + block_size)
                return -1;
            // overlap test needs the reference span only for reads
            // starting left of the window (htslib endpos semantics,
            // io/bam.py:595-599)
            if (pos < start) {
                int64_t ref_end = pos;
                for (int ci = 0; ci < n_cigar; ++ci) {
                    uint32_t c;
                    memcpy(&c, cigar + 4 * (size_t)ci, 4);
                    if (consumes_r_op(c & 0xf)) ref_end += c >> 4;
                }
                if (ref_end <= start) continue;
            }

            if (want_tag || want_rg) {
                const uint8_t* aux = cigar + 4 * (int64_t)n_cigar
                    + (l_seq + 1) / 2 + l_seq;
                const uint8_t* aux_end = rec + block_size;
                if (aux > aux_end) return -1;
                if (want_tag) {
                    AuxHit hit = find_tag(aux, aux_end, tag_name);
                    if (!hit.found) {
                        if (!keep_missing) continue;
                    } else if (!hit.is_int || hit.ival != tag_value) {
                        continue;
                    }
                }
                if (want_rg) {
                    AuxHit hit = find_tag(aux, aux_end, "RG");
                    if (!hit.found || hit.str == nullptr) continue;
                    if (strcmp((const char*)hit.str, read_group) != 0)
                        continue;
                }
            }

            // CG-style long cigar placeholder (kSmN): the real cigar
            // lives in an aux tag the pileup kernel does not expand
            if (n_cigar == 2) {
                uint32_t c0, c1;
                memcpy(&c0, cigar, 4);
                memcpy(&c1, cigar + 4, 4);
                if ((c0 & 0xf) == 4 && (c1 & 0xf) == 3 &&
                        (c0 >> 4) == l_seq)
                    return -2;
            }

            if (n_out >= cap) return -1;
            rec_off_out[n_out++] = rec_payload_off;
        }
    }
    return n_out;
}

}  // extern "C"
