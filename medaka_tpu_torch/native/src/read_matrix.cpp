// Read-level feature-matrix accumulation (host side), copied from
// medaka_tpu/native/src/read_matrix.cpp for medaka_tpu_torch.
//
// Native equivalent of the reference's src/medaka_read_matrix.c:277-615:
// builds the int8 (n_cols, n_rows, featlen) tensor with per-read
// channels [base, qual, strand, mapq(, dwell)(, haplotype)(, dtype)],
// read-row reuse with min_gap=5, deletion fill for spanned-but-absent
// columns, and boundary read-row bookkeeping for cross-chunk joins.
//
// Consumes raw BAM record bytes like mt_pileup_counts_raw (pileup.cpp);
// per-read tag-derived values (dwells from 'mv', HP, DT) are parsed on
// the Python side and passed as flat arrays.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

const int BASE_FEATLEN = 4;       // base, qual, strand, mapq
const int READ_DEL_VAL = 5;
const int ROW_MIN_GAP = 5;        // reference medaka_read_matrix.c:329

// strand-symmetric nt16 -> base code 1..4 (0 pad, 5 deletion),
// reference medaka_read_matrix.h:37-46
int8_t NT16_SYMM[16];
struct SymmInit {
    SymmInit() {
        memset(NT16_SYMM, 0, sizeof NT16_SYMM);
        NT16_SYMM[1] = 1;   // A
        NT16_SYMM[2] = 2;   // C
        NT16_SYMM[4] = 3;   // G
        NT16_SYMM[8] = 4;   // T
    }
} symm_init_;

inline bool consumes_q(int op) {
    return op == 0 || op == 1 || op == 4 || op == 7 || op == 8;
}
inline bool consumes_r(int op) {
    return op == 0 || op == 2 || op == 3 || op == 7 || op == 8;
}
inline bool is_aligned(int op) { return op == 0 || op == 7 || op == 8; }

}  // namespace

extern "C" {

// Returns 0 on success. Outputs (malloc'd; free with mt_free):
//   *matrix_out: int8 [n_cols * n_rows * featlen]
//   *majors_out, *minors_out: int64 [n_cols]
//   *left_out, *right_out: int32 [n_rows] read index occupying the row
//       at the first/last covered position (-1 when none)
int mt_read_matrix_raw(
        int n_reads,
        const uint8_t* records,      // concatenated raw BAM records
        const int64_t* rec_off,      // n_reads+1 offsets
        const int32_t* read_dtype,   // datatype index per read
        const int8_t* read_hap,      // HP value per read
        const int8_t* dwells,        // concatenated per-base dwells
        const int64_t* dwell_off,    // n_reads offsets (-1 = no dwells)
        int64_t start, int64_t end,
        int num_dtypes, int include_dwells, int include_hap,
        int row_per_read, int max_reads,
        int8_t** matrix_out, int64_t** majors_out, int64_t** minors_out,
        int64_t* n_cols_out, int32_t* n_rows_out,
        int32_t** left_out, int32_t** right_out) {
    const int64_t span = end - start;
    if (span <= 0) return 1;
    const int featlen = BASE_FEATLEN + (include_dwells ? 1 : 0)
        + (include_hap ? 1 : 0) + (num_dtypes > 1 ? 1 : 0);
    const int dwell_ch = include_dwells ? BASE_FEATLEN : -1;
    const int hap_ch = include_hap
        ? BASE_FEATLEN + (include_dwells ? 1 : 0) : -1;
    const int dt_ch = (num_dtypes > 1)
        ? BASE_FEATLEN + (include_dwells ? 1 : 0) + (include_hap ? 1 : 0)
        : -1;

    struct View {
        int64_t pos;
        int64_t ref_end;      // unclipped reference end
        int64_t cover_start;  // clipped to [start, end)
        int64_t cover_end;
        bool rev;
        uint8_t mapq;
        const uint8_t* cigar;  // unaligned; read via memcpy
        int n_cigar;
        const uint8_t* seq;    // packed nt16
        const uint8_t* qual;
        int l_seq;
    };
    std::vector<View> views(n_reads);

    // phase 1: record views, coverage, max insertion per position
    std::vector<int32_t> cover(span + 1, 0);
    std::vector<int64_t> max_ins(span, 0);
    for (int r = 0; r < n_reads; ++r) {
        const uint8_t* p = records + rec_off[r];
        View& v = views[r];
        int32_t pos;
        memcpy(&pos, p + 4, 4);
        v.pos = pos;
        uint8_t l_read_name = p[8];
        v.mapq = p[9];
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
        q += 4 * (size_t)n_cigar;
        v.seq = q;
        q += (l_seq + 1) / 2;
        v.qual = q;

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
        v.ref_end = ref_end;
        v.cover_start = std::max(v.pos, start);
        v.cover_end = std::min(ref_end, end);
        if (v.cover_end > v.cover_start) {
            cover[v.cover_start - start] += 1;
            cover[v.cover_end - start] -= 1;
        }
    }

    // column geometry
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
        *matrix_out = nullptr; *majors_out = nullptr;
        *minors_out = nullptr; *left_out = nullptr; *right_out = nullptr;
        *n_cols_out = 0; *n_rows_out = 0;
        return 0;
    }
    const int64_t first_pos = cov_pos.front() + start;
    const int64_t last_pos = cov_pos.back() + start;

    // row assignment in read order with slot reuse
    std::vector<int64_t> row_end;
    std::vector<int32_t> row_of(n_reads, -1);
    for (int r = 0; r < n_reads; ++r) {
        const View& v = views[r];
        if (v.cover_end <= v.cover_start) continue;
        int row = -1;
        if (!row_per_read) {
            for (size_t i = 0; i < row_end.size(); ++i) {
                if (v.cover_start >= row_end[i] + ROW_MIN_GAP) {
                    row = (int)i;
                    break;
                }
            }
        }
        if (row < 0) {
            row = (int)row_end.size();
            row_end.push_back(v.ref_end);
        } else {
            row_end[row] = v.ref_end;
        }
        row_of[r] = row < max_reads ? row : -1;
    }
    const int n_rows = (int)std::min<size_t>(max_reads, row_end.size());
    if (n_rows == 0) {
        *matrix_out = nullptr; *majors_out = nullptr;
        *minors_out = nullptr; *left_out = nullptr; *right_out = nullptr;
        *n_cols_out = 0; *n_rows_out = 0;
        return 0;
    }

    int8_t* matrix = (int8_t*)calloc(
        (size_t)n_cols * n_rows * featlen, sizeof(int8_t));
    int64_t* majors = (int64_t*)malloc(n_cols * sizeof(int64_t));
    int64_t* minors = (int64_t*)malloc(n_cols * sizeof(int64_t));
    int32_t* left = (int32_t*)malloc(n_rows * sizeof(int32_t));
    int32_t* right = (int32_t*)malloc(n_rows * sizeof(int32_t));
    if (!matrix || !majors || !minors || !left || !right) {
        free(matrix); free(majors); free(minors); free(left); free(right);
        return 1;
    }
    for (int i = 0; i < n_rows; ++i) { left[i] = -1; right[i] = -1; }
    for (int64_t p : cov_pos) {
        int64_t c0 = col_of_pos[p];
        for (int64_t m = 0; m <= max_ins[p]; ++m) {
            majors[c0 + m] = start + p;
            minors[c0 + m] = m;
        }
    }

    auto seq_at = [](const uint8_t* seq, int64_t i) -> int {
        uint8_t b = seq[i >> 1];
        return (i & 1) ? (b & 0xf) : (b >> 4);
    };

    // phase 2: per-read fill
    for (int r = 0; r < n_reads; ++r) {
        const int row = row_of[r];
        if (row < 0) continue;
        const View& v = views[r];
        const int8_t strand = v.rev ? -1 : 1;
        const int8_t mapq = (int8_t)std::min<int>(v.mapq, 127);
        const int8_t hap = include_hap ? read_hap[r] : 0;
        const int8_t dtype = (int8_t)read_dtype[r];
        const int8_t* dw = (include_dwells && dwell_off[r] >= 0)
            ? dwells + dwell_off[r] : nullptr;

        // deletion fill over the read's covered column span
        int64_t lo_col = col_of_pos[v.cover_start - start];
        int64_t hi_p = v.cover_end - 1 - start;
        int64_t hi_col = col_of_pos[hi_p] + max_ins[hi_p] + 1;
        for (int64_t col = lo_col; col < hi_col; ++col) {
            int8_t* cell = matrix + (col * n_rows + row) * featlen;
            cell[0] = READ_DEL_VAL;
            cell[1] = -1;
            cell[2] = strand;
            cell[3] = mapq;
            if (dwell_ch >= 0) cell[dwell_ch] = -1;
            if (hap_ch >= 0) cell[hap_ch] = hap;
            if (dt_ch >= 0) cell[dt_ch] = dtype;
        }

        // aligned + inserted base calls
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
                    int64_t qi = q + (p - ref_pos);
                    int64_t col = col_of_pos[p - start];
                    int8_t* cell =
                        matrix + (col * n_rows + row) * featlen;
                    cell[0] = NT16_SYMM[seq_at(v.seq, qi)];
                    uint8_t qq = v.qual[qi];
                    cell[1] = qq == 0xff
                        ? 0 : (int8_t)std::min<int>(qq, 127);
                    if (dw) cell[dwell_ch] = dw[qi];
                }
            } else if (op == 1) {
                int64_t anchor = ref_pos - 1;
                if (anchor >= v.pos && anchor >= start && anchor < end) {
                    int64_t base_col = col_of_pos[anchor - start];
                    for (int64_t j = 0; j < len; ++j) {
                        int64_t qi = q + j;
                        int8_t* cell = matrix
                            + ((base_col + 1 + j) * n_rows + row)
                            * featlen;
                        cell[0] = NT16_SYMM[seq_at(v.seq, qi)];
                        uint8_t qq = v.qual[qi];
                        cell[1] = qq == 0xff
                            ? 0 : (int8_t)std::min<int>(qq, 127);
                        if (dw) cell[dwell_ch] = dw[qi];
                    }
                }
            }
            if (consumes_q(op)) q += len;
            if (consumes_r(op)) ref_pos += len;
        }

        if (v.cover_start <= first_pos && first_pos < v.cover_end)
            left[row] = r;
        if (v.ref_end - 1 >= last_pos && last_pos >= v.pos)
            right[row] = r;
    }

    *matrix_out = matrix;
    *majors_out = majors;
    *minors_out = minors;
    *n_cols_out = n_cols;
    *n_rows_out = n_rows;
    *left_out = left;
    *right_out = right;
    return 0;
}

}  // extern "C"
