// Long-read-to-draft mapper (host side), copied from
// medaka_tpu/native/src/mapper.cpp for medaka_tpu_torch.
//
// Replaces the reference's dependency on external minimap2/mini_align
// (scripts/medaka_consensus:165-176) for the polishing workflow: reads
// are mapped to the draft assembly with a minimizer index, colinear
// anchor chaining and banded affine extension between anchors.
//
// Scope: a "minimap2-lite" tuned for the polishing use case (reads are
// drawn from the assembly itself, so high identity, mostly unique
// placement). Primary mapping per read, both strands considered.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

const int K = 15;        // k-mer size
const int W = 10;        // minimizer window
const uint64_t KMASK = (1ULL << (2 * K)) - 1;

inline int base_code(char c) {
    switch (c) {
        case 'A': case 'a': return 0;
        case 'C': case 'c': return 1;
        case 'G': case 'g': return 2;
        case 'T': case 't': return 3;
        default: return -1;
    }
}

inline uint64_t hash64(uint64_t key) {
    key = (~key + (key << 21)) & UINT64_MAX;
    key = key ^ (key >> 24);
    key = ((key + (key << 3)) + (key << 8));
    key = key ^ (key >> 14);
    key = ((key + (key << 2)) + (key << 4));
    key = key ^ (key >> 28);
    key = key + (key << 31);
    return key;
}

struct Minimizer {
    uint64_t hash;
    int pos;      // position of k-mer start
    bool rev;     // strand of canonical k-mer
};

// canonical minimizers of a sequence
void sketch(const char* seq, int len, std::vector<Minimizer>* out) {
    if (len < K) return;
    uint64_t fwd = 0, rev = 0;
    int valid = 0;
    std::vector<Minimizer> window_buf;
    std::vector<Minimizer> kmers;
    kmers.reserve(len);
    for (int i = 0; i < len; ++i) {
        int c = base_code(seq[i]);
        if (c < 0) {
            valid = 0;
            fwd = rev = 0;
            continue;
        }
        fwd = ((fwd << 2) | c) & KMASK;
        rev = (rev >> 2) | ((uint64_t)(3 - c) << (2 * (K - 1)));
        if (++valid < K) continue;
        bool is_rev = rev < fwd;
        uint64_t canon = is_rev ? rev : fwd;
        kmers.push_back({hash64(canon), i - K + 1, is_rev});
    }
    // window minima
    int n = (int)kmers.size();
    std::vector<char> taken(n, 0);
    for (int i = 0; i + W <= n; ++i) {
        int best = i;
        for (int j = i + 1; j < i + W; ++j)
            if (kmers[j].hash < kmers[best].hash) best = j;
        if (!taken[best]) {
            taken[best] = 1;
            out->push_back(kmers[best]);
        }
    }
    if (n > 0 && n < W) {  // short sequence: take global min
        int best = 0;
        for (int j = 1; j < n; ++j)
            if (kmers[j].hash < kmers[best].hash) best = j;
        out->push_back(kmers[best]);
    }
}

struct RefIndex {
    // hash -> list of (ref_id << 32 | pos), strand in low bit of pos<<1
    std::unordered_map<uint64_t, std::vector<uint64_t>> table;
    std::vector<std::string> names;
    std::vector<std::string> seqs;
    int max_occ = 64;  // drop ultra-repetitive seeds
};

struct Anchor {
    int rpos, qpos;
};

}  // namespace

extern "C" {

void* mt_index_create() { return new RefIndex(); }

void mt_index_add(void* handle, const char* name, const char* seq,
                  int len) {
    RefIndex* idx = static_cast<RefIndex*>(handle);
    int rid = (int)idx->seqs.size();
    idx->names.push_back(name);
    idx->seqs.emplace_back(seq, len);
    std::vector<Minimizer> mins;
    sketch(seq, len, &mins);
    for (const Minimizer& m : mins) {
        uint64_t val =
            ((uint64_t)rid << 33) | ((uint64_t)m.pos << 1) |
            (m.rev ? 1 : 0);
        idx->table[m.hash].push_back(val);
    }
}

void mt_index_destroy(void* handle) {
    delete static_cast<RefIndex*>(handle);
}

typedef struct {
    int32_t ref_id;
    int32_t ref_start;
    int32_t flag;        // 0 fwd, 16 rev (| 2048 supplementary), -1 unmapped
    int32_t score;
    int32_t query_start;  // soft-clip at start (of oriented query)
    int32_t query_end;
    int32_t mapq;         // 0-60, minimap2-style confidence
    char* cigar;          // aligned part only (no clips); mt_free()
} mt_mapping;

// forward declaration from align.cpp
typedef struct {
    int32_t score;
    int32_t ref_start;
    int32_t ref_end;
    int32_t query_start;
    int32_t query_end;
    char* cigar;
} mt_alignment;
int mt_align(const char* query, int qlen, const char* ref, int rlen,
             int match, int mismatch, int gap_open, int gap_extend,
             int mode, int band, mt_alignment* out);
void mt_free(void* p);

static void revcomp(const std::string& in, std::string* out) {
    out->resize(in.size());
    for (size_t i = 0; i < in.size(); ++i) {
        char c = in[in.size() - 1 - i];
        switch (c) {
            case 'A': case 'a': (*out)[i] = 'T'; break;
            case 'C': case 'c': (*out)[i] = 'G'; break;
            case 'G': case 'g': (*out)[i] = 'C'; break;
            case 'T': case 't': (*out)[i] = 'A'; break;
            default: (*out)[i] = 'N';
        }
    }
}

namespace {

// one diagonal-bundle chain candidate
struct Candidate {
    uint64_t key;    // (ref_id << 1) | orient_rev
    int diag;        // diagonal bucket (rpos - oriented_qpos) / 500
    int count;       // anchors in the bundle (chain score proxy)
    int rmin, rmax;  // reference span of the bundle's anchors
    int qmin, qmax;  // oriented-query span of the bundle's anchors
};

// overlap of two [a0, a1) intervals
inline int interval_overlap(int a0, int a1, int b0, int b1) {
    return std::max(0, std::min(a1, b1) - std::max(a0, b0));
}

// anchors-count-based mapping quality: scales with how decisively the
// best chain beats its best same-query-interval competitor, damped for
// thin chains (minimap2-style shape; exact formula is our own)
inline int chain_mapq(int best, int runner_up) {
    double ratio = best > 0 ? 1.0 - (double)runner_up / best : 0.0;
    double thin = std::min(1.0, best / 10.0);
    int q = (int)(60.0 * ratio * thin + 0.499);
    return std::max(0, std::min(60, q));
}

}  // namespace

// Map one read: collect anchors per (ref, strand), enumerate diagonal
// bundle candidates, emit the best chain as the primary mapping plus up
// to max_out-1 supplementary mappings over distinct query intervals.
// Each mapping carries a mapq derived from the margin over the best
// competing candidate on the same part of the query.
// Returns the number of mappings written (0 = unmapped), or -1 on error.
int mt_map_multi(void* handle, const char* qseq_c, int qlen, int band,
                 mt_mapping* out, int max_out) {
    RefIndex* idx = static_cast<RefIndex*>(handle);
    if (max_out < 1) return 0;
    for (int i = 0; i < max_out; ++i) {
        out[i].cigar = nullptr;
        out[i].flag = -1;
        out[i].mapq = 0;
    }
    if (qlen < K) return 0;
    std::string qseq(qseq_c, qlen);
    std::vector<Minimizer> qmins;
    sketch(qseq.c_str(), qlen, &qmins);

    // anchors keyed by (ref_id, orientation)
    std::unordered_map<uint64_t, std::vector<Anchor>> buckets;
    for (const Minimizer& m : qmins) {
        auto it = idx->table.find(m.hash);
        if (it == idx->table.end()) continue;
        if ((int)it->second.size() > idx->max_occ) continue;
        for (uint64_t val : it->second) {
            int rid = (int)(val >> 33);
            int rpos = (int)((val >> 1) & 0xffffffffULL);
            bool rrev = val & 1;
            bool orient_rev = (rrev != m.rev);  // read maps to - strand
            uint64_t key = ((uint64_t)rid << 1) | (orient_rev ? 1 : 0);
            buckets[key].push_back({rpos, m.pos});
        }
    }

    // enumerate diagonal-bundle candidates (>= 3 anchors)
    std::vector<Candidate> cands;
    for (auto& kv : buckets) {
        bool orient_rev = kv.first & 1;
        // flip query coords for reverse orientation so colinearity is
        // ascending in both axes
        std::vector<Anchor> a = kv.second;
        if (orient_rev)
            for (Anchor& an : a) an.qpos = qlen - K - an.qpos;
        std::unordered_map<int, int> diag_count;
        for (const Anchor& an : a)
            diag_count[(an.rpos - an.qpos) / 500]++;
        for (auto& dc : diag_count) {
            if (dc.second < 3) continue;
            Candidate c;
            c.key = kv.first;
            c.diag = dc.first;
            c.count = 0;
            c.rmin = c.qmin = INT32_MAX;
            c.rmax = c.qmax = INT32_MIN;
            // gather anchors near this diagonal (±1 bucket); bundles on
            // adjacent diagonals describe the same placement drifted by
            // indels, so they merge into the candidate's span/count
            for (const Anchor& an : a) {
                int d = (an.rpos - an.qpos) / 500;
                if (std::abs(d - dc.first) > 1) continue;
                c.count++;
                c.rmin = std::min(c.rmin, an.rpos);
                c.rmax = std::max(c.rmax, an.rpos + K);
                c.qmin = std::min(c.qmin, an.qpos);
                c.qmax = std::max(c.qmax, an.qpos + K);
            }
            cands.push_back(c);
        }
    }
    if (cands.empty()) return 0;
    std::sort(cands.begin(), cands.end(),
              [](const Candidate& x, const Candidate& y) {
                  return x.count > y.count;
              });

    // accept the primary, then candidates covering query intervals the
    // accepted set does not (supplementary mappings of split reads)
    std::vector<Candidate> accepted;
    std::vector<int> mapqs;
    for (const Candidate& c : cands) {
        if ((int)accepted.size() >= max_out) break;
        // original-read query interval (for overlap bookkeeping)
        bool crev = c.key & 1;
        int c0 = crev ? qlen - c.qmax : c.qmin;
        int c1 = crev ? qlen - c.qmin : c.qmax;
        bool same_placement_seen = false;
        bool covers_new_query = true;
        int runner_up = 0;
        for (const Candidate& p : accepted) {
            bool prev = p.key & 1;
            int p0 = prev ? qlen - p.qmax : p.qmin;
            int p1 = prev ? qlen - p.qmin : p.qmax;
            int ovl = interval_overlap(c0, c1, p0, p1);
            if (2 * ovl > (c1 - c0)) covers_new_query = false;
            if (p.key == c.key && std::abs(p.diag - c.diag) <= 2)
                same_placement_seen = true;
        }
        if (same_placement_seen) continue;
        if (!accepted.empty() && !covers_new_query) continue;
        // best remaining competitor over this candidate's query interval
        for (const Candidate& o : cands) {
            if (&o == &c) continue;
            if (o.key == c.key && std::abs(o.diag - c.diag) <= 2) continue;
            bool orev = o.key & 1;
            int o0 = orev ? qlen - o.qmax : o.qmin;
            int o1 = orev ? qlen - o.qmin : o.qmax;
            if (2 * interval_overlap(c0, c1, o0, o1) > (c1 - c0))
                runner_up = std::max(runner_up, o.count);
        }
        accepted.push_back(c);
        mapqs.push_back(chain_mapq(c.count, runner_up));
    }

    std::string oriented_cache;
    bool have_oriented = false;
    int n_out = 0;
    for (size_t ci = 0; ci < accepted.size(); ++ci) {
        const Candidate& c = accepted[ci];
        int rid = (int)(c.key >> 1);
        bool orient_rev = c.key & 1;
        const std::string& ref = idx->seqs[rid];

        // expand the reference window to cover the full query with margin
        int margin = band;
        int rstart = std::max(0, c.rmin - c.qmin - margin);
        int rend = std::min(
            (int)ref.size(), c.rmax + (qlen - c.qmax) + margin);
        if (rend <= rstart) continue;

        if (orient_rev && !have_oriented) {
            revcomp(qseq, &oriented_cache);
            have_oriented = true;
        }
        const std::string& q = orient_rev ? oriented_cache : qseq;

        mt_alignment aln;
        int rv = mt_align(
            q.c_str(), qlen, ref.c_str() + rstart, rend - rstart,
            2, 4, 4, 2, /*mode=SW*/ 2, band, &aln);
        if (rv != 0 || aln.cigar == nullptr) continue;
        mt_mapping* m = &out[n_out];
        m->ref_id = rid;
        m->ref_start = rstart + aln.ref_start;
        m->flag = (orient_rev ? 16 : 0) | (n_out > 0 ? 2048 : 0);
        m->score = aln.score;
        m->query_start = aln.query_start;
        m->query_end = aln.query_end;
        m->mapq = mapqs[ci];
        m->cigar = aln.cigar;  // ownership to caller
        n_out++;
    }
    return n_out;
}

// single-mapping compatibility entry (primary only)
int mt_map(void* handle, const char* qseq_c, int qlen, int band,
           mt_mapping* out) {
    int n = mt_map_multi(handle, qseq_c, qlen, band, out, 1);
    return n < 0 ? 1 : 0;
}

}  // extern "C"
