// Partial-order alignment consensus for medaka_tpu (host side).
//
// Replaces the reference's external spoa/abpoa dependency
// (medaka/smolecule.py:164-226, medaka/tandem/consensus_generator.py):
// sequences are aligned against a growing DAG with global DP (linear gap
// cost over graph edges), matched bases fuse into existing nodes (with
// aligned-alternative tracking per column), and the consensus is the
// heaviest path by edge support.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Node {
    char base;
    std::vector<int> preds;        // predecessor node ids
    std::vector<int> pred_weight;  // support of the incoming edge
    std::vector<int> aligned;      // alternative-base nodes in this column
    int support = 0;               // reads passing through this node
};

struct Graph {
    std::vector<Node> nodes;
    std::vector<int> order;  // topological order (rebuilt on demand)

    int add_node(char base) {
        nodes.push_back(Node{base, {}, {}, {}, 0});
        return (int)nodes.size() - 1;
    }

    void add_edge(int from, int to, int w) {
        if (from < 0) return;
        Node& n = nodes[to];
        for (size_t k = 0; k < n.preds.size(); ++k) {
            if (n.preds[k] == from) {
                n.pred_weight[k] += w;
                return;
            }
        }
        n.preds.push_back(from);
        n.pred_weight.push_back(w);
    }

    void toposort() {
        const int n = (int)nodes.size();
        std::vector<int> outdeg(n, 0);
        std::vector<std::vector<int>> succs(n);
        for (int v = 0; v < n; ++v)
            for (int p : nodes[v].preds) succs[p].push_back(v);
        std::vector<int> indeg(n, 0);
        for (int v = 0; v < n; ++v) indeg[v] = (int)nodes[v].preds.size();
        order.clear();
        std::vector<int> stack;
        for (int v = 0; v < n; ++v)
            if (indeg[v] == 0) stack.push_back(v);
        while (!stack.empty()) {
            int v = stack.back();
            stack.pop_back();
            order.push_back(v);
            for (int s : succs[v])
                if (--indeg[s] == 0) stack.push_back(s);
        }
    }
};

const int NEG = INT32_MIN / 4;

// Global alignment of seq against graph; returns per-base matched node id
// (-1 for insertions) via `match_node`.
void align_to_graph(const Graph& g, const char* seq, int slen,
                    int match, int mismatch, int gap,
                    std::vector<int>* match_node) {
    const int n = (int)g.order.size();
    std::vector<int> rank(g.nodes.size());
    for (int r = 0; r < n; ++r) rank[g.order[r]] = r;

    // score[(r+1) * (slen+1) + j]; row 0 = virtual start
    const int W = slen + 1;
    std::vector<int32_t> score((n + 1) * W, NEG);
    std::vector<int32_t> from_row((n + 1) * W, -1);
    std::vector<int8_t> move((n + 1) * W, 0);  // 0 diag, 1 up(del), 2 left(ins)

    for (int j = 0; j <= slen; ++j) {
        score[j] = -gap * j;
        move[j] = 2;
        from_row[j] = 0;
    }
    for (int r = 0; r < n; ++r) {
        const Node& node = g.nodes[g.order[r]];
        // predecessor rows (virtual start row 0 when no preds)
        std::vector<int> prows;
        if (node.preds.empty()) prows.push_back(0);
        else for (int p : node.preds) prows.push_back(rank[p] + 1);
        int32_t* row = &score[(r + 1) * W];
        int32_t* frow = &from_row[(r + 1) * W];
        int8_t* mrow = &move[(r + 1) * W];
        for (int j = 0; j <= slen; ++j) row[j] = NEG;
        for (int pr : prows) {
            const int32_t* prev = &score[pr * W];
            // j = 0: deletion (skip node)
            if (prev[0] != NEG && prev[0] - gap > row[0]) {
                row[0] = prev[0] - gap;
                frow[0] = pr;
                mrow[0] = 1;
            }
            for (int j = 1; j <= slen; ++j) {
                int32_t sub = (seq[j - 1] == node.base) ? match : -mismatch;
                int32_t diag = prev[j - 1] == NEG ? NEG : prev[j - 1] + sub;
                int32_t del = prev[j] == NEG ? NEG : prev[j] - gap;
                if (diag > row[j]) { row[j] = diag; frow[j] = pr; mrow[j] = 0; }
                if (del > row[j]) { row[j] = del; frow[j] = pr; mrow[j] = 1; }
            }
        }
        // insertions within this row
        for (int j = 1; j <= slen; ++j) {
            int32_t ins = row[j - 1] == NEG ? NEG : row[j - 1] - gap;
            if (ins > row[j]) {
                row[j] = ins;
                frow[j] = r + 1;
                mrow[j] = 2;
            }
        }
    }

    // best end: global in sequence, ends at any sink row (or any row —
    // graph suffix may be skipped only via deletions, which cost; to keep
    // it simple take the best score over all rows at j=slen that belong
    // to sink nodes, falling back to the overall best)
    std::vector<char> is_sink(n + 1, 1);
    for (const Node& nd : g.nodes)
        for (int p : nd.preds) is_sink[rank[p] + 1] = 0;
    int best_r = 0;
    int32_t best = NEG;
    for (int r = 1; r <= n; ++r) {
        if (!is_sink[r]) continue;
        if (score[r * W + slen] > best) {
            best = score[r * W + slen];
            best_r = r;
        }
    }
    if (best == NEG) {
        for (int r = 0; r <= n; ++r)
            if (score[r * W + slen] > best) {
                best = score[r * W + slen];
                best_r = r;
            }
    }

    match_node->assign(slen, -1);
    int r = best_r, j = slen;
    while (j > 0 || r > 0) {
        int idx = r * W + j;
        int8_t mv = move[idx];
        int32_t fr = from_row[idx];
        if (r == 0) {  // only insertions remain
            --j;
            continue;
        }
        if (mv == 0) {
            (*match_node)[j - 1] = g.order[r - 1];
            --j;
            r = fr;
        } else if (mv == 1) {
            r = fr;
        } else {
            --j;
        }
        if (fr < 0 && mv != 2) break;  // safety
    }
}

}  // namespace

extern "C" {

// Compute a POA consensus of n sequences. Returns consensus length
// (truncated to out_cap - 1), or -1 on error. The consensus is the
// heaviest path by summed edge weights.
int mt_poa_consensus(const char** seqs, const int* lens, int n_seqs,
                     int match, int mismatch, int gap,
                     char* out, int out_cap) {
    if (n_seqs <= 0 || out_cap <= 1) return -1;
    Graph g;
    // seed graph with the first sequence
    {
        int prev = -1;
        for (int i = 0; i < lens[0]; ++i) {
            int v = g.add_node(seqs[0][i]);
            g.nodes[v].support = 1;
            g.add_edge(prev, v, 1);
            prev = v;
        }
    }
    for (int s = 1; s < n_seqs; ++s) {
        g.toposort();
        std::vector<int> match_node;
        align_to_graph(
            g, seqs[s], lens[s], match, mismatch, gap, &match_node);
        int prev = -1;
        for (int i = 0; i < lens[s]; ++i) {
            int node = match_node[i];
            char base = seqs[s][i];
            if (node >= 0 && g.nodes[node].base != base) {
                // substitute: find or create an aligned alternative
                int alt = -1;
                for (int a : g.nodes[node].aligned)
                    if (g.nodes[a].base == base) { alt = a; break; }
                if (alt < 0) {
                    alt = g.add_node(base);
                    g.nodes[node].aligned.push_back(alt);
                    for (int a : g.nodes[node].aligned)
                        if (a != alt) {
                            g.nodes[alt].aligned.push_back(a);
                            g.nodes[a].aligned.push_back(alt);
                        }
                    g.nodes[alt].aligned.push_back(node);
                }
                node = alt;
            } else if (node < 0) {
                node = g.add_node(base);
            }
            g.nodes[node].support += 1;
            g.add_edge(prev, node, 1);
            prev = node;
        }
    }

    // heaviest path: DP over topological order maximising summed EDGE
    // weight only (spoa's rule). Every read traversal increments both
    // its edges and the node, so adding node support to the objective
    // double-counts and lets a single read's insertion tie or beat a
    // 3:1 majority deletion (the bypass edge carries the majority's
    // weight, but the insertion path picks up the extra node's
    // support).
    g.toposort();
    const int n = (int)g.nodes.size();
    std::vector<int64_t> best(n, 0);
    std::vector<int> back(n, -1);
    int64_t global_best = -1;
    int global_node = -1;
    for (int v : g.order) {
        const Node& node = g.nodes[v];
        int64_t b = 0;
        int bp = -1;
        for (size_t k = 0; k < node.preds.size(); ++k) {
            int64_t cand = best[node.preds[k]] + node.pred_weight[k];
            if (cand > b) {
                b = cand;
                bp = node.preds[k];
            }
        }
        best[v] = b;
        back[v] = bp;
        if (b > global_best) {
            global_best = b;
            global_node = v;
        }
    }
    std::string cons;
    for (int v = global_node; v >= 0; v = back[v]) cons += g.nodes[v].base;
    std::reverse(cons.begin(), cons.end());
    int out_len = (int)std::min((size_t)(out_cap - 1), cons.size());
    memcpy(out, cons.data(), out_len);
    out[out_len] = '\0';
    return out_len;
}

}  // extern "C"
