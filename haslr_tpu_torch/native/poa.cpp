// Partial-order-alignment consensus: the native host engine.
//
// Plays the role of the vendored SPOA v1.1.3 library the reference links
// against (Assemble.cpp:499-555: global alignment, match 5 / mismatch -4 /
// gap -8, align+add each supporting subsequence, generate_consensus), and
// doubles as the honest CPU baseline for the TPU consensus benchmark.
// Semantics match haslr_tpu/assemble/poa.py (the validated reference
// implementation) move for move: same topological order, same traceback
// preference (diagonal > deletion > insertion, predecessors in insertion
// order), same heaviest-bundle tie-breaks — so either engine can verify the
// other.
//
// Batch API: hx_poa_run consumes a whole batch of windows (concatenated
// 2-bit codes + per-sequence offsets + per-window sequence ranges) and can
// fan windows out over threads, mirroring the reference's pthread work
// queue over edges (Assemble.cpp:562-605).

#include <cstdint>
#include <cstring>
#include <vector>
#include <thread>
#include <atomic>
#include <algorithm>

namespace {

constexpr int32_t NEG = -1000000000;

struct PoaGraph {
    int match, mismatch, gap;
    std::vector<uint8_t> base;
    // adjacency in insertion order (matches Python dict semantics)
    std::vector<std::vector<std::pair<int32_t, int32_t>>> in_edges;
    std::vector<std::vector<std::pair<int32_t, int32_t>>> out_edges;
    std::vector<std::vector<int32_t>> aligned;
    int n_seqs = 0;

    // scratch reused across sequences
    std::vector<int32_t> H;          // (n+1) x (m+1) DP table
    std::vector<int32_t> order, rank_of;

    PoaGraph(int ma, int mi, int g) : match(ma), mismatch(mi), gap(g) {}

    int32_t new_node(uint8_t c) {
        base.push_back(c);
        in_edges.emplace_back();
        out_edges.emplace_back();
        aligned.emplace_back();
        return (int32_t)base.size() - 1;
    }

    void add_edge(int32_t u, int32_t v) {
        bool found = false;
        for (auto &e : out_edges[u])
            if (e.first == v) { e.second++; found = true; break; }
        if (!found) out_edges[u].push_back({v, 1});
        found = false;
        for (auto &e : in_edges[v])
            if (e.first == u) { e.second++; found = true; break; }
        if (!found) in_edges[v].push_back({u, 1});
    }

    void topo() {
        int n = (int)base.size();
        order.clear();
        order.reserve(n);
        std::vector<int32_t> indeg(n);
        std::vector<int32_t> stack;
        for (int i = 0; i < n; i++) {
            indeg[i] = (int32_t)in_edges[i].size();
            if (indeg[i] == 0) stack.push_back(i);
        }
        while (!stack.empty()) {
            int32_t u = stack.back();
            stack.pop_back();
            order.push_back(u);
            for (auto &e : out_edges[u])
                if (--indeg[e.first] == 0) stack.push_back(e.first);
        }
        rank_of.assign(n, 0);
        for (int r = 0; r < (int)order.size(); r++) rank_of[order[r]] = r;
    }

    // Global sequence-to-graph alignment + threading of the sequence into
    // the graph (align() + add_sequence() of the Python engine in one).
    void align_add(const uint8_t *codes, int64_t m) {
        if (m <= 0) return;
        if (base.empty()) {
            int32_t prev = -1;
            for (int64_t i = 0; i < m; i++) {
                int32_t u = new_node(codes[i]);
                if (prev >= 0) add_edge(prev, u);
                prev = u;
            }
            n_seqs++;
            return;
        }
        topo();
        int n = (int)order.size();
        int64_t stride = m + 1;
        H.resize((size_t)(n + 1) * stride);
        int32_t *H0 = H.data();
        for (int64_t j = 0; j <= m; j++) H0[j] = (int32_t)(gap * j);
        std::vector<int32_t> tmp(stride);
        for (int r = 0; r < n; r++) {
            int32_t u = order[r];
            int32_t *row = H.data() + (size_t)(r + 1) * stride;
            const auto &preds = in_edges[u];
            // best_pred computed into tmp-space on the fly
            const int32_t *bp;
            std::vector<int32_t> bestp;
            if (preds.empty()) {
                bp = H0;
            } else if (preds.size() == 1) {
                bp = H.data() + (size_t)(rank_of[preds[0].first] + 1) * stride;
            } else {
                bestp.assign(stride, NEG);
                for (auto &e : preds) {
                    const int32_t *pr =
                        H.data() + (size_t)(rank_of[e.first] + 1) * stride;
                    for (int64_t j = 0; j <= m; j++)
                        bestp[j] = std::max(bestp[j], pr[j]);
                }
                bp = bestp.data();
            }
            uint8_t bu = base[u];
            tmp[0] = bp[0] + gap;
            for (int64_t j = 1; j <= m; j++) {
                int32_t s = (codes[j - 1] == bu) ? match : mismatch;
                tmp[j] = std::max(bp[j - 1] + s, bp[j] + gap);
            }
            int32_t run = tmp[0];
            row[0] = run;
            for (int64_t j = 1; j <= m; j++) {
                run = std::max(tmp[j], run + gap);
                row[j] = run;
            }
        }
        // best end node: no out-edges; max score, tie -> smaller rank
        int32_t best_u = -1;
        int64_t best_key_score = NEG;
        int32_t best_key_rank = 0;
        for (int r = 0; r < n; r++) {
            int32_t u = order[r];
            if (!out_edges[u].empty()) continue;
            int32_t sc = H[(size_t)(r + 1) * stride + m];
            if (best_u < 0 || sc > best_key_score ||
                (sc == best_key_score && r < best_key_rank)) {
                best_u = u;
                best_key_score = sc;
                best_key_rank = r;
            }
        }
        // traceback: (node, pos) pairs in reverse; node -1 = insertion,
        // pos -1 = deletion
        std::vector<std::pair<int32_t, int64_t>> pairs;
        pairs.reserve((size_t)m * 2);
        int32_t u = best_u;
        int64_t j = m;
        while (true) {
            if (u < 0) {
                while (j > 0) { pairs.push_back({-1, j - 1}); j--; }
                break;
            }
            int r = rank_of[u] + 1;
            int32_t h = H[(size_t)r * stride + j];
            const auto &preds = in_edges[u];
            int32_t moved = 0;   // 0 none, 1 diag, 2 del
            int32_t pnext = -2;
            if (j > 0) {
                int32_t s = (base[u] == codes[j - 1]) ? match : mismatch;
                if (preds.empty()) {
                    if (h == H0[j - 1] + s) { moved = 1; pnext = -1; }
                } else {
                    for (auto &e : preds) {
                        int pr = rank_of[e.first] + 1;
                        if (h == H[(size_t)pr * stride + j - 1] + s) {
                            moved = 1; pnext = e.first; break;
                        }
                    }
                }
            }
            if (!moved) {
                if (preds.empty()) {
                    if (h == H0[j] + gap) { moved = 2; pnext = -1; }
                } else {
                    for (auto &e : preds) {
                        int pr = rank_of[e.first] + 1;
                        if (h == H[(size_t)pr * stride + j] + gap) {
                            moved = 2; pnext = e.first; break;
                        }
                    }
                }
            }
            if (!moved) {
                // insertion within the row
                pairs.push_back({-1, j - 1});
                j--;
                continue;
            }
            if (moved == 1) { pairs.push_back({u, j - 1}); j--; }
            else pairs.push_back({u, -1});
            u = pnext;
        }
        std::reverse(pairs.begin(), pairs.end());
        // thread sequence into graph
        int32_t prev = -1;
        for (auto &pr : pairs) {
            int32_t node_id = pr.first;
            int64_t pos = pr.second;
            if (pos < 0) continue;  // deletion
            uint8_t c = codes[pos];
            int32_t v;
            if (node_id < 0) {
                v = new_node(c);
            } else if (base[node_id] == c) {
                v = node_id;
            } else {
                v = -1;
                for (int32_t a : aligned[node_id])
                    if (base[a] == c) { v = a; break; }
                if (v < 0) {
                    v = new_node(c);
                    std::vector<int32_t> group;
                    group.push_back(node_id);
                    for (int32_t a : aligned[node_id]) group.push_back(a);
                    for (int32_t a : group) aligned[a].push_back(v);
                    aligned[v] = group;
                }
            }
            if (prev >= 0) add_edge(prev, v);
            prev = v;
        }
        n_seqs++;
    }

    // heaviest-bundle consensus (Lee 2003), same tie-breaks as poa.py
    std::vector<uint8_t> consensus() {
        std::vector<uint8_t> out;
        if (base.empty()) return out;
        topo();
        int n = (int)order.size();
        std::vector<int64_t> score(base.size(), 0);
        std::vector<int32_t> pred(base.size(), -1);
        for (int r = 0; r < n; r++) {
            int32_t u = order[r];
            for (auto &e : out_edges[u]) {
                int32_t v = e.first;
                int64_t cand = score[u] + e.second;
                if (cand > score[v] ||
                    (cand == score[v] && pred[v] >= 0 && u < pred[v])) {
                    score[v] = cand;
                    pred[v] = u;
                }
            }
        }
        // max over order of (score, -u): first max wins
        int32_t best = order[0];
        for (int r = 1; r < n; r++) {
            int32_t u = order[r];
            if (score[u] > score[best] ||
                (score[u] == score[best] && u < best)) best = u;
        }
        std::vector<uint8_t> rev;
        int32_t u = best;
        while (u >= 0) { rev.push_back(base[u]); u = pred[u]; }
        out.assign(rev.rbegin(), rev.rend());
        return out;
    }
};

struct PoaBatchResult {
    std::vector<uint8_t> out;       // concatenated consensus codes
    std::vector<uint64_t> offsets;  // n_wins + 1
};

}  // namespace

extern "C" {

void *hx_poa_run(const uint8_t *codes, const uint64_t *seq_offsets,
                 uint64_t n_seqs, const uint64_t *win_offsets,
                 uint64_t n_wins, int match, int mismatch, int gap,
                 int n_threads) {
    (void)n_seqs;
    auto *res = new PoaBatchResult();
    std::vector<std::vector<uint8_t>> per_win(n_wins);
    std::atomic<uint64_t> next{0};
    auto worker = [&]() {
        for (;;) {
            uint64_t w = next.fetch_add(1);
            if (w >= n_wins) break;
            PoaGraph g(match, mismatch, gap);
            for (uint64_t s = win_offsets[w]; s < win_offsets[w + 1]; s++) {
                int64_t len =
                    (int64_t)(seq_offsets[s + 1] - seq_offsets[s]);
                if (len > 0) g.align_add(codes + seq_offsets[s], len);
            }
            if (g.n_seqs > 0) per_win[w] = g.consensus();
        }
    };
    if (n_threads <= 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);
        for (auto &th : pool) th.join();
    }
    res->offsets.resize(n_wins + 1);
    res->offsets[0] = 0;
    for (uint64_t w = 0; w < n_wins; w++)
        res->offsets[w + 1] = res->offsets[w] + per_win[w].size();
    res->out.reserve(res->offsets[n_wins]);
    for (auto &v : per_win)
        res->out.insert(res->out.end(), v.begin(), v.end());
    return res;
}

uint64_t hx_poa_out_size(void *h) {
    return ((PoaBatchResult *)h)->out.size();
}
const uint8_t *hx_poa_out(void *h) {
    auto *r = (PoaBatchResult *)h;
    return r->out.empty() ? (const uint8_t *)"" : r->out.data();
}
const uint64_t *hx_poa_out_offsets(void *h) {
    return ((PoaBatchResult *)h)->offsets.data();
}
void hx_poa_free(void *h) { delete (PoaBatchResult *)h; }

}  // extern "C"
