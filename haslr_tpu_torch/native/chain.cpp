// Anchor chaining DP (minimap2-style) — native hot loop for the aligner.
//
// Semantics are identical to haslr_tpu/aligner/chain.py::chain_anchors
// (the Python fallback): concave-gap chain score over a bounded
// predecessor window, then best-first chain extraction with marginal
// scoring, ties broken by lower anchor index (stable descending sort).
// The role this plays matches the reference pipeline's minimap2 chaining
// stage (invoked at bin/haslr.py:99 of the reference); scoring follows
// minimap2's published formulation, not its code.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

struct ChainResult {
    std::vector<double> scores;
    std::vector<int64_t> group_ids;  // per chain (batch entry point)
    std::vector<uint64_t> offsets;   // n_chains + 1
    std::vector<int64_t> indices;    // concatenated anchor indices
};

inline double gap_cost(int64_t diff, int k) {
    if (diff == 0) return 0.0;
    double d = static_cast<double>(diff < 0 ? -diff : diff);
    return 0.01 * k * d + 0.5 * std::log2(d + 1.0);
}

// One (target, strand) group's DP + best-first extraction, appending
// chains (with group id) into res.  Identical semantics to hx_chain_run.
void chain_group(const int64_t* t_pos, const int64_t* q_pos, uint64_t n,
                 int k, int window, int64_t max_gap, double min_score,
                 int min_anchors, int64_t gid, ChainResult* res) {
    if (n == 0) return;
    std::vector<double> f(n, static_cast<double>(k));
    std::vector<int64_t> pred(n, -1);
    for (uint64_t i = 1; i < n; i++) {
        uint64_t j0 = i > static_cast<uint64_t>(window)
                          ? i - static_cast<uint64_t>(window)
                          : 0;
        double best = -1.0;
        int64_t best_j = -1;
        for (uint64_t j = j0; j < i; j++) {
            int64_t dq = q_pos[i] - q_pos[j];
            int64_t dt = t_pos[i] - t_pos[j];
            if (dq <= 0 || dt <= 0 || dq >= max_gap || dt >= max_gap)
                continue;
            int64_t alpha = std::min(std::min(dq, dt),
                                     static_cast<int64_t>(k));
            double cand = f[j] + alpha - gap_cost(dq - dt, k);
            // strict > keeps the FIRST maximum, matching np.argmax
            if (best_j < 0 || cand > best) {
                best = cand;
                best_j = static_cast<int64_t>(j);
            }
        }
        if (best_j >= 0 && best > f[i]) {
            f[i] = best;
            pred[i] = best_j;
        }
    }
    std::vector<uint64_t> order(n);
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(),
                     [&](uint64_t a, uint64_t b) { return f[a] > f[b]; });
    std::vector<char> used(n, 0);
    std::vector<int64_t> idx;
    for (uint64_t oi = 0; oi < n; oi++) {
        uint64_t i = order[oi];
        if (used[i] || f[i] < min_score) continue;
        idx.clear();
        int64_t j = static_cast<int64_t>(i);
        while (j != -1 && !used[j]) {
            idx.push_back(j);
            j = pred[j];
        }
        double marginal = f[i] - (j != -1 ? f[j] : 0.0);
        for (int64_t jj : idx) used[jj] = 1;
        if (static_cast<int>(idx.size()) < min_anchors ||
            marginal < min_score)
            continue;
        res->scores.push_back(marginal);
        res->group_ids.push_back(gid);
        res->indices.insert(res->indices.end(), idx.rbegin(), idx.rend());
        res->offsets.push_back(res->indices.size());
    }
}

}  // namespace

extern "C" {

// All of one read's (target, strand) groups chained in ONE call: the
// per-group ctypes/numpy crossing measured ~44% of the whole
// seed+chain phase (6.8M tiny calls at the 50 Mb tier).  ``group_off``
// holds n_groups + 1 offsets into the flat (t_pos, q_pos) arrays;
// chain anchor indices are RELATIVE to their group's start.
void* hx_chain_batch(const int64_t* t_pos, const int64_t* q_pos,
                     const uint64_t* group_off, uint64_t n_groups, int k,
                     int window, int64_t max_gap, double min_score,
                     int min_anchors) {
    auto* res = new ChainResult();
    res->offsets.push_back(0);
    for (uint64_t g = 0; g < n_groups; g++) {
        uint64_t lo = group_off[g], hi = group_off[g + 1];
        chain_group(t_pos + lo, q_pos + lo, hi - lo, k, window, max_gap,
                    min_score, min_anchors, static_cast<int64_t>(g), res);
    }
    return res;
}

const int64_t* hx_chain_group_ids(void* h) {
    return static_cast<ChainResult*>(h)->group_ids.data();
}

// Minimizer-index lookup: equal-range of each query hash in the sorted
// hash array, bucketed by the top 16 bits (``bstart``: 65537 prefix
// offsets, built once per index).  Replaces two whole-array numpy
// searchsorted calls per read — ~35% of the 50 Mb seed+chain phase was
// 23-probe binary searches over the 10M-entry array; the bucket narrows
// each search to a cache-resident ~150-entry range.
void hx_idx_lookup(const uint64_t* hashes, const uint64_t* bstart,
                   const uint64_t* q, uint64_t m, int64_t* lo_out,
                   int64_t* hi_out) {
    for (uint64_t i = 0; i < m; i++) {
        uint64_t b = q[i] >> 48;
        const uint64_t* first = hashes + bstart[b];
        const uint64_t* last = hashes + bstart[b + 1];
        lo_out[i] = std::lower_bound(first, last, q[i]) - hashes;
        hi_out[i] = std::upper_bound(first, last, q[i]) - hashes;
    }
}

void* hx_chain_run(const int64_t* t_pos, const int64_t* q_pos, uint64_t n,
                   int k, int window, int64_t max_gap, double min_score,
                   int min_anchors) {
    auto* res = new ChainResult();
    res->offsets.push_back(0);
    chain_group(t_pos, q_pos, n, k, window, max_gap, min_score,
                min_anchors, 0, res);
    return res;
}

uint64_t hx_chain_n(void* h) {
    return static_cast<ChainResult*>(h)->scores.size();
}

const double* hx_chain_scores(void* h) {
    return static_cast<ChainResult*>(h)->scores.data();
}

const uint64_t* hx_chain_offsets(void* h) {
    return static_cast<ChainResult*>(h)->offsets.data();
}

const int64_t* hx_chain_indices(void* h) {
    return static_cast<ChainResult*>(h)->indices.data();
}

void hx_chain_free(void* h) { delete static_cast<ChainResult*>(h); }

}  // extern "C"
