// Batched mapping -> normalized CIGAR conversion.
//
// The device NW kernel returns, per aligned pair, a mapping row m where
// m[i] is the draft position of read base i (or -(a+3) for an insertion
// after draft position a).  Converting that to a run-length CIGAR was a
// per-segment Python loop (haslr_tpu/aligner/extend.py::mapping_to_cigar)
// — this does a whole (B, R) chunk in one call with identical outputs.
// Op codes follow haslr_tpu.core.cigar: M=0, I=1, D=2.

#include <cstdint>
#include <vector>

namespace {

struct MapCigResult {
    std::vector<uint8_t> ops;
    std::vector<int64_t> lens;
    std::vector<uint64_t> offsets;  // B + 1, into ops/lens
    std::vector<int64_t> n_eq;      // B
};

constexpr uint8_t OP_M = 0, OP_I = 1, OP_D = 2;

inline void push_op(MapCigResult* r, uint8_t op, int64_t len) {
    if (len <= 0) return;
    if (!r->ops.empty() && r->offsets.back() < r->ops.size() &&
        r->ops.back() == op) {
        r->lens.back() += len;
    } else {
        r->ops.push_back(op);
        r->lens.push_back(len);
    }
}

}  // namespace

extern "C" {

void* hx_mapcig_run(const int16_t* mapping, const uint8_t* reads,
                    const uint8_t* drafts, const int32_t* r_lens,
                    const int32_t* d_lens, uint64_t B, uint64_t R,
                    uint64_t S) {
    auto* res = new MapCigResult();
    res->offsets.reserve(B + 1);
    res->offsets.push_back(0);
    res->n_eq.reserve(B);
    for (uint64_t b = 0; b < B; b++) {
        const int16_t* m = mapping + b * R;
        const uint8_t* q = reads + b * S;
        const uint8_t* t = drafts + b * S;
        int64_t L = r_lens[b];
        int64_t D = d_lens[b];
        int64_t neq = 0;
        if (L == 0) {
            push_op(res, OP_D, D);
        } else {
            int64_t prev_j = -1;
            for (int64_t i = 0; i < L; i++) {
                int64_t mi = m[i];
                if (mi >= 0) {
                    push_op(res, OP_D, mi - prev_j - 1);
                    push_op(res, OP_M, 1);
                    int64_t j = mi < D ? mi : D - 1;
                    if (j < 0) j = 0;
                    neq += (q[i] == t[j]);
                    prev_j = mi;
                } else {
                    push_op(res, OP_I, 1);
                }
            }
            push_op(res, OP_D, D - 1 - prev_j);
        }
        res->n_eq.push_back(neq);
        res->offsets.push_back(res->ops.size());
    }
    return res;
}

// Runs -> normalized CIGAR + n_eq.  The device traceback emits CIGAR
// runs directly (haslr_tpu/kernels/nw_rowscan.py::_cigar_kernel) in
// TRACEBACK order, packed (len-1)<<2 | op into uint16; this walks each
// row reversed (forward order), counts exact matches over M runs, and
// normalizes.  Rows whose run count overflowed MAXR — or whose walk does
// not consume exactly (r_len, d_len) bases — report n_eq = -1 so the
// caller realigns them on host instead of emitting a corrupt record.
void* hx_runcig_run(const uint16_t* runs, const int32_t* n_runs,
                    const uint8_t* reads, const uint8_t* drafts,
                    const int32_t* r_lens, const int32_t* d_lens,
                    uint64_t B, uint64_t MAXR, uint64_t S) {
    auto* res = new MapCigResult();
    res->offsets.reserve(B + 1);
    res->offsets.push_back(0);
    res->n_eq.reserve(B);
    for (uint64_t b = 0; b < B; b++) {
        int64_t n = n_runs[b];
        int64_t L = r_lens[b];
        int64_t D = d_lens[b];
        bool bad = n < 0 || n > (int64_t)MAXR;
        const uint16_t* r = runs + b * MAXR;
        const uint8_t* q = reads + b * S;
        const uint8_t* t = drafts + b * S;
        int64_t qpos = 0, tpos = 0, neq = 0;
        std::size_t row_start = res->ops.size();
        for (int64_t k = n - 1; !bad && k >= 0; k--) {
            uint16_t v = r[k];
            uint8_t op = v & 3;
            int64_t len = (int64_t)(v >> 2) + 1;
            if (op == OP_M) {
                if (qpos + len > L || tpos + len > D) { bad = true; break; }
                for (int64_t x = 0; x < len; x++)
                    neq += (q[qpos + x] == t[tpos + x]);
                qpos += len;
                tpos += len;
            } else if (op == OP_I) {
                if (qpos + len > L) { bad = true; break; }
                qpos += len;
            } else {
                if (tpos + len > D) { bad = true; break; }
                tpos += len;
            }
            push_op(res, op, len);
        }
        if (bad || qpos != L || tpos != D) {
            res->ops.resize(row_start);
            res->lens.resize(row_start);
            res->n_eq.push_back(-1);
        } else {
            res->n_eq.push_back(neq);
        }
        res->offsets.push_back(res->ops.size());
    }
    return res;
}

uint64_t hx_mapcig_size(void* h) {
    return static_cast<MapCigResult*>(h)->ops.size();
}

const uint8_t* hx_mapcig_ops(void* h) {
    return static_cast<MapCigResult*>(h)->ops.data();
}

const int64_t* hx_mapcig_lens(void* h) {
    return static_cast<MapCigResult*>(h)->lens.data();
}

const uint64_t* hx_mapcig_offsets(void* h) {
    return static_cast<MapCigResult*>(h)->offsets.data();
}

const int64_t* hx_mapcig_neq(void* h) {
    return static_cast<MapCigResult*>(h)->n_eq.data();
}

void hx_mapcig_free(void* h) { delete static_cast<MapCigResult*>(h); }

}  // extern "C"
