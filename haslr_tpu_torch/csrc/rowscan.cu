// Row-scan banded Needleman-Wunsch for NVIDIA Hopper (sm_90a), with three
// traceback emitters on one DP core:
//
//   hx_rowscan_votes    replaces haslr_tpu/kernels/nw_rowscan.py
//                       _votes_kernel (pallas_call in rowscan_votes_pallas):
//                       draft-indexed per-read vote planes + the aligned
//                       span, for the window-consensus rounds;
//   hx_rowscan_cigar    replaces haslr_tpu/kernels/nw_rowscan.py
//                       _cigar_kernel (pallas_call in rowscan_cigar_pallas):
//                       CIGAR runs in traceback order, for the aligner's
//                       extension stage;
//   hx_rowscan_mapping  replaces haslr_tpu/kernels/nw_rowscan.py:422
//                       _mapping_kernel (pallas_call :926 in
//                       rowscan_mapping_pallas :914): the (B, R)
//                       read->draft mapping, for nw.align_mapping_device.
//
// What is computed is exactly what the XLA reference _rowscan_dirs_inner
// and the Pallas traceback emitters compute, cell for cell:
//
//   tmp[k]   = max(diag[k] + sub[k], up[k] + gap)         (previous row)
//   H[i][k]  = gap*k + prefix_max_k(valid ? tmp : NEG  - gap*k)
//   dir      = DIAG if H == cand_diag, else UP if H == cand_up, else LEFT
//
// on a W-lane band whose lane 0 sits at draft column base[i] (the
// length-proportional diagonal minus W/2, advancing 0 or 1 per row).
// Directions are computed on every lane with the same int32 formula, so
// even reads outside the consensus admission gate agree with the
// reference.  Unlike the Pallas _prefix_max, whose shift ladder stops at
// 64 (exact for W <= 128 only), the block-wide scan here is exact for
// every W the kernels take (32..512, a multiple of 32).
//
// Design (first version; right before fast).  One thread block per read,
// W threads, one per band lane.  Each DP row reads the previous row from
// shared memory, forms x, and takes an inclusive max-scan over the W
// lanes: __shfl_up_sync inside each warp, then every thread folds in the
// totals of the warps to its left from shared memory.  One direction
// byte per lane goes to a global scratch of (R+1)*W bytes per read that
// the wrapper allocates (and chunks to a memory budget).  Thread 0 then
// walks the traceback rows r = r_len .. 1; the nearest non-LEFT cell at
// or left of its column, found by a serial leftward scan, is the same
// pick as the reference's prefix max over packed (lane, dir) codes.
//
// What bounds it on the card: the serial chain of R rows per read, each
// with a log2(32)-step shuffle scan and two block barriers, and the
// single-thread traceback's dependent byte loads; about (R+1)*W bytes of
// direction traffic per read (65,664 B at S=512/W=128), which stays
// mostly in L2.  The design answers the latency chain with occupancy:
// blocks are small (128-512 threads, ~2 KB of static shared memory), so
// up to 16 reads are in flight on each of the 132 SMs and one read's
// barrier stalls hide behind another's.  Keeping directions in shared
// memory for the small buckets and a warp-wide traceback are the next
// steps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -100000000;
constexpr int kDiag = 0;
constexpr int kUp = 1;
constexpr int kLeft = 2;
constexpr int kMaxW = 512;

struct Problem {
  const uint8_t* reads;    // (B, R) codes 0-3, 4 = pad
  const int32_t* r_lens;   // (B,)
  const uint8_t* drafts;   // (B, D)
  const int32_t* d_lens;   // (B,)
  const int32_t* base;     // (R + 1,) lane-0 draft column per row
  uint8_t* dirs;           // (B, R + 1, W) direction scratch
  int R, D, W, match, mismatch, gap;
};

// Rows 1..rows of one read's DP; directions into `dirs` (row-major
// (R+1, W)).  Called by every thread of the block (it synchronises).
__device__ void dp_rows(const Problem& p, int b, int rows, int dl,
                        uint8_t* dirs) {
  __shared__ int h_row[kMaxW];
  __shared__ int warp_max[kMaxW / 32];
  const int k = threadIdx.x;
  const int lane = k & 31;
  const int warp = k >> 5;
  const int W = p.W;
  const int D = p.D;
  const int gap = p.gap;
  const uint8_t* read = p.reads + (size_t)b * p.R;
  const uint8_t* draft = p.drafts + (size_t)b * D;
  const int glane = gap * k;
  h_row[k] = (k <= dl) ? glane : kNeg;
  __syncthreads();
  for (int i = 1; i <= rows; ++i) {
    const int b_i = p.base[i];
    const int s = b_i - p.base[i - 1];
    const int ku = k + s;
    const int kd = ku - 1;
    const int up = (ku >= 0 && ku < W) ? h_row[ku] : kNeg;
    const int dg = (kd >= 0 && kd < W) ? h_row[kd] : kNeg;
    const int j = b_i + k;
    int jj = j - 1;
    jj = jj < 0 ? 0 : (jj > D ? D : jj);
    const int db = (jj == D) ? 4 : draft[jj];
    const int sub = (read[i - 1] == db) ? p.match : p.mismatch;
    const int cand_d = dg + sub;
    const int cand_u = up + gap;
    const bool valid = j <= dl;
    int x = (valid ? max(cand_d, cand_u) : kNeg) - glane;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x = max(x, y);
    }
    if (lane == 31) warp_max[warp] = x;
    __syncthreads();  // warp totals visible; every read of h_row done
    for (int w = 0; w < warp; ++w) x = max(x, warp_max[w]);
    const int h = glane + x;
    dirs[(size_t)i * W + k] =
        (h == cand_d) ? kDiag : ((h == cand_u) ? kUp : kLeft);
    h_row[k] = valid ? h : kNeg;
    __syncthreads();  // the new row visible before the next row reads it
  }
}

// One traceback row: the nearest non-LEFT cell at or left of column j in
// row r ends the LEFT run (draft deletions consumed silently); returns
// that cell's direction (DIAG or UP) and column jp.  Out of band, or no
// such cell: a forced UP at jp = j.
__device__ __forceinline__ int tb_resolve(const uint8_t* dirs,
                                          const int32_t* base, int W, int r,
                                          int j, int* jp) {
  const int b_r = base[r];
  const int lane = j - b_r;
  if (lane >= 0 && lane < W) {
    const uint8_t* row = dirs + (size_t)r * W;
    for (int k = lane; k >= 0; --k) {
      const int d = row[k];
      if (d != kLeft) {
        *jp = b_r + k;
        return d;
      }
    }
  }
  *jp = j;
  return kUp;
}

// planes (B, 3D + 256) uint8, filled with 4 by the caller:
//   [0, D)            aligned read base at draft column jp - 1
//   [D, D + DQ)       1st inserted base after column q - 1 (DQ = D + 128)
//   [D + DQ, D + 2DQ) 2nd inserted base
// stats (B, 2) int32: min / max aligned column (1<<29 / -1 if none).
__global__ void __launch_bounds__(kMaxW)
    votes_kernel(Problem p, uint8_t* planes, int32_t* stats) {
  const int b = blockIdx.x;
  const int R = p.R;
  const int D = p.D;
  const int W = p.W;
  const int rl = p.r_lens[b];
  const int dl = p.d_lens[b];
  uint8_t* dirs = p.dirs + (size_t)b * (R + 1) * W;
  dp_rows(p, b, rl < 0 ? 0 : (rl < R ? rl : R), dl, dirs);
  if (threadIdx.x != 0) return;

  const int DQ = D + 128;
  uint8_t* pb = planes + (size_t)b * (3 * D + 256);
  uint8_t* pa = pb + D;
  uint8_t* pa2 = pa + DQ;
  const uint8_t* read = p.reads + (size_t)b * R;
  int j = dl;
  int anchor = -9;  // insertion-run anchor column; >= -1 while a run is open
  int b_a = 4;      // the open run's 1st inserted base (read order)
  int b_b = 4;      // its 2nd
  int jmn = 1 << 29;
  int jmx = -1;
  if (rl <= R) {
    for (int r = rl; r >= 1; --r) {
      int jp;
      const int d = tb_resolve(dirs, p.base, W, r, j, &jp);
      const bool is_diag = d == kDiag;
      const bool is_up = !is_diag;
      const int rb = read[r - 1] & 3;
      if (is_diag) {
        const int c = jp - 1;
        if (c >= 0 && c < D) pb[c] = (uint8_t)rb;
        jmn = min(jmn, c);
        jmx = max(jmx, c);
      }
      // consecutive UP acts at one anchor form a run; flush it at
      // q = anchor + 1 on the next act that does not continue it
      const int anchor_now = jp - 1;
      const bool same_run = is_up && anchor == anchor_now;
      const bool ended = anchor >= -1 && !same_run;
      if (ended) {
        const int q = anchor + 1;
        if (q >= 0 && q < DQ) {
          pa[q] = (uint8_t)b_a;
          pa2[q] = (uint8_t)b_b;
        }
      }
      const int next_b = same_run ? b_a : (is_up ? 4 : b_b);
      b_a = is_up ? rb : (ended ? 4 : b_a);
      b_b = next_b;
      anchor = is_up ? anchor_now : (ended ? -9 : anchor);
      j = is_diag ? jp - 1 : jp;
    }
  }
  if (anchor >= -1) {  // a run still open when the walk leaves row 1
    const int q = anchor + 1;
    if (q >= 0 && q < DQ) {
      pa[q] = (uint8_t)b_a;
      pa2[q] = (uint8_t)b_b;
    }
  }
  stats[2 * (size_t)b] = jmn;
  stats[2 * (size_t)b + 1] = jmx;
}

// runs (B, maxr) int32, zeroed by the caller: (len - 1) << 2 | op with
// op M=0, I=1, D=2, in traceback order.  n_runs (B,) int32: the true run
// count (> maxr: the list overflowed and the caller realigns on host).
__global__ void __launch_bounds__(kMaxW)
    cigar_kernel(Problem p, int maxr, int32_t* runs, int32_t* n_runs) {
  const int b = blockIdx.x;
  const int R = p.R;
  const int W = p.W;
  const int rl = p.r_lens[b];
  const int dl = p.d_lens[b];
  uint8_t* dirs = p.dirs + (size_t)b * (R + 1) * W;
  dp_rows(p, b, rl < 0 ? 0 : (rl < R ? rl : R), dl, dirs);
  if (threadIdx.x != 0) return;

  int32_t* out = runs + (size_t)b * maxr;
  int n = 0;
  auto emit = [&](int op, int len) {
    if (n < maxr) out[n] = ((len - 1) << 2) | op;
    ++n;
  };
  int j = dl;
  int cur_op = -1;
  int cur_len = 0;
  if (rl <= R) {
    for (int r = rl; r >= 1; --r) {
      int jp;
      const int d = tb_resolve(dirs, p.base, W, r, j, &jp);
      const int len_d = j - jp;  // the LEFT run consumed before the act
      if (len_d > 0) {
        if (cur_len > 0) emit(cur_op, cur_len);
        emit(kLeft, len_d);
        cur_len = 0;
      }
      if (cur_len > 0 && cur_op != d) emit(cur_op, cur_len);
      cur_len = (cur_len > 0 && cur_op == d) ? cur_len + 1 : 1;
      cur_op = d;
      j = (d == kDiag) ? jp - 1 : jp;
    }
  }
  if (cur_len > 0) emit(cur_op, cur_len);
  if (j > 0) emit(kLeft, j);  // the leading deletion run
  n_runs[b] = n;
}

// mapping (B, R) int32, filled with -1 by the caller: jp - 1 for a read
// base aligned to draft column jp - 1 (DIAG), -(jp + 2) for a base
// inserted after column jp - 1 (UP).
__global__ void __launch_bounds__(kMaxW)
    mapping_kernel(Problem p, int32_t* mapping) {
  const int b = blockIdx.x;
  const int R = p.R;
  const int W = p.W;
  const int rl = p.r_lens[b];
  const int dl = p.d_lens[b];
  uint8_t* dirs = p.dirs + (size_t)b * (R + 1) * W;
  dp_rows(p, b, rl < 0 ? 0 : (rl < R ? rl : R), dl, dirs);
  if (threadIdx.x != 0) return;

  int32_t* out = mapping + (size_t)b * R;
  int j = dl;
  if (rl <= R) {
    for (int r = rl; r >= 1; --r) {
      int jp;
      const int d = tb_resolve(dirs, p.base, W, r, j, &jp);
      out[r - 1] = (d == kDiag) ? jp - 1 : -(jp + 2);
      j = (d == kDiag) ? jp - 1 : jp;
    }
  }
}

bool width_ok(int W) { return W >= 32 && W <= kMaxW && W % 32 == 0; }

Problem make_problem(const void* reads, const void* r_lens,
                     const void* drafts, const void* d_lens,
                     const void* base, void* dirs, int R, int D, int W,
                     int match, int mismatch, int gap) {
  Problem p;
  p.reads = static_cast<const uint8_t*>(reads);
  p.r_lens = static_cast<const int32_t*>(r_lens);
  p.drafts = static_cast<const uint8_t*>(drafts);
  p.d_lens = static_cast<const int32_t*>(d_lens);
  p.base = static_cast<const int32_t*>(base);
  p.dirs = static_cast<uint8_t*>(dirs);
  p.R = R;
  p.D = D;
  p.W = W;
  p.match = match;
  p.mismatch = mismatch;
  p.gap = gap;
  return p;
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError() of the launch.
extern "C" {

int hx_rowscan_votes(const void* reads, const void* r_lens,
                     const void* drafts, const void* d_lens,
                     const void* base, void* dirs, void* planes,
                     void* stats, int B, int R, int D, int W, int match,
                     int mismatch, int gap, void* stream) {
  if (!width_ok(W)) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  votes_kernel<<<B, W, 0, static_cast<cudaStream_t>(stream)>>>(
      make_problem(reads, r_lens, drafts, d_lens, base, dirs, R, D, W,
                   match, mismatch, gap),
      static_cast<uint8_t*>(planes), static_cast<int32_t*>(stats));
  return (int)cudaGetLastError();
}

int hx_rowscan_cigar(const void* reads, const void* r_lens,
                     const void* drafts, const void* d_lens,
                     const void* base, void* dirs, void* runs, void* n_runs,
                     int B, int R, int D, int W, int match, int mismatch,
                     int gap, int maxr, void* stream) {
  if (!width_ok(W) || maxr <= 0) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  cigar_kernel<<<B, W, 0, static_cast<cudaStream_t>(stream)>>>(
      make_problem(reads, r_lens, drafts, d_lens, base, dirs, R, D, W,
                   match, mismatch, gap),
      maxr, static_cast<int32_t*>(runs), static_cast<int32_t*>(n_runs));
  return (int)cudaGetLastError();
}

int hx_rowscan_mapping(const void* reads, const void* r_lens,
                       const void* drafts, const void* d_lens,
                       const void* base, void* dirs, void* mapping, int B,
                       int R, int D, int W, int match, int mismatch, int gap,
                       void* stream) {
  if (!width_ok(W)) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  mapping_kernel<<<B, W, 0, static_cast<cudaStream_t>(stream)>>>(
      make_problem(reads, r_lens, drafts, d_lens, base, dirs, R, D, W,
                   match, mismatch, gap),
      static_cast<int32_t*>(mapping));
  return (int)cudaGetLastError();
}

}  // extern "C"
