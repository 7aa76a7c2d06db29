// Anti-diagonal (wavefront) banded Needleman-Wunsch for NVIDIA Hopper
// (sm_90a): one DP core with three emitters.
//
//   hx_wavefront_dirs     replaces haslr_tpu/kernels/nw_pallas.py:201
//                         _kernel (DP phase _dp_phase :73; pallas_call
//                         :512 in nw_dirs_pallas :493): the (T+1, B, W)
//                         direction tensor in device memory, for the host
//                         traceback (nw.traceback_batch);
//   hx_wavefront_mapping  replaces nw_pallas.py:208 _fused_kernel
//                         (pallas_call :561 in nw_mapping_pallas :539):
//                         DP + traceback -> the (B, R) read->draft mapping;
//   hx_wavefront_votes    replaces nw_pallas.py:266 _votes_kernel
//                         (pallas_call :455 in nw_votes_pallas :429):
//                         DP + traceback -> draft-indexed vote planes and
//                         the aligned span, the layout of hx_rowscan_votes.
//
// What is computed is the XLA reference's, cell for cell on every lane
// (haslr_tpu/kernels/nw.py:68-120 _nw_scan_inner, and the traceback of
// :225-269 / traceback_batch :425-469).  For t = 1 .. T (T = R + D), with
// b = base[t], lane k at draft column j = b + k and read row i = t - j:
//
//   up   = H[t-1][k + s1]      left = H[t-1][k + s1 - 1]
//   diag = H[t-2][k + s2 - 1]  (NEG outside [0, W); all NEG at t = 1)
//   s1 = b - base[t-1] in {0, 1}, s2 = b - base[t-2] in {0, 1, 2}
//   cand_d = i,j >= 1 ? diag + sub : NEG,  cand_u = i >= 1 ? up + gap : NEG,
//   cand_l = j >= 1 ? left + gap : NEG,    h = max of the three,
//   dir = DIAG if h == cand_d, else UP if h == cand_u, else LEFT,
//   H[t][k] = (0 <= i <= r_len and 0 <= j <= d_len) ? h : NEG
//
// in int32 with NEG = -1e8; reads[R] and drafts[D] read the pad code 4.
// The Pallas kernels computed directions from unmasked candidates and
// wrapped windows, so they agree with the reference on valid cells only;
// these kernels agree on every cell.
//
// Design (first version; right before fast).  One thread block per read,
// W threads, one per band lane.  Three shared rows of W scores (t-2, t-1,
// t) rotate; the lanes of one anti-diagonal are independent, so a step is
// three shared loads, two sequence byte loads, one direction byte store
// and one barrier (no prefix scan, unlike the row-scan DP).  The traceback
// is thread 0 walking one move at a time from (r_len, d_len), exactly as
// traceback_batch does (out of band -> LEFT, then LEFT at i == 0, then UP
// at j == 0).  The mapping and votes kernels stop the DP at
// t = r_len + d_len, the last diagonal the walk reads.
//
// What bounds it on the card: T = 2S serial steps per read, each ending in
// a block barrier; a serial traceback of up to 2S dependent byte loads;
// (2S+1)*W bytes of direction scratch per read in device memory: 131,200 B
// at S=512/W=128 (twice the row-scan's) and 16.8 MB at S=16384/W=512.
// As in rowscan.cu the answer is occupancy: 128-512-thread blocks with
// 6 KB of static shared memory keep up to 16 reads in flight per SM, so
// one read's barrier and load stalls hide behind another's.

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
  const int32_t* base;     // (T + 1,) lane-0 draft column per diagonal
  int R, D, W, match, mismatch, gap;
};

// Diagonals 1..t_hi of read b; the direction byte of lane k on diagonal t
// goes to dirs[t * stride + k].  Called by every thread of the block.
__device__ void dp_diagonals(const Problem& p, int b, int t_hi,
                             uint8_t* dirs, size_t stride) {
  __shared__ int rows[3][kMaxW];
  const int k = threadIdx.x;
  const int W = p.W;
  const int R = p.R;
  const int D = p.D;
  const int rl = p.r_lens[b];
  const int dl = p.d_lens[b];
  const uint8_t* read = p.reads + (size_t)b * R;
  const uint8_t* draft = p.drafts + (size_t)b * D;
  int* h2 = rows[0];  // diagonal t - 2
  int* h1 = rows[1];  // diagonal t - 1
  int* h0 = rows[2];  // diagonal t
  h2[k] = kNeg;
  h1[k] = (k == 0) ? 0 : kNeg;  // t = 0: cell (0, 0) at lane 0
  __syncthreads();
  int b1 = p.base[0];
  int b2 = b1;
  for (int t = 1; t <= t_hi; ++t) {
    const int bt = p.base[t];
    const int ku = k + (bt - b1);
    const int kl = ku - 1;
    const int up = (ku >= 0 && ku < W) ? h1[ku] : kNeg;
    const int left = (kl >= 0 && kl < W) ? h1[kl] : kNeg;
    int diag = kNeg;
    if (t >= 2) {
      const int kd = k + (bt - b2) - 1;
      if (kd >= 0 && kd < W) diag = h2[kd];
    }
    const int j = bt + k;
    const int i = t - j;
    int ii = i - 1;
    ii = ii < 0 ? 0 : (ii > R ? R : ii);
    int jj = j - 1;
    jj = jj < 0 ? 0 : (jj > D ? D : jj);
    const int rb = (ii == R) ? 4 : read[ii];
    const int db = (jj == D) ? 4 : draft[jj];
    const int sub = (rb == db) ? p.match : p.mismatch;
    const int cand_d = (i >= 1 && j >= 1) ? diag + sub : kNeg;
    const int cand_u = (i >= 1) ? up + p.gap : kNeg;
    const int cand_l = (j >= 1) ? left + p.gap : kNeg;
    const int h = max(cand_d, max(cand_u, cand_l));
    dirs[(size_t)t * stride + k] =
        (h == cand_d) ? kDiag : ((h == cand_u) ? kUp : kLeft);
    const bool valid = i >= 0 && i <= rl && j >= 0 && j <= dl;
    h0[k] = valid ? h : kNeg;
    // the new diagonal visible, and every read of the oldest one done,
    // before the next step overwrites it
    __syncthreads();
    int* tmp = h2;
    h2 = h1;
    h1 = h0;
    h0 = tmp;
    b2 = b1;
    b1 = bt;
  }
}

// The last diagonal the walk from (r_len, d_len) reads, within [0, T].
__device__ __forceinline__ int walk_end(const Problem& p, int b) {
  const int t = p.r_lens[b] + p.d_lens[b];
  const int T = p.R + p.D;
  return t < 0 ? 0 : (t > T ? T : t);
}

// One traceback move from (i, j), (i, j) != (0, 0): the stored direction
// of the cell, LEFT when it lies out of band (or past the DP), then LEFT
// at i == 0, then UP at j == 0 (the order of nw.py:245-248).
__device__ __forceinline__ int tb_move(const uint8_t* dirs,
                                       const int32_t* base, int W, int t_hi,
                                       int i, int j) {
  const int t = i + j;
  int d = kLeft;
  if (t <= t_hi) {
    const int lane = j - base[t];
    if (lane >= 0 && lane < W) d = dirs[(size_t)t * W + lane];
  }
  if (i == 0) d = kLeft;
  if (j == 0) d = kUp;
  return d;
}

// dirs (T + 1, B, W) uint8, t-major; every diagonal of every read.
__global__ void __launch_bounds__(kMaxW)
    wf_dirs_kernel(Problem p, int B, uint8_t* dirs) {
  const int b = blockIdx.x;
  uint8_t* out = dirs + (size_t)b * p.W;
  out[threadIdx.x] = 0;  // diagonal 0
  dp_diagonals(p, b, p.R + p.D, out, (size_t)B * p.W);
}

// mapping (B, R) int32, filled with -1 by the caller: j for a read base
// aligned to draft column j, -(a + 3) for a base inserted after column a.
__global__ void __launch_bounds__(kMaxW)
    wf_mapping_kernel(Problem p, uint8_t* scratch, int32_t* mapping) {
  const int b = blockIdx.x;
  const int W = p.W;
  const int t_hi = walk_end(p, b);
  uint8_t* dirs = scratch + (size_t)b * (p.R + p.D + 1) * W;
  dp_diagonals(p, b, t_hi, dirs, W);
  if (threadIdx.x != 0) return;

  int32_t* out = mapping + (size_t)b * p.R;
  int i = p.r_lens[b];
  int j = p.d_lens[b];
  while ((i > 0 || j > 0) && i <= p.R) {
    const int d = tb_move(dirs, p.base, W, t_hi, i, j);
    if (d == kDiag) {
      out[i - 1] = j - 1;
      --i;
      --j;
    } else if (d == kUp) {
      out[i - 1] = -(j + 2);
      --i;
    } else {
      --j;
    }
  }
}

// planes (B, 3D + 256) uint8, filled with 4 by the caller:
//   [0, D)            aligned read base at draft column j - 1
//   [D, D + DQ)       1st inserted base after column q - 1 (DQ = D + 128)
//   [D + DQ, D + 2DQ) 2nd inserted base
// stats (B, 2) int32: min / max aligned column (1<<29 / -1 if none).
// The insertion-run emitter is nw_pallas.py:343-414's: consecutive UP
// moves at one anchor form a run; any other move ends it (a LEFT move
// too) and flushes it at q = anchor + 1.
__global__ void __launch_bounds__(kMaxW)
    wf_votes_kernel(Problem p, uint8_t* scratch, uint8_t* planes,
                    int32_t* stats) {
  const int b = blockIdx.x;
  const int W = p.W;
  const int D = p.D;
  const int t_hi = walk_end(p, b);
  uint8_t* dirs = scratch + (size_t)b * (p.R + D + 1) * W;
  dp_diagonals(p, b, t_hi, dirs, W);
  if (threadIdx.x != 0) return;

  const int DQ = D + 128;
  uint8_t* pb = planes + (size_t)b * (3 * D + 256);
  uint8_t* pa = pb + D;
  uint8_t* pa2 = pa + DQ;
  const uint8_t* read = p.reads + (size_t)b * p.R;
  int i = p.r_lens[b];
  int j = p.d_lens[b];
  int anchor = -9;  // insertion-run anchor column; >= -1 while a run is open
  int b_a = 4;      // the open run's 1st inserted base (read order)
  int b_b = 4;      // its 2nd
  int jmn = 1 << 29;
  int jmx = -1;
  while ((i > 0 || j > 0) && i <= p.R) {
    const int d = tb_move(dirs, p.base, W, t_hi, i, j);
    const bool is_diag = d == kDiag;
    const bool is_up = d == kUp;
    const int rb = (i >= 1) ? (read[i - 1] & 3) : 0;
    const int c = j - 1;
    if (is_diag) {
      if (c >= 0 && c < D) pb[c] = (uint8_t)rb;
      jmn = min(jmn, c);
      jmx = max(jmx, c);
    }
    const bool same_run = is_up && anchor == c;
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
    anchor = is_up ? c : (ended ? -9 : anchor);
    i -= (is_diag || is_up) ? 1 : 0;
    j -= is_up ? 0 : 1;
  }
  if (anchor >= -1) {  // a run still open when the walk reaches (0, 0)
    const int q = anchor + 1;
    if (q >= 0 && q < DQ) {
      pa[q] = (uint8_t)b_a;
      pa2[q] = (uint8_t)b_b;
    }
  }
  stats[2 * (size_t)b] = jmn;
  stats[2 * (size_t)b + 1] = jmx;
}

bool width_ok(int W) { return W >= 32 && W <= kMaxW && W % 32 == 0; }

Problem make_problem(const void* reads, const void* r_lens,
                     const void* drafts, const void* d_lens,
                     const void* base, int R, int D, int W, int match,
                     int mismatch, int gap) {
  Problem p;
  p.reads = static_cast<const uint8_t*>(reads);
  p.r_lens = static_cast<const int32_t*>(r_lens);
  p.drafts = static_cast<const uint8_t*>(drafts);
  p.d_lens = static_cast<const int32_t*>(d_lens);
  p.base = static_cast<const int32_t*>(base);
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

int hx_wavefront_dirs(const void* reads, const void* r_lens,
                      const void* drafts, const void* d_lens,
                      const void* base, void* dirs, int B, int R, int D,
                      int W, int match, int mismatch, int gap,
                      void* stream) {
  if (!width_ok(W)) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  wf_dirs_kernel<<<B, W, 0, static_cast<cudaStream_t>(stream)>>>(
      make_problem(reads, r_lens, drafts, d_lens, base, R, D, W, match,
                   mismatch, gap),
      B, static_cast<uint8_t*>(dirs));
  return (int)cudaGetLastError();
}

int hx_wavefront_mapping(const void* reads, const void* r_lens,
                         const void* drafts, const void* d_lens,
                         const void* base, void* scratch, void* mapping,
                         int B, int R, int D, int W, int match,
                         int mismatch, int gap, void* stream) {
  if (!width_ok(W)) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  wf_mapping_kernel<<<B, W, 0, static_cast<cudaStream_t>(stream)>>>(
      make_problem(reads, r_lens, drafts, d_lens, base, R, D, W, match,
                   mismatch, gap),
      static_cast<uint8_t*>(scratch), static_cast<int32_t*>(mapping));
  return (int)cudaGetLastError();
}

int hx_wavefront_votes(const void* reads, const void* r_lens,
                       const void* drafts, const void* d_lens,
                       const void* base, void* scratch, void* planes,
                       void* stats, int B, int R, int D, int W, int match,
                       int mismatch, int gap, void* stream) {
  if (!width_ok(W)) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  wf_votes_kernel<<<B, W, 0, static_cast<cudaStream_t>(stream)>>>(
      make_problem(reads, r_lens, drafts, d_lens, base, R, D, W, match,
                   mismatch, gap),
      static_cast<uint8_t*>(scratch), static_cast<uint8_t*>(planes),
      static_cast<int32_t*>(stats));
  return (int)cudaGetLastError();
}

}  // extern "C"
