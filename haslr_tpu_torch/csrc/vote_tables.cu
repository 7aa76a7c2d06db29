// Per-window vote tables of one dense consensus round, for NVIDIA Hopper
// (sm_90a):
//
//   hx_vote_tables  replaces haslr_tpu/kernels/consensus_dense.py:401
//                   _kernel_vote_tables (XLA: a segment matrix times the
//                   one-hot vote planes on the MXU, no scatter), called
//                   once a round from the dense engine's round loop.
//
// What is computed is exactly what vote_tables_plain in
// kernels/vote_tables.py computes.  The inputs are one shard's rows of a
// round: the vote planes of B1 or B4, (B, 3S+256) uint8 with a row stride
// of its own, the base plane at column 0, the first insertion plane at
// off1 = S and the second at off2 = 2S+128 (S and S+1 columns); the
// stats (B, 2) int32 (jmin, jmax: the aligned draft span, jmax = -1 when
// nothing aligned); ok (B,) bool, the admission gate; and win_ptr (N+1)
// int32, the rows of window w being [win_ptr[w], win_ptr[w+1]) (the rows
// come sorted by window).  A row votes when ok and jmax >= 0.  Out, for
// every window w of N:
//
//   counts[w*S + c][v]      rows voting with code v (0-3) in base column c
//   ins1/ins2[w*(S+1)+c][v] the same over the two insertion planes
//   cov[w*(S+1) + c]        rows with jmin == c minus rows with
//                           jmax + 1 == c (a difference array whose
//                           running sum is the coverage); the last slot,
//                           cov[N*(S+1)], stays 0: the votes kernels give
//                           jmin <= jmax < d_len <= S, so no span ends
//                           past its window's S+1 slots
//   n_reads[w]              the voting rows
//
// Code 4 (no vote) counts nowhere.  Every (window, column) is written,
// those of windows without a row in this shard with zeros, so the tables
// of several shards sum to the whole batch's.
//
// The bound.  Each plane byte of the 3S+2 used columns is read once and
// each table entry written once: B (3S+2) bytes in, N (3S+2) 16 bytes of
// counts and N (S+1) 4 bytes of coverage out.  At the consensus
// workload's round (N = 4096 windows, B = 53,248 rows, S = 512) that is
// 0.19 GB, 57 us at 3.35 TB/s; the arithmetic, an add a plane byte, is a
// tenth of that.  So the kernel is bound by bytes.
//
// Design.  The rows of a window are a contiguous range, so a window's
// tables are one reduction over that range and need no atomics: one CTA a
// (window, tile of 128 x 4 columns).  A thread owns four consecutive
// columns of one plane, loads them as one 32-bit word a row (the offsets
// and the stride are multiples of four; a warp reads 128 contiguous bytes
// of a row), keeps the 16 counts in registers and writes each column's
// four counts once, as one int4.  The threads of the first insertion
// plane, whose S+1 columns are the coverage's, also take the coverage
// difference from the row's stats; the first thread of the window's
// first tile writes n_reads.  The reference's matmul does N x B x (12S+8)
// products of which all but one in N are by zero; here each plane byte
// is read by one thread and added once.  The ok byte and the stats of a
// row are read by every thread of the window (one broadcast a warp).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

struct Args {
  const uint8_t* planes;
  const uint8_t* ok;
  const int2* stats;
  const int32_t* win_ptr;
  int4* counts;
  int32_t* cov;
  int4* ins1;
  int4* ins2;
  int32_t* n_reads;
  long long stride;  // bytes from one plane row to the next
  int N;
  int S;
  int off1;  // column of the first insertion plane in a row
  int off2;  // column of the second
};

// counts[k][v] += 1 where byte k of word is v, for a voting row (use 1)
__device__ __forceinline__ void tally(int (&counts)[4][4], uint32_t word,
                                      int use) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t b = (word >> (8 * k)) & 0xFFu;
#pragma unroll
    for (int v = 0; v < 4; ++v) counts[k][v] += use & (b == (uint32_t)v);
  }
}

__global__ void __launch_bounds__(kThreads) vote_tables_kernel(Args a) {
  const int w = blockIdx.x;
  const int qb = a.S >> 2;  // quads of the base plane
  const int qi = qb + 1;    // of an insertion plane (S + 1 columns)
  const int q = blockIdx.y * kThreads + threadIdx.x;
  if (q >= qb + 2 * qi) return;
  int plane, c0, width, off;
  if (q < qb) {
    plane = 0, c0 = 4 * q, width = a.S, off = 0;
  } else if (q < qb + qi) {
    plane = 1, c0 = 4 * (q - qb), width = a.S + 1, off = a.off1;
  } else {
    plane = 2, c0 = 4 * (q - qb - qi), width = a.S + 1, off = a.off2;
  }
  const int lo = __ldg(a.win_ptr + w);
  const int hi = __ldg(a.win_ptr + w + 1);
  const uint8_t* src = a.planes + off + c0;
  int counts[4][4] = {};
  int cov[4] = {};
  int rows = 0;
#pragma unroll 4
  for (int r = lo; r < hi; ++r) {
    const int2 st = __ldg(a.stats + r);
    const int use = (__ldg(a.ok + r) != 0) & (st.y >= 0);
    const uint32_t word = __ldg(
        reinterpret_cast<const uint32_t*>(src + (size_t)r * a.stride));
    tally(counts, word, use);
    rows += use;
    if (plane == 1) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        cov[k] += use & (st.x == c0 + k);
        cov[k] -= use & (st.y + 1 == c0 + k);
      }
    }
  }
  int4* out = plane == 0 ? a.counts : (plane == 1 ? a.ins1 : a.ins2);
  const size_t at = (size_t)w * width + c0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (c0 + k < width) {
      out[at + k] = make_int4(counts[k][0], counts[k][1], counts[k][2],
                              counts[k][3]);
      if (plane == 1) a.cov[at + k] = cov[k];
    }
  }
  if (q == 0) {
    a.n_reads[w] = rows;
    if (w == a.N - 1) a.cov[(size_t)a.N * (a.S + 1)] = 0;
  }
}

}  // namespace

extern "C" {

// The tables of one shard's round (layout above).  planes: B rows of
// row_stride bytes; ok: B bytes; stats: B int2; win_ptr: N + 1 int32;
// counts: N*S int4; cov: N*(S+1) + 1 int32; ins1, ins2: N*(S+1) int4;
// n_reads: N int32.  Returns the launch's CUDA error (0: launched).
int hx_vote_tables(const void* planes, const void* ok, const void* stats,
                   const void* win_ptr, void* counts, void* cov, void* ins1,
                   void* ins2, void* n_reads, int N, int S, int row_stride,
                   int off1, int off2, void* stream) {
  if (N <= 0) return 0;
  const uintptr_t vec = reinterpret_cast<uintptr_t>(counts) |
                        reinterpret_cast<uintptr_t>(ins1) |
                        reinterpret_cast<uintptr_t>(ins2);
  if (S <= 0 || S % 4 || row_stride % 4 || off1 % 4 || off2 % 4 ||
      off1 < S || off2 < off1 + S + 4 || row_stride < off2 + S + 4 ||
      reinterpret_cast<uintptr_t>(planes) % 4 ||
      reinterpret_cast<uintptr_t>(stats) % 8 || vec % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const int quads = 3 * (S / 4) + 2;
  const dim3 grid(N, (quads + kThreads - 1) / kThreads);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  Args a;
  a.planes = static_cast<const uint8_t*>(planes);
  a.ok = static_cast<const uint8_t*>(ok);
  a.stats = static_cast<const int2*>(stats);
  a.win_ptr = static_cast<const int32_t*>(win_ptr);
  a.counts = static_cast<int4*>(counts);
  a.cov = static_cast<int32_t*>(cov);
  a.ins1 = static_cast<int4*>(ins1);
  a.ins2 = static_cast<int4*>(ins2);
  a.n_reads = static_cast<int32_t*>(n_reads);
  a.stride = row_stride;
  a.N = N;
  a.S = S;
  a.off1 = off1;
  a.off2 = off2;
  vote_tables_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
