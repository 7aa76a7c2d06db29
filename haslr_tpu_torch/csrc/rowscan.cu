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
// 64 (exact for W <= 128 only), the scan here is exact for every W the
// kernels take: 32 to 512 in steps of 32.  The kernels are built for 128,
// 256 and 512 lanes; another band runs on the next of these with its
// lanes from W on masked as invalid columns, which is the same recurrence.
//
// The bound.  Inputs and outputs are a few MB (codes in, runs / planes /
// mapping out; the direction scratch is neither), 1-2 us at 3.35 TB/s, so
// the kernels are bound by operations.  A cell takes 14 int32 operations
// as the recurrence is written: the substitution score (compare, select),
// two candidate adds, their max, the valid mask (compare, select), the
// -gap*k shift, the scan max, the +gap*k shift, and the direction (two
// compares, two selects).  Hopper issues int32 add / max / compare on 64
// lanes an SM: 132 x 64 x 1.98 GHz = 16.7 T operations/s, half of the
// instruction rate behind the published 67 TFLOP/s of float32.  The bound
// is rows x W x 14 / 16.7e12 s with rows the sum of the reads' lengths:
// 0.11 ms for 2048 full reads at S=512, W=128.
//
// What bounds the kernels on the card.  A read is a serial chain of R DP
// rows, each waiting on a warp scan (six dependent shuffles), then a
// serial chain of R traceback steps (a ballot, two leading-zero counts
// and a shuffle each).  A launch of few reads takes the time of its
// longest read's chain: about 400 cycles a DP row and 360 a walk row,
// measured with clock64() stamps.  A launch that fills the card is held
// by instruction issue instead: the int32 pipe takes a warp instruction
// every two cycles, and a DP row costs about 100 instructions for a
// warp's 128 cells beside the 56 the recurrence needs (scan, packing,
// neighbour values, loop), a walk row about as many, done alike by all 32
// threads because the chain has no parallel work to give them.
//
// Design.
//  * Several lanes a thread, the row in registers.  A thread owns C
//    consecutive band lanes and keeps the previous row's scores for them
//    in registers.  The in-row prefix max is serial over the thread's C
//    lanes, then one warp scan of the threads' totals (__shfl_up_sync),
//    then a fold-in.  The one neighbouring score a thread needs for the
//    next row (its left neighbour's last lane when the band stays, its
//    right neighbour's first lane when the band shifts) is rebuilt from
//    scan values the thread already holds -- the exclusive prefix, and
//    the right neighbour's first x, shuffled while the scan runs -- so it
//    costs no step on the row's critical path.
//  * No block barrier where a read fits one warp (WPR = 1: W = 32 C, so
//    C = 4 / 8 / 16 at W = 128 / 256 / 512).  Several reads share a block,
//    one warp each, and run independently; a read's walk overlaps other
//    reads' DP on the same SM.
//  * Small launches at W = 512 (the extension's largest buckets hold 32
//    to 128 reads) take WPR = 4 warps a read at C = 4, one block a read:
//    a row's latency is that of 4 lanes, not 16.  The warps exchange
//    their totals and first x through a double-buffered shared slot with
//    ONE barrier a row: a slot written for row i is next written for row
//    i + 2, after every warp has passed barrier i + 1 and so has finished
//    reading it.  The wrapper picks the route by the launch's read count.
//  * No load on a row's chain.  The band's steps come as bits, 32 rows a
//    word, behind the base table; the read's codes four rows a word, the
//    same word in every thread; the draft code a thread takes in when the
//    band moves from a word of four fetched at least four moves ahead.
//    Each word is fetched one ahead of the one in use.
//  * Four rows at once where nothing special happens: when the next four
//    rows lie in one word of the read, the band moves in each and every
//    lane stays a valid column (all but the first and last W / 2 rows of
//    a read that fills its draft), the rows run without the select on the
//    step and without the valid masks, and the draft codes move by
//    register renaming.  Other rows take the general form one at a time.
//  * Two bits a direction.  A thread packs its C lanes into C / 4 bytes;
//    a row is W / 4 bytes (one coalesced 32 B store a warp at W = 128)
//    and a read's scratch (R + 1) W / 4 bytes: 16,416 B at S=512/W=128.
//  * Directions in a global scratch a quarter the size of one byte a
//    cell.  Keeping them in dynamic shared memory instead was built and
//    measured slower at every shape that fits (0.46 ms against 0.33 at
//    2048 reads of S=512/W=128): the walk's loads are off its chain
//    either way, and shared memory holds fewer reads an SM (14 at
//    S=512/W=128, 7 at S=1024) than registers allow.  It was taken out.
//  * A walk that does not scan bytes.  The warp loads whole packed rows
//    (32 words: 4 rows at W = 128, 2 at 256, 1 at 512), eight such loads
//    ahead of the row it resolves; the loads do not depend on the walk's
//    state, so their latency (L2, or device memory where a launch's
//    scratch outgrows L2) is off the chain, and the band's base steps
//    down by the same step bits.  "Nearest non-LEFT cell at or left of
//    lane" is bit work: each thread masks the non-LEFT cells of its word
//    (high bit of the 2-bit code clear), cut at the lane; __ballot_sync +
//    __clz pick the word, __clz the cell, one __shfl_sync brings it back.
//    The emitters' state (cur_op / cur_len, anchor / b_a / b_b) is a
//    serial chain of R steps replicated in the warp; thread 0 writes.
//    That chain, and the R-row chain of the DP before it, is the kernel's
//    floor for one read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -100000000;
constexpr int kMin = -(1 << 30);  // below every score; safe to add gap*k to
constexpr int kDiag = 0;
constexpr int kUp = 1;
constexpr int kLeft = 2;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxReadsPerBlock = 16;  // WPR = 1: warps (reads) a block

template <bool V>
struct Flag {
  static constexpr bool value = V;
};

struct Problem {
  const uint8_t* reads;    // (B, R) codes 0-3, 4 = pad
  const int32_t* r_lens;   // (B,)
  const uint8_t* drafts;   // (B, D)
  const int32_t* d_lens;   // (B,)
  const int32_t* base;     // (R + 1,) lane-0 draft column per row, then
  const uint32_t* steps;   // (R / 32 + 1,) words: bit i & 31 of word i >> 5
                           // is base[i] - base[i - 1], the band's step
  uint8_t* dirs;           // (B, per_read) packed scratch
  size_t per_read;         // (R + 1) * lanes / 4 bytes
  int B, R, D;
  int W;                   // the band: lanes W .. 32 C WPR - 1 are masked
  int match, mismatch, gap;
};

// Rows 1..rows of one read's DP for the thread that owns lanes
// C*g .. C*g + C - 1 (g = 32*wr + t, wr the warp within the read, t the
// lane within the warp); packed directions into `dirs` (row i at byte
// i * W / 4).  Every thread of the read calls it; with WPR > 1 it holds
// one __syncthreads a row, so the block is exactly one read.
template <int C, int WPR>
__device__ __forceinline__ void dp_rows(const Problem& p, int b, int rows,
                                        int dl, uint8_t* dirs, int wr,
                                        int t) {
  constexpr int W = 32 * C * WPR;  // lanes computed; p.W of them the band
  const int wl = p.W - 1;          // the band's last lane
  __shared__ int xch[WPR > 1 ? 4 * WPR : 1];  // [row parity][totals | x0]
  const int g = 32 * wr + t;
  const int k0 = C * g;
  const int D = p.D;
  const int gap = p.gap;
  const int R = p.R;
  const uint8_t* __restrict__ read = p.reads + (size_t)b * R;
  const uint8_t* __restrict__ draft = p.drafts + (size_t)b * D;
  auto fetch = [&](int jj) -> int {  // draft code of column jj + 1
    jj = jj < 0 ? 0 : (jj > D ? D : jj);
    return jj == D ? 4 : (int)__ldg(draft + jj);
  };
  // Nothing a row reads from memory is loaded in that row.  The band's
  // steps come 32 rows a word and the read's codes 4 rows a word (the
  // same word in every thread), each fetched one word ahead; the draft
  // code a thread takes in when the band moves comes from a word of 4
  // fetched at least 4 moves ahead (R and D are multiples of 4).
  const uint32_t* __restrict__ steps = p.steps;
  const int last_sw = R >> 5;
  uint32_t sw = __ldg(steps);
  uint32_t sw_nxt = __ldg(steps + (last_sw < 1 ? last_sw : 1));
  const uint32_t* __restrict__ rwords =
      reinterpret_cast<const uint32_t*>(read);
  const int last_rw = (R >> 2) - 1;
  uint32_t rw = __ldg(rwords);
  uint32_t rw_nxt = __ldg(rwords + (last_rw < 1 ? last_rw : 1));
  const uint32_t* __restrict__ dwords =
      reinterpret_cast<const uint32_t*>(draft);
  auto dword = [&](int wi) -> uint32_t {  // codes 4 wi .. 4 wi + 3; 4 past D
    return 4 * wi < D ? __ldg(dwords + wi) : 0x04040404u;
  };

  int h[C];   // previous row, own lanes (NEG where invalid)
  int dc[C];  // draft codes under own lanes for the current base
  int b_prev = __ldg(p.base);
  int nb = b_prev + k0 + C - 1;  // the draft code taken in on the next move
  uint32_t dw = dword(nb >> 2);
  uint32_t dw_nxt = dword((nb >> 2) + 1);
  const int v0 = min(dl, wl);  // row 0: lane k is valid iff k <= v0
#pragma unroll
  for (int c = 0; c < C; ++c) {
    h[c] = (k0 + c <= v0) ? gap * (k0 + c) : kNeg;
    dc[c] = fetch(b_prev + k0 + c - 1);
  }
  // previous row at lane k0 - 1 and at lane k0 + C
  int hl = (k0 >= 1 && k0 - 1 <= v0) ? gap * (k0 - 1) : kNeg;
  int hr = (k0 + C < W && k0 + C <= v0) ? gap * (k0 + C) : kNeg;

  // One DP row i with the band's step s, the read's code rc and the
  // draft codes dcur[0 .. C - 1] under the thread's lanes.  FAST: the band
  // moved (s = 1) and every lane of the band is a valid column, so the
  // row needs no select on s and no valid mask.
  auto row = [&](auto fast, int i, int s, int rc, const int* dcur) {
    constexpr bool FAST = decltype(fast)::value;
    int dg[C], up[C];
    if (FAST || s) {  // the band moved one column: lane k sits where k + 1 sat
#pragma unroll
      for (int c = 0; c < C; ++c) {
        dg[c] = h[c];
        up[c] = (c + 1 < C) ? h[c + 1] : hr;
      }
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        dg[c] = c ? h[c - 1] : hl;
        up[c] = h[c];
      }
    }
    b_prev += FAST ? 1 : s;
    const int vk = min(dl - b_prev, wl);  // lane k is valid iff k <= vk
    int cd[C], cu[C], px[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      cd[c] = dg[c] + ((rc == dcur[c]) ? p.match : p.mismatch);
      cu[c] = up[c] + gap;
      int m = max(cd[c], cu[c]);
      if (!FAST) m = (k0 + c <= vk) ? m : kNeg;
      const int x = m - gap * (k0 + c);
      px[c] = c ? max(px[c - 1], x) : x;  // prefix max inside the thread
    }
    // the right neighbour's first x, needed only after the scan
    int xr = __shfl_down_sync(kFull, px[0], 1);
    int incl = px[C - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      // threads below `off` get their own value back: max leaves it
      incl = max(incl, __shfl_up_sync(kFull, incl, off));
    }
    int excl = __shfl_up_sync(kFull, incl, 1);
    if (t == 0) excl = kMin;
    if (WPR > 1) {
      int* slot = xch + (i & 1) * 2 * WPR;
      if (t == 31) slot[wr] = incl;
      if (t == 0) slot[WPR + wr] = px[0];
      __syncthreads();
      int pre = kMin;
      for (int w = 0; w < wr; ++w) pre = max(pre, slot[w]);
      excl = max(excl, pre);
      incl = max(incl, pre);
      if (t == 31 && wr + 1 < WPR) xr = slot[WPR + wr + 1];
    }
    unsigned code = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int hh = gap * (k0 + c) + max(px[c], excl);
      const unsigned d =
          (hh == cd[c]) ? kDiag : ((hh == cu[c]) ? kUp : kLeft);
      code |= d << (2 * c);
      h[c] = (FAST || k0 + c <= vk) ? hh : kNeg;
    }
    hl = (k0 >= 1 && (FAST || k0 - 1 <= vk)) ? gap * (k0 - 1) + excl : kNeg;
    hr = (k0 + C < W && (FAST || k0 + C <= vk))
             ? gap * (k0 + C) + max(incl, xr)
             : kNeg;
    uint8_t* out = dirs + (size_t)i * (W / 4);
    if (C == 4) {
      out[g] = (uint8_t)code;
    } else if (C == 8) {
      reinterpret_cast<uint16_t*>(out)[g] = (uint16_t)code;
    } else {
      reinterpret_cast<uint32_t*>(out)[g] = code;
    }
  };

  int i = 1;
  while (i <= rows) {
    if ((i & 31) == 0) {
      sw = sw_nxt;
      const int m = (i >> 5) + 1;
      sw_nxt = __ldg(steps + (m > last_sw ? last_sw : m));
    }
    const int i0 = i - 1;
    if (i0 && (i0 & 3) == 0) {
      rw = rw_nxt;
      const int m = (i0 >> 2) + 1;
      rw_nxt = __ldg(rwords + (m > last_rw ? last_rw : m));
    }
    // the steps of rows i .. i + 3
    const unsigned s4 = __funnelshift_r(sw, sw_nxt, i & 31) & 15u;
    if ((i0 & 3) == 0 && i + 3 <= rows && s4 == 15u && wl == W - 1 &&
        dl - (b_prev + 4) >= W - 1) {
      // Four rows at once (uniform in the read): one word of the read,
      // the band moving in each, all lanes valid to the last of them.
      // The draft codes move by renaming, not by copying: row q reads
      // d8[q + 1 .. q + C], the last four from one funnel shift.
      const uint32_t n4 = __funnelshift_r(dw, dw_nxt, 8 * (nb & 3));
      nb += 4;
      dw = dw_nxt;
      dw_nxt = dword((nb >> 2) + 1);
      int d8[C + 4];
#pragma unroll
      for (int c = 0; c < C; ++c) d8[c] = dc[c];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        d8[C + q] = (int)__byte_perm(n4, 0, 0x4440 + q);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        row(Flag<true>{}, i + q, 1, (int)__byte_perm(rw, 0, 0x4440 + q),
            d8 + q + 1);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) dc[c] = d8[c + 4];
      if ((i & 31) == 29) {  // row i + 3 began a step word
        sw = sw_nxt;
        const int m = ((i + 3) >> 5) + 1;
        sw_nxt = __ldg(steps + (m > last_sw ? last_sw : m));
      }
      i += 4;
    } else {
      const int s = s4 & 1;
      if (s) {
#pragma unroll
        for (int c = 0; c + 1 < C; ++c) dc[c] = dc[c + 1];
        dc[C - 1] = (int)__byte_perm(dw, 0, 0x4440 + (nb & 3));
        if ((++nb & 3) == 0) {  // k0 is a multiple of 4: uniform in the read
          dw = dw_nxt;
          dw_nxt = dword((nb >> 2) + 1);
        }
      }
      row(Flag<false>{}, i, s, (int)__byte_perm(rw, 0, 0x4440 + (i0 & 3)),
          dc);
      ++i;
    }
  }
}

// The traceback of one read by one warp: rows r = rl .. 1.  In each row
// the nearest non-LEFT cell at or left of column j ends the LEFT run
// (draft deletions consumed silently); it gives the act (DIAG or UP) and
// its column jp.  Out of band, or no such cell: a forced UP at jp = j.
// Calls em.row(r, d, jp, j) per row in every thread (uniform state) and
// returns the final j.
template <int W, class Emit>
__device__ __forceinline__ int walk(const Problem& p, const uint8_t* dirs,
                                    int rl, int dl, int t, Emit& em) {
  constexpr int NW = W / 16;  // 32-bit words a row, 16 lanes each
  constexpr int G = 32 / NW;  // rows a warp-wide load
  constexpr int PF = 8;       // loads in flight: PF * G rows ahead
  const uint32_t* words = reinterpret_cast<const uint32_t*>(dirs);
  // the band's base per row, stepped down from base[rl] by the step bits
  // (one word for 32 rows, fetched a word ahead): no load a row
  const uint32_t* __restrict__ steps = p.steps;
  const int r0 = rl < 1 ? 0 : rl;
  int b_r = __ldg(p.base + r0);
  uint32_t sw = __ldg(steps + (r0 >> 5));
  uint32_t sw_nxt = __ldg(steps + ((r0 >> 5) < 1 ? 0 : (r0 >> 5) - 1));
  const int q = t % NW;
  const int gi = t / NW;
  auto load = [&](int r_top) -> uint32_t {
    const int r = r_top - gi;
    return r >= 1 ? words[(size_t)r * NW + q] : 0xaaaaaaaau;  // all LEFT
  };
  int j = dl;
  uint32_t cur[PF];
#pragma unroll
  for (int u = 0; u < PF; ++u) cur[u] = load(rl - u * G);
  for (int r_top = rl; r_top >= 1; r_top -= PF * G) {
    // the next PF loads go out before this batch's rows are resolved:
    // they depend on r only, never on the walk's state
    uint32_t nxt[PF];
#pragma unroll
    for (int u = 0; u < PF; ++u) nxt[u] = load(r_top - (PF + u) * G);
#pragma unroll
    for (int u = 0; u < PF; ++u) {
#pragma unroll
      for (int gg = 0; gg < G; ++gg) {
        const int r = r_top - u * G - gg;
        if (r >= 1) {  // uniform across the warp
          const uint32_t w = cur[u];
          const int L = j - b_r;
          const int qL = L >> 4;
          // odd bit 2c + 1 set: cell c of this word is not LEFT
          uint32_t m = ~w & 0xaaaaaaaau;
          if (q == qL) m &= 0xffffffffu >> (30 - 2 * (L & 15));
          if (q > qL || gi != gg || (unsigned)L >= (unsigned)p.W) m = 0;
          unsigned bal = __ballot_sync(kFull, m != 0);
          bal = (bal >> (gg * NW)) & (kFull >> (32 - NW));
          const int cell = ((31 - __clz(m)) >> 1) & 15;
          const int mine = (cell << 1) | (int)((w >> (2 * cell)) & 1u);
          const int qs = 31 - __clz(bal);  // -1: none, a forced UP at j
          const int a =
              __shfl_sync(kFull, mine, gg * NW + (qs & (NW - 1)));
          const int d = bal ? (a & 1) : kUp;
          const int jp = bal ? b_r + 16 * qs + (a >> 1) : j;
          em.row(r, d, jp, j);
          j = (d == kDiag) ? jp - 1 : jp;
          b_r -= (sw >> (r & 31)) & 1;
          if ((r & 31) == 0) {
            sw = sw_nxt;
            const int m = (r >> 5) - 2;
            sw_nxt = __ldg(steps + (m < 0 ? 0 : m));
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < PF; ++u) cur[u] = nxt[u];
  }
  return j;
}

// planes (B, 3D + 256) uint8, filled with 4 by the caller:
//   [0, D)            aligned read base at draft column jp - 1
//   [D, D + DQ)       1st inserted base after column q - 1 (DQ = D + 128)
//   [D + DQ, D + 2DQ) 2nd inserted base
// stats (B, 2) int32: min / max aligned column (1<<29 / -1 if none).
struct VotesOut {
  uint8_t* planes;
  int32_t* stats;
};

struct VotesEmit {
  using Out = VotesOut;
  uint8_t *pb, *pa, *pa2;
  int32_t* st;
  const uint8_t* read;
  int D, DQ;
  bool writer;
  int anchor = -9;  // insertion-run anchor column; >= -1 while a run is open
  int b_a = 4;      // the open run's 1st inserted base (read order)
  int b_b = 4;      // its 2nd
  int jmn = 1 << 29;
  int jmx = -1;

  __device__ VotesEmit(const Problem& p, const Out& o, int b, bool w)
      : pb(o.planes + (size_t)b * (3 * p.D + 256)),
        st(o.stats + 2 * (size_t)b),
        read(p.reads + (size_t)b * p.R),
        D(p.D),
        DQ(p.D + 128),
        writer(w) {
    pa = pb + D;
    pa2 = pa + DQ;
  }
  __device__ void flush() {
    const int q = anchor + 1;
    if (writer && q >= 0 && q < DQ) {
      pa[q] = (uint8_t)b_a;
      pa2[q] = (uint8_t)b_b;
    }
  }
  __device__ void row(int r, int d, int jp, int) {
    const bool is_diag = d == kDiag;
    const bool is_up = !is_diag;
    const int rb = read[r - 1] & 3;
    if (is_diag) {
      const int c = jp - 1;
      if (writer && c >= 0 && c < D) pb[c] = (uint8_t)rb;
      jmn = min(jmn, c);
      jmx = max(jmx, c);
    }
    // consecutive UP acts at one anchor form a run; flush it at
    // q = anchor + 1 on the next act that does not continue it
    const int anchor_now = jp - 1;
    const bool same_run = is_up && anchor == anchor_now;
    const bool ended = anchor >= -1 && !same_run;
    if (ended) flush();
    const int next_b = same_run ? b_a : (is_up ? 4 : b_b);
    b_a = is_up ? rb : (ended ? 4 : b_a);
    b_b = next_b;
    anchor = is_up ? anchor_now : (ended ? -9 : anchor);
  }
  __device__ void finish(int) {
    if (anchor >= -1) flush();  // a run still open when the walk leaves row 1
    if (writer) {
      st[0] = jmn;
      st[1] = jmx;
    }
  }
};

// runs (B, maxr) int32, zeroed by the caller: (len - 1) << 2 | op with
// op M=0, I=1, D=2, in traceback order.  n_runs (B,) int32: the true run
// count (> maxr: the list overflowed and the caller realigns on host).
struct CigarOut {
  int32_t* runs;
  int32_t* n_runs;
  int maxr;
};

struct CigarEmit {
  using Out = CigarOut;
  int32_t* out;
  int32_t* n_out;
  int maxr;
  bool writer;
  int n = 0;
  int cur_op = -1;
  int cur_len = 0;

  __device__ CigarEmit(const Problem&, const Out& o, int b, bool w)
      : out(o.runs + (size_t)b * o.maxr),
        n_out(o.n_runs + b),
        maxr(o.maxr),
        writer(w) {}
  __device__ void emit(int op, int len) {
    if (writer && n < maxr) out[n] = ((len - 1) << 2) | op;
    ++n;
  }
  __device__ void row(int, int d, int jp, int j) {
    if (j == jp && d == cur_op) {  // the common row: the open run grows
      ++cur_len;
      return;
    }
    const int len_d = j - jp;  // the LEFT run consumed before the act
    if (len_d > 0) {
      if (cur_len > 0) emit(cur_op, cur_len);
      emit(kLeft, len_d);
      cur_len = 0;
    }
    if (cur_len > 0 && cur_op != d) emit(cur_op, cur_len);
    cur_len = (cur_len > 0 && cur_op == d) ? cur_len + 1 : 1;
    cur_op = d;
  }
  __device__ void finish(int j) {
    if (cur_len > 0) emit(cur_op, cur_len);
    if (j > 0) emit(kLeft, j);  // the leading deletion run
    if (writer) *n_out = n;
  }
};

// mapping (B, R) int32, filled with -1 by the caller: jp - 1 for a read
// base aligned to draft column jp - 1 (DIAG), -(jp + 2) for a base
// inserted after column jp - 1 (UP).
struct MappingOut {
  int32_t* mapping;
};

struct MappingEmit {
  using Out = MappingOut;
  int32_t* out;
  bool writer;

  __device__ MappingEmit(const Problem& p, const Out& o, int b, bool w)
      : out(o.mapping + (size_t)b * p.R), writer(w) {}
  __device__ void row(int r, int d, int jp, int) {
    if (writer) out[r - 1] = (d == kDiag) ? jp - 1 : -(jp + 2);
  }
  __device__ void finish(int) {}
};

// WPR = 1: a block is blockDim.x / 32 reads, one warp each.  WPR > 1: a
// block is one read of WPR warps; warp 0 walks.
template <class Emit, int C, int WPR>
__global__ void __launch_bounds__(WPR == 1 ? 32 * kMaxReadsPerBlock
                                           : 32 * WPR)
    rowscan_kernel(Problem p, typename Emit::Out out) {
  constexpr int W = 32 * C * WPR;
  const int t = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = WPR == 1 ? blockIdx.x * (blockDim.x >> 5) + warp
                         : blockIdx.x;
  const int wr = WPR == 1 ? 0 : warp;
  if (b >= p.B) return;  // WPR == 1 only: the last block's spare warps
  const int rl = p.r_lens[b];
  const int dl = p.d_lens[b];
  uint8_t* dirs = p.dirs + (size_t)b * p.per_read;
  dp_rows<C, WPR>(p, b, rl < 0 ? 0 : (rl < p.R ? rl : p.R), dl, dirs, wr,
                  t);
  if (WPR > 1) {
    __syncthreads();  // every warp's rows visible to the walking warp
    if (wr != 0) return;
  } else {
    __syncwarp();
  }
  Emit em(p, out, b, t == 0);
  int j = dl;
  if (rl <= p.R) j = walk<W>(p, dirs, rl, dl, t, em);
  em.finish(j);
}

template <class Emit, int C, int WPR>
cudaError_t launch_as(const Problem& p, const typename Emit::Out& out,
                      int reads_per_block, cudaStream_t stream) {
  if (WPR > 1) reads_per_block = 1;
  if (reads_per_block < 1 || reads_per_block > kMaxReadsPerBlock) {
    return cudaErrorInvalidValue;
  }
  const int blocks = (p.B + reads_per_block - 1) / reads_per_block;
  rowscan_kernel<Emit, C, WPR>
      <<<blocks, 32 * WPR * reads_per_block, 0, stream>>>(p, out);
  return cudaGetLastError();
}

// The routes: (lanes a thread C, warps a read WPR), 32 C WPR >= W lanes.
template <class Emit>
int launch(const void* reads, const void* r_lens, const void* drafts,
           const void* d_lens, const void* base, void* dirs,
           const typename Emit::Out& out, int B, int R, int D, int W,
           int match, int mismatch, int gap, int C, int wpr,
           int reads_per_block, void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || C * wpr * 32 < W || R % 4 || D % 4 || dirs == nullptr ||
      (reinterpret_cast<uintptr_t>(reads) |
       reinterpret_cast<uintptr_t>(drafts)) % 4) {
    return (int)cudaErrorInvalidValue;
  }
  Problem p;
  p.reads = static_cast<const uint8_t*>(reads);
  p.r_lens = static_cast<const int32_t*>(r_lens);
  p.drafts = static_cast<const uint8_t*>(drafts);
  p.d_lens = static_cast<const int32_t*>(d_lens);
  p.base = static_cast<const int32_t*>(base);
  p.steps = reinterpret_cast<const uint32_t*>(p.base + R + 1);
  p.dirs = static_cast<uint8_t*>(dirs);
  p.per_read = (size_t)(R + 1) * (8 * C * wpr);
  p.B = B;
  p.R = R;
  p.D = D;
  p.W = W;
  p.match = match;
  p.mismatch = mismatch;
  p.gap = gap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (C == 4 && wpr == 1) {
    err = launch_as<Emit, 4, 1>(p, out, reads_per_block, s);
  } else if (C == 8 && wpr == 1) {
    err = launch_as<Emit, 8, 1>(p, out, reads_per_block, s);
  } else if (C == 16 && wpr == 1) {
    err = launch_as<Emit, 16, 1>(p, out, reads_per_block, s);
  } else if (C == 4 && wpr == 4) {
    err = launch_as<Emit, 4, 4>(p, out, reads_per_block, s);
  }
  return (int)err;
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`,
// does not synchronise, and returns the CUDA error of the launch (0: ok).
// The route is the caller's: C lanes a thread and wpr warps a read, (C,
// wpr) in (4,1) (8,1) (16,1) (4,4), for a band of W <= 32 * C * wpr lanes;
// R and D are multiples of 4, `reads` and `drafts` 4-byte aligned, and
// `base` holds R + 1 bases, then R / 32 + 1 step words; reads_per_block
// warps (reads) a block when wpr == 1; `dirs` is a global scratch of
// B * (R + 1) * 8 * C * wpr bytes.
extern "C" {

int hx_rowscan_votes(const void* reads, const void* r_lens,
                     const void* drafts, const void* d_lens,
                     const void* base, void* dirs, void* planes,
                     void* stats, int B, int R, int D, int W, int match,
                     int mismatch, int gap, int C, int wpr,
                     int reads_per_block, void* stream) {
  VotesOut out{static_cast<uint8_t*>(planes), static_cast<int32_t*>(stats)};
  return launch<VotesEmit>(reads, r_lens, drafts, d_lens, base, dirs, out,
                           B, R, D, W, match, mismatch, gap, C, wpr,
                           reads_per_block, stream);
}

int hx_rowscan_cigar(const void* reads, const void* r_lens,
                     const void* drafts, const void* d_lens,
                     const void* base, void* dirs, void* runs, void* n_runs,
                     int B, int R, int D, int W, int match, int mismatch,
                     int gap, int maxr, int C, int wpr, int reads_per_block,
                     void* stream) {
  if (maxr <= 0) return (int)cudaErrorInvalidValue;
  CigarOut out{static_cast<int32_t*>(runs), static_cast<int32_t*>(n_runs),
               maxr};
  return launch<CigarEmit>(reads, r_lens, drafts, d_lens, base, dirs, out,
                           B, R, D, W, match, mismatch, gap, C, wpr,
                           reads_per_block, stream);
}

int hx_rowscan_mapping(const void* reads, const void* r_lens,
                       const void* drafts, const void* d_lens,
                       const void* base, void* dirs, void* mapping, int B,
                       int R, int D, int W, int match, int mismatch, int gap,
                       int C, int wpr, int reads_per_block, void* stream) {
  MappingOut out{static_cast<int32_t*>(mapping)};
  return launch<MappingEmit>(reads, r_lens, drafts, d_lens, base, dirs, out,
                             B, R, D, W, match, mismatch, gap, C, wpr,
                             reads_per_block, stream);
}

}  // extern "C"
