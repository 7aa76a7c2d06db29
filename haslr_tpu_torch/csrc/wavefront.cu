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
// hx_wavefront_dirs agrees on every cell, and the other two on every
// output.
//
// The bound.  Inputs and outputs are a few MB (the direction scratch is
// neither), so the kernels are bound by operations, over 132 SMs x 64
// int32 lanes x 1.98 GHz = 16.7 T/s.  The mapping and votes kernels need 8
// int32 operations a cell (the score 2, three candidate adds, two maxes,
// the tag cleared: no gate, no upper mask and no direction compare, see
// "three forms" below) on (r_len + d_len) x W cells a read: 0.070 ms for
// 2048 ragged reads at S=512, W=128.  hx_wavefront_dirs owes the
// reference's direction on every cell, so it needs the recurrence as it is
// written, 18 a cell (the score 2, three adds, their gates 5, two maxes,
// the direction 4, the valid mask 2), on all R + D diagonals (0.289 ms at
// that shape), and writes a byte a cell: (R + D + 1) B W bytes at
// 3.35 TB/s.
//
// What holds the kernels on the card (NVIDIA H100 80GB HBM3, 700 W,
// clock64() stamps).  A read is a serial chain of r_len + d_len
// diagonals, then a serial chain of walk moves.  One warp alone on an SM
// takes about 320 cycles a diagonal at C = 4 (some 70 instructions, most
// of them waiting on the one before: the warp runs in order) and about
// 175 cycles a diagonal of walk; sixteen warps an SM take 475 and 200.
// A launch of one wave (2048 reads) ends with its longest read, so it is
// held by that latency; a launch of many waves by instruction rate: the
// int32 pipe takes a warp instruction every two cycles, and every thread
// of the warp repeats the walk's serial state.
//
// Design.
//  * Several lanes a thread, two diagonals in registers.  A thread owns C
//    consecutive band lanes and keeps H[t-1] for them, and the C + 1
//    values of H[t-2] that were its `left` and `up` at step t - 1.  One
//    warp a read where the band fits (C = 4 / 8 / 16 at 128 / 256 / 512
//    lanes), several reads a block, no shared memory, no barrier.
//  * One shuffle a step.  `up` is lane k + s1 and `left` lane k + s1 - 1
//    of H[t-1], so of another thread's lanes a thread needs its left
//    neighbour's last (s1 = 0) or its right neighbour's first (s1 = 1):
//    one __shfl_sync, in a direction uniform over the launch.  The
//    diagonal value needs none: diag(t)[k] = H[t-2][k + s1(t) + s1(t-1) - 1]
//    is the `left` (s1(t) = 0) or the `up` (s1(t) = 1) that the lane held
//    at step t - 1.
//  * Small launches at 512 lanes (the extension's largest buckets) take
//    four warps a read at C = 4, one block a read: a diagonal's latency is
//    that of 4 lanes a thread, not 16.  The warps' edge threads exchange
//    their scores through a double-buffered shared slot with ONE barrier a
//    diagonal.  Measured (mapping kernel) at 64 reads of S=4096: 1.87 ms
//    against 2.98 with one warp a read; at 256 reads 2.13 against 3.03;
//    512 reads are a tie (2.96, 3.04), and at 1024 reads of S=1024 one
//    warp a read wins, 0.95 against 1.26.  The wrapper picks the route by
//    the launch's read count.
//  * DPX, and the direction for nothing.  Scores are kept times four and
//    each candidate carries a tag in the two low bits (DIAG 2, UP 1,
//    LEFT 0), so the maximum of the tagged candidates is the score and, in
//    its low bits, the direction in the reference's tie order (DIAG, then
//    UP, then LEFT): two __viaddmax_s32 (VIADDMNMX: max(a + b, c)) a cell
//    in the ungated forms, one __vimax3_s32 (VIMNMX3) in the gated one, no
//    compare and no select for the direction.
//  * No load on a step's chain.  The band's steps come as bits, 32
//    diagonals a word, behind the base table.  The codes slide: when the
//    band stays, every lane's read row grows by one, so the thread's read
//    codes move one lane up and its lane 0 takes in the next code of the
//    read; when the band advances, the draft codes move one lane down and
//    the last lane takes in the next code of the draft.  A thread keeps
//    its C read codes and C draft codes four bits each in two 64-bit
//    words, so a move is a shift and an or, and "codes equal" a bit test
//    of their xor.  Codes come four a word, fetched a word ahead (rows are
//    padded to a multiple of four with code 4; indices below 0 are never
//    used by a cell that counts, indices past the row read 4).
//  * Three forms of a diagonal.  hx_wavefront_dirs must give the
//    reference's direction on every cell, so it keeps every gate and the
//    whole valid mask (the general form) except where every lane has
//    1 <= i <= r_len and 1 <= j <= d_len: there the gates and the mask are
//    no-ops and the fast form drops them.  The mapping and votes kernels
//    never take the general form: their diagonals run ungated, with lanes
//    of i < 0 (or k >= W) masked to NEG (the masked form), or with no mask
//    at all once every lane has i >= 0 and the band fills its lanes (the
//    fast form).  Why that is exact for them:
//    (a) the walk starts at (r_len, d_len) and only decreases i and j, and
//    the edge rules override the stored direction at i == 0 and at j == 0,
//    so only directions of cells with 1 <= i <= r_len, 1 <= j <= d_len
//    reach an output; such a cell's candidates are ungated in the
//    reference too, so its direction is right if its three inputs are.
//    (b) H[i][j] depends only on cells (i', j') with i' <= i and j' <= j,
//    so whatever the missing upper mask leaves in cells past r_len or
//    d_len is an input of no cell that counts.
//    (c) At i == 0 (j >= 1) the reference gates cand_d and cand_u off; here
//    they are NEG + sub and NEG + gap, because row -1 is masked (i < 0) or
//    outside the band (NEG by the exchange's edge rule), and the real
//    cand_l = j * gap is far above NEG; so H[0][j] is right.  The same at
//    j == 0 with lane -1.  So every H[i][j] with 0 <= i <= r_len and
//    0 <= j <= d_len equals the reference's.  Nothing overflows: |4 H|
//    stays below 4e8 + 4 (R + D) |score|.
//  * Two diagonals at once where the band stays in one and advances in
//    the other (its steady state where R == D): the rotation of the kept
//    diagonals and of the code windows becomes register renaming.
//  * Two bits a direction.  A thread packs its C lanes' tags into C / 4
//    bytes, a diagonal is lanes / 4 bytes (one 32 B store a warp at 128
//    lanes), a read's scratch (R + D + 1) lanes / 4 bytes: 32,800 B at
//    S=512/W=128.  hx_wavefront_dirs writes one byte a cell, t-major (the
//    host traceback's layout): C bytes a thread, whole 128 B segments a
//    warp.
//  * The walk, by a warp.  It goes down the diagonals by one (UP, LEFT)
//    or two (DIAG), so the warp loads whole packed diagonals (32 words: 4
//    diagonals at 128 lanes, 2 at 256, 1 at 512) into windows of four
//    diagonals, 16 to 32 diagonals ahead of the one it stands on; the
//    loads do not depend on the walk's state.  The base of a window's top
//    steps down by the same step bits; inside a window it is a population
//    count.  A move is: the cell's word by one __shfl_sync, its two bits,
//    the edge rules (out of band -> LEFT, then i == 0 -> LEFT, then
//    j == 0 -> UP), the emitter, (i, j); moves repeat while the walk
//    stands in the window, so a diagonal it jumps costs nothing.  The
//    state is replicated in the warp; thread 0 writes.
//  * A band of W = 32 .. 480 runs on the next of 128 / 256 / 512 lanes;
//    lanes >= W hold NEG like every lane outside the reference's band.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Probe builds (scripts/torch_wavefront_probe.py; never the port's own
// build).  -DHX_PROBE: the mapping and votes kernels write per read
// [clock64() cycles of the DP, of the walk, diagonals] to the array given
// to hx_set_probe, and end after the DP when its dp_only is set.
// -DHX_PROBE_NO_STORE / -DHX_PROBE_NO_REFILL: the DP without its packed
// direction stores / without its code-word refills (outputs wrong; only
// the stamps are read).
#ifdef HX_PROBE
__device__ long long* g_stamps;
__device__ int g_dp_only;
#endif
#ifdef HX_PROBE_NO_REFILL
#define HX_REFILL(...)
#else
#define HX_REFILL(...) __VA_ARGS__
#endif

namespace {

constexpr int kNeg = -100000000;
constexpr int kDiag = 0;
constexpr int kUp = 1;
constexpr int kLeft = 2;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxReadsPerBlock = 16;  // warps (reads) a block
constexpr uint32_t kPadWord = 0x04040404u;

struct Problem {
  const uint8_t* reads;    // (B, rs) codes 0-3, 4 = pad
  const int32_t* r_lens;   // (B,)
  const uint8_t* drafts;   // (B, ds)
  const int32_t* d_lens;   // (B,)
  const int32_t* base;     // (T + 1,) lane-0 draft column per diagonal, then
  const uint32_t* steps;   // (T / 32 + 1,) words: bit t & 31 of word t >> 5
                           // is base[t] - base[t - 1], the band's step
  int B;
  int R, D;                // the band's shape: T = R + D diagonals
  int rs, ds;              // code row widths, multiples of 4, >= R, D
  int W;                   // the band: lanes W .. 32 C - 1 are masked
  int match, mismatch, gap;
};

// Diagonals 1..t_hi of read b for the thread that owns lanes C g ..
// C g + C - 1 (g = 32 wr + lane, wr the warp within the read).  Every
// thread of the read calls it; with WPR > 1 it holds one __syncthreads a
// diagonal, so the block is exactly one read.  BYTES: one direction byte a
// cell to out[t * stride + k] for the band's lanes, every gate kept on every
// cell; else two bits a cell to out[t * 8 C + g C / 4], and cells past
// r_len / d_len left unmasked where the fast form runs.
template <int C, int WPR, bool BYTES>
__device__ __forceinline__ void dp_diagonals(const Problem& p, int b,
                                             int t_hi, int rl, int dl, int wr,
                                             int lane, uint8_t* out,
                                             size_t stride) {
  constexpr int LANES = 32 * C * WPR;
  // [diagonal parity][first lane | last lane][warp]: the scores a warp's
  // edge threads need of the neighbouring warps
  __shared__ int edge[WPR > 1 ? 4 * WPR : 1];
  int par = 0;
  const int g = 32 * wr + lane;
  const int k0 = C * g;
  const int W = p.W;
  const uint32_t* __restrict__ rwords =
      reinterpret_cast<const uint32_t*>(p.reads + (size_t)b * p.rs);
  const uint32_t* __restrict__ dwords =
      reinterpret_cast<const uint32_t*>(p.drafts + (size_t)b * p.ds);
  const int n_rw = p.rs >> 2;
  const int n_dw = p.ds >> 2;
  auto rword = [&](int wi) -> uint32_t {  // codes 4 wi .. 4 wi + 3 of the read
    return (wi >= 0 && wi < n_rw) ? __ldg(rwords + wi) : kPadWord;
  };
  auto dword = [&](int wi) -> uint32_t {
    return (wi >= 0 && wi < n_dw) ? __ldg(dwords + wi) : kPadWord;
  };
  const uint32_t* __restrict__ steps = p.steps;
  const int last_sw = (p.R + p.D) >> 5;
  uint32_t sw = __ldg(steps);
  uint32_t sw_nxt = __ldg(steps + (last_sw < 1 ? last_sw : 1));

  // Scores are kept times four, the low two bits free for a candidate's
  // tag (DIAG 2, UP 1, LEFT 0): one max over the tagged candidates gives
  // the score and, in its low bits, the direction in the reference's tie
  // order.  |H| < 1e8 + (R + D) * |score| stays far inside int32 times 4.
  constexpr int kNeg4 = 4 * kNeg;
  const int match4 = 4 * p.match + 2;
  const int mismatch4 = 4 * p.mismatch + 2;
  const int gap_u = 4 * p.gap + 1;
  const int gap_l = 4 * p.gap;
  int h1[C];      // 4 H[t-1], own lanes (NEG where invalid)
  int e2[C + 1];  // 4 H[t-2] at the lanes that were left(t-1)[0..C-1], then
                  // up(t-1)[C-1]: diag(t)[c] = e2[c + s1(t)]
#pragma unroll
  for (int c = 0; c < C; ++c) {
    h1[c] = (k0 + c == 0) ? 0 : kNeg4;  // t = 0: cell (0, 0) at lane 0
    e2[c] = kNeg4;
  }
  e2[C] = kNeg4;
  // The code windows, four bits a lane, lane c in bits 4c .. 4c + 3: lane
  // c's read code read[t - bt - k0 - c - 1], its draft code
  // draft[bt + k0 + c - 1].  nr / nd: the index taken in by lane 0 on the
  // next stay step / by lane C - 1 on the next advance step.  k0 is a
  // multiple of 4, so nr & 3 and nd & 3 are uniform in the warp.
  uint64_t rpk = 0x4444444444444444ull;
  uint64_t dpk = 0;
  int nr = -k0;
  int nd = k0 + C - 1;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int jj = k0 + c - 1;
    const uint32_t w = dword(jj >> 2);
    dpk |= (uint64_t)((w >> (8 * (jj & 3))) & 15u) << (4 * c);
  }
  uint32_t rw = rword(nr >> 2);
  uint32_t rw_nxt = rword((nr >> 2) + 1);
  uint32_t dw = dword(nd >> 2);
  uint32_t dw_nxt = dword((nd >> 2) + 1);
  int bt = 0;  // base[0]
  if (WPR > 1) {
    if (lane == 0) edge[wr] = h1[0];
    if (lane == 31) edge[WPR + wr] = h1[C - 1];
    __syncthreads();
  }

  auto stay = [&]() {  // the band stays: read codes one lane up
    const uint64_t in = (rw >> (8 * (nr & 3))) & 15u;
    rpk = (rpk << 4) | in;
    if ((++nr & 3) == 0) {
      HX_REFILL(rw = rw_nxt; rw_nxt = rword((nr >> 2) + 1);)
    }
  };
  auto advance = [&]() {  // the band advances: draft codes one lane down
    ++bt;
    const uint64_t in = (dw >> (8 * (nd & 3))) & 15u;
    dpk = (dpk >> 4) | (in << (4 * (C - 1)));
    if ((++nd & 3) == 0) {
      HX_REFILL(dw = dw_nxt; dw_nxt = dword((nd >> 2) + 1);)
    }
  };
  // The forms of a diagonal.  kFast: no gates and no mask.  kMasked
  // (packed output only): no gates, lanes with i < 0 or k >= W masked.
  // kGeneral: every gate and the whole valid mask.
  constexpr int kFast = 0;
  constexpr int kMasked = 1;
  constexpr int kGeneral = 2;
  // Diagonal t at base b may take the fast form (uniform in the warp):
  // the band fills its lanes and every lane has i >= 0 -- and, for BYTES,
  // 1 <= i <= rl and 1 <= j <= dl.
  auto is_fast = [&](int t, int b) -> bool {
    const int i_min = t - b - (LANES - 1);
    return W == LANES &&
           (BYTES ? (b >= 1 && i_min >= 1 && t - b <= rl &&
                     b + LANES - 1 <= dl)
                  : i_min >= 0);
  };

  // One diagonal t with the band's step S1 (bt and the windows already
  // moved), in form MODE.
  auto step = [&](auto s1_flag, auto mode_flag, int t) {
    constexpr bool S1 = decltype(s1_flag)::value;
    constexpr int MODE = decltype(mode_flag)::value;
    int xch = S1 ? __shfl_down_sync(kFull, h1[0], 1)
                 : __shfl_up_sync(kFull, h1[C - 1], 1);
    if (WPR > 1) {  // across warps: the diagonal before, through `edge`
      const int* e = edge + par * 2 * WPR;
      if (S1) {
        if (lane == 31 && wr + 1 < WPR) xch = e[wr + 1];
      } else {
        if (lane == 0 && wr > 0) xch = e[WPR + wr - 1];
      }
    }
    if (S1 ? g == 32 * WPR - 1 : g == 0) xch = kNeg4;
    const uint64_t x = rpk ^ dpk;
    const int i0 = t - bt - k0;  // lane c: i = i0 - c, j = j0 + c
    const int j0 = bt + k0;
    const int c_max = min(i0, W - 1 - k0);  // kMasked: lane c valid iff <=
    int hn[C];
    uint32_t tags[BYTES ? C / 4 : 1];  // two bits a lane, or a byte a lane
#pragma unroll
    for (int q = 0; q < (BYTES ? C / 4 : 1); ++q) tags[q] = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int left = S1 ? h1[c] : (c ? h1[c - 1] : xch);
      const int up = S1 ? (c + 1 < C ? h1[c + 1] : xch) : h1[c];
      const int diag = e2[c + (S1 ? 1 : 0)];
      const int sub = ((x >> (4 * c)) & 15u) ? mismatch4 : match4;
      int hp;
      if (MODE != kGeneral) {
        hp = __viaddmax_s32(diag, sub,
                            __viaddmax_s32(up, gap_u, left + gap_l));
        hn[c] = (MODE == kFast || c <= c_max) ? (hp & ~3) : kNeg4;
      } else {
        const int i = i0 - c;
        const int j = j0 + c;
        const int cd = (i >= 1 && j >= 1) ? diag + sub : kNeg4 + 2;
        const int cu = (i >= 1) ? up + gap_u : kNeg4 + 1;
        const int cl = (j >= 1) ? left + gap_l : kNeg4;
        hp = __vimax3_s32(cd, cu, cl);
        const bool valid =
            i >= 0 && i <= rl && j >= 0 && j <= dl && k0 + c < W;
        hn[c] = valid ? (hp & ~3) : kNeg4;
      }
      const uint32_t tag = hp & 3;
      if (BYTES) {
        tags[c >> 2] |= tag << (8 * (c & 3));
      } else {
        tags[0] |= tag << (2 * c);
      }
    }
    // H[t-1] at left(t)[0..C-1] and up(t)[C-1] becomes the next step's e2
    if (S1) {
#pragma unroll
      for (int c = 0; c < C; ++c) e2[c] = h1[c];
      e2[C] = xch;
    } else {
      e2[0] = xch;
#pragma unroll
      for (int c = 0; c < C; ++c) e2[c + 1] = h1[c];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) h1[c] = hn[c];
    if (WPR > 1) {
      // One barrier a diagonal: the slot written here is read in the next
      // step and written again in the one after, when every warp has
      // passed the next barrier and so has read it.
      par ^= 1;
      int* e = edge + par * 2 * WPR;
      if (lane == 0) e[wr] = hn[0];
      if (lane == 31) e[WPR + wr] = hn[C - 1];
      __syncthreads();
    }
    if (BYTES) {
      if (k0 < W) {  // W is a multiple of 32: a thread's lanes are in or out
        uint32_t d4[4];  // direction bytes: 2 - tag
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          d4[q] = 0x02020202u - tags[q % (C / 4)];
        }
        uint32_t* o =
            reinterpret_cast<uint32_t*>(out + (size_t)t * stride + k0);
        if (C == 4) {
          o[0] = d4[0];
        } else if (C == 8) {
          *reinterpret_cast<uint2*>(o) = make_uint2(d4[0], d4[1]);
        } else {
          *reinterpret_cast<uint4*>(o) =
              make_uint4(d4[0], d4[1], d4[2], d4[3]);
        }
      }
    } else {
      uint8_t* o = out + (size_t)t * (LANES / 4);
#ifdef HX_PROBE_NO_STORE
      if (tags[0] == kFull)  // never: two bits a lane of value 0..2
#endif
      if (C == 4) {
        o[g] = (uint8_t)tags[0];
      } else if (C == 8) {
        reinterpret_cast<uint16_t*>(o)[g] = (uint16_t)tags[0];
      } else {
        reinterpret_cast<uint32_t*>(o)[g] = tags[0];
      }
    }
  };
  using Stay = std::false_type;  // the band's step s1, as a type
  using Advance = std::true_type;
  using Fast = std::integral_constant<int, kFast>;
  // the form of a diagonal that is not fast
  using Slow = std::integral_constant<int, BYTES ? kGeneral : kMasked>;

  int t = 1;
  while (t <= t_hi) {
    if ((t & 31) == 0) {
      sw = sw_nxt;
      const int m = (t >> 5) + 1;
      sw_nxt = __ldg(steps + (m > last_sw ? last_sw : m));
    }
    // the steps of diagonals t and t + 1
    const unsigned s2 = __funnelshift_r(sw, sw_nxt, t & 31) & 3u;
    const bool fast = is_fast(t, bt + (s2 & 1u));
    if (t < t_hi && (s2 == 1u || s2 == 2u) &&
        (BYTES ? fast && is_fast(t + 1, bt + 1) : true)) {
      // Two diagonals at once, the band staying in one and advancing in
      // the other (its steady state where R == D): the rotation of the
      // two kept diagonals is register renaming.  A packed diagonal after
      // a fast one is fast (t - b never decreases).
      auto pair = [&](auto mode) {
        if (s2 == 2u) {
          stay();
          step(Stay{}, mode, t);
          advance();
          step(Advance{}, mode, t + 1);
        } else {
          advance();
          step(Advance{}, mode, t);
          stay();
          step(Stay{}, mode, t + 1);
        }
      };
      if (fast) {
        pair(Fast{});
      } else {
        pair(Slow{});
      }
      if ((t & 31) == 31) {  // diagonal t + 1 began a step word
        sw = sw_nxt;
        const int m = ((t + 1) >> 5) + 1;
        sw_nxt = __ldg(steps + (m > last_sw ? last_sw : m));
      }
      t += 2;
      continue;
    }
    if (s2 & 1u) {
      advance();
      if (fast) {
        step(Advance{}, Fast{}, t);
      } else {
        step(Advance{}, Slow{}, t);
      }
    } else {
      stay();
      if (fast) {
        step(Stay{}, Fast{}, t);
      } else {
        step(Stay{}, Slow{}, t);
      }
    }
    ++t;
  }
}

// The traceback of one read by one warp, from (rl, dl) down the packed
// diagonals of `dirs` (filled up to t_hi; later ones count as LEFT).  One
// move from (i, j) != (0, 0): the stored direction of the cell, LEFT when
// it lies out of band, then LEFT at i == 0, then UP at j == 0 (the order
// of nw.py:245-248).  Calls em.move(i, j, d) per move in every thread
// (uniform state).
template <int LANES, class Emit>
__device__ __forceinline__ void walk(const Problem& p, const uint8_t* dirs,
                                     int rl, int dl, int t_hi, int lane,
                                     Emit& em) {
  constexpr int NW = LANES / 16;  // 32-bit words a diagonal, 16 lanes each
  constexpr int G = 32 / NW;      // diagonals a warp-wide load
  constexpr int WD = 4;           // diagonals a window
  constexpr int WR = WD / G;      // loads (registers) a window: 1, 2 or 4
  constexpr int PF = WR == 1 ? 8 : 4;  // windows in flight
  const uint32_t* words = reinterpret_cast<const uint32_t*>(dirs);
  const int T = p.R + p.D;
  const int t0 = rl + dl;
  // The band's base at a window's top diagonal, stepped down window by
  // window by the step bits (two words held, the lower fetched ahead).
  const uint32_t* __restrict__ steps = p.steps;
  const int tb = t0 > T ? T : (t0 < 0 ? 0 : t0);
  int bt = __ldg(p.base + tb);
  int wi = tb >> 5;  // sw_hi is word wi, sw_lo word wi - 1
  uint32_t sw_hi = __ldg(steps + wi);
  uint32_t sw_lo = wi ? __ldg(steps + wi - 1) : 0u;
  const int q = lane % NW;
  const int gi = lane / NW;
  auto load = [&](int top) -> uint32_t {  // diagonals top - G + 1 .. top
    const int t = top - gi;
    return (t >= 1 && t <= t_hi) ? words[(size_t)t * NW + q]
                                 : 0u;  // all LEFT
  };
  int i = rl;
  int j = dl;
  uint32_t cur[PF][WR];
#pragma unroll
  for (int u = 0; u < PF; ++u) {
#pragma unroll
    for (int r = 0; r < WR; ++r) cur[u][r] = load(t0 - u * WD - r * G);
  }
  for (int t_top = t0; t_top >= 1; t_top -= PF * WD) {
    // the next PF windows' loads go out before this batch is walked: they
    // depend on t only, never on the walk's state
    uint32_t nxt[PF][WR];
#pragma unroll
    for (int u = 0; u < PF; ++u) {
#pragma unroll
      for (int r = 0; r < WR; ++r) {
        nxt[u][r] = load(t_top - (PF + u) * WD - r * G);
      }
    }
#pragma unroll
    for (int u = 0; u < PF; ++u) {
      const int top = t_top - u * WD;  // the window: top - WD + 1 .. top
      if (top < 1) break;              // uniform across the warp
      // x: bit r is the band's step into diagonal lo + r (0 below diagonal
      // 1 and above T), so the base of diagonal top - gg is bt less the
      // count of bits WD - gg .. WD - 1
      const int lo = top - WD + 1;
      uint32_t x = 0;
      if (lo <= T) {
        if (lo < 0) {
          x = sw_hi << (-lo);
        } else if ((lo >> 5) == wi) {
          x = sw_hi >> (lo & 31);
        } else {
          x = __funnelshift_r(sw_lo, sw_hi, lo & 31);
        }
        x &= (1u << (top > T ? T - lo + 1 : WD)) - 1u;
      }
      while (true) {
        const int t = i + j;
        const int gg = top - t;
        if (gg >= WD || t < 1) break;  // the walk left the window, or ended
        const int L = j - (bt - __popc(x >> (WD - gg)));
        uint32_t mine = cur[u][0];
#pragma unroll
        for (int r = 1; r < WR; ++r) {
          if (gg / G == r) mine = cur[u][r];
        }
        const uint32_t w =
            __shfl_sync(kFull, mine, (gg % G) * NW + ((L >> 4) & (NW - 1)));
        int d = 2 - (int)((w >> (2 * (L & 15))) & 3u);  // 2 - tag
        if ((unsigned)L >= (unsigned)p.W) d = kLeft;
        if (i == 0) d = kLeft;
        if (j == 0) d = kUp;
        em.move(i, j, d);
        i -= d != kLeft;
        j -= d != kUp;
      }
      bt -= __popc(x);
      if (lo <= T && lo >= 1 && ((lo - 1) >> 5) != wi) {
        --wi;
        sw_hi = sw_lo;
        sw_lo = wi ? __ldg(steps + wi - 1) : 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < PF; ++u) {
#pragma unroll
      for (int r = 0; r < WR; ++r) cur[u][r] = nxt[u][r];
    }
  }
}

// mapping (B, R) int32, filled with -1 by the caller: j for a read base
// aligned to draft column j, -(a + 3) for a base inserted after column a.
struct MappingOut {
  int32_t* mapping;
};

struct MappingEmit {
  using Out = MappingOut;
  int32_t* out;
  bool writer;

  __device__ MappingEmit(const Problem& p, const Out& o, int b, bool w)
      : out(o.mapping + (size_t)b * p.R), writer(w) {}
  __device__ void move(int i, int j, int d) {
    if (writer && d != kLeft) out[i - 1] = (d == kDiag) ? j - 1 : -(j + 2);
  }
  __device__ void finish() {}
};

// planes (B, 3D + 256) uint8, filled with 4 by the caller:
//   [0, D)            aligned read base at draft column j - 1
//   [D, D + DQ)       1st inserted base after column q - 1 (DQ = D + 128)
//   [D + DQ, D + 2DQ) 2nd inserted base
// stats (B, 2) int32: min / max aligned column (1<<29 / -1 if none).
// The insertion-run emitter is nw_pallas.py:343-414's: consecutive UP
// moves at one anchor form a run; any other move ends it (a LEFT move
// too) and flushes it at q = anchor + 1.
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
        read(p.reads + (size_t)b * p.rs),
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
  __device__ void move(int i, int j, int d) {
    const bool is_diag = d == kDiag;
    const bool is_up = d == kUp;
    const int rb = (i >= 1) ? (read[i - 1] & 3) : 0;
    const int c = j - 1;
    if (is_diag) {
      if (writer && c >= 0 && c < D) pb[c] = (uint8_t)rb;
      jmn = min(jmn, c);
      jmx = max(jmx, c);
    }
    const bool same_run = is_up && anchor == c;
    const bool ended = anchor >= -1 && !same_run;
    if (ended) flush();
    const int next_b = same_run ? b_a : (is_up ? 4 : b_b);
    b_a = is_up ? rb : (ended ? 4 : b_a);
    b_b = next_b;
    anchor = is_up ? c : (ended ? -9 : anchor);
  }
  __device__ void finish() {
    if (anchor >= -1) flush();  // a run still open when the walk reaches (0, 0)
    if (writer) {
      st[0] = jmn;
      st[1] = jmx;
    }
  }
};

// The last diagonal the walk from (r_len, d_len) reads, within [0, T].
__device__ __forceinline__ int walk_end(const Problem& p, int rl, int dl) {
  const int t = rl + dl;
  const int T = p.R + p.D;
  return t < 0 ? 0 : (t > T ? T : t);
}

// WPR = 1: a block is blockDim.x / 32 reads, one warp each.  WPR > 1: a
// block is one read of WPR warps; warp 0 walks.  scratch: per_read =
// (R + D + 1) * 8 C WPR bytes a read.
template <class Emit, int C, int WPR>
__global__ void __launch_bounds__(WPR == 1 ? 32 * kMaxReadsPerBlock
                                           : 32 * WPR)
    wf_walk_kernel(Problem p, uint8_t* scratch, typename Emit::Out out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = WPR == 1 ? blockIdx.x * (blockDim.x >> 5) + warp
                         : blockIdx.x;
  const int wr = WPR == 1 ? 0 : warp;
  if (b >= p.B) return;  // WPR == 1 only: the last block's spare warps
  const int rl = p.r_lens[b];
  const int dl = p.d_lens[b];
  const int t_hi = walk_end(p, rl, dl);
  uint8_t* dirs = scratch + (size_t)b * (p.R + p.D + 1) * (8 * C * WPR);
#ifdef HX_PROBE
  const long long c0 = clock64();
#endif
  dp_diagonals<C, WPR, false>(p, b, t_hi, rl, dl, wr, lane, dirs, 0);
  if (WPR > 1) {
    __syncthreads();  // every warp's diagonals visible to the walking warp
    if (wr != 0) return;
  } else {
    __syncwarp();
  }
#ifdef HX_PROBE
  const long long c1 = clock64();
  if (lane == 0) {
    g_stamps[3 * (size_t)b] = c1 - c0;
    g_stamps[3 * (size_t)b + 2] = t_hi;
  }
  if (g_dp_only) return;
#endif
  Emit em(p, out, b, lane == 0);
  if (rl <= p.R) walk<32 * C * WPR>(p, dirs, rl, dl, t_hi, lane, em);
  em.finish();
#ifdef HX_PROBE
  if (lane == 0) g_stamps[3 * (size_t)b + 1] = clock64() - c1;
#endif
}

// dirs (T + 1, B, W) uint8, t-major; every diagonal of every read.
template <int C, int WPR>
__global__ void __launch_bounds__(WPR == 1 ? 32 * kMaxReadsPerBlock
                                           : 32 * WPR)
    wf_dirs_kernel(Problem p, uint8_t* dirs) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = WPR == 1 ? blockIdx.x * (blockDim.x >> 5) + warp
                         : blockIdx.x;
  const int wr = WPR == 1 ? 0 : warp;
  if (b >= p.B) return;
  uint8_t* out = dirs + (size_t)b * p.W;
  for (int k = 32 * wr + lane; k < p.W; k += 32 * WPR) out[k] = 0;  // t = 0
  dp_diagonals<C, WPR, true>(p, b, p.R + p.D, p.r_lens[b], p.d_lens[b], wr,
                             lane, out, (size_t)p.B * p.W);
}

// 0 when the arguments are what the kernels take.
int fill_problem(Problem& p, const void* reads, const void* r_lens,
                 const void* drafts, const void* d_lens, const void* base,
                 int B, int rs, int ds, int W, int match, int mismatch,
                 int gap, int R, int D, int C, int wpr, int reads_per_block) {
  const bool route = wpr == 1 ? (C == 4 || C == 8 || C == 16)
                              : (wpr == 4 && C == 4 && reads_per_block == 1);
  if (W < 32 || W % 32 || 32 * C * wpr < W || !route ||
      R < 0 || D < 0 || rs < R || ds < D || rs % 4 || ds % 4 ||
      reads_per_block < 1 || reads_per_block > kMaxReadsPerBlock ||
      (reinterpret_cast<uintptr_t>(reads) |
       reinterpret_cast<uintptr_t>(drafts)) % 4) {
    return (int)cudaErrorInvalidValue;
  }
  p.reads = static_cast<const uint8_t*>(reads);
  p.r_lens = static_cast<const int32_t*>(r_lens);
  p.drafts = static_cast<const uint8_t*>(drafts);
  p.d_lens = static_cast<const int32_t*>(d_lens);
  p.base = static_cast<const int32_t*>(base);
  p.steps = reinterpret_cast<const uint32_t*>(p.base + R + D + 1);
  p.B = B;
  p.R = R;
  p.D = D;
  p.rs = rs;
  p.ds = ds;
  p.W = W;
  p.match = match;
  p.mismatch = mismatch;
  p.gap = gap;
  return 0;
}

// The routes: (lanes a thread C, warps a read wpr), 32 C wpr >= W lanes.
template <class Emit>
int launch_walk(const Problem& p, void* scratch,
                const typename Emit::Out& out, int C, int wpr,
                int reads_per_block, void* stream) {
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int blocks = (p.B + reads_per_block - 1) / reads_per_block;
  const int threads = 32 * wpr * reads_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* sc = static_cast<uint8_t*>(scratch);
  if (wpr == 4) {
    wf_walk_kernel<Emit, 4, 4><<<blocks, threads, 0, s>>>(p, sc, out);
  } else if (C == 4) {
    wf_walk_kernel<Emit, 4, 1><<<blocks, threads, 0, s>>>(p, sc, out);
  } else if (C == 8) {
    wf_walk_kernel<Emit, 8, 1><<<blocks, threads, 0, s>>>(p, sc, out);
  } else {
    wf_walk_kernel<Emit, 16, 1><<<blocks, threads, 0, s>>>(p, sc, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`,
// does not synchronise, and returns the CUDA error of the launch (0: ok).
// `reads` and `drafts` are (B, rs) and (B, ds) code rows, rs and ds
// multiples of 4 and the pointers 4-byte aligned; the band is that of
// (R, D, W) with R <= rs and D <= ds, and `base` holds its R + D + 1 bases,
// then (R + D) / 32 + 1 step words.  The route is the caller's: C lanes a
// thread and wpr warps a read, (C, wpr) in (4,1) (8,1) (16,1) (4,4) with
// 32 C wpr >= W, and reads_per_block warps (reads) a block when wpr == 1;
// `scratch` holds B * (R + D + 1) * 8 C wpr bytes.
extern "C" {

int hx_wavefront_dirs(const void* reads, const void* r_lens,
                      const void* drafts, const void* d_lens,
                      const void* base, void* dirs, int B, int rs, int ds,
                      int W, int match, int mismatch, int gap, int R, int D,
                      int C, int wpr, int reads_per_block, void* stream) {
  if (B <= 0) return 0;
  Problem p;
  const int bad = fill_problem(p, reads, r_lens, drafts, d_lens, base, B, rs,
                               ds, W, match, mismatch, gap, R, D, C, wpr,
                               reads_per_block);
  if (bad) return bad;
  const int blocks = (B + reads_per_block - 1) / reads_per_block;
  const int threads = 32 * wpr * reads_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* out = static_cast<uint8_t*>(dirs);
  if (wpr == 4) {
    wf_dirs_kernel<4, 4><<<blocks, threads, 0, s>>>(p, out);
  } else if (C == 4) {
    wf_dirs_kernel<4, 1><<<blocks, threads, 0, s>>>(p, out);
  } else if (C == 8) {
    wf_dirs_kernel<8, 1><<<blocks, threads, 0, s>>>(p, out);
  } else {
    wf_dirs_kernel<16, 1><<<blocks, threads, 0, s>>>(p, out);
  }
  return (int)cudaGetLastError();
}

int hx_wavefront_mapping(const void* reads, const void* r_lens,
                         const void* drafts, const void* d_lens,
                         const void* base, void* scratch, void* mapping,
                         int B, int rs, int ds, int W, int match,
                         int mismatch, int gap, int R, int D, int C, int wpr,
                         int reads_per_block, void* stream) {
  if (B <= 0) return 0;
  Problem p;
  const int bad = fill_problem(p, reads, r_lens, drafts, d_lens, base, B, rs,
                               ds, W, match, mismatch, gap, R, D, C, wpr,
                               reads_per_block);
  if (bad) return bad;
  MappingOut out{static_cast<int32_t*>(mapping)};
  return launch_walk<MappingEmit>(p, scratch, out, C, wpr, reads_per_block,
                                  stream);
}

int hx_wavefront_votes(const void* reads, const void* r_lens,
                       const void* drafts, const void* d_lens,
                       const void* base, void* scratch, void* planes,
                       void* stats, int B, int rs, int ds, int W, int match,
                       int mismatch, int gap, int R, int D, int C, int wpr,
                       int reads_per_block, void* stream) {
  if (B <= 0) return 0;
  Problem p;
  const int bad = fill_problem(p, reads, r_lens, drafts, d_lens, base, B, rs,
                               ds, W, match, mismatch, gap, R, D, C, wpr,
                               reads_per_block);
  if (bad) return bad;
  VotesOut out{static_cast<uint8_t*>(planes), static_cast<int32_t*>(stats)};
  return launch_walk<VotesEmit>(p, scratch, out, C, wpr, reads_per_block,
                                stream);
}

#ifdef HX_PROBE
int hx_set_probe(void* stamps, int dp_only) {
  long long* s = static_cast<long long*>(stamps);
  cudaMemcpyToSymbol(g_stamps, &s, sizeof(s));
  cudaMemcpyToSymbol(g_dp_only, &dp_only, sizeof(int));
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
