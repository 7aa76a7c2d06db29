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
// Code 4 (no vote), and any byte above 3, counts nowhere.  Every (window,
// column) is written, those of windows without a row in this shard with
// zeros, so the tables of several shards sum to the whole batch's.
//
// The bound.  Each plane byte of the 3S+2 used columns is read once and
// each table entry written once: B (3S+2) bytes in, N (3S+2) 16 bytes of
// counts and N (S+1) 4 bytes of coverage out.  At the consensus
// workload's round (N = 4096 windows, B = 53,248 rows, S = 512) that is
// 0.19 GB, 57 us at 3.35 TB/s, 57 % of it the stores; the arithmetic, an
// add a plane byte, is a tenth of that.  So the kernel is bound by bytes,
// and its design is about keeping bytes in flight both ways.
//
// Design.  Work items are (window, column tile): a tile is TC columns of
// each of the three planes (TC = S up to S = 512, else 512, so a window of
// a wide bucket is S/512 items; the last tile of a window also takes the
// insertion planes' column S).  A window's rows are a contiguous range,
// so an item is one reduction over that range and needs no atomics in
// device memory.  The grid is persistent: as many CTAs as fit on the SMs
// (the occupancy API, shared memory decides), CTA b taking items b,
// b + grid, ...; both the producer and the consumers of a CTA walk that
// list.
//
// - One producer warp brings an item's rows into a ring of kStages = 2
//   stages in shared memory, chunks of at most kChunk = 16 rows, one
//   row a lane: one or two 1-D bulk copies (cp.async.bulk, the TMA's
//   copy engine) a plane segment, completing on the stage's `full`
//   mbarrier with the bytes expected.  The segment of an insertion plane
//   is TC + 16 bytes (the plane has S + 1 columns, and 127 pad bytes
//   follow it in a row, so the read stays in the row and keeps the 16-B
//   sizes that the copy needs); where one tile is the whole window, the
//   base plane and the first insertion plane are contiguous in a row and
//   come as one copy.  The lane also reads its row's stats and ok byte
//   and stores (jmin, jmax) in the stage, (-1, -2) for a row that does
//   not vote, then arrives on `full`.  It runs ahead of the consumers by
//   the ring's depth, across items, so the next item's rows land while
//   this one is counted and stored.
// - Eight consumer warps count.  A thread takes one 4-column word of one
//   plane at a time and keeps its 16 counts as four packed registers of
//   four 8-bit counters (code v of byte k in byte k of register v), the
//   codes found with byte-parallel bit arithmetic (a byte votes when its
//   top six bits are 0; bits 0 and 1 then give the code).  A chunk holds
//   at most 16 rows, so the 8-bit counters never overflow; after each
//   chunk they widen into the item's int32 table rows, staged in shared
//   memory (stored after the first chunk, added after later ones), so a
//   window of any depth stays exact.  Warp 0 takes the coverage (two
//   shared-memory atomics a voting row) and the voting rows (a ballot).
//   Then each consumer arrives on the stage's `empty` mbarrier.
// - Epilogue.  The staged table rows of an item are three contiguous
//   slices of the outputs (TC or TC + 1 int4 each, 16-B aligned), written
//   by three bulk stores (cp.async.bulk shared -> global) that one thread
//   issues after a proxy fence and a barrier of the consumers; the
//   coverage (TC or TC + 1 int32, not 16-B aligned) takes ordinary stores
//   on consecutive addresses.  The staging is double-buffered: the next
//   item is counted into the other buffer while the stores drain, and a
//   buffer is reused only after its stores have read it
//   (cp.async.bulk.wait_group.read 1).
//
// Shared memory of a CTA: two staging buffers of (3 TC + 2) int4 and
// TC + 1 int32, and kStages stages of kChunk rows of 3 TC + 32 bytes and
// their (jmin, jmax): 103,808 bytes at TC = 512, so two CTAs an SM (18
// warps).  hx_vote_tables_plan reports the grid and the shared memory of
// a launch.  The settings were chosen on one NVIDIA H100 80GB HBM3
// (700 W) by timing, at the consensus round, builds of this kernel that
// took them as launch arguments: as here 0.078 ms a launch, 73 % of the
// byte bound; 3 or 4 stages (one CTA an SM) 0.093-0.094; 8, 24 or 32
// rows a stage 0.087-0.097; tiles of 256 or 128 columns 0.089 and
// 0.130.  Two CTAs an SM, each with its own ring and stores in flight,
// beat one CTA with a deeper ring.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kConsumers = 256;            // eight counting warps
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kStages = 2;                 // ring stages
constexpr int kChunk = 16;                 // rows a stage, <= 32 lanes
constexpr int kMaxTile = 512;              // widest column tile TC

// TC, the columns of each plane a work item takes: the whole window up
// to kMaxTile, else tiles of kMaxTile (S a multiple of it)
__host__ __device__ inline int tile_of(int S) { return min(S, kMaxTile); }

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
  int off1;    // column of the first insertion plane in a row
  int off2;    // of the second
  int tile;    // TC = tile_of(S)
  int items;   // N * (S / TC)
};

// The carve-up of a CTA's dynamic shared memory, in bytes from its base.
struct Layout {
  int stage_tab;   // int4 table rows of one staging buffer: 3 TC + 2
  int stage_cov;   // int32 coverage of one staging buffer: TC + 1, padded
  int row_bytes;   // one row of a ring stage: 3 TC + 32
  int ring;        // offset of the ring
  int stage_rows;  // bytes of one stage's rows
  int meta;        // offset of the stages' (jmin, jmax)
  int bars;        // offset of the 2 kStages mbarriers
  int total;
};

__host__ __device__ inline Layout layout(int tile) {
  Layout l;
  l.stage_tab = (3 * tile + 2) * 16;
  l.stage_cov = ((tile + 1) * 4 + 15) / 16 * 16;
  l.row_bytes = 3 * tile + 32;
  l.ring = 2 * (l.stage_tab + l.stage_cov);
  l.stage_rows = kChunk * l.row_bytes;
  l.meta = l.ring + kStages * l.stage_rows;
  l.bars = l.meta + kStages * kChunk * 8;
  l.total = l.bars + 2 * kStages * 8;
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// returns once the barrier's phase of this parity has completed; a wait
// of more than ~2^34 cycles (seconds) traps, so that a fault in the ring's
// protocol ends the launch with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  for (int spins = 0; !done; ++spins) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && (spins & 1023) == 1023) {
      const long long now = clock64();
      if (t0 == 0) {
        t0 = now;
      } else if (now - t0 > (1LL << 34)) {
        __trap();
      }
    }
  }
}

// global -> shared, `bytes` (a multiple of 16, both ends 16-B aligned),
// completing on the mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// shared -> global, in the thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the thread's bulk groups but the newest `n` have read their source
template <int n>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(n) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// the consumers' barrier (the producer warp does not take part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// Four plane bytes of one row into the packed counters: byte k of c[v]
// counts byte k of `word` equal to v.  `use` is 0x01010101 for a voting
// row, else 0.  A byte votes when its top six bits are 0 (the exact
// zero-byte test on word & 0xFC..: the add carries into bit 7 of a byte
// only when one of its low seven bits is set, and no carry leaves a
// byte).
__device__ __forceinline__ void tally(uint32_t (&c)[4], uint32_t word,
                                      uint32_t use) {
  const uint32_t high = word & 0xFCFCFCFCu;
  const uint32_t nonzero = ((high & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | high;
  const uint32_t votes = (~nonzero >> 7) & use;  // 0x01 where code 0-3
  const uint32_t b0 = word & 0x01010101u;
  const uint32_t b1 = (word >> 1) & 0x01010101u;
  c[0] += votes & ~(b0 | b1);
  c[1] += votes & b0 & ~b1;
  c[2] += votes & ~b0 & b1;
  c[3] += votes & b0 & b1;
}

__device__ __forceinline__ int packed_byte(uint32_t c, int k) {
  return (int)((c >> (8 * k)) & 0xFFu);
}

// The producer warp: every chunk of every item of this CTA, in order,
// into the ring.
__device__ void produce(const Args& a, const Layout& L, uint8_t* smem,
                        int ntiles) {
  const int lane = threadIdx.x & 31;
  const uint32_t ring = smem_addr(smem + L.ring);
  int2* meta = reinterpret_cast<int2*>(smem + L.meta);
  const uint32_t bars = smem_addr(smem + L.bars);
  const int tc = a.tile;
  // one tile a window: base and first insertion plane in one copy
  const bool merged = ntiles == 1 && a.off1 == tc;
  uint32_t g = 0;  // chunks so far
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int w = item / ntiles;
    const int cb = (item - w * ntiles) * tc;  // first column of the tile
    const int lo = __ldg(a.win_ptr + w);
    const int n = __ldg(a.win_ptr + w + 1) - lo;
    const int nc = n > 0 ? (n + kChunk - 1) / kChunk : 1;
    for (int c = 0; c < nc; ++c, ++g) {
      const int s = g % kStages;
      const uint32_t full = bars + 8 * s;
      const uint32_t empty = bars + 8 * (kStages + s);
      mbar_wait(empty, ((g / kStages) & 1) ^ 1);
      const int r0 = c * kChunk;
      const int rows = min(kChunk, n - r0);
      if (lane == 0) {
        mbar_arrive_expect(full, (uint32_t)(max(rows, 0) * L.row_bytes));
      }
      __syncwarp();
      if (lane < rows) {
        const int row = lo + r0 + lane;
        const uint8_t* src = a.planes + (size_t)row * a.stride;
        const uint32_t dst = ring + s * L.stage_rows + lane * L.row_bytes;
        if (merged) {
          bulk_load(dst, src, 2 * tc + 16, full);
        } else {
          bulk_load(dst, src + cb, tc, full);
          bulk_load(dst + tc, src + a.off1 + cb, tc + 16, full);
        }
        bulk_load(dst + 2 * tc + 16, src + a.off2 + cb, tc + 16, full);
        const int2 st = __ldg(a.stats + row);
        const bool use = __ldg(a.ok + row) != 0 && st.y >= 0;
        meta[s * kChunk + lane] = use ? st : make_int2(-1, -2);
      }
      mbar_arrive(full);
    }
  }
}

// The consumer warps: count every item of this CTA, stage its table rows
// and store them.
__device__ void consume(const Args& a, const Layout& L, uint8_t* smem,
                        int ntiles) {
  const int tid = threadIdx.x;
  const int tc = a.tile;
  const uint8_t* ring = smem + L.ring;
  const int2* meta = reinterpret_cast<const int2*>(smem + L.meta);
  const uint32_t bars = smem_addr(smem + L.bars);
  const int qt = tc / 4;  // whole words of one plane's tile
  uint32_t g = 0;
  int buf = 0;
  for (int item = blockIdx.x; item < a.items; item += gridDim.x,
           buf ^= 1) {
    const int w = item / ntiles;
    const int t = item - w * ntiles;
    const int cb = t * tc;
    const int last = t == ntiles - 1;  // takes the insertion column S
    const int lo = __ldg(a.win_ptr + w);
    const int n = __ldg(a.win_ptr + w + 1) - lo;
    const int nc = n > 0 ? (n + kChunk - 1) / kChunk : 1;
    uint8_t* stage = smem + buf * (L.stage_tab + L.stage_cov);
    int4* tab = reinterpret_cast<int4*>(stage);
    int* cov = reinterpret_cast<int*>(stage + L.stage_tab);
    if (tid == 0) bulk_wait_read<1>();  // this buffer's last stores
    for (int j = tid; j <= tc; j += kConsumers) cov[j] = 0;
    consumers_sync();
    int voting = 0;  // thread 0: the window's voting rows
    const int words = 3 * qt + 2 * last;
    for (int c = 0; c < nc; ++c, ++g) {
      const int s = g % kStages;
      mbar_wait(bars + 8 * s, (g / kStages) & 1);
      const int rows = max(0, min(kChunk, n - c * kChunk));
      const uint8_t* rw = ring + s * L.stage_rows;
      const int2* mt = meta + s * kChunk;
      if (tid < 32) {
        int2 st = make_int2(-1, -2);
        if (tid < rows) st = mt[tid];
        const bool use = st.y >= 0;
        if (use) {
          const int j0 = st.x - cb, j1 = st.y + 1 - cb;
          if (j0 >= 0 && j0 < tc + last) atomicAdd(cov + j0, 1);
          if (j1 >= 0 && j1 < tc + last) atomicAdd(cov + j1, -1);
        }
        const int nv = __popc(__ballot_sync(0xFFFFFFFFu, use));
        if (tid == 0) voting += nv;
      }
      for (int q = tid; q < words; q += kConsumers) {
        int plane = 0, qq = q;
        if (qq >= qt) {
          qq -= qt, plane = 1;
          if (qq >= qt + last) qq -= qt + last, plane = 2;
        }
        const int soff = plane == 0 ? 4 * qq
                                    : (plane == 1 ? tc : 2 * tc + 16) +
                                          4 * qq;
        const int at = (plane == 0 ? 0 : (plane == 1 ? tc : 2 * tc + 1)) +
                       4 * qq;
        const int kv = (plane != 0 && qq == qt) ? 1 : 4;
        uint32_t p[4] = {0u, 0u, 0u, 0u};
#pragma unroll 4
        for (int r = 0; r < rows; ++r) {
          const uint32_t word = *reinterpret_cast<const uint32_t*>(
              rw + r * L.row_bytes + soff);
          tally(p, word, mt[r].y >= 0 ? 0x01010101u : 0u);
        }
        // widen into the int32 rows; the four columns in a rotated order
        // so that a quarter-warp's 16-B stores spread over the banks
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = (j + tid) & 3;
          if (k < kv) {
            int4 v = make_int4(packed_byte(p[0], k), packed_byte(p[1], k),
                               packed_byte(p[2], k), packed_byte(p[3], k));
            if (c > 0) {
              const int4 o = tab[at + k];
              v.x += o.x, v.y += o.y, v.z += o.z, v.w += o.w;
            }
            tab[at + k] = v;
          }
        }
      }
      mbar_arrive(bars + 8 * (kStages + s));
    }
    // the item's rows are staged: make them visible to the bulk copies
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    consumers_sync();
    if (tid == 0) {
      const uint32_t src = smem_addr(tab);
      bulk_store(a.counts + (size_t)w * a.S + cb, src, tc * 16);
      bulk_store(a.ins1 + (size_t)w * (a.S + 1) + cb, src + tc * 16,
                 (tc + last) * 16);
      bulk_store(a.ins2 + (size_t)w * (a.S + 1) + cb,
                 src + (2 * tc + 1) * 16, (tc + last) * 16);
      bulk_commit();
      if (t == 0) a.n_reads[w] = voting;
    }
    int32_t* out = a.cov + (size_t)w * (a.S + 1) + cb;
    for (int j = tid; j < tc + last; j += kConsumers) out[j] = cov[j];
  }
  if (tid == 0) {
    if (blockIdx.x == 0) a.cov[(size_t)a.N * (a.S + 1)] = 0;
    bulk_wait_all();
  }
}

__global__ void __launch_bounds__(kThreads)
    vote_tables_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const Layout L = layout(a.tile);
  const int ntiles = a.S / a.tile;
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_addr(smem + L.bars);
    for (int s = 0; s < kStages; ++s) {
      // full: the producer lane 0's expectation and the 32 lanes' rows
      mbar_init(bars + 8 * s, 33);
      mbar_init(bars + 8 * (kStages + s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    produce(a, L, smem, ntiles);
  } else {
    consume(a, L, smem, ntiles);
  }
}

// CTAs an SM and the persistent grid of a launch (0 CTAs: does not
// fit).  The occupancy of a (device, tile) is asked once and kept: the
// dense engine launches the kernel on an idle card, where the host's
// time to the launch is the kernel's latency.  A device's shared-memory
// limit for the kernel only rises, so that a plan kept for it stays
// valid.
cudaError_t plan(int items, int tile, int* grid, int* per_sm,
                 int* smem_bytes) {
  struct Kept {
    int dev, tile, per_sm, sms;
  };
  static std::mutex mu;
  static Kept kept[64];
  static int n_kept = 0;
  static int limit[64] = {};  // the attribute set, by device
  const int bytes = layout(tile).total;
  *smem_bytes = bytes;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_kept; ++i) {
    const Kept& k = kept[i];
    if (k.dev == dev && k.tile == tile) {
      *per_sm = k.per_sm;
      *grid = min(items, k.per_sm * k.sms);
      return cudaSuccess;
    }
  }
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (bytes > limit[dev]) {
    err = cudaFuncSetAttribute(vote_tables_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    limit[dev] = bytes;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, vote_tables_kernel, kThreads, bytes);
  if (err != cudaSuccess) return err;
  if (n_kept < 64) kept[n_kept++] = {dev, tile, *per_sm, sms};
  *grid = min(items, *per_sm * sms);
  return cudaSuccess;
}

// S the kernel takes: a multiple of 16 (the bulk copies' sizes and
// offsets), and of kMaxTile above it
bool bad_shape(int N, int S) {
  return N <= 0 || S <= 0 || S % 16 || (S > kMaxTile && S % kMaxTile) ||
         (long long)N * (S / tile_of(S)) > 0x7FFFFFFF;
}

}  // namespace

extern "C" {

// The launch's plan for N windows at width S: out[0] the persistent
// grid, out[1] CTAs an SM, out[2] dynamic shared memory bytes a CTA,
// out[3] threads a CTA, out[4] ring stages, out[5] the tile TC, out[6]
// rows a stage.  Returns a CUDA error (0: planned).
int hx_vote_tables_plan(int N, int S, void* out) {
  if (bad_shape(N, S)) return (int)cudaErrorInvalidValue;
  int* o = static_cast<int*>(out);
  const int tile = tile_of(S);
  const cudaError_t err = plan(N * (S / tile), tile, o, o + 1, o + 2);
  o[3] = kThreads;
  o[4] = kStages;
  o[5] = tile;
  o[6] = kChunk;
  return (int)err;
}

// The tables of one shard's round (layout above).  planes: B rows of
// row_stride bytes; ok: B bytes; stats: B int2; win_ptr: N + 1 int32;
// counts: N*S int4; cov: N*(S+1) + 1 int32; ins1, ins2: N*(S+1) int4;
// n_reads: N int32.  S a multiple of 16, and of 512 above 512.  Returns
// the launch's CUDA error (0: launched).
int hx_vote_tables(const void* planes, const void* ok, const void* stats,
                   const void* win_ptr, void* counts, void* cov, void* ins1,
                   void* ins2, void* n_reads, int N, int S, int row_stride,
                   int off1, int off2, void* stream) {
  if (N <= 0) return 0;
  const uintptr_t vec = reinterpret_cast<uintptr_t>(planes) |
                        reinterpret_cast<uintptr_t>(counts) |
                        reinterpret_cast<uintptr_t>(ins1) |
                        reinterpret_cast<uintptr_t>(ins2);
  if (bad_shape(N, S) || row_stride % 16 || off1 % 16 || off2 % 16 ||
      off1 < S || off2 < off1 + S + 16 || row_stride < off2 + S + 16 ||
      reinterpret_cast<uintptr_t>(stats) % 8 || vec % 16) {
    return (int)cudaErrorInvalidValue;
  }
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
  a.tile = tile_of(S);
  a.items = N * (S / a.tile);
  int grid = 0, per_sm = 0, bytes = 0;
  const cudaError_t err = plan(a.items, a.tile, &grid, &per_sm, &bytes);
  if (err != cudaSuccess) return (int)err;
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  vote_tables_kernel<<<grid, kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
