// Sequence-parallel all-gather attention (long-context causal prefill) for
// Hopper (sm_90a), over ranks co-located on one card.
//
// Replaces: triton_distributed_tpu/ops/attention/sp_ag_attention.py
// `_sp_ag_attn_kernel` :39 (entry `sp_ag_attention` :150): the KV gather
// and the causal flash attention that consumes it, fused in one kernel.
//
// What it computes, per rank me of n (the sequence sharded in rank order,
// s_loc rows a rank): for q head h and local row i, causal attention over
// the K/V chunks 0..me, where chunks r < me are fully visible and the own
// chunk is causal in local indices (col <= i, sp_ag_attention.py:115-119);
// scores (q . k) * sm_scale in f32, an online softmax over key tiles with
// f32 (m, l, acc), masked scores -1e30, P.V accumulated in f32, l floored
// at 1e-30; O in q's dtype and the f32 LSE. P is rounded to V's dtype
// before P.V, as the TPU kernel and csrc/flash_attention.cu do (l sums the
// unrounded P).
//
// What bounds it on the H100: operations. At Qwen3-8B's geometry (hq 32,
// hd 128) over a 32768-token sequence the causal products are
// 4 * hq * hd * S^2 / 2 = 8.8e12 FLOP, 8.9 ms at 989 TFLOP/s bf16, against
// 134 MB of K/V moved. Rank me attends me + 1 chunks: its share of the
// causal work is (2 me + 1) / n^2.
//
// Design (not a DMA-by-DMA copy of the Pallas kernel, which stages a whole
// s_loc chunk in VMEM: 4 MB per K at s_loc 16384, far over shared memory):
// - one cooperative launch over all ranks, every block resident or the
//   launch is refused. The grid is split by work: rank r gets counts[r]
//   blocks (the launcher's default about (2r + 1) / n^2 of the co-resident
//   blocks, at least one), block b is (rank, index) through the prefix of
//   the counts; a block computes only its own rank's rows;
// - the entry barrier and epoch flags of tdt_comm.cuh; push first: block g
//   of rank me copies piece g of counts[me] of its K and V shard into slot
//   me of the workspace [n, 2, hkv, s_loc, hd] of every later rank and
//   stores flag (me, g) there, before any block waits, so no block spins on
//   a push that has not started; the own chunk is read in place;
// - then each block walks work items (kv head, q tile), heaviest tile
//   first, over the G = hq / hkv q heads of one kv head (GQA: each K/V tile
//   is read once a group), chunk by chunk: the own chunk first (it needs no
//   wait, and only the tiles up to the item's last row), then 0..me-1, each
//   after its flags (a flag at this launch's epoch: never a stale chunk).
//
// bf16 (sp_ag_attn_tc_kernel): 128 (head, row) rows an item, 128 / G
// positions a head, two consumer warpgroups of 64 rows each over the same
// K/V tile (tdt_attention.cuh's tile: S = Q K^T on wgmma m64n64k16, P from
// registers into O += P V on wgmma m64n128k16, V MN-major, the online
// softmax in log2 units). Tile i's Q K^T and tile i-1's P V go out
// together; the softmax of tile i runs while P V multiplies. One producer
// warp (one thread) keeps K and V in flight by TMA into a ring of kStages
// stages, across chunk and item boundaries: a full mbarrier for K and one
// for V a stage, an empty one that every consumer thread arrives on once
// it has read the stage; Q by TMA into two buffers (the next item's loads
// ahead). 3-D tensor maps: the own K and V [hkv, s_loc, 128], the
// workspace [n * 2 * hkv, s_loc, 128] (chunk r's K or V of kv head h an
// outer coordinate) and Q [hq, s_loc, 128] (a warpgroup's 64 rows are one
// box of 64 columns x min(128 / G, 64) rows x max(G / 2, 1) heads); rows
// past s_loc are zero-filled and never stored, keys past s_loc score
// -inf. The producer acquires chunk r's flags, then fences the generic
// proxy (the peers' stores) against the async proxy (its TMA loads),
// before its first load of chunk r. The per-element masks only on a tile
// that crosses the warpgroup's causal diagonal or s_loc.
// f32 (TF32 off, sp_ag_attn_f32_kernel): the FMA pipes, a lane a key, as
// csrc/flash_attention.cu does, 16 (head, row) rows a block.
//
// Flags of rank p: [0, n) the entry barrier, then n + prefix(src) + g for
// piece g of source src's push.
#include <climits>

#include "tdt_attention.cuh"
#include "tdt_comm.cuh"
#include "tdt_common.cuh"
#include "tdt_hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tdt::RankPtrs;

constexpr int kD = 128;   // head dim
constexpr int kBKf = 32;  // keys per tile, f32 path (one per lane)

// f32: rows a block (flattened (head, q row) over the G heads of one kv
// head), q rows per head (kBQ) and threads.
template <int G>
struct Cfg {
  static constexpr int kWarps = 4;
  static constexpr int kRows = 16;
  static constexpr int kBQ = kRows / G;
  static constexpr int kThreads = kWarps * 32;
};

// bf16: two consumer warpgroups and one producer warp.
namespace tc {
using namespace tdt::attn;
constexpr int kRows = 128;                // (head, row) rows an item
constexpr int kConsumers = 256;           // two warpgroups
constexpr int kThreads = kConsumers + 32;  // + the producer warp
// K/V tiles in flight: at Qwen3-8B geometry, S = 32768, n = 2, on an H100
// 80GB HBM3 (700 W) 3 stages took 19.4-19.5 ms, 4 took 20.8-21.0 and 5
// 20.1-20.3 (perf/sp_attention_bench.py over copies of this file).
constexpr int kStages = 3;
constexpr int kQBytes = 2 * kTile;        // an item's Q: a tile a warpgroup
// Barriers: Q full and empty a buffer, K full, V full and empty a stage.
constexpr int kBars = 4 + 3 * kStages;
// 1 KB of slack aligns the buffers to the swizzle's 1024-byte atoms.
constexpr int kSmem = 1024 + 2 * kQBytes + kStages * 2 * kTile + 8 * kBars;
}  // namespace tc

struct SpParams {
  RankPtrs q, k, v, o, lse;  // per rank: q/o [hq, s_loc, D], k/v [hkv, s_loc,
                             // D], lse [hq, s_loc] f32
  const int64_t* ws_tab;     // [n, 2, hkv, s_loc, D] of T a rank
  const int64_t* fl_tab;
  int counts[tdt::kMaxRanks];  // blocks of each rank
  int n, hkv, s_loc;
  float sm_scale;
  uint64_t epoch;
};

// Each rank's Q, own K and V, and workspace as TMA boxes (bf16 build),
// passed by value as a __grid_constant__ parameter.
struct alignas(64) SpMaps {
  CUtensorMap q[tdt::kMaxRanks], k[tdt::kMaxRanks], v[tdt::kMaxRanks],
      ws[tdt::kMaxRanks];
};

// Block b of the grid as (rank me, index g of counts[me]).
__device__ __forceinline__ void block_rank(const SpParams& P, int& me,
                                           int& g) {
  int b = blockIdx.x, r = 0;
  while (b >= P.counts[r]) b -= P.counts[r++];
  me = r;
  g = b;
}

// The first flag of source src's pieces.
__device__ __forceinline__ int prefix(const SpParams& P, int src) {
  int p = 0;
  for (int r = 0; r < src; ++r) p += P.counts[r];
  return p;
}

__device__ __forceinline__ void byte_piece(long long span, int g, int G,
                                           long long& lo, long long& hi) {
  const long long per = ((span + G - 1) / G + 15) / 16 * 16;
  lo = min(span, static_cast<long long>(g) * per);
  hi = min(span, lo + per);
}

// Piece g of counts[me] of the own K and V shard into slot me of every
// later rank's workspace, then flag (me, g) on each of them.
template <typename T>
__device__ void push_shard(const SpParams& P, int me, int g) {
  const long long kv_bytes =
      static_cast<long long>(P.hkv) * P.s_loc * kD * sizeof(T);
  const char* k = tdt::rank_ptr<const char>(P.k, me);
  const char* v = tdt::rank_ptr<const char>(P.v, me);
  long long lo, hi;
  byte_piece(kv_bytes, g, P.counts[me], lo, hi);
  for (int p = me + 1; p < P.n; ++p) {
    char* slot = tdt::symm_ptr<char>(P.ws_tab, p) + me * 2 * kv_bytes;
    if (hi > lo) {
      tdt::put(slot + lo, k + lo, hi - lo);
      tdt::put(slot + kv_bytes + lo, v + lo, hi - lo);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && me + 1 < P.n) {
    __threadfence_system();
    const int flag = P.n + prefix(P, me) + g;
    for (int p = me + 1; p < P.n; ++p)
      tdt::st_release_sys(tdt::symm_ptr<uint64_t>(P.fl_tab, p) + flag,
                          P.epoch);
  }
}

// One thread: chunk r's pieces have all arrived at rank me.
template <bool kQuiet>
__device__ __forceinline__ void wait_chunk(const SpParams& P, int me, int r) {
  const uint64_t* mine =
      tdt::symm_ptr<const uint64_t>(P.fl_tab, me) + P.n + prefix(P, r);
  for (int j = 0; j < P.counts[r]; ++j)
    tdt::wait_until<kQuiet>(mine + j, P.epoch);
}

// Chunk r (< me) has arrived: all its pieces. Waited once per block and
// chunk (`arrived` is the block's bitmask).
__device__ __forceinline__ void await_chunk(const SpParams& P, int me, int r,
                                            unsigned& arrived) {
  if (r == me || (arrived >> r) & 1u) return;
  if (threadIdx.x == 0) wait_chunk<false>(P, me, r);
  __syncthreads();
  arrived |= 1u << r;
}

// Chunk r's K (which 0) or V (1) rows of kv head kvh: the own chunk in
// place, an earlier one from the workspace.
template <typename T>
__device__ __forceinline__ const T* chunk_ptr(const SpParams& P, int me,
                                              int r, int which, int kvh) {
  const size_t head = static_cast<size_t>(kvh) * P.s_loc * kD;
  if (r == me)
    return tdt::rank_ptr<const T>(which ? P.v : P.k, me) + head;
  return tdt::symm_ptr<const T>(P.ws_tab, me) +
         (static_cast<size_t>(r * 2 + which) * P.hkv) * P.s_loc * kD + head;
}

// ---- bf16: tensor cores ---------------------------------------------------

// Item it of a rank: kv head and q tile, heaviest (last) q tiles first.
__device__ __forceinline__ void item_of(int it, int hkv, int n_qt, int& kvh,
                                        int& qt) {
  kvh = it % hkv;
  qt = n_qt - 1 - it / hkv;
}

// The producer thread: for each of the block's items, its Q into buffer
// j % 2, then every K/V tile of its chunks in the consumers' order (the
// own chunk up to the item's last row, then 0..me-1, each after its
// flags) into the ring.
template <int G>
__device__ __forceinline__ void produce(const SpParams& P, const SpMaps& maps,
                                        int me, int g, uint8_t* qbuf,
                                        uint8_t* ring, uint64_t* bars) {
  using namespace tc;
  constexpr int BQ = kRows / G;          // positions a head an item
  constexpr int R = BQ < 64 ? BQ : 64;   // rows a head in a Q box
  constexpr int H = 64 / R;              // heads in a Q box
  uint64_t *q_full = bars, *q_empty = bars + 2, *k_full = bars + 4,
           *v_full = k_full + kStages, *empty = v_full + kStages;
  const int s_loc = P.s_loc, hkv = P.hkv, nb = P.counts[me];
  const int n_qt = (s_loc + BQ - 1) / BQ, items = hkv * n_qt;
  const int full_tiles = (s_loc + kKeys - 1) / kKeys;
  unsigned arrived = 0;
  uint32_t t = 0;
  for (int it = g, j = 0; it < items; it += nb, ++j) {
    int kvh, qt;
    item_of(it, hkv, n_qt, kvh, qt);
    const int qb = j & 1;
    if (j >= 2) tdt::mbar_wait(q_empty + qb, ((j >> 1) - 1) & 1);
    tdt::mbar_expect_tx(q_full + qb, kQBytes);
    for (int wg = 0; wg < 2; ++wg) {
      const int row = qt * BQ + (G == 1 ? 64 * wg : 0);
      const int head = kvh * G + (G == 1 ? 0 : wg * H);
      uint8_t* dst = qbuf + qb * kQBytes + wg * kTile;
      tdt::tma_load_3d(dst, &maps.q[me], q_full + qb, 0, row, head);
      tdt::tma_load_3d(dst + kBox, &maps.q[me], q_full + qb, 64, row, head);
    }
    const int own_tiles =
        (min((qt + 1) * BQ, s_loc) + kKeys - 1) / kKeys;
    for (int ci = 0; ci <= me; ++ci) {
      const int r = ci == 0 ? me : ci - 1;
      if (r != me && !((arrived >> r) & 1u)) {
        wait_chunk<true>(P, me, r);
        tdt::fence_proxy_async_global();
        arrived |= 1u << r;
      }
      const CUtensorMap* km = r == me ? &maps.k[me] : &maps.ws[me];
      const CUtensorMap* vm = r == me ? &maps.v[me] : &maps.ws[me];
      const int kh = r == me ? kvh : (2 * r) * hkv + kvh;
      const int vh = r == me ? kvh : (2 * r + 1) * hkv + kvh;
      const int nt = ci == 0 ? own_tiles : full_tiles;
      for (int i = 0; i < nt; ++i, ++t) {
        const int s = t % kStages;
        if (t >= kStages) tdt::mbar_wait(empty + s, (t / kStages - 1) & 1);
        uint8_t* kd = ring + s * 2 * kTile;
        tdt::mbar_expect_tx(k_full + s, kTile);
        tdt::tma_load_3d(kd, km, k_full + s, 0, i * kKeys, kh);
        tdt::tma_load_3d(kd + kBox, km, k_full + s, 64, i * kKeys, kh);
        tdt::mbar_expect_tx(v_full + s, kTile);
        tdt::tma_load_3d(kd + kTile, vm, v_full + s, 0, i * kKeys, vh);
        tdt::tma_load_3d(kd + kTile + kBox, vm, v_full + s, 64, i * kKeys,
                         vh);
      }
    }
  }
}

// The scores of tile i of an item on the S fragment, softmaxed in place:
// the own chunk's tiles first (causal at the rows' positions pa, pb; the
// per-element masks only past the warpgroup's first row or s_loc), then
// every earlier chunk's (only the last tile past s_loc masked).
__device__ __forceinline__ void softmax_tile(float (&s)[32], int i,
                                             int own_tiles, int full_tiles,
                                             int wg_first, int pa, int pb,
                                             int cq, int s_loc, float scale2,
                                             float& m_a, float& m_b,
                                             float& l_a, float& l_b,
                                             float& alpha_a, float& alpha_b) {
  using namespace tdt::attn;
  const bool own = i < own_tiles;
  const int k0 = (own ? i : (i - own_tiles) % full_tiles) * kKeys;
  const float bv[1] = {0.f};
  float mx_a = m_a, mx_b = m_b;
  if ((own && k0 + kKeys - 1 > wg_first) || k0 + kKeys > s_loc)
    score_tile<false, true>(s, bv, scale2, k0, cq, own ? pa : INT_MAX,
                            own ? pb : INT_MAX, s_loc, mx_a, mx_b);
  else
    score_tile<false, false>(s, bv, scale2, k0, cq, 0, 0, s_loc, mx_a, mx_b);
  softmax_update(s, mx_a, mx_b, m_a, m_b, l_a, l_b, alpha_a, alpha_b);
}

// Consumer warpgroup wg (thread t of 128): rows [64 wg, 64 wg + 64) of each
// item, flattened f = 64 wg + row: head f / BQ of the kv head's G, position
// qt * BQ + f % BQ.
template <int G>
__device__ __forceinline__ void consume(const SpParams& P, int me, int g,
                                        int wg, int t, uint8_t* qbuf,
                                        uint8_t* ring, uint64_t* bars) {
  using namespace tc;
  constexpr int BQ = kRows / G;
  uint64_t *q_full = bars, *q_empty = bars + 2, *k_full = bars + 4,
           *v_full = k_full + kStages, *empty = v_full + kStages;
  const int s_loc = P.s_loc, hkv = P.hkv, nb = P.counts[me];
  const int n_qt = (s_loc + BQ - 1) / BQ, items = hkv * n_qt;
  const int full_tiles = (s_loc + kKeys - 1) / kKeys;
  const int lane = t % 32;
  const int fa = 64 * wg + (t / 32) * 16 + lane / 4, fb = fa + 8;
  const int cq = 2 * (lane % 4);
  const float scale2 = P.sm_scale * kLog2e;
  const uint32_t ring_a = tdt::smem_u32(ring);
  bf16* o_base = tdt::rank_ptr<bf16>(P.o, me);
  float* lse_base = tdt::rank_ptr<float>(P.lse, me);
  float o_acc[64], s_acc[32];
  uint32_t p[16];
  uint32_t t0 = 0;  // the item's first tile in the ring's sequence
  for (int it = g, j = 0; it < items; it += nb, ++j) {
    int kvh, qt;
    item_of(it, hkv, n_qt, kvh, qt);
    const int qb = j & 1;
    const int pa = qt * BQ + fa % BQ, pb = qt * BQ + fb % BQ;
    const int wg_first = qt * BQ + (G == 1 ? 64 * wg : 0);
    const int own_tiles =
        (min((qt + 1) * BQ, s_loc) + kKeys - 1) / kKeys;
    const int n_tiles = own_tiles + me * full_tiles;
#pragma unroll
    for (int i = 0; i < 64; ++i) o_acc[i] = 0.f;
    float m_a = -__int_as_float(0x7f800000), m_b = m_a, l_a = 0.f, l_b = 0.f;
    float alpha_a, alpha_b;
    const uint32_t qa = tdt::smem_u32(qbuf + qb * kQBytes + wg * kTile);
    tdt::mbar_wait(q_full + qb, (j >> 1) & 1);

    // Tile 0 (acc is still 0).
    {
      const int s = t0 % kStages;
      tdt::mbar_wait(k_full + s, (t0 / kStages) & 1);
      issue_qk(s_acc, qa, ring_a + s * 2 * kTile);
      tdt::wgmma_wait<0>();
      tdt::fence_acc(s_acc);
      softmax_tile(s_acc, 0, own_tiles, full_tiles, wg_first, pa, pb, cq,
                   s_loc, scale2, m_a, m_b, l_a, l_b, alpha_a, alpha_b);
      pack_p(p, s_acc);
    }
    for (int i = 1; i < n_tiles; ++i) {
      const uint32_t ti = t0 + i, tp = ti - 1;
      const int s = ti % kStages, sp = tp % kStages;
      tdt::mbar_wait(k_full + s, (ti / kStages) & 1);
      issue_qk(s_acc, qa, ring_a + s * 2 * kTile);
      tdt::mbar_wait(v_full + sp, (tp / kStages) & 1);
      issue_pv(o_acc, p, ring_a + sp * 2 * kTile + kTile);
      tdt::wgmma_wait<1>();
      tdt::fence_acc(s_acc);
      softmax_tile(s_acc, i, own_tiles, full_tiles, wg_first, pa, pb, cq,
                   s_loc, scale2, m_a, m_b, l_a, l_b, alpha_a, alpha_b);
      tdt::wgmma_wait<0>();
      tdt::fence_acc(o_acc);
      tdt::mbar_arrive(empty + sp);  // K(i-1) and V(i-1) are read
      rescale_o(o_acc, alpha_a, alpha_b);
      pack_p(p, s_acc);
    }
    {
      const uint32_t tl = t0 + n_tiles - 1;
      const int s = tl % kStages;
      tdt::mbar_wait(v_full + s, (tl / kStages) & 1);
      issue_pv(o_acc, p, ring_a + s * 2 * kTile + kTile);
      tdt::wgmma_wait<0>();
      tdt::fence_acc(o_acc);
      tdt::mbar_arrive(empty + s);
      tdt::mbar_arrive(q_empty + qb);
    }
    t0 += n_tiles;

    l_a = quad_sum(l_a);
    l_b = quad_sum(l_b);
    const float la = fmaxf(l_a, 1e-30f), lb = fmaxf(l_b, 1e-30f);
    const size_t ha = static_cast<size_t>(kvh) * G + fa / BQ;
    const size_t hb = static_cast<size_t>(kvh) * G + fb / BQ;
    bf16* oa = o_base + (ha * s_loc + pa) * kD + cq;
    bf16* ob = o_base + (hb * s_loc + pb) * kD + cq;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      if (pa < s_loc)
        *reinterpret_cast<__nv_bfloat162*>(oa + 8 * jj) =
            __floats2bfloat162_rn(o_acc[4 * jj] / la, o_acc[4 * jj + 1] / la);
      if (pb < s_loc)
        *reinterpret_cast<__nv_bfloat162*>(ob + 8 * jj) =
            __floats2bfloat162_rn(o_acc[4 * jj + 2] / lb,
                                  o_acc[4 * jj + 3] / lb);
    }
    if (lane % 4 == 0) {
      if (pa < s_loc) lse_base[ha * s_loc + pa] = m_a * kLn2 + logf(la);
      if (pb < s_loc) lse_base[hb * s_loc + pb] = m_b * kLn2 + logf(lb);
    }
  }
}

template <int G>
__global__ void __launch_bounds__(tc::kThreads, 1)
    sp_ag_attn_tc_kernel(SpParams P, const __grid_constant__ SpMaps maps) {
  using namespace tc;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qbuf = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = qbuf + 2 * kQBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kStages * 2 * kTile);
  int me, g;
  block_rank(P, me, g);
  tdt::barrier_all<true>(P.fl_tab, me, P.n, P.epoch, g == 0);
  push_shard<bf16>(P, me, g);
  if (threadIdx.x == 0) {
    // Q full (one arrival: the producer's expect_tx), Q empty (every
    // consumer thread), K and V full, stage empty.
    for (int i = 0; i < 2; ++i) {
      tdt::mbar_init(bars + i, 1);
      tdt::mbar_init(bars + 2 + i, kConsumers);
    }
    for (int s = 0; s < kStages; ++s) {
      tdt::mbar_init(bars + 4 + s, 1);
      tdt::mbar_init(bars + 4 + kStages + s, 1);
      tdt::mbar_init(bars + 4 + 2 * kStages + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers)
      produce<G>(P, maps, me, g, qbuf, ring, bars);
    return;
  }
  consume<G>(P, me, g, threadIdx.x / 128, threadIdx.x % 128, qbuf, ring,
             bars);
}

// ---- f32: FMA pipes ---------------------------------------------------------

// One work item on the FMA pipes: 16 flattened rows, 4 a warp; lane j
// scores key j of a 32-key tile, the warp reduces max and sum by shuffle,
// and each lane owns D / 32 output columns of P.V.
template <int G>
__device__ void item_f32(const SpParams& P, int me, int kvh, int qt,
                         unsigned& arrived, float (*q_s)[kD],
                         float (*k_s)[kD + 1], float (*v_s)[kD]) {
  using C = Cfg<G>;
  constexpr int RPW = C::kRows / C::kWarps;
  constexpr int EPL = kD / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s_loc = P.s_loc;
  const int last_row = min((qt + 1) * C::kBQ, s_loc) - 1;
  const float* q = tdt::rank_ptr<const float>(P.q, me);

  __syncthreads();  // the previous item's q rows are consumed
  for (int i = threadIdx.x; i < C::kRows * kD; i += C::kThreads) {
    const int f = i / kD, c = i % kD;
    const int h = kvh * G + f / C::kBQ, row = qt * C::kBQ + f % C::kBQ;
    q_s[f][c] = row < s_loc
                    ? q[(static_cast<size_t>(h) * s_loc + row) * kD + c]
                    : 0.f;
  }
  float m[RPW], l[RPW], acc[RPW][EPL];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = tdt::kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[rr][e] = 0.f;
  }
  const float neg_inf = -__int_as_float(0x7f800000);

  for (int r = 0; r <= me; ++r) {
    await_chunk(P, me, r, arrived);
    const float* kc = chunk_ptr<float>(P, me, r, 0, kvh);
    const float* vc = chunk_ptr<float>(P, me, r, 1, kvh);
    const int kv_end = r == me ? last_row + 1 : s_loc;
    for (int k0 = 0; k0 < kv_end; k0 += kBKf) {
      __syncthreads();
      for (int i = threadIdx.x; i < kBKf * kD; i += C::kThreads) {
        const int key = i / kD, c = i % kD;
        const bool in = k0 + key < s_loc;
        const size_t at = static_cast<size_t>(k0 + key) * kD + c;
        k_s[key][c] = in ? __ldcg(kc + at) : 0.f;
        v_s[key][c] = in ? __ldcg(vc + at) : 0.f;
      }
      __syncthreads();
      const int col = k0 + lane;
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const int f = warp * RPW + rr;
        const int row = qt * C::kBQ + f % C::kBQ;
        if (row >= s_loc) continue;  // warp-uniform
        float s = 0.f;
#pragma unroll 16
        for (int d = 0; d < kD; ++d) s = fmaf(q_s[f][d], k_s[lane][d], s);
        s *= P.sm_scale;
        if (r == me && col > row) s = tdt::kNegInf;
        if (col >= s_loc) s = neg_inf;
        const float m_new = fmaxf(m[rr], tdt::warp_max(s));
        const float p = expf(s - m_new);
        const float alpha = expf(m[rr] - m_new);
        l[rr] = l[rr] * alpha + tdt::warp_sum(p);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[rr][e] *= alpha;
#pragma unroll 8
        for (int j = 0; j < kBKf; ++j) {
          const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            acc[rr][e] = fmaf(pj, v_s[j][e * 32 + lane], acc[rr][e]);
        }
        m[rr] = m_new;
      }
    }
  }

  float* o = tdt::rank_ptr<float>(P.o, me);
  float* lse = tdt::rank_ptr<float>(P.lse, me);
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int f = warp * RPW + rr;
    const int h = kvh * G + f / C::kBQ, row = qt * C::kBQ + f % C::kBQ;
    if (row >= s_loc) continue;
    const float lf = fmaxf(l[rr], 1e-30f);
    float* ob = o + (static_cast<size_t>(h) * s_loc + row) * kD;
#pragma unroll
    for (int e = 0; e < EPL; ++e) ob[e * 32 + lane] = acc[rr][e] / lf;
    if (lane == 0) lse[static_cast<size_t>(h) * s_loc + row] = m[rr] + logf(lf);
  }
}

template <int G>
__global__ void __launch_bounds__(Cfg<G>::kThreads)
    sp_ag_attn_f32_kernel(SpParams P) {
  using C = Cfg<G>;
  int me, g;
  block_rank(P, me, g);
  tdt::barrier_all(P.fl_tab, me, P.n, P.epoch, g == 0);
  push_shard<float>(P, me, g);

  const int n_qt = (P.s_loc + C::kBQ - 1) / C::kBQ;
  const int items = P.hkv * n_qt;
  unsigned arrived = 0;
  __shared__ float q_s[C::kRows][kD];
  __shared__ float k_s[kBKf][kD + 1];
  __shared__ float v_s[kBKf][kD];
  for (int it = g; it < items; it += P.counts[me])
    item_f32<G>(P, me, it % P.hkv, n_qt - 1 - it / P.hkv, arrived, q_s, k_s,
                v_s);
}

// The kernel of (dtype, group), its threads and dynamic shared memory.
struct Build {
  const void* fn;
  int threads;
  int smem;
};

template <int G>
Build build_g(int dtype) {
  if (dtype == tdt::kDtypeF32)
    return {reinterpret_cast<const void*>(&sp_ag_attn_f32_kernel<G>),
            Cfg<G>::kThreads, 0};
  if (dtype == tdt::kDtypeBF16)
    return {reinterpret_cast<const void*>(&sp_ag_attn_tc_kernel<G>),
            tc::kThreads, tc::kSmem};
  return {nullptr, 0, 0};
}

Build sp_build(int dtype, int group) {
  switch (group) {
    case 1: return build_g<1>(dtype);
    case 2: return build_g<2>(dtype);
    case 4: return build_g<4>(dtype);
    case 8: return build_g<8>(dtype);
    default: return {nullptr, 0, 0};
  }
}

// Raises the build's dynamic shared-memory limit once a kernel and device.
bool prepare(const Build& k) {
  static int done_dev[64];
  static const void* done_fn[64];
  static int n_done = 0;
  if (k.smem == 0) return true;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  for (int i = 0; i < n_done; ++i)
    if (done_fn[i] == k.fn && done_dev[i] == dev) return true;
  if (cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           k.smem) != cudaSuccess)
    return false;
  if (n_done < 64) {
    done_fn[n_done] = k.fn;
    done_dev[n_done++] = dev;
  }
  return true;
}

}  // namespace

extern "C" {

// Co-resident blocks of the kernel for (dtype, group): the most one
// cooperative launch takes.
int tdt_sp_ag_attention_capacity(int dtype, int group) {
  const Build k = sp_build(dtype, group);
  if (k.fn == nullptr || !prepare(k)) return 0;
  return tdt::capacity(k.fn, k.threads, k.smem);
}

// Causal SP attention over n co-located ranks: host tables of the per-rank
// q/k/v/o/lse pointers (q/o [hkv * group, s_loc, d], k/v [hkv, s_loc, d]
// of dtype 0 f32 or 1 bf16, lse [hkv * group, s_loc] f32) and of the
// workspace's ([n, 2, hkv, s_loc, d] a rank), the workspace's and flags'
// device tables (flags: n + the sum of counts a rank), and counts[r], the
// blocks of rank r (each >= 1). d must be 128 and group 1, 2, 4 or 8.
int tdt_sp_ag_attention_launch(int dtype, int group, const int64_t* q,
                               const int64_t* k, const int64_t* v,
                               const int64_t* o, const int64_t* lse,
                               const int64_t* ws, const int64_t* ws_tab,
                               const int64_t* fl_tab, int n, int hkv,
                               int s_loc, int d, float sm_scale,
                               unsigned long long epoch, const int* counts,
                               void* stream) {
  const Build kb = sp_build(dtype, group);
  if (kb.fn == nullptr || d != kD || n < 1 || n > tdt::kMaxRanks ||
      hkv < 1 || s_loc < 1)
    return cudaErrorInvalidValue;
  SpParams P{};
  int blocks = 0;
  for (int r = 0; r < n; ++r) {
    if (counts[r] < 1) return cudaErrorInvalidValue;
    P.counts[r] = counts[r];
    blocks += counts[r];
  }
  if (!prepare(kb)) return cudaErrorInvalidValue;
  if (blocks > tdt::capacity(kb.fn, kb.threads, kb.smem))
    return cudaErrorCooperativeLaunchTooLarge;
  P.q = tdt::to_ptrs(q, n);
  P.k = tdt::to_ptrs(k, n);
  P.v = tdt::to_ptrs(v, n);
  P.o = tdt::to_ptrs(o, n);
  P.lse = tdt::to_ptrs(lse, n);
  P.ws_tab = ws_tab;
  P.fl_tab = fl_tab;
  P.n = n;
  P.hkv = hkv;
  P.s_loc = s_loc;
  P.sm_scale = sm_scale;
  P.epoch = epoch;
  cudaError_t err;
  if (dtype == tdt::kDtypeBF16) {
    const int bq = tc::kRows / group;
    SpMaps maps{};
    for (int r = 0; r < n; ++r) {
      const void* qr = reinterpret_cast<const void*>(q[r]);
      const void* kr = reinterpret_cast<const void*>(k[r]);
      const void* vr = reinterpret_cast<const void*>(v[r]);
      const void* wr = reinterpret_cast<const void*>(ws[r]);
      if (!tdt::attn::encode_rows(&maps.q[r], qr, s_loc, hkv * group,
                                  bq < 64 ? bq : 64, bq < 64 ? 64 / bq : 1) ||
          !tdt::attn::encode_rows(&maps.k[r], kr, s_loc, hkv, 64, 1) ||
          !tdt::attn::encode_rows(&maps.v[r], vr, s_loc, hkv, 64, 1) ||
          !tdt::attn::encode_rows(&maps.ws[r], wr, s_loc, n * 2 * hkv, 64,
                                  1))
        return cudaErrorInvalidValue;
    }
    void* args[] = {&P, &maps};
    err = cudaLaunchCooperativeKernel(kb.fn, dim3(blocks), dim3(kb.threads),
                                      args, kb.smem,
                                      static_cast<cudaStream_t>(stream));
  } else {
    void* args[] = {&P};
    err = cudaLaunchCooperativeKernel(kb.fn, dim3(blocks), dim3(kb.threads),
                                      args, 0,
                                      static_cast<cudaStream_t>(stream));
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
