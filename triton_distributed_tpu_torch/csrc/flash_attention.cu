// Causal/GQA flash attention forward for Hopper (sm_90a).
//
// Replaces: triton_distributed_tpu/ops/attention/flash_attention.py
// `_attn_kernel` (the Pallas TPU kernel behind `flash_attention`), the
// prefill attention of batched prefill and of chunked prefix-cache
// prefill with a dynamic `kv_offset`; the same `_attn_kernel` with
// `ks_ref`/`vs_ref` (int8 K/V codes with one f32 scale per `block_k`
// keys per kv head), the chunked prefill over an int8 page pool
// (`block_k` = page); and the same `_attn_kernel` with `b_ref` (an
// additive [Sq, Sk] f32 score bias shared by every batch row and head:
// the draft-tree ancestor mask of a speculative tree verify chunk); and
// the same `_attn_kernel` with `causal=False`, with `b_ref` and with or
// without `ks_ref`/`vs_ref`: the cold partial of a sharded long-context
// slot's prefill chunk (layers/tp_attn.py
// `tp_attn_prefill_paged_chunk_cold`), where every chunk row sees every
// cold column below `s_cold` and the bias masks the bucket's tail.
//
// What it computes, per query row r of head h (kv head h / group):
//   s_c = (q_r . k_c) * sm_scale in f32, masked to -1e30 where
//         c > kv_offset + r (the causal limit; causal kernels only), and
//         to -inf where c >= Sk (a padding column of the last tile, which
//         then weighs exactly 0 even in a row whose columns are all
//         masked: such a row averages V over its Sk real columns, as the
//         TPU kernel and the plain version do),
//   an online softmax over kv tiles with f32 (m, l, acc), P rounded to
//   V's dtype before P·V (f32 accumulation), l floored at 1e-30, and the
//   optional base-e LSE m + log(l).
//   int8: s_c = (q_r . code_c) * (sm_scale * k_scale[c / block_k]), and
//   P·V adds p_c * v_scale[c / block_k] * code_c with p unrounded, the TPU
//   kernel's in-register dequant folded per key (its scale is per
//   block_k keys, independent of this kernel's 32-key tile).
//   bias: s_c = (q_r . k_c) * sm_scale + bias[r, c], added after the
//   scale and before the causal mask, as in the TPU kernel. A masked
//   bias entry is -1e30; in f32 a score plus -1e30 rounds to -1e30, the
//   causal mask's own value, so a tile whose visible columns are all
//   bias-masked for a row behaves like a causally masked tile (its
//   exp(0) terms are zeroed by exp(m_old - m_new) once a real score
//   arrives). The bias only masks more than causality, so the causal
//   tile limit stays sound. Bias rows are read straight from global
//   memory: lane j reads bias[r, k0 + j], 32 consecutive floats.
//   Non-causal (kCausal false): every tile up to Sk is read, with no
//   causal limit and no tile skip. A cold partial whose bias masks every
//   column (s_cold = 0) is never skipped either: each score is -1e30,
//   p = exp(0) = 1, l = Sk, and its LSE near -1e30 gives it weight 0 in
//   the lse_combine with the resident partial (no 0/0 anywhere).
//
// What bounds it on the H100: at the main path's shapes (a 256-token
// chunk against <= 2k cached positions, head_dim 128) the work is a
// few GFLOP and a few MB, so the roofline bound is the tensor-core rate
// (989 TFLOP/s bf16). A tree verify chunk (16 rows against <= 2k keys,
// with the bias) is the other way round: ~0.1 GFLOP against ~3 MB of K/V
// read up to the causal limit (kv_offset 700) and 128 KB of bias, so
// its bound is the bytes (~0.9 us at 3.35 TB/s). A cold partial (a
// 128-row chunk against a 2048-key window at Qwen3-0.6B) is ~0.27 GFLOP
// against ~8.5 MB: bound by the bytes (~2.6 us).
//
// Two bodies. The TPU kernel carried (m, l, acc) in VMEM scratch across a
// sequential kv grid axis; Hopper blocks run in parallel in no order, so
// in both a block owns a (b*hq, q tile) and loops over kv tiles itself,
// stopping at the causal limit of its last row (the TPU kernel's block
// skip).
//
// The tensor-core body (flash_attention_tc_kernel): bf16 at head_dim 128
// over model-dtype K/V: causal without a bias (every prefill chunk) or
// with one (every tree verify chunk: 16 rows in the 64-row q tile, the
// rows past Sq zero-filled, never stored), and non-causal with or without
// one (the cold partial, ring attention).
// A block owns 64 q rows of one (b, q head) and runs two warpgroups; each
// computes all 64 rows against every other 64-key tile (warpgroup g takes
// tiles g, g + 2, ...), and the two merge their (m, l, acc) through
// shared memory at the end, by (m, l): an all-masked row then stays the
// mean of V over every column. Per tile, in one warpgroup:
//   - S = Q K^T on wgmma m64n64k16 (8 steps over head_dim), both operands
//     from shared memory in the 128-byte swizzle: Q staged once, K in its
//     natural [keys, D] layout (K-major), each a pair of 64-column boxes;
//   - the online softmax in log2 units (scores times sm_scale * log2 e,
//     the bias times log2 e, 2^x in one MUFU op; LSE = m ln 2 + log l):
//     the causal mask only on tiles that cross the diagonal, -inf past Sk
//     only on the last tile; a row's max reduces over the 4 threads of a
//     quad (two shuffles), l stays per thread until the end. The bias is
//     read in the accumulator's own (row, column) pattern, a tile ahead,
//     so its loads fly across the products;
//   - P, rounded to bf16 in pairs, is the A operand of O += P V straight
//     from registers (wgmma m64n128k16, the S fragment is the A fragment),
//     V read MN-major ([keys, D] row-major, never transposed); O is 64 f32
//     registers a thread.
// Tile i's Q K^T and tile i-1's P V are issued together, and tile i's
// softmax runs while P V multiplies (O is rescaled once P V retires).
// K and V tiles arrive by TMA (3-D tensor maps over [B*H, S, 128], so rows
// past Sk of one kv head are zero-filled, never the next head's; Q rows
// past Sq the same, computed on zeros and never stored) into a ring of 2
// stages a warpgroup, each K and V on its own mbarrier, refilled as soon
// as the product that reads it retires. What bounds it at the serving
// shapes is latency, not a rate: a 64-row q tile walks its keys in
// sequence, and the grids are small (64 blocks for a 256-row chunk of 16
// heads), so the time is a fixed ~11 us (launch, first loads, the merge)
// plus ~1.3 us a tile of each warpgroup (PERF.md).
//
// The masks in the tensor-core body: the bias is scaled to log2 units
// with the scores, so a masked bias entry is ~-1.44e30, below the causal
// mask's -1e30 (kNegInf). A row whose visible columns in a tile (or in all
// of one warpgroup's tiles) are all bias-masked then takes a tile maximum
// of -1e30 (causally masked columns) or -1.44e30, and its terms are
// zeroed by exp2(m_old - m_new) = 0 once a real score arrives, in the
// online softmax or in the warpgroups' merge; the tree verify mask always
// leaves a row its own column, so no row is all masked.
//
// The FMA body (flash_attention_kernel), every other build: f32 (the
// CPU-oracle mode of the card tests), head_dim 32 and int8 K/V. One block
// owns 16 query rows;
// K/V tiles of 32 keys are staged through shared memory in f32 (K rows
// padded by one float so the lane-per-key reads hit 32 distinct banks)
// and shared by the block's 4 warps; each warp owns 4 query rows. For a
// row, lane j scores key j of the tile, the warp reduces max and sum with
// shuffles, and P·V runs with each lane owning head_dim/32 output columns
// while p_j is broadcast by shuffle. Its products run on the f32 FMA
// pipes (67 TFLOP/s peak), far below the tensor cores.
#include "tdt_attention.cuh"
#include "tdt_common.cuh"
#include "tdt_hopper.cuh"

#include <climits>
#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 16;  // query rows per block, 4 per warp
constexpr int kBlockK = 32;  // keys per staged tile, one per lane

// T is q/o's type, KT the K/V element type (T, or int8_t codes with
// k_scale/v_scale [B, Hkv, Sk / block_k] f32); kBias adds bias [Sq, Sk]
// f32 to the scaled scores; kCausal masks columns past kv_offset + row.
template <typename T, typename KT, int D, bool kBias, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const KT* __restrict__ k,
                           const KT* __restrict__ v,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const float* __restrict__ bias,
                           T* __restrict__ o, float* __restrict__ lse,
                           int hq, int hkv, int sq, int sk, int kv_offset,
                           int block_k, float sm_scale) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int EPL = D / 32;            // output columns per lane
  constexpr int RPW = kBlockQ / kWarps;  // query rows per warp
  __shared__ float q_s[kBlockQ][D];
  __shared__ float k_s[kBlockK][D + 1];
  __shared__ float v_s[kBlockK][D];

  const int bh = blockIdx.x;  // b * hq + h
  const int b = bh / hq;
  const int h = bh % hq;
  const int kvh = h / (hq / hkv);
  const int q0 = blockIdx.y * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const T* qb = q + (size_t)bh * sq * D;
  const KT* kb = k + (size_t)(b * hkv + kvh) * sk * D;
  const KT* vb = v + (size_t)(b * hkv + kvh) * sk * D;
  const int n_blocks = kQuant ? sk / block_k : 0;
  const float* ksb = kQuant ? k_scale + (size_t)(b * hkv + kvh) * n_blocks
                            : nullptr;
  const float* vsb = kQuant ? v_scale + (size_t)(b * hkv + kvh) * n_blocks
                            : nullptr;

  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    q_s[r][c] = (q0 + r < sq) ? tdt::to_f32(qb[(size_t)(q0 + r) * D + c])
                              : 0.f;
  }

  // Columns this block can see: the causal limit of its last real row,
  // or every column when the attention is not causal.
  const int last_row = min(q0 + kBlockQ, sq) - 1;
  const int kv_end = kCausal ? min(sk, kv_offset + last_row + 1) : sk;

  float m[RPW], l[RPW], acc[RPW][EPL];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = tdt::kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[rr][e] = 0.f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < sk;
      k_s[r][c] = in ? tdt::to_f32(kb[(size_t)(k0 + r) * D + c]) : 0.f;
      v_s[r][c] = in ? tdt::to_f32(vb[(size_t)(k0 + r) * D + c]) : 0.f;
    }
    __syncthreads();
    const int col = k0 + lane;
    // This lane's key: its score multiplier and P·V weight scale.
    float k_mult = sm_scale, v_mult = 1.f;
    if constexpr (kQuant) {
      if (col < sk) {
        k_mult = sm_scale * ksb[col / block_k];
        v_mult = vsb[col / block_k];
      }
    }
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      const int row = q0 + r;
      if (row >= sq) continue;  // warp-uniform
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(q_s[r][d], k_s[lane][d], s);
      s *= k_mult;
      if constexpr (kBias) {
        if (col < sk) s += __ldg(bias + (size_t)row * sk + col);
      }
      if (kCausal && col > kv_offset + row) s = tdt::kNegInf;
      if (col >= sk) s = -__int_as_float(0x7f800000);  // -inf: weight 0
      const float m_new = fmaxf(m[rr], tdt::warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + tdt::warp_sum(p);
      float pr;
      if constexpr (kQuant)
        pr = p * v_mult;
      else
        pr = tdt::round_to<T>(p);
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[rr][e] *= alpha;
#pragma unroll 8
      for (int j = 0; j < kBlockK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pr, j);
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[rr][e] = fmaf(pj, v_s[j][e * 32 + lane], acc[rr][e]);
      }
      m[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int row = q0 + warp * RPW + rr;
    if (row >= sq) continue;
    const float lf = fmaxf(l[rr], 1e-30f);
    T* ob = o + ((size_t)bh * sq + row) * D;
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      ob[e * 32 + lane] = tdt::from_f32<T>(acc[rr][e] / lf);
    if (lse != nullptr && lane == 0)
      lse[(size_t)bh * sq + row] = m[rr] + logf(lf);
  }
}

// ---------------------------------------------------------------------------
// The tensor-core body (the design note above): bf16, head_dim 128.

namespace tc {

// The tile's products, softmax steps and constants (kD, kKeys, kBox,
// kTile, kLog2e, kLn2) are tdt_attention.cuh's.
using namespace tdt::attn;
using BF16 = __nv_bfloat16;

constexpr int kRows = 64;     // q rows a block: one wgmma's M
constexpr int kGroups = 2;    // warpgroups, splitting a q tile's key tiles
constexpr int kStages = 2;    // K/V tiles in flight a warpgroup
constexpr int kThreads = 128 * kGroups;
constexpr int kBufs = 1 + kGroups * kStages * 2;  // Q, then K, V a stage
// 1 KB of slack aligns the tiles to the swizzle's 1024-byte atoms; one
// mbarrier a buffer.
constexpr int kSmem = 1024 + kBufs * kTile + 8 * kBufs;
// The merge stages a warpgroup's acc, m and l, f32 [68][128], in the ring.
static_assert((kD / 2 + 4) * 128 * 4 <= (kBufs - 1) * kTile,
              "the merge staging reuses the ring");

// Q [B*Hq, Sq, 128], K and V [B*Hkv, Sk, 128] (bf16) as boxes of 64
// columns x 64 rows x 1 head in the 128-byte swizzle, zero past Sq / Sk:
// passed by value as a __grid_constant__ parameter (TMA reads param space).
struct alignas(64) QkvMaps {
  CUtensorMap q, k, v;
};

// Tile i of warpgroup g's share: its K buffer (its V buffer is the next),
// the parity of the buffer's use, and its first key.
__device__ __forceinline__ int kv_buf(int g, int i) {
  return (g * kStages + i % kStages) * 2;
}
__device__ __forceinline__ uint32_t kv_parity(int i) {
  return uint32_t(i / kStages) & 1;
}
__device__ __forceinline__ int tile_key(int g, int i) {
  return (g + i * kGroups) * kKeys;
}

// Issues the K (v = 0) or V (v = 1) half of tile i of warpgroup g's share
// (key tile g + i * kGroups) into its stage: a pair of 64-column boxes on
// the buffer's own mbarrier. One thread of the warpgroup calls it.
__device__ __forceinline__ void load_kv(const QkvMaps& maps, uint8_t* ring,
                                        uint64_t* bars, int g, int i, int v,
                                        int kvbh) {
  const int buf = kv_buf(g, i) + v;
  uint8_t* dst = ring + buf * kTile;
  const CUtensorMap* map = v ? &maps.v : &maps.k;
  tdt::mbar_expect_tx(bars + buf, kTile);
  tdt::tma_load_3d(dst, map, bars + buf, 0, tile_key(g, i), kvbh);
  tdt::tma_load_3d(dst + kBox, map, bars + buf, 64, tile_key(g, i), kvbh);
}

// The bias of the thread's accumulator elements in the 64-key tile at k0
// (0 outside [Sq, Sk]), in the S fragment's order. Nothing consumes the
// loads here: they stay in flight across the products (a use right after
// them, such as a scale to log2 units, would stall every tile on them).
__device__ __forceinline__ void load_bias(float (&bv)[32],
                                          const float* __restrict__ bias,
                                          int ra, int rb, int cq, int k0,
                                          int sq, int sk) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = k0 + 8 * j + cq + e;
      bv[4 * j + e] =
          (ra < sq && c < sk) ? __ldg(bias + (size_t)ra * sk + c) : 0.f;
      bv[4 * j + 2 + e] =
          (rb < sq && c < sk) ? __ldg(bias + (size_t)rb * sk + c) : 0.f;
    }
}

// The online softmax of the tile at k0 on the S fragment (rows ra, rb;
// columns k0 + 8j + cq + {0, 1}), in place and in log2 units (scale2 =
// sm_scale * log2 e; m is in log2 units too): the per-element masks only
// on a tile that crosses the causal diagonal or Sk; the row maxima over
// the quad; s becomes 2^(s - m), unrounded; l is rescaled and summed
// over the thread's columns. alpha_a/b rescale the old acc.
template <bool kBias, bool kCausal>
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], const float (&bv)[kBias ? 32 : 1], int k0, int q0,
    int ra, int rb, int cq, int sk, int kv_offset, float scale2,
    float& m_a, float& m_b, float& l_a, float& l_b, float& alpha_a,
    float& alpha_b) {
  const bool diag = kCausal && k0 + kKeys - 1 > kv_offset + q0;
  float mx_a = m_a, mx_b = m_b;
  if (diag || k0 + kKeys > sk)
    score_tile<kBias, true>(s, bv, scale2, k0, cq,
                            kCausal ? kv_offset + ra : INT_MAX,
                            kCausal ? kv_offset + rb : INT_MAX, sk, mx_a,
                            mx_b);
  else
    score_tile<kBias, false>(s, bv, scale2, k0, cq, 0, 0, sk, mx_a, mx_b);
  softmax_update(s, mx_a, mx_b, m_a, m_b, l_a, l_b, alpha_a, alpha_b);
}

}  // namespace tc

// kBias adds bias [Sq, Sk] f32 to the scaled scores; kCausal masks columns
// past kv_offset + row. Grid (B*Hq, ceil(Sq / 64)), kThreads threads,
// kSmem bytes of dynamic shared memory.
template <bool kBias, bool kCausal>
__global__ void __launch_bounds__(tc::kThreads, 1)
    flash_attention_tc_kernel(const __grid_constant__ tc::QkvMaps maps,
                              const float* __restrict__ bias,
                              tc::BF16* __restrict__ o,
                              float* __restrict__ lse, int hq, int hkv,
                              int sq, int sk, int kv_offset, float sm_scale) {
  using namespace tc;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = q_s + kTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(q_s + kBufs * kTile);
  uint64_t* kv_bars = bars + 1;  // bars[0]: Q

  const int tid = threadIdx.x, g = tid / 128, t = tid % 128;
  const int bh = blockIdx.x;  // b * hq + h
  const int kvbh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  // The heaviest (last) q tiles of every head go first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int last_row = min(q0 + kRows, sq) - 1;
  const int kv_end = kCausal ? min(sk, kv_offset + last_row + 1) : sk;
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;
  const int mine = n_tiles > g ? (n_tiles - g + kGroups - 1) / kGroups : 0;

  if (tid == 0) {
    for (int i = 0; i < kBufs; ++i) tdt::mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    tdt::mbar_expect_tx(bars, kTile);
    tdt::tma_load_3d(q_s, &maps.q, bars, 0, q0, bh);
    tdt::tma_load_3d(q_s + kBox, &maps.q, bars, 64, q0, bh);
  }
  if (t == 0)
    for (int i = 0; i < kStages && i < mine; ++i) {
      load_kv(maps, ring, kv_bars, g, i, 0, kvbh);
      load_kv(maps, ring, kv_bars, g, i, 1, kvbh);
    }

  // The thread's accumulator rows ra, rb (absolute) and column pair cq.
  const int lane = t % 32;
  const int ra = q0 + (t / 32) * 16 + lane / 4, rb = ra + 8;
  const int cq = 2 * (lane % 4);
  float o_acc[64], s_acc[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) o_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s_acc[i] = 0.f;
  // m starts at -inf: a row whose scores are all bias-masked (-1e30 in
  // natural units, below -1e30 in log2 units) then weighs each column 1.
  const float scale2 = sm_scale * kLog2e;
  float m_a = -__int_as_float(0x7f800000), m_b = m_a, l_a = 0.f, l_b = 0.f;
  // The bias of the next tile, loaded a tile ahead of its use.
  float bv[kBias ? 32 : 1];
  if constexpr (kBias)
    if (mine > 0) load_bias(bv, bias, ra, rb, cq, tile_key(g, 0), sq, sk);

  const uint32_t qa = tdt::smem_u32(q_s), ring_a = tdt::smem_u32(ring);
  uint32_t p[16];
  float alpha_a, alpha_b;
  if (mine > 0) {
    tdt::mbar_wait(bars, 0);
    tdt::mbar_wait(kv_bars + kv_buf(g, 0), 0);
    issue_qk(s_acc, qa, ring_a + kv_buf(g, 0) * kTile);
    tdt::wgmma_wait<0>();
    tdt::fence_acc(s_acc);
    softmax_tile<kBias, kCausal>(s_acc, bv, tile_key(g, 0), q0, ra, rb, cq,
                                 sk, kv_offset, scale2, m_a, m_b, l_a,
                                 l_b, alpha_a, alpha_b);  // acc is still 0
    if constexpr (kBias)
      if (mine > 1) load_bias(bv, bias, ra, rb, cq, tile_key(g, 1), sq, sk);
    pack_p(p, s_acc);
    if (kStages < mine) {  // K(0) is read: refill its buffer
      asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");
      if (t == 0) load_kv(maps, ring, kv_bars, g, kStages, 0, kvbh);
    }
  }
  // Tile i's S = Q K^T and tile i-1's O += P V go out together; the
  // softmax of tile i runs while P·V multiplies, then O is rescaled.
  for (int i = 1; i < mine; ++i) {
    tdt::mbar_wait(kv_bars + kv_buf(g, i), kv_parity(i));
    issue_qk(s_acc, qa, ring_a + kv_buf(g, i) * kTile);
    tdt::mbar_wait(kv_bars + kv_buf(g, i - 1) + 1, kv_parity(i - 1));
    issue_pv(o_acc, p, ring_a + (kv_buf(g, i - 1) + 1) * kTile);
    tdt::wgmma_wait<1>();
    tdt::fence_acc(s_acc);
    softmax_tile<kBias, kCausal>(s_acc, bv, tile_key(g, i), q0, ra, rb, cq,
                                 sk, kv_offset, scale2, m_a, m_b, l_a,
                                 l_b, alpha_a, alpha_b);
    if constexpr (kBias)  // bv is consumed: fetch the next tile's
      if (i + 1 < mine)
        load_bias(bv, bias, ra, rb, cq, tile_key(g, i + 1), sq, sk);
    tdt::wgmma_wait<0>();
    tdt::fence_acc(o_acc);
    rescale_o(o_acc, alpha_a, alpha_b);
    pack_p(p, s_acc);
    // K(i) and V(i-1) are read: refill their buffers.
    if (i - 1 + kStages < mine) {
      asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");
      if (t == 0) {
        if (i + kStages < mine)
          load_kv(maps, ring, kv_bars, g, i + kStages, 0, kvbh);
        load_kv(maps, ring, kv_bars, g, i - 1 + kStages, 1, kvbh);
      }
    }
  }
  if (mine > 0) {
    const int last = mine - 1;
    tdt::mbar_wait(kv_bars + kv_buf(g, last) + 1, kv_parity(last));
    issue_pv(o_acc, p, ring_a + (kv_buf(g, last) + 1) * kTile);
    tdt::wgmma_wait<0>();
    tdt::fence_acc(o_acc);
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  // Warpgroups 1.. hand (acc, m, l) to warpgroup 0 through the ring, one
  // float a (register, thread): O = sum of acc_g * exp(m_g - m), l the same.
  float* st = reinterpret_cast<float*>(ring);
#pragma unroll 1
  for (int src = 1; src < kGroups; ++src) {
    __syncthreads();  // every product has retired; the ring is free
    tdt::fence_proxy_async_smem();
    if (g == src) {
#pragma unroll
      for (int i = 0; i < 64; ++i) st[i * 128 + t] = o_acc[i];
      st[64 * 128 + t] = m_a;
      st[65 * 128 + t] = m_b;
      st[66 * 128 + t] = l_a;
      st[67 * 128 + t] = l_b;
    }
    __syncthreads();
    if (g == 0) {
      const float m1a = st[64 * 128 + t], m1b = st[65 * 128 + t];
      const float na = fmaxf(m_a, m1a), nb = fmaxf(m_b, m1b);
      const float s0a = ex2(m_a - na), s1a = ex2(m1a - na);
      const float s0b = ex2(m_b - nb), s1b = ex2(m1b - nb);
      l_a = l_a * s0a + st[66 * 128 + t] * s1a;
      l_b = l_b * s0b + st[67 * 128 + t] * s1b;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o_acc[4 * j] = o_acc[4 * j] * s0a + st[(4 * j) * 128 + t] * s1a;
        o_acc[4 * j + 1] =
            o_acc[4 * j + 1] * s0a + st[(4 * j + 1) * 128 + t] * s1a;
        o_acc[4 * j + 2] =
            o_acc[4 * j + 2] * s0b + st[(4 * j + 2) * 128 + t] * s1b;
        o_acc[4 * j + 3] =
            o_acc[4 * j + 3] * s0b + st[(4 * j + 3) * 128 + t] * s1b;
      }
      m_a = na;
      m_b = nb;
    }
  }
  if (g != 0) return;
  const float la = fmaxf(l_a, 1e-30f), lb = fmaxf(l_b, 1e-30f);
  BF16* oa = o + ((size_t)bh * sq + ra) * kD + cq;
  BF16* ob = oa + 8 * kD;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (ra < sq)
      *reinterpret_cast<__nv_bfloat162*>(oa + 8 * j) =
          __floats2bfloat162_rn(o_acc[4 * j] / la, o_acc[4 * j + 1] / la);
    if (rb < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * j) =
          __floats2bfloat162_rn(o_acc[4 * j + 2] / lb,
                                o_acc[4 * j + 3] / lb);
  }
  if (lse != nullptr && lane % 4 == 0) {
    if (ra < sq) lse[(size_t)bh * sq + ra] = m_a * kLn2 + logf(la);
    if (rb < sq) lse[(size_t)bh * sq + rb] = m_b * kLn2 + logf(lb);
  }
}

// The operands of one launch (the C entry points fill it).
struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;  // null: K/V of q's type
  const float* v_scale;
  const float* bias;  // null: no score bias
  void* o;
  float* lse;  // may be null
  int b, hq, hkv, sq, sk, kv_offset, block_k;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, typename KT, int D, bool kBias, bool kCausal>
void launch(const AttnArgs& a) {
  dim3 grid(a.b * a.hq, (a.sq + kBlockQ - 1) / kBlockQ);
  flash_attention_kernel<T, KT, D, kBias, kCausal>
      <<<grid, kThreads, 0, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const KT*>(a.k),
          static_cast<const KT*>(a.v), a.k_scale, a.v_scale, a.bias,
          static_cast<T*>(a.o), a.lse, a.hq, a.hkv, a.sq, a.sk, a.kv_offset,
          a.block_k, a.sm_scale);
}

// [rows, 128] bf16 rows of `heads` heads as the tensor-core body's boxes:
// 64 columns x 64 rows x 1 head, zero past `rows`.
bool encode_heads(CUtensorMap* map, const void* p, int rows, int heads) {
  return tdt::attn::encode_rows(map, p, rows, heads, tc::kRows, 1);
}

// One launch of the tensor-core body; 1 if its shared memory or tensor
// maps are refused.
template <bool kBias, bool kCausal>
int launch_tc(const AttnArgs& a) {
  static_assert(tc::kRows == tc::kKeys, "one box shape serves Q, K and V");
  static bool ready[64] = {};  // the shared-memory limit raised, a device
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (!ready[dev]) {
    if (cudaFuncSetAttribute(flash_attention_tc_kernel<kBias, kCausal>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tc::kSmem) != cudaSuccess)
      return 1;
    ready[dev] = true;
  }
  tc::QkvMaps maps;
  if (!encode_heads(&maps.q, a.q, a.sq, a.b * a.hq) ||
      !encode_heads(&maps.k, a.k, a.sk, a.b * a.hkv) ||
      !encode_heads(&maps.v, a.v, a.sk, a.b * a.hkv))
    return 1;
  dim3 grid(a.b * a.hq, (a.sq + tc::kRows - 1) / tc::kRows);
  flash_attention_tc_kernel<kBias, kCausal>
      <<<grid, tc::kThreads, tc::kSmem, a.stream>>>(
      maps, a.bias, static_cast<tc::BF16*>(a.o), a.lse, a.hq, a.hkv, a.sq,
      a.sk, a.kv_offset, a.sm_scale);
  return 0;
}

// The instances the entry points take: causal with int8 scales, with a
// bias, or with neither; non-causal with or without int8 scales and with
// or without a bias. Causal int8 with a bias is on no serving path and
// is refused. bf16 at head_dim 128 over model-dtype K/V takes the
// tensor-core body (causal or not, with or without a bias); no FMA build
// of those is compiled.
template <typename T, int D>
int launch_kv(const AttnArgs& a, bool causal) {
  constexpr bool kTc = std::is_same<T, tc::BF16>::value && D == tc::kD;
  const bool quant = a.k_scale != nullptr, bias = a.bias != nullptr;
  if (causal) {
    if (quant && bias) return 1;
    if (quant) {
      launch<T, int8_t, D, false, true>(a);
    } else if (bias) {
      if constexpr (kTc) return launch_tc<true, true>(a);
      else launch<T, T, D, true, true>(a);
    } else {
      if constexpr (kTc) return launch_tc<false, true>(a);
      else launch<T, T, D, false, true>(a);
    }
  } else if (quant) {
    if (bias)
      launch<T, int8_t, D, true, false>(a);
    else
      launch<T, int8_t, D, false, false>(a);
  } else if (bias) {
    if constexpr (kTc) return launch_tc<true, false>(a);
    else launch<T, T, D, true, false>(a);
  } else {
    if constexpr (kTc) return launch_tc<false, false>(a);
    else launch<T, T, D, false, false>(a);
  }
  return 0;
}

template <typename T>
int dispatch_d(int d, const AttnArgs& a, bool causal) {
  switch (d) {
    case 32: return launch_kv<T, 32>(a, causal);
    case 128: return launch_kv<T, 128>(a, causal);
    default: return 1;
  }
}

int run(const AttnArgs& a, int d, bool causal, int dtype) {
  if (a.k_scale != nullptr &&
      (a.v_scale == nullptr || a.block_k < 1 || a.sk % a.block_k != 0))
    return (int)cudaErrorInvalidValue;
  int bad = 1;
  if (dtype == tdt::kDtypeF32)
    bad = dispatch_d<float>(d, a, causal);
  else if (dtype == tdt::kDtypeBF16)
    bad = dispatch_d<__nv_bfloat16>(d, a, causal);
  if (bad) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D], o like q, lse [B, Hq, Sq] f32 or
// null; all contiguous. Returns a cudaError_t (0 on success).
extern "C" int tdt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       int b, int hq, int hkv, int sq, int sk,
                                       int d, int kv_offset, float sm_scale,
                                       int dtype, void* stream) {
  AttnArgs a{q, k, v, nullptr, nullptr, nullptr, o, lse, b, hq, hkv, sq, sk,
             kv_offset, 1, sm_scale, static_cast<cudaStream_t>(stream)};
  return run(a, d, true, dtype);
}

// Additive score bias: bias [Sq, Sk] f32 (non-null, contiguous), shared by
// every batch row and head; the rest as tdt_flash_attention_fwd.
extern "C" int tdt_flash_attention_bias_fwd(
    const void* q, const void* k, const void* v, const float* bias, void* o,
    float* lse, int b, int hq, int hkv, int sq, int sk, int d, int kv_offset,
    float sm_scale, int dtype, void* stream) {
  if (bias == nullptr) return (int)cudaErrorInvalidValue;
  AttnArgs a{q, k, v, nullptr, nullptr, bias, o, lse, b, hq, hkv, sq, sk,
             kv_offset, 1, sm_scale, static_cast<cudaStream_t>(stream)};
  return run(a, d, true, dtype);
}

// int8 K/V: k/v int8 codes [B, Hkv, Sk, D], k_scale/v_scale [B, Hkv,
// Sk / block_k] f32 (non-null, Sk a multiple of block_k); q/o of `dtype`;
// the rest as above.
extern "C" int tdt_flash_attention_int8_fwd(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, void* o, float* lse, int b, int hq, int hkv,
    int sq, int sk, int d, int kv_offset, int block_k, float sm_scale,
    int dtype, void* stream) {
  if (k_scale == nullptr) return (int)cudaErrorInvalidValue;
  AttnArgs a{q, k, v, k_scale, v_scale, nullptr, o, lse, b, hq, hkv, sq, sk,
             kv_offset, block_k, sm_scale, static_cast<cudaStream_t>(stream)};
  return run(a, d, true, dtype);
}

// Non-causal (the cold partial of a sharded prefill chunk): every query
// row attends every column below Sk, bias [Sq, Sk] f32 or null; K/V of
// q's type; the rest as tdt_flash_attention_fwd.
extern "C" int tdt_flash_attention_cold_fwd(
    const void* q, const void* k, const void* v, const float* bias, void* o,
    float* lse, int b, int hq, int hkv, int sq, int sk, int d,
    float sm_scale, int dtype, void* stream) {
  AttnArgs a{q, k, v, nullptr, nullptr, bias, o, lse, b, hq, hkv, sq, sk, 0,
             1, sm_scale, static_cast<cudaStream_t>(stream)};
  return run(a, d, false, dtype);
}

// Non-causal over int8 codes: scales as tdt_flash_attention_int8_fwd
// (non-null), bias [Sq, Sk] f32 or null.
extern "C" int tdt_flash_attention_cold_int8_fwd(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, const float* bias, void* o, float* lse, int b,
    int hq, int hkv, int sq, int sk, int d, int block_k, float sm_scale,
    int dtype, void* stream) {
  if (k_scale == nullptr) return (int)cudaErrorInvalidValue;
  AttnArgs a{q, k, v, k_scale, v_scale, bias, o, lse, b, hq, hkv, sq, sk, 0,
             block_k, sm_scale, static_cast<cudaStream_t>(stream)};
  return run(a, d, false, dtype);
}
