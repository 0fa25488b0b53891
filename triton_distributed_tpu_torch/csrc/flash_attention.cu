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
// (989 TFLOP/s bf16). This first version does its products on the f32
// FMA pipes (67 TFLOP/s peak), so it is operation-bound far below that
// roofline; moving QK^T and P·V onto wgmma with TMA-fed K/V tiles is
// the next step. A tree verify chunk (16 rows against <= 2k keys, with
// the bias) is the other way round: ~0.1 GFLOP against ~3 MB of K/V
// read up to the causal limit (kv_offset 700) and 128 KB of bias, so
// its bound is the bytes (~0.9 us at 3.35 TB/s), and
// with one 16-row block per head only 16 blocks run; the kernel is
// latency-bound there, which a split over keys would address. A cold
// partial (a 128-row chunk against a 2048-key window at Qwen3-0.6B) is
// ~0.27 GFLOP against ~8.5 MB: bound by the bytes (~2.6 us), and run at
// the FMA pipes' rate like the causal chunk.
//
// Design: the TPU kernel carried (m, l, acc) in VMEM scratch across a
// sequential kv grid axis; Hopper blocks run in parallel in no order, so
// one block owns a (b*hq, 16-row q tile) and loops over kv tiles itself,
// stopping at the causal limit of its last row (the TPU kernel's block
// skip). K/V tiles of 32 keys are staged through shared memory in f32
// (K rows padded by one float so the lane-per-key reads hit 32 distinct
// banks) and shared by the block's 4 warps; each warp owns 4 query rows.
// For a row, lane j scores key j of the tile, the warp reduces max and
// sum with shuffles, and P·V runs with each lane owning head_dim/32
// output columns while p_j is broadcast by shuffle.
#include "tdt_common.cuh"

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

// The instances the entry points take: causal with int8 scales, with a
// bias, or with neither; non-causal with or without int8 scales and with
// or without a bias. Causal int8 with a bias is on no serving path and
// is refused.
template <typename T, int D>
int launch_kv(const AttnArgs& a, bool causal) {
  const bool quant = a.k_scale != nullptr, bias = a.bias != nullptr;
  if (causal) {
    if (quant && bias) return 1;
    if (quant)
      launch<T, int8_t, D, false, true>(a);
    else if (bias)
      launch<T, T, D, true, true>(a);
    else
      launch<T, T, D, false, true>(a);
  } else if (quant) {
    if (bias)
      launch<T, int8_t, D, true, false>(a);
    else
      launch<T, int8_t, D, false, false>(a);
  } else if (bias) {
    launch<T, T, D, true, false>(a);
  } else {
    launch<T, T, D, false, false>(a);
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
