// The tensor-core attention tile shared by the port's wgmma attention
// bodies (sm_90a): flash_attention.cu's `flash_attention_tc_kernel` and
// sp_attention.cu's bf16 SP kernel. A consumer warpgroup owns 64 q rows
// (a [64, 128] bf16 tile in shared memory as two 64-column boxes in the
// 128-byte swizzle) and walks 64-key K/V tiles of the same layout:
//   - S = Q K^T on wgmma m64n64k16 (8 steps over head_dim), both operands
//     K-major from shared memory;
//   - the online softmax in log2 units (scores times sm_scale * log2 e,
//     2^x in one MUFU op; LSE = m ln 2 + log l): the per-element masks only
//     on a tile that needs them, a row's max over the 4 threads of a quad;
//   - P rounded to bf16 in pairs is the A operand of O += P V from
//     registers (wgmma m64n128k16), V read MN-major, never transposed.
// The thread's accumulator rows are ra = 16 * warp + lane / 4 and rb =
// ra + 8 of the tile, its columns 8j + 2 (lane % 4) + {0, 1}.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "tdt_common.cuh"
#include "tdt_hopper.cuh"

namespace tdt {
namespace attn {

constexpr int kD = 128;            // head_dim
constexpr int kKeys = 64;          // keys a tile: S's N, P·V's depth
constexpr int kBox = 64 * 64 * 2;  // [64 rows, 64 columns] bf16: 8 KB
constexpr int kTile = 2 * kBox;    // [64 rows, 128 columns]: two boxes
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x in one MUFU op (denormal results flush to 0: weight 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// S = Q K^T for one tile, issued and committed: head_dim in 8 steps of 16;
// step kk reads 32 bytes into the kk/4-th 64-column box of each operand
// (8-row groups 1024 B apart).
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t qa,
                                         uint32_t ka) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
    wgmma_m64n64k16_kk(s, wgmma_desc(qa + off, 16, 1024),
                       wgmma_desc(ka + off, 16, 1024), kk);
  }
  wgmma_commit();
}

// O += P V for one tile, issued and committed: the 64 keys in 4 steps of
// 16 (16 rows of 128 B), the second 64 columns of V one box on; P in the
// A fragment's registers.
__device__ __forceinline__ void issue_pv(float (&o)[64],
                                         const uint32_t (&p)[16],
                                         uint32_t va) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3]};
    wgmma_m64n128k16_rs(o, a, wgmma_desc(va + kk * 2048, kBox, 1024));
  }
  wgmma_commit();
}

// The scores of the tile at k0 in log2 units, s * scale2 (+ bias), and
// their running row maxima; with kMask, -1e30 past the causal limits
// lim_a, lim_b and -inf (weight 0) past sk.
template <bool kBias, bool kMask>
__device__ __forceinline__ void score_tile(float (&s)[32],
                                           const float (&bv)[kBias ? 32 : 1],
                                           float scale2, int k0, int cq,
                                           int lim_a, int lim_b, int sk,
                                           float& mx_a, float& mx_b) {
  const float ninf = -__int_as_float(0x7f800000);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float xa = s[4 * j + e] * scale2, xb = s[4 * j + 2 + e] * scale2;
      if constexpr (kBias) {
        xa = fmaf(bv[4 * j + e], kLog2e, xa);
        xb = fmaf(bv[4 * j + 2 + e], kLog2e, xb);
      }
      if constexpr (kMask) {
        const int c = k0 + 8 * j + cq + e;
        if (c > lim_a) xa = kNegInf;
        if (c > lim_b) xb = kNegInf;
        if (c >= sk) xa = xb = ninf;
      }
      s[4 * j + e] = xa;
      s[4 * j + 2 + e] = xb;
      mx_a = fmaxf(mx_a, xa);
      mx_b = fmaxf(mx_b, xb);
    }
}

// The online softmax's update once a tile's scores (log2 units) and their
// thread maxima mx_a, mx_b are in s: the row maxima over the quad; s
// becomes 2^(s - m), unrounded; l is rescaled and summed over the
// thread's columns; alpha_a/b rescale the old acc.
__device__ __forceinline__ void softmax_update(float (&s)[32], float mx_a,
                                               float mx_b, float& m_a,
                                               float& m_b, float& l_a,
                                               float& l_b, float& alpha_a,
                                               float& alpha_b) {
  mx_a = quad_max(mx_a);
  mx_b = quad_max(mx_b);
  alpha_a = ex2(m_a - mx_a);
  alpha_b = ex2(m_b - mx_b);
  m_a = mx_a;
  m_b = mx_b;
  l_a *= alpha_a;
  l_b *= alpha_b;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * j + e] = ex2(s[4 * j + e] - m_a);
      s[4 * j + 2 + e] = ex2(s[4 * j + 2 + e] - m_b);
    }
    l_a += s[4 * j] + s[4 * j + 1];
    l_b += s[4 * j + 2] + s[4 * j + 3];
  }
}

// P in bf16 pairs, laid out as P·V's A fragment: key pair j of row a,
// then of row b.
__device__ __forceinline__ void pack_p(uint32_t (&p)[16],
                                       const float (&s)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    p[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
    p[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

// O *= alpha by row: the old acc rescaled once P·V of the earlier tile has
// retired.
__device__ __forceinline__ void rescale_o(float (&o)[64], float alpha_a,
                                          float alpha_b) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    o[4 * j] *= alpha_a;
    o[4 * j + 1] *= alpha_a;
    o[4 * j + 2] *= alpha_b;
    o[4 * j + 3] *= alpha_b;
  }
}

// [rows, 128] bf16 rows of `heads` heads ([heads, rows, 128] contiguous)
// as TMA boxes of 64 columns x box_rows rows x box_heads heads in the
// 128-byte swizzle, zero past `rows` (never the next head's rows): a box
// lands as box_heads x box_rows consecutive 128-byte rows.
inline bool encode_rows(CUtensorMap* map, const void* p, int rows, int heads,
                        int box_rows, int box_heads) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {kD, static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {
      kD * sizeof(__nv_bfloat16),
      static_cast<cuuint64_t>(rows) * kD * sizeof(__nv_bfloat16)};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows),
                             static_cast<cuuint32_t>(box_heads)};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace attn
}  // namespace tdt
