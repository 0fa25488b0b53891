// Single-token GQA decode attention for Hopper (sm_90a): one source, three
// entry points.
//
// Replaces:
//   - triton_distributed_tpu/ops/attention/flash_decode.py
//     `_paged_decode_kernel` (entry `paged_flash_decode`): decode straight
//     over the paged KV pool through the page table (the
//     ContinuousEngine / Engine(paged=True) decode step);
//   - `_decode_kernel` (entry `flash_decode`): the same split-KV decode
//     over a dense [B, Hkv, S, D] cache in chunk_k chunks
//     (Engine(paged=False));
//   - `_paged_decode_kernel_q` (entry `paged_flash_decode` with
//     k_scale/v_scale): the paged decode over an int8 pool with one f32
//     scale per (page, kv head) (kv_dtype="int8");
//   - `_decode_kernel_q` (entry `flash_decode` with k_scale/v_scale): the
//     dense decode over int8 codes with one f32 scale per chunk_k keys
//     per kv head ([B, Hkv, S / chunk_k]): the cold partial of a sharded
//     long-context slot's decode over an int8 pool (chunk_k = page).
// All share the TPU body `_decode_body`; here they share one kernel pair,
// templated on the K/V element type (q's type, or int8_t codes) and told
// apart by the page table pointer (null = dense). A chunk's scale is
// k_scale[page, h] through the table, or k_scale[b, h, chunk] dense.
//
// What it computes: for sequence b and kv head h, the `group` query rows
// of that head against the first kv_len[b] cached positions, exactly as
// the TPU kernels do: one (O, LSE) partial per chunk (page) — chunk max
// m_c, p = exp(s - m_c), l_c summed from unrounded p, O_c = P·V / l_c,
// LSE_c = m_c + log(l_c) — then the log-sum-exp merge of `lse_combine`.
// Full width: s = (q . k) * sm_scale and p is rounded to V's dtype before
// P·V. int8: s = (q . code) * (sm_scale * k_scale[chunk's scale]) and
// O_c = ((sum_j p_j * code_j) * v_scale[chunk's scale]) / l_c with p
// unrounded,
// the order of the TPU kernel's in-register dequant. Chunks at or past
// ceil(kv_len / chunk) are never read (their partials have weight 0 in
// lse_combine), so a kv_len of 0 reads nothing and yields O = 0,
// LSE = -1e30, and unused table entries (the trash page 0) and their
// scales are never dereferenced.
//
// What bounds it on the H100: bytes. Each step reads every cached K and
// V row once (kv_len * head_dim * 2 * element bytes per (b, kv head);
// half as many with int8 codes, plus 8 bytes of scales per page) and
// does ~4 * group FLOPs per K/V element pair, far below the card's ~295
// FLOP/byte balance point, so the bound is kv bytes / 3.35 TB/s.
//
// Design: the TPU grid (b, kv head, chunk) becomes the CUDA grid, so a
// batch-4 step at a 2k context runs hundreds of blocks instead of one per
// (b, kv head); a second small kernel merges the chunk partials. Inside a
// block, 8 warps own whole keys: each lane loads EPL contiguous elements
// of a row with one vector load (full width: D/32 elements, 8 or 16
// bytes; int8: 16 codes, 16 bytes, so D/16 lanes cover a row and one
// warp instruction loads 32*16/D rows), and each warp issues the loads of
// kUnroll such instructions before using any of them, which keeps enough
// bytes in flight to approach the HBM rate. Scores are summed over a
// row's lanes with shuffles; only the chunk's scores go through shared
// memory, and the group's query rows stay in registers.
#include "tdt_common.cuh"

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // load instructions a warp issues together
constexpr int kMaxChunk = 256;

// Sum over aligned groups of LPR lanes (LPR a power of two <= 32).
template <int LPR>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One (b, kv head, chunk) block: the chunk's partial O [G, D] (already
// divided by l_c) and LSE [G], f32, into the partial buffers. T is q/o's
// type, KT the K/V element type (T, or int8_t with per-page scales).
template <typename T, typename KT, int D, int G>
__global__ void __launch_bounds__(kThreads)
    decode_chunk_kernel(const T* __restrict__ q, const KT* __restrict__ k,
                        const KT* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ table,
                        const int* __restrict__ kv_len,
                        float* __restrict__ o_part,
                        float* __restrict__ lse_part, int hkv, int chunk,
                        int n_chunks, float sm_scale) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int EPL = kQuant ? 16 : D / 32;  // contiguous elements per lane
  constexpr int LPR = D / EPL;               // lanes per row
  constexpr int RPI = 32 / LPR;              // rows per warp load
  constexpr int STEP = kUnroll * RPI;        // rows per warp iteration
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "row layout");
  __shared__ float q_s[G][D];
  __shared__ float p_s[G][kMaxChunk];
  __shared__ float mc_s[G], lc_s[G];
  __shared__ float red_s[kWarps][G][D];

  const int bh = blockIdx.x;  // b * hkv + h
  const int c = blockIdx.y;
  const int b = bh / hkv;
  const int h = bh % hkv;
  const int valid = min(max(kv_len[b], 0) - c * chunk, chunk);
  if (valid <= 0) return;  // never read: weight 0 in the merge
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LPR;          // row of this lane within a load
  const int col = (lane % LPR) * EPL;  // first column of this lane

  for (int i = threadIdx.x; i < G * D; i += kThreads)
    q_s[i / D][i % D] = tdt::to_f32(q[(size_t)bh * G * D + i]);
  __syncthreads();
  float qr[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[g][e] = q_s[g][col + e];

  // Dense: row (b*hkv + h) * S + c * chunk with S = n_chunks * chunk.
  // Paged: row (table[b, c] * hkv + h) * page.
  const int pid = table != nullptr ? table[(size_t)b * n_chunks + c] : 0;
  const size_t row0 = table != nullptr
                          ? ((size_t)pid * hkv + h) * chunk
                          : ((size_t)bh * n_chunks + c) * chunk;
  const KT* kc = k + row0 * D + col;
  const KT* vc = v + row0 * D + col;
  float k_mult = sm_scale, v_mult = 1.f;
  if constexpr (kQuant) {
    const size_t si = table != nullptr ? (size_t)pid * hkv + h
                                       : (size_t)bh * n_chunks + c;
    k_mult = sm_scale * k_scale[si];
    v_mult = v_scale[si];
  }

  // Scores: warp w scores rows [w*STEP, w*STEP + STEP), then
  // + kWarps*STEP, ...; instruction u of an iteration loads rows
  // j0 + u*RPI + [0, RPI).
  for (int j0 = warp * STEP; j0 < valid; j0 += kWarps * STEP) {
    float kr[kUnroll][EPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * RPI + sub;
      if (j < valid) tdt::load_vec<KT, EPL>(kc + (size_t)j * D, kr[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u * RPI >= valid) break;  // warp-uniform
      const int j = j0 + u * RPI + sub;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
        if (j < valid) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) s = fmaf(qr[g][e], kr[u][e], s);
        }
        s = group_sum<LPR>(s);
        if (lane % LPR == 0 && j < valid) p_s[g][j] = s * k_mult;
      }
    }
  }
  __syncthreads();
  // Chunk softmax statistics, one warp per query row.
  for (int g = warp; g < G; g += kWarps) {
    float mx = tdt::kNegInf;
    for (int j = lane; j < valid; j += 32) mx = fmaxf(mx, p_s[g][j]);
    mx = tdt::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < valid; j += 32) {
      const float p = expf(p_s[g][j] - mx);
      sum += p;
      if constexpr (kQuant)
        p_s[g][j] = p;
      else
        p_s[g][j] = tdt::round_to<KT>(p);
    }
    sum = tdt::warp_sum(sum);
    if (lane == 0) {
      mc_s[g] = mx;
      lc_s[g] = sum;
    }
  }
  __syncthreads();
  // This warp's share of P·V: each lane sums its columns over its rows,
  // then lanes holding the same columns (lane % LPR equal) are summed.
  float pv[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) pv[g][e] = 0.f;
  for (int j0 = warp * STEP; j0 < valid; j0 += kWarps * STEP) {
    float vr[kUnroll][EPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * RPI + sub;
      if (j < valid) tdt::load_vec<KT, EPL>(vc + (size_t)j * D, vr[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * RPI + sub;
      if (j >= valid) break;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = p_s[g][j];
#pragma unroll
        for (int e = 0; e < EPL; ++e) pv[g][e] = fmaf(p, vr[u][e], pv[g][e]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1)
        pv[g][e] += __shfl_xor_sync(0xffffffffu, pv[g][e], o);
    }
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < EPL; ++e) red_s[warp][g][col + e] = pv[g][e];
  }
  __syncthreads();
  const size_t part = (size_t)bh * n_chunks + c;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red_s[w][g][d];
    if constexpr (kQuant) s *= v_mult;
    o_part[part * G * D + i] = s / lc_s[g];
  }
  if (threadIdx.x < G)
    lse_part[part * G + threadIdx.x] =
        mc_s[threadIdx.x] + logf(lc_s[threadIdx.x]);
}

// lse_combine over the live chunk partials of one (b, kv head).
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const float* __restrict__ o_part,
                          const float* __restrict__ lse_part,
                          const int* __restrict__ kv_len, T* __restrict__ o,
                          float* __restrict__ lse, int hkv, int chunk,
                          int n_chunks) {
  __shared__ float m_s[G], den_s[G];
  const int bh = blockIdx.x;
  const int b = bh / hkv;
  const int n_live =
      min((max(kv_len[b], 0) + chunk - 1) / chunk, n_chunks);
  const float* lp = lse_part + (size_t)bh * n_chunks * G;
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float m = tdt::kNegInf;
    for (int c = 0; c < n_live; ++c) m = fmaxf(m, lp[c * G + g]);
    float den = 0.f;
    for (int c = 0; c < n_live; ++c) den += expf(lp[c * G + g] - m);
    m_s[g] = m;
    den_s[g] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  const float* op = o_part + (size_t)bh * n_chunks * G * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    float acc = 0.f;
    for (int c = 0; c < n_live; ++c)
      acc = fmaf(op[(size_t)c * G * D + i], expf(lp[c * G + g] - m_s[g]),
                 acc);
    o[(size_t)bh * G * D + i] = tdt::from_f32<T>(acc / den_s[g]);
  }
  if (lse != nullptr && threadIdx.x < G)
    lse[(size_t)bh * G + threadIdx.x] =
        m_s[threadIdx.x] + logf(den_s[threadIdx.x]);
}

// Launch operands (the partial buffers are the wrapper's scratch:
// [B*Hkv, n_chunks, G, D] and [B*Hkv, n_chunks, G] f32).
struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;  // null: full-width K/V; else [P, Hkv] through
  const float* v_scale;  // the table, or [B, Hkv, n_chunks] dense
  const int* table;  // null: dense cache
  const int* kv_len;
  void* o;
  float* lse;  // may be null
  float* o_part;
  float* lse_part;
  int b, hkv, chunk, n_chunks;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, typename KT, int D, int G>
void launch(const DecodeArgs& a) {
  decode_chunk_kernel<T, KT, D, G>
      <<<dim3(a.b * a.hkv, a.n_chunks), kThreads, 0, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const KT*>(a.k),
          static_cast<const KT*>(a.v), a.k_scale, a.v_scale, a.table,
          a.kv_len, a.o_part, a.lse_part, a.hkv, a.chunk, a.n_chunks,
          a.sm_scale);
  decode_combine_kernel<T, D, G><<<a.b * a.hkv, kThreads, 0, a.stream>>>(
      a.o_part, a.lse_part, a.kv_len, static_cast<T*>(a.o), a.lse, a.hkv,
      a.chunk, a.n_chunks);
}

template <typename T, typename KT, int D>
int dispatch_g(int group, const DecodeArgs& a) {
  switch (group) {
    case 2: launch<T, KT, D, 2>(a); return 0;
    case 4: launch<T, KT, D, 4>(a); return 0;
    case 8: launch<T, KT, D, 8>(a); return 0;
    default: return 1;
  }
}

template <typename T, typename KT>
int dispatch_d(int d, int group, const DecodeArgs& a) {
  switch (d) {
    case 32: return dispatch_g<T, KT, 32>(group, a);
    case 128: return dispatch_g<T, KT, 128>(group, a);
    default: return 1;
  }
}

// K/V of q's type, or int8 codes when the scales are given.
template <typename T>
int dispatch_kv(int d, int group, const DecodeArgs& a) {
  if (a.k_scale != nullptr) return dispatch_d<T, int8_t>(d, group, a);
  return dispatch_d<T, T>(d, group, a);
}

int run(const DecodeArgs& a, int group, int d, int dtype) {
  if (a.chunk < 1 || a.chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  int bad = 1;
  if (dtype == tdt::kDtypeF32)
    bad = dispatch_kv<float>(d, group, a);
  else if (dtype == tdt::kDtypeBF16)
    bad = dispatch_kv<__nv_bfloat16>(d, group, a);
  if (bad) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// Dense: q [B, Hkv*group, D], k/v [B, Hkv, n_chunks*chunk, D], kv_len [B]
// int32, o like q, lse [B, Hkv*group] f32 or null, the partial scratch
// as in DecodeArgs; all contiguous. Returns a cudaError_t (0 on success).
extern "C" int tdt_flash_decode(const void* q, const void* k, const void* v,
                                const int* kv_len, void* o, float* lse,
                                float* o_part, float* lse_part, int b,
                                int hkv, int group, int d, int chunk,
                                int n_chunks, float sm_scale, int dtype,
                                void* stream) {
  DecodeArgs a{q, k, v, nullptr, nullptr, nullptr, kv_len, o, lse, o_part,
               lse_part, b, hkv, chunk, n_chunks, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return run(a, group, d, dtype);
}

// Paged: k/v pools [P, Hkv, page, D], table [B, pages_per_seq] int32 (the
// chunk is the page, n_chunks the table width); the rest as above.
extern "C" int tdt_paged_flash_decode(const void* q, const void* k,
                                      const void* v, const int* table,
                                      const int* kv_len, void* o, float* lse,
                                      float* o_part, float* lse_part, int b,
                                      int hkv, int group, int d, int page,
                                      int pages_per_seq, float sm_scale,
                                      int dtype, void* stream) {
  DecodeArgs a{q, k, v, nullptr, nullptr, table, kv_len, o, lse, o_part,
               lse_part, b, hkv, page, pages_per_seq, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return run(a, group, d, dtype);
}

// Paged over an int8 pool: k/v int8 codes [P, Hkv, page, D], k_scale /
// v_scale [P, Hkv] f32 (non-null); q/o of `dtype`; the rest as above.
extern "C" int tdt_paged_flash_decode_int8(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, const int* table, const int* kv_len, void* o,
    float* lse, float* o_part, float* lse_part, int b, int hkv, int group,
    int d, int page, int pages_per_seq, float sm_scale, int dtype,
    void* stream) {
  if (k_scale == nullptr || v_scale == nullptr || table == nullptr)
    return (int)cudaErrorInvalidValue;
  DecodeArgs a{q, k, v, k_scale, v_scale, table, kv_len, o, lse, o_part,
               lse_part, b, hkv, page, pages_per_seq, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return run(a, group, d, dtype);
}

// Dense over int8 codes: k/v int8 codes [B, Hkv, n_chunks*chunk, D],
// k_scale/v_scale [B, Hkv, n_chunks] f32 (non-null), one per chunk of
// keys; q/o of `dtype`; the rest as tdt_flash_decode.
extern "C" int tdt_flash_decode_int8(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, const int* kv_len, void* o, float* lse,
    float* o_part, float* lse_part, int b, int hkv, int group, int d,
    int chunk, int n_chunks, float sm_scale, int dtype, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  DecodeArgs a{q, k, v, k_scale, v_scale, nullptr, kv_len, o, lse, o_part,
               lse_part, b, hkv, chunk, n_chunks, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return run(a, group, d, dtype);
}
