// Single-token GQA decode attention for Hopper (sm_90a): one source, two
// entry points.
//
// Replaces:
//   - triton_distributed_tpu/ops/attention/flash_decode.py
//     `_paged_decode_kernel` (entry `paged_flash_decode`): decode straight
//     over the paged KV pool through the page table (the
//     ContinuousEngine / Engine(paged=True) decode step);
//   - `_decode_kernel` (entry `flash_decode`): the same split-KV decode
//     over a dense [B, Hkv, S, D] cache in chunk_k chunks
//     (Engine(paged=False)).
// Both share the TPU body `_decode_body`; here they share one kernel pair,
// told apart by the page table pointer (null = dense).
//
// What it computes: for sequence b and kv head h, the `group` query rows
// of that head against the first kv_len[b] cached positions, exactly as
// the TPU kernels do: one (O, LSE) partial per chunk (page) — chunk max
// m_c, p = exp(s - m_c) rounded to V's dtype before P·V, l_c summed from
// unrounded p, O_c = P·V / l_c, LSE_c = m_c + log(l_c) — then the
// log-sum-exp merge of `lse_combine`. Chunks at or past
// ceil(kv_len / chunk) are never read (their partials have weight 0 in
// lse_combine), so a kv_len of 0 reads nothing and yields O = 0,
// LSE = -1e30, and unused table entries (the trash page 0) are never
// dereferenced.
//
// What bounds it on the H100: bytes. Each step reads every cached K and
// V row once (kv_len * head_dim * 2 * dtype bytes per (b, kv head)) and
// does ~4 * group FLOPs per byte pair, far below the card's ~295
// FLOP/byte balance point, so the bound is kv bytes / 3.35 TB/s.
//
// Design: the TPU grid (b, kv head, chunk) becomes the CUDA grid, so a
// batch-4 step at a 2k context runs hundreds of blocks instead of one per
// (b, kv head); a second small kernel merges the chunk partials. Inside a
// block, 8 warps own whole keys: each warp issues the vector loads of 4
// K (then V) rows before using any of them (one coalesced 8- or 16-byte
// load per lane per row), which keeps enough bytes in flight to approach
// the HBM rate; only the chunk's scores go through shared memory, and
// the group's query rows stay in registers.
#include "tdt_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // rows whose loads a warp issues together
constexpr int kMaxChunk = 256;

// One (b, kv head, chunk) block: the chunk's partial O [G, D] (already
// divided by l_c) and LSE [G], f32, into the partial buffers.
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
    decode_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ table,
                        const int* __restrict__ kv_len,
                        float* __restrict__ o_part,
                        float* __restrict__ lse_part, int hkv, int chunk,
                        int n_chunks, float sm_scale) {
  constexpr int EPL = D / 32;  // contiguous columns per lane
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

  for (int i = threadIdx.x; i < G * D; i += kThreads)
    q_s[i / D][i % D] = tdt::to_f32(q[(size_t)bh * G * D + i]);
  __syncthreads();
  float qr[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[g][e] = q_s[g][lane * EPL + e];

  // Dense: row (b*hkv + h) * S + c * chunk with S = n_chunks * chunk.
  // Paged: row (table[b, c] * hkv + h) * page.
  const size_t row0 =
      table != nullptr
          ? ((size_t)table[(size_t)b * n_chunks + c] * hkv + h) * chunk
          : ((size_t)bh * n_chunks + c) * chunk;
  const T* kc = k + row0 * D + lane * EPL;
  const T* vc = v + row0 * D + lane * EPL;

  // Scores: warp w scores keys [w*U, w*U + U), then + kWarps*U, ...
  for (int j0 = warp * kUnroll; j0 < valid; j0 += kWarps * kUnroll) {
    float kr[kUnroll][EPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j0 + u < valid)
        tdt::load_vec<T, EPL>(kc + (size_t)(j0 + u) * D, kr[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u >= valid) break;  // warp-uniform
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) s = fmaf(qr[g][e], kr[u][e], s);
        s = tdt::warp_sum(s);
        if (lane == 0) p_s[g][j0 + u] = s * sm_scale;
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
      p_s[g][j] = tdt::round_to<T>(p);
    }
    sum = tdt::warp_sum(sum);
    if (lane == 0) {
      mc_s[g] = mx;
      lc_s[g] = sum;
    }
  }
  __syncthreads();
  // This warp's share of P·V.
  float pv[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) pv[g][e] = 0.f;
  for (int j0 = warp * kUnroll; j0 < valid; j0 += kWarps * kUnroll) {
    float vr[kUnroll][EPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j0 + u < valid)
        tdt::load_vec<T, EPL>(vc + (size_t)(j0 + u) * D, vr[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u >= valid) break;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = p_s[g][j0 + u];
#pragma unroll
        for (int e = 0; e < EPL; ++e) pv[g][e] = fmaf(p, vr[u][e], pv[g][e]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) red_s[warp][g][lane * EPL + e] = pv[g][e];
  __syncthreads();
  const size_t part = (size_t)bh * n_chunks + c;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red_s[w][g][d];
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

template <typename T, int D, int G>
void launch(const DecodeArgs& a) {
  decode_chunk_kernel<T, D, G>
      <<<dim3(a.b * a.hkv, a.n_chunks), kThreads, 0, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), a.table, a.kv_len, a.o_part,
          a.lse_part, a.hkv, a.chunk, a.n_chunks, a.sm_scale);
  decode_combine_kernel<T, D, G><<<a.b * a.hkv, kThreads, 0, a.stream>>>(
      a.o_part, a.lse_part, a.kv_len, static_cast<T*>(a.o), a.lse, a.hkv,
      a.chunk, a.n_chunks);
}

template <typename T, int D>
int dispatch_g(int group, const DecodeArgs& a) {
  switch (group) {
    case 2: launch<T, D, 2>(a); return 0;
    case 4: launch<T, D, 4>(a); return 0;
    case 8: launch<T, D, 8>(a); return 0;
    default: return 1;
  }
}

template <typename T>
int dispatch_d(int d, int group, const DecodeArgs& a) {
  switch (d) {
    case 32: return dispatch_g<T, 32>(group, a);
    case 128: return dispatch_g<T, 128>(group, a);
    default: return 1;
  }
}

int run(const DecodeArgs& a, int group, int d, int dtype) {
  if (a.chunk < 1 || a.chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  int bad = 1;
  if (dtype == tdt::kDtypeF32)
    bad = dispatch_d<float>(d, group, a);
  else if (dtype == tdt::kDtypeBF16)
    bad = dispatch_d<__nv_bfloat16>(d, group, a);
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
  DecodeArgs a{q, k, v, nullptr, kv_len, o, lse, o_part, lse_part,
               b, hkv, chunk, n_chunks, sm_scale,
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
  DecodeArgs a{q, k, v, table, kv_len, o, lse, o_part, lse_part,
               b, hkv, page, pages_per_seq, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return run(a, group, d, dtype);
}
