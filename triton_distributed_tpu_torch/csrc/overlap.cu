// Tensor-parallel GEMMs fused with their collective, for Hopper (sm_90a):
// one source, three entry points, over ranks co-located on one card.
//
// Replaces:
//   - triton_distributed_tpu/ops/overlap/gemm_ar.py
//     `_gemm_ar_one_shot_kernel` (`gemm_ar_kernel`): the row-parallel
//     o-proj / FC2 GEMM of a decode step (and of a chunk up to 512 KB of
//     output) whose partial products every rank needs summed;
//   - triton_distributed_tpu/ops/overlap/gemm_rs.py `_gemm_rs_kernel`
//     (`gemm_rs_kernel`): GEMM + ring reduce-scatter, the o-proj / FC2
//     of the sequence-sharded prefill and the first shot of gemm_ar's
//     TWO_SHOT;
//   - triton_distributed_tpu/ops/overlap/ag_gemm.py `_ag_gemm_kernel`
//     (`ag_gemm_kernel`): all-gather of the row-sharded activations
//     overlapped with their GEMM, the QKV / FC1 of that prefill.
//
// What each computes, as the TPU kernels do:
//   gemm_ar: rank r's partial A_r @ B_r (f32 accumulate) is rounded to
//     the input dtype and put into slot [r] of EVERY rank's workspace,
//     flagged per (source, tile); each rank then waits for its tile's n
//     flags and sums slots 0..n-1 IN RANK ORDER in f32, rounded once. All
//     ranks read the same rounded partials in the same order, so every
//     rank's output is bitwise the same.
//   gemm_rs: the ring. At step s rank me computes the partial of chunk
//     (me-1-s) mod n (rows below half_m: the clockwise ring) or
//     (me+1+s) mod n (rows from half_m on: the counter-clockwise ring of
//     the bidirectional variant), adds the sum that arrived from its ring
//     neighbour at step s-1, rounds to the wire dtype (the input dtype)
//     and forwards it; at step n-1 the chunk is its own and the rounded
//     sum is its output [M/n, N]. The accumulation order (and so the bf16
//     roundings) is the ring's, not rank order.
//   ag_gemm: every rank puts its [m_per, K] chunk to every peer's
//     workspace slot [me], flagged per row tile; at step s it computes
//     chunk (me + s) mod n (its own first, straight from its input)
//     against its B columns, waiting per row tile for the chunk's
//     arrival. Output rows are written at their global position, so the
//     result [n*m_per, n_loc] needs no un-permuting.
//
// The options of the TPU kernels, each its own instantiation (the builds
// without them are unchanged):
//   - ag_gemm's arrival-adaptive pick (`adaptive_pick`, ag_gemm.py:128):
//     kAdaptive. One realized order a rank: the first block of the rank to
//     finish step s claims the pick of step s+1 (a CAS on a per-(rank,
//     step) word, so a busy block 0 never stalls its peers), scans chunks
//     me+1 .. me+n-1 for the first unprocessed one whose row tiles have
//     all landed (acquire loads of their flags; none landed: the first
//     unprocessed one), writes it to the rank's int32 [n] order output
//     (the Pallas kernel's `order`, fresh each launch) and publishes it
//     with a release flag; every block acquires the flag and reads the
//     pick from the order before step s+1. The winner never waits
//     between claim and publish, so no block waits on a spinning one.
//     Rows still land at their global position: the output is bitwise
//     the ring-order build's, which writes its fixed order to the same
//     output.
//   - gemm_rs's wire dtype (`wire_dtype`, gemm_rs.py:61-75): the
//     workspace holds W; a hop adds its f32 partial to the f32 of the
//     inbound W sum and rounds to W, the last step rounds to T (JAX's
//     separate final buffer). e4m3 rounds to nearest even and gives NaN
//     past 464 (what ml_dtypes / jnp's cast gives: the TPU reference's
//     oracle), never a saturated 448. The wire is read and written in
//     4-element vectors (4 bytes at e4m3), so N % 8 == 0 keeps them
//     aligned. At n = 1 (`force_kernel`) step 0 is the final step: the
//     partial rounded once to T.
//   - gemm_ar's device trace ring (trace=True, gemm_ar.py:84-199):
//     kTrace. Iterations s = 0 .. num_j: produce column group s (tile_n
//     columns), a rank-local count of the rank's blocks, reduce group
//     s-1, a count, then at s == num_j the drain. After each count one
//     thread of the rank stamps the phase's record in the megakernel
//     tracer's format with JAX's logical ticks (one per begin, mid and
//     end), so the ring is bitwise the plain version's and passes
//     validate_ring; the outputs are bitwise the untraced build's.
//
// What bounds it on the H100: decode shapes (M = 4) are bytes: each rank
// streams its weight shard once (Qwen3-8B tp=2: 16.8 MB a rank for the
// o-proj, 50.3 MB for FC2) and co-located ranks share one HBM, so the
// bound is all ranks' bytes / 3.35 TB/s. Prefill shapes (M = 150..384)
// are operations: 2*M*N*K a rank against the tensor cores' 989 TFLOP/s.
//
// All three launch through the C entry `tdt_overlap_launch` (its `kind`
// picks the kernel; `tdt_overlap_capacity` gives the co-resident limit).
//
// Design (this slice: right and simple first): one cooperative launch
// covers all ranks; blockIdx.y is the rank and its blocks loop over
// (step, tile) items, so every block is resident (or the launch is
// refused) and no wait can depend on a block that was never scheduled:
// produce/put items never wait, and a wait depends only on an item of an
// earlier phase or step. The GEMM is a shared-memory tiled FMA kernel
// with f32 accumulation (f32 inputs stay exact: no TF32): 64-column
// tiles of BM = 16 rows for decode or 64 rows otherwise, 32-deep K
// slices staged through registers while the previous slice computes.
// wgmma and TMA come in a later slice; the times go into PERF.md.
#include <cuda_fp8.h>

#include <type_traits>

#include "tdt_common.cuh"
#include "tdt_comm.cuh"

namespace {

using tdt::RankPtrs;

constexpr int kThreads = 256;
constexpr int kBN = 64;
constexpr int kBK = 32;

template <int BM>
__host__ __device__ constexpr int smem_floats() {
  return 2 * kBK * BM + 2 * kBK * kBN;
}

// C_tile[BM, kBN] = A[rows, K] @ B[K, n0 : n0 + kBN] in f32. a_row(i)
// gives row i of the tile (nullptr: masked to zero); K and N are
// multiples of the 16-byte vector width. Thread (ty, tx) of the 16 x 16
// grid owns rows ty*TM .. +TM and columns tx*4 .. +4 of the tile.
template <typename T, int BM, typename ARow>
__device__ __forceinline__ void gemm_tile(ARow a_row,
                                          const T* __restrict__ B, int ldb,
                                          int n0, int N, int K,
                                          float (&acc)[BM / 16][4],
                                          float* smem) {
  constexpr int V = 16 / sizeof(T);
  constexpr int TM = BM / 16;
  constexpr int NA = BM * kBK / V;
  constexpr int NB = kBK * kBN / V;
  constexpr int RA = (NA + kThreads - 1) / kThreads;
  constexpr int RB = (NB + kThreads - 1) / kThreads;
  float* As = smem;                  // [2][kBK][BM]
  float* Bs = smem + 2 * kBK * BM;   // [2][kBK][kBN]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  uint4 ra[RA], rb[RB];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < RA; ++i) {
      const int v = tid + i * kThreads;
      ra[i] = make_uint4(0, 0, 0, 0);
      if (v < NA) {
        const int r = v / (kBK / V), kc = k0 + (v % (kBK / V)) * V;
        const T* row = a_row(r);
        if (row != nullptr && kc < K)
          ra[i] = __ldcg(reinterpret_cast<const uint4*>(row + kc));
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int v = tid + i * kThreads;
      rb[i] = make_uint4(0, 0, 0, 0);
      if (v < NB) {
        const int kr = k0 + v / (kBN / V), nc = n0 + (v % (kBN / V)) * V;
        if (kr < K && nc < N)
          rb[i] = __ldg(reinterpret_cast<const uint4*>(
              B + (size_t)kr * ldb + nc));
      }
    }
  };
  auto store = [&](int buf) {
    float* as = As + buf * kBK * BM;
    float* bs = Bs + buf * kBK * kBN;
#pragma unroll
    for (int i = 0; i < RA; ++i) {
      const int v = tid + i * kThreads;
      if (v < NA) {
        const int r = v / (kBK / V), kc = (v % (kBK / V)) * V;
        const T* e = reinterpret_cast<const T*>(&ra[i]);
#pragma unroll
        for (int j = 0; j < V; ++j) as[(kc + j) * BM + r] = tdt::to_f32(e[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int v = tid + i * kThreads;
      if (v < NB) {
        const int kr = v / (kBN / V), nc = (v % (kBN / V)) * V;
        const T* e = reinterpret_cast<const T*>(&rb[i]);
#pragma unroll
        for (int j = 0; j < V; ++j) bs[kr * kBN + nc + j] = tdt::to_f32(e[j]);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int nk = (K + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int buf = t & 1;
    if (t + 1 < nk) load((t + 1) * kBK);
    const float* as = As + buf * kBK * BM;
    const float* bs = Bs + buf * kBK * kBN;
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(bs + kk * kBN + tx * 4);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float a = as[kk * BM + ty * TM + i];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    if (t + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }
}

// Element conversions: the model dtypes through tdt_common.cuh; the e4m3
// wire of gemm_rs rounds to nearest even (the hardware's saturating
// convert) and gives NaN where the rounded value would pass +-448, i.e.
// |v| > 464 (the tie at 464 rounds down to 448), and for NaN.
using E4M3 = __nv_fp8_e4m3;
constexpr float kE4M3Overflow = 464.f;

template <typename T>
__device__ __forceinline__ float f32_of(T x) {
  return tdt::to_f32(x);
}
template <>
__device__ __forceinline__ float f32_of<E4M3>(E4M3 x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T of_f32(float v) {
  return tdt::from_f32<T>(v);
}
template <>
__device__ __forceinline__ E4M3 of_f32<E4M3>(float v) {
  E4M3 r;
  r.__x = fabsf(v) <= kE4M3Overflow
              ? __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3)
              : static_cast<__nv_fp8_storage_t>(0x7F);
  return r;
}

// Four consecutive elements of T at p (4-, 8- or 16-byte aligned),
// rounded to T.
template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4]) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (sizeof(T) == 2) {
    alignas(8) T e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) e[j] = of_f32<T>(v[j]);
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(e);
  } else {
    alignas(4) T e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) e[j] = of_f32<T>(v[j]);
    *reinterpret_cast<uint32_t*>(p) = *reinterpret_cast<const uint32_t*>(e);
  }
}

// Four consecutive elements of T at p as f32, read through L2 (a peer
// may have written them in this launch).
template <typename T>
__device__ __forceinline__ void load4_cg(const T* p, float (&v)[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else if constexpr (sizeof(T) == 2) {
    const uint2 raw = __ldcg(reinterpret_cast<const uint2*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = f32_of(e[j]);
  } else {
    const unsigned int raw = __ldcg(reinterpret_cast<const unsigned int*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = f32_of(e[j]);
  }
}

// A CAS claim of a per-launch word: true for the one caller that moves it
// from an earlier epoch to `epoch`.
__device__ __forceinline__ bool claim(uint64_t* w, uint64_t epoch) {
  unsigned long long old = tdt::ld_acquire_sys(w);
  while (old < epoch) {
    const unsigned long long prev = atomicCAS(
        reinterpret_cast<unsigned long long*>(w), old,
        static_cast<unsigned long long>(epoch));
    if (prev == old) return true;
    old = prev;
  }
  return false;
}

// The rank-local count of the traced gemm_ar: every one of the rank's G
// blocks arrives (its writes fenced), the last one resets the arrival word
// and moves the generation on; the others spin until it has. All G blocks
// are co-resident (cooperative launch), so the count always completes.
__device__ __forceinline__ void rank_count(uint64_t* arrive, uint64_t* gen,
                                           int G) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const uint64_t g = tdt::ld_acquire_sys(gen);
    if (atomicAdd(reinterpret_cast<unsigned long long*>(arrive), 1ull) ==
        static_cast<unsigned long long>(G - 1)) {
      atomicExch(reinterpret_cast<unsigned long long*>(arrive), 0ull);
      tdt::signal(gen, g + 1);
    } else {
      tdt::wait_until(gen, g + 1);
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// gemm_ar one-shot. Flags of rank r: [0, n) the entry barrier, then
// n + src * tiles + t (kTrace: n the rank-local count's arrivals, n + 1
// its generation, tile flags from n + 2). Workspace of rank r: [n, M, N]
// (slot src). kTrace also takes the per-rank rings RING ([num_j+1, 3, 8]
// int32 each, zeroed by the host) and tile_n (a multiple of kBN dividing
// N).
template <typename T, int BM>
__device__ __forceinline__ void ar_produce(const T* a, const T* b, int M,
                                           int N, int K, int n, int me,
                                           int tiles, int t, int tiles_n,
                                           const int64_t* ws_tab,
                                           const int64_t* fl_tab, int fl0,
                                           uint64_t epoch, float* smem) {
  constexpr int TM = BM / 16;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t slot = (size_t)M * N;
  const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * kBN;
  float acc[TM][4];
  gemm_tile<T, BM>(
      [&](int i) -> const T* {
        return m0 + i < M ? a + (size_t)(m0 + i) * K : nullptr;
      },
      b, N, n0, N, K, acc, smem);
  const int col = n0 + tx * 4;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    if (row >= M || col >= N) continue;
    for (int p = 0; p < n; ++p) {
      T* ws = tdt::symm_ptr<T>(ws_tab, p) + me * slot;
      store4(ws + (size_t)row * N + col, acc[i]);
    }
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence_system();
    for (int p = 0; p < n; ++p)
      tdt::st_release_sys(
          tdt::symm_ptr<uint64_t>(fl_tab, p) + fl0 + me * tiles + t, epoch);
  }
}

template <typename T, int BM>
__device__ __forceinline__ void ar_reduce(T* o, int M, int N, int n,
                                          int me, int tiles, int t,
                                          int tiles_n, const int64_t* ws_tab,
                                          const int64_t* fl_tab, int fl0,
                                          uint64_t epoch) {
  const int tid = threadIdx.x;
  const size_t slot = (size_t)M * N;
  const T* ws = tdt::symm_ptr<const T>(ws_tab, me);
  const uint64_t* fl = tdt::symm_ptr<const uint64_t>(fl_tab, me);
  const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * kBN;
  if (tid == 0)
    for (int src = 0; src < n; ++src)
      tdt::wait_until(fl + fl0 + src * tiles + t, epoch);
  __syncthreads();
  for (int e = tid; e < BM * (kBN / 4); e += kThreads) {
    const int row = m0 + e / (kBN / 4), col = n0 + (e % (kBN / 4)) * 4;
    if (row >= M || col >= N) continue;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int src = 0; src < n; ++src) {
      float v[4];
      load4_cg(ws + src * slot + (size_t)row * N + col, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) sum[j] += v[j];
    }
    store4(o + (size_t)row * N + col, sum);
  }
}

// One ring record [task_id, opcode, layer, slot, begin, end, mid, flag].
__device__ __forceinline__ void ring_record(int32_t* ring, int s, int phase,
                                            int opcode, int slot, int begin,
                                            int end, int mid) {
  int32_t* r = ring + (s * 3 + phase) * 8;
  r[0] = s;
  r[1] = opcode;
  r[2] = 0;
  r[3] = slot;
  r[4] = begin;
  r[5] = end;
  r[6] = mid;
  r[7] = 1;
}

template <typename T, int BM, bool kTrace>
__global__ void __launch_bounds__(kThreads)
gemm_ar_kernel(RankPtrs A, RankPtrs B, RankPtrs O, const int64_t* ws_tab,
               const int64_t* fl_tab, int M, int N, int K, int n,
               uint64_t epoch, RankPtrs RING, int tile_n) {
  __shared__ __align__(16) float smem[smem_floats<BM>()];
  const int me = blockIdx.y, G = gridDim.x;
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + kBN - 1) / kBN;
  const int tiles = tiles_m * tiles_n;
  const T* a = tdt::rank_ptr<const T>(A, me);
  const T* b = tdt::rank_ptr<const T>(B, me);
  T* o = tdt::rank_ptr<T>(O, me);

  tdt::barrier_all(fl_tab, me, n, epoch, blockIdx.x == 0);

  if constexpr (!kTrace) {
    // Produce: partial tile -> input dtype -> every rank's slot [me].
    for (int t = blockIdx.x; t < tiles; t += G)
      ar_produce<T, BM>(a, b, M, N, K, n, me, tiles, t, tiles_n, ws_tab,
                        fl_tab, n, epoch, smem);
    // Reduce: wait the tile's n partials, sum slots 0..n-1 in rank order.
    for (int t = blockIdx.x; t < tiles; t += G)
      ar_reduce<T, BM>(o, M, N, n, me, tiles, t, tiles_n, ws_tab, fl_tab,
                       n, epoch);
  } else {
    // JAX's grid (num_j + 1,): iteration s produces column group s and
    // reduces group s - 1; a group is tiles_m x (tile_n / kBN) tiles.
    uint64_t* mine = tdt::symm_ptr<uint64_t>(fl_tab, me);
    int32_t* ring = tdt::rank_ptr<int32_t>(RING, me);
    const bool stamp = blockIdx.x == 0 && threadIdx.x == 0;
    const int per = tile_n / kBN, num_j = N / tile_n, gtiles = tiles_m * per;
    const int fl0 = n + 2;
    auto tile_of = [&](int j, int g) {
      return (g / per) * tiles_n + j * per + g % per;
    };
    int clk = 0;  // JAX's logical clock: one tick a begin, mid and end
    for (int s = 0; s <= num_j; ++s) {
      if (s < num_j) {
        for (int g = blockIdx.x; g < gtiles; g += G)
          ar_produce<T, BM>(a, b, M, N, K, n, me, tiles, tile_of(s, g),
                            tiles_n, ws_tab, fl_tab, fl0, epoch, smem);
        rank_count(mine + n, mine + n + 1, G);
        if (stamp) {  // TaskType.AR_SEND: the puts of group s are out
          ring_record(ring, s, 0, 12, s, clk + 1, clk + 3, clk + 2);
          clk += 3;
        }
      }
      if (s > 0) {
        for (int g = blockIdx.x; g < gtiles; g += G)
          ar_reduce<T, BM>(o, M, N, n, me, tiles, tile_of(s - 1, g),
                           tiles_n, ws_tab, fl_tab, fl0, epoch);
        rank_count(mine + n, mine + n + 1, G);
        if (stamp) {  // TaskType.AR_WAIT: mid once the partials landed
          ring_record(ring, s, 1, 13, s - 1, clk + 1, clk + 3, clk + 2);
          clk += 3;
        }
      }
      if (s == num_j && stamp) {  // TaskType.BARRIER: the drain (the puts
        // are stores flagged as they were made: nothing is in flight)
        ring_record(ring, s, 2, 9, 0, clk + 1, clk + 2, 0);
        clk += 2;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// gemm_rs ring. M is the full row count (n chunks of m_per rows); rows
// [0, half_m) of a chunk ride the clockwise ring, the rest the
// counter-clockwise one. Flags of rank r: [0, n) the barrier, then
// n + ((dir * (n-1) + step) * tiles + t). Workspace of rank r:
// [n-1, m_per, N] of the wire type W (slot = the step that forwarded into
// it). At n = 1 step 0 is the last step and nothing is exchanged.
template <typename T, typename W, int BM>
__global__ void __launch_bounds__(kThreads)
gemm_rs_kernel(RankPtrs A, RankPtrs B, RankPtrs O, const int64_t* ws_tab,
               const int64_t* fl_tab, int M, int N, int K, int n, int half_m,
               uint64_t epoch) {
  __shared__ __align__(16) float smem[smem_floats<BM>()];
  constexpr int TM = BM / 16;
  const int me = blockIdx.y, G = gridDim.x;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m_per = M / n;
  const int tiles_m = (m_per + BM - 1) / BM, tiles_n = (N + kBN - 1) / kBN;
  const int tiles = tiles_m * tiles_n;
  const int right = (me + 1) % n, left = (me + n - 1) % n;
  const T* a = tdt::rank_ptr<const T>(A, me);
  const T* b = tdt::rank_ptr<const T>(B, me);
  T* o = tdt::rank_ptr<T>(O, me);
  const size_t slot = (size_t)m_per * N;
  const W* ws_in = tdt::symm_ptr<const W>(ws_tab, me);
  const uint64_t* fl = tdt::symm_ptr<const uint64_t>(fl_tab, me);
  auto flag_at = [&](int dir, int step, int t) {
    return n + ((dir * (n - 1) + step) * tiles + t);
  };

  tdt::barrier_all(fl_tab, me, n, epoch, blockIdx.x == 0);

  for (int s = 0; s < n; ++s) {
    const int c_cw = ((me - 1 - s) % n + 2 * n) % n;
    const int c_ccw = (me + 1 + s) % n;
    for (int t = blockIdx.x; t < tiles; t += G) {
      const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * kBN;
      const int m1 = min(m0 + BM, m_per);
      const bool has_cw = m0 < half_m, has_ccw = m1 > half_m;
      if (s > 0 && tid == 0) {
        if (has_cw) tdt::wait_until(fl + flag_at(0, s - 1, t), epoch);
        if (has_ccw) tdt::wait_until(fl + flag_at(1, s - 1, t), epoch);
      }
      __syncthreads();
      float acc[TM][4];
      gemm_tile<T, BM>(
          [&](int i) -> const T* {
            const int r = m0 + i;
            if (r >= m_per) return nullptr;
            const int c = r < half_m ? c_cw : c_ccw;
            return a + ((size_t)c * m_per + r) * K;
          },
          b, N, n0, N, K, acc, smem);
      const int col = n0 + tx * 4;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = m0 + ty * TM + i;
        if (row >= m_per || col >= N) continue;
        float v[4] = {acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
        if (s > 0) {
          float inb[4];
          load4_cg(ws_in + (size_t)(s - 1) * slot + (size_t)row * N + col,
                   inb);
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] += inb[j];
        }
        if (s == n - 1) {
          store4(o + (size_t)row * N + col, v);
        } else {
          const int dst = row < half_m ? right : left;
          W* ws = tdt::symm_ptr<W>(ws_tab, dst) + (size_t)s * slot;
          store4(ws + (size_t)row * N + col, v);
        }
      }
      if (s < n - 1) {
        __syncthreads();
        if (tid == 0) {
          __threadfence_system();
          if (has_cw)
            tdt::st_release_sys(
                tdt::symm_ptr<uint64_t>(fl_tab, right) + flag_at(0, s, t),
                epoch);
          if (has_ccw)
            tdt::st_release_sys(
                tdt::symm_ptr<uint64_t>(fl_tab, left) + flag_at(1, s, t),
                epoch);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// ag_gemm. A_r [m_per, K]; B_r [K, N]; O_r [n*m_per, N]. Flags of rank
// r: [0, n) the barrier, then n + src * tiles_m + row tile; kAdaptive
// adds, from base = n + n * tiles_m, the claim word of step s at base + s
// and its publish flag at base + n + s. The flags hold nothing but epochs:
// a site's layout moves with m_per and its flags are never reset, so any
// other value left in a slot could pass a later launch's wait. Workspace
// of rank r: [n, m_per, K] (slot = the source rank). ORD: the per-rank
// int32 [n] realized order, fresh each launch (the ring build writes its
// fixed order there too); the adaptive pick of step s is read from it
// once its publish flag is acquired. The lag fixtures: rank lag_rank
// spins lag_ns, every rank delay_ns, after the entry barrier and before
// its puts.

// The block copies `bytes` (a multiple of 16, both sides 16-byte aligned)
// from src to the same offset of every peer's slot: kPutUnroll 16-byte
// vectors a thread in flight, each stored to every peer, so one read of
// the chunk feeds all n - 1 puts.
constexpr int kPutUnroll = 8;
template <typename T>
__device__ __forceinline__ void put_to_peers(const T* src,
                                             const int64_t* ws_tab,
                                             size_t dst_off, int me, int n,
                                             size_t bytes) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  const size_t nv = bytes / 16;
  const size_t step = (size_t)blockDim.x * kPutUnroll;
  for (size_t i0 = 0; i0 < nv; i0 += step) {
    uint4 r[kPutUnroll];
#pragma unroll
    for (int u = 0; u < kPutUnroll; ++u) {
      const size_t i = i0 + u * blockDim.x + threadIdx.x;
      if (i < nv) r[u] = __ldcg(s + i);
    }
    for (int p = 1; p < n; ++p) {
      uint4* d = reinterpret_cast<uint4*>(
          tdt::symm_ptr<T>(ws_tab, (me + p) % n) + dst_off);
#pragma unroll
      for (int u = 0; u < kPutUnroll; ++u) {
        const size_t i = i0 + u * blockDim.x + threadIdx.x;
        if (i < nv) d[i] = r[u];
      }
    }
  }
}

template <typename T, int BM, bool kAdaptive>
__device__ __forceinline__ void ag_gemm_body(
    RankPtrs A, RankPtrs B, RankPtrs O, const int64_t* ws_tab,
    const int64_t* fl_tab, int m_per, int N, int K, int n, uint64_t epoch,
    RankPtrs ORD, int lag_rank, long long lag_ns, long long delay_ns) {
  __shared__ __align__(16) float smem[smem_floats<BM>()];
  __shared__ int picked;
  constexpr int TM = BM / 16;
  const int me = blockIdx.y, G = gridDim.x;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int tiles_m = (m_per + BM - 1) / BM, tiles_n = (N + kBN - 1) / kBN;
  const int tiles = tiles_m * tiles_n;
  const T* a = tdt::rank_ptr<const T>(A, me);
  const T* b = tdt::rank_ptr<const T>(B, me);
  T* o = tdt::rank_ptr<T>(O, me);
  const size_t slot = (size_t)m_per * K;
  const T* ws_in = tdt::symm_ptr<const T>(ws_tab, me);
  uint64_t* fl = tdt::symm_ptr<uint64_t>(fl_tab, me);
  const int base = n + n * tiles_m;

  tdt::barrier_all(fl_tab, me, n, epoch, blockIdx.x == 0);
  if (me == lag_rank) tdt::spin_ns(lag_ns);
  tdt::spin_ns(delay_ns);

  // Put the own chunk, one row tile at a time, to every peer's slot [me].
  for (int ti = blockIdx.x; ti < tiles_m; ti += G) {
    const int r0 = ti * BM, rows = min(BM, m_per - r0);
    put_to_peers(a + (size_t)r0 * K, ws_tab, me * slot + (size_t)r0 * K, me,
                 n, (size_t)rows * K * sizeof(T));
    __syncthreads();
    if (tid == 0) {
      __threadfence_system();
      for (int p = 1; p < n; ++p)
        tdt::st_release_sys(tdt::symm_ptr<uint64_t>(fl_tab, (me + p) % n) +
                                n + me * tiles_m + ti,
                            epoch);
    }
  }

  // Compute chunk order[s] at step s, own chunk first: (me + s) mod n, or
  // (kAdaptive) the rank's realized order.
  int* ord = tdt::rank_ptr<int>(ORD, me);
  unsigned done = 0;
  for (int s = 0; s < n; ++s) {
    int c = (me + s) % n;
    if (kAdaptive && s > 0) {
      if (tid == 0) {
        tdt::wait_until(fl + base + n + s, epoch);
        picked = __ldcg(ord + s);
      }
      __syncthreads();
      c = picked;
      __syncthreads();
    } else if (blockIdx.x == 0 && tid == 0) {
      ord[s] = c;  // the ring build's order, and step 0 of the adaptive one
    }
    done |= 1u << c;
    const T* src = c == me ? a : ws_in + c * slot;
    for (int t = blockIdx.x; t < tiles; t += G) {
      const int ti = t / tiles_n, m0 = ti * BM, n0 = (t % tiles_n) * kBN;
      if (c != me && tid == 0)
        tdt::wait_until(fl + n + c * tiles_m + ti, epoch);
      __syncthreads();
      float acc[TM][4];
      gemm_tile<T, BM>(
          [&](int i) -> const T* {
            return m0 + i < m_per ? src + (size_t)(m0 + i) * K : nullptr;
          },
          b, N, n0, N, K, acc, smem);
      const int col = n0 + tx * 4;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = m0 + ty * TM + i;
        if (row >= m_per || col >= N) continue;
        store4(o + ((size_t)c * m_per + row) * N + col, acc[i]);
      }
    }
    // The rank's first block to finish step s picks step s + 1's chunk:
    // the first unprocessed one in me+1 .. me+n-1 whose row tiles have all
    // landed, else the first unprocessed one. Never waits.
    if (kAdaptive && s + 1 < n && tid == 0 &&
        claim(fl + base + s + 1, epoch)) {
      int ready = -1, any = -1;
      for (int off = 1; off < n; ++off) {
        const int cc = (me + off) % n;
        if (done & (1u << cc)) continue;
        if (any < 0) any = cc;
        if (ready >= 0) continue;
        bool landed = true;
        for (int ti = 0; ti < tiles_m && landed; ++ti)
          landed = tdt::ld_acquire_sys(fl + n + cc * tiles_m + ti) >= epoch;
        if (landed) ready = cc;
      }
      ord[s + 1] = ready >= 0 ? ready : any;
      tdt::signal(fl + base + n + s + 1, epoch);
    }
  }
}

// Both builds ask for 3 blocks an SM in bf16 (2 in f32): ptxas otherwise
// gave the bf16 tile 80 to 113 registers from one small edit to the next
// (2 or 3 blocks an SM), and a third fewer blocks made the QKV launch ~30%
// slower (1.1475 ms against 0.8670, H100 80GB HBM3 at 700 W).
template <typename T, int BM, bool kAdaptive>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 3 : 2)
ag_gemm_kernel(RankPtrs A, RankPtrs B, RankPtrs O, const int64_t* ws_tab,
               const int64_t* fl_tab, int m_per, int N, int K, int n,
               uint64_t epoch, RankPtrs ORD, int lag_rank, long long lag_ns,
               long long delay_ns) {
  ag_gemm_body<T, BM, kAdaptive>(A, B, O, ws_tab, fl_tab, m_per, N, K, n,
                                 epoch, ORD, lag_rank, lag_ns, delay_ns);
}

// Kernel kinds of tdt_overlap_launch, and the wire codes of gemm_rs.
enum Kind {
  kGemmAR = 0,
  kGemmRS = 1,
  kAGGemm = 2,
  kAGGemmAdaptive = 3,
  kGemmARTraced = 4
};
enum Wire { kWireF32 = 0, kWireBF16 = 1, kWireE4M3 = 2 };

template <typename T, int BM>
void* rs_kernel_of(int wire) {
  if (wire == kWireE4M3)
    return reinterpret_cast<void*>(&gemm_rs_kernel<T, E4M3, BM>);
  if (wire == kWireBF16)
    return reinterpret_cast<void*>(&gemm_rs_kernel<T, __nv_bfloat16, BM>);
  if constexpr (std::is_same<T, float>::value) {
    if (wire == kWireF32)
      return reinterpret_cast<void*>(&gemm_rs_kernel<float, float, BM>);
  }
  return nullptr;  // no such wire, or one wider than a bf16 input
}

template <typename T, int BM>
void* kernel_of(int kind, int wire) {
  switch (kind) {
    case kGemmAR:
      return reinterpret_cast<void*>(&gemm_ar_kernel<T, BM, false>);
    case kGemmARTraced:
      return reinterpret_cast<void*>(&gemm_ar_kernel<T, BM, true>);
    case kGemmRS: return rs_kernel_of<T, BM>(wire);
    case kAGGemm:
      return reinterpret_cast<void*>(&ag_gemm_kernel<T, BM, false>);
    case kAGGemmAdaptive:
      return reinterpret_cast<void*>(&ag_gemm_kernel<T, BM, true>);
    default: return nullptr;
  }
}

void* pick_kernel(int kind, int dtype, int small_m, int wire) {
  if (dtype == tdt::kDtypeF32)
    return small_m ? kernel_of<float, 16>(kind, wire)
                   : kernel_of<float, 64>(kind, wire);
  if (dtype != tdt::kDtypeBF16) return nullptr;
  return small_m ? kernel_of<__nv_bfloat16, 16>(kind, wire)
                 : kernel_of<__nv_bfloat16, 64>(kind, wire);
}

}  // namespace

extern "C" {

// Blocks of `kind`'s kernel (gemm_rs: of that wire) that can be
// co-resident on the device; 0 for a combination that has no kernel.
int tdt_overlap_capacity(int kind, int dtype, int small_m, int wire) {
  void* fn = pick_kernel(kind, dtype, small_m, wire);
  return fn == nullptr ? 0 : tdt::capacity(fn, kThreads);
}

// One cooperative launch of `kind` over n co-located ranks with
// blocks_per_rank blocks each (grid (blocks_per_rank, n)). dims: M, N, K,
// and for gemm_rs half_m (for ag_gemm M is m_per). `wire`: gemm_rs's wire
// code. `aux`: host table of the per-rank int32 outputs (ag_gemm's
// realized order, the traced gemm_ar's ring), or null. `arg`: the traced
// gemm_ar's tile_n. lag_rank / lag_ns / delay_ns: ag_gemm's lag fixtures
// (-1, 0, 0: none). Returns the CUDA error; a grid that cannot be
// co-resident is refused with cudaErrorCooperativeLaunchTooLarge before
// launching.
int tdt_overlap_launch(int kind, int dtype, int small_m, int wire,
                       const int64_t* a, const int64_t* b, const int64_t* o,
                       const int64_t* aux, const int64_t* ws_tab,
                       const int64_t* fl_tab, int n, int M, int N, int K,
                       int half_m, int arg, unsigned long long epoch,
                       int lag_rank, long long lag_ns, long long delay_ns,
                       int blocks_per_rank, void* stream) {
  if (n < 1 || n > tdt::kMaxRanks || blocks_per_rank < 1)
    return cudaErrorInvalidValue;
  void* fn = pick_kernel(kind, dtype, small_m, wire);
  if (fn == nullptr) return cudaErrorInvalidValue;
  if (kind == kGemmARTraced &&
      (arg < kBN || arg % kBN != 0 || N % arg != 0 || aux == nullptr))
    return cudaErrorInvalidValue;
  if ((kind == kAGGemm || kind == kAGGemmAdaptive) && aux == nullptr)
    return cudaErrorInvalidValue;
  if (n * blocks_per_rank > tdt::capacity(fn, kThreads))
    return cudaErrorCooperativeLaunchTooLarge;
  RankPtrs pa = tdt::to_ptrs(a, n), pb = tdt::to_ptrs(b, n),
           po = tdt::to_ptrs(o, n);
  RankPtrs px = aux == nullptr ? RankPtrs{} : tdt::to_ptrs(aux, n);
  uint64_t ep = epoch;
  void* args_ar[] = {&pa, &pb, &po, &ws_tab, &fl_tab, &M,
                     &N,  &K,  &n,  &ep,     &px,     &arg};
  void* args_rs[] = {&pa, &pb, &po, &ws_tab, &fl_tab, &M,
                     &N,  &K,  &n,  &half_m, &ep};
  void* args_ag[] = {&pa, &pb,  &po, &ws_tab,   &fl_tab, &M,     &N,
                     &K,  &n,   &ep, &px,       &lag_rank, &lag_ns,
                     &delay_ns};
  void** args = kind == kGemmRS                 ? args_rs
                : kind == kGemmAR || kind == kGemmARTraced ? args_ar
                                                           : args_ag;
  cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(blocks_per_rank, n), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
