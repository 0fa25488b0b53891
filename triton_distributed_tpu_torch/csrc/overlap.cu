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

// Four consecutive elements of T at p (8- or 16-byte aligned), rounded
// to T.
template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4]) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    alignas(8) T e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) e[j] = tdt::from_f32<T>(v[j]);
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(e);
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
  } else {
    const uint2 raw = __ldcg(reinterpret_cast<const uint2*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = tdt::to_f32(e[j]);
  }
}

// ---------------------------------------------------------------------------
// gemm_ar one-shot. Flags of rank r: [0, n) the entry barrier, then
// n + src * tiles + t. Workspace of rank r: [n, M, N] (slot src).
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
gemm_ar_kernel(RankPtrs A, RankPtrs B, RankPtrs O, const int64_t* ws_tab,
               const int64_t* fl_tab, int M, int N, int K, int n,
               uint64_t epoch) {
  __shared__ __align__(16) float smem[smem_floats<BM>()];
  constexpr int TM = BM / 16;
  const int me = blockIdx.y, G = gridDim.x;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + kBN - 1) / kBN;
  const int tiles = tiles_m * tiles_n;
  const T* a = tdt::rank_ptr<const T>(A, me);
  const T* b = tdt::rank_ptr<const T>(B, me);
  T* o = tdt::rank_ptr<T>(O, me);
  const size_t slot = (size_t)M * N;

  tdt::barrier_all(fl_tab, me, n, epoch, blockIdx.x == 0);

  // Produce: partial tile -> input dtype -> every rank's slot [me].
  for (int t = blockIdx.x; t < tiles; t += G) {
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
            tdt::symm_ptr<uint64_t>(fl_tab, p) + n + me * tiles + t, epoch);
    }
  }

  // Reduce: wait the tile's n partials, sum slots 0..n-1 in rank order.
  const T* ws = tdt::symm_ptr<const T>(ws_tab, me);
  const uint64_t* fl = tdt::symm_ptr<const uint64_t>(fl_tab, me);
  for (int t = blockIdx.x; t < tiles; t += G) {
    const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * kBN;
    if (tid == 0)
      for (int src = 0; src < n; ++src)
        tdt::wait_until(fl + n + src * tiles + t, epoch);
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
}

// ---------------------------------------------------------------------------
// gemm_rs ring. M is the full row count (n chunks of m_per rows); rows
// [0, half_m) of a chunk ride the clockwise ring, the rest the
// counter-clockwise one. Flags of rank r: [0, n) the barrier, then
// n + ((dir * (n-1) + step) * tiles + t). Workspace of rank r:
// [n-1, m_per, N] (slot = the step that forwarded into it).
template <typename T, int BM>
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
  const T* ws_in = tdt::symm_ptr<const T>(ws_tab, me);
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
          T* ws = tdt::symm_ptr<T>(ws_tab, dst) + (size_t)s * slot;
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
// r: [0, n) the barrier, then n + src * tiles_m + row tile. Workspace of
// rank r: [n, m_per, K] (slot = the source rank).
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
ag_gemm_kernel(RankPtrs A, RankPtrs B, RankPtrs O, const int64_t* ws_tab,
               const int64_t* fl_tab, int m_per, int N, int K, int n,
               uint64_t epoch) {
  __shared__ __align__(16) float smem[smem_floats<BM>()];
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
  const uint64_t* fl = tdt::symm_ptr<const uint64_t>(fl_tab, me);

  tdt::barrier_all(fl_tab, me, n, epoch, blockIdx.x == 0);

  // Put the own chunk, one row tile at a time, to every peer's slot [me].
  for (int ti = blockIdx.x; ti < tiles_m; ti += G) {
    const int r0 = ti * BM, rows = min(BM, m_per - r0);
    for (int p = 1; p < n; ++p) {
      const int peer = (me + p) % n;
      T* dst = tdt::symm_ptr<T>(ws_tab, peer) + me * slot + (size_t)r0 * K;
      tdt::put(dst, a + (size_t)r0 * K, (size_t)rows * K * sizeof(T));
    }
    __syncthreads();
    if (tid == 0) {
      __threadfence_system();
      for (int p = 1; p < n; ++p)
        tdt::st_release_sys(tdt::symm_ptr<uint64_t>(fl_tab, (me + p) % n) +
                                n + me * tiles_m + ti,
                            epoch);
    }
  }

  // Compute chunk (me + s) mod n at step s, own chunk first.
  for (int s = 0; s < n; ++s) {
    const int c = (me + s) % n;
    const T* src = s == 0 ? a : ws_in + c * slot;
    for (int t = blockIdx.x; t < tiles; t += G) {
      const int ti = t / tiles_n, m0 = ti * BM, n0 = (t % tiles_n) * kBN;
      if (s > 0 && tid == 0) tdt::wait_until(fl + n + c * tiles_m + ti, epoch);
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
  }
}

enum Kind { kGemmAR = 0, kGemmRS = 1, kAGGemm = 2 };

template <typename T, int BM>
void* kernel_of(int kind) {
  switch (kind) {
    case kGemmAR: return reinterpret_cast<void*>(&gemm_ar_kernel<T, BM>);
    case kGemmRS: return reinterpret_cast<void*>(&gemm_rs_kernel<T, BM>);
    default: return reinterpret_cast<void*>(&ag_gemm_kernel<T, BM>);
  }
}

void* pick_kernel(int kind, int dtype, int small_m) {
  if (dtype == tdt::kDtypeF32)
    return small_m ? kernel_of<float, 16>(kind) : kernel_of<float, 64>(kind);
  return small_m ? kernel_of<__nv_bfloat16, 16>(kind)
                 : kernel_of<__nv_bfloat16, 64>(kind);
}

}  // namespace

extern "C" {

// Blocks of `kind`'s kernel that can be co-resident on the device.
int tdt_overlap_capacity(int kind, int dtype, int small_m) {
  return tdt::capacity(pick_kernel(kind, dtype, small_m), kThreads);
}

// One cooperative launch of `kind` over n co-located ranks with
// blocks_per_rank blocks each (grid (blocks_per_rank, n)). dims: M, N, K,
// and for gemm_rs half_m (for ag_gemm M is m_per). Returns the CUDA
// error; a grid that cannot be co-resident is refused with
// cudaErrorCooperativeLaunchTooLarge before launching.
int tdt_overlap_launch(int kind, int dtype, int small_m, const int64_t* a,
                       const int64_t* b, const int64_t* o,
                       const int64_t* ws_tab, const int64_t* fl_tab, int n,
                       int M, int N, int K, int half_m,
                       unsigned long long epoch, int blocks_per_rank,
                       void* stream) {
  if (n < 1 || n > tdt::kMaxRanks || blocks_per_rank < 1)
    return cudaErrorInvalidValue;
  void* fn = pick_kernel(kind, dtype, small_m);
  if (n * blocks_per_rank > tdt::capacity(fn, kThreads))
    return cudaErrorCooperativeLaunchTooLarge;
  RankPtrs pa = tdt::to_ptrs(a, n), pb = tdt::to_ptrs(b, n),
           po = tdt::to_ptrs(o, n);
  uint64_t ep = epoch;
  void* args_ar[] = {&pa, &pb, &po, &ws_tab, &fl_tab, &M, &N, &K, &n, &ep};
  void* args_rs[] = {&pa, &pb, &po, &ws_tab, &fl_tab, &M,
                     &N,  &K,  &n,  &half_m, &ep};
  void** args = kind == kGemmRS ? args_rs : args_ar;
  cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(blocks_per_rank, n), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
