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
//     validate_ring; the outputs are bitwise the untraced build's. In
//     bf16 a group's produce is its (tile, K atom) items over all of the
//     rank's blocks, then the atom sums and puts of its tiles.
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
// Design: one cooperative launch covers all ranks; blockIdx.y is the rank
// and its blocks loop over (step, tile) items, so every block is resident
// (or the launch is refused) and no wait can depend on a block that was
// never scheduled: produce/put items never wait, and a wait depends only
// on an item of an earlier phase or step. Each kernel is written once
// over a tile type that does the product (mma) and hands the f32 tile to
// the epilogue kVec columns at a time (stage, for_each):
//
//   WgTile, the bf16 product of ag_gemm and gemm_rs above SMALL_M rows
//   (every prefill launch): the TPU kernels' `jnp.dot(...,
//   preferred_element_type=f32)` on the matrix unit becomes wgmma on the
//   tensor cores (m64n128k16, bf16 in, f32 accumulate, both operands read
//   from shared memory). What bounds it is the tensor cores' rate and
//   keeping them fed from L2 and HBM: a tile is 128 x 128, two
//   warpgroups (256 threads) of 64 rows each, 64 f32 accumulators a
//   thread, over 64-deep K slices in a ring of 6 shared-memory stages
//   (32 KB each: A 128 x 64 and B 64 x 128, both in the 128-byte swizzle
//   wgmma reads without bank conflicts); the copies of the next 4 slices
//   are in flight while one slice multiplies.
//   B, the rank's weight shard [K, N] row-major, is always one plain box:
//   thread 0 loads it with TMA (two 64-column boxes a slice, tensor maps
//   from cuTensorMapEncodeTiled fetched through cudaGetDriverEntryPoint,
//   out-of-range rows and columns zero-filled), completion on the stage's
//   mbarrier, and wgmma reads it MN-major (transposed), so the weights
//   are never transposed. A often is not one box: gemm_rs's bidirectional
//   ring draws a tile's rows from two chunks (half_m 96 at m_per 192, 75
//   at m_per 150), m_per is ragged (150; 32 at n = 4) and ag_gemm reads
//   peers' slots; so every thread copies 4 of the tile's 16-byte row
//   pieces with cp.async (zero-fill past m_per and K: K is only a multiple
//   of 8), into the swizzled layout, tracked by cp.async groups. A thread
//   waits for its own copies, fences them for the async proxy
//   (fence.proxy.async.shared::cta, since wgmma reads shared memory
//   through it), waits for the stage's TMA barrier, and the block syncs
//   before each warpgroup issues the slice's four wgmmas (on its 64 rows,
//   real or zero-filled past m_per). A peer's bytes are read by
//   cp.async.cg, through L2 and the generic proxy, after the rows' put
//   flags were acquired, so no proxy fence on global memory is needed;
//   nothing writes B during a launch. The kernels make no call (no
//   printf in their waits: ptxas serializes every wgmma of a kernel that
//   calls a function, C7510).
//   Tiles are numbered column strip first (t % tiles_m is the row tile),
//   so the blocks that run together share their B strip through L2: at
//   the Qwen3-8B tp=2 FC1 (B 100 MB a rank, past the 50 MB L2) the
//   row-tile-first order of an earlier 64 x 128 build took 0.4448 ms and
//   this order 0.2808 (H100 80GB HBM3, 700 W). The shape: 1 block an SM
//   (193 KB of shared memory), so the QKV at m_per 192, n_loc 3072 is 2 x
//   24 = 48 tiles a step for a rank's 66 co-resident blocks, one round.
//   Measured against it on that card, with the same waits: 64 x 128 with
//   4 stages and 2 blocks an SM was 5-17 % slower at every prefill shape
//   (the adaptive QKV 0.0987 ms against 0.0940, FC1 0.2534 against
//   0.2166), 64 x 128 with 6 stages (1 block an SM) slower still, 128 x
//   128 with 4 stages between them.
//   The epilogue stages the fragment through shared memory (f32, rows
//   padded to 136) so that each thread rounds and stores 8 consecutive
//   columns (16 bytes of bf16) and reads the inbound sum the same way
//   (8 elements through L2).
//
//   FmaTile, everything else of ag_gemm and gemm_rs (f32 inputs, kept
//   exact: no TF32; bf16 decode, m <= SMALL_M, 16-row tiles) and gemm_ar
//   in f32. A shared-memory tiled FMA kernel with f32 accumulation:
//   64-column tiles of BM = 16 rows for decode or 64 rows otherwise,
//   32-deep K slices staged through registers while the previous slice
//   computes (bf16 is converted to f32 in shared memory). It runs on the
//   CUDA cores' f32 rate (67 TFLOP/s at best).
//
//   gemm_ar in bf16 (gemm_ar_mma_kernel, ArTile) is its own kernel. At
//   decode (M = 4) it is bytes: each rank streams its weight shard once.
//   Each block walks its items' 64-row K slices through one ring of
//   kStages stages (6 at MT = 16 rows, 5 at 64) that never drains between
//   items, thread 0 keeping kStages - 1 slices in flight by TMA: a 64 x
//   64 box of B (the weights, 8 KB) and an MT x 64 box of A (zero past M
//   and K), on the stage's mbarrier; 3 blocks an SM at MT 16 (2 at 64).
//   The product runs on the tensor cores with the weights on the wide
//   side: mma.sync m16n8k16 computes out^T = B^T A^T, the B tile (16
//   columns x 16 K, read transposed by ldmatrix.trans from the swizzled
//   box) as the 16-row operand and 8 activation rows (ldmatrix) as the
//   8-column one, so M = 4 pads to 8 rows, not 64. Warp w owns columns 16
//   (w % 4) .. +16 and half of the tile's rows. wgmma would need 64 rows
//   on its M side or a transposed A operand from shared memory; mma.sync
//   keeps one simple tile, and up to the 64-row chunks that take the
//   one-shot the bytes bound it, not the tensor cores' rate.
//   K is cut into atoms of kArAtom = 512 rows, whatever the grid; an
//   atom's partial starts from zero and a tile's atoms are summed in atom
//   order in f32, rounded once to bf16
//   and put to every rank's slot [me], flagged per (source, tile) as the
//   f32 build does. No float atomics: the same inputs give the same bits,
//   on every rank, in either build. The traced build's items are single
//   atoms, so each iteration's column group spreads over the rank's
//   blocks; their partials go to a rank-local scratch behind the
//   workspace's slots, and a block sums a tile once the blocks that own
//   its atoms have flagged. The untraced build's item is a whole tile (64
//   a rank at N 4096): on the H100 it streamed faster than a split over
//   every block, since a tile's sum waits for the slowest of its blocks;
//   the block sums the tile's atoms in its registers, the same additions
//   in the same order, and puts at once. Every word of the flag site is
//   an epoch (never a count), so a layout that moves with M and K cannot
//   read an earlier launch's word as a claim.
//   What is left is a floor of flag round trips, so the flags are as
//   cheap as the protocol allows. One cooperative launch covers every
//   rank, so every rank of a launch is on this device, and all of
//   gemm_ar's flags, f32 and bf16, take device scope (perf/flag_latency.cu
//   on the H100: a round trip 1.5 us, against 3.8 at system scope and 2.2
//   more for a __threadfence_system(), and a system-scope release is
//   slower still while the weights stream): a release store after the
//   block's barrier, cumulative over its writes, with no separate fence.
//   A launch a card would need system scope again. The bf16 build's entry
//   barrier is announced as the kernel starts and awaited just before the
//   first put, so its round trip hides under the products.
//
// gemm_rs waits for the inbound sum just before the epilogue's add, after
// the product: the product does not need it, so it overlaps the
// neighbour's hop.
#include <cuda.h>  // CUtensorMap and its enums only: no -lcuda
#include <cuda_fp8.h>

#include <type_traits>

#include "tdt_common.cuh"
#include "tdt_comm.cuh"
#include "tdt_hopper.cuh"

namespace {

using tdt::RankPtrs;
using tdt::cp_async16;
using tdt::cp_async_commit;
using tdt::cp_async_wait;
using tdt::encode_tiled;
using tdt::EncodeTiled;
using tdt::fence_acc;
using tdt::fence_proxy_async_smem;
using tdt::mbar_expect_tx;
using tdt::mbar_init;
using tdt::mbar_wait;
using tdt::smem_u32;
using tdt::tma_load_2d;
using tdt::wgmma_commit;
using tdt::wgmma_desc;
using tdt::wgmma_fence;
using tdt::wgmma_m64n128k16;
using tdt::wgmma_wait;
using BF16 = __nv_bfloat16;

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

// V consecutive elements of T at p, rounded to T, stored as one vector of
// V * sizeof(T) bytes (two 16-byte ones for 8 f32); p is aligned to it.
template <int V, typename T>
__device__ __forceinline__ void storev(T* p, const float (&v)[V]) {
  constexpr int kBytes = V * sizeof(T);
  alignas(16) T e[V];
#pragma unroll
  for (int j = 0; j < V; ++j) e[j] = of_f32<T>(v[j]);
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(e)[i];
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(e);
  } else {
    *reinterpret_cast<uint32_t*>(p) = *reinterpret_cast<const uint32_t*>(e);
  }
}

// V consecutive elements of T at p as f32, read through L2 (a peer may
// have written them in this launch).
template <int V, typename T>
__device__ __forceinline__ void loadv_cg(const T* p, float (&v)[V]) {
  constexpr int kBytes = V * sizeof(T);
  alignas(16) T e[V];
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      reinterpret_cast<uint4*>(e)[i] =
          __ldcg(reinterpret_cast<const uint4*>(p) + i);
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(e) = __ldcg(reinterpret_cast<const uint2*>(p));
  } else {
    *reinterpret_cast<unsigned int*>(e) =
        __ldcg(reinterpret_cast<const unsigned int*>(p));
  }
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = f32_of(e[j]);
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
// blocks arrives (an acq_rel add), the last one resets the arrival word
// and moves the generation on; the others spin until it has. All G blocks
// are co-resident (cooperative launch), so the count always completes.
// Both words are the rank's own: device scope.
__device__ __forceinline__ void rank_count(uint64_t* arrive, uint64_t* gen,
                                           int G) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint64_t g = tdt::ld_acquire_gpu(gen);
    unsigned long long old;
    asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], 1;"
                 : "=l"(old)
                 : "l"(arrive)
                 : "memory");
    if (old == static_cast<unsigned long long>(G - 1)) {
      atomicExch(reinterpret_cast<unsigned long long*>(arrive), 0ull);
      tdt::st_release_gpu(gen, g + 1);
    } else {
      tdt::wait_until<false, true>(gen, g + 1);
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The Hopper primitives of the wgmma tile (mbarriers, TMA, cp.async, proxy
// fences, wgmma) and the tensor-map encoder are tdt_hopper.cuh's.

// The rank's weight-shard tensor maps (B [K, N] of each rank), passed by
// value as a __grid_constant__ parameter: TMA reads them from param space.
struct alignas(64) BMaps {
  CUtensorMap m[tdt::kMaxRanks];
};

// ---------------------------------------------------------------------------
// The tiles of ag_gemm and gemm_rs (the design note above). A tile object
// lives in the kernel for the whole launch: mma() computes one
// [kRows, kCols] f32 block of A[rows, K] @ B[K, n0 : n0 + kCols], a_row(i)
// giving row i of A (nullptr: zero); stage() readies it for the epilogue;
// after the caller's __syncthreads, for_each(epi) calls epi(row, col, v)
// for kVec consecutive columns v of the block, each once.

template <typename T, int BM>
struct FmaTile {
  static constexpr int kRows = BM, kCols = kBN, kBlock = kThreads, kVec = 4;
  // 3 blocks an SM in bf16, 2 in f32: left to itself ptxas moved the bf16
  // tile between 80 and 113 registers (3 or 2 blocks an SM) from one small
  // edit to the next, and ag_gemm's time moved with the blocks.
  static constexpr int kMinBlocks = sizeof(T) == 2 ? 3 : 2;
  static constexpr int kSmemBytes = smem_floats<BM>() * sizeof(float);
  static constexpr bool kTma = false, kQuiet = false;
  float* smem;
  float acc[BM / 16][4];

  __device__ explicit FmaTile(uint8_t* s)
      : smem(reinterpret_cast<float*>(s)) {}

  template <typename ARow>
  __device__ __forceinline__ void mma(ARow a_row, const T* b, int N, int n0,
                                      int K, const CUtensorMap*) {
    gemm_tile<T, BM>(a_row, b, N, n0, N, K, acc, smem);
  }
  __device__ __forceinline__ void stage() {}
  template <typename Epi>
  __device__ __forceinline__ void for_each(Epi epi) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) epi(ty * (BM / 16) + i, tx * 4, acc[i]);
  }
};

struct WgTile {
  static constexpr int kRows = 128, kCols = 128, kDepth = 64, kStages = 6;
  static constexpr int kBlock = 256, kVec = 8, kMinBlocks = 1;
  // B through the tensor maps; flag waits trap without printing (a call
  // in the kernel serializes its wgmmas).
  static constexpr bool kTma = true, kQuiet = true;
  static constexpr int kABytes = kRows * kDepth * 2;   // rows of 128 B
  static constexpr int kBBytes = kDepth * kCols * 2;   // two 64-column boxes
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kLd = kCols + 8;                // f32 staging row
  // 1 KB of slack aligns the ring to the swizzle's 1024-byte atoms.
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 8 * kStages;
  static_assert(kRows * kLd * 4 <= kStages * kStageBytes,
                "the staging area reuses the ring");
  uint8_t* ring;
  uint64_t* full;  // a stage's TMA barrier
  uint32_t seq;    // slices this block has consumed: stage and parity
  float acc[64];

  __device__ explicit WgTile(uint8_t* s) {
    ring = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(s) + 1023) & ~uintptr_t(1023));
    full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
    seq = 0;
    if (threadIdx.x == 0) {
      for (int i = 0; i < kStages; ++i) mbar_init(full + i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }

  // Issues slice j's copies into its stage: the thread's 4 pieces of A
  // (zero past m_per and K), and (thread 0) B's two TMA boxes. A member,
  // not a lambda: a call left in the mainloop makes ptxas serialize every
  // wgmma (C7510) and keeps the accumulators in local memory.
  __device__ __forceinline__ void load(int j, const BF16* const (&rows)[4],
                                       const BF16* b, int n0, int K,
                                       const CUtensorMap* bmap) {
    const int tid = threadIdx.x, ch = tid & 7;
    const uint32_t st = (seq + j) % kStages;
    uint8_t* as = ring + st * kStageBytes;
    const int k = j * kDepth + ch * 8;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = tid / 8 + u * 32;
      const bool ok = rows[u] != nullptr && k < K;
      cp_async16(as + r * 128 + ((ch ^ (r & 7)) << 4),
                 ok ? static_cast<const void*>(rows[u] + k) : b, ok);
    }
    if (tid == 0) {
      mbar_expect_tx(full + st, kBBytes);
      tma_load_2d(as + kABytes, bmap, full + st, n0, j * kDepth);
      tma_load_2d(as + kABytes + kBBytes / 2, bmap, full + st, n0 + 64,
                  j * kDepth);
    }
  }

  template <typename ARow>
  __device__ __forceinline__ void mma(ARow a_row, const BF16* b, int, int n0,
                                      int K, const CUtensorMap* bmap) {
    const int tid = threadIdx.x;
    // The thread copies 16-byte piece tid%8 of rows tid/8 + 32u of a slice.
    const BF16* rows[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) rows[u] = a_row(tid / 8 + u * 32);
    const uint32_t wg_a = (tid / 128) * 64 * 128;  // warpgroup's 64 rows
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    const int nk = (K + kDepth - 1) / kDepth;
    // The previous tile's epilogue has read the staging area (generic
    // proxy) before TMA (async proxy) writes the ring again.
    __syncthreads();
    if (tid == 0) fence_proxy_async_smem();

    // kStages - 2 slices in flight ahead of the one multiplying; the
    // slice loaded at step j goes to the stage of slice j - 2, whose
    // product was retired (wait_group(1) at step j - 1) before the block's
    // sync at step j.
#pragma unroll
    for (int j = 0; j < kStages - 2; ++j) {
      if (j < nk) load(j, rows, b, n0, K, bmap);
      cp_async_commit();
    }
    for (int j = 0; j < nk; ++j) {
      const uint32_t g = seq + j, st = g % kStages;
      cp_async_wait<kStages - 3>();
      fence_proxy_async_smem();
      mbar_wait(full + st, (g / kStages) & 1);
      __syncthreads();
      if (j + kStages - 2 < nk) load(j + kStages - 2, rows, b, n0, K, bmap);
      cp_async_commit();
      const uint32_t sa = smem_u32(ring + st * kStageBytes);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDepth / 16; ++kk)
        // A: K-major, 8-row groups 1024 B apart, 16 K = 32 B further on.
        // B: MN-major, 8-K-row groups 1024 B apart, the second 64-column
        // box 8 KB on, 16 K = 16 rows of 128 B further on.
        wgmma_m64n128k16(acc, wgmma_desc(sa + wg_a + kk * 32, 16, 1024),
                         wgmma_desc(sa + kABytes + kk * 2048, kBBytes / 2,
                                    1024));
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(acc);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    seq += nk;
  }

  // The accumulator fragment (thread t: rows (t/32)*16 + (t%32)/4 (+8),
  // column pairs 8j + 2(t%4)) into the staging area, f32 [kRows][kLd].
  __device__ __forceinline__ void stage() {
    __syncthreads();
    float* sf = reinterpret_cast<float*>(ring);
    const int w = threadIdx.x / 32, l = threadIdx.x % 32;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = w * 16 + l / 4 + h * 8, col = j * 8 + (l % 4) * 2;
        *reinterpret_cast<float2*>(sf + row * kLd + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
  }

  template <typename Epi>
  __device__ __forceinline__ void for_each(Epi epi) {
    const float* sf = reinterpret_cast<const float*>(ring);
#pragma unroll
    for (int i = 0; i < kRows * kCols / 8 / kBlock; ++i) {
      const int e = threadIdx.x + i * kBlock;
      const int row = e / (kCols / 8), col = (e % (kCols / 8)) * 8;
      const float4 x = *reinterpret_cast<const float4*>(sf + row * kLd + col);
      const float4 y =
          *reinterpret_cast<const float4*>(sf + row * kLd + col + 4);
      float v[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
      epi(row, col, v);
    }
  }
};

// ---------------------------------------------------------------------------
// gemm_ar's flags, both builds, are device-scope release stores after the
// block's barrier (cumulative over its threads' writes: no fence) and
// device-scope acquires: one cooperative launch covers every rank, so
// every rank is on this card.
//
// The entry barrier in two halves: the last block of each rank announces
// its arrival as the kernel starts (it publishes nothing), and a block
// waits for all n ranks before its first put; no block touches a peer
// before every rank has entered. The bf16 build waits just before its
// first put, by when the announcements have landed. The last block: while
// the weights stream a release store holds its block for microseconds,
// and the first blocks take the items (the last often has none).
__device__ __forceinline__ void announce(const int64_t* fl_tab, int me,
                                         int n, uint64_t epoch) {
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0)
    for (int p = 0; p < n; ++p)
      tdt::st_release_gpu(tdt::symm_ptr<uint64_t>(fl_tab, p) + me, epoch);
}

__device__ __forceinline__ void await_ranks(const uint64_t* mine, int n,
                                            uint64_t epoch) {
  if (threadIdx.x == 0)
    for (int src = 0; src < n; ++src)
      tdt::wait_until<false, true>(mine + src, epoch);
  __syncthreads();
}


// gemm_ar one-shot, f32 (the FMA tile). Flags of rank r: [0, n) the entry
// barrier, then n + src * tiles + t (kTrace: n the rank-local count's
// arrivals, n + 1 its generation, tile flags from n + 2). Workspace of
// rank r: [n, M, N] (slot src). kTrace also takes the per-rank rings RING
// ([num_j+1, 3, 8] int32 each, zeroed by the host) and tile_n (a multiple
// of kBN dividing N). The bf16 build (gemm_ar_mma_kernel) follows.
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
      storev<4>(ws + (size_t)row * N + col, acc[i]);
    }
  }
  __syncthreads();
  if (tid == 0)
    for (int p = 0; p < n; ++p)
      tdt::st_release_gpu(
          tdt::symm_ptr<uint64_t>(fl_tab, p) + fl0 + me * tiles + t, epoch);
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
      tdt::wait_until<false, true>(fl + fl0 + src * tiles + t, epoch);
  __syncthreads();
  for (int e = tid; e < BM * (kBN / 4); e += kThreads) {
    const int row = m0 + e / (kBN / 4), col = n0 + (e % (kBN / 4)) * 4;
    if (row >= M || col >= N) continue;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int src = 0; src < n; ++src) {
      float v[4];
      loadv_cg<4>(ws + src * slot + (size_t)row * N + col, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) sum[j] += v[j];
    }
    storev<4>(o + (size_t)row * N + col, sum);
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

  announce(fl_tab, me, n, epoch);
  await_ranks(tdt::symm_ptr<const uint64_t>(fl_tab, me), n, epoch);

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
// gemm_ar one-shot, bf16 (the design note's split-K tile). K is cut into
// atoms of kArAtom rows, A = ceil(K / kArAtom); an atom's partial of a
// tile starts from zero, so it is the same bits
// whichever block computes it. An item is a run of `span` atoms of one
// tile: all A in the untraced build, one in the traced build. Items of a
// column group [ct0, ct0 + nct), P = ceil(A / span) runs a tile: item i
// is row tile i % tiles_m, column tile ct0 + (i / tiles_m) % nct, run i /
// (tiles_m * nct), so the blocks that run together read the same K rows
// of B across the group's columns (whole rows of B at decode, not
// 128-byte pieces of many rows). Block b takes items b, b + G, ... A
// tile's sum adds its A atom partials in atom order, so the two builds
// agree bit for bit. Flags of rank r: [0, n) the entry barrier, then the
// put flags fput + src * tiles + t, fput = n (kTrace: n, n + 1 the
// rank-local count, then the rank's own block flags n + 2 + s * G + b,
// one set an iteration s, each raised once the block's items of the
// iteration are written; fput = n + 2 + num_j * G). Workspace of rank r:
// [n, M, N] bf16 (slot src), then (kTrace) the rank's f32 atom partials
// [A, tiles, MT / 8, 4, 32] float4 in the mma fragment's order (m8 tile,
// warp column block, lane): each thread writes its own registers and the
// thread of the same index in the summing block reads them back, with no
// staging between atoms.

constexpr int kArDepth = 64;                    // K rows a slice
constexpr int kArAtom = 512;                    // K rows an atom
constexpr int kArWBytes = kArDepth * kBN * 2;   // a 64 x 64 bf16 box of B
static_assert(kArDepth == 64 && kBN == 64,
              "a slice is one 128-byte-swizzled box of each operand");
static_assert(kArAtom % kArDepth == 0, "an atom is whole slices");

// The ranks' weight shards (B [K, N]) and activations (A [M, K]) as TMA
// boxes, passed by value as a __grid_constant__ parameter.
struct alignas(64) ArMaps {
  CUtensorMap w[tdt::kMaxRanks];
  CUtensorMap x[tdt::kMaxRanks];
};

template <int MT>
struct ArTile {
  static constexpr int kStages = MT == 16 ? 6 : 5;
  static constexpr int kMinBlocks = MT == 16 ? 3 : 2;
  static constexpr int kXBytes = MT * kArDepth * 2;
  static constexpr int kStageBytes = kArWBytes + kXBytes;
  static constexpr int kLd = kBN + 4;  // f32 staging row
  // 1 KB of slack aligns the ring to the swizzle's 1024-byte atoms.
  static constexpr int kSmemBytes =
      1024 + kStages * kStageBytes + MT * kLd * 4 + 8 * kStages;
  static_assert(kStageBytes % 1024 == 0, "stages on swizzle atoms");
};

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&d)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&d)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(d[0]), "=r"(d[1])
               : "r"(addr)
               : "memory");
}

// c[16 x 8] += a[16 x 16] (row-major) @ b[16 x 8] (column-major), bf16 in,
// f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Warp w's share of a tile: out^T rows 16 (w % 4) .. +16, i.e. output
// columns, by its m8 tiles mt(w, i) = MT / 16 * (w / 4) + i, output rows
// 8 mt .. +8. Thread lane holds, of m8 tile i, c[i][0..1] at out^T row
// lane / 4, columns 2 (lane % 4) + {0, 1}, and c[i][2..3] 8 rows on.
__device__ __forceinline__ int ar_mtile(int MT, int i) {
  return MT / 16 * (threadIdx.x / 128) + i;
}

// One slice: acc += the slice's B^T (from the swizzled [64 K, 64 N] box
// at wb) times its A^T (from the swizzled [MT, 64 K] box at xb). A
// 16-byte row piece c of box row r sits at piece c ^ (r % 8).
template <int MT>
__device__ __forceinline__ void ar_slice(float (&acc)[MT / 16][4],
                                         uint32_t wb, uint32_t xb) {
  const int lane = threadIdx.x % 32, nb = threadIdx.x / 32 % 4;
  const int mat = lane / 8, r = lane % 8;
#pragma unroll
  for (int kk = 0; kk < kArDepth / 16; ++kk) {
    // Matrices (columns lo/hi, K lo), (lo/hi, K hi): the A fragment of B^T.
    uint32_t a[4];
    ldsm_x4_trans(a, wb + (kk * 16 + (mat / 2) * 8 + r) * 128 +
                         (((nb * 2 + mat % 2) ^ r) << 4));
#pragma unroll
    for (int i = 0; i < MT / 16; ++i) {
      uint32_t b[2];  // 8 rows, K lo and hi (addresses of lanes 0-15)
      ldsm_x2(b, xb + (ar_mtile(MT, i) * 8 + r) * 128 +
                     (((kk * 2 + mat % 2) ^ r) << 4));
      mma_16816(acc[i], a, b);
    }
  }
}

// The thread's float4 of m8 tile mt in the atom partials of tile t, atom
// a (the workspace layout above).
template <int MT>
__device__ __forceinline__ size_t ar_frag(int a, int tiles, int t, int mt) {
  return (((size_t)a * tiles + t) * (MT / 8) + mt) * 128 +
         (threadIdx.x / 32 % 4) * 32 + threadIdx.x % 32;
}

// Stage a tile's f32 sum (the fragment) row-major, round it once to bf16,
// put it to every rank's slot [me] and flag it there. The release store
// is cumulative over the block's puts, which the barrier ordered before
// it: no separate fence.
template <int MT>
__device__ __forceinline__ void ar_put(const float (&sum)[MT / 16][4],
                                       float* stg, const int64_t* ws_tab,
                                       const int64_t* fl_tab, int fput,
                                       int M, int N, int n, int me,
                                       int tiles, int rt, int ct,
                                       int tiles_n, uint64_t epoch) {
  using C = ArTile<MT>;
  const int tid = threadIdx.x, lane = tid % 32, nb = tid / 32 % 4;
#pragma unroll
  for (int b = 0; b < MT / 16; ++b) {
    const int m = ar_mtile(MT, b) * 8 + 2 * (lane % 4), c = nb * 16 + lane / 4;
    stg[m * C::kLd + c] = sum[b][0];
    stg[(m + 1) * C::kLd + c] = sum[b][1];
    stg[m * C::kLd + c + 8] = sum[b][2];
    stg[(m + 1) * C::kLd + c + 8] = sum[b][3];
  }
  __syncthreads();
  const int m0 = rt * MT, n0 = ct * kBN;
  const size_t plane = (size_t)M * N;
  for (int e = tid; e < MT * (kBN / 4); e += blockDim.x) {
    const int r = e / (kBN / 4), c = (e % (kBN / 4)) * 4;
    if (m0 + r >= M || n0 + c >= N) continue;
    const float4 v = *reinterpret_cast<const float4*>(stg + r * C::kLd + c);
    const float out[4] = {v.x, v.y, v.z, v.w};
    for (int d = 0; d < n; ++d)
      storev<4>(tdt::symm_ptr<BF16>(ws_tab, d) + me * plane +
                    (size_t)(m0 + r) * N + n0 + c,
                out);
  }
  __syncthreads();
  if (tid == 0)
    for (int d = 0; d < n; ++d)
      tdt::st_release_gpu(tdt::symm_ptr<uint64_t>(fl_tab, d) + fput +
                              me * tiles + rt * tiles_n + ct,
                          epoch);
}

// Where a tile's atoms are summed: through the scratch by a block that
// waits for the items' owners (ar_sum_put, the traced build), or, `fused`
// (the untraced build's item holds every atom of its tile), in that
// block's registers, in atom order, and put at once; the rest is what
// ar_put needs.
struct ArPut {
  bool fused;
  float* stg;
  const int64_t* ws_tab;
  const int64_t* fl_tab;
  const uint64_t* mine;
  int fput, N, n, me;
};

// The block's items of column tiles [ct0, ct0 + nct): each atom's f32
// partial to part (m8 tiles below M only); once all are written, the
// block's flag `done`. One flag a block, not an item or atom: a release
// stalls its warp until the writes before it land, and every warp then
// waits at the next slice's barrier. Fused (an item holds every atom
// of its tile): the atoms are summed in registers in atom order, the
// additions ar_sum_put makes, and the item's tile is put at once. `seq`
// counts the slices the block has consumed (stage and parity); every
// slice a call issues, it consumes.
template <int MT>
__device__ __forceinline__ void ar_items(
    uint8_t* ring, uint64_t* full, uint32_t& seq, const CUtensorMap* wmap,
    const CUtensorMap* xmap, float4* part, uint64_t* done, int M, int K,
    int span, int tiles_m, int tiles_n, int ct0, int nct, uint64_t epoch,
    const ArPut& put) {
  using C = ArTile<MT>;
  const int tid = threadIdx.x, G = gridDim.x;
  const int A = (K + kArAtom - 1) / kArAtom, P = (A + span - 1) / span;
  const int items = nct * P * tiles_m, tiles = tiles_m * tiles_n;
  // The item's K rows [k0, k0 + len): its run of atoms.
  auto rows = [&](int i, int& k0) {
    k0 = (i / (tiles_m * nct)) * span * kArAtom;
    return min(span * kArAtom, K - k0);
  };
  // Thread 0's producer cursor: item pi, its slice pj, slices issued.
  int pi = blockIdx.x, pj = 0;
  uint32_t issued = seq;
  auto issue = [&]() {
    if (pi >= items) return;
    int k0;
    const int len = rows(pi, k0), k = k0 + pj * kArDepth;
    const int rt = pi % tiles_m, ct = ct0 + (pi / tiles_m) % nct;
    const uint32_t st = issued % C::kStages;
    uint8_t* s = ring + st * C::kStageBytes;
    mbar_expect_tx(full + st, C::kStageBytes);
    tma_load_2d(s, wmap, full + st, ct * kBN, k);
    tma_load_2d(s + kArWBytes, xmap, full + st, k, rt * MT);
    ++issued;
    if (++pj * kArDepth >= len) {
      pj = 0;
      pi += G;
    }
  };
  if (tid == 0) {
    fence_proxy_async_smem();
    for (int j = 0; j < C::kStages - 1; ++j) issue();
  }
  for (int i = blockIdx.x; i < items; i += G) {
    const int rt = i % tiles_m, ct = ct0 + (i / tiles_m) % nct;
    const int t = rt * tiles_n + ct;
    int k0;
    const int ns = (rows(i, k0) + kArDepth - 1) / kArDepth;
    constexpr int per = kArAtom / kArDepth;  // slices an atom
    float acc[MT / 16][4], run[MT / 16][4];
    for (int j = 0; j < ns; ++j) {
      if (j % per == 0)
#pragma unroll
        for (int a = 0; a < MT / 16; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;
      const uint32_t st = seq % C::kStages;
      mbar_wait(full + st, (seq / C::kStages) & 1);
      // Every warp is past slice seq - 1: its stage takes the next copy.
      __syncthreads();
      if (tid == 0) {
        fence_proxy_async_smem();
        issue();
      }
      const uint32_t wb = smem_u32(ring + st * C::kStageBytes);
      ar_slice<MT>(acc, wb, wb + kArWBytes);
      ++seq;
      if (j % per == per - 1 || j == ns - 1) {  // the atom is complete
        const int a = k0 / kArAtom + j / per;
#pragma unroll
        for (int b = 0; b < MT / 16; ++b) {
          if (put.fused) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              run[b][e] = a == 0 ? acc[b][e] : run[b][e] + acc[b][e];
          } else if (rt * MT + ar_mtile(MT, b) * 8 < M) {
            part[ar_frag<MT>(a, tiles, t, ar_mtile(MT, b))] =
                make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
          }
        }
      }
    }
    if (put.fused) {
      if (i == blockIdx.x) await_ranks(put.mine, put.n, epoch);
      ar_put<MT>(run, put.stg, put.ws_tab, put.fl_tab, put.fput, M, put.N,
                 put.n, put.me, tiles, rt, ct, tiles_n, epoch);
    }
  }
  if (put.fused) return;
  __syncthreads();
  if (tid == 0 && blockIdx.x < items) tdt::st_release_gpu(done, epoch);
}

// The tiles of column tiles [ct0, ct0 + nct), single-atom items: wait
// for the flags `done` of the blocks that own a tile's A atoms, sum its
// atom partials in atom order in f32 (each thread its own fragment,
// kBatch loads in flight) and put the sum (ar_put).
template <int MT>
__device__ __forceinline__ void ar_sum_put(
    const float4* part, float* stg, const int64_t* ws_tab,
    const int64_t* fl_tab, const uint64_t* done, int fput, int M, int N,
    int K, int n, int me, int tiles_m, int tiles_n, int ct0, int nct,
    uint64_t epoch) {
  constexpr int kBatch = 8;
  const int tid = threadIdx.x, tiles = tiles_m * tiles_n, G = gridDim.x;
  const int A = (K + kArAtom - 1) / kArAtom;
  for (int q = blockIdx.x; q < nct * tiles_m; q += G) {
    const int rt = q % tiles_m, ct = ct0 + q / tiles_m;
    const int t = rt * tiles_n + ct;
    // Atom a of the tile is item a * nct * tiles_m + q.
    for (int a = tid; a < A; a += blockDim.x)
      tdt::wait_until<false, true>(done + (a * nct * tiles_m + q) % G,
                                   epoch);
    __syncthreads();
    float sum[MT / 16][4];
#pragma unroll
    for (int b = 0; b < MT / 16; ++b) {
      const int mt = ar_mtile(MT, b);
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[b][c] = 0.f;
      if (rt * MT + mt * 8 >= M) continue;
      for (int a0 = 0; a0 < A; a0 += kBatch) {
        float4 u[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if (a0 + j < A) u[j] = __ldcg(part + ar_frag<MT>(a0 + j, tiles, t,
                                                           mt));
#pragma unroll
        for (int j = 0; j < kBatch && a0 + j < A; ++j) {
          const float x[4] = {u[j].x, u[j].y, u[j].z, u[j].w};
#pragma unroll
          for (int c = 0; c < 4; ++c)
            sum[b][c] = a0 + j == 0 ? x[c] : sum[b][c] + x[c];
        }
      }
    }
    ar_put<MT>(sum, stg, ws_tab, fl_tab, fput, M, N, n, me, tiles, rt, ct,
               tiles_n, epoch);
  }
}

// tile_n: the traced build's column group.
template <int MT, bool kTrace>
__global__ void __launch_bounds__(kThreads, ArTile<MT>::kMinBlocks)
gemm_ar_mma_kernel(RankPtrs O, const int64_t* ws_tab, const int64_t* fl_tab,
                   int M, int N, int K, int n, uint64_t epoch,
                   RankPtrs RING, int tile_n,
                   const __grid_constant__ ArMaps maps) {
  using C = ArTile<MT>;
  extern __shared__ __align__(16) uint8_t dsmem[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(dsmem) + 1023) & ~uintptr_t(1023));
  float* stg = reinterpret_cast<float*>(ring + C::kStages * C::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(stg + MT * C::kLd);
  const int me = blockIdx.y, G = gridDim.x;
  const CUtensorMap* wmap = &maps.w[me];
  const CUtensorMap* xmap = &maps.x[me];
  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(wmap) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(xmap) : "memory");
    for (int i = 0; i < C::kStages; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  uint32_t seq = 0;
  const int tiles_m = (M + MT - 1) / MT, tiles_n = (N + kBN - 1) / kBN;
  const int tiles = tiles_m * tiles_n;
  // The untraced build's item is a whole tile, the traced build's an atom.
  const int span = kTrace ? 1 : (K + kArAtom - 1) / kArAtom;
  BF16* o = tdt::rank_ptr<BF16>(O, me);
  uint64_t* mine = tdt::symm_ptr<uint64_t>(fl_tab, me);
  float4* part = reinterpret_cast<float4*>(tdt::symm_ptr<BF16>(ws_tab, me) +
                                           (size_t)n * M * N);
  const int num_j = kTrace ? N / tile_n : 0;
  uint64_t* fb = mine + n + 2;  // kTrace: the block flags
  const int fput = kTrace ? n + 2 + num_j * G : n;
  const ArPut put{!kTrace, stg, ws_tab, fl_tab, mine, fput, N, n, me};
  auto items = [&](int j, int ct0, int nct) {
    ar_items<MT>(ring, full, seq, wmap, xmap, part, fb + j * G + blockIdx.x,
                 M, K, span, tiles_m, tiles_n, ct0, nct, epoch, put);
  };
  auto sum_put = [&](int j, int ct0, int nct) {
    ar_sum_put<MT>(part, stg, ws_tab, fl_tab, fb + j * G, fput, M, N, K, n,
                   me, tiles_m, tiles_n, ct0, nct, epoch);
  };

  announce(fl_tab, me, n, epoch);
  if constexpr (!kTrace) {
    items(0, 0, tiles_n);
    for (int t = blockIdx.x; t < tiles; t += G)
      ar_reduce<BF16, MT>(o, M, N, n, me, tiles, t, tiles_n, ws_tab, fl_tab,
                          fput, epoch);
  } else {
    // JAX's grid (num_j + 1,), as the f32 build: a group is tiles_m x
    // (tile_n / kBN) tiles, its items every atom of them.
    int32_t* ring_out = tdt::rank_ptr<int32_t>(RING, me);
    const bool stamp = blockIdx.x == 0 && threadIdx.x == 0;
    const int per = tile_n / kBN, gtiles = tiles_m * per;
    auto tile_of = [&](int j, int g) {
      return (g / per) * tiles_n + j * per + g % per;
    };
    int clk = 0;  // JAX's logical clock: one tick a begin, mid and end
    for (int s = 0; s <= num_j; ++s) {
      if (s < num_j) {
        items(s, s * per, per);
        if (s == 0) await_ranks(mine, n, epoch);
        sum_put(s, s * per, per);
        rank_count(mine + n, mine + n + 1, G);
        if (stamp) {  // TaskType.AR_SEND: the puts of group s are out
          ring_record(ring_out, s, 0, 12, s, clk + 1, clk + 3, clk + 2);
          clk += 3;
        }
      }
      if (s > 0) {
        for (int g = blockIdx.x; g < gtiles; g += G)
          ar_reduce<BF16, MT>(o, M, N, n, me, tiles, tile_of(s - 1, g),
                              tiles_n, ws_tab, fl_tab, fput, epoch);
        rank_count(mine + n, mine + n + 1, G);
        if (stamp) {  // TaskType.AR_WAIT: mid once the partials landed
          ring_record(ring_out, s, 1, 13, s - 1, clk + 1, clk + 3, clk + 2);
          clk += 3;
        }
      }
      if (s == num_j && stamp) {  // TaskType.BARRIER: the drain
        ring_record(ring_out, s, 2, 9, 0, clk + 1, clk + 2, 0);
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
template <typename T, typename W, class Tile>
__global__ void __launch_bounds__(Tile::kBlock, Tile::kMinBlocks)
gemm_rs_kernel(RankPtrs A, RankPtrs B, RankPtrs O, const int64_t* ws_tab,
               const int64_t* fl_tab, int M, int N, int K, int n, int half_m,
               uint64_t epoch, const __grid_constant__ BMaps maps) {
  extern __shared__ __align__(16) uint8_t dsmem[];
  constexpr int BM = Tile::kRows, BN = Tile::kCols, V = Tile::kVec;
  Tile tile(dsmem);
  const int me = blockIdx.y, G = gridDim.x;
  const int tid = threadIdx.x;
  const int m_per = M / n;
  const int tiles_m = (m_per + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
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

  tdt::barrier_all<Tile::kQuiet>(fl_tab, me, n, epoch, blockIdx.x == 0);

  for (int s = 0; s < n; ++s) {
    const int c_cw = ((me - 1 - s) % n + 2 * n) % n;
    const int c_ccw = (me + 1 + s) % n;
    for (int t = blockIdx.x; t < tiles; t += G) {
      const int m0 = (t % tiles_m) * BM, n0 = (t / tiles_m) * BN;
      const int m1 = min(m0 + BM, m_per);
      const bool has_cw = m0 < half_m, has_ccw = m1 > half_m;
      tile.mma(
          [&](int i) -> const T* {
            const int r = m0 + i;
            if (r >= m_per) return nullptr;
            const int c = r < half_m ? c_cw : c_ccw;
            return a + ((size_t)c * m_per + r) * K;
          },
          b, N, n0, K, &maps.m[me]);
      tile.stage();
      // Only the add needs the inbound sum: the product overlapped the hop.
      if (s > 0 && tid == 0) {
        if (has_cw)
          tdt::wait_until<Tile::kQuiet>(fl + flag_at(0, s - 1, t), epoch);
        if (has_ccw)
          tdt::wait_until<Tile::kQuiet>(fl + flag_at(1, s - 1, t), epoch);
      }
      __syncthreads();
      tile.for_each([&](int r, int cc, float (&v)[V]) {
        const int row = m0 + r, col = n0 + cc;
        if (row >= m_per || col >= N) return;
        if (s > 0) {
          float inb[V];
          loadv_cg<V>(ws_in + (size_t)(s - 1) * slot + (size_t)row * N + col,
                      inb);
#pragma unroll
          for (int j = 0; j < V; ++j) v[j] += inb[j];
        }
        if (s == n - 1) {
          storev<V>(o + (size_t)row * N + col, v);
        } else {
          const int dst = row < half_m ? right : left;
          W* ws = tdt::symm_ptr<W>(ws_tab, dst) + (size_t)s * slot;
          storev<V>(ws + (size_t)row * N + col, v);
        }
      });
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
// r: [0, n) the barrier, then n + src * puts + p, one a put row tile p of
// kPutRows rows (puts = ceil(m_per / kPutRows)); kAdaptive adds, from
// base = n + n * puts, the claim word of step s at base + s and its
// publish flag at base + n + s. The flags hold nothing but epochs: a
// site's layout moves with m_per and its flags are never reset, so any
// other value left in a slot could pass a later launch's wait. Workspace
// of rank r: [n, m_per, K] (slot = the source rank). ORD: the per-rank
// int32 [n] realized order, fresh each launch (the ring build writes its
// fixed order there too); the adaptive pick of step s is read from it
// once its publish flag is acquired, before the step's first copy. The
// lag fixtures: rank lag_rank spins lag_ns, every rank delay_ns, after
// the entry barrier and before its puts.

// A put row tile is kPutRows rows, whatever the GEMM tile: a chunk's puts
// are then spread over ceil(m_per / 16) blocks (6 at m_per 96) and land
// before the rank's first block finishes step 0 on the wgmma tile, so the
// adaptive pick finds them; a GEMM tile waits for the put tiles of its
// rows (at most 4, one thread each).
constexpr int kPutRows = 16;

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

template <typename T, class Tile, bool kAdaptive>
__global__ void __launch_bounds__(Tile::kBlock, Tile::kMinBlocks)
ag_gemm_kernel(RankPtrs A, RankPtrs B, RankPtrs O, const int64_t* ws_tab,
               const int64_t* fl_tab, int m_per, int N, int K, int n,
               uint64_t epoch, RankPtrs ORD, int lag_rank, long long lag_ns,
               long long delay_ns, const __grid_constant__ BMaps maps) {
  extern __shared__ __align__(16) uint8_t dsmem[];
  __shared__ int picked;
  constexpr int BM = Tile::kRows, BN = Tile::kCols, V = Tile::kVec;
  Tile tile(dsmem);
  const int me = blockIdx.y, G = gridDim.x;
  const int tid = threadIdx.x;
  const int tiles_m = (m_per + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n;
  const T* a = tdt::rank_ptr<const T>(A, me);
  const T* b = tdt::rank_ptr<const T>(B, me);
  T* o = tdt::rank_ptr<T>(O, me);
  const size_t slot = (size_t)m_per * K;
  const T* ws_in = tdt::symm_ptr<const T>(ws_tab, me);
  uint64_t* fl = tdt::symm_ptr<uint64_t>(fl_tab, me);
  const int puts = (m_per + kPutRows - 1) / kPutRows;
  const int base = n + n * puts;

  tdt::barrier_all<Tile::kQuiet>(fl_tab, me, n, epoch, blockIdx.x == 0);
  if (me == lag_rank) tdt::spin_ns(lag_ns);
  tdt::spin_ns(delay_ns);

  // Put the own chunk, one put row tile at a time, to every peer's slot
  // [me].
  for (int p = blockIdx.x; p < puts; p += G) {
    const int r0 = p * kPutRows, rows = min(kPutRows, m_per - r0);
    put_to_peers(a + (size_t)r0 * K, ws_tab, me * slot + (size_t)r0 * K, me,
                 n, (size_t)rows * K * sizeof(T));
    __syncthreads();
    if (tid == 0) {
      __threadfence_system();
      for (int q = 1; q < n; ++q)
        tdt::st_release_sys(tdt::symm_ptr<uint64_t>(fl_tab, (me + q) % n) +
                                n + me * puts + p,
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
        tdt::wait_until<Tile::kQuiet>(fl + base + n + s, epoch);
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
      const int m0 = (t % tiles_m) * BM, n0 = (t / tiles_m) * BN;
      // A peer's rows are copied only once their put tiles' flags are
      // acquired; the own chunk never waits.
      if (c != me) {
        const int p0 = m0 / kPutRows;
        const int p1 = min(puts, (m0 + BM + kPutRows - 1) / kPutRows);
        if (tid < p1 - p0)
          tdt::wait_until<Tile::kQuiet>(fl + n + c * puts + p0 + tid, epoch);
      }
      __syncthreads();
      tile.mma(
          [&](int i) -> const T* {
            return m0 + i < m_per ? src + (size_t)(m0 + i) * K : nullptr;
          },
          b, N, n0, K, &maps.m[me]);
      tile.stage();
      __syncthreads();
      tile.for_each([&](int r, int cc, float (&v)[V]) {
        const int row = m0 + r, col = n0 + cc;
        if (row >= m_per || col >= N) return;
        storev<V>(o + ((size_t)c * m_per + row) * N + col, v);
      });
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
        for (int p = 0; p < puts && landed; ++p)
          landed = tdt::ld_acquire_sys(fl + n + cc * puts + p) >= epoch;
        if (landed) ready = cc;
      }
      ord[s + 1] = ready >= 0 ? ready : any;
      tdt::signal(fl + base + n + s + 1, epoch);
    }
  }
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

// A launchable build: the kernel, its block, its dynamic shared memory,
// and whether it reads B through the tensor maps.
struct Build {
  void* fn;
  int threads;
  int smem;
  bool tma;
};

template <typename T, class Tile>
void* rs_kernel_of(int wire) {
  if (wire == kWireE4M3)
    return reinterpret_cast<void*>(&gemm_rs_kernel<T, E4M3, Tile>);
  if (wire == kWireBF16)
    return reinterpret_cast<void*>(&gemm_rs_kernel<T, BF16, Tile>);
  if constexpr (std::is_same<T, float>::value) {
    if (wire == kWireF32)
      return reinterpret_cast<void*>(&gemm_rs_kernel<float, float, Tile>);
  }
  return nullptr;  // no such wire, or one wider than a bf16 input
}

template <int BM>
Build ar_build(int kind) {
  return {kind == kGemmAR
              ? reinterpret_cast<void*>(&gemm_ar_kernel<float, BM, false>)
              : reinterpret_cast<void*>(&gemm_ar_kernel<float, BM, true>),
          kThreads, 0, false};
}

// gemm_ar in bf16: the split-K tile of MT rows (A and B through the maps).
template <int MT>
Build ar_mma_build(int kind) {
  return {kind == kGemmAR
              ? reinterpret_cast<void*>(&gemm_ar_mma_kernel<MT, false>)
              : reinterpret_cast<void*>(&gemm_ar_mma_kernel<MT, true>),
          kThreads, ArTile<MT>::kSmemBytes, true};
}

// ag_gemm and gemm_rs over `Tile`.
template <typename T, class Tile>
Build tile_build(int kind, int wire) {
  void* fn = nullptr;
  if (kind == kGemmRS) fn = rs_kernel_of<T, Tile>(wire);
  if (kind == kAGGemm)
    fn = reinterpret_cast<void*>(&ag_gemm_kernel<T, Tile, false>);
  if (kind == kAGGemmAdaptive)
    fn = reinterpret_cast<void*>(&ag_gemm_kernel<T, Tile, true>);
  return {fn, Tile::kBlock, Tile::kSmemBytes, Tile::kTma};
}

// f32: the FMA tile; bf16: ag_gemm and gemm_rs on the FMA tile at m <=
// SMALL_M (small_m), else wgmma; gemm_ar on the split-K mma.sync tile of
// 16 rows at m <= SMALL_M, else 64.
Build pick_kernel(int kind, int dtype, int small_m, int wire) {
  const bool ar = kind == kGemmAR || kind == kGemmARTraced;
  if (kind < kGemmAR || kind > kGemmARTraced) return {};
  if (dtype == tdt::kDtypeF32) {
    if (ar) return small_m ? ar_build<16>(kind) : ar_build<64>(kind);
    return small_m ? tile_build<float, FmaTile<float, 16>>(kind, wire)
                   : tile_build<float, FmaTile<float, 64>>(kind, wire);
  }
  if (dtype != tdt::kDtypeBF16) return {};
  if (ar) return small_m ? ar_mma_build<16>(kind) : ar_mma_build<64>(kind);
  return small_m ? tile_build<BF16, FmaTile<BF16, 16>>(kind, wire)
                 : tile_build<BF16, WgTile>(kind, wire);
}

// Lets `k` take its dynamic shared memory (above the 48 KB default), once
// a kernel and device.
bool prepare(const Build& k) {
  static int done_dev[64];
  static void* done_fn[64];
  static int n_done = 0;
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

// Rank r's B [K, N] (bf16, row-major) as boxes of 64 columns x 64 rows in
// the 128-byte swizzle, zero past its edges.
bool encode_b(CUtensorMap* map, const void* b, int N, int K) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(K)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N) * sizeof(BF16)};
  static_assert(WgTile::kDepth == kArDepth, "one B box serves both tiles");
  const cuuint32_t box[2] = {64, WgTile::kDepth};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(b),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Rank r's A [M, K] (bf16, row-major) as boxes of 64 columns (K) x `rows`
// rows in the 128-byte swizzle, zero past M and K: gemm_ar's bf16 build.
bool encode_a(CUtensorMap* map, const void* a, int M, int K, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * sizeof(BF16)};
  const cuuint32_t box[2] = {kArDepth, static_cast<cuuint32_t>(rows)};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(a),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// Blocks of `kind`'s kernel (gemm_rs: of that wire) that can be
// co-resident on the device; 0 for a combination that has no kernel.
int tdt_overlap_capacity(int kind, int dtype, int small_m, int wire) {
  const Build k = pick_kernel(kind, dtype, small_m, wire);
  if (k.fn == nullptr || !prepare(k)) return 0;
  return tdt::capacity(k.fn, k.threads, k.smem);
}

// One cooperative launch of `kind` over n co-located ranks with
// blocks_per_rank blocks each (grid (blocks_per_rank, n)). dims: M, N, K,
// and gemm_rs's half_m (for ag_gemm M is m_per). `wire`: gemm_rs's wire
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
  const Build k = pick_kernel(kind, dtype, small_m, wire);
  if (k.fn == nullptr) return cudaErrorInvalidValue;
  if (kind == kGemmARTraced &&
      (arg < kBN || arg % kBN != 0 || N % arg != 0 || aux == nullptr))
    return cudaErrorInvalidValue;
  if ((kind == kAGGemm || kind == kAGGemmAdaptive) && aux == nullptr)
    return cudaErrorInvalidValue;
  const bool ar = kind == kGemmAR || kind == kGemmARTraced;
  if (!prepare(k)) return cudaErrorInvalidValue;
  if (n * blocks_per_rank > tdt::capacity(k.fn, k.threads, k.smem))
    return cudaErrorCooperativeLaunchTooLarge;
  BMaps maps{};
  ArMaps ar_maps{};
  for (int r = 0; k.tma && r < n; ++r) {
    const void* br = reinterpret_cast<const void*>(b[r]);
    const bool ok =
        ar ? encode_b(&ar_maps.w[r], br, N, K) &&
                 encode_a(&ar_maps.x[r], reinterpret_cast<const void*>(a[r]),
                          M, K, small_m ? 16 : 64)
           : encode_b(&maps.m[r], br, N, K);
    if (!ok) return cudaErrorInvalidValue;
  }
  RankPtrs pa = tdt::to_ptrs(a, n), pb = tdt::to_ptrs(b, n),
           po = tdt::to_ptrs(o, n);
  RankPtrs px = aux == nullptr ? RankPtrs{} : tdt::to_ptrs(aux, n);
  uint64_t ep = epoch;
  void* args_ar[] = {&pa, &pb, &po, &ws_tab, &fl_tab, &M,
                     &N,  &K,  &n,  &ep,     &px,     &arg};
  void* args_mma[] = {&po, &ws_tab, &fl_tab, &M,   &N,
                      &K,  &n,      &ep,     &px,  &arg, &ar_maps};
  void* args_rs[] = {&pa, &pb, &po,     &ws_tab, &fl_tab, &M,
                     &N,  &K,  &n,      &half_m, &ep,     &maps};
  void* args_ag[] = {&pa, &pb, &po, &ws_tab, &fl_tab,   &M,
                     &N,  &K,  &n,  &ep,     &px,       &lag_rank,
                     &lag_ns, &delay_ns, &maps};
  void** args = kind == kGemmRS ? args_rs
                : ar              ? (k.tma ? args_mma : args_ar)
                                  : args_ag;
  cudaError_t err = cudaLaunchCooperativeKernel(
      k.fn, dim3(blocks_per_rank, n), dim3(k.threads), args, k.smem,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
