// Full-mesh all-gather for Hopper (sm_90a), over ranks co-located on one
// card.
//
// Replaces triton_distributed_tpu/ops/collectives/all_gather.py
// `_full_mesh_kernel` (method PALLAS_FULL_MESH; the port's AUTO takes it
// for every size until the ring kernels are ported): gemm_ar's TWO_SHOT
// tail, which gathers each rank's reduced [M/n, N] rows into the full
// [M, N] on every rank.
//
// What it computes: every rank puts its shard [m_per, ...] (as bytes) at
// rows [me*m_per, (me+1)*m_per) of EVERY rank's output, its own included
// (one hop each), and waits until every peer's shard has landed in its
// own output. Data movement only: every rank's output is the
// concatenation of the shards, bitwise the same on every rank.
//
// What bounds it on the H100: bytes. Each rank reads its shard n times and
// writes n shards; co-located ranks share one HBM, so the bound is
// (n*n reads + n*n writes of a shard) / 3.35 TB/s.
//
// Design: one cooperative launch (grid (blocks_per_rank, n), every block
// resident or the launch is refused); after the entry barrier block g of
// rank me copies piece g of its shard (16-byte vectors) to every rank and
// flags (me, g) on each peer, then waits for piece g of every peer. The
// C entry is `tdt_all_gather_launch` (`tdt_all_gather_capacity` gives the
// co-resident limit).
#include "tdt_comm.cuh"

namespace {

using tdt::RankPtrs;

constexpr int kThreads = 256;

// Flags of rank r: [0, n) the barrier, then n + src * G + piece.
__global__ void __launch_bounds__(kThreads)
full_mesh_kernel(RankPtrs X, RankPtrs O, const int64_t* fl_tab,
                 long long shard_bytes, int n, uint64_t epoch) {
  const int me = blockIdx.y, g = blockIdx.x, G = gridDim.x;
  const size_t total = static_cast<size_t>(shard_bytes);
  // Pieces of whole 16-byte vectors (the last takes the remainder).
  const size_t piece = ((total + G - 1) / G + 15) / 16 * 16;
  const size_t start = static_cast<size_t>(g) * piece;
  const size_t lo = start < total ? start : total;
  const size_t hi = lo + piece < total ? lo + piece : total;
  const char* x = tdt::rank_ptr<const char>(X, me);

  tdt::barrier_all(fl_tab, me, n, epoch, g == 0);

  for (int p = 0; p < n; ++p) {
    const int dst = (me + p) % n;
    char* o = tdt::rank_ptr<char>(O, dst) + me * total;
    if (hi > lo) tdt::put(o + lo, x + lo, hi - lo);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    for (int p = 1; p < n; ++p)
      tdt::st_release_sys(
          tdt::symm_ptr<uint64_t>(fl_tab, (me + p) % n) + n + me * G + g,
          epoch);
    const uint64_t* mine = tdt::symm_ptr<const uint64_t>(fl_tab, me);
    for (int p = 1; p < n; ++p)
      tdt::wait_until(mine + n + ((me + p) % n) * G + g, epoch);
  }
}

}  // namespace

extern "C" {

int tdt_all_gather_capacity() {
  return tdt::capacity(reinterpret_cast<const void*>(&full_mesh_kernel),
                       kThreads);
}

// One cooperative launch over n co-located ranks: x[r] (shard_bytes
// each) to every o[*] at offset r * shard_bytes. Returns the CUDA error;
// a grid that cannot be co-resident is refused before launching.
int tdt_all_gather_launch(const int64_t* x, const int64_t* o,
                          const int64_t* fl_tab, int n,
                          long long shard_bytes, unsigned long long epoch,
                          int blocks_per_rank, void* stream) {
  if (n < 1 || n > tdt::kMaxRanks || blocks_per_rank < 1)
    return cudaErrorInvalidValue;
  const void* fn = reinterpret_cast<const void*>(&full_mesh_kernel);
  if (n * blocks_per_rank > tdt::capacity(fn, kThreads))
    return cudaErrorCooperativeLaunchTooLarge;
  RankPtrs px = tdt::to_ptrs(x, n), po = tdt::to_ptrs(o, n);
  uint64_t ep = epoch;
  void* args[] = {&px, &po, &fl_tab, &shard_bytes, &n, &ep};
  cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(blocks_per_rank, n), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
