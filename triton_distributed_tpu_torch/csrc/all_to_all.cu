// All-to-all exchanges for Hopper (sm_90a), over ranks co-located on one card.
//
// Replaces two Pallas kernels of the JAX package:
//   triton_distributed_tpu/ops/collectives/all_to_all.py `_a2a_kernel` :35
//     (dense: chunk p of every rank goes to rank p's chunk me);
//   triton_distributed_tpu/ops/moe/ep_exchange.py `_ep_exchange_kernel` :81
//     (the expert-parallel MoE transport: segment p of a rank's packed
//     uint8 rows goes to segment me of rank p, only the filled prefix)
// and the lagging-rank fixture of the EP kernel (`straggler_rank`,
// `straggle_nanos`), here a lag argument: once every block of every rank
// has started, that rank waits the lag before it announces at the entry
// barrier, so the launch lasts the whole lag plus its work.
//
// What they compute: bytes only. Dense: every rank's output is the chunk
// transpose of the inputs, bitwise. EP: rows [0, splits[p]) of segment p
// land at rows [0, splits[p]) of rank p's segment me; the rest of every
// output segment stays unwritten (the JAX contract, ep_exchange.py:32-33;
// callers mask by count). The JAX kernel moves 32-row blocks; the card
// moves the exact rows.
//
// The counts stay on the device: the EP kernel reads `splits` (rows this
// rank sends to each peer) and `recv_counts` (rows each peer sends it)
// from device int32 arrays, as the TPU kernel scalar-prefetches them; the
// host never reads them, so a MoE layer adds no sync.
//
// What bounds it on the H100: bytes. Co-located ranks share one HBM, so
// the bound counts the moved rows read once and written once over
// 3.35 TB/s.
//
// Design: one cooperative launch over all ranks (grid (G, n), every block
// resident or the launch is refused), the entry barrier and epoch flags of
// tdt_comm.cuh. Block g of rank me copies piece g of each destination's
// filled prefix (own segment first, local), then stores flag (me, g) on
// every peer; the receiver's block g waits for flag (src, g) of every
// source whose piece g is non-empty by its recv_counts (the sender's
// splits: the same pieces). Flags of rank r: [0, n) the barrier, then
// n + src * G + g; on the lagging rank, n + n * G + src * G + g says that
// block g of rank src has started.
#include "tdt_comm.cuh"

namespace {

using tdt::RankPtrs;

constexpr int kThreads = 256;

// Byte range [lo, hi) of piece g of G over `span` bytes, in whole 16-byte
// vectors (the last piece takes the remainder).
__device__ __forceinline__ void byte_piece(long long span, int g, int G,
                                           long long& lo, long long& hi) {
  const long long per = ((span + G - 1) / G + 15) / 16 * 16;
  lo = min(span, static_cast<long long>(g) * per);
  hi = min(span, lo + per);
}

__device__ __forceinline__ long long clamp_rows(int v, long long cap) {
  return v < 0 ? 0 : (v > cap ? cap : static_cast<long long>(v));
}

// kCounts false: the dense all-to-all, every segment `seg_rows` rows.
// kCounts true: the EP exchange, segment p's rows from splits[me][p],
// the waits from recv_counts[me][src]. Rows are `row_bytes` wide.
template <bool kCounts>
__global__ void __launch_bounds__(kThreads)
exchange_kernel(RankPtrs X, RankPtrs O, RankPtrs S, RankPtrs E,
                const int64_t* fl_tab, long long seg_rows,
                long long row_bytes, int n, uint64_t epoch, int lag_rank,
                long long lag_ns) {
  const int me = blockIdx.y, g = blockIdx.x, G = gridDim.x;
  const long long seg_bytes = seg_rows * row_bytes;
  const char* x = tdt::rank_ptr<const char>(X, me);
  const int* splits = kCounts ? tdt::rank_ptr<const int>(S, me) : nullptr;
  const int* expect = kCounts ? tdt::rank_ptr<const int>(E, me) : nullptr;

  // The lagging rank starts late: every block announces that it has
  // started; block 0 of the lagging rank waits for all of them (so no
  // block's dispatch overlaps the lag), spins lag_ns, and only then
  // announces at the entry barrier, which every rank's copies wait for.
  if (lag_rank >= 0 && lag_ns > 0 && threadIdx.x == 0) {
    uint64_t* started = tdt::symm_ptr<uint64_t>(fl_tab, lag_rank) + n + n * G;
    tdt::st_release_sys(started + me * G + g, epoch);
    if (me == lag_rank && g == 0) {
      for (int i = 0; i < n * G; ++i) tdt::wait_until(started + i, epoch);
      const uint64_t t0 = tdt::global_ns();
      while (tdt::global_ns() - t0 < static_cast<uint64_t>(lag_ns))
        __nanosleep(1000);
    }
  }
  tdt::barrier_all(fl_tab, me, n, epoch, g == 0);

  for (int i = 0; i < n; ++i) {
    const int p = (me + i) % n;  // the own segment first (a local copy)
    const long long rows = kCounts ? clamp_rows(splits[p], seg_rows)
                                   : seg_rows;
    long long lo, hi;
    byte_piece(rows * row_bytes, g, G, lo, hi);
    char* dst = tdt::rank_ptr<char>(O, p) + me * seg_bytes;
    const char* src = x + p * seg_bytes;
    if (hi > lo) tdt::put(dst + lo, src + lo, hi - lo);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    for (int i = 1; i < n; ++i)
      tdt::st_release_sys(
          tdt::symm_ptr<uint64_t>(fl_tab, (me + i) % n) + n + me * G + g,
          epoch);
    const uint64_t* mine = tdt::symm_ptr<const uint64_t>(fl_tab, me);
    for (int i = 1; i < n; ++i) {
      const int src = (me + i) % n;
      if (kCounts) {
        long long lo, hi;
        byte_piece(clamp_rows(expect[src], seg_rows) * row_bytes, g, G, lo,
                   hi);
        if (hi <= lo) continue;  // nothing of piece g comes from src
      }
      tdt::wait_until(mine + n + src * G + g, epoch);
    }
  }
}

const void* exchange_fn(int counts) {
  return counts ? reinterpret_cast<const void*>(&exchange_kernel<true>)
                : reinterpret_cast<const void*>(&exchange_kernel<false>);
}

int launch(int counts, const int64_t* x, const int64_t* o,
           const int64_t* splits, const int64_t* expect,
           const int64_t* fl_tab, int n, long long seg_rows,
           long long row_bytes, unsigned long long epoch, int blocks,
           int lag_rank, long long lag_ns, void* stream) {
  if (n < 2 || n > tdt::kMaxRanks || blocks < 1 || seg_rows < 0 ||
      row_bytes < 1 || lag_rank >= n)
    return cudaErrorInvalidValue;
  const void* fn = exchange_fn(counts);
  if (n * blocks > tdt::capacity(fn, kThreads))
    return cudaErrorCooperativeLaunchTooLarge;
  RankPtrs px = tdt::to_ptrs(x, n), po = tdt::to_ptrs(o, n);
  RankPtrs ps{}, pe{};
  if (counts) {
    ps = tdt::to_ptrs(splits, n);
    pe = tdt::to_ptrs(expect, n);
  }
  uint64_t ep = epoch;
  void* args[] = {&px,       &po, &ps,  &pe,       &fl_tab, &seg_rows,
                  &row_bytes, &n, &ep, &lag_rank, &lag_ns};
  cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(blocks, n), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Co-resident blocks of the exchange kernel (counts 0 dense, 1 EP).
int tdt_all_to_all_capacity(int counts) {
  return tdt::capacity(exchange_fn(counts), kThreads);
}

// Dense all-to-all over n co-located ranks: x[r] holds n chunks of
// chunk_bytes; chunk p of x[r] lands at chunk r of o[p]. Host tables of
// the per-rank x and o pointers, the flags' device table.
int tdt_all_to_all_launch(const int64_t* x, const int64_t* o,
                          const int64_t* fl_tab, int n,
                          long long chunk_bytes, unsigned long long epoch,
                          int blocks_per_rank, void* stream) {
  return launch(0, x, o, nullptr, nullptr, fl_tab, n, 1, chunk_bytes, epoch,
                blocks_per_rank, -1, 0, stream);
}

// EP exchange: rows[r] is [n, cap, row_bytes] uint8; rows [0,
// splits[r][p]) of segment p land at segment r of out[p]. splits[r] and
// recv_counts[r] are device int32 [n] arrays (host tables of their
// pointers). lag_rank >= 0 lags that rank lag_ns at the entry barrier,
// counted from the start of the grid's last block; the flag table then
// holds n + 2 * n * blocks_per_rank flags a rank.
int tdt_ep_exchange_launch(const int64_t* rows, const int64_t* out,
                           const int64_t* splits, const int64_t* recv_counts,
                           const int64_t* fl_tab, int n, long long cap,
                           long long row_bytes, unsigned long long epoch,
                           int blocks_per_rank, int lag_rank,
                           long long lag_ns, void* stream) {
  if (row_bytes % 16) return cudaErrorInvalidValue;
  return launch(1, rows, out, splits, recv_counts, fl_tab, n, cap, row_bytes,
                epoch, blocks_per_rank, lag_rank, lag_ns, stream);
}

}  // extern "C"
