// Collectives for Hopper (sm_90a), over ranks co-located on one card.
//
// Replaces the Pallas kernels of triton_distributed_tpu/ops/collectives/:
//   all_gather.py     _full_mesh_kernel :146, _ring_kernel :49,
//                     _bidir_ring_kernel :93
//   reduce_scatter.py _one_shot_rs_kernel :150, _ring_rs_kernel :59,
//                     _bidir_ring_rs_kernel :89, _ring_rs_hbm_kernel :191
//   all_reduce.py     _one_shot_kernel :78, _doubling_kernel :113, and the
//                     lagging-rank fixture _straggle_entry :151 (here a lag
//                     argument of the one-shot, doubling and ring RS launches)
//   all_gather.py     _pull_kernel :182, _torus_2d_kernel :328
//   broadcast.py      _one_shot_bcast_kernel :41
//   low_latency.py    _ll_ag_kernel :62
// and triton_distributed_tpu/parallel/p2p.py _shift_kernel :43 (the
// pipeline neighbour shift).
// The port's AUTO follows the JAX dispatch (ops/collectives/*.py of the
// port): the tensor-parallel MoE layer reaches every reduction and the
// ring and full-mesh gathers by size and rank count; the shift, the pull
// and torus gathers, the broadcast and the low-latency gather are reached
// by their own entry points, as in JAX.
//
// What they compute. The all-gathers move bytes only: every rank's output
// is the shards in rank order, bitwise. The reductions follow the JAX
// rounding, because at bf16 the order of a sum is part of the function:
// - AR one-shot: every rank sums the n copies in f32 in rank order 0..n-1
//   and rounds once, so the ranks come out bitwise equal;
// - AR doubling: log2 n rounds; in round k a rank sends its running f32 sum
//   rounded to the dtype to partner me ^ 2^k and adds the partner's rounded
//   value to its own unrounded f32 sum (held in registers, or, where a
//   warp's sub-piece outgrows them, rebuilt from x and the received values
//   in the same order);
// - RS one-shot: the n contributions to the own chunk, f32 in source-rank
//   order, rounded once;
// - RS rings (single, bidirectional, HBM-tiled): the running sum is rounded
//   to the dtype at every hop; chunk me-1-s goes right at step s, and in the
//   bidirectional ring the rows from `half` on go left (chunk me+1+s).
//
// What bounds it on the H100 (each of them): bytes. Co-located ranks share
// one HBM, so a bound counts every rank's reads and writes over 3.35 TB/s.
//
// Design: one cooperative launch over all ranks (grid (blocks_per_rank, n),
// every block resident or the launch is refused), the entry barrier and
// epoch flags of tdt_comm.cuh. Block g of every rank owns piece g of each
// chunk, so a block only ever waits for block g of its peers: flag (step,
// piece) per rank, set by the one peer that writes that piece of that step.
// The ring all-gathers, the ring and one-shot reduce-scatters, the
// doubling all-reduce and the low-latency gather cut a piece further, one
// flagged sub-piece a warp, and keep every flag and their entry barrier at
// device scope: their time is flag latency, not bytes (a device-scope
// round trip took 1.5 us on an H100 against 3.8 at system scope, and a
// __threadfence_system() 2.2, perf/flag_latency.cu), and device scope is
// right because one launch covers every rank and every rank is on this
// card. Their grids are sized to the work (~16 KB a block). The other kernels
// keep tdt_comm.cuh's system scope: right here too, only slower, and what
// one launch a rank on separate cards needs; they move to device scope as
// each is redesigned, and separate cards would bring every kernel back to
// system scope.
// A ring hop fuses the add into the put: the sender reads its received
// slot and its own contribution and writes the rounded sum into the next
// rank's slot. Element kernels move 16-byte vectors (the wrappers require
// rows of a multiple of 16 bytes); data a peer wrote is read with ld.cg.
// Symmetric workspaces hold the received slots: AR one-shot n x M, AR
// doubling log2(n) x M, RS one-shot n x chunk, RS rings (n-1) x chunk.
//
// The byte movers of the shift, the pull and torus gathers, the broadcast
// and the low-latency gather move whole byte ranges (any size: 16-byte
// vectors where both ends are aligned, bytes for the rest) and read every
// byte through L2 (ld.cg), since a peer may have written it in this launch.
// - shift: the entry barrier, then every sender puts piece g into rank
//   me+1's output and flags it; rank 0 writes zeros without wrap.
// - pull: no barrier. Block 0 of each rank raises its "entered" flag; the
//   grid splits into w lanes and lane j reads sources me+1+j, me+1+j+w, ...
//   in turn, each after that source's flag, into the own output: at most w
//   peers read at once (the JAX window of outstanding requests).
// - torus: one entry barrier over the world; the own chunk put along the
//   column (the tp peers) and along the row (the dp peers), each column
//   chunk forwarded along the row as its flag arrives, the row arrivals
//   waited by (slot, piece) flags.
// - broadcast: the entry barrier; the root copies into its own output and
//   puts to every peer, one flag a (peer, piece); the peers wait.
// - low-latency gather: no barrier. The shard goes into every peer's
//   persistent slot p = phase % 2 of a symmetric workspace; the flags carry
//   the caller's counter: an arrival reads phase + 1, and a producer
//   overwrites a peer's slot p only once that peer's ACK for p reads
//   phase - 1 (the use at phase - 2). With barrier_free 0 an entry barrier
//   replaces the ACK wait (the JAX interpret-mode variant); the ACKs are
//   still written, so the two variants may alternate on one workspace.
//   Each warp runs the discipline for its own sub-piece on its own flags,
//   the n - 1 peers' pushes, flags and copies at once.
//
// C entries: tdt_all_gather_launch (kind 0 full mesh, 1 ring, 2 bidir
// ring), tdt_reduce_scatter_launch (0 one-shot, 1 ring, 2 bidir ring,
// 3 HBM ring), tdt_all_reduce_launch (0 one-shot, 1 doubling),
// tdt_move_launch (0 shift, 1 broadcast, 2 pull, 3 torus),
// tdt_ll_all_gather_launch; the co-resident limit of each kernel from
// tdt_collective_capacity.
#include <cuda_bf16.h>

#include "tdt_comm.cuh"

namespace {

using tdt::RankPtrs;

constexpr int kThreads = 256;

// ---- helpers -------------------------------------------------------------

// [lo, hi) of piece g of G over `count` units.
__device__ __forceinline__ void piece_of(long long count, int g, int G,
                                         long long& lo, long long& hi) {
  const long long per = (count + G - 1) / G;
  lo = min(count, static_cast<long long>(g) * per);
  hi = min(count, lo + per);
}

__device__ __forceinline__ uint64_t* flag_at(const int64_t* fl_tab, int r,
                                             long long idx) {
  return tdt::symm_ptr<uint64_t>(fl_tab, r) + idx;
}

// The block's writes are done (all threads), then one release store.
__device__ __forceinline__ void block_signal(uint64_t* flag, uint64_t epoch) {
  __syncthreads();
  if (threadIdx.x == 0) tdt::signal(flag, epoch);
}

// One thread acquires the flag, then the block goes on.
__device__ __forceinline__ void block_wait(const uint64_t* flag,
                                           uint64_t epoch) {
  if (threadIdx.x == 0) tdt::wait_until(flag, epoch);
  __syncthreads();
}

// The lagging-rank fixture: the blocks of `lag_rank` spin `lag_ns` before
// their first put (the JAX straggle_if_rank after the entry barrier).
__device__ __forceinline__ void straggle(int me, int lag_rank,
                                         long long lag_ns) {
  if (me == lag_rank) tdt::spin_ns(lag_ns);
}

// 16-byte vectors of T as f32 lanes.
template <typename T>
struct Lanes {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Vector v of p as f32; kPeer reads through L2 (data a peer wrote).
template <typename T, bool kPeer>
__device__ __forceinline__ void load(const T* p, long long v, float* f) {
  const uint4* q = reinterpret_cast<const uint4*>(p) + v;
  const uint4 u = kPeer ? __ldcg(q) : *q;
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < Lanes<T>::N; ++i) f[i] = to_f32(e[i]);
}

template <typename T, bool kPeer>
__device__ __forceinline__ void add(const T* p, long long v, float* acc) {
  float f[Lanes<T>::N];
  load<T, kPeer>(p, v, f);
#pragma unroll
  for (int i = 0; i < Lanes<T>::N; ++i) acc[i] += f[i];
}

// Round the f32 lanes to T and store vector v of p.
template <typename T>
__device__ __forceinline__ void store(T* p, long long v, const float* f) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < Lanes<T>::N; ++i) e[i] = from_f32<T>(f[i]);
  reinterpret_cast<uint4*>(p)[v] = u;
}

// ---- all-gather ------------------------------------------------------------

// Full mesh. Flags of rank r: [0, n) the barrier, then n + src * G + piece.
__global__ void __launch_bounds__(kThreads)
full_mesh_kernel(RankPtrs X, RankPtrs O, const int64_t* fl_tab,
                 long long shard_bytes, long long /*half_bytes*/, int n,
                 uint64_t epoch) {
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

// Byte range [lo, hi) of piece g of [a, b), in whole 16-byte vectors.
__device__ __forceinline__ void byte_piece(long long a, long long b, int g,
                                           int G, long long& lo,
                                           long long& hi) {
  const long long span = b - a;
  const long long per = ((span + G - 1) / G + 15) / 16 * 16;
  lo = min(b, a + static_cast<long long>(g) * per);
  hi = min(b, lo + per);
}

// Flagged sub-pieces a block and hop of the ring all-gathers: one a warp.
constexpr int kRingWarps = kThreads / 32;

// The warp copies `bytes` from src to dst: 16-byte vectors where both are
// aligned, four loads in flight a lane, bytes for the rest; every read
// through L2 (a peer may have written it in this launch).
__device__ __forceinline__ void warp_put(char* dst, const char* src,
                                         long long bytes) {
  const int lane = threadIdx.x % 32;
  long long head = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) &
       15) == 0) {
    const long long nv = bytes / 16;
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4* s = reinterpret_cast<const uint4*>(src);
    long long i = lane;
    for (; i + 96 < nv; i += 128) {
      const uint4 u0 = __ldcg(s + i), u1 = __ldcg(s + i + 32),
                  u2 = __ldcg(s + i + 64), u3 = __ldcg(s + i + 96);
      d[i] = u0;
      d[i + 32] = u1;
      d[i + 64] = u2;
      d[i + 96] = u3;
    }
    for (; i < nv; i += 32) d[i] = __ldcg(s + i);
    head = nv * 16;
  }
  for (long long i = head + lane; i < bytes; i += 32) dst[i] = __ldcg(src + i);
}

// The warp's writes are done (all lanes), then one device-scope release
// store: one launch covers every rank, all on this card.
__device__ __forceinline__ void warp_signal(uint64_t* flag, uint64_t epoch) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) {
    __threadfence();
    tdt::st_release_gpu(flag, epoch);
  }
}

// Lane 0 acquires the flag at device scope, then the warp goes on.
__device__ __forceinline__ void warp_wait(const uint64_t* flag,
                                          uint64_t epoch) {
  if (threadIdx.x % 32 == 0) tdt::wait_until<false, true>(flag, epoch);
  __syncwarp();
}

// The warp copies k ranges of `len` bytes, range q from src(q) to dst(q),
// its lanes spread over all k ranges at once (the n - 1 peers of a push go
// out together): 16-byte vectors, four in flight a lane, when `vec` (every
// range 16-byte aligned), else bytes; every read through L2 (a peer may
// have written it in this launch).
template <typename Src, typename Dst>
__device__ __forceinline__ void warp_copy_k(int k, long long len, bool vec,
                                            Src src, Dst dst) {
  const int lane = threadIdx.x % 32;
  if (!vec) {
    for (long long i = lane; i < k * len; i += 32) {
      const int q = static_cast<int>(i / len);
      dst(q)[i - q * len] = __ldcg(src(q) + (i - q * len));
    }
    return;
  }
  const long long nv = len / 16, total = k * nv;
  auto at = [&](long long i, int& q) {
    q = static_cast<int>(i / nv);
    return i - q * nv;
  };
  long long i = lane;
  for (; i + 96 < total; i += 128) {
    uint4 u[4];
    int q[4];
    long long v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = at(i + 32 * j, q[j]);
      u[j] = __ldcg(reinterpret_cast<const uint4*>(src(q[j])) + v[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      reinterpret_cast<uint4*>(dst(q[j]))[v[j]] = u[j];
  }
  for (; i < total; i += 32) {
    int q;
    const long long v = at(i, q);
    reinterpret_cast<uint4*>(dst(q))[v] =
        __ldcg(reinterpret_cast<const uint4*>(src(q)) + v);
  }
}

// Lanes 0 .. k - 1 of the warp each release flag(q) at device scope once
// the warp's writes (all lanes) are done.
template <typename F>
__device__ __forceinline__ void warp_signal_k(int k, F flag, uint64_t v) {
  __syncwarp();
  const int lane = threadIdx.x % 32;
  if (lane < k) {
    __threadfence();
    tdt::st_release_gpu(flag(lane), v);
  }
}

// Lanes 0 .. k - 1 each acquire flag(q) >= v at device scope, at once;
// then the warp goes on.
template <typename F>
__device__ __forceinline__ void warp_wait_k(int k, F flag, uint64_t v) {
  const int lane = threadIdx.x % 32;
  if (lane < k) tdt::wait_until<false, true>(flag(lane), v);
  __syncwarp();
}

// Ring (kBidir false) and bidirectional ring. At step s a rank forwards the
// shard of rank me - s (its own at s = 0) to the right; in the bidir ring
// the bytes from half_bytes on go left instead (the shard of rank me + s).
// Block g owns piece g of a direction's bytes, cut into one flagged
// sub-piece a warp (kRingWarps of them; in the bidir ring half the warps
// go each way), so a sub-piece's next hop starts as soon as it has landed,
// whatever the rest of the block's piece does. Every flag and the entry
// barrier are device scope. Flags of rank r: [0, n) the barrier, then
// n + ((dir * (n - 1) + s) * G + g) * W + w for warp w of W a direction.
template <bool kBidir>
__global__ void __launch_bounds__(kThreads)
ag_ring_kernel(RankPtrs X, RankPtrs O, const int64_t* fl_tab,
               long long shard_bytes, long long half_bytes, int n,
               uint64_t epoch) {
  constexpr int W = kBidir ? kRingWarps / 2 : kRingWarps;
  const int me = blockIdx.y, g = blockIdx.x, G = gridDim.x;
  const int warp = threadIdx.x / 32;
  const int dir = kBidir && warp >= W ? 1 : 0, w = warp % W;
  const char* x = tdt::rank_ptr<const char>(X, me);
  char* o_me = tdt::rank_ptr<char>(O, me);
  long long lo, hi, slo, shi;
  if (dir == 0)
    byte_piece(0, kBidir ? half_bytes : shard_bytes, g, G, lo, hi);
  else
    byte_piece(half_bytes, shard_bytes, g, G, lo, hi);
  byte_piece(lo, hi, w, W, slo, shi);
  const int to = dir ? (me + n - 1) % n : (me + 1) % n;
  const long long base = n + static_cast<long long>(dir) * (n - 1) * G * W;
  auto flag = [&](int s) {
    return base + (static_cast<long long>(s) * G + g) * W + w;
  };

  // The own shard lands at its offset (local; no peer touches it).
  {
    long long a, b;
    byte_piece(0, shard_bytes, g, G, a, b);
    if (b > a) tdt::put(o_me + me * shard_bytes + a, x + a, b - a);
  }
  tdt::barrier_all<false, true>(fl_tab, me, n, epoch, g == 0);

  for (int s = 0; s < n - 1; ++s) {
    const int src = dir ? (me + s) % n : (me - s + n) % n;
    if (s > 0) warp_wait(flag_at(fl_tab, me, flag(s - 1)), epoch);
    const char* from = s == 0 ? x : o_me + src * shard_bytes;
    char* dst = tdt::rank_ptr<char>(O, to) + src * shard_bytes;
    if (shi > slo) warp_put(dst + slo, from + slo, shi - slo);
    warp_signal(flag_at(fl_tab, to, flag(s)), epoch);
  }
  if (threadIdx.x % 32 == 0)
    tdt::wait_until<false, true>(flag_at(fl_tab, me, flag(n - 2)), epoch);
}

// ---- reduce-scatter --------------------------------------------------------

// [lo, hi) of warp w's sub-piece of block g's piece of `count` vectors:
// one flagged sub-piece a warp, kRingWarps of them a block.
__device__ __forceinline__ void sub_piece_of(long long count, int g, int G,
                                             int w, long long& lo,
                                             long long& hi) {
  long long plo, phi;
  piece_of(count, g, G, plo, phi);
  piece_of(phi - plo, w, kRingWarps, lo, hi);
  lo += plo;
  hi += plo;
}

// Vectors a lane holds in registers in the one-shot's sum and the
// doubling's running sum (a stripe is 32 x kHeld vectors of a warp).
constexpr int kHeld = 4;

// One-shot: chunk p of x goes to slot me of rank p's workspace; each rank
// sums its n slots (its own chunk read from x) in f32 in source order.
// Units: 16-byte vectors; cnt is the chunk. Block g owns piece g of the
// chunk, cut into one flagged sub-piece a warp (kRingWarps of them), and
// each warp runs the whole exchange for its sub-piece on its own flags:
// its first vectors of the own chunk load before anything else, it pushes
// chunk p's sub-piece into the n - 1 peers' slot me in one pass over all
// lanes, releases their arrival flags (a lane a peer), waits the n - 1
// arrivals (a lane each) and sums x's and the slots' vectors (ld.cg) in
// source order. One launch covers every rank, so every flag and the entry
// barrier are device scope. Flags of rank r: [0, n) the barrier, then
// n + (src * G + g) * W + w: src's sub-piece (g, w) arrived.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rs_one_shot_kernel(RankPtrs X, RankPtrs O, const int64_t* ws_tab,
                   const int64_t* fl_tab, long long cnt, long long /*half*/,
                   int n, uint64_t epoch, int lag_rank, long long lag_ns) {
  constexpr int N = Lanes<T>::N, W = kRingWarps, U = kHeld;
  const int me = blockIdx.y, g = blockIdx.x, G = gridDim.x;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  long long slo, shi;
  sub_piece_of(cnt, g, G, w, slo, shi);
  const long long sub = static_cast<long long>(g) * W + w;
  auto arr = [&](int src) {
    return n + static_cast<long long>(src) * G * W + sub;
  };
  auto peer = [&](int q) { return (me + 1 + q) % n; };
  const uint4* x = tdt::rank_ptr<const uint4>(X, me);
  const uint4* xo = x + me * cnt;
  const uint4* ws = tdt::symm_ptr<const uint4>(ws_tab, me);

  long long v = slo + lane;
  uint4 a[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (v + 32 * u < shi) a[u] = xo[v + 32 * u];
  tdt::barrier_all<false, true>(fl_tab, me, n, epoch, g == 0);
  straggle(me, lag_rank, lag_ns);
  warp_copy_k(n - 1, (shi - slo) * 16, true, [&](int q) {
    return reinterpret_cast<const char*>(x + peer(q) * cnt + slo);
  }, [&](int q) {
    return reinterpret_cast<char*>(tdt::symm_ptr<uint4>(ws_tab, peer(q)) +
                                   me * cnt + slo);
  });
  warp_signal_k(n - 1, [&](int q) {
    return flag_at(fl_tab, peer(q), arr(me));
  }, epoch);
  warp_wait_k(n - 1, [&](int q) {
    return flag_at(fl_tab, me, arr(peer(q)));
  }, epoch);

  T* o = tdt::rank_ptr<T>(O, me);
  for (; v < shi; v += 32 * U) {
    float acc[U][N];
    for (int src = 0; src < n; ++src) {
      uint4 b[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (v + 32 * u < shi)
          b[u] = src == me ? a[u] : __ldcg(ws + src * cnt + v + 32 * u);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (v + 32 * u >= shi) continue;
        const T* e = reinterpret_cast<const T*>(&b[u]);
#pragma unroll
        for (int i = 0; i < N; ++i)
          acc[u][i] = src == 0 ? to_f32(e[i]) : acc[u][i] + to_f32(e[i]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (v + 32 * u < shi) store<T>(o, v + 32 * u, acc[u]);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (v + 32 * (U + u) < shi) a[u] = xo[v + 32 * (U + u)];
  }
}

// The warp's share of one ring hop over vectors [lo, hi): x's chunk xc
// plus, once `wait` reads the epoch (none at the first hop), the received
// slot rv, summed in f32 and rounded to T, into dst. Four vectors in
// flight a lane; the first four of x (the launch's own input, final
// before it started) are loaded before the wait, so they arrive while the
// flag does.
template <typename T>
__device__ __forceinline__ void warp_add_put(uint4* dst, const uint4* xc,
                                             const uint4* rv, long long lo,
                                             long long hi,
                                             const uint64_t* wait,
                                             uint64_t epoch) {
  constexpr int N = Lanes<T>::N, U = 4;
  const int lane = threadIdx.x % 32;
  long long v = lo + lane;
  uint4 a[U], b[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (v + 32 * u < hi) a[u] = xc[v + 32 * u];
  if (wait != nullptr) warp_wait(wait, epoch);
  for (; v < hi; v += 32 * U) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (rv != nullptr && v + 32 * u < hi) b[u] = __ldcg(rv + v + 32 * u);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (v + 32 * u >= hi) continue;
      float f[N];
      const T* e = reinterpret_cast<const T*>(&a[u]);
#pragma unroll
      for (int i = 0; i < N; ++i) f[i] = to_f32(e[i]);
      if (rv != nullptr) {
        const T* r = reinterpret_cast<const T*>(&b[u]);
#pragma unroll
        for (int i = 0; i < N; ++i) f[i] += to_f32(r[i]);
      }
      store<T>(reinterpret_cast<T*>(dst + v + 32 * u), 0, f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (v + 32 * (U + u) < hi) a[u] = xc[v + 32 * (U + u)];
  }
}

// The rings: one ring (kBidir false; PALLAS_RING and PALLAS_RING_HBM,
// whose JAX row tiles the sub-pieces below make finer) and two
// counter-rotating rings (elements from `half` on go left). Step s: the
// running sum of chunk me - 1 - s (x's chunk at s = 0, else the received
// slot s - 1 plus x's chunk, rounded) goes to slot s of the right rank
// (left: chunk me + 1 + s); after n - 1 steps slot n - 2 plus x's own
// chunk is the output. Block g owns piece g of a direction's vectors, cut
// into one flagged sub-piece a warp (kRingWarps of them; in the bidir
// ring half the warps go each way, both directions at once), so a
// sub-piece's next hop starts as soon as it has landed, whatever the rest
// of the block does. Every flag and the entry barrier are device scope.
// Flags of rank r: [0, n) the barrier, then
// n + ((dir * (n - 1) + s) * G + g) * W + w for warp w of W a direction.
template <typename T, bool kBidir>
__global__ void __launch_bounds__(kThreads)
rs_ring_kernel(RankPtrs X, RankPtrs O, const int64_t* ws_tab,
               const int64_t* fl_tab, long long cnt, long long half, int n,
               uint64_t epoch, int lag_rank, long long lag_ns) {
  constexpr int W = kBidir ? kRingWarps / 2 : kRingWarps;
  const int me = blockIdx.y, g = blockIdx.x, G = gridDim.x;
  const int warp = threadIdx.x / 32;
  const int dir = kBidir && warp >= W ? 1 : 0, w = warp % W;
  const long long a = dir ? half : 0, b = kBidir && !dir ? half : cnt;
  long long lo, hi, slo, shi;
  piece_of(b - a, g, G, lo, hi);
  piece_of(hi - lo, w, W, slo, shi);
  slo += a + lo;
  shi += a + lo;
  const int to = dir ? (me + n - 1) % n : (me + 1) % n;
  const long long base = n + static_cast<long long>(dir) * (n - 1) * G * W;
  auto flag = [&](int s) {
    return base + (static_cast<long long>(s) * G + g) * W + w;
  };
  const uint4* x = tdt::rank_ptr<const uint4>(X, me);
  const uint4* ws_me = tdt::symm_ptr<const uint4>(ws_tab, me);
  uint4* ws_to = tdt::symm_ptr<uint4>(ws_tab, to);

  tdt::barrier_all<false, true>(fl_tab, me, n, epoch, g == 0);
  straggle(me, lag_rank, lag_ns);

  for (int s = 0; s < n - 1; ++s) {
    const int c = dir ? (me + 1 + s) % n : (me - 1 - s + 2 * n) % n;
    warp_add_put<T>(ws_to + s * cnt, x + c * cnt,
                    s > 0 ? ws_me + (s - 1) * cnt : nullptr, slo, shi,
                    s > 0 ? flag_at(fl_tab, me, flag(s - 1)) : nullptr,
                    epoch);
    warp_signal(flag_at(fl_tab, to, flag(s)), epoch);
  }
  // The own chunk: the last received slot plus x's own contribution.
  warp_add_put<T>(tdt::rank_ptr<uint4>(O, me), x + me * cnt,
                  ws_me + (n - 2) * cnt, slo, shi,
                  flag_at(fl_tab, me, flag(n - 2)), epoch);
}

// ---- all-reduce ------------------------------------------------------------

// One-shot: every rank puts x into slot me of every peer, then sums its n
// slots (its own read from x) in f32 in rank order. Flags: n + src * G + g.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ar_one_shot_kernel(RankPtrs X, RankPtrs O, const int64_t* ws_tab,
                   const int64_t* fl_tab, long long numel, int n,
                   uint64_t epoch, int lag_rank, long long lag_ns) {
  constexpr int N = Lanes<T>::N;
  const int me = blockIdx.y, g = blockIdx.x, G = gridDim.x;
  long long lo, hi;
  piece_of(numel, g, G, lo, hi);
  const T* x = tdt::rank_ptr<const T>(X, me);
  tdt::barrier_all(fl_tab, me, n, epoch, g == 0);
  straggle(me, lag_rank, lag_ns);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  for (int p = 1; p < n; ++p) {
    uint4* slot = reinterpret_cast<uint4*>(
                      tdt::symm_ptr<T>(ws_tab, (me + p) % n)) +
                  me * numel;
    for (long long v = lo + threadIdx.x; v < hi; v += blockDim.x)
      slot[v] = xv[v];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    for (int p = 1; p < n; ++p)
      tdt::st_release_sys(flag_at(fl_tab, (me + p) % n, n + me * G + g),
                          epoch);
    for (int p = 1; p < n; ++p)
      tdt::wait_until(flag_at(fl_tab, me, n + ((me + p) % n) * G + g),
                      epoch);
  }
  __syncthreads();
  const T* ws = tdt::symm_ptr<const T>(ws_tab, me);
  T* o = tdt::rank_ptr<T>(O, me);
  for (long long v = lo + threadIdx.x; v < hi; v += blockDim.x) {
    float acc[N];
    if (me == 0)
      load<T, false>(x, v, acc);
    else
      load<T, true>(ws, v, acc);
    for (int src = 1; src < n; ++src) {
      if (src == me)
        add<T, false>(x, v, acc);
      else
        add<T, true>(ws, src * numel + v, acc);
    }
    store<T>(o, v, acc);
  }
}

// Recursive doubling (n a power of two): in round k the running sum
// x + r_0 + ... + r_{k-1} (f32, in that order) rounded to T goes to slot k
// of partner me ^ 2^k; the output is x + r_0 + ... + r_{lg-1} rounded.
// Block g owns piece g of x, cut into one flagged sub-piece a warp
// (kRingWarps of them), and each sub-piece runs its lg rounds at its own
// pace: the warp stores its rounded running sum into the partner's slot k,
// releases the partner's flag (k, g, w), acquires its own and adds the
// received slot (ld.cg). A sub-piece of at most one stripe (32 x kHeld
// vectors) keeps its running sum in registers across the rounds; a larger
// one (a grid capped below the bytes) is walked in stripes, each rebuilt
// from x and the slots received so far in the same order, so both give
// the same bits. Every flag and the entry barrier are device scope (one
// launch covers every rank). Flags of rank r: [0, n) the barrier, then
// n + (k * G + g) * W + w, set by round k's partner.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ar_doubling_kernel(RankPtrs X, RankPtrs O, const int64_t* ws_tab,
                   const int64_t* fl_tab, long long numel, int n,
                   uint64_t epoch, int lag_rank, long long lag_ns) {
  constexpr int N = Lanes<T>::N, W = kRingWarps, U = kHeld;
  const int me = blockIdx.y, g = blockIdx.x, G = gridDim.x;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lg = 31 - __clz(n);
  long long slo, shi;
  sub_piece_of(numel, g, G, w, slo, shi);
  const bool held = shi - slo <= 32 * U;
  auto flag = [&](int k) {
    return n + (static_cast<long long>(k) * G + g) * W + w;
  };
  const T* x = tdt::rank_ptr<const T>(X, me);
  const T* ws = tdt::symm_ptr<const T>(ws_tab, me);
  float acc[U][N];
  // acc = x + r_0 + ... + r_{k-1} over the lane's vectors of the stripe
  // at v (v + 32u), in that order.
  auto build = [&](long long v, int k) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (v + 32 * u < shi) load<T, false>(x, v + 32 * u, acc[u]);
    for (int j = 0; j < k; ++j) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (v + 32 * u < shi) add<T, true>(ws, j * numel + v + 32 * u, acc[u]);
    }
  };

  if (held) build(slo + lane, 0);
  tdt::barrier_all<false, true>(fl_tab, me, n, epoch, g == 0);
  straggle(me, lag_rank, lag_ns);
  for (int k = 0; k < lg; ++k) {
    const int partner = me ^ (1 << k);
    T* dst = tdt::symm_ptr<T>(ws_tab, partner);
    for (long long v = slo + lane; v - lane < shi; v += 32 * U) {
      if (!held) build(v, k);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (v + 32 * u < shi) store<T>(dst, k * numel + v + 32 * u, acc[u]);
    }
    warp_signal(flag_at(fl_tab, partner, flag(k)), epoch);
    warp_wait(flag_at(fl_tab, me, flag(k)), epoch);
    if (held) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (slo + lane + 32 * u < shi)
          add<T, true>(ws, k * numel + slo + lane + 32 * u, acc[u]);
    }
  }
  T* o = tdt::rank_ptr<T>(O, me);
  for (long long v = slo + lane; v - lane < shi; v += 32 * U) {
    if (!held) build(v, lg);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (v + 32 * u < shi) store<T>(o, v + 32 * u, acc[u]);
  }
}

// ---- byte movers: shift, broadcast, pull and torus gathers, LL gather -------

// The block copies `bytes` from s to d, every load through L2: a peer may
// have written s in this launch, and a neighbouring piece read earlier
// may have left a stale line of it in this SM's L1. 16-byte vectors where
// both ends are aligned, bytes for the rest (any row width).
__device__ __forceinline__ void copy_bytes(char* d, const char* s,
                                     long long bytes) {
  long long head = 0;
  if (((reinterpret_cast<uintptr_t>(d) | reinterpret_cast<uintptr_t>(s)) &
       15) == 0) {
    const long long nv = bytes / 16;
    uint4* dv = reinterpret_cast<uint4*>(d);
    const uint4* sv = reinterpret_cast<const uint4*>(s);
    for (long long i = threadIdx.x; i < nv; i += blockDim.x)
      dv[i] = __ldcg(sv + i);
    head = nv * 16;
  }
  for (long long i = head + threadIdx.x; i < bytes; i += blockDim.x)
    d[i] = __ldcg(s + i);
}

__device__ __forceinline__ void fill_zero(char* d, long long bytes) {
  long long head = 0;
  if ((reinterpret_cast<uintptr_t>(d) & 15) == 0) {
    const long long nv = bytes / 16;
    uint4* dv = reinterpret_cast<uint4*>(d);
    for (long long i = threadIdx.x; i < nv; i += blockDim.x)
      dv[i] = make_uint4(0, 0, 0, 0);
    head = nv * 16;
  }
  for (long long i = head + threadIdx.x; i < bytes; i += blockDim.x) d[i] = 0;
}

// Pipeline shift (p2p.py _shift_kernel): rank me's shard lands in rank
// me + 1's output (rank 0 receives rank n - 1's with wrap, zeros without).
// Flags of rank r: [0, n) the barrier, n + g piece g from rank r - 1.
__global__ void __launch_bounds__(kThreads)
shift_kernel(RankPtrs X, RankPtrs O, const int64_t* fl_tab, long long bytes,
             int n, int wrap, uint64_t epoch) {
  const int me = blockIdx.y, g = blockIdx.x, G = gridDim.x;
  long long lo, hi;
  byte_piece(0, bytes, g, G, lo, hi);
  tdt::barrier_all(fl_tab, me, n, epoch, g == 0);
  if (wrap || me < n - 1) {
    const int nxt = (me + 1) % n;
    copy_bytes(tdt::rank_ptr<char>(O, nxt) + lo,
               tdt::rank_ptr<const char>(X, me) + lo, hi - lo);
    block_signal(flag_at(fl_tab, nxt, n + g), epoch);
  }
  if (wrap || me > 0)
    block_wait(flag_at(fl_tab, me, n + g), epoch);
  else
    fill_zero(tdt::rank_ptr<char>(O, me) + lo, hi - lo);
}

// One-shot broadcast (broadcast.py _one_shot_bcast_kernel): the root's x
// into every rank's output. Flags of rank r: [0, n) the barrier, n + g.
__global__ void __launch_bounds__(kThreads)
bcast_kernel(RankPtrs X, RankPtrs O, const int64_t* fl_tab, long long bytes,
             int n, int root, uint64_t epoch) {
  const int me = blockIdx.y, g = blockIdx.x, G = gridDim.x;
  long long lo, hi;
  byte_piece(0, bytes, g, G, lo, hi);
  tdt::barrier_all(fl_tab, me, n, epoch, g == 0);
  if (me != root) {
    block_wait(flag_at(fl_tab, me, n + g), epoch);
    return;
  }
  const char* x = tdt::rank_ptr<const char>(X, root) + lo;
  for (int p = 0; p < n; ++p)
    copy_bytes(tdt::rank_ptr<char>(O, (root + p) % n) + lo, x, hi - lo);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    for (int p = 1; p < n; ++p)
      tdt::st_release_sys(flag_at(fl_tab, (root + p) % n, n + g), epoch);
  }
}

// Pull gather (all_gather.py _pull_kernel), no barrier: block 0 raises the
// rank's "entered" flag (its flag 0: its shard is final, the rendezvous of
// dl.request / dl.serve_get); lane j = g % w of the grid reads sources
// me+1+j, me+1+j+w, ... in turn, each after its flag, into the own output.
__global__ void __launch_bounds__(kThreads)
pull_kernel(RankPtrs X, RankPtrs O, const int64_t* fl_tab, long long bytes,
            int n, int window, uint64_t epoch) {
  const int me = blockIdx.y, g = blockIdx.x, G = gridDim.x;
  const int w = min(max(window, 1), n - 1);
  char* o = tdt::rank_ptr<char>(O, me);
  if (g == 0) block_signal(flag_at(fl_tab, me, 0), epoch);
  long long lo, hi;
  byte_piece(0, bytes, g, G, lo, hi);
  copy_bytes(o + me * bytes + lo, tdt::rank_ptr<const char>(X, me) + lo,
             hi - lo);
  const int j = g % w;
  byte_piece(0, bytes, g / w, (G - j + w - 1) / w, lo, hi);
  for (int k = 1 + j; k < n; k += w) {
    const int src = (me + k) % n;
    block_wait(flag_at(fl_tab, src, 0), epoch);
    copy_bytes(o + src * bytes + lo, tdt::rank_ptr<const char>(X, src) + lo,
               hi - lo);
  }
}

// Fused 2-D torus gather (all_gather.py _torus_2d_kernel) over nx x ny
// ranks, rank mx * ny + my; slot s of every output holds rank s's shard.
// Flags of rank r: [0, n) the barrier, n + s * G + g slot s's piece g.
__global__ void __launch_bounds__(kThreads)
torus_kernel(RankPtrs X, RankPtrs O, const int64_t* fl_tab, long long bytes,
             int n, int ny, uint64_t epoch) {
  const int me = blockIdx.y, g = blockIdx.x, G = gridDim.x;
  const int nx = n / ny, mx = me / ny, my = me % ny;
  long long lo, hi;
  byte_piece(0, bytes, g, G, lo, hi);
  const char* x = tdt::rank_ptr<const char>(X, me) + lo;
  char* o_me = tdt::rank_ptr<char>(O, me);
  auto col = [&](int q) { return mx * ny + (my + q) % ny; };
  auto row = [&](int p) { return ((mx + p) % nx) * ny + my; };

  copy_bytes(o_me + me * bytes + lo, x, hi - lo);
  tdt::barrier_all(fl_tab, me, n, epoch, g == 0);
  // The own chunk along the column and along the row.
  for (int q = 1; q < ny; ++q)
    copy_bytes(tdt::rank_ptr<char>(O, col(q)) + me * bytes + lo, x,
               hi - lo);
  for (int p = 1; p < nx; ++p)
    copy_bytes(tdt::rank_ptr<char>(O, row(p)) + me * bytes + lo, x,
               hi - lo);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    for (int q = 1; q < ny; ++q)
      tdt::st_release_sys(flag_at(fl_tab, col(q), n + me * G + g), epoch);
    for (int p = 1; p < nx; ++p)
      tdt::st_release_sys(flag_at(fl_tab, row(p), n + me * G + g), epoch);
  }
  // Each column chunk forwarded along the row as it arrives.
  for (int q = 1; q < ny; ++q) {
    const int src = col(q);
    block_wait(flag_at(fl_tab, me, n + src * G + g), epoch);
    if (nx == 1) continue;
    for (int p = 1; p < nx; ++p)
      copy_bytes(tdt::rank_ptr<char>(O, row(p)) + src * bytes + lo,
                 o_me + src * bytes + lo, hi - lo);
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence_system();
      for (int p = 1; p < nx; ++p)
        tdt::st_release_sys(flag_at(fl_tab, row(p), n + src * G + g), epoch);
    }
  }
  // The row arrivals: every slot of the other rows.
  if (threadIdx.x == 0)
    for (int p = 1; p < nx; ++p)
      for (int t = 0; t < ny; ++t)
        tdt::wait_until(
            flag_at(fl_tab, me, n + (((mx + p) % nx) * ny + t) * G + g),
            epoch);
}

// Low-latency gather (low_latency.py _ll_ag_kernel) over the persistent
// symmetric slots ws [2][n][bytes] a rank. Block g owns piece g of the
// shard, cut into one sub-piece a warp (kRingWarps of them), and each
// warp runs the whole discipline for its sub-piece on its own flags: wait
// the n - 1 ACKs of slot p (one lane a peer, at once), push into the n - 1
// peers' slot (p, me) in one pass, release the n - 1 arrival flags, copy
// its own shard while they travel, wait the n - 1 arrivals (a lane each),
// copy them out in one pass and release the n - 1 ACKs. One launch covers
// every rank, so every flag is device scope and no fence is system-wide.
// Flags of rank r (values: the caller's phase + 1): [0, n) the barrier
// (barrier_free 0); then n + ((p * n + src) * G + g) * W + w: src's
// sub-piece (g, w) arrived in slot p; then
// n + 2 * n * G * W + ((p * n + c) * G + g) * W + w: consumer c's ACK of
// r's sub-piece (g, w) in slot p.
__global__ void __launch_bounds__(kThreads)
ll_ag_kernel(RankPtrs X, RankPtrs O, const int64_t* ws_tab,
             const int64_t* fl_tab, long long bytes, int n, uint64_t phase,
             int barrier_free) {
  constexpr int W = kRingWarps;
  const int me = blockIdx.y, g = blockIdx.x, G = gridDim.x;
  const int w = threadIdx.x / 32;
  const int p = static_cast<int>(phase & 1);
  const uint64_t v = phase + 1;
  const long long gw = static_cast<long long>(G) * W;
  const long long sub = static_cast<long long>(g) * W + w;
  auto arr = [&](int src) { return n + (p * n + src) * gw + sub; };
  auto ack = [&](int c) { return n + (2 * n + p * n + c) * gw + sub; };
  auto peer = [&](int q) { return (me + 1 + q) % n; };
  long long lo, hi, slo, shi;
  byte_piece(0, bytes, g, G, lo, hi);
  byte_piece(lo, hi, w, W, slo, shi);
  const long long len = shi - slo;
  const char* x = tdt::rank_ptr<const char>(X, me) + slo;
  char* o = tdt::rank_ptr<char>(O, me) + slo;
  const char* ws = tdt::symm_ptr<const char>(ws_tab, me) + slo;
  const bool vec = ((bytes | reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(o) |
                     reinterpret_cast<uintptr_t>(ws)) & 15) == 0;
  const long long mine = (static_cast<long long>(p) * n + me) * bytes;

  if (barrier_free) {
    // Slot p's use at phase - 2 consumed by every peer before overwriting.
    if (phase >= 2)
      warp_wait_k(n - 1, [&](int q) {
        return flag_at(fl_tab, me, ack(peer(q)));
      }, phase - 1);
  } else {
    tdt::barrier_all<false, true>(fl_tab, me, n, v, g == 0);
  }
  // Push into every peer's persistent slot (p, me), then the arrivals.
  warp_copy_k(n - 1, len, vec, [&](int) { return x; }, [&](int q) {
    return tdt::symm_ptr<char>(ws_tab, peer(q)) + mine + slo;
  });
  warp_signal_k(n - 1, [&](int q) {
    return flag_at(fl_tab, peer(q), arr(me));
  }, v);
  // The own shard while the peers' arrive.
  warp_copy_k(1, len, vec, [&](int) { return x; },
              [&](int) { return o + me * bytes; });
  // Wait the n - 1 arrivals of slot p, assemble, ACK every producer.
  warp_wait_k(n - 1, [&](int q) {
    return flag_at(fl_tab, me, arr(peer(q)));
  }, v);
  warp_copy_k(n - 1, len, vec, [&](int q) {
    return ws + (static_cast<long long>(p) * n + peer(q)) * bytes;
  }, [&](int q) { return o + peer(q) * bytes; });
  warp_signal_k(n - 1, [&](int q) {
    return flag_at(fl_tab, peer(q), ack(me));
  }, v);
}

// ---- launch ----------------------------------------------------------------

const void* move_fn(int kind) {
  switch (kind) {
    case 0: return reinterpret_cast<const void*>(&shift_kernel);
    case 1: return reinterpret_cast<const void*>(&bcast_kernel);
    case 2: return reinterpret_cast<const void*>(&pull_kernel);
    case 3: return reinterpret_cast<const void*>(&torus_kernel);
    default: return nullptr;
  }
}

const void* ag_fn(int kind) {
  switch (kind) {
    case 0: return reinterpret_cast<const void*>(&full_mesh_kernel);
    case 1: return reinterpret_cast<const void*>(&ag_ring_kernel<false>);
    case 2: return reinterpret_cast<const void*>(&ag_ring_kernel<true>);
    default: return nullptr;
  }
}

template <typename T>
const void* rs_fn_t(int kind) {
  switch (kind) {
    case 0: return reinterpret_cast<const void*>(&rs_one_shot_kernel<T>);
    case 1:
    case 3: return reinterpret_cast<const void*>(&rs_ring_kernel<T, false>);
    case 2: return reinterpret_cast<const void*>(&rs_ring_kernel<T, true>);
    default: return nullptr;
  }
}

const void* rs_fn(int kind, int dtype) {
  return dtype == 0 ? rs_fn_t<float>(kind)
                    : dtype == 1 ? rs_fn_t<__nv_bfloat16>(kind) : nullptr;
}

template <typename T>
const void* ar_fn_t(int kind) {
  switch (kind) {
    case 0: return reinterpret_cast<const void*>(&ar_one_shot_kernel<T>);
    case 1: return reinterpret_cast<const void*>(&ar_doubling_kernel<T>);
    default: return nullptr;
  }
}

const void* ar_fn(int kind, int dtype) {
  return dtype == 0 ? ar_fn_t<float>(kind)
                    : dtype == 1 ? ar_fn_t<__nv_bfloat16>(kind) : nullptr;
}

// One cooperative launch of fn over n ranks; a grid that cannot be
// co-resident is refused before launching. Returns the CUDA error.
int coop_launch(const void* fn, int n, int blocks, void** args,
                void* stream) {
  if (fn == nullptr || n < 2 || n > tdt::kMaxRanks || blocks < 1)
    return cudaErrorInvalidValue;
  if (n * blocks > tdt::capacity(fn, kThreads))
    return cudaErrorCooperativeLaunchTooLarge;
  cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(blocks, n), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Co-resident blocks of a kernel: family 0 all-gather, 1 reduce-scatter,
// 2 all-reduce, 3 the byte movers of tdt_move_launch, 4 the low-latency
// gather; kind and dtype (0 f32, 1 bf16) as in the launches.
int tdt_collective_capacity(int family, int kind, int dtype) {
  const void* fn =
      family == 0   ? ag_fn(kind)
      : family == 1 ? rs_fn(kind, dtype)
      : family == 2 ? ar_fn(kind, dtype)
      : family == 3 ? move_fn(kind)
      : family == 4 ? reinterpret_cast<const void*>(&ll_ag_kernel)
                    : nullptr;
  return fn == nullptr ? 0 : tdt::capacity(fn, kThreads);
}

// The byte movers over n co-located ranks, x[r] and o[r] of `bytes` a
// shard: kind 0 the pipeline shift (arg: wrap), 1 the one-shot broadcast
// (arg: root), 2 the pull gather (arg: window; o[r] n shards, at least
// min(window, n - 1) blocks a rank), 3 the 2-D torus gather over
// n / arg x arg ranks (arg: the inner size; o[r] n shards).
int tdt_move_launch(int kind, const int64_t* x, const int64_t* o,
                    const int64_t* fl_tab, int n, long long bytes, int arg,
                    unsigned long long epoch, int blocks_per_rank,
                    void* stream) {
  if (bytes < 0 || (kind == 1 && (arg < 0 || arg >= n)) ||
      (kind == 2 && blocks_per_rank < (arg < n - 1 ? (arg < 1 ? 1 : arg)
                                                   : n - 1)) ||
      (kind == 3 && (arg < 1 || n % arg)))
    return cudaErrorInvalidValue;
  RankPtrs px = tdt::to_ptrs(x, n), po = tdt::to_ptrs(o, n);
  uint64_t ep = epoch;
  void* args[] = {&px, &po, &fl_tab, &bytes, &n, &arg, &ep};
  return coop_launch(move_fn(kind), n, blocks_per_rank, args, stream);
}

// The low-latency gather: x[r] (`bytes`) into o[r] at r * bytes through
// the symmetric slots ws_tab ([2][n][bytes] a rank) and flags fl_tab
// (n + 4 * n * blocks_per_rank * kRingWarps a rank, zeroed once,
// blocks_per_rank fixed for the workspace), at the caller's phase counter.
int tdt_ll_all_gather_launch(const int64_t* x, const int64_t* o,
                             const int64_t* ws_tab, const int64_t* fl_tab,
                             int n, long long bytes, unsigned long long phase,
                             int barrier_free, int blocks_per_rank,
                             void* stream) {
  if (bytes < 0) return cudaErrorInvalidValue;
  RankPtrs px = tdt::to_ptrs(x, n), po = tdt::to_ptrs(o, n);
  uint64_t ph = phase;
  void* args[] = {&px, &po, &ws_tab, &fl_tab, &bytes, &n, &ph,
                  &barrier_free};
  return coop_launch(reinterpret_cast<const void*>(&ll_ag_kernel), n,
                     blocks_per_rank, args, stream);
}

// All-gather over n co-located ranks: x[r] (shard_bytes each) to every
// o[*] at offset r * shard_bytes. kind 0 full mesh, 1 ring, 2 bidir ring
// (bytes from half_bytes on go counter-clockwise).
int tdt_all_gather_launch(int kind, const int64_t* x, const int64_t* o,
                          const int64_t* fl_tab, int n,
                          long long shard_bytes, long long half_bytes,
                          unsigned long long epoch, int blocks_per_rank,
                          void* stream) {
  RankPtrs px = tdt::to_ptrs(x, n), po = tdt::to_ptrs(o, n);
  uint64_t ep = epoch;
  void* args[] = {&px, &po, &fl_tab, &shard_bytes, &half_bytes, &n, &ep};
  return coop_launch(ag_fn(kind), n, blocks_per_rank, args, stream);
}

// Reduce-scatter: x[r] holds n chunks of `cnt` elements, o[r] receives
// the reduced chunk r. kind 0 one-shot, 1 ring, 2 bidir ring (elements
// from `half` on go counter-clockwise), 3 HBM ring (the ring's kernel: its
// sub-pieces are finer than the JAX row tiles). ws_tab: the symmetric
// workspace (n or n - 1 chunks a rank). lag_rank >= 0 lags that rank's
// blocks lag_ns before their first put.
int tdt_reduce_scatter_launch(int kind, int dtype, const int64_t* x,
                              const int64_t* o, const int64_t* ws_tab,
                              const int64_t* fl_tab, int n, long long cnt,
                              long long half, unsigned long long epoch,
                              int blocks_per_rank, int lag_rank,
                              long long lag_ns, void* stream) {
  const long long lanes = dtype == 0 ? 4 : 8;
  if (cnt % lanes || half % lanes || half > cnt)
    return cudaErrorInvalidValue;
  long long cv = cnt / lanes, hv = half / lanes;
  RankPtrs px = tdt::to_ptrs(x, n), po = tdt::to_ptrs(o, n);
  uint64_t ep = epoch;
  void* args[] = {&px, &po, &ws_tab, &fl_tab, &cv, &hv,
                  &n, &ep, &lag_rank, &lag_ns};
  return coop_launch(rs_fn(kind, dtype), n, blocks_per_rank, args, stream);
}

// All-reduce of x[r] (numel elements each) into every o[r]: kind 0
// one-shot (ws: n x numel a rank), 1 recursive doubling (log2 n x numel).
int tdt_all_reduce_launch(int kind, int dtype, const int64_t* x,
                          const int64_t* o, const int64_t* ws_tab,
                          const int64_t* fl_tab, int n, long long numel,
                          unsigned long long epoch, int blocks_per_rank,
                          int lag_rank, long long lag_ns, void* stream) {
  const long long lanes = dtype == 0 ? 4 : 8;
  if (numel % lanes || (kind == 1 && (n & (n - 1))))
    return cudaErrorInvalidValue;
  long long nv = numel / lanes;
  RankPtrs px = tdt::to_ptrs(x, n), po = tdt::to_ptrs(o, n);
  uint64_t ep = epoch;
  void* args[] = {&px, &po, &ws_tab, &fl_tab, &nv, &n, &ep, &lag_rank,
                  &lag_ns};
  return coop_launch(ar_fn(kind, dtype), n, blocks_per_rank, args, stream);
}

}  // extern "C"
