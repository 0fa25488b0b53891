// Device-side communication primitives of the port's cross-rank kernels.
//
// Counterpart of triton_distributed_tpu/language/primitives.py: `put`
// (a block's vector copy into a peer's buffer), `signal` (a flag store
// with release semantics), `wait_until` (:186, an acquire spin),
// `put_signal` (:257) and `barrier_all` (:342).
//
// Ranks address each other's buffers through pointer tables: a kernel
// takes the table of its operands (RankPtrs, by value) or of a symmetric
// allocation (an int64 table on the device) and a rank, never a base plus
// a stride. Today every rank lives on one card; a table of CUDA-IPC or
// symmetric-memory pointers moves them to separate cards unchanged.
//
// Signals: one uint64 flag per (site, slot) per rank. Each launch carries
// a host epoch that goes up by one per launch, and a wait spins until
// flag >= epoch, so flags are never reset. Stores are st.release.sys and
// loads ld.acquire.sys (system scope: the same code is right across
// cards); a block publishes its threads' writes with __syncthreads, then
// thread 0 fences at system scope and stores the flag (the cooperative
// groups grid-barrier pattern). gemm_ar, the ring all-gathers, the ring
// and one-shot reduce-scatters, the doubling all-reduce and the
// low-latency gather take device scope instead (see st_release_gpu).
// Data a peer wrote is read with ld.cg (L2, never a
// stale L1 line of an earlier launch).
//
// Every wait traps after kWaitTimeoutNs: a lost block or a protocol
// error then fails the launch instead of hanging the card.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstdio>

namespace tdt {

// Co-located ranks one launch may cover.
constexpr int kMaxRanks = 8;
constexpr unsigned long long kWaitTimeoutNs = 10ull * 1000 * 1000 * 1000;

// Per-rank operand pointers, passed by value in the launch.
struct RankPtrs {
  const void* p[kMaxRanks];
};

template <typename T>
__device__ __forceinline__ T* rank_ptr(const RankPtrs& t, int r) {
  return reinterpret_cast<T*>(const_cast<void*>(t.p[r]));
}

// Rank r's slot of a symmetric allocation (device pointer table).
template <typename T>
__device__ __forceinline__ T* symm_ptr(const int64_t* table, int r) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(table[r]));
}

__device__ __forceinline__ void st_release_sys(uint64_t* p, uint64_t v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t ld_acquire_sys(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Words that only the blocks of one launch on one card touch: the same
// discipline at device scope, without the fence. gemm_ar (overlap.cu, both
// builds) takes it for all of its flags, since its one cooperative launch
// covers every rank. On an H100 80GB HBM3 (700 W) a device-scope
// flag round trip between two blocks took 1.5 us against 3.8 at system
// scope, and a __threadfence_system() 2.2 us (perf/flag_latency.cu).
__device__ __forceinline__ void st_release_gpu(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t ld_acquire_gpu(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

template <bool kGpu>
__device__ __forceinline__ uint64_t ld_acquire(const uint64_t* p) {
  if constexpr (kGpu)
    return ld_acquire_gpu(p);
  else
    return ld_acquire_sys(p);
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Called by ONE thread after the block's __syncthreads: every write the
// block made before the barrier is visible before the flag reads epoch.
__device__ __forceinline__ void signal(uint64_t* flag, uint64_t epoch) {
  __threadfence_system();
  st_release_sys(flag, epoch);
}

// Spin (one thread) until *flag >= epoch; trap after kWaitTimeoutNs,
// printing the flag first unless kQuiet. A kernel that issues wgmma takes
// kQuiet: any call (printf's vprintf) in it makes ptxas serialize its
// wgmmas (C7510). kGpu: a word released at device scope, acquired so.
template <bool kQuiet = false, bool kGpu = false>
__device__ __forceinline__ void wait_until(const uint64_t* flag,
                                           uint64_t epoch) {
  if (ld_acquire<kGpu>(flag) >= epoch) return;
  const uint64_t t0 = global_ns();
  while (ld_acquire<kGpu>(flag) < epoch) {
    __nanosleep(64);
    if (global_ns() - t0 > kWaitTimeoutNs) {
      if constexpr (!kQuiet)
        printf("tdt wait_until timed out: flag %p at %llu, epoch %llu\n",
               flag, (unsigned long long)ld_acquire<kGpu>(flag),
               (unsigned long long)epoch);
      __trap();
    }
  }
}

// Thread 0 of the block spins `ns` nanoseconds, then the block goes on: the
// lagging-rank fixtures (JAX straggle_if_rank / maybe_delay after the entry
// barrier, before a rank's puts).
__device__ __forceinline__ void spin_ns(long long ns) {
  if (ns <= 0) return;
  if (threadIdx.x == 0) {
    const uint64_t t0 = global_ns();
    while (global_ns() - t0 < static_cast<uint64_t>(ns)) __nanosleep(1000);
  }
  __syncthreads();
}

// The block copies `bytes` from src to dst (16-byte vectors where both
// are aligned, bytes for the rest). The caller publishes with
// __syncthreads + signal.
__device__ __forceinline__ void put(void* dst, const void* src,
                                    size_t bytes) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  size_t head = 0;
  if (((reinterpret_cast<uintptr_t>(d) | reinterpret_cast<uintptr_t>(s)) &
       15) == 0) {
    const size_t nv = bytes / 16;
    uint4* dv = reinterpret_cast<uint4*>(d);
    const uint4* sv = reinterpret_cast<const uint4*>(s);
    for (size_t i = threadIdx.x; i < nv; i += blockDim.x)
      dv[i] = __ldcg(sv + i);
    head = nv * 16;
  }
  for (size_t i = head + threadIdx.x; i < bytes; i += blockDim.x)
    d[i] = s[i];
}

// put, then (all threads' copies done) one flag store on the peer.
__device__ __forceinline__ void put_signal(void* dst, const void* src,
                                           size_t bytes, uint64_t* flag,
                                           uint64_t epoch) {
  put(dst, src, bytes);
  __syncthreads();
  if (threadIdx.x == 0) signal(flag, epoch);
}

// Entry barrier over the ranks of one launch (flags[0, n) of each rank):
// block 0 of rank `me` announces its arrival to every rank, and every
// block waits until all n ranks have arrived before touching a peer's
// buffer. One launch covers all co-located ranks, so this costs little;
// it is what separate launches per rank will need. kGpu: the same at
// device scope (__threadfence, st.release.gpu, ld.acquire.gpu), for a
// kernel whose one launch covers every rank on one card (the ring
// all-gathers, the ring and one-shot reduce-scatters, the doubling
// all-reduce, the low-latency gather's variant with a barrier).
template <bool kQuiet = false, bool kGpu = false>
__device__ __forceinline__ void barrier_all(const int64_t* flag_tab, int me,
                                            int n, uint64_t epoch,
                                            bool announce) {
  if (threadIdx.x == 0) {
    if (announce) {
      if constexpr (kGpu) {
        __threadfence();
        for (int p = 0; p < n; ++p)
          st_release_gpu(symm_ptr<uint64_t>(flag_tab, p) + me, epoch);
      } else {
        __threadfence_system();
        for (int p = 0; p < n; ++p)
          st_release_sys(symm_ptr<uint64_t>(flag_tab, p) + me, epoch);
      }
    }
    const uint64_t* mine = symm_ptr<uint64_t>(flag_tab, me);
    for (int src = 0; src < n; ++src)
      wait_until<kQuiet, kGpu>(mine + src, epoch);
  }
  __syncthreads();
}

// Blocks of `fn` (threads a block, its static shared memory and
// dyn_smem bytes of dynamic shared memory) that can be co-resident on the
// current device: the most a cooperative launch takes.
inline int capacity(const void* fn, int threads, size_t dyn_smem = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                    dyn_smem) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

// Host table of n device pointers (ints) as a by-value RankPtrs.
inline RankPtrs to_ptrs(const int64_t* p, int n) {
  RankPtrs t{};
  for (int r = 0; r < n && r < kMaxRanks; ++r)
    t.p[r] = reinterpret_cast<const void*>(static_cast<uintptr_t>(p[r]));
  return t;
}

}  // namespace tdt
