// What a cross-rank kernel's synchronisation costs on one NVIDIA GPU: the
// launch floor, a flag round trip between two blocks at system and at
// device scope (with and without a fence before each store), and one
// fence after a store.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/flag_latency \
//       perf/flag_latency.cu && build/flag_latency
//
// Prints one line a measurement (CUDA-event time over 100 launches or
// 1000 round trips / fences). From these numbers gemm_ar (both builds,
// csrc/overlap.cu) publishes every flag, cross-rank puts included, with a
// device-scope release store after the block's barrier and no fence: its
// one cooperative launch covers every rank, all on one card. The other
// cross-rank kernels keep tdt_comm.cuh's system-scope discipline
// (__threadfence_system() and st.release.sys), written for ranks whose
// pointer tables may reach other cards.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstdio>

__device__ __forceinline__ void st_release(uint64_t* p, uint64_t v,
                                           bool sys) {
  if (sys)
    asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
  else
    asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
}

__device__ __forceinline__ uint64_t ld_acquire(const uint64_t* p, bool sys) {
  uint64_t v;
  if (sys)
    asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
                 : "=l"(v)
                 : "l"(p)
                 : "memory");
  else
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                 : "=l"(v)
                 : "l"(p)
                 : "memory");
  return v;
}

__global__ void empty_kernel(int) {}

// Blocks 0 and 1 pass a flag back and forth `iters` times: block 0 stores
// f[0] and waits for f[1], block 1 waits for f[0] and stores f[1]. fence:
// 0 none, 1 __threadfence_system(), 2 __threadfence() before each store.
__global__ void ping_pong(uint64_t* f, int iters, bool sys, int fence,
                          uint64_t base) {
  if (threadIdx.x != 0) return;
  const int me = blockIdx.x;
  for (int i = 1; i <= iters; ++i) {
    const uint64_t v = base + i;
    if (me == 1)
      while (ld_acquire(f, sys) < v) {
      }
    if (fence == 1) __threadfence_system();
    if (fence == 2) __threadfence();
    st_release(f + me, v, sys);
    if (me == 0)
      while (ld_acquire(f + 1, sys) < v) {
      }
  }
}

__global__ void store_fence(uint64_t* sink, int iters, bool sys) {
  if (threadIdx.x != 0) return;
  for (int i = 0; i < iters; ++i) {
    sink[blockIdx.x] = i;
    if (sys)
      __threadfence_system();
    else
      __threadfence();
  }
}

int main() {
  uint64_t* f = nullptr;
  if (cudaMalloc(&f, 4096) != cudaSuccess) return 1;
  cudaMemset(f, 0, 4096);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  float ms = 0.f;
  int zero = 0;
  void* args[] = {&zero};
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  for (int rep = 0; rep < 3; ++rep) {
    cudaEventRecord(a);
    for (int i = 0; i < 100; ++i) empty_kernel<<<1, 256>>>(0);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    cudaEventElapsedTime(&ms, a, b);
    printf("launch, empty kernel: %.2f us\n", ms * 10);
    cudaEventRecord(a);
    for (int i = 0; i < 100; ++i)
      cudaLaunchCooperativeKernel(reinterpret_cast<void*>(empty_kernel),
                                  dim3(2 * sms), dim3(256), args, 0, 0);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    cudaEventElapsedTime(&ms, a, b);
    printf("cooperative launch, %d blocks: %.2f us\n", 2 * sms, ms * 10);
  }
  const char* fences[] = {"no fence", "__threadfence_system()",
                          "__threadfence()"};
  uint64_t base = 0;
  const int iters = 1000;
  for (int sys = 1; sys >= 0; --sys)
    for (int fence = 0; fence < 3; ++fence) {
      cudaEventRecord(a);
      ping_pong<<<2, 32>>>(f, iters, sys, fence, base);
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      base += iters;
      cudaEventElapsedTime(&ms, a, b);
      printf("flag round trip, %s scope, %s before the store: %.3f us\n",
             sys ? "system" : "device", fences[fence], ms * 1000 / iters);
    }
  for (int sys = 1; sys >= 0; --sys) {
    cudaEventRecord(a);
    store_fence<<<sms, 32>>>(f + 64, iters, sys);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    cudaEventElapsedTime(&ms, a, b);
    printf("%s after a store: %.3f us\n",
           sys ? "__threadfence_system()" : "__threadfence()",
           ms * 1000 / iters);
  }
  const cudaError_t err = cudaGetLastError();
  printf("%s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
