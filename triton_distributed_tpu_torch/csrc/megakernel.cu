// The decode megakernel for Hopper (sm_90a): a whole greedy decode step of
// a dense Qwen3 at tp=1, or NS steps, as ONE persistent cooperative kernel
// walking a packed task table.
//
// Replaces: triton_distributed_tpu/megakernel/code_generator.py
// `make_mega_kernel` / `build_mega_call` (the one `pl.pallas_call` whose
// sequential grid (step, task) dispatches the bodies of
// triton_distributed_tpu/megakernel/kernels.py over a scalar-prefetched
// task table). Its ATTN body computes what the decode kernels of
// triton_distributed_tpu/ops/attention/flash_decode.py compute, plus the
// in-launch band and the token's own K/V.
//
// What it computes, per step, task by task in table order (the bodies
// this slice runs: EMBED, NORM, QKV_PROJ, ATTN, O_PROJ, FC1, FC2,
// ALLREDUCE at tp=1, LM_HEAD), over f32 state kept in a global workspace
// (x, h, qkv, ao, mlp), rounding where the TPU kernel rounds: every GEMM
// casts its f32 input to the weight dtype and accumulates in f32; the
// fused norms (no NORM tasks in the table) normalise inline; ATTN runs
// QK-norm, rope at kv_len + step, and one softmax over the cached rows
// (< kv_len, dense or through the page table), the launch's own rows of
// earlier steps (read back from knew/vnew in the cache dtype) and the
// token's own K/V (f32), so a row with kv_len 0 never divides by zero. The
// cache is never written: new rows leave as knew/vnew [NS, L, B, hkv, hd].
// LM_HEAD writes f32 logits over the padded vocab and, in multi-step
// launches, takes the argmax over the real columns (first occurrence on
// ties), feeds it to the next step's EMBED, writes toks [NS, B] and, under
// eos, the first step whose token is the row's stop token (stop_step [B],
// NS = never).
//
// What bounds it on the H100: bytes. A step reads every layer weight once
// (0.88 GB at Qwen3-0.6B in bf16), the LM head (0.31 GB) and every cached
// K/V row (114688 B per token over 28 layers); at small batch it does ~2
// FLOPs per weight byte per row, far under the ~295 FLOP/byte balance
// point, so the bound is those bytes / 3.35 TB/s.
//
// Design, correct and simple first. Every block walks the same table. A
// task is split into tiles over the blocks: 64 output columns by a K range
// for the GEMMs (split K when the columns alone would leave blocks idle;
// each split writes its own f32 partial and a second phase sums them in a
// fixed order, so results are bit-identical run to run: no float
// atomics; a batch wider than kGroupB rows runs each tile once per batch
// group of kGroupB rows, reading its weights once per group), (b, kv
// head, 128-token chunk) for the attention partials and
// (b, kv head) for their merge, 64-column vocab tiles for the LM head. A
// grid-wide barrier (one counter, every barrier adds exactly 2^31, so the
// counter is ready for the next launch whatever its value) sits between
// dependent phases, except between an elementwise phase and the next one
// that reads the same elements on the same threads (O_PROJ/FC2 sums →
// ALLREDUCE). The launch is cooperative, so every block is resident. Data
// written inside the kernel is read with ld.global.cg (L2), never through
// a possibly stale L1 line. The argmax is reduced per block, then across
// blocks by every block after a barrier. A tile-level scoreboard, TMA
// weight streams and wgmma are later work.
#include "tdt_common.cuh"

#include <math.h>

namespace {

using tdt::from_f32;
using tdt::round_to;
using tdt::to_f32;
using tdt::warp_max;
using tdt::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Batch rows one GEMM pass accumulates. 4 rather than 8: half the
// accumulator registers and staging, so two blocks fit an SM at every
// batch; on an H100 (perf/mega_batch_sweep.py) 4-row groups beat 8-row
// ones at B = 4, 8 and 16.
constexpr int kGroupB = 4;
constexpr int kTileN = 64;          // GEMM output columns per tile
constexpr int kColsPer = 8;         // consecutive columns per thread
constexpr int kColThreads = kTileN / kColsPer;       // 8
constexpr int kRowGroups = kThreads / kColThreads;   // 32
constexpr int kMaxSplit = 16;       // K splits of one GEMM at most
constexpr int kAttnChunk = 128;     // cached tokens per attention tile
constexpr int kMaxBlocksPerSM = 2;
constexpr int kMaxHd = 256;
constexpr int kMaxGroup = 8;
constexpr int kIdxNone = 0x7fffffff;
constexpr int kUnrollK = 4;         // weight rows in flight per thread
constexpr int kUnrollT = 4;         // cached tokens in flight per warp
constexpr int kUnrollPV = 8;        // V rows in flight per thread

// TaskType values (megakernel/task.py).
enum : int {
  kEmbed = 0, kNorm = 1, kQkv = 2, kAttn = 3, kOProj = 4, kFc1 = 5,
  kFc2 = 6, kAllReduce = 7, kLmHead = 8
};

struct Params {
  const void* embed; const void* wqkv; const void* wo; const void* w1;
  const void* w2; const void* lm_head; const void* ln1; const void* ln2;
  const void* normf; const void* qn; const void* kn;
  const void* kc; const void* vc;
  const int* page_table; const int* kv_len; const int* tokens;
  const int* stop_tok; const int* table; const float* inv_freq;
  float* logits; void* knew; void* vnew; int* toks; int* stop_step;
  unsigned* bar;
  // Workspace views (carved by the host entry).
  float* x; float* h; float* qkv; float* ao; float* mlp; float* part;
  float* attn; float* qs; float* kself; float* vself; float* argv;
  int* argi;
  int T, nsteps, B, d, hq, hkv, hd, f, v_pad, v_real, L, s_cap, page, pps,
      num_pages, fuse_norms, eos, vocab, argmax, nch;
  float eps, sm_scale;
};

// -- small helpers -----------------------------------------------------------

__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cg(const __nv_bfloat16* p) {
  return __bfloat162float(__ldcg(p));
}

// 8 consecutive weights (16/32-byte aligned), loaded raw on the
// read-only path and widened to f32 later, so a thread can keep several
// rows' loads in flight before it uses any.
template <typename W>
struct Raw8;
template <>
struct Raw8<__nv_bfloat16> {
  uint4 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void widen(float (&o)[8]) const {
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = __bfloat162float(e[i]);
  }
};
template <>
struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p + 4));
  }
  __device__ __forceinline__ void widen(float (&o)[8]) const {
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
};

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, o);
    int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// Grid-wide barrier. Block 0 adds 2^31 - (n - 1), every other block 1: the
// counter's top bit flips exactly when all n blocks have arrived, and each
// barrier adds 2^31 in total, so no reset is needed between barriers or
// launches. Writes before it are visible to every block after it. A
// barrier still open after ~2^35 cycles (over 10 s) traps: a launch that
// lost a block fails loudly instead of hanging the card.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned inc =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(bar, inc);
    volatile unsigned* vb = bar;
    const long long start = clock64();
    while (((old ^ *vb) & 0x80000000u) == 0) {
      __nanosleep(32);
      if (clock64() - start > (1LL << 35)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// rstd[b] = rsqrt(mean(x[b]^2) + eps) for the B rows of x [B, d].
__device__ void row_rstd(const float* x, int B, int d, float eps,
                         float* rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int b = warp; b < B; b += kWarps) {
    float s = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float v = __ldcg(x + (size_t)b * d + i);
      s += v * v;
    }
    s = warp_sum(s);
    if (lane == 0) rstd[b] = rsqrtf(s / (float)d + eps);
  }
  __syncthreads();
}

// Stage rows [k0, k1) of a GEMM input src [B, K] into xs [B][k1 - k0],
// rounded to the weight dtype; with normw, the inline RMS norm
// (src * rstd[b]) * normw[k] first.
template <typename W>
__device__ void stage_input(const float* src, int K, const W* normw,
                            const float* rstd, int B, int k0, int k1,
                            float* xs) {
  const int n = k1 - k0;
  for (int i = threadIdx.x; i < B * n; i += kThreads) {
    const int b = i / n, k = k0 + i % n;
    float v = __ldcg(src + (size_t)b * K + k);
    if (normw != nullptr) v = v * rstd[b] * to_f32(normw[k]);
    xs[i] = round_to<W>(v);
  }
  __syncthreads();
}

// One GEMM tile: out[b * ldo + n] = sum_{k0 <= k < k1} xs[b][k - k0] *
// w[k][n] for the 64 columns n0.. (clipped at N), every b < B <= kGroupB.
// 32 row groups x 8 column threads; each thread owns 8 columns (one
// 16-byte load in bf16) and strides over K, kUnrollK rows' loads in
// flight at a time; the row groups reduce with shuffles and then through
// shared memory in a fixed order. With `tile`, the sums are also left in
// shared memory tile[b][c].
template <typename W>
__device__ void gemm_tile(const W* __restrict__ w, int N, int n0, int k0,
                          int k1, const float* xs, int B, float* red,
                          float* out, int ldo, float* tile) {
  const int tid = threadIdx.x;
  const int ct = tid % kColThreads, rg = tid / kColThreads;
  const int col = n0 + ct * kColsPer;
  const int nk = k1 - k0;
  float acc[kGroupB][kColsPer];
#pragma unroll
  for (int b = 0; b < kGroupB; ++b)
#pragma unroll
    for (int j = 0; j < kColsPer; ++j) acc[b][j] = 0.f;
  if (col < N) {
    const W* wp = w + (size_t)k0 * N + col;
    for (int kk = rg; kk < nk; kk += kRowGroups * kUnrollK) {
      Raw8<W> raw[kUnrollK];
#pragma unroll
      for (int u = 0; u < kUnrollK; ++u)
        if (kk + u * kRowGroups < nk)
          raw[u].load(wp + (size_t)(kk + u * kRowGroups) * N);
#pragma unroll
      for (int u = 0; u < kUnrollK; ++u) {
        const int k = kk + u * kRowGroups;
        if (k < nk) {
          float wv[kColsPer];
          raw[u].widen(wv);
#pragma unroll
          for (int b = 0; b < kGroupB; ++b) {
            if (b < B) {
              const float xv = xs[b * nk + k];
#pragma unroll
              for (int j = 0; j < kColsPer; ++j)
                acc[b][j] = fmaf(xv, wv[j], acc[b][j]);
            }
          }
        }
      }
    }
  }
  // The 4 row groups of a warp sit 8 lanes apart.
#pragma unroll
  for (int b = 0; b < kGroupB; ++b) {
    if (b < B) {
#pragma unroll
      for (int j = 0; j < kColsPer; ++j) {
        float v = acc[b][j];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[b][j] = v;
      }
    }
  }
  const int lane = tid % 32, warp = tid / 32;
  if (lane < kColThreads) {
#pragma unroll
    for (int b = 0; b < kGroupB; ++b)
      if (b < B)
#pragma unroll
        for (int j = 0; j < kColsPer; ++j)
          red[(warp * kGroupB + b) * kTileN + lane * kColsPer + j] = acc[b][j];
  }
  __syncthreads();
  for (int i = tid; i < B * kTileN; i += kThreads) {
    const int b = i / kTileN, c = i % kTileN;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi)
      s += red[(wi * kGroupB + b) * kTileN + c];
    if (n0 + c < N) out[(size_t)b * ldo + n0 + c] = s;
    if (tile != nullptr) tile[i] = s;
  }
  __syncthreads();
}

// K splits of a GEMM with `ntiles` column tiles: double while blocks
// would sit idle and each split keeps >= 64 rows.
__device__ __forceinline__ int pick_split(int ntiles, int K) {
  int s = 1;
  while (s < kMaxSplit && ntiles * s < (int)gridDim.x && K / (2 * s) >= 64)
    s *= 2;
  return s;
}

// All tiles of src [B, K] @ w [K, N] over the blocks, each K split into
// its own partial part[s][B][N], each tile once per batch group.
template <typename W>
__device__ void gemm_partials(const W* w, int K, int N, int B, int S,
                              const float* src, const W* normw,
                              const float* rstd, float* part, float* xs,
                              float* red) {
  const int ntiles = (N + kTileN - 1) / kTileN;
  const int kchunk = (K + S - 1) / S;
  int staged = -1;  // s * B + b0 of the rows in xs
  for (int u = blockIdx.x; u < ntiles * S; u += gridDim.x) {
    const int s = u / ntiles, tile = u % ntiles;
    const int k0 = s * kchunk, k1 = min(K, k0 + kchunk);
    if (k1 <= k0) continue;
    for (int b0 = 0; b0 < B; b0 += kGroupB) {
      const int bg = min(kGroupB, B - b0);
      if (s * B + b0 != staged) {
        stage_input<W>(src + (size_t)b0 * K, K, normw, rstd + b0, bg, k0, k1,
                       xs);
        staged = s * B + b0;
      }
      gemm_tile<W>(w, N, tile * kTileN, k0, k1, xs, bg, red,
                   part + ((size_t)s * B + b0) * N, N, nullptr);
    }
  }
}

__device__ __forceinline__ float sum_parts(const float* part, int S,
                                           size_t stride, size_t i) {
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += __ldcg(part + k * stride + i);
  return s;
}

// Offset of cached token t of (layer, b, kv head h): dense [L, B, hkv, S,
// hd] or the pool [L, P, hkv, page, hd] through the page table.
__device__ __forceinline__ size_t kv_off(const Params& p, int layer, int b,
                                         int h, int t) {
  if (p.page > 0) {
    const int pid = p.page_table[b * p.pps + min(t / p.page, p.pps - 1)];
    return ((((size_t)layer * p.num_pages + pid) * p.hkv + h) * p.page +
            (t % p.page)) * p.hd;
  }
  return ((((size_t)layer * p.B + b) * p.hkv + h) * p.s_cap + t) * p.hd;
}

// One warp: dst[hd] = rope(headnorm(src) * normw, pos) * scale, the JAX
// kernel's _headnorm then the roll-and-sign rope with the per-lane angle
// pos * inv_freq[i].
template <typename W>
__device__ void head_prep(const float* src, const W* normw, int hd,
                          float eps, int pos, const float* inv_freq,
                          float scale, float* dst) {
  const int lane = threadIdx.x % 32, n = hd / 32, half = hd / 2;
  float v[kMaxHd / 32];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxHd / 32; ++j) {
    if (j < n) {
      v[j] = __ldcg(src + lane + 32 * j);
      ss += v[j] * v[j];
    }
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / (float)hd + eps);
#pragma unroll
  for (int j = 0; j < kMaxHd / 32; ++j) {
    if (j < n) {
      const int i = lane + 32 * j;
      v[j] = v[j] * r * to_f32(normw[i]);
      dst[i] = v[j];
    }
  }
  __syncwarp();
  float o[kMaxHd / 32];
#pragma unroll
  for (int j = 0; j < kMaxHd / 32; ++j) {
    if (j < n) {
      const int i = lane + 32 * j;
      const float partner = dst[i < half ? i + half : i - half];
      const float rot = i < half ? -partner : partner;
      const float ang = (float)pos * inv_freq[i];
      o[j] = (v[j] * cosf(ang) + rot * sinf(ang)) * scale;
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kMaxHd / 32; ++j)
    if (j < n) dst[lane + 32 * j] = o[j];
  __syncwarp();
}

// ATTN phase 1, tiles (b, kv head, chunk): the chunk's softmax partial
// [g][m, l, acc[hd]] over its cached tokens. Chunk 0 also writes the new
// K/V rows (knew/vnew in the cache dtype; f32 copies for phase 2) and the
// prepared q rows.
template <typename W>
__device__ void attn_partials(const Params& p, int layer, int step,
                              float* sm) {
  const int B = p.B, hkv = p.hkv, hd = p.hd, hq = p.hq, g = hq / hkv;
  const int qkvN = (hq + 2 * hkv) * hd;
  // Cached rows' element offsets, found once per token (the page-table
  // lookup) and reused by P·V.
  long long* roff = reinterpret_cast<long long*>(sm);  // [kAttnChunk]
  float* qv = sm + 2 * kAttnChunk;       // [g][hd]
  float* sc = qv + g * hd;               // [g][kAttnChunk]
  float* kt = sc + g * kAttnChunk;       // [hd] the new K row
  float* stat = kt + hd;                 // [g][2]
  float* pvbuf = stat + 2 * g;           // [kThreads / hd][g][hd]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const W* qn = reinterpret_cast<const W*>(p.qn) + (size_t)layer * hd;
  const W* kn = reinterpret_cast<const W*>(p.kn) + (size_t)layer * hd;
  const W* kc = reinterpret_cast<const W*>(p.kc);
  const W* vc = reinterpret_cast<const W*>(p.vc);
  for (int u = blockIdx.x; u < B * hkv * p.nch; u += gridDim.x) {
    const int c = u % p.nch, kvh = (u / p.nch) % hkv, b = u / (p.nch * hkv);
    const int len = min(p.kv_len[b], p.s_cap);
    const int t0 = c * kAttnChunk;
    const int nt = min(kAttnChunk, len - t0);
    if (c > 0 && nt <= 0) continue;  // never read: phase 2 stops at len
    const int pos = p.kv_len[b] + step;
    const float* row = p.qkv + (size_t)b * qkvN;
    for (int hh = warp; hh < g + (c == 0 ? 1 : 0); hh += kWarps) {
      if (hh < g)
        head_prep<W>(row + (kvh * g + hh) * hd, qn, hd, p.eps, pos,
                     p.inv_freq, p.sm_scale, qv + hh * hd);
      else
        head_prep<W>(row + (hq + kvh) * hd, kn, hd, p.eps, pos, p.inv_freq,
                     1.0f, kt);
    }
    __syncthreads();
    if (c == 0) {
      W* knew = reinterpret_cast<W*>(p.knew);
      W* vnew = reinterpret_cast<W*>(p.vnew);
      for (int i = tid; i < hd; i += kThreads) {
        const float kval = kt[i];
        const float vval = __ldcg(row + (hq + hkv + kvh) * hd + i);
        const size_t o =
            ((((size_t)step * p.L + layer) * B + b) * hkv + kvh) * hd + i;
        knew[o] = from_f32<W>(kval);
        vnew[o] = from_f32<W>(vval);
        p.kself[((size_t)b * hkv + kvh) * hd + i] = kval;
        p.vself[((size_t)b * hkv + kvh) * hd + i] = vval;
      }
      for (int i = tid; i < g * hd; i += kThreads)
        p.qs[((size_t)b * hq + kvh * g) * hd + i] = qv[i];
    }
    float* out = p.attn + (((size_t)b * hkv + kvh) * p.nch + c) * g * (hd + 2);
    if (nt <= 0) {  // chunk 0 of an empty row: an empty partial
      for (int i = tid; i < g * (hd + 2); i += kThreads)
        out[i] = (i % (hd + 2) == 0) ? -INFINITY : 0.f;
      __syncthreads();
      continue;
    }
    // Scores: one warp per token, lanes across the head dim, kUnrollT
    // tokens' K rows loaded before any is used.
    for (int tb = warp; tb < nt; tb += kWarps * kUnrollT) {
      float kr[kUnrollT][kMaxHd / 32];
#pragma unroll
      for (int u = 0; u < kUnrollT; ++u) {
        const int t = tb + u * kWarps;
        if (t < nt) {
          const size_t off = kv_off(p, layer, b, kvh, t0 + t);
          if (lane == 0) roff[t] = (long long)off;
          const W* krow = kc + off;
#pragma unroll
          for (int j = 0; j < kMaxHd / 32; ++j)
            if (j < hd / 32) kr[u][j] = to_f32(krow[lane + 32 * j]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnrollT; ++u) {
        const int t = tb + u * kWarps;
        if (t < nt) {
          for (int gi = 0; gi < g; ++gi) {
            float dot = 0.f;
#pragma unroll
            for (int j = 0; j < kMaxHd / 32; ++j)
              if (j < hd / 32)
                dot = fmaf(qv[gi * hd + lane + 32 * j], kr[u][j], dot);
            dot = warp_sum(dot);
            if (lane == 0) sc[gi * kAttnChunk + t] = dot;
          }
        }
      }
    }
    __syncthreads();
    for (int gi = warp; gi < g; gi += kWarps) {
      float m = -INFINITY;
      for (int t = lane; t < nt; t += 32) m = fmaxf(m, sc[gi * kAttnChunk + t]);
      m = warp_max(m);
      float l = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float e = expf(sc[gi * kAttnChunk + t] - m);
        sc[gi * kAttnChunk + t] = e;
        l += e;
      }
      l = warp_sum(l);
      if (lane == 0) {
        stat[2 * gi] = m;
        stat[2 * gi + 1] = l;
      }
    }
    __syncthreads();
    // P·V: thread (part, dim) sums the tokens t = part (mod parts) for
    // every q head of the group, kUnrollPV V rows in flight; the parts
    // then add up in a fixed order.
    {
      const int parts = kThreads / hd, dd = tid % hd, part = tid / hd;
      float acc[kMaxGroup];
#pragma unroll
      for (int gi = 0; gi < kMaxGroup; ++gi) acc[gi] = 0.f;
      for (int tb = part; tb < nt; tb += parts * kUnrollPV) {
        float vv[kUnrollPV];
#pragma unroll
        for (int u = 0; u < kUnrollPV; ++u) {
          const int t = tb + u * parts;
          vv[u] = t < nt ? to_f32(vc[roff[t] + dd]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kUnrollPV; ++u) {
          const int t = tb + u * parts;
          if (t < nt) {
#pragma unroll
            for (int gi = 0; gi < kMaxGroup; ++gi)
              if (gi < g)
                acc[gi] = fmaf(sc[gi * kAttnChunk + t], vv[u], acc[gi]);
          }
        }
      }
#pragma unroll
      for (int gi = 0; gi < kMaxGroup; ++gi)
        if (gi < g) pvbuf[(part * g + gi) * hd + dd] = acc[gi];
      __syncthreads();
      for (int i = tid; i < g * hd; i += kThreads) {
        const int gi = i / hd, d2 = i % hd;
        float a = 0.f;
        for (int pp = 0; pp < parts; ++pp) a += pvbuf[(pp * g + gi) * hd + d2];
        out[gi * (hd + 2) + 2 + d2] = a;
      }
    }
    if (tid < g) {
      out[tid * (hd + 2)] = stat[2 * tid];
      out[tid * (hd + 2) + 1] = stat[2 * tid + 1];
    }
    __syncthreads();
  }
}

// ATTN phase 2, tiles (b, kv head): merge the chunk partials, the band
// (this launch's rows of steps < step) and the token's own K/V into ao.
template <typename W>
__device__ void attn_merge(const Params& p, int layer, int step, float* sm) {
  const int B = p.B, hkv = p.hkv, hd = p.hd, hq = p.hq, g = hq / hkv;
  const int nb = step, stride = p.nsteps + 1;
  float* qv = sm;             // [g][hd]
  float* sb = qv + g * hd;    // [g][nsteps + 1]: band scores, then self
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const W* knew = reinterpret_cast<const W*>(p.knew);
  const W* vnew = reinterpret_cast<const W*>(p.vnew);
  for (int u = blockIdx.x; u < B * hkv; u += gridDim.x) {
    const int kvh = u % hkv, b = u / hkv;
    const size_t bh = (size_t)b * hkv + kvh;
    for (int i = tid; i < g * hd; i += kThreads)
      qv[i] = __ldcg(p.qs + ((size_t)b * hq + kvh * g) * hd + i);
    __syncthreads();
    for (int pr = warp; pr < g * (nb + 1); pr += kWarps) {
      const int gi = pr / (nb + 1), r = pr % (nb + 1);
      float dot = 0.f;
      for (int i = lane; i < hd; i += 32) {
        const float kval =
            r == nb ? __ldcg(p.kself + bh * hd + i)
                    : ld_cg(knew + ((((size_t)r * p.L + layer) * B + b) * hkv +
                                    kvh) * hd + i);
        dot = fmaf(qv[gi * hd + i], kval, dot);
      }
      dot = warp_sum(dot);
      if (lane == 0) sb[gi * stride + r] = dot;
    }
    __syncthreads();
    const int len = min(p.kv_len[b], p.s_cap);
    const int ncb = max(1, (len + kAttnChunk - 1) / kAttnChunk);
    const float* part = p.attn + bh * p.nch * g * (hd + 2);
    for (int i = tid; i < g * hd; i += kThreads) {
      const int gi = i / hd, dd = i % hd;
      float M = sb[gi * stride + nb];
      for (int r = 0; r < nb; ++r) M = fmaxf(M, sb[gi * stride + r]);
      for (int c = 0; c < ncb; ++c)
        M = fmaxf(M, __ldcg(part + ((size_t)c * g + gi) * (hd + 2)));
      float lsum = 0.f, acc = 0.f;
      for (int c = 0; c < ncb; ++c) {
        const float* pc = part + ((size_t)c * g + gi) * (hd + 2);
        const float e = expf(__ldcg(pc) - M);
        lsum += __ldcg(pc + 1) * e;
        acc += __ldcg(pc + 2 + dd) * e;
      }
      for (int r = 0; r < nb; ++r) {
        const float e = expf(sb[gi * stride + r] - M);
        lsum += e;
        acc += e * ld_cg(vnew + ((((size_t)r * p.L + layer) * B + b) * hkv +
                                 kvh) * hd + dd);
      }
      const float e = expf(sb[gi * stride + nb] - M);
      lsum += e;
      acc += e * __ldcg(p.vself + bh * hd + dd);
      p.ao[(size_t)b * hq * hd + (kvh * g + gi) * hd + dd] = acc / lsum;
    }
    __syncthreads();
  }
}

// LM head: logits over the padded vocab in 64-column tiles (each tile
// once per batch group); in multi-step builds (argmax set, even at
// NS = 1) each block keeps its best (value, index) per row over the real
// columns and publishes it to argv/argi.
template <typename W>
__device__ void lm_head(const Params& p, float* xs, float* red, float* tile,
                        float* rstd, float* best_v, int* best_i) {
  const int B = p.B, K = p.d, N = p.v_pad, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const float* src = p.fuse_norms ? p.x : p.h;
  const W* normw = p.fuse_norms ? reinterpret_cast<const W*>(p.normf) : nullptr;
  if (p.fuse_norms) row_rstd(p.x, B, K, p.eps, rstd);
  const bool track = p.argmax != 0;
  for (int b = tid; b < B; b += kThreads) {
    best_v[b] = -INFINITY;
    best_i[b] = kIdxNone;
  }
  __syncthreads();
  const W* w = reinterpret_cast<const W*>(p.lm_head);
  const int ntiles = (N + kTileN - 1) / kTileN;
  int staged = -1;  // b0 of the rows in xs
  for (int u = blockIdx.x; u < ntiles; u += gridDim.x) {
    const int n0 = u * kTileN;
    for (int b0 = 0; b0 < B; b0 += kGroupB) {
      const int bg = min(kGroupB, B - b0);
      if (b0 != staged) {
        stage_input<W>(src + (size_t)b0 * K, K, normw, rstd + b0, bg, 0, K,
                       xs);
        staged = b0;
      }
      gemm_tile<W>(w, N, n0, 0, K, xs, bg, red, p.logits + (size_t)b0 * N,
                   N, track ? tile : nullptr);
      if (track) {
        for (int r = warp; r < bg; r += kWarps) {
          float v = -INFINITY;
          int idx = kIdxNone;
          for (int c = lane; c < kTileN; c += 32) {
            const int col = n0 + c;
            if (col < p.v_real) {
              const float s = tile[r * kTileN + c];
              if (better(s, col, v, idx)) { v = s; idx = col; }
            }
          }
          warp_argmax(v, idx);
          if (lane == 0 && better(v, idx, best_v[b0 + r], best_i[b0 + r])) {
            best_v[b0 + r] = v;
            best_i[b0 + r] = idx;
          }
        }
      }
      __syncthreads();
    }
  }
  if (track) {
    for (int b = tid; b < B; b += kThreads) {
      p.argv[(size_t)blockIdx.x * B + b] = best_v[b];
      p.argi[(size_t)blockIdx.x * B + b] = best_i[b];
    }
  }
}

// Dynamic shared memory of a block (floats): the per-row values
// (rstd, best_v, best_i, tok_s: [B] each), the GEMM reduction buffer
// red [kWarps][kGroupB][kTileN], the LM head's tile [kGroupB][kTileN],
// then `region` for GEMM input staging or the attention phases.
__host__ __device__ __forceinline__ size_t smem_floats(int B, int region) {
  return 4 * (size_t)B + (size_t)kWarps * kGroupB * kTileN +
         kGroupB * kTileN + region;
}

template <typename W>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSM)
    mega_kernel(const __grid_constant__ Params p) {
  extern __shared__ float smem[];
  float* rstd = smem;
  float* best_v = rstd + p.B;
  int* best_i = reinterpret_cast<int*>(best_v + p.B);
  int* tok_s = best_i + p.B;
  float* red = reinterpret_cast<float*>(tok_s + p.B);
  float* tile = red + kWarps * kGroupB * kTileN;
  float* xs = tile + kGroupB * kTileN;  // 16-byte aligned
  const int tid = threadIdx.x;
  const size_t gtid = (size_t)blockIdx.x * kThreads + tid;
  const size_t gthreads = (size_t)gridDim.x * kThreads;
  const int B = p.B, d = p.d, hd = p.hd;
  const int qkvN = (p.hq + 2 * p.hkv) * hd, oK = p.hq * hd;
  const W* wqkv = reinterpret_cast<const W*>(p.wqkv);
  const W* wo = reinterpret_cast<const W*>(p.wo);
  const W* w1 = reinterpret_cast<const W*>(p.w1);
  const W* w2 = reinterpret_cast<const W*>(p.w2);
  const W* ln1 = reinterpret_cast<const W*>(p.ln1);
  const W* ln2 = reinterpret_cast<const W*>(p.ln2);
  for (int b = tid; b < B; b += kThreads) tok_s[b] = p.tokens[b];
  __syncthreads();

  for (int step = 0; step < p.nsteps; ++step) {
    for (int t = 0; t < p.T; ++t) {
      const int type = p.table[t * 8], layer = p.table[t * 8 + 1];
      const int arg0 = p.table[t * 8 + 2];
      const int next = t + 1 < p.T ? p.table[(t + 1) * 8] : -1;
      switch (type) {
        case kEmbed: {
          const W* emb = reinterpret_cast<const W*>(p.embed);
          for (size_t i = gtid; i < (size_t)B * d; i += gthreads) {
            const int b = (int)(i / d), k = (int)(i % d);
            const int tok = min(max(tok_s[b], 0), p.vocab - 1);
            p.x[i] = to_f32(emb[(size_t)tok * d + k]);
          }
          grid_sync(p.bar);
          break;
        }
        case kNorm: {
          const W* w = arg0 == 0   ? ln1 + (size_t)layer * d
                       : arg0 == 1 ? ln2 + (size_t)layer * d
                                   : reinterpret_cast<const W*>(p.normf);
          row_rstd(p.x, B, d, p.eps, rstd);
          for (size_t i = gtid; i < (size_t)B * d; i += gthreads) {
            const int b = (int)(i / d), k = (int)(i % d);
            p.h[i] = __ldcg(p.x + i) * rstd[b] * to_f32(w[k]);
          }
          grid_sync(p.bar);
          break;
        }
        case kQkv:
        case kFc1: {
          const bool qkv = type == kQkv;
          const int N = qkv ? qkvN : 2 * p.f;
          const W* w = qkv ? wqkv + (size_t)layer * d * N
                           : w1 + (size_t)layer * d * N;
          const W* normw = nullptr;
          if (p.fuse_norms) {
            normw = (qkv ? ln1 : ln2) + (size_t)layer * d;
            row_rstd(p.x, B, d, p.eps, rstd);
          }
          const int S = pick_split((N + kTileN - 1) / kTileN, d);
          gemm_partials<W>(w, d, N, B, S, p.fuse_norms ? p.x : p.h,
                             normw, rstd, p.part, xs, red);
          grid_sync(p.bar);
          const size_t BN = (size_t)B * N;
          if (qkv) {
            for (size_t i = gtid; i < BN; i += gthreads)
              p.qkv[i] = sum_parts(p.part, S, BN, i);
          } else {
            const int f = p.f;
            for (size_t i = gtid; i < (size_t)B * f; i += gthreads) {
              const size_t b = i / f, c = i % f;
              const float gt = sum_parts(p.part, S, BN, b * N + c);
              const float up = sum_parts(p.part, S, BN, b * N + f + c);
              p.mlp[i] = gt * (1.0f / (1.0f + expf(-gt))) * up;
            }
          }
          grid_sync(p.bar);
          break;
        }
        case kAttn: {
          attn_partials<W>(p, layer, step, xs);
          grid_sync(p.bar);
          attn_merge<W>(p, layer, step, xs);
          grid_sync(p.bar);
          break;
        }
        case kOProj:
        case kFc2: {
          const bool o = type == kOProj;
          const int K = o ? oK : p.f;
          const W* w = o ? wo + (size_t)layer * K * d
                         : w2 + (size_t)layer * K * d;
          const int S = pick_split((d + kTileN - 1) / kTileN, K);
          gemm_partials<W>(w, K, d, B, S, o ? p.ao : p.mlp, nullptr,
                             rstd, p.part, xs, red);
          grid_sync(p.bar);
          const size_t BN = (size_t)B * d;
          for (size_t i = gtid; i < BN; i += gthreads)
            p.h[i] = sum_parts(p.part, S, BN, i);
          // ALLREDUCE reads exactly these elements on these threads.
          if (next != kAllReduce) grid_sync(p.bar);
          break;
        }
        case kAllReduce: {
          for (size_t i = gtid; i < (size_t)B * d; i += gthreads)
            p.x[i] = __ldcg(p.x + i) + __ldcg(p.h + i);
          grid_sync(p.bar);
          break;
        }
        case kLmHead: {
          lm_head<W>(p, xs, red, tile, rstd, best_v, best_i);
          grid_sync(p.bar);
          if (p.argmax) {
            for (int b = tid; b < B; b += kThreads) {
              float bv = -INFINITY;
              int bi = kIdxNone;
              for (int blk = 0; blk < (int)gridDim.x; ++blk) {
                const float v = __ldcg(p.argv + (size_t)blk * B + b);
                const int i = __ldcg(p.argi + (size_t)blk * B + b);
                if (better(v, i, bv, bi)) { bv = v; bi = i; }
              }
              if (bi == kIdxNone) bi = 0;
              tok_s[b] = bi;
              if (blockIdx.x == 0) {
                p.toks[step * B + b] = bi;
                if (p.eos) {
                  const int prev = step == 0 ? p.nsteps : p.stop_step[b];
                  const bool hit = bi == p.stop_tok[b];
                  p.stop_step[b] = (hit && prev == p.nsteps) ? step : prev;
                }
              }
            }
            __syncthreads();
          }
          break;
        }
        default:
          __trap();
      }
    }
  }
}

template <typename W>
int launch(Params p, long long ws_floats, int* info, cudaStream_t stream) {
  auto kern = mega_kernel<W>;
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  const int g = p.hq / p.hkv;
  const int kmax = max(p.d, max(p.hq * p.hd, p.f));
  const int attn_b = 2 * kAttnChunk + g * p.hd + g * kAttnChunk + p.hd +
                     2 * g + kThreads * g;
  const int attn_m = g * p.hd + g * (p.nsteps + 1);
  const int region = max(min(p.B, kGroupB) * kmax, max(attn_b, attn_m));
  const size_t smem = sizeof(float) * smem_floats(p.B, region);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  int occ = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int nblk = sms * min(occ, kMaxBlocksPerSM);
  // Carve the workspace; megakernel/code_generator.py sizes it.
  float* ws = p.x;
  size_t off = 0;
  auto take = [&](size_t n) { float* r = ws + off; off += n; return r; };
  const size_t B = p.B;
  const int qkvN = (p.hq + 2 * p.hkv) * p.hd;
  p.x = take(B * p.d);
  p.h = take(B * p.d);
  p.qkv = take(B * qkvN);
  p.ao = take(B * p.hq * p.hd);
  p.mlp = take(B * p.f);
  p.part = take((size_t)kMaxSplit * B * max(qkvN, max(p.d, 2 * p.f)));
  p.attn = take(B * p.hkv * p.nch * g * (p.hd + 2));
  p.qs = take(B * p.hq * p.hd);
  p.kself = take(B * p.hkv * p.hd);
  p.vself = take(B * p.hkv * p.hd);
  p.argv = take((size_t)nblk * B);
  p.argi = reinterpret_cast<int*>(take((size_t)nblk * B));
  if ((long long)off > ws_floats) return (int)cudaErrorInvalidValue;
  info[0] = nblk;
  info[1] = (int)smem;
  info[2] = occ;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)kern,
                                  dim3(nblk), dim3(kThreads), args, smem,
                                  stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: embed, wqkv, wo, w1, w2, lm_head, ln1, ln2, normf, qn, kn, kc, vc,
//   page_table (0 = dense), kv_len, tokens, stop_tok (0 without eos),
//   table, inv_freq, logits, knew, vnew, toks, stop_step, workspace,
//   barrier counter.
// ints: T, nsteps, B, d, hq, hkv, hd, f, v_pad, v_real, L, s_cap (dense
//   S or pages_per_seq * page), page (0 = dense), pages_per_seq,
//   num_pages, fuse_norms, eos, dtype (0 f32, 1 bf16), workspace floats,
//   vocab rows of embed, argmax (1 = multi-step build: the LM head takes
//   the argmax and feeds it back).
// info (out): blocks launched, dynamic shared memory bytes, blocks per SM
//   the occupancy calculator allows.
extern "C" int tdt_mega_decode(const unsigned long long* ptrs,
                               const int* ints, float eps, float sm_scale,
                               int* info, void* stream) {
  Params p{};
  int k = 0;
  p.embed = (const void*)ptrs[k++];
  p.wqkv = (const void*)ptrs[k++];
  p.wo = (const void*)ptrs[k++];
  p.w1 = (const void*)ptrs[k++];
  p.w2 = (const void*)ptrs[k++];
  p.lm_head = (const void*)ptrs[k++];
  p.ln1 = (const void*)ptrs[k++];
  p.ln2 = (const void*)ptrs[k++];
  p.normf = (const void*)ptrs[k++];
  p.qn = (const void*)ptrs[k++];
  p.kn = (const void*)ptrs[k++];
  p.kc = (const void*)ptrs[k++];
  p.vc = (const void*)ptrs[k++];
  p.page_table = (const int*)ptrs[k++];
  p.kv_len = (const int*)ptrs[k++];
  p.tokens = (const int*)ptrs[k++];
  p.stop_tok = (const int*)ptrs[k++];
  p.table = (const int*)ptrs[k++];
  p.inv_freq = (const float*)ptrs[k++];
  p.logits = (float*)ptrs[k++];
  p.knew = (void*)ptrs[k++];
  p.vnew = (void*)ptrs[k++];
  p.toks = (int*)ptrs[k++];
  p.stop_step = (int*)ptrs[k++];
  p.x = (float*)ptrs[k++];  // the workspace base, carved in launch()
  p.bar = (unsigned*)ptrs[k++];
  int i = 0;
  p.T = ints[i++];
  p.nsteps = ints[i++];
  p.B = ints[i++];
  p.d = ints[i++];
  p.hq = ints[i++];
  p.hkv = ints[i++];
  p.hd = ints[i++];
  p.f = ints[i++];
  p.v_pad = ints[i++];
  p.v_real = ints[i++];
  p.L = ints[i++];
  p.s_cap = ints[i++];
  p.page = ints[i++];
  p.pps = ints[i++];
  p.num_pages = ints[i++];
  p.fuse_norms = ints[i++];
  p.eos = ints[i++];
  const int dtype = ints[i++];
  const long long ws_floats = ints[i++];
  p.vocab = ints[i++];
  p.argmax = ints[i++];
  p.nch = (p.s_cap + kAttnChunk - 1) / kAttnChunk;
  p.eps = eps;
  p.sm_scale = sm_scale;
  if (p.B < 1 || p.hkv < 1 || p.hq % p.hkv != 0 ||
      p.hq / p.hkv > kMaxGroup || p.hd % 32 != 0 || p.hd > kMaxHd ||
      kThreads % p.hd != 0 ||
      p.nsteps < 1 || (p.eos && p.stop_tok == nullptr) ||
      (p.page > 0 && p.page_table == nullptr) || p.d % 8 != 0 ||
      p.v_pad % 8 != 0 || ((p.hq + 2 * p.hkv) * p.hd) % 8 != 0 ||
      (2 * p.f) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::kDtypeF32) return launch<float>(p, ws_floats, info, s);
  if (dtype == tdt::kDtypeBF16)
    return launch<__nv_bfloat16>(p, ws_floats, info, s);
  return (int)cudaErrorInvalidValue;
}
