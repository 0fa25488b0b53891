// Sequence-parallel all-gather attention (long-context causal prefill) for
// Hopper (sm_90a), over ranks co-located on one card.
//
// Replaces: triton_distributed_tpu/ops/attention/sp_ag_attention.py
// `_sp_ag_attn_kernel` :39 (entry `sp_ag_attention` :150): the KV gather
// and the causal flash attention that consumes it, fused in one kernel.
//
// What it computes, per rank me of n (the sequence sharded in rank order,
// s_loc rows a rank): for q head h and local row i, causal attention over
// the K/V chunks 0..me, where chunks r < me are fully visible and the own
// chunk is causal in local indices (col <= i, sp_ag_attention.py:115-119);
// scores (q . k) * sm_scale in f32, an online softmax over key tiles with
// f32 (m, l, acc), masked scores -1e30, P.V accumulated in f32, l floored
// at 1e-30; O in q's dtype and the f32 LSE m + log(l). P is rounded to
// V's dtype before P.V, as the TPU kernel and csrc/flash_attention.cu do
// (l sums the unrounded P).
//
// What bounds it on the H100: operations. At Qwen3-8B's geometry (hq 32,
// hd 128) over a 32768-token sequence the causal products are
// 4 * hq * hd * S^2 / 2 = 8.8e12 FLOP, 8.9 ms at 989 TFLOP/s bf16, against
// 134 MB of K/V moved. The schedule is the reference's: rank me attends
// me + 1 chunks, so rank n - 1 does n times rank 0's work, and with every
// rank's blocks resident on one card the last rank's blocks finish last.
//
// Design (not a DMA-by-DMA copy of the Pallas kernel, which stages a whole
// s_loc chunk in VMEM: 4 MB per K at s_loc 16384, far over shared memory):
// - one cooperative launch over all ranks (grid (G, n), every block
//   resident or the launch is refused), the entry barrier and epoch flags
//   of tdt_comm.cuh;
// - push first: block g of rank me copies piece g of its K and V shard into
//   slot me of the workspace [n, 2, hkv, s_loc, hd] of every later rank and
//   stores flag (me, g) there, before any block waits, so no block spins on
//   a push that has not started; the own chunk is read in place;
// - then each block walks work items (kv head, q tile), heaviest tile
//   first, and for each runs chunks 0..me, waiting once per chunk and block
//   on that chunk's G flags (a flag at this launch's epoch: never a stale
//   chunk of an earlier launch), and tiles over keys within the chunk
//   (the own chunk up to the tile's last row);
// - a block holds the G = hq / hkv q heads of one kv head (GQA), so each
//   K/V tile is read once per group;
// - bf16: QK^T and P.V on the tensor cores (mma.sync m16n8k16, f32
//   accumulators), 16 (head, row) rows a warp, 64-key tiles staged in
//   shared memory (V transposed, rows padded against bank conflicts);
// - f32 (TF32 off): the FMA pipes, a lane a key, as csrc/flash_attention.cu
//   does, 16 (head, row) rows a block.
// Rows past s_loc (a q tile over the edge) are computed on zero q and
// never stored; keys past s_loc weigh exactly 0 (score -inf).
//
// Flags of rank r: [0, n) the entry barrier, then n + src * G + g.
#include <type_traits>

#include "tdt_comm.cuh"
#include "tdt_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tdt::RankPtrs;

constexpr int kD = 128;   // head dim
constexpr int kBK = 64;   // keys per staged tile, bf16 path
constexpr int kBKf = 32;  // keys per tile, f32 path (one per lane)

// Rows a block (flattened (head, q row) over the G heads of one kv head),
// q rows per head (kBQ) and threads, per path.
template <typename T, int G>
struct Cfg {
  static constexpr bool kMma = std::is_same<T, bf16>::value;
  static constexpr int kWarps = kMma ? (G > 4 ? G : 4) : 4;
  static constexpr int kRows = kMma ? kWarps * 16 : 16;
  static constexpr int kBQ = kRows / G;
  static constexpr int kThreads = kWarps * 32;
};

struct SpParams {
  RankPtrs q, k, v, o, lse;  // per rank: q/o [hq, s_loc, D], k/v [hkv, s_loc,
                             // D], lse [hq, s_loc] f32
  const int64_t* ws_tab;     // [n, 2, hkv, s_loc, D] of T a rank
  const int64_t* fl_tab;
  int n, hkv, s_loc;
  float sm_scale;
  uint64_t epoch;
};

__device__ __forceinline__ void byte_piece(long long span, int g, int G,
                                           long long& lo, long long& hi) {
  const long long per = ((span + G - 1) / G + 15) / 16 * 16;
  lo = min(span, static_cast<long long>(g) * per);
  hi = min(span, lo + per);
}

// Piece g of the own K and V shard into slot me of every later rank's
// workspace, then flag (me, g) on each of them.
template <typename T>
__device__ void push_shard(const SpParams& P, int me) {
  const int g = blockIdx.x, G = gridDim.x;
  const long long kv_bytes =
      static_cast<long long>(P.hkv) * P.s_loc * kD * sizeof(T);
  const char* k = tdt::rank_ptr<const char>(P.k, me);
  const char* v = tdt::rank_ptr<const char>(P.v, me);
  long long lo, hi;
  byte_piece(kv_bytes, g, G, lo, hi);
  for (int p = me + 1; p < P.n; ++p) {
    char* slot = tdt::symm_ptr<char>(P.ws_tab, p) + me * 2 * kv_bytes;
    if (hi > lo) {
      tdt::put(slot + lo, k + lo, hi - lo);
      tdt::put(slot + kv_bytes + lo, v + lo, hi - lo);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && me + 1 < P.n) {
    __threadfence_system();
    for (int p = me + 1; p < P.n; ++p)
      tdt::st_release_sys(
          tdt::symm_ptr<uint64_t>(P.fl_tab, p) + P.n + me * G + g, P.epoch);
  }
}

// Chunk r (< me) has arrived: all G pieces of its push. Waited once per
// block and chunk (`arrived` is the block's bitmask).
__device__ __forceinline__ void await_chunk(const SpParams& P, int me, int r,
                                            unsigned& arrived) {
  if (r == me || (arrived >> r) & 1u) return;
  if (threadIdx.x == 0) {
    const uint64_t* mine = tdt::symm_ptr<const uint64_t>(P.fl_tab, me);
    for (int j = 0; j < static_cast<int>(gridDim.x); ++j)
      tdt::wait_until(mine + P.n + r * gridDim.x + j, P.epoch);
  }
  __syncthreads();
  arrived |= 1u << r;
}

// Chunk r's K (which 0) or V (1) rows of kv head kvh: the own chunk in
// place, an earlier one from the workspace.
template <typename T>
__device__ __forceinline__ const T* chunk_ptr(const SpParams& P, int me,
                                              int r, int which, int kvh) {
  const size_t head = static_cast<size_t>(kvh) * P.s_loc * kD;
  if (r == me)
    return tdt::rank_ptr<const T>(which ? P.v : P.k, me) + head;
  return tdt::symm_ptr<const T>(P.ws_tab, me) +
         (static_cast<size_t>(r * 2 + which) * P.hkv) * P.s_loc * kD + head;
}

// ---- bf16: tensor cores ---------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

constexpr int kKPad = kD + 8;    // K tile row stride (bf16)
constexpr int kVPad = kBK + 8;   // transposed V tile row stride (bf16)

// One work item (kv head kvh, q tile qt) on the tensor cores. Warp w owns
// the 16 flattened rows [16w, 16w + 16): one head, 16 consecutive q rows;
// a thread holds rows ra = row0 + lane / 4 and rb = ra + 8 (the mma
// accumulator layout), columns (lane % 4) * 2 + {0, 1} of each 8-wide
// tile.
template <int G>
__device__ void item_mma(const SpParams& P, int me, int kvh, int qt,
                         unsigned& arrived, bf16 (*Ks)[kKPad],
                         bf16 (*Vt)[kVPad]) {
  using C = Cfg<bf16, G>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s_loc = P.s_loc;
  const int h = kvh * G + (warp * 16) / C::kBQ;
  const int ra = qt * C::kBQ + (warp * 16) % C::kBQ + lane / 4;
  const int rb = ra + 8;
  const int last_row = min((qt + 1) * C::kBQ, s_loc) - 1;
  const bf16* q = tdt::rank_ptr<const bf16>(P.q, me) +
                  static_cast<size_t>(h) * s_loc * kD;

  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    const int c = ks * 16 + (lane % 4) * 2;
    qa[ks][0] = ra < s_loc ? ld_u32(q + static_cast<size_t>(ra) * kD + c) : 0u;
    qa[ks][1] = rb < s_loc ? ld_u32(q + static_cast<size_t>(rb) * kD + c) : 0u;
    qa[ks][2] =
        ra < s_loc ? ld_u32(q + static_cast<size_t>(ra) * kD + c + 8) : 0u;
    qa[ks][3] =
        rb < s_loc ? ld_u32(q + static_cast<size_t>(rb) * kD + c + 8) : 0u;
  }
  float acc[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[dn][j] = 0.f;
  float m[2] = {tdt::kNegInf, tdt::kNegInf}, l[2] = {0.f, 0.f};
  const float neg_inf = -__int_as_float(0x7f800000);

  for (int r = 0; r <= me; ++r) {
    await_chunk(P, me, r, arrived);
    const bf16* kc = chunk_ptr<bf16>(P, me, r, 0, kvh);
    const bf16* vc = chunk_ptr<bf16>(P, me, r, 1, kvh);
    const int kv_end = r == me ? last_row + 1 : s_loc;
    for (int k0 = 0; k0 < kv_end; k0 += kBK) {
      __syncthreads();  // the previous tile is consumed
      for (int i = threadIdx.x; i < kBK * kD / 8; i += C::kThreads) {
        const int key = i / (kD / 8), d0 = (i % (kD / 8)) * 8;
        uint4 u = make_uint4(0, 0, 0, 0);
        if (k0 + key < s_loc)
          u = __ldcg(reinterpret_cast<const uint4*>(
              kc + static_cast<size_t>(k0 + key) * kD + d0));
        *reinterpret_cast<uint4*>(&Ks[key][d0]) = u;
      }
      for (int i = threadIdx.x; i < kBK * kD / 8; i += C::kThreads) {
        const int key = i % kBK, d0 = (i / kBK) * 8;
        uint4 u = make_uint4(0, 0, 0, 0);
        if (k0 + key < s_loc)
          u = __ldcg(reinterpret_cast<const uint4*>(
              vc + static_cast<size_t>(k0 + key) * kD + d0));
        const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int j = 0; j < 8; ++j) Vt[d0 + j][key] = e[j];
      }
      __syncthreads();

      float s[kBK / 8][4];
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
#pragma unroll
        for (int ks = 0; ks < kD / 16; ++ks) {
          const bf16* kr = &Ks[nt * 8 + lane / 4][ks * 16 + (lane % 4) * 2];
          mma_bf16(s[nt], qa[ks], ld_u32(kr), ld_u32(kr + 8));
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + nt * 8 + (lane % 4) * 2 + (j & 1);
          const int row = j < 2 ? ra : rb;
          float x = s[nt][j] * P.sm_scale;
          if (r == me && col > row) x = tdt::kNegInf;
          if (col >= s_loc) x = neg_inf;  // padding: weight exactly 0
          s[nt][j] = x;
          mx[j >> 1] = fmaxf(mx[j >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = expf(m[i] - mx[i]);
        m[i] = mx[i];
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int dn = 0; dn < kD / 8; ++dn) {
        acc[dn][0] *= alpha[0];
        acc[dn][1] *= alpha[0];
        acc[dn][2] *= alpha[1];
        acc[dn][3] *= alpha[1];
      }
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = expf(s[nt][j] - m[j >> 1]);
          l[j >> 1] += p;
          s[nt][j] = p;
        }
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dn = 0; dn < kD / 8; ++dn) {
          const bf16* vr = &Vt[dn * 8 + lane / 4][kk * 16 + (lane % 4) * 2];
          mma_bf16(acc[dn], pa, ld_u32(vr), ld_u32(vr + 8));
        }
      }
    }
  }

  bf16* o = tdt::rank_ptr<bf16>(P.o, me) + static_cast<size_t>(h) * s_loc * kD;
  float* lse = tdt::rank_ptr<float>(P.lse, me) + static_cast<size_t>(h) * s_loc;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = i == 0 ? ra : rb;
    if (row >= s_loc) continue;
    const float lf = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn) {
      const int c = dn * 8 + (lane % 4) * 2;
      *reinterpret_cast<__nv_bfloat162*>(o + static_cast<size_t>(row) * kD +
                                         c) =
          __floats2bfloat162_rn(acc[dn][2 * i] / lf, acc[dn][2 * i + 1] / lf);
    }
    if (lane % 4 == 0) lse[row] = m[i] + logf(lf);
  }
}

// ---- f32: FMA pipes ---------------------------------------------------------

// One work item on the FMA pipes: 16 flattened rows, 4 a warp; lane j
// scores key j of a 32-key tile, the warp reduces max and sum by shuffle,
// and each lane owns D / 32 output columns of P.V.
template <int G>
__device__ void item_f32(const SpParams& P, int me, int kvh, int qt,
                         unsigned& arrived, float (*q_s)[kD],
                         float (*k_s)[kD + 1], float (*v_s)[kD]) {
  using C = Cfg<float, G>;
  constexpr int RPW = C::kRows / C::kWarps;
  constexpr int EPL = kD / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s_loc = P.s_loc;
  const int last_row = min((qt + 1) * C::kBQ, s_loc) - 1;
  const float* q = tdt::rank_ptr<const float>(P.q, me);

  __syncthreads();  // the previous item's q rows are consumed
  for (int i = threadIdx.x; i < C::kRows * kD; i += C::kThreads) {
    const int f = i / kD, c = i % kD;
    const int h = kvh * G + f / C::kBQ, row = qt * C::kBQ + f % C::kBQ;
    q_s[f][c] = row < s_loc
                    ? q[(static_cast<size_t>(h) * s_loc + row) * kD + c]
                    : 0.f;
  }
  float m[RPW], l[RPW], acc[RPW][EPL];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = tdt::kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[rr][e] = 0.f;
  }
  const float neg_inf = -__int_as_float(0x7f800000);

  for (int r = 0; r <= me; ++r) {
    await_chunk(P, me, r, arrived);
    const float* kc = chunk_ptr<float>(P, me, r, 0, kvh);
    const float* vc = chunk_ptr<float>(P, me, r, 1, kvh);
    const int kv_end = r == me ? last_row + 1 : s_loc;
    for (int k0 = 0; k0 < kv_end; k0 += kBKf) {
      __syncthreads();
      for (int i = threadIdx.x; i < kBKf * kD; i += C::kThreads) {
        const int key = i / kD, c = i % kD;
        const bool in = k0 + key < s_loc;
        const size_t at = static_cast<size_t>(k0 + key) * kD + c;
        k_s[key][c] = in ? __ldcg(kc + at) : 0.f;
        v_s[key][c] = in ? __ldcg(vc + at) : 0.f;
      }
      __syncthreads();
      const int col = k0 + lane;
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const int f = warp * RPW + rr;
        const int row = qt * C::kBQ + f % C::kBQ;
        if (row >= s_loc) continue;  // warp-uniform
        float s = 0.f;
#pragma unroll 16
        for (int d = 0; d < kD; ++d) s = fmaf(q_s[f][d], k_s[lane][d], s);
        s *= P.sm_scale;
        if (r == me && col > row) s = tdt::kNegInf;
        if (col >= s_loc) s = neg_inf;
        const float m_new = fmaxf(m[rr], tdt::warp_max(s));
        const float p = expf(s - m_new);
        const float alpha = expf(m[rr] - m_new);
        l[rr] = l[rr] * alpha + tdt::warp_sum(p);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[rr][e] *= alpha;
#pragma unroll 8
        for (int j = 0; j < kBKf; ++j) {
          const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            acc[rr][e] = fmaf(pj, v_s[j][e * 32 + lane], acc[rr][e]);
        }
        m[rr] = m_new;
      }
    }
  }

  float* o = tdt::rank_ptr<float>(P.o, me);
  float* lse = tdt::rank_ptr<float>(P.lse, me);
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int f = warp * RPW + rr;
    const int h = kvh * G + f / C::kBQ, row = qt * C::kBQ + f % C::kBQ;
    if (row >= s_loc) continue;
    const float lf = fmaxf(l[rr], 1e-30f);
    float* ob = o + (static_cast<size_t>(h) * s_loc + row) * kD;
#pragma unroll
    for (int e = 0; e < EPL; ++e) ob[e * 32 + lane] = acc[rr][e] / lf;
    if (lane == 0) lse[static_cast<size_t>(h) * s_loc + row] = m[rr] + logf(lf);
  }
}

// ---- the kernel ---------------------------------------------------------------

template <typename T, int G>
__global__ void __launch_bounds__(Cfg<T, G>::kThreads)
    sp_ag_attn_kernel(SpParams P) {
  using C = Cfg<T, G>;
  const int me = blockIdx.y;
  tdt::barrier_all(P.fl_tab, me, P.n, P.epoch, blockIdx.x == 0);
  push_shard<T>(P, me);

  const int n_qt = (P.s_loc + C::kBQ - 1) / C::kBQ;
  const int items = P.hkv * n_qt;
  unsigned arrived = 0;
  if constexpr (C::kMma) {
    // Raw 16-bit storage: a __shared__ array may not have a constructor.
    __shared__ __align__(16) uint16_t ks_raw[kBK][kKPad];
    __shared__ __align__(16) uint16_t vt_raw[kD][kVPad];
    auto* Ks = reinterpret_cast<bf16 (*)[kKPad]>(ks_raw);
    auto* Vt = reinterpret_cast<bf16 (*)[kVPad]>(vt_raw);
    for (int it = blockIdx.x; it < items; it += gridDim.x)
      item_mma<G>(P, me, it % P.hkv, n_qt - 1 - it / P.hkv, arrived, Ks, Vt);
  } else {
    __shared__ float q_s[C::kRows][kD];
    __shared__ float k_s[kBKf][kD + 1];
    __shared__ float v_s[kBKf][kD];
    for (int it = blockIdx.x; it < items; it += gridDim.x)
      item_f32<G>(P, me, it % P.hkv, n_qt - 1 - it / P.hkv, arrived, q_s,
                  k_s, v_s);
  }
}

template <typename T>
const void* fn_t(int group) {
  switch (group) {
    case 1: return reinterpret_cast<const void*>(&sp_ag_attn_kernel<T, 1>);
    case 2: return reinterpret_cast<const void*>(&sp_ag_attn_kernel<T, 2>);
    case 4: return reinterpret_cast<const void*>(&sp_ag_attn_kernel<T, 4>);
    case 8: return reinterpret_cast<const void*>(&sp_ag_attn_kernel<T, 8>);
    default: return nullptr;
  }
}

const void* sp_fn(int dtype, int group) {
  return dtype == tdt::kDtypeF32    ? fn_t<float>(group)
         : dtype == tdt::kDtypeBF16 ? fn_t<bf16>(group)
                                    : nullptr;
}

int sp_threads(int dtype, int group) {
  if (dtype == tdt::kDtypeF32) return Cfg<float, 1>::kThreads;
  return 32 * (group > 4 ? group : 4);
}

}  // namespace

extern "C" {

// Co-resident blocks of the kernel for (dtype, group): the most one
// cooperative launch takes.
int tdt_sp_ag_attention_capacity(int dtype, int group) {
  const void* fn = sp_fn(dtype, group);
  return fn == nullptr ? 0 : tdt::capacity(fn, sp_threads(dtype, group));
}

// Causal SP attention over n co-located ranks: host tables of the per-rank
// q/k/v/o/lse pointers (q/o [hkv * group, s_loc, d], k/v [hkv, s_loc, d]
// of dtype 0 f32 or 1 bf16, lse [hkv * group, s_loc] f32), the workspace's
// ([n, 2, hkv, s_loc, d] a rank) and flags' device tables. d must be 128
// and group 1, 2, 4 or 8.
int tdt_sp_ag_attention_launch(int dtype, int group, const int64_t* q,
                               const int64_t* k, const int64_t* v,
                               const int64_t* o, const int64_t* lse,
                               const int64_t* ws_tab, const int64_t* fl_tab,
                               int n, int hkv, int s_loc, int d,
                               float sm_scale, unsigned long long epoch,
                               int blocks_per_rank, void* stream) {
  const void* fn = sp_fn(dtype, group);
  if (fn == nullptr || d != kD || n < 1 || n > tdt::kMaxRanks || hkv < 1 ||
      s_loc < 1 || blocks_per_rank < 1)
    return cudaErrorInvalidValue;
  const int threads = sp_threads(dtype, group);
  if (n * blocks_per_rank > tdt::capacity(fn, threads))
    return cudaErrorCooperativeLaunchTooLarge;
  SpParams P;
  P.q = tdt::to_ptrs(q, n);
  P.k = tdt::to_ptrs(k, n);
  P.v = tdt::to_ptrs(v, n);
  P.o = tdt::to_ptrs(o, n);
  P.lse = tdt::to_ptrs(lse, n);
  P.ws_tab = ws_tab;
  P.fl_tab = fl_tab;
  P.n = n;
  P.hkv = hkv;
  P.s_loc = s_loc;
  P.sm_scale = sm_scale;
  P.epoch = epoch;
  void* args[] = {&P};
  cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(blocks_per_rank, n), dim3(threads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
