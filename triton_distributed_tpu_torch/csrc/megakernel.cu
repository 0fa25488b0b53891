// The decode megakernel for Hopper (sm_90a): a whole greedy decode step of
// a dense Qwen3 at tp=1, or NS steps, as ONE persistent cooperative kernel
// walking a packed task table, also over n > 1 co-located tensor-parallel
// ranks in one launch (see "At tp > 1" below); and the prefill megakernel
// (one prompt's rows through the prefill table, mega_prefill_kernel
// below).
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
// ALLREDUCE, LM_HEAD; at tp > 1 also BARRIER, AR_SEND and AR_WAIT), over
// f32 state kept in a global workspace
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
// The device task tracer (the TPU kernel's dims.trace, code_generator.py
// :628-682 and kernels.py:46-79) and the work ring's RING_POLL task
// (kernels.py:1581): a traced launch writes one [task_id, opcode, layer,
// arg0, begin, end, mid, flag] record per (step, task) into trace [NS, T,
// 8], on block 0's clock64 (see trace_mark); ALLREDUCE stamps mid between
// its exchange and its fold, and RING_POLL the published doorbell
// ring_state[0]. An untraced launch writes nothing, and RING_POLL is a
// no-op there. The prefill graph runs in its own kernel, below
// (mega_prefill_kernel).
//
// Sampling (the TPU kernel's dims.sampled and dims.filtered,
// triton_distributed_tpu/megakernel/kernels.py:1500-1505 and
// `_filtered_winner` :1353). Sampled: the argmax runs over logits +
// noise[step] (noise = T_b * gumbel, drawn by the host per launch; the
// Gumbel-max trick makes that argmax a draw of softmax(logits / T_b)); the
// logits written stay clean, and a greedy row's noise is 0, so its tokens
// are the greedy launch's bit for bit. Filtered: no threshold is known
// until every vocab tile has landed, so the stream only writes logits and,
// after the grid barrier, one block per row finds the row's exact top-k /
// top-p keep-set by bisection on monotone counts in the scaled domain ls =
// logits * (1/T) (`filtered_winner`): 64 halvings of count(ls > t) >= k,
// then over those survivors 64 halvings of sum(exp(ls - max); ls > t) >=
// p * Z; the winner is the argmax of logits + noise over the keep-set. A
// bisection reads the row from L2 while its bracket holds more than
// kFiltCap columns and then only those columns from shared memory (each
// halving's count is the columns above the bracket plus the members above
// the midpoint, so the counts are those of the full row); a top-k window
// of the whole vocab skips its bisection, whose keep-set is then every
// real column. Counts are exact in f32; sums of weights use fixed-order
// block reductions, so two launches agree bit for bit. The other blocks
// wait at the next grid barrier.
//
// Three storage types, each a template parameter (no type switch inside a
// loop): T, the model dtype (f32 or bf16: embed, norms, knew/vnew, the
// rounding of every GEMM input, a full-width cache); WT, the weights' (T,
// or int8 under wq8: the five projection weights as int8 codes with one
// f32 scale per output column, the TPU kernel's `_q8_scale`); CT, the
// cache's (T, or int8 codes over a paged pool with one f32 scale per
// (layer, page, kv head), the TPU kernel's kv_quant). All eight
// combinations are built, each greedy and sampled, untraced and traced
// (the fourth and fifth template parameters, see mega_kernel). An int8 weight widens to f32 exactly, so only
// the f32 product is scaled: the scale of an output column multiplies the
// fixed-order split-K sum once (a per-column constant distributes over the
// K sum, which the TPU kernel scales tile by tile), before SwiGLU for fc1,
// before the residual add for wo/w2, and in the LM head before the pad
// mask and the argmax. Over an int8 pool each cached token's score is
// multiplied by its page's K scale and its V row by the page's V scale,
// token by token, so a 128-token tile may span pages of any size. The
// kernel never writes the pool: the new rows leave in T, the launch's own
// rows are attended at full precision (the band), and the host quantizes
// them into the pool after the launch.
//
// What bounds it on the H100: bytes. A step reads every layer weight once
// (0.88 GB at Qwen3-0.6B in bf16, 0.44 GB in int8 plus 0.6 MB of scales),
// the LM head (0.31 GB, 0.16 GB in int8) and every cached K/V row (114688
// B per token over 28 layers in bf16, 57344 B of codes plus the pages'
// scales in int8); at small batch it does ~2 FLOPs per weight byte per
// row, far under the ~295 FLOP/byte balance point, so the bound is those
// bytes / 3.35 TB/s.
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
// weight streams and wgmma are later work; so are 16-byte int8 weight
// loads (a thread owns 8 columns, one 8-byte load per row, with twice as
// many rows in flight as in bf16).
//
// The MoE graph (the TPU kernel's dims.moe, kernels.py:1133 moe_gate_body,
// :1188 moe_ffn_body, :1253 a2a_send_body, :1296 a2a_wait_body at tp=1) is
// built from this same source into its own library (megakernel_moe.cu
// defines TDT_MEGA_MOE): its instantiations carry kMoE, and the dense ones
// compile exactly the code they compiled before. Per layer, in place of
// FC1/FC2/ALLREDUCE: MOE_GATE (moe_gate: one block per row computes the
// f32 router logits of its normed row, softmax over the E experts, and the
// top-k by max-and-retire in one warp, ties to the lowest expert index,
// renormalised under norm_topk, into the combine weights moe_w [E, B];
// every block writes the normed rows to h under fused norms and zeroes the
// accumulator moe_acc [B, d]; one grid barrier), one MOE_FFN per expert
// (moe_ffn: the FC1 and FC2 streams of the dense path over the expert's
// weights, FC2's sums scaled per row by the combine weight and added into
// moe_acc) and the combine: the last expert's arg1 = 1 copies moe_acc to h
// for ALLREDUCE, or under overlap_ar A2A_SEND phase 0 parks moe_acc in
// a2buf and zeroes it, phase 1 parks it in cbuf, and A2A_WAIT folds x +=
// a2buf + cbuf behind a grid barrier (at tp=1 no peer: the TPU bodies'
// puts, waits and tile-0 prefetch drop out; the tracer stamps mid where
// they call trace_mid). An expert whose combine weight is 0 for every row
// of the launch is skipped by every block, barriers included: all blocks
// read the same moe_w after the gate's barrier, so all decide alike, and
// the skipped terms are exactly 0. A routed expert costs three barriers
// (FC1 sums, SwiGLU, FC2 sums); FC2 keeps its split-K partials apart
// from FC1's (part2), so no barrier follows the accumulate. Bound: bytes,
// each routed expert's 2f(d) + f(d) weights once a step.
//
// The MoE graph at tp > 1 (kMoE with kTp: kernels.py:1254 a2a_send_body and
// :1297 a2a_wait_body with their puts and waits, :442 _a2a_put_dmas, :469
// _a2a_wait_recvs, and :404 _ar_put_dmas / :429 _ar_wait_recvs for phase
// 1): the experts are expert-parallel, rank r holding experts r * E/n ..
// at full width (megakernel/qwen3.py moe_params), every rank running the
// replicated gate; MOE_FFN weights local expert e's output by the combine
// weight of global expert r * E/n + e. A2A_SEND stores this block's
// elements of moe_acc into slot me of every peer (phase 0 into its own
// two alternating slot sets, phase 1 into the partials sets ALLREDUCE
// uses, as the TPU kernel reuses cbuf), with the flag protocol above;
// A2A_WAIT acquires every peer's block for both phases and folds acc = x,
// acc = acc + phase0[r] + phase1[r] in rank order (the TPU body's order),
// then the grid barrier. The A2A tasks are per layer, not per expert, so
// the exchange ordinals count alike on every rank; the skip of unrouted
// local experts and its barriers stay rank-local. The TPU body's tile-0
// prefetch (cross_prefetch) has no counterpart: the tracer stamps mid
// there. Without overlap_ar the combine is the last expert's handoff to
// ALLREDUCE, as at tp=1.
//
// At tp > 1 (the TPU kernel's n_ranks > 1: kernels.py:1047 allreduce_body
// beyond tp=1, :1076 ar_send_body, :1102 ar_wait_body, :1574 barrier_body,
// the puts and waits of :404 _ar_put_dmas, :429 _ar_wait_recvs and :481
// _workspace_bcast, and the LM head's cross-rank argmax :1529-1557), for a
// dense graph: n ranks share ONE cooperative launch (the kTp
// instantiations, tdt_mega_decode_tp), because two cooperative launches on
// one card are not guaranteed to be co-resident and a rank that waits on a
// peer that is not resident hangs. The grid is (G, n): blockIdx.y is the
// rank and blockIdx.x the block within it, so every work split over
// blockIdx.x / gridDim.x above is rank-local by construction and a tp=1
// launch (gridDim.y = 1) computes exactly what it computed before. G is
// the co-resident capacity over n; a grid whose n·G blocks cannot all be
// resident is refused. Each block reads its rank's Params (its weights,
// pool shard, knew/vnew, workspace, trace ring and grid-barrier counter,
// so grid_sync counts only the rank's G blocks) from a __grid_constant__
// array. The exchanges (Comm, through the tdt_comm.cuh primitives): the
// graph's entry BARRIER is tdt::barrier_all; an ALLREDUCE, and an AR_SEND
// with its AR_WAIT, move the f32 partial h: block g of rank me stores its
// elements of h (the same elements every rank's block g owns, and the ones
// its fold reads) into slot me of every peer, publishes them with one
// release flag per (source rank, block) at system scope, and after the
// acquire of every peer's block g folds x += slot[0] + ... + slot[n-1] in
// rank order in f32 (its own partial read from h), so every rank holds the
// same bits. The LM head's (value, global index) candidates go the same
// way, one candidate set per block, and every block reduces them in rank
// order with a strict > (a tie goes to the lower rank: the first
// occurrence). Flags are never reset: a flag's value is the launch epoch
// (<< 20) plus the exchange's ordinal in the launch. Slot reuse, which the
// TPU kernel's trailing cross-rank barriers guard, is guarded here by two
// slot sets alternated per exchange (one pair for the partials, one for the
// candidates): before block g of a rank writes a slot set again it has
// waited for block g of every peer at the exchange in between, which that
// peer's block g publishes only after it has read the slot. The TPU
// kernel's cross_prefetch tile-0 DMA has no counterpart here; the tracer
// stamps mid where the TPU bodies call trace_mid. The straggler fixture
// (the TPU kernel's straggler_rank) spins the lagging rank's blocks before
// its first exchange (and, MoE, its first phase-0 combine) and before every
// LM-head push. Code a tp=1 launch does not run sits behind the kTp
// template parameter. Bound: bytes, every rank's weight shards and K/V rows
// over the one card's HBM. The prefill kernel at tp > 1 (kTp, kernels.py
// :1047 allreduce_body over S rows, :896 load_x_body, :908
// attn_prefill_body, each rank its heads and vocab columns) takes the same
// (G, n) grid, per-rank Params, entry BARRIER and ALLREDUCE exchange, its
// slots S * d floats a set and a source rank.
#include "tdt_comm.cuh"
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
  kFc2 = 6, kAllReduce = 7, kLmHead = 8, kBarrier = 9, kAttnPrefill = 10,
  kLoadX = 11, kArSend = 12, kArWait = 13, kMoeGate = 14, kMoeFfn = 15,
  kA2aSend = 16, kA2aWait = 17, kRingPoll = 18
};
constexpr int kMaxExperts = 256;    // the gate's warp holds 8 per lane
constexpr int kGateUnroll = 8;      // router rows in flight per thread
// Trace-ring record columns (megakernel/task.py TR_*).
enum : int {
  kTrTaskId = 0, kTrOpcode = 1, kTrLayer = 2, kTrSlot = 3, kTrBegin = 4,
  kTrEnd = 5, kTrMid = 6, kTrFlag = 7, kTraceInts = 8
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
  // wq8: per-output-column scales [L, N] (sc_lm [v_pad]); kv_quant: the
  // pool's scales [L, P, hkv].
  const float* sc_qkv; const float* sc_o; const float* sc_w1;
  const float* sc_w2; const float* sc_lm; const float* ksc; const float* vsc;
  // Sampling: noise [NS, B, v_pad] (sampled), sampcfg [B, 4] rows [1/T,
  // top-k window, top-p, enable] (filtered).
  const float* noise; const float* sampcfg;
  // Workspace views (carved by the host entry).
  float* x; float* h; float* qkv; float* ao; float* mlp; float* part;
  float* attn; float* qs; float* kself; float* vself; float* argv;
  int* argi;
  int T, nsteps, B, d, hq, hkv, hd, f, v_pad, v_real, L, s_cap, page, pps,
      num_pages, fuse_norms, eos, vocab, argmax, nch, sampled, filtered;
  float eps, sm_scale;
  // The tracer's ring [NS, T, 8] (nullptr = untraced) and the work
  // ring's published snapshot [doorbell, head, tail, occupancy]
  // (nullptr without a ring).
  int* trace; const int* ring_state;
  // Prefill: the embedded prompt rows x0 [S, d] in T, and workspace
  // views for the prepared q [hq, S, hd] and k [hkv, S, hd] heads (f32)
  // and the rows' rstd [S].
  const void* x0; float* qf; float* kf; float* rstd;
  // MoE: the router [L, d, E] (w1 is then [L, E, d, 2f] and w2 [L, E, f,
  // d]); workspace views for the combine weights moe_w [E, B], the
  // accumulator moe_acc, the split combine's a2buf and cbuf [B, d] and
  // FC2's partials part2 [kMaxSplit, B, d]. E = 0 in a dense launch.
  // moe_route [NS, L, E, B] and moe_x [NS, L, B, d] (optional, nullptr =
  // none): every gate's combine weights and the residual rows it read, for
  // a check that holds the routing and the state layer by layer.
  const void* wrouter; float* moe_route; float* moe_x;
  float* moe_w; float* moe_acc; float* a2buf; float* cbuf; float* part2;
  int E, topk, norm_topk;
};

// The exchange of a launch over n > 1 co-located ranks (kTp). Each rank's
// slots (floats): the partials [2][n][B * d], then the LM head's candidates
// [2][n][g_cap][B][2], then (MoE) the combine's phase-0 partials
// [2][n][B * d] (two alternating sets each, the source rank's slot within a
// set); its flags (uint64): the entry barrier's [n], then one a source
// block [n][g_cap]. Both through device tables of the ranks' slot pointers
// (DistContext symmetric allocations).
struct Comm {
  const int64_t* slot_tab;
  const int64_t* flag_tab;
  unsigned long long base;  // epoch << 20: exchange e waits for base + e + 1
  long long lag_ns;         // the straggler fixture's lag
  int n, g_cap, lag_rank;   // lag_rank -1: none
};

// A kTp launch's argument: every rank's Params and the exchange.
struct TpParams {
  Params p[tdt::kMaxRanks];
  Comm c;
};

template <bool kTp>
struct KernelArg {
  using type = Params;
};
template <>
struct KernelArg<true> {
  using type = TpParams;
};

// The Params of this block's rank (blockIdx.y), and the exchange.
__device__ __forceinline__ const Params& rank_params(const Params& a) {
  return a;
}
__device__ __forceinline__ const Params& rank_params(const TpParams& a) {
  return a.p[blockIdx.y];
}
__device__ __forceinline__ const Comm* comm_of(const Params&) {
  return nullptr;
}
__device__ __forceinline__ const Comm* comm_of(const TpParams& a) {
  return &a.c;
}

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

template <>
struct Raw8<int8_t> {
  uint2 v;
  __device__ __forceinline__ void load(const int8_t* p) {
    v = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void widen(float (&o)[8]) const {
    const int8_t* e = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = to_f32(e[i]);
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

// -- the cross-rank exchange (kTp) ---------------------------------------------

// The flag value of the launch's exchange ordinal e.
__device__ __forceinline__ uint64_t xval(const Comm& c, int e) {
  return c.base + (uint64_t)e + 1;
}

// Rank r's flag of source block (src, this block's index).
__device__ __forceinline__ uint64_t* xflag(const Comm& c, int r, int src) {
  return tdt::symm_ptr<uint64_t>(c.flag_tab, r) + c.n +
         (size_t)src * c.g_cap + blockIdx.x;
}

// Slot `src` of rank r's partials set `par` ([B * d] floats).
__device__ __forceinline__ float* ar_slot(const Comm& c, int r, int par,
                                          int src, size_t bd) {
  return tdt::symm_ptr<float>(c.slot_tab, r) + ((size_t)par * c.n + src) * bd;
}

// This block's candidates [B][2] in slot `src` of rank r's set `par`.
__device__ __forceinline__ float* lm_slot(const Comm& c, int r, int par,
                                          int src, size_t bd, int B) {
  return tdt::symm_ptr<float>(c.slot_tab, r) + 2 * (size_t)c.n * bd +
         (((size_t)par * c.n + src) * c.g_cap + blockIdx.x) * 2 * B;
}

// Slot `src` of rank r's phase-0 combine set `par` ([B * d] floats, MoE).
__device__ __forceinline__ float* a2_slot(const Comm& c, int r, int par,
                                          int src, size_t bd, int B) {
  return tdt::symm_ptr<float>(c.slot_tab, r) + 2 * (size_t)c.n * bd +
         4 * (size_t)c.n * c.g_cap * B + ((size_t)par * c.n + src) * bd;
}

// The straggler fixture: the lagging rank's blocks spin before a push.
__device__ __forceinline__ void straggle(const Comm& c, int me) {
  if (me == c.lag_rank && threadIdx.x == 0) {
    const uint64_t t0 = tdt::global_ns();
    while (tdt::global_ns() - t0 < (uint64_t)c.lag_ns) __nanosleep(1000);
  }
  __syncthreads();
}

// After the block's threads stored its piece into every peer's slot:
// publish it to the same block of every peer (release, system scope).
__device__ __forceinline__ void xsignal(const Comm& c, int me, uint64_t v) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    for (int r = 0; r < c.n; ++r)
      if (r != me) tdt::st_release_sys(xflag(c, r, me), v);
  }
}

// Wait until the same block of every peer has published exchange v.
__device__ __forceinline__ void xwait(const Comm& c, int me, uint64_t v) {
  if (threadIdx.x == 0)
    for (int r = 0; r < c.n; ++r)
      if (r != me) tdt::wait_until(xflag(c, me, r), v);
  __syncthreads();
}

// The exchange of the partial h (ALLREDUCE, AR_SEND): this block's
// elements into slot `me` of every peer's set `par`, then the flag.
__device__ void ar_push(const Params& p, const Comm& c, int me, int par,
                        uint64_t v) {
  const size_t bd = (size_t)p.B * p.d;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < bd;
       i += (size_t)gridDim.x * kThreads) {
    const float hv = __ldcg(p.h + i);
    for (int r = 0; r < c.n; ++r)
      if (r != me) ar_slot(c, r, par, me, bd)[i] = hv;
  }
  xsignal(c, me, v);
}

// The fold (ALLREDUCE, AR_WAIT), after xwait: x += h_0 + ... + h_{n-1} in
// rank order in f32, the rank's own partial read from h.
__device__ void ar_fold(const Params& p, const Comm& c, int me, int par) {
  const size_t bd = (size_t)p.B * p.d;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < bd;
       i += (size_t)gridDim.x * kThreads) {
    float acc = __ldcg(p.x + i);
    for (int r = 0; r < c.n; ++r)
      acc += r == me ? __ldcg(p.h + i) : __ldcg(ar_slot(c, me, par, r, bd) + i);
    p.x[i] = acc;
  }
}

// A2A_SEND of an MoE graph at tp > 1 (the TPU body's _a2a_put_dmas for
// phase 0, _ar_put_dmas for phase 1): this block's elements of moe_acc,
// this rank's combine partial, into its own a2buf (phase 0, moe_acc then
// restarts at 0) or cbuf (phase 1) and into slot `me` of every peer's
// phase-0 set or partials set `par`, then the flag.
__device__ __noinline__ void a2a_push(const Params& p, const Comm& c, int me,
                                      int phase, int par, uint64_t v) {
  const size_t bd = (size_t)p.B * p.d;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < bd;
       i += (size_t)gridDim.x * kThreads) {
    const float a = __ldcg(p.moe_acc + i);
    if (phase == 0) {
      p.a2buf[i] = a;
      p.moe_acc[i] = 0.f;
    } else {
      p.cbuf[i] = a;
    }
    for (int r = 0; r < c.n; ++r)
      if (r != me)
        (phase == 0 ? a2_slot(c, r, par, me, bd, p.B)
                    : ar_slot(c, r, par, me, bd))[i] = a;
  }
  xsignal(c, me, v);
}

// A2A_WAIT's fold (the TPU body's), after the waits: acc = x, then acc =
// acc + phase0[r] + phase1[r] for every rank r in order, in f32, this
// rank's own partials read from a2buf and cbuf.
__device__ __noinline__ void a2a_fold(const Params& p, const Comm& c, int me,
                                      int par0, int par1) {
  const size_t bd = (size_t)p.B * p.d;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < bd;
       i += (size_t)gridDim.x * kThreads) {
    float acc = __ldcg(p.x + i);
    for (int r = 0; r < c.n; ++r) {
      const float a = r == me ? __ldcg(p.a2buf + i)
                              : __ldcg(a2_slot(c, me, par0, r, bd, p.B) + i);
      const float b = r == me ? __ldcg(p.cbuf + i)
                              : __ldcg(ar_slot(c, me, par1, r, bd) + i);
      acc = acc + a + b;
    }
    p.x[i] = acc;
  }
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
// rounded to the model dtype T; with normw, the inline RMS norm
// (src * rstd[b]) * normw[k] first.
template <typename T>
__device__ void stage_input(const float* src, int K, const T* normw,
                            const float* rstd, int B, int k0, int k1,
                            float* xs) {
  const int n = k1 - k0;
  for (int i = threadIdx.x; i < B * n; i += kThreads) {
    const int b = i / n, k = k0 + i % n;
    float v = __ldcg(src + (size_t)b * K + k);
    if (normw != nullptr) v = v * rstd[b] * to_f32(normw[k]);
    xs[i] = round_to<T>(v);
  }
  __syncthreads();
}

// One GEMM tile: out[b * ldo + n] = sum_{k0 <= k < k1} xs[b][k - k0] *
// w[k][n] for the 64 columns n0.. (clipped at N), every b < B <= kGroupB.
// 32 row groups x 8 column threads; each thread owns 8 columns (one
// 16-byte load in bf16) and strides over K, kUnrollK rows' loads in
// flight at a time; the row groups reduce with shuffles and then through
// shared memory in a fixed order. With `colscale` (wq8's per-column
// scales), each sum is multiplied by its column's scale. With `tile`, the
// sums are also left in shared memory tile[b][c].
template <typename WT>
__device__ void gemm_tile(const WT* __restrict__ w, int N, int n0, int k0,
                          int k1, const float* xs, int B, float* red,
                          float* out, int ldo, float* tile,
                          const float* colscale) {
  // int8 weights: 8 bytes a row per thread, so twice as many rows in
  // flight keep the bytes in flight of the bf16 stream.
  constexpr int kU = sizeof(WT) == 1 ? 2 * kUnrollK : kUnrollK;
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
    const WT* wp = w + (size_t)k0 * N + col;
    for (int kk = rg; kk < nk; kk += kRowGroups * kU) {
      Raw8<WT> raw[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (kk + u * kRowGroups < nk)
          raw[u].load(wp + (size_t)(kk + u * kRowGroups) * N);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
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
    if (colscale != nullptr && n0 + c < N) s *= colscale[n0 + c];
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
template <typename T, typename WT>
__device__ void gemm_partials(const WT* w, int K, int N, int B, int S,
                              const float* src, const T* normw,
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
        stage_input<T>(src + (size_t)b0 * K, K, normw, rstd + b0, bg, k0, k1,
                       xs);
        staged = s * B + b0;
      }
      gemm_tile<WT>(w, N, tile * kTileN, k0, k1, xs, bg, red,
                    part + ((size_t)s * B + b0) * N, N, nullptr, nullptr);
    }
  }
}

__device__ __forceinline__ float sum_parts(const float* part, int S,
                                           size_t stride, size_t i) {
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += __ldcg(part + k * stride + i);
  return s;
}

// Pool page of cached token t of row b, through the page table.
__device__ __forceinline__ int kv_pid(const Params& p, int b, int t) {
  return p.page_table[b * p.pps + min(t / p.page, p.pps - 1)];
}

// Offset of cached token t of (layer, b, kv head h): dense [L, B, hkv, S,
// hd] or the pool [L, P, hkv, page, hd] through the page table.
__device__ __forceinline__ size_t kv_off(const Params& p, int layer, int b,
                                         int h, int t) {
  if (p.page > 0) {
    const int pid = kv_pid(p, b, t);
    return ((((size_t)layer * p.num_pages + pid) * p.hkv + h) * p.page +
            (t % p.page)) * p.hd;
  }
  return ((((size_t)layer * p.B + b) * p.hkv + h) * p.s_cap + t) * p.hd;
}

// One warp: dst[hd] = rope(headnorm(src) * normw, pos) * scale, the JAX
// kernel's _headnorm then the roll-and-sign rope with the per-lane angle
// pos * inv_freq[i].
template <typename T>
__device__ void head_prep(const float* src, const T* normw, int hd,
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
// K/V rows (knew/vnew in the model dtype; f32 copies for phase 2) and the
// prepared q rows. Over an int8 pool (CT = int8_t) a token's score is its
// code dot product times its page's K scale, and its V codes are
// multiplied by the page's V scale.
template <typename T, typename CT>
__device__ void attn_partials(const Params& p, int layer, int step,
                              float* sm) {
  constexpr bool kQuant = sizeof(CT) == 1;
  const int B = p.B, hkv = p.hkv, hd = p.hd, hq = p.hq, g = hq / hkv;
  const int qkvN = (hq + 2 * hkv) * hd;
  // Cached rows' element offsets (and, int8, V scales), found once per
  // token (the page-table lookup) and reused by P·V.
  long long* roff = reinterpret_cast<long long*>(sm);  // [kAttnChunk]
  float* tvs = sm + 2 * kAttnChunk;      // [kAttnChunk]
  float* qv = tvs + kAttnChunk;          // [g][hd]
  float* sc = qv + g * hd;               // [g][kAttnChunk]
  float* kt = sc + g * kAttnChunk;       // [hd] the new K row
  float* stat = kt + hd;                 // [g][2]
  float* pvbuf = stat + 2 * g;           // [kThreads / hd][g][hd]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* qn = reinterpret_cast<const T*>(p.qn) + (size_t)layer * hd;
  const T* kn = reinterpret_cast<const T*>(p.kn) + (size_t)layer * hd;
  const CT* kc = reinterpret_cast<const CT*>(p.kc);
  const CT* vc = reinterpret_cast<const CT*>(p.vc);
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
        head_prep<T>(row + (kvh * g + hh) * hd, qn, hd, p.eps, pos,
                     p.inv_freq, p.sm_scale, qv + hh * hd);
      else
        head_prep<T>(row + (hq + kvh) * hd, kn, hd, p.eps, pos, p.inv_freq,
                     1.0f, kt);
    }
    __syncthreads();
    if (c == 0) {
      T* knew = reinterpret_cast<T*>(p.knew);
      T* vnew = reinterpret_cast<T*>(p.vnew);
      for (int i = tid; i < hd; i += kThreads) {
        const float kval = kt[i];
        const float vval = __ldcg(row + (hq + hkv + kvh) * hd + i);
        const size_t o =
            ((((size_t)step * p.L + layer) * B + b) * hkv + kvh) * hd + i;
        knew[o] = from_f32<T>(kval);
        vnew[o] = from_f32<T>(vval);
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
      float ks[kUnrollT];
#pragma unroll
      for (int u = 0; u < kUnrollT; ++u) {
        const int t = tb + u * kWarps;
        if (t < nt) {
          const size_t off = kv_off(p, layer, b, kvh, t0 + t);
          if (lane == 0) roff[t] = (long long)off;
          if constexpr (kQuant) {
            const size_t si =
                ((size_t)layer * p.num_pages + kv_pid(p, b, t0 + t)) * hkv +
                kvh;
            ks[u] = p.ksc[si];
            if (lane == 0) tvs[t] = p.vsc[si];
          }
          const CT* krow = kc + off;
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
            if constexpr (kQuant) dot *= ks[u];
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
          if (t < nt) {
            vv[u] = to_f32(vc[roff[t] + dd]);
            if constexpr (kQuant) vv[u] *= tvs[t];
          } else {
            vv[u] = 0.f;
          }
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
template <typename T>
__device__ void attn_merge(const Params& p, int layer, int step, float* sm) {
  const int B = p.B, hkv = p.hkv, hd = p.hd, hq = p.hq, g = hq / hkv;
  const int nb = step, stride = p.nsteps + 1;
  float* qv = sm;             // [g][hd]
  float* sb = qv + g * hd;    // [g][nsteps + 1]: band scores, then self
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* knew = reinterpret_cast<const T*>(p.knew);
  const T* vnew = reinterpret_cast<const T*>(p.vnew);
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
// columns, of logits + this step's noise when sampled, and publishes it to
// argv/argi; a filtered build only writes the logits. Under wq8 the logits
// are scaled per column before they are written or compared.
template <typename T, typename WT, bool kSample>
__device__ void lm_head(const Params& p, int step, float* xs, float* red,
                        float* tile, float* rstd, float* best_v,
                        int* best_i) {
  const int B = p.B, K = p.d, N = p.v_pad, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const float* src = p.fuse_norms ? p.x : p.h;
  const T* normw =
      p.fuse_norms ? reinterpret_cast<const T*>(p.normf) : nullptr;
  const float* colscale = sizeof(WT) == 1 ? p.sc_lm : nullptr;
  if (p.fuse_norms) row_rstd(p.x, B, K, p.eps, rstd);
  const bool track = p.argmax != 0 && !(kSample && p.filtered);
  for (int b = tid; b < B; b += kThreads) {
    best_v[b] = -INFINITY;
    best_i[b] = kIdxNone;
  }
  __syncthreads();
  const WT* w = reinterpret_cast<const WT*>(p.lm_head);
  const int ntiles = (N + kTileN - 1) / kTileN;
  int staged = -1;  // b0 of the rows in xs
  for (int u = blockIdx.x; u < ntiles; u += gridDim.x) {
    const int n0 = u * kTileN;
    for (int b0 = 0; b0 < B; b0 += kGroupB) {
      const int bg = min(kGroupB, B - b0);
      if (b0 != staged) {
        stage_input<T>(src + (size_t)b0 * K, K, normw, rstd + b0, bg, 0, K,
                       xs);
        staged = b0;
      }
      gemm_tile<WT>(w, N, n0, 0, K, xs, bg, red, p.logits + (size_t)b0 * N,
                    N, track ? tile : nullptr, colscale);
      if (track) {
        const float* nz =
            kSample ? p.noise + ((size_t)step * B + b0) * N : nullptr;
        for (int r = warp; r < bg; r += kWarps) {
          float v = -INFINITY;
          int idx = kIdxNone;
          for (int c = lane; c < kTileN; c += 32) {
            const int col = n0 + c;
            if (col < p.v_real) {
              float s = tile[r * kTileN + c];
              if (nz != nullptr) s += __ldg(nz + (size_t)r * N + col);
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

// The LM head's cross-rank argmax (kTp, after the grid barrier that follows
// the LM head): this rank's (value, global index) candidate of each row,
// from the blocks' argv/argi, into candidate slot `me` of set `par` of every
// rank (each block its own copy), then, once the same block of every peer
// has published, the ranks' candidates reduced in rank order with a strict
// > (rank 0's first) into tok_s; block 0 writes the rank's toks and
// stop_step, as the tp=1 tail does.
__device__ __noinline__ void lm_exchange(const Params& p, const Comm& c,
                                         int me, int step, int par,
                                         uint64_t v, int* tok_s) {
  const int B = p.B;
  const size_t bd = (size_t)B * p.d;
  straggle(c, me);
  for (int b = threadIdx.x; b < B; b += kThreads) {
    float bv = -INFINITY;
    int bi = kIdxNone;
    for (int blk = 0; blk < (int)gridDim.x; ++blk) {
      const float v2 = __ldcg(p.argv + (size_t)blk * B + b);
      const int i2 = __ldcg(p.argi + (size_t)blk * B + b);
      if (better(v2, i2, bv, bi)) { bv = v2; bi = i2; }
    }
    const int gi = bi == kIdxNone ? kIdxNone : me * p.v_pad + bi;
    for (int r = 0; r < c.n; ++r) {
      float* slot = lm_slot(c, r, par, me, bd, B) + 2 * b;
      slot[0] = bv;
      slot[1] = __int_as_float(gi);
    }
  }
  xsignal(c, me, v);
  xwait(c, me, v);
  for (int b = threadIdx.x; b < B; b += kThreads) {
    float bv = -INFINITY;
    int bi = kIdxNone;
    for (int r = 0; r < c.n; ++r) {
      const float* slot = lm_slot(c, me, par, r, bd, B) + 2 * b;
      const float v2 = __ldcg(slot);
      const int i2 = __float_as_int(__ldcg(slot + 1));
      if (r == 0 || v2 > bv) { bv = v2; bi = i2; }
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

// -- the filtered winner ------------------------------------------------------

constexpr float kNegF = -3.0e38f;  // the TPU kernel's pad-column score
constexpr int kFiltCap = 4096;     // bracket members kept in shared memory
// Shared memory of filtered_winner (floats): reduction scratch [kWarps],
// per-thread counts [kThreads], the bracket's members (scaled value and
// weight) [2][kFiltCap].
constexpr int kFiltFloats = kWarps + kThreads + 2 * kFiltCap;

// Block-wide reductions in a fixed order, so that every thread gets the
// same value on every run: the xor tree inside each warp (lane 0's
// result), then the warps' results in warp order. `scr` holds kWarps
// values; the leading barrier keeps the previous call's readers safe.
__device__ __forceinline__ float block_sum(float v, float* scr) {
  v = warp_sum(v);
  __syncthreads();
  if (threadIdx.x % 32 == 0) scr[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kWarps; ++w) s += scr[w];
  return s;
}

__device__ __forceinline__ int block_sum_int(int v, float* scr) {
  v = __reduce_add_sync(0xffffffffu, v);
  int* si = reinterpret_cast<int*>(scr);
  __syncthreads();
  if (threadIdx.x % 32 == 0) si[threadIdx.x / 32] = v;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < kWarps; ++w) s += si[w];
  return s;
}

__device__ __forceinline__ float block_max(float v, float* scr) {
  v = warp_max(v);
  __syncthreads();
  if (threadIdx.x % 32 == 0) scr[threadIdx.x / 32] = v;
  __syncthreads();
  float m = scr[0];
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, scr[w]);
  return m;
}

// f(i, r[i], q[i]) for every column i < n of one row r (n % 4 == 0, rows
// 16-byte aligned; q[i] is 0 without kQ), each thread over the same
// columns in the same order on every call: 16-byte loads (r from L2, as
// the kernel wrote it; q read-only), four of each in flight per thread.
template <bool kQ = false, typename F>
__device__ __forceinline__ void row_scan(const float* r, const float* q,
                                         int n, F&& f) {
  constexpr int kU = 4, kStride = kThreads * 4;
  for (int i0 = threadIdx.x * 4; i0 < n; i0 += kStride * kU) {
    float4 v[kU], w[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kStride;
      if (i < n) {
        v[u] = __ldcg(reinterpret_cast<const float4*>(r + i));
        w[u] = kQ ? __ldg(reinterpret_cast<const float4*>(q + i))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kStride;
      if (i < n) {
        f(i, v[u].x, w[u].x);
        f(i + 1, v[u].y, w[u].y);
        f(i + 2, v[u].z, w[u].z);
        f(i + 3, v[u].w, w[u].w);
      }
    }
  }
}

// The scaled logit ls = x * (1/T) of the TPU kernel, rounded on its own
// (never contracted into a later subtraction).
__device__ __forceinline__ float scaled(float x, float inv_t) {
  return __fmul_rn(x, inv_t);
}

// 64 halvings of [mn - 1, mx] keeping count_ge(lo) true and count_ge(hi)
// false, count_ge(t) = C(t) >= target. kSum = false: C(t) = #{real columns
// with ls > t} (top-k); kSum = true: C(t) = sum of exp(ls - mx) over the
// top-k survivors (ls > lo_k) with ls > t (top-p). Full passes over the
// row while the bracket (lo, hi] holds more than kFiltCap members; then
// the members go to shared memory once (thread by thread, in a fixed
// order) with the sum of those above hi, and the remaining halvings read
// only them. Returns lo.
template <bool kSum>
__device__ float bisect(const float* lg, int n, int vr, float inv_t, float mx,
                        float mn, float lo_k, float target, float* sm) {
  float* scr = sm;
  int* tcnt = reinterpret_cast<int*>(sm + kWarps);
  float* mls = sm + kWarps + kThreads;
  float* mw = mls + kFiltCap;
  const int tid = threadIdx.x;
  float lo = mn - 1.0f, hi = mx;
  int it = 0, mine = 0, nact = 0;
  for (; it < 64; ++it) {
    const float mid = 0.5f * (lo + hi);
    float gt = 0.f;
    int c_lo = 0, c_hi = 0;  // members in (lo, mid] and in (mid, hi]
    row_scan(lg, nullptr, n, [&](int i, float x, float) {
      if (i >= vr) return;
      const float ls = scaled(x, inv_t);
      if (kSum && !(ls > lo_k)) return;
      if (ls > mid) {
        gt += kSum ? expf(ls - mx) : 1.f;
        if (ls <= hi) ++c_hi;
      } else if (ls > lo) {
        ++c_lo;
      }
    });
    const bool take = block_sum(gt, scr) >= target;
    if (take) lo = mid; else hi = mid;
    mine = take ? c_hi : c_lo;
    nact = block_sum_int(mine, scr);
    if (nact <= kFiltCap) {
      ++it;
      break;
    }
  }
  if (it >= 64) return lo;
  tcnt[tid] = mine;
  __syncthreads();
  int pos = 0;
  for (int t = 0; t < tid; ++t) pos += tcnt[t];
  float above = 0.f;
  row_scan(lg, nullptr, n, [&](int i, float x, float) {
    if (i >= vr) return;
    const float ls = scaled(x, inv_t);
    if (kSum && !(ls > lo_k)) return;
    const float wv = kSum ? expf(ls - mx) : 1.f;
    if (ls > hi) {
      above += wv;
    } else if (ls > lo) {
      mls[pos] = ls;
      mw[pos] = wv;
      ++pos;
    }
  });
  above = block_sum(above, scr);  // its barriers publish the members
  for (; it < 64; ++it) {
    const float mid = 0.5f * (lo + hi);
    float gt = 0.f;
    for (int j = tid; j < nact; j += kThreads)
      if (mls[j] > mid) gt += mw[j];
    if (above + block_sum(gt, scr) >= target) lo = mid; else hi = mid;
  }
  return lo;
}

// Row b's winner in a filtered launch, on one block: with the row's filter
// enabled, the keep-set is ls > lo_k (top-k) and ls > lo_p (top-p) as
// bisected above; otherwise every real column. The winner, the argmax of
// logits + noise[step] over the keep-set with the lowest index on ties, goes
// to p.argi[b]. Not inlined: its registers stay out of the allocation of
// the kernel's other phases.
__device__ __noinline__ void filtered_winner(const Params& p, int step, int b,
                                             float* sm) {
  const int tid = threadIdx.x, n = p.v_pad, vr = p.v_real;
  const float* lg = p.logits + (size_t)b * n;
  const float* nz = p.noise + ((size_t)step * p.B + b) * n;
  const float* cfg = p.sampcfg + (size_t)b * 4;
  const float inv_t = cfg[0], kk = cfg[1], pp = cfg[2];
  const bool en = cfg[3] > 0.f;
  float* scr = sm;
  float lo_k = 0.f, lo_p = 0.f;
  if (en) {
    float vmx = kNegF, vmn = -kNegF;
    row_scan(lg, nullptr, n, [&](int i, float x, float) {
      if (i < vr) {
        const float ls = scaled(x, inv_t);
        vmx = fmaxf(vmx, ls);
        vmn = fminf(vmn, ls);
      }
    });
    const float mx = block_max(vmx, scr);
    const float mn = -block_max(-vmn, scr);
    // A top-k window of every real column keeps every real column: the
    // bisection would only walk lo down towards mn, keeping count(ls >
    // lo) = vr. That holds whenever mn - 1 < mn (|mn| < 2^24), so the 64
    // halvings are skipped then; the keep-set is the same.
    lo_k = kk >= (float)vr && mn - 1.0f < mn
               ? mn - 1.0f
               : bisect<false>(lg, n, vr, inv_t, mx, mn, 0.f, kk, sm);
    float z = 0.f;
    row_scan(lg, nullptr, n, [&](int i, float x, float) {
      if (i < vr) {
        const float ls = scaled(x, inv_t);
        if (ls > lo_k) z += expf(ls - mx);
      }
    });
    z = block_sum(z, scr);
    lo_p = bisect<true>(lg, n, vr, inv_t, mx, mn, lo_k, pp * z, sm);
  }
  float bv = -INFINITY;
  int bi = kIdxNone;
  row_scan<true>(lg, nz, n, [&](int i, float x, float y) {
    if (i >= vr) return;
    if (en) {
      const float ls = scaled(x, inv_t);
      if (!(ls > lo_k && ls > lo_p)) return;
    }
    const float sc = x + y;
    if (better(sc, i, bv, bi)) {
      bv = sc;
      bi = i;
    }
  });
  warp_argmax(bv, bi);
  int* si = reinterpret_cast<int*>(scr + kWarps);
  __syncthreads();
  if (tid % 32 == 0) {
    scr[tid / 32] = bv;
    si[tid / 32] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    float v = scr[0];
    int i = si[0];
    for (int w = 1; w < kWarps; ++w)
      if (better(scr[w], si[w], v, i)) {
        v = scr[w];
        i = si[w];
      }
    p.argi[b] = i == kIdxNone ? 0 : i;
  }
  __syncthreads();
}

// -- the MoE bodies -----------------------------------------------------------

// MOE_GATE, before its grid barrier (see the header). sm holds the normed
// row [d], the logit partials [kThreads] and the logits [E].
template <typename T>
__device__ __noinline__ void moe_gate(const Params& p, int step, int layer,
                                      float* sm, float* rstd) {
  const int B = p.B, d = p.d, E = p.E, tid = threadIdx.x;
  const size_t gtid = (size_t)blockIdx.x * kThreads + tid;
  const size_t gthreads = (size_t)gridDim.x * kThreads;
  const T* ln2 = reinterpret_cast<const T*>(p.ln2) + (size_t)layer * d;
  if (p.fuse_norms) row_rstd(p.x, B, d, p.eps, rstd);
  for (size_t i = gtid; i < (size_t)B * d; i += gthreads) {
    // The experts read the normed rows from h (the NORM task wrote them
    // without fused norms).
    if (p.fuse_norms)
      p.h[i] = __ldcg(p.x + i) * rstd[i / d] * to_f32(ln2[i % d]);
    p.moe_acc[i] = 0.f;
  }
  float* hn = sm;
  float* lg = hn + d;
  float* logit = lg + 8 * kThreads;  // lg: [parts][E] <= 8 * kThreads
  const T* wr = reinterpret_cast<const T*>(p.wrouter) + (size_t)layer * d * E;
  // f32 logits: thread (part, group) sums the rows k = part (mod parts) of
  // 8 neighbouring experts' columns (one 16-byte load a row in bf16),
  // kGateUnroll rows' loads in flight; the parts then add up in a fixed
  // order. E is a multiple of 8, at most kMaxExperts.
  const int groups = E / 8, parts = kThreads / groups;
  const int grp = tid % groups, part = tid / groups;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    for (int k = tid; k < d; k += kThreads)
      hn[k] = p.fuse_norms ? __ldcg(p.x + (size_t)b * d + k) * rstd[b] *
                                 to_f32(ln2[k])
                           : __ldcg(p.h + (size_t)b * d + k);
    __syncthreads();
    if (p.moe_x != nullptr)
      for (int k = tid; k < d; k += kThreads)
        p.moe_x[(((size_t)step * p.L + layer) * B + b) * d + k] =
            __ldcg(p.x + (size_t)b * d + k);
    if (part < parts) {
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
      for (int k0 = part; k0 < d; k0 += parts * kGateUnroll) {
        Raw8<T> raw[kGateUnroll];
#pragma unroll
        for (int u = 0; u < kGateUnroll; ++u)
          if (k0 + u * parts < d)
            raw[u].load(wr + (size_t)(k0 + u * parts) * E + grp * 8);
#pragma unroll
        for (int u = 0; u < kGateUnroll; ++u) {
          const int k = k0 + u * parts;
          if (k < d) {
            float wv[8];
            raw[u].widen(wv);
            const float hv = hn[k];
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[j] = fmaf(hv, wv[j], acc[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) lg[part * E + grp * 8 + j] = acc[j];
    }
    __syncthreads();
    for (int e = tid; e < E; e += kThreads) {
      float t = 0.f;
      for (int q = 0; q < parts; ++q) t += lg[q * E + e];
      logit[e] = t;
    }
    __syncthreads();
    if (tid < 32) {
      // Softmax over the experts, then top-k: k rounds of the warp's
      // (max, lowest index) pick, each retiring its expert.
      constexpr int kPer = kMaxExperts / 32;
      const int lane = tid;
      float pr[kPer], cw[kPer];
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int e = lane + 32 * j;
        pr[j] = e < E ? logit[e] : -INFINITY;
        m = fmaxf(m, pr[j]);
      }
      m = warp_max(m);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        pr[j] = lane + 32 * j < E ? expf(pr[j] - m) : 0.f;
        s += pr[j];
      }
      s = warp_sum(s);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        // Retired and absent experts sit below every probability.
        pr[j] = lane + 32 * j < E ? pr[j] / s : -2.f;
        cw[j] = 0.f;
      }
      for (int it = 0; it < p.topk; ++it) {
        float v = -3.f;
        int idx = kIdxNone;
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          if (better(pr[j], lane + 32 * j, v, idx)) {
            v = pr[j];
            idx = lane + 32 * j;
          }
        warp_argmax(v, idx);
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          if (lane + 32 * j == idx) {
            cw[j] = pr[j];
            pr[j] = -1.f;
          }
      }
      if (p.norm_topk) {
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < kPer; ++j) t += cw[j];
        t = warp_sum(t);
#pragma unroll
        for (int j = 0; j < kPer; ++j) cw[j] = cw[j] / t;
      }
      float* route = p.moe_route == nullptr
                         ? nullptr
                         : p.moe_route + ((size_t)step * p.L + layer) * E * B;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int e = lane + 32 * j;
        if (e < E) {
          p.moe_w[(size_t)e * B + b] = cw[j];
          if (route != nullptr) route[(size_t)e * B + b] = cw[j];
        }
      }
    }
    __syncthreads();
  }
}

// K splits of an expert's GEMM with `ntiles` column tiles: as many as fill
// the grid once (an expert's GEMMs are small: one unit a block, not the
// dense path's doubling, which leaves some blocks two), each keeping >= 64
// rows.
__device__ __forceinline__ int pick_split_fill(int ntiles, int K) {
  int s = max(1, min(kMaxSplit, (int)gridDim.x / ntiles));
  while (s > 1 && K / s < 64) --s;
  return s;
}

// MOE_FFN of local expert e (see the header): skipped when no row routes
// to it; arg1 = 1 then hands moe_acc to ALLREDUCE through h. kTp: the
// rank's (blockIdx.y's) expert-parallel experts, E / n of them in its
// w1/w2, the combine weights those of global expert rank * E / n + e.
template <typename T, bool kTp>
__device__ __noinline__ void moe_ffn(const Params& p, int layer, int e,
                                     int arg1, float* xs, float* red,
                                     float* rstd) {
  const int B = p.B, d = p.d, f = p.f, N1 = 2 * f;
  const size_t gtid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t gthreads = (size_t)gridDim.x * kThreads;
  const int e_loc = kTp ? p.E / (int)gridDim.y : p.E;
  const float* cw =
      p.moe_w + (size_t)(kTp ? (int)blockIdx.y * e_loc + e : e) * B;
  bool routed = false;
  for (int b = 0; b < B; ++b) routed = routed || __ldcg(cw + b) != 0.f;
  const size_t BD = (size_t)B * d;
  if (routed) {
    const size_t ex = (size_t)layer * e_loc + e;
    const T* w1 = reinterpret_cast<const T*>(p.w1) + ex * d * N1;
    const T* w2 = reinterpret_cast<const T*>(p.w2) + ex * f * d;
    int S = pick_split_fill((N1 + kTileN - 1) / kTileN, d);
    gemm_partials<T, T>(w1, d, N1, B, S, p.h, (const T*)nullptr, rstd,
                        p.part, xs, red);
    grid_sync(p.bar);
    const size_t BN = (size_t)B * N1;
    for (size_t i = gtid; i < (size_t)B * f; i += gthreads) {
      const size_t b = i / f, c = i % f;
      const float gt = sum_parts(p.part, S, BN, b * N1 + c);
      const float up = sum_parts(p.part, S, BN, b * N1 + f + c);
      p.mlp[i] = gt * (1.0f / (1.0f + expf(-gt))) * up;
    }
    grid_sync(p.bar);
    S = pick_split_fill((d + kTileN - 1) / kTileN, f);
    gemm_partials<T, T>(w2, f, d, B, S, p.mlp, (const T*)nullptr, rstd,
                        p.part2, xs, red);
    grid_sync(p.bar);
    // Same elements on the same threads as every other moe_acc access.
    for (size_t i = gtid; i < BD; i += gthreads)
      p.moe_acc[i] = __ldcg(p.moe_acc + i) +
                     sum_parts(p.part2, S, BD, i) * __ldcg(cw + i / d);
  }
  if (arg1 == 1)
    for (size_t i = gtid; i < BD; i += gthreads) p.h[i] = __ldcg(p.moe_acc + i);
}

// -- the device task tracer ---------------------------------------------------
//
// Block 0, thread 0 reads clock64() once at every task boundary, after the
// previous task's closing grid barrier: that read ends the previous record
// and begins the next, so a record spans the whole grid's work on its
// task (a task without a closing barrier, O_PROJ/FC2 before ALLREDUCE,
// spans block 0's part). Ticks are stored relative to the launch's first
// read as int32 (2^31 cycles, ~1 s at 1.98 GHz). Not inlined: a greedy
// launch carries only the pointer test at each boundary.

// Record `idx` (step * T + t) begins and record idx - 1 ends; idx ==
// nsteps * T only ends the last one.
__device__ __noinline__ void trace_mark(const Params& p, int idx,
                                        long long* t0) {
  const long long now = clock64();
  if (idx == 0) *t0 = now;
  const int rel = (int)(now - *t0);
  if (idx > 0) {
    int* r = p.trace + (size_t)(idx - 1) * kTraceInts;
    r[kTrEnd] = rel;
    r[kTrFlag] = 1;
  }
  if (idx < p.nsteps * p.T) {
    int* r = p.trace + (size_t)idx * kTraceInts;
    const int* h = p.table + (idx % p.T) * 8;
    r[kTrTaskId] = h[4];
    r[kTrOpcode] = h[0];
    r[kTrLayer] = h[1];
    r[kTrSlot] = h[2];
    r[kTrBegin] = rel;
    r[kTrMid] = 0;
  }
}

// Record idx's mid column: a clock read (ALLREDUCE's phase mark).
__device__ __noinline__ void trace_mid(const Params& p, int idx,
                                       const long long* t0) {
  p.trace[(size_t)idx * kTraceInts + kTrMid] = (int)(clock64() - *t0);
}

// Dynamic shared memory of a block (floats): the per-row values
// (rstd, best_v, best_i, tok_s: [B] each), the GEMM reduction buffer
// red [kWarps][kGroupB][kTileN], the LM head's tile [kGroupB][kTileN],
// then `region` for GEMM input staging or the attention phases.
__host__ __device__ __forceinline__ size_t smem_floats(int B, int region) {
  return 4 * (size_t)B + (size_t)kWarps * kGroupB * kTileN +
         kGroupB * kTileN + region;
}

// T: model dtype; WT: projection weights (T or int8_t); CT: cache (T or
// int8_t); kSample: a sampled launch (the noise, and the filtered pass when
// p.filtered); kTrace: a traced or ring launch (the tracer's stamps when
// p.trace is set, and the RING_POLL task); kMoE: an MoE graph (the MoE
// library's instantiations); kTp: a launch over n > 1 ranks (its argument
// is a TpParams, the grid (G, n); BARRIER, AR_SEND, AR_WAIT and the
// exchanges). The other launches run instantiations without that code, so
// that it weighs nothing on their registers.
template <typename T, typename WT, typename CT, bool kSample, bool kTrace,
          bool kMoE, bool kTp>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSM)
    mega_kernel(const __grid_constant__ typename KernelArg<kTp>::type arg) {
  const Params& p = rank_params(arg);
  constexpr bool kQ8 = sizeof(WT) == 1;
  extern __shared__ __align__(16) float smem[];
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
  const WT* wqkv = reinterpret_cast<const WT*>(p.wqkv);
  const WT* wo = reinterpret_cast<const WT*>(p.wo);
  const WT* w1 = reinterpret_cast<const WT*>(p.w1);
  const WT* w2 = reinterpret_cast<const WT*>(p.w2);
  const T* ln1 = reinterpret_cast<const T*>(p.ln1);
  const T* ln2 = reinterpret_cast<const T*>(p.ln2);
  __shared__ long long trace_t0;  // the launch's first clock read
  const bool tracer =
      kTrace && p.trace != nullptr && blockIdx.x == 0 && tid == 0;
  for (int b = tid; b < B; b += kThreads) tok_s[b] = p.tokens[b];
  __syncthreads();
  // kTp: this block's rank, the launch's exchange ordinal (every block
  // walks the same exchanges in the same order), the partials' and the
  // candidates' exchange counts (their slot sets alternate) and the
  // pending AR_SEND's ordinal and set.
  // kTp with kMoE: the phase-0 combine exchanges' count (their own slot
  // sets alternate) and the pending phase 0's ordinal and set.
  [[maybe_unused]] const int me = blockIdx.y;
  [[maybe_unused]] int xe = 0, n_ar = 0, n_lm = 0, send_e = 0, send_par = 0;
  [[maybe_unused]] int n_a2 = 0, a2_e = 0, a2_par = 0;

  for (int step = 0; step < p.nsteps; ++step) {
    for (int t = 0; t < p.T; ++t) {
      const int type = p.table[t * 8], layer = p.table[t * 8 + 1];
      const int arg0 = p.table[t * 8 + 2];
      const int next = t + 1 < p.T ? p.table[(t + 1) * 8] : -1;
      if constexpr (kTrace) {
        if (tracer) trace_mark(p, step * p.T + t, &trace_t0);
      }
      switch (type) {
        case kEmbed: {
          const T* emb = reinterpret_cast<const T*>(p.embed);
          for (size_t i = gtid; i < (size_t)B * d; i += gthreads) {
            const int b = (int)(i / d), k = (int)(i % d);
            const int tok = min(max(tok_s[b], 0), p.vocab - 1);
            p.x[i] = to_f32(emb[(size_t)tok * d + k]);
          }
          grid_sync(p.bar);
          break;
        }
        case kNorm: {
          const T* w = arg0 == 0   ? ln1 + (size_t)layer * d
                       : arg0 == 1 ? ln2 + (size_t)layer * d
                                   : reinterpret_cast<const T*>(p.normf);
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
          const WT* w = qkv ? wqkv + (size_t)layer * d * N
                            : w1 + (size_t)layer * d * N;
          // wq8: this layer's per-column scales, applied to the sums.
          const float* sc =
              kQ8 ? (qkv ? p.sc_qkv : p.sc_w1) + (size_t)layer * N : nullptr;
          const T* normw = nullptr;
          if (p.fuse_norms) {
            normw = (qkv ? ln1 : ln2) + (size_t)layer * d;
            row_rstd(p.x, B, d, p.eps, rstd);
          }
          const int S = pick_split((N + kTileN - 1) / kTileN, d);
          gemm_partials<T, WT>(w, d, N, B, S, p.fuse_norms ? p.x : p.h,
                               normw, rstd, p.part, xs, red);
          grid_sync(p.bar);
          const size_t BN = (size_t)B * N;
          if (qkv) {
            for (size_t i = gtid; i < BN; i += gthreads) {
              float v = sum_parts(p.part, S, BN, i);
              if constexpr (kQ8) v *= sc[i % N];
              p.qkv[i] = v;
            }
          } else {
            const int f = p.f;
            for (size_t i = gtid; i < (size_t)B * f; i += gthreads) {
              const size_t b = i / f, c = i % f;
              float gt = sum_parts(p.part, S, BN, b * N + c);
              float up = sum_parts(p.part, S, BN, b * N + f + c);
              if constexpr (kQ8) {  // before SwiGLU
                gt *= sc[c];
                up *= sc[f + c];
              }
              p.mlp[i] = gt * (1.0f / (1.0f + expf(-gt))) * up;
            }
          }
          grid_sync(p.bar);
          break;
        }
        case kAttn: {
          attn_partials<T, CT>(p, layer, step, xs);
          grid_sync(p.bar);
          attn_merge<T>(p, layer, step, xs);
          grid_sync(p.bar);
          break;
        }
        case kOProj:
        case kFc2: {
          const bool o = type == kOProj;
          const int K = o ? oK : p.f;
          const WT* w = o ? wo + (size_t)layer * K * d
                          : w2 + (size_t)layer * K * d;
          const float* sc =
              kQ8 ? (o ? p.sc_o : p.sc_w2) + (size_t)layer * d : nullptr;
          const int S = pick_split((d + kTileN - 1) / kTileN, K);
          gemm_partials<T, WT>(w, K, d, B, S, o ? p.ao : p.mlp,
                               (const T*)nullptr, rstd, p.part, xs, red);
          grid_sync(p.bar);
          const size_t BN = (size_t)B * d;
          for (size_t i = gtid; i < BN; i += gthreads) {
            float v = sum_parts(p.part, S, BN, i);
            if constexpr (kQ8) v *= sc[i % d];  // before the residual add
            p.h[i] = v;
          }
          // ALLREDUCE (and AR_SEND) reads exactly these elements on these
          // threads.
          if constexpr (kTp) {
            if (next != kAllReduce && next != kArSend) grid_sync(p.bar);
          } else {
            if (next != kAllReduce) grid_sync(p.bar);
          }
          break;
        }
        case kAllReduce: {
          if constexpr (kTp) {
            const Comm& c = *comm_of(arg);
            if (step == 0 && n_ar == 0) straggle(c, me);
            const int par = n_ar++ & 1;
            const uint64_t v = xval(c, xe++);
            ar_push(p, c, me, par, v);
            xwait(c, me, v);
            // The phase mark: the partials have landed; the fold follows.
            if constexpr (kTrace) {
              if (tracer) trace_mid(p, step * p.T + t, &trace_t0);
            }
            ar_fold(p, c, me, par);
          } else {
            // The phase mark between the exchange (none at tp=1) and the
            // fold, as the TPU kernel's trace_mid.
            if constexpr (kTrace) {
              if (tracer) trace_mid(p, step * p.T + t, &trace_t0);
            }
            for (size_t i = gtid; i < (size_t)B * d; i += gthreads)
              p.x[i] = __ldcg(p.x + i) + __ldcg(p.h + i);
          }
          grid_sync(p.bar);
          break;
        }
        case kLmHead: {
          lm_head<T, WT, kSample>(p, step, xs, red, tile, rstd, best_v,
                                  best_i);
          grid_sync(p.bar);
          if (kSample && p.argmax && p.filtered) {
            // One block per row finds the row's winner (p.argi[b]).
            for (int b = blockIdx.x; b < B; b += gridDim.x)
              filtered_winner(p, step, b, xs);
            grid_sync(p.bar);
          }
          if constexpr (kTp) {
            if (p.argmax) {
              const Comm& c = *comm_of(arg);
              lm_exchange(p, c, me, step, n_lm++ & 1, xval(c, xe++), tok_s);
            }
          } else if (p.argmax) {
            for (int b = tid; b < B; b += kThreads) {
              float bv = -INFINITY;
              int bi = kIdxNone;
              if (kSample && p.filtered) {
                bi = __ldcg(p.argi + b);
              } else {
                for (int blk = 0; blk < (int)gridDim.x; ++blk) {
                  const float v = __ldcg(p.argv + (size_t)blk * B + b);
                  const int i = __ldcg(p.argi + (size_t)blk * B + b);
                  if (better(v, i, bv, bi)) { bv = v; bi = i; }
                }
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
          // The MoE tasks, in kMoE instantiations only.
          if constexpr (kMoE) {
            if (type == kMoeGate) {
              moe_gate<T>(p, step, layer, xs, rstd);
              grid_sync(p.bar);
              break;
            }
            if (type == kMoeFfn) {
              moe_ffn<T, kTp>(p, layer, arg0, p.table[t * 8 + 3], xs, red,
                              rstd);
              // The next task reads moe_acc or h element by element on
              // these threads; anything else waits for the grid.
              if (next != kMoeFfn && next != kA2aSend && next != kAllReduce)
                grid_sync(p.bar);
              break;
            }
            if (type == kA2aSend || type == kA2aWait) {
              const bool wait = type == kA2aWait;
              if constexpr (kTp) {
                // The expert-parallel combine: each phase's partial to
                // every peer (phase 0 its own slot sets, phase 1 the
                // partials sets ALLREDUCE uses), then the wait for both
                // and the fold in rank order.
                const Comm& c = *comm_of(arg);
                if (!wait) {
                  if (arg0 == 0 && step == 0 && n_a2 == 0) straggle(c, me);
                  const int par = arg0 == 0 ? n_a2++ & 1 : n_ar++ & 1;
                  const int e = xe++;
                  if (arg0 == 0) {
                    a2_e = e;
                    a2_par = par;
                  } else {
                    send_e = e;
                    send_par = par;
                  }
                  a2a_push(p, c, me, arg0, par, xval(c, e));
                  // The phase mark: this phase's puts are out.
                  if constexpr (kTrace) {
                    if (tracer) trace_mid(p, step * p.T + t, &trace_t0);
                  }
                } else {
                  // The phase mark before the wait (where the TPU body
                  // has fired the next weight stream's tile 0).
                  if constexpr (kTrace) {
                    if (tracer) trace_mid(p, step * p.T + t, &trace_t0);
                  }
                  xwait(c, me, xval(c, a2_e));
                  xwait(c, me, xval(c, send_e));
                  a2a_fold(p, c, me, a2_par, send_par);
                  grid_sync(p.bar);
                }
                break;
              }
              if constexpr (kTrace) {
                if (wait && tracer) trace_mid(p, step * p.T + t, &trace_t0);
              }
              for (size_t i = gtid; i < (size_t)B * d; i += gthreads) {
                if (wait) {
                  p.x[i] = __ldcg(p.x + i) + __ldcg(p.a2buf + i) +
                           __ldcg(p.cbuf + i);
                } else if (arg0 == 0) {
                  p.a2buf[i] = __ldcg(p.moe_acc + i);
                  p.moe_acc[i] = 0.f;
                } else {
                  p.cbuf[i] = __ldcg(p.moe_acc + i);
                }
              }
              if constexpr (kTrace) {
                if (!wait && tracer) trace_mid(p, step * p.T + t, &trace_t0);
              }
              if (wait) grid_sync(p.bar);
              break;
            }
          }
          // The cross-rank tasks, in kTp instantiations only.
          if constexpr (kTp) {
            const Comm& c = *comm_of(arg);
            if (type == kBarrier) {
              tdt::barrier_all(c.flag_tab, me, c.n, xval(c, xe++),
                               blockIdx.x == 0);
              break;
            }
            if (type == kArSend) {
              if (step == 0 && n_ar == 0) straggle(c, me);
              send_par = n_ar++ & 1;
              send_e = xe++;
              ar_push(p, c, me, send_par, xval(c, send_e));
              // The phase mark: every put is out.
              if constexpr (kTrace) {
                if (tracer) trace_mid(p, step * p.T + t, &trace_t0);
              }
              break;
            }
            if (type == kArWait) {
              // The phase mark before the wait (where the TPU body has
              // fired the next weight stream's tile 0).
              if constexpr (kTrace) {
                if (tracer) trace_mid(p, step * p.T + t, &trace_t0);
              }
              xwait(c, me, xval(c, send_e));
              ar_fold(p, c, me, send_par);
              grid_sync(p.bar);
              break;
            }
          }
          // RING_POLL: only ring launches have it, and they run a kTrace
          // instantiation; untraced, it is a no-op. Kept out of the case
          // labels, so that the other instantiations compile the switch
          // (and allocate its registers) as before.
          if constexpr (kTrace) {
            if (type == kRingPoll) {
              // The doorbell this round observed, into its record's mid.
              if (tracer && p.ring_state != nullptr)
                p.trace[(size_t)(step * p.T + t) * kTraceInts + kTrMid] =
                    p.ring_state[0];
              break;
            }
          }
          __trap();
      }
    }
  }
  if constexpr (kTrace) {
    if (tracer) trace_mark(p, p.nsteps * p.T, &trace_t0);
  }
}

// Dynamic shared memory of one decode block (bytes).
size_t decode_smem(const Params& p, bool moe) {
  const int g = p.hq / p.hkv;
  const int kmax = max(p.d, max(p.hq * p.hd, p.f));
  const int attn_b = 3 * kAttnChunk + g * p.hd + g * kAttnChunk + p.hd +
                     2 * g + kThreads * g;
  const int attn_m = g * p.hd + g * (p.nsteps + 1);
  int region = max(min(p.B, kGroupB) * kmax, max(attn_b, attn_m));
  if (p.filtered) region = max(region, kFiltFloats);
  if (moe) region = max(region, p.d + 8 * kThreads + p.E);  // the gate
  return sizeof(float) * smem_floats(p.B, region);
}

// Carve the workspace (base p.x) for a launch of nblk blocks a rank;
// megakernel/code_generator.py sizes it. Returns false if it is too small.
bool carve(Params& p, long long ws_floats, int nblk, bool moe) {
  float* ws = p.x;
  size_t off = 0;
  auto take = [&](size_t n) { float* r = ws + off; off += n; return r; };
  const size_t B = p.B;
  const int g = p.hq / p.hkv;
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
  if (moe) {
    p.moe_w = take((size_t)p.E * B);
    p.moe_acc = take(B * p.d);
    p.a2buf = take(B * p.d);
    p.cbuf = take(B * p.d);
    p.part2 = take((size_t)kMaxSplit * B * p.d);
  }
  return (long long)off <= ws_floats;
}

// The cooperative-launch geometry of kern: its SMs, the blocks per SM the
// occupancy calculator allows at smem bytes, and whether it may launch.
template <typename K>
cudaError_t geometry(K kern, size_t smem, int* sms, int* occ) {
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return cudaErrorNotSupported;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kern, kThreads, smem);
  if (e != cudaSuccess) return e;
  return *occ < 1 ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

template <typename T, typename WT, typename CT, bool kSample, bool kTrace,
          bool kMoE>
int launch(Params p, long long ws_floats, int* info, cudaStream_t stream) {
  auto kern = mega_kernel<T, WT, CT, kSample, kTrace, kMoE, false>;
  const size_t smem = decode_smem(p, kMoE);
  int sms = 0, occ = 0;
  cudaError_t e = geometry(kern, smem, &sms, &occ);
  if (e != cudaSuccess) return (int)e;
  const int nblk = sms * min(occ, kMaxBlocksPerSM);
  if (!carve(p, ws_floats, nblk, kMoE)) return (int)cudaErrorInvalidValue;
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

// One launch over tp.c.n ranks, G blocks each (blocks_per_rank, or the
// co-resident capacity over n): refused unless all n·G blocks can be
// resident at once.
template <typename T, bool kTrace, bool kMoE>
int launch_tp(TpParams& tp, long long ws_floats, int blocks_per_rank,
              int* info, cudaStream_t stream) {
  auto kern = mega_kernel<T, T, T, false, kTrace, kMoE, true>;
  const int n = tp.c.n;
  const size_t smem = decode_smem(tp.p[0], kMoE);
  int sms = 0, occ = 0;
  cudaError_t e = geometry(kern, smem, &sms, &occ);
  if (e != cudaSuccess) return (int)e;
  const int cap = sms * min(occ, kMaxBlocksPerSM);
  const int G = blocks_per_rank > 0 ? blocks_per_rank : cap / n;
  if (G < 1 || (long long)G * n > cap || G > tp.c.g_cap)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  for (int r = 0; r < n; ++r)
    if (!carve(tp.p[r], ws_floats, G, kMoE))
      return (int)cudaErrorInvalidValue;
  info[0] = G;
  info[1] = (int)smem;
  info[2] = occ;
  void* args[] = {&tp};
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(G, n),
                                  dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Greedy or sampled, for one storage-type combination.
template <typename T, typename WT, typename CT, bool kMoE>
int launch_s(const Params& p, long long ws_floats, int* info,
             cudaStream_t s) {
  if (p.trace != nullptr || p.ring_state != nullptr)
    return p.sampled
               ? launch<T, WT, CT, true, true, kMoE>(p, ws_floats, info, s)
               : launch<T, WT, CT, false, true, kMoE>(p, ws_floats, info, s);
  return p.sampled
             ? launch<T, WT, CT, true, false, kMoE>(p, ws_floats, info, s)
             : launch<T, WT, CT, false, false, kMoE>(p, ws_floats, info, s);
}

// The weight and cache storage types of one model dtype T. The MoE build
// has no int8 weights (wq8 does not compose with MoE).
template <typename T, bool kMoE>
int launch_t(const Params& p, int wq8, int kv_quant, long long ws_floats,
             int* info, cudaStream_t s) {
  if constexpr (kMoE) {
    if (wq8) return (int)cudaErrorInvalidValue;
  } else {
    if (wq8)
      return kv_quant
                 ? launch_s<T, int8_t, int8_t, false>(p, ws_floats, info, s)
                 : launch_s<T, int8_t, T, false>(p, ws_floats, info, s);
  }
  return kv_quant ? launch_s<T, T, int8_t, kMoE>(p, ws_floats, info, s)
                  : launch_s<T, T, T, kMoE>(p, ws_floats, info, s);
}

// -- the prefill megakernel ---------------------------------------------------
//
// Replaces the prefill build of the same pallas_call: load_x_body
// (triton_distributed_tpu/megakernel/kernels.py:895), attn_prefill_body
// (:907) and lm_head_body's last-row projection (:1437), walking the table
// of build_prefill_graph once over the S prompt rows. Its own __global__,
// instantiated for (T, WT) only, so the decode kernel's registers and
// code do not change. The S rows take the decode kernel's place of the
// batch: the GEMMs run each 64-column tile over 4-row groups, one unit
// (tile, group) at a time with the whole K range (S/4 groups give the
// blocks their parallelism, so K is not split), contiguous units per
// block so that a block's consecutive units share a weight tile.
//
// What bounds it on the H100: at S = 256, bytes (every layer weight once,
// 0.88 GB at Qwen3-0.6B in bf16, plus the LM head's 0.31 GB) against ~0.23
// TFLOP; this simple kernel re-reads each weight tile once per 4-row
// group, mostly from L2, and runs its products on FMA pipes, so it is
// far from that bound (a tiled tensor-core GEMM is later work).

constexpr int kPrefillRows = 8;   // query rows per attention unit (a warp each)
constexpr int kPrefillKeys = 32;  // keys staged per chunk

// rstd[r] = rsqrt(mean(x[r]^2) + eps) for the S rows, a warp per row
// over the grid; with out, also out[r][k] = x[r][k] * rstd[r] * w[k].
template <typename T>
__device__ void rows_rstd(const float* x, int S, int d, float eps,
                          float* rstd, float* out, const T* w) {
  const int lane = threadIdx.x % 32;
  const int gw = blockIdx.x * kWarps + threadIdx.x / 32;
  for (int r = gw; r < S; r += gridDim.x * kWarps) {
    const float* xr = x + (size_t)r * d;
    float ss = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float v = __ldcg(xr + i);
      ss += v * v;
    }
    const float rs = rsqrtf(warp_sum(ss) / (float)d + eps);
    if (rstd != nullptr && lane == 0) rstd[r] = rs;
    if (out != nullptr)
      for (int i = lane; i < d; i += 32)
        out[(size_t)r * d + i] = __ldcg(xr + i) * rs * to_f32(w[i]);
  }
}

// out[S][N] = src[S][K] @ w[K][N] (src rounded to T, with normw the
// inline norm src * rstd[r] * normw[k]; each sum times colscale[n] under
// wq8). Units (tile, 4-row group), a contiguous range per block.
template <typename T, typename WT>
__device__ void gemm_rows(const WT* w, int K, int N, int S, const float* src,
                          const T* normw, const float* rstd, float* out,
                          const float* colscale, float* xs, float* red,
                          float* rs) {
  const int ntiles = (N + kTileN - 1) / kTileN;
  const int ngroups = (S + kGroupB - 1) / kGroupB;
  const int units = ntiles * ngroups;
  const int per = (units + gridDim.x - 1) / gridDim.x;
  const int u0 = blockIdx.x * per, u1 = min(units, u0 + per);
  for (int u = u0; u < u1; ++u) {
    const int tile = u / ngroups, g = u % ngroups;
    const int b0 = g * kGroupB, bg = min(kGroupB, S - b0);
    if (normw != nullptr) {
      if (threadIdx.x < bg) rs[threadIdx.x] = __ldcg(rstd + b0 + threadIdx.x);
      __syncthreads();
    }
    stage_input<T>(src + (size_t)b0 * K, K, normw, rs, bg, 0, K, xs);
    gemm_tile<WT>(w, N, tile * kTileN, 0, K, xs, bg, red,
                  out + (size_t)b0 * N, N, nullptr, colscale);
  }
}

// ATTN_PREFILL phase 1, a warp per (row r, q or k head): QK-norm, rope
// at position r (q also times the softmax scale) into qf / kf in f32; a k
// head also writes its K and V rows to knew / vnew [L, hkv, S, hd] in T.
template <typename T>
__device__ void prefill_heads(const Params& p, int layer, float* sm) {
  const int S = p.B, hq = p.hq, hkv = p.hkv, hd = p.hd;
  const int qkvN = (hq + 2 * hkv) * hd, lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float* scr = sm + warp * hd;
  const T* qn = reinterpret_cast<const T*>(p.qn) + (size_t)layer * hd;
  const T* kn = reinterpret_cast<const T*>(p.kn) + (size_t)layer * hd;
  T* knew = reinterpret_cast<T*>(p.knew);
  T* vnew = reinterpret_cast<T*>(p.vnew);
  const int gw = blockIdx.x * kWarps + warp;
  for (int it = gw; it < S * (hq + hkv); it += gridDim.x * kWarps) {
    const int r = it / (hq + hkv), hi = it % (hq + hkv);
    const float* row = p.qkv + (size_t)r * qkvN;
    const bool isq = hi < hq;
    head_prep<T>(row + hi * hd, isq ? qn : kn, hd, p.eps, r, p.inv_freq,
                 isq ? p.sm_scale : 1.0f, scr);
    if (isq) {
      for (int i = lane; i < hd; i += 32)
        p.qf[((size_t)hi * S + r) * hd + i] = scr[i];
    } else {
      const int kh = hi - hq;
      const size_t o = (((size_t)layer * hkv + kh) * S + r) * hd;
      for (int i = lane; i < hd; i += 32) {
        p.kf[((size_t)kh * S + r) * hd + i] = scr[i];
        knew[o + i] = from_f32<T>(scr[i]);
        vnew[o + i] = from_f32<T>(__ldcg(row + (hq + hkv + kh) * hd + i));
      }
    }
    __syncwarp();
  }
}

// ATTN_PREFILL phase 2, units (q head, block of kPrefillRows rows), a warp
// per row: one causal softmax over keys 0..r with the f32 K (kf) and V
// (the qkv rows), the two passes of the TPU body (scores, then P·V over
// the normalised weights), K and V staged kPrefillKeys rows at a time.
__device__ void prefill_attend(const Params& p, float* sm) {
  const int S = p.B, hq = p.hq, hkv = p.hkv, hd = p.hd, g = hq / hkv;
  const int qkvN = (hq + 2 * hkv) * hd, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, kp = hd + 1;
  float* qv = sm;                                 // [rows][hd]
  float* kv = qv + kPrefillRows * hd;             // [keys][hd + 1]
  float* sc = kv + kPrefillKeys * kp;             // [rows][S]
  const int nrb = (S + kPrefillRows - 1) / kPrefillRows;
  for (int u = blockIdx.x; u < hq * nrb; u += gridDim.x) {
    const int h = u % hq, rb = nrb - 1 - u / hq;  // the long rows first
    const int kvh = h / g, r0 = rb * kPrefillRows;
    const int r = r0 + warp, kend = min(S, r0 + kPrefillRows);
    const float* kf = p.kf + (size_t)kvh * S * hd;
    const float* vf = p.qkv + (hq + hkv + kvh) * hd;
    for (int i = tid; i < kPrefillRows * hd; i += kThreads) {
      const int rr = r0 + i / hd;
      qv[i] = rr < S ? __ldcg(p.qf + ((size_t)h * S + rr) * hd + i % hd)
                     : 0.f;
    }
    // Scores: lane j takes key c0 + j of the staged chunk.
    for (int c0 = 0; c0 < kend; c0 += kPrefillKeys) {
      const int nk = min(kPrefillKeys, kend - c0);
      __syncthreads();
      for (int i = tid; i < nk * hd; i += kThreads)
        kv[(i / hd) * kp + i % hd] = __ldcg(kf + (size_t)c0 * hd + i);
      __syncthreads();
      const int key = c0 + lane;
      if (warp < kPrefillRows && r < S && lane < nk && key <= r) {
        float dot = 0.f;
        for (int i = 0; i < hd; ++i)
          dot = fmaf(qv[warp * hd + i], kv[lane * kp + i], dot);
        sc[warp * S + key] = dot;
      }
    }
    __syncwarp();  // the row's scores came from every lane of the warp
    float m = -INFINITY, l = 0.f;
    if (r < S) {
      for (int k = lane; k <= r; k += 32) m = fmaxf(m, sc[warp * S + k]);
      m = warp_max(m);
      for (int k = lane; k <= r; k += 32) {
        const float e = expf(sc[warp * S + k] - m);
        sc[warp * S + k] = e;
        l += e;
      }
      l = warp_sum(l);
    }
    float acc[kMaxHd / 32];
#pragma unroll
    for (int j = 0; j < kMaxHd / 32; ++j) acc[j] = 0.f;
    for (int c0 = 0; c0 < kend; c0 += kPrefillKeys) {
      const int nk = min(kPrefillKeys, kend - c0);
      __syncthreads();
      for (int i = tid; i < nk * hd; i += kThreads)
        kv[(i / hd) * kp + i % hd] =
            __ldcg(vf + (size_t)(c0 + i / hd) * qkvN + i % hd);
      __syncthreads();
      if (r < S) {
        const int n = min(nk, r - c0 + 1);
        for (int j = 0; j < n; ++j) {
          const float pj = sc[warp * S + c0 + j];
#pragma unroll
          for (int q = 0; q < kMaxHd / 32; ++q)
            if (q < hd / 32)
              acc[q] = fmaf(pj, kv[j * kp + lane + 32 * q], acc[q]);
        }
      }
    }
    if (r < S) {
#pragma unroll
      for (int q = 0; q < kMaxHd / 32; ++q)
        if (q < hd / 32)
          p.ao[(size_t)r * hq * hd + h * hd + lane + 32 * q] = acc[q] / l;
    }
  }
}

// Dynamic shared memory of the prefill kernel (floats): the GEMM
// reduction buffer, the 4 staged rstd values, then the region for GEMM
// input staging or the attention phases. megakernel/code_generator.py
// (prefill_smem_bytes) mirrors it.
__host__ __device__ __forceinline__ size_t prefill_region(int S, int kmax,
                                                          int hd) {
  const size_t gemm = (size_t)kGroupB * kmax;
  const size_t heads = (size_t)kWarps * hd;
  const size_t attend = (size_t)kPrefillRows * hd +
                        (size_t)kPrefillKeys * (hd + 1) +
                        (size_t)kPrefillRows * S;
  const size_t m = gemm > heads ? gemm : heads;
  return m > attend ? m : attend;
}

// kTp: the prefill graph over n > 1 co-located ranks, as mega_kernel's kTp
// (a TpParams argument, the grid (G, n), every split over blockIdx.x /
// gridDim.x rank-local): the entry BARRIER, and each ALLREDUCE's [S, d]
// partials through the exchange (ar_push / ar_fold: two alternating slot
// sets of S * d floats a source rank).
template <typename T, typename WT, bool kTp>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSM)
    mega_prefill_kernel(
        const __grid_constant__ typename KernelArg<kTp>::type arg) {
  const Params& p = rank_params(arg);
  constexpr bool kQ8 = sizeof(WT) == 1;
  extern __shared__ __align__(16) float smem[];
  float* red = smem;
  float* rs = red + kWarps * kGroupB * kTileN;
  float* xs = rs + kGroupB;  // 16-byte aligned
  const int tid = threadIdx.x;
  const size_t gtid = (size_t)blockIdx.x * kThreads + tid;
  const size_t gthreads = (size_t)gridDim.x * kThreads;
  const int S = p.B, d = p.d, hd = p.hd;
  const int qkvN = (p.hq + 2 * p.hkv) * hd, oK = p.hq * hd;
  const WT* wqkv = reinterpret_cast<const WT*>(p.wqkv);
  const WT* wo = reinterpret_cast<const WT*>(p.wo);
  const WT* w1 = reinterpret_cast<const WT*>(p.w1);
  const WT* w2 = reinterpret_cast<const WT*>(p.w2);
  const T* ln1 = reinterpret_cast<const T*>(p.ln1);
  const T* ln2 = reinterpret_cast<const T*>(p.ln2);
  const T* normf = reinterpret_cast<const T*>(p.normf);
  // kTp: this block's rank, the exchange ordinal and the partials' count.
  [[maybe_unused]] const int me = blockIdx.y;
  [[maybe_unused]] int xe = 0, n_ar = 0;
  for (int t = 0; t < p.T; ++t) {
    const int type = p.table[t * 8], layer = p.table[t * 8 + 1];
    const int arg0 = p.table[t * 8 + 2];
    switch (type) {
      case kLoadX: {
        const T* x0 = reinterpret_cast<const T*>(p.x0);
        for (size_t i = gtid; i < (size_t)S * d; i += gthreads)
          p.x[i] = to_f32(x0[i]);
        grid_sync(p.bar);
        break;
      }
      case kNorm: {
        const T* w = arg0 == 0   ? ln1 + (size_t)layer * d
                     : arg0 == 1 ? ln2 + (size_t)layer * d
                                 : normf;
        rows_rstd<T>(p.x, S, d, p.eps, nullptr, p.h, w);
        grid_sync(p.bar);
        break;
      }
      case kQkv:
      case kFc1: {
        const bool qkv = type == kQkv;
        const int N = qkv ? qkvN : 2 * p.f;
        const WT* w = qkv ? wqkv + (size_t)layer * d * N
                          : w1 + (size_t)layer * d * N;
        const float* sc =
            kQ8 ? (qkv ? p.sc_qkv : p.sc_w1) + (size_t)layer * N : nullptr;
        const T* normw = nullptr;
        if (p.fuse_norms) {
          normw = (qkv ? ln1 : ln2) + (size_t)layer * d;
          rows_rstd<T>(p.x, S, d, p.eps, p.rstd, nullptr, normw);
          grid_sync(p.bar);
        }
        gemm_rows<T, WT>(w, d, N, S, p.fuse_norms ? p.x : p.h, normw, p.rstd,
                         qkv ? p.qkv : p.part, sc, xs, red, rs);
        grid_sync(p.bar);
        if (!qkv) {
          const int f = p.f;
          for (size_t i = gtid; i < (size_t)S * f; i += gthreads) {
            const size_t r = i / f, c = i % f;
            const float gt = __ldcg(p.part + r * N + c);
            const float up = __ldcg(p.part + r * N + f + c);
            p.mlp[i] = gt * (1.0f / (1.0f + expf(-gt))) * up;
          }
          grid_sync(p.bar);
        }
        break;
      }
      case kAttnPrefill: {
        prefill_heads<T>(p, layer, xs);
        grid_sync(p.bar);
        prefill_attend(p, xs);
        grid_sync(p.bar);
        break;
      }
      case kOProj:
      case kFc2: {
        const bool o = type == kOProj;
        const int K = o ? oK : p.f;
        const WT* w = o ? wo + (size_t)layer * K * d
                        : w2 + (size_t)layer * K * d;
        const float* sc =
            kQ8 ? (o ? p.sc_o : p.sc_w2) + (size_t)layer * d : nullptr;
        gemm_rows<T, WT>(w, K, d, S, o ? p.ao : p.mlp, (const T*)nullptr,
                         nullptr, p.h, sc, xs, red, rs);
        grid_sync(p.bar);
        break;
      }
      case kAllReduce: {
        if constexpr (kTp) {
          const Comm& c = *comm_of(arg);
          const int par = n_ar++ & 1;
          const uint64_t v = xval(c, xe++);
          ar_push(p, c, me, par, v);
          xwait(c, me, v);
          ar_fold(p, c, me, par);
        } else {
          for (size_t i = gtid; i < (size_t)S * d; i += gthreads)
            p.x[i] = __ldcg(p.x + i) + __ldcg(p.h + i);
        }
        grid_sync(p.bar);
        break;
      }
      case kLmHead: {
        // Only the last real row, kv_len[0] - 1: its inline norm (or the
        // NORM task's h row), then the vocab tiles over the blocks.
        const int r = min(max(p.kv_len[0], 1), S) - 1;
        const float* src = (p.fuse_norms ? p.x : p.h) + (size_t)r * d;
        if (p.fuse_norms) {
          if (tid < 32) {
            float ss = 0.f;
            for (int i = tid; i < d; i += 32) {
              const float v = __ldcg(src + i);
              ss += v * v;
            }
            ss = warp_sum(ss);
            if (tid == 0) rs[0] = rsqrtf(ss / (float)d + p.eps);
          }
          __syncthreads();
        }
        stage_input<T>(src, d, p.fuse_norms ? normf : nullptr, rs, 1, 0, d,
                       xs);
        const WT* w = reinterpret_cast<const WT*>(p.lm_head);
        const int ntiles = (p.v_pad + kTileN - 1) / kTileN;
        for (int u = blockIdx.x; u < ntiles; u += gridDim.x)
          gemm_tile<WT>(w, p.v_pad, u * kTileN, 0, d, xs, 1, red, p.logits,
                        p.v_pad, nullptr, kQ8 ? p.sc_lm : nullptr);
        grid_sync(p.bar);
        break;
      }
      default:
        if constexpr (kTp) {
          if (type == kBarrier) {
            const Comm& c = *comm_of(arg);
            tdt::barrier_all(c.flag_tab, me, c.n, xval(c, xe++),
                             blockIdx.x == 0);
            break;
          }
        }
        __trap();
    }
  }
}

// Dynamic shared memory of one prefill block (bytes).
size_t prefill_smem(const Params& p) {
  const int kmax = max(p.d, max(p.hq * p.hd, p.f));
  return sizeof(float) * ((size_t)kWarps * kGroupB * kTileN + kGroupB +
                          prefill_region(p.B, kmax, p.hd));
}

// Carve the prefill workspace (base p.x); megakernel/code_generator.py
// sizes it. Returns false if it is too small.
bool carve_prefill(Params& p, long long ws_floats) {
  const int S = p.B, qkvN = (p.hq + 2 * p.hkv) * p.hd;
  float* ws = p.x;
  size_t off = 0;
  auto take = [&](size_t n) { float* r = ws + off; off += n; return r; };
  p.x = take((size_t)S * p.d);
  p.h = take((size_t)S * p.d);
  p.qkv = take((size_t)S * qkvN);
  p.ao = take((size_t)S * p.hq * p.hd);
  p.mlp = take((size_t)S * p.f);
  p.part = take((size_t)S * 2 * p.f);
  p.qf = take((size_t)p.hq * S * p.hd);
  p.kf = take((size_t)p.hkv * S * p.hd);
  p.rstd = take((size_t)S);
  return (long long)off <= ws_floats;
}

template <typename T, typename WT>
int launch_prefill(Params p, long long ws_floats, int* info,
                   cudaStream_t stream) {
  auto kern = mega_prefill_kernel<T, WT, false>;
  const size_t smem = prefill_smem(p);
  int sms = 0, occ = 0;
  cudaError_t e = geometry(kern, smem, &sms, &occ);
  if (e != cudaSuccess) return (int)e;
  const int nblk = sms * min(occ, kMaxBlocksPerSM);
  if (!carve_prefill(p, ws_floats)) return (int)cudaErrorInvalidValue;
  info[0] = nblk;
  info[1] = (int)smem;
  info[2] = occ;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(nblk),
                                  dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The prefill over tp.c.n ranks, G blocks each (as launch_tp).
template <typename T>
int launch_prefill_tp(TpParams& tp, long long ws_floats, int blocks_per_rank,
                      int* info, cudaStream_t stream) {
  auto kern = mega_prefill_kernel<T, T, true>;
  const int n = tp.c.n;
  const size_t smem = prefill_smem(tp.p[0]);
  int sms = 0, occ = 0;
  cudaError_t e = geometry(kern, smem, &sms, &occ);
  if (e != cudaSuccess) return (int)e;
  const int cap = sms * min(occ, kMaxBlocksPerSM);
  const int G = blocks_per_rank > 0 ? blocks_per_rank : cap / n;
  if (G < 1 || (long long)G * n > cap || G > tp.c.g_cap)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  for (int r = 0; r < n; ++r)
    if (!carve_prefill(tp.p[r], ws_floats)) return (int)cudaErrorInvalidValue;
  info[0] = G;
  info[1] = (int)smem;
  info[2] = occ;
  void* args[] = {&tp};
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(G, n),
                                  dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// One rank's prefill launch from tdt_mega_prefill's arrays (layout there):
// its Params, model dtype, workspace floats and wq8. False if they are not
// a launch this kernel takes.
bool parse_prefill(const unsigned long long* ptrs, const int* ints,
                   float eps, float sm_scale, Params& p, int& dtype,
                   long long& ws_floats, int& wq8) {
  int k = 0;
  p.x0 = (const void*)ptrs[k++];
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
  p.kv_len = (const int*)ptrs[k++];
  p.table = (const int*)ptrs[k++];
  p.inv_freq = (const float*)ptrs[k++];
  p.logits = (float*)ptrs[k++];
  p.knew = (void*)ptrs[k++];
  p.vnew = (void*)ptrs[k++];
  p.x = (float*)ptrs[k++];  // the workspace base, carved in carve_prefill
  p.bar = (unsigned*)ptrs[k++];
  p.sc_qkv = (const float*)ptrs[k++];
  p.sc_o = (const float*)ptrs[k++];
  p.sc_w1 = (const float*)ptrs[k++];
  p.sc_w2 = (const float*)ptrs[k++];
  p.sc_lm = (const float*)ptrs[k++];
  int i = 0;
  p.T = ints[i++];
  p.B = ints[i++];
  p.d = ints[i++];
  p.hq = ints[i++];
  p.hkv = ints[i++];
  p.hd = ints[i++];
  p.f = ints[i++];
  p.v_pad = ints[i++];
  p.L = ints[i++];
  p.fuse_norms = ints[i++];
  dtype = ints[i++];
  ws_floats = ints[i++];
  wq8 = ints[i++];
  p.nsteps = 1;
  p.eps = eps;
  p.sm_scale = sm_scale;
  return !(p.B < 1 || p.hkv < 1 || p.hq % p.hkv != 0 ||
           p.hq / p.hkv > kMaxGroup || p.hd % 32 != 0 || p.hd > kMaxHd ||
           p.d % 8 != 0 || p.v_pad % 8 != 0 ||
           ((p.hq + 2 * p.hkv) * p.hd) % 8 != 0 || (2 * p.f) % 8 != 0 ||
           (wq8 && (p.sc_qkv == nullptr || p.sc_o == nullptr ||
                    p.sc_w1 == nullptr || p.sc_w2 == nullptr ||
                    p.sc_lm == nullptr)));
}

// The exchange of a kTp launch (see Comm).
void set_comm(Comm& c, int n, const void* slot_tab, const void* flag_tab,
              unsigned long long epoch, int g_cap, int lag_rank,
              long long lag_ns) {
  c.slot_tab = static_cast<const int64_t*>(slot_tab);
  c.flag_tab = static_cast<const int64_t*>(flag_tab);
  c.base = epoch << 20;
  c.lag_ns = lag_ns;
  c.n = n;
  c.g_cap = g_cap;
  c.lag_rank = lag_rank;
}

// One rank's decode launch from tdt_mega_decode's arrays (layout there):
// its Params, model dtype, workspace floats, wq8 and kv_quant. False if they
// are not a launch this library takes (moe: the MoE library).
bool parse_decode(const unsigned long long* ptrs, const int* ints, float eps,
                  float sm_scale, bool moe, Params& p, int& dtype,
                  long long& ws_floats, int& wq8, int& kv_quant) {
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
  p.sc_qkv = (const float*)ptrs[k++];
  p.sc_o = (const float*)ptrs[k++];
  p.sc_w1 = (const float*)ptrs[k++];
  p.sc_w2 = (const float*)ptrs[k++];
  p.sc_lm = (const float*)ptrs[k++];
  p.ksc = (const float*)ptrs[k++];
  p.vsc = (const float*)ptrs[k++];
  p.noise = (const float*)ptrs[k++];
  p.sampcfg = (const float*)ptrs[k++];
  p.trace = (int*)ptrs[k++];
  p.ring_state = (const int*)ptrs[k++];
  p.wrouter = (const void*)ptrs[k++];
  p.moe_route = (float*)ptrs[k++];
  p.moe_x = (float*)ptrs[k++];
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
  dtype = ints[i++];
  ws_floats = ints[i++];
  p.vocab = ints[i++];
  p.argmax = ints[i++];
  wq8 = ints[i++];
  kv_quant = ints[i++];
  p.sampled = ints[i++];
  p.filtered = ints[i++];
  p.E = ints[i++];
  p.topk = ints[i++];
  p.norm_topk = ints[i++];
  p.nch = (p.s_cap + kAttnChunk - 1) / kAttnChunk;
  p.eps = eps;
  p.sm_scale = sm_scale;
  return !(p.B < 1 || p.hkv < 1 || p.hq % p.hkv != 0 ||
         p.hq / p.hkv > kMaxGroup || p.hd % 32 != 0 || p.hd > kMaxHd ||
         kThreads % p.hd != 0 ||
         p.nsteps < 1 || (p.eos && p.stop_tok == nullptr) ||
         (p.page > 0 && p.page_table == nullptr) || p.d % 8 != 0 ||
         p.v_pad % 8 != 0 || ((p.hq + 2 * p.hkv) * p.hd) % 8 != 0 ||
         (2 * p.f) % 8 != 0 ||
         (wq8 && (p.sc_qkv == nullptr || p.sc_o == nullptr ||
                  p.sc_w1 == nullptr || p.sc_w2 == nullptr ||
                  p.sc_lm == nullptr)) ||
         (kv_quant && (p.page == 0 || p.ksc == nullptr || p.vsc == nullptr)) ||
         (p.sampled && (p.noise == nullptr || !p.argmax)) ||
         (p.filtered && (p.sampcfg == nullptr || !p.sampled ||
                         p.v_pad % 4 != 0)) ||
         (moe ? (p.E < 8 || p.E > kMaxExperts || p.E % 8 != 0 || p.topk < 1 ||
                  p.topk > p.E || p.wrouter == nullptr)
              : p.E != 0));
}

}  // namespace

// ptrs: embed, wqkv, wo, w1, w2, lm_head, ln1, ln2, normf, qn, kn, kc, vc,
//   page_table (0 = dense), kv_len, tokens, stop_tok (0 without eos),
//   table, inv_freq, logits, knew, vnew, toks, stop_step, workspace,
//   barrier counter, then sc_qkv, sc_o, sc_w1, sc_w2, sc_lm (0 without
//   wq8), k_scale, v_scale (0 without kv_quant), noise (0 unless
//   sampled), sampcfg (0 unless filtered), the trace ring [NS, T, 8] (0 =
//   untraced), the work-ring snapshot [4] (0 without a ring).
// ints: T, nsteps, B, d, hq, hkv, hd, f, v_pad, v_real, L, s_cap (dense
//   S or pages_per_seq * page), page (0 = dense), pages_per_seq,
//   num_pages, fuse_norms, eos, dtype of the model (0 f32, 1 bf16),
//   workspace floats, vocab rows of embed, argmax (1 = multi-step build:
//   the LM head takes the argmax and feeds it back), wq8 (1 = int8
//   weights), kv_quant (1 = int8 pool, paged only), sampled (1 = the
//   argmax over logits + noise), filtered (1 = over each row's top-k/top-p
//   keep-set; needs sampled), then the MoE router [L, d, E] (0 when dense)
//   and the routing records [NS, L, E, B] and [NS, L, B, d] f32 (0 =
//   none: the gates' combine weights and the residual rows they read),
//   and the ints E
//   (0 = dense), top_k, norm_topk. The dense library takes
//   E = 0 only, the MoE library (TDT_MEGA_MOE) E > 0 only.
// info (out): blocks launched, dynamic shared memory bytes, blocks per SM
//   the occupancy calculator allows.
extern "C" int tdt_mega_decode(const unsigned long long* ptrs,
                               const int* ints, float eps, float sm_scale,
                               int* info, void* stream) {
#ifdef TDT_MEGA_MOE
  constexpr bool kMoE = true;
#else
  constexpr bool kMoE = false;
#endif
  Params p{};
  int dtype = -1, wq8 = 0, kv_quant = 0;
  long long ws_floats = 0;
  if (!parse_decode(ptrs, ints, eps, sm_scale, kMoE, p, dtype, ws_floats,
                    wq8, kv_quant))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::kDtypeF32)
    return launch_t<float, kMoE>(p, wq8, kv_quant, ws_floats, info, s);
  if (dtype == tdt::kDtypeBF16)
    return launch_t<__nv_bfloat16, kMoE>(p, wq8, kv_quant, ws_floats, info,
                                          s);
  return (int)cudaErrorInvalidValue;
}

// A decode launch over n > 1 co-located ranks, one cooperative launch of
// G blocks a rank. ptrs and ints: n rows of tdt_mega_decode's arrays, one a
// rank (its weights, cache shard, outputs, workspace, barrier counter,
// trace ring, MoE records; the shared table, kv_len, tokens, page table,
// stop_tok and ring snapshot), each in the model dtype with a full-width
// cache, greedy, without wq8; a rank's v_real is its real vocab columns.
// The dense library takes dense graphs, the MoE library (TDT_MEGA_MOE) MoE
// graphs, whose w1/w2 are the rank's E/n experts (rank r's: r * E/n ..).
// slot_tab and flag_tab: device tables of the ranks' exchange slots and
// flags (layout: Comm), flag_cap flags and g_cap candidate blocks a rank;
// epoch: this launch's (flags are never reset); blocks_per_rank: G (0 =
// the co-resident capacity over n); lag_rank (-1: none) lags its pushes
// by lag_ns. info (out): G, dynamic shared memory bytes, blocks per SM.
extern "C" int tdt_mega_decode_tp(int n, const unsigned long long* ptrs,
                                  const int* ints, float eps, float sm_scale,
                                  const void* slot_tab, const void* flag_tab,
                                  unsigned long long epoch, int flag_cap,
                                  int g_cap, int blocks_per_rank,
                                  int lag_rank, long long lag_ns, int* info,
                                  void* stream) {
#ifdef TDT_MEGA_MOE
  constexpr bool kMoE = true;
#else
  constexpr bool kMoE = false;
#endif
  constexpr int kPtrs = 40, kInts = 28;
  if (n < 2 || n > tdt::kMaxRanks || g_cap < 1 ||
      (long long)flag_cap < n + (long long)n * g_cap || slot_tab == nullptr ||
      flag_tab == nullptr || lag_ns < 0)
    return (int)cudaErrorInvalidValue;
  TpParams tp{};  // the kernel argument (~5 KB, copied at the launch)
  int dtype = -1;
  long long ws_floats = 0;
  for (int r = 0; r < n; ++r) {
    int dt = -1, wq8 = 0, kv_quant = 0;
    long long ws = 0;
    Params& pr = tp.p[r];
    if (!parse_decode(ptrs + (size_t)r * kPtrs, ints + (size_t)r * kInts,
                      eps, sm_scale, kMoE, pr, dt, ws, wq8, kv_quant) ||
        wq8 || kv_quant || pr.sampled || (kMoE && pr.E % n != 0) ||
        (r > 0 && (dt != dtype || ws != ws_floats)))
      return (int)cudaErrorInvalidValue;
    dtype = dt;
    ws_floats = ws;
  }
  const bool traced =
      tp.p[0].trace != nullptr || tp.p[0].ring_state != nullptr;
  set_comm(tp.c, n, slot_tab, flag_tab, epoch, g_cap, lag_rank, lag_ns);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::kDtypeF32)
    return traced ? launch_tp<float, true, kMoE>(tp, ws_floats,
                                                 blocks_per_rank, info, s)
                  : launch_tp<float, false, kMoE>(tp, ws_floats,
                                                  blocks_per_rank, info, s);
  if (dtype == tdt::kDtypeBF16)
    return traced ? launch_tp<__nv_bfloat16, true, kMoE>(
                        tp, ws_floats, blocks_per_rank, info, s)
                  : launch_tp<__nv_bfloat16, false, kMoE>(
                        tp, ws_floats, blocks_per_rank, info, s);
  return (int)cudaErrorInvalidValue;
}

#ifndef TDT_MEGA_MOE

// The prefill megakernel over one prompt of S rows.
// ptrs: x0 [S, d] (T), wqkv, wo, w1, w2, lm_head, ln1, ln2, normf, qn, kn,
//   true_len [1] (int32), table, inv_freq, logits [1, v_pad] (f32), knew,
//   vnew [L, hkv, S, hd] (T), workspace, barrier counter, then sc_qkv,
//   sc_o, sc_w1, sc_w2, sc_lm (0 without wq8).
// ints: T, S, d, hq, hkv, hd, f, v_pad, L, fuse_norms, dtype of the model
//   (0 f32, 1 bf16), workspace floats, wq8.
// info (out): blocks launched, dynamic shared memory bytes, blocks per SM.
extern "C" int tdt_mega_prefill(const unsigned long long* ptrs,
                                const int* ints, float eps, float sm_scale,
                                int* info, void* stream) {
  Params p{};
  int dtype = -1, wq8 = 0;
  long long ws_floats = 0;
  if (!parse_prefill(ptrs, ints, eps, sm_scale, p, dtype, ws_floats, wq8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::kDtypeF32)
    return wq8 ? launch_prefill<float, int8_t>(p, ws_floats, info, s)
               : launch_prefill<float, float>(p, ws_floats, info, s);
  if (dtype == tdt::kDtypeBF16)
    return wq8 ? launch_prefill<__nv_bfloat16, int8_t>(p, ws_floats, info, s)
               : launch_prefill<__nv_bfloat16, __nv_bfloat16>(
                     p, ws_floats, info, s);
  return (int)cudaErrorInvalidValue;
}

// The prefill megakernel over n > 1 co-located ranks, one cooperative
// launch of G blocks a rank. ptrs and ints: n rows of tdt_mega_prefill's
// arrays, one a rank (its weights, logits, knew/vnew, workspace and barrier
// counter; the shared x0, true_len, table and inv_freq), without wq8.
// slot_tab, flag_tab, epoch, flag_cap, g_cap, blocks_per_rank and info as
// tdt_mega_decode_tp's; each rank's slots hold two sets of n partials
// [S * d].
extern "C" int tdt_mega_prefill_tp(int n, const unsigned long long* ptrs,
                                   const int* ints, float eps,
                                   float sm_scale, const void* slot_tab,
                                   const void* flag_tab,
                                   unsigned long long epoch, int flag_cap,
                                   int g_cap, int blocks_per_rank, int* info,
                                   void* stream) {
  constexpr int kPtrs = 24, kInts = 13;
  if (n < 2 || n > tdt::kMaxRanks || g_cap < 1 ||
      (long long)flag_cap < n + (long long)n * g_cap || slot_tab == nullptr ||
      flag_tab == nullptr)
    return (int)cudaErrorInvalidValue;
  TpParams tp{};
  int dtype = -1;
  long long ws_floats = 0;
  for (int r = 0; r < n; ++r) {
    int dt = -1, wq8 = 0;
    long long ws = 0;
    if (!parse_prefill(ptrs + (size_t)r * kPtrs, ints + (size_t)r * kInts,
                       eps, sm_scale, tp.p[r], dt, ws, wq8) ||
        wq8 || (r > 0 && (dt != dtype || ws != ws_floats)))
      return (int)cudaErrorInvalidValue;
    dtype = dt;
    ws_floats = ws;
  }
  set_comm(tp.c, n, slot_tab, flag_tab, epoch, g_cap, -1, 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::kDtypeF32)
    return launch_prefill_tp<float>(tp, ws_floats, blocks_per_rank, info, s);
  if (dtype == tdt::kDtypeBF16)
    return launch_prefill_tp<__nv_bfloat16>(tp, ws_floats, blocks_per_rank,
                                            info, s);
  return (int)cudaErrorInvalidValue;
}

#endif  // TDT_MEGA_MOE
