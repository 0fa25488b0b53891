"""Megakernel launch: geometry, config, operand packing, one CUDA launch.

Counterpart of ``triton_distributed_tpu/megakernel/code_generator.py``
(``MegaDims``, ``MegaConfig``, ``make_mega_kernel`` / ``build_mega_call``).
The JAX package traces a ``pl.when`` dispatch over the task types into
one Pallas kernel whose sequential grid walks the task table; here the
kernel is fixed CUDA source (``csrc/megakernel.cu``), compiled once, and
the same packed table is one of its operands. :func:`mega_decode` packs
the operands into the kernel's parameter struct and launches it
cooperatively on a CUDA tensor, or runs the plain version
(``kernels.mega_decode_plain``) on a CPU tensor; a failed build or
launch raises, it never falls back.

Built here: decode over a dense cache, a full-width paged pool
or an int8 paged pool (``kv_quant``: codes plus f32 scales ``[L, P,
Hkv]``), f32 or bf16 models with weights in the model dtype or int8
(``MegaConfig.wq8``: per-output-channel f32 scales), ``nsteps >= 1``,
``eos``; greedy, ``sampled`` (the argmax over ``logits + noise``, noise
``[NS, B, v_loc]`` f32 = T·gumbel per row) and ``filtered`` (the argmax
over each row's exact top-k/top-p keep-set, per-row ``sampcfg [B, 4]``);
``trace`` (the device task tracer: a ``[NS, T, 8]`` int32 ring of
per-task records) and ``ring`` (a leading RING_POLL task that stamps the
published work-ring doorbell, ``ring_state [4]``). :func:`mega_prefill`
runs the prefill graph (``dims.prefill``) over one prompt's S rows.
An MoE decode graph (``dims.moe``: MOE_GATE, MOE_FFN per expert, and
the combine through ALLREDUCE or, under ``overlap_ar``, A2A_SEND /
A2A_WAIT, local at tp=1) launches the MoE build of the same source
(``cuda_kernels.MEGA_DECODE_MOE``). MoE with ``wq8`` or in a prefill
graph is refused as the JAX package refuses it.

A decode graph over ``n_ranks = n > 1`` co-located ranks (the entry
BARRIER, each projection's partial summed across ranks by ALLREDUCE or,
under ``overlap_ar``, AR_SEND / AR_WAIT, and the LM head's cross-rank
argmax; an MoE graph's experts expert-parallel, E/n a rank, their
combine summed across ranks by ALLREDUCE or the A2A_SEND / A2A_WAIT
pair) takes per-rank operands (weights, pool shards) and a
:class:`~triton_distributed_tpu_torch.runtime.mesh.DistContext` for the
exchange's symmetric slots and flags, and is one cooperative launch over
all n ranks (``cuda_kernels.MEGA_DECODE_TP``, an MoE graph
``MEGA_DECODE_MOE_TP``), or on the CPU the plain version walking the n
rank states in lockstep (``kernels.mega_decode_plain_tp``). The prefill
graph at n > 1 is one launch over all ranks as well
(:func:`mega_prefill_tp`, ``cuda_kernels.MEGA_PREFILL_TP``). Refused at
tp > 1, naming ROADMAP queue 1 position 4: ``wq8``, the int8 pool and
sampling.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from triton_distributed_tpu_torch.megakernel import kernels as _kernels
from triton_distributed_tpu_torch.megakernel.task import (
    TRACE_INTS,
    Task,
    TaskType,
)
from triton_distributed_tpu_torch.ops import cuda_kernels as ck

# Task types the CUDA kernels have bodies for: the decode graph
# (``mega_kernel``) and the prefill graph (``mega_prefill_kernel``).
KERNEL_TASKS = frozenset({
    TaskType.EMBED, TaskType.NORM, TaskType.QKV_PROJ, TaskType.ATTN,
    TaskType.O_PROJ, TaskType.FC1, TaskType.FC2, TaskType.ALLREDUCE,
    TaskType.LM_HEAD, TaskType.RING_POLL,
})
# The cross-rank bodies of a graph at tp > 1 (the kTp instantiations of
# ``mega_kernel`` and, BARRIER, of ``mega_prefill_kernel``).
TP_TASKS = frozenset({TaskType.BARRIER, TaskType.AR_SEND, TaskType.AR_WAIT})
# Co-located ranks one launch covers (tdt::kMaxRanks).
MAX_RANKS = 8
# The MoE graph's own bodies (the MoE build of ``mega_kernel``).
MOE_TASKS = frozenset({
    TaskType.MOE_GATE, TaskType.MOE_FFN, TaskType.A2A_SEND,
    TaskType.A2A_WAIT,
})
PREFILL_TASKS = frozenset({
    TaskType.LOAD_X, TaskType.NORM, TaskType.QKV_PROJ,
    TaskType.ATTN_PREFILL, TaskType.O_PROJ, TaskType.FC1, TaskType.FC2,
    TaskType.ALLREDUCE, TaskType.LM_HEAD,
})
# Kernel geometry shared with csrc/megakernel.cu (kMaxSplit, kAttnChunk,
# blocks per SM at most): the workspace is sized from it.
MAX_SPLIT = 16
ATTN_CHUNK = 128
MAX_BLOCKS_PER_SM = 2
# Experts the MoE gate ranks in one warp (kMaxExperts: 8 per lane; its
# router loads take 8 experts' columns at a time, so E % 8 == 0).
MAX_EXPERTS = 256
# The prefill kernel's shared memory (kWarps, kGroupB, kTileN,
# kPrefillRows, kPrefillKeys) and the most a block may take on Hopper.
_WARPS, _GROUP_B, _TILE_N = 8, 4, 64
_PREFILL_ROWS, _PREFILL_KEYS = 8, 32
MAX_SMEM_BYTES = 232448


@dataclasses.dataclass(frozen=True)
class MegaDims:
    """Static geometry of the decode step (the JAX fields, so a JAX
    ``MegaDims`` reads the same). ``kv_quant`` reads an int8 pool through
    its per-(layer, page, kv head) scales; ``sampled`` perturbs the
    multi-step argmax with host-drawn noise and ``filtered`` (with
    ``sampled``) restricts it to each row's top-k/top-p keep-set.
    ``trace`` adds the device task tracer's ring, ``ring`` a leading
    RING_POLL task, and ``prefill`` makes ``batch`` the prompt's S rows
    (the prefill graph). ``num_experts > 0`` makes the MLP the routed
    experts' (``f_loc`` is then one expert's full width). ``n_ranks >
    1``: the ``*_loc`` widths are one rank's shard (``v_loc`` =
    ``pad_vocab(V, n) // n``); ``straggler_rank`` lags that rank by
    ``straggler_nanos`` before its first exchange and each LM-head push
    (a test fixture; None = off)."""

    batch: int
    d: int
    hq_loc: int
    hkv_loc: int
    head_dim: int
    f_loc: int
    v_loc: int
    num_layers: int
    s_max: int
    n_ranks: int
    rms_eps: float = 1e-6
    rope_theta: float = 1e6
    page: int = 0           # paged pool page size (0 = dense cache)
    kv_quant: bool = False
    num_pages: int = 0
    prefill: bool = False
    nsteps: int = 1
    v_real: int = 0         # real (unpadded) vocab; 0 = every column
    sampled: bool = False
    filtered: bool = False
    eos: bool = False
    ring: bool = False
    straggler_rank: int | None = None
    straggler_nanos: int = 500_000
    trace: bool = False
    num_experts: int = 0
    moe_top_k: int = 0
    norm_topk: bool = True

    @property
    def moe(self) -> bool:
        return self.num_experts > 0

    @property
    def experts_loc(self) -> int:
        return self.num_experts // self.n_ranks if self.moe else 0

    @property
    def qkv_loc(self) -> int:
        return (self.hq_loc + 2 * self.hkv_loc) * self.head_dim

    @property
    def o_k(self) -> int:
        return self.hq_loc * self.head_dim


@dataclasses.dataclass(frozen=True)
class MegaConfig:
    """The JAX package's tile configuration. Only ``fuse_norms`` changes
    what the CUDA kernel computes (it drops the NORM tasks from the graph
    and the consumers normalise inline); ``overlap_ar`` changes the graph
    at tp > 1 and, at tp=1, only an MoE graph's combine (A2A_SEND /
    A2A_WAIT in place of ALLREDUCE: the combine folded in two halves).
    The TPU staging knobs — ``tile_n``, ``tile_k``,
    ``s_blk``, ``nbuf``, ``cross_prefetch`` — are accepted so configs
    and spec strings carry over, and do not change the CUDA kernel,
    which sizes its own tiles. ``wq8`` decodes from int8 weights
    (``MegaQwen3.quantized_params``): the five projection weights as
    int8 codes with one f32 scale per output column."""

    tile_n: int = 1024
    tile_k: int = 1024
    s_blk: int = 256
    nbuf: int = 2
    wq8: bool = False
    cross_prefetch: bool = False
    fuse_norms: bool = False
    overlap_ar: bool = False

    @classmethod
    def from_spec(cls, spec: str) -> "MegaConfig":
        """Parse ``tile_n:tile_k:nbuf[:fuse_norms[:cross_prefetch
        [:overlap_ar]]]``, the JAX package's sweep/bench string."""
        fields = [int(v) for v in spec.split(":")]
        if len(fields) not in (3, 4, 5, 6):
            raise ValueError(
                "want tile_n:tile_k:nbuf[:fuse_norms[:cross_prefetch"
                f"[:overlap_ar]]], got {spec!r}"
            )
        if min(fields[:3]) <= 0:
            raise ValueError(
                f"tile_n/tile_k/nbuf must be positive, got {spec!r}"
            )
        if any(f not in (0, 1) for f in fields[3:]):
            raise ValueError(
                f"fuse_norms/cross_prefetch/overlap_ar flags must be 0 "
                f"or 1: {spec!r}"
            )
        return cls(
            tile_n=fields[0], tile_k=fields[1], nbuf=fields[2],
            fuse_norms=bool(fields[3]) if len(fields) > 3 else False,
            cross_prefetch=bool(fields[4]) if len(fields) > 4 else False,
            overlap_ar=bool(fields[5]) if len(fields) > 5 else False,
        )

    def spec(self) -> str:
        """Inverse of :meth:`from_spec`."""
        return (f"{self.tile_n}:{self.tile_k}:{self.nbuf}:"
                f"{int(self.fuse_norms)}:{int(self.cross_prefetch)}:"
                f"{int(self.overlap_ar)}")


@dataclasses.dataclass(frozen=True)
class MegaWeights:
    """The tensors the kernel reads, as the model holds them (views of
    ``Qwen3.params`` or of ``Q8Params``, never copies): stacked per
    layer, contiguous. Under ``wq8`` the five projection weights are
    int8 and the five scale planes (f32, one scale per output column)
    are set; otherwise every weight is in the model dtype (``embed``'s)
    and the scales are None."""

    embed: torch.Tensor    # [V, d]
    wqkv: torch.Tensor     # [L, d, qkv]
    wo: torch.Tensor       # [L, hq*hd, d]
    w1: torch.Tensor       # [L, d, 2f]  (gate | up)
    w2: torch.Tensor       # [L, f, d]
    lm_head: torch.Tensor  # [d, v_pad]
    ln1: torch.Tensor      # [L, d]
    ln2: torch.Tensor      # [L, d]
    normf: torch.Tensor    # [d]
    qn: torch.Tensor       # [L, hd]
    kn: torch.Tensor       # [L, hd]
    # MoE: the router [L, d, E]; w1 is then [L, E, d, 2f] and w2 [L, E,
    # f, d] (the JAX MoEMegaParams at tp=1: the model's own tensors).
    wrouter: torch.Tensor | None = None
    sc_qkv: torch.Tensor | None = None  # [L, 1, qkv]
    sc_o: torch.Tensor | None = None    # [L, 1, d]
    sc_w1: torch.Tensor | None = None   # [L, 1, 2f]
    sc_w2: torch.Tensor | None = None   # [L, 1, d]
    sc_lm: torch.Tensor | None = None   # [1, v_pad]

    @classmethod
    def from_params(cls, params) -> "MegaWeights":
        """From the model's parameter dict, or from a ``Q8Params``."""
        if not isinstance(params, dict):
            return cls(**{f.name: getattr(params, "norm" if f.name == "normf"
                                          else f.name, None)
                          for f in dataclasses.fields(cls)})
        lp = params["layers"]
        return cls(
            embed=params["embed"], wqkv=lp["attn"]["wqkv"],
            wo=lp["attn"]["wo"], w1=lp["mlp"]["w1"], w2=lp["mlp"]["w2"],
            lm_head=params["lm_head"], ln1=lp["ln1"], ln2=lp["ln2"],
            normf=params["norm"], qn=lp["attn"]["q_norm"],
            kn=lp["attn"]["k_norm"], wrouter=lp["mlp"].get("w_router"),
        )

    @property
    def q8(self) -> bool:
        return self.sc_qkv is not None


def check_dims(dims: MegaDims, cfg: MegaConfig) -> None:
    """Refuse what this slice does not build, naming the ROADMAP item,
    and what the JAX package refuses (a paged or sampled prefill)."""
    refused = [
        (dims.moe and cfg.wq8, "wq8 does not compose with MoE decode yet "
                               "(per-expert per-channel scale planes)"),
        (dims.moe and dims.prefill,
         "MoE prefill runs through the model path (the engines prefill "
         "with mode='xla' under mode='mega')"),
        (dims.n_ranks > 1 and cfg.wq8,
         "MegaConfig(wq8=True) at tp > 1 is not ported yet (ROADMAP queue "
         "1 position 4)"),
        (dims.n_ranks > 1 and (dims.kv_quant or dims.sampled),
         "the int8 pool and sampling at tp > 1 are not ported yet "
         "(ROADMAP queue 1 position 4)"),
        (dims.page and dims.prefill, "paged prefill: prefill then scatter"),
        (dims.sampled and dims.prefill, "sampled multi-step: decode only"),
    ]
    for bad, msg in refused:
        if bad:
            raise NotImplementedError(msg)
    if not 1 <= dims.n_ranks <= MAX_RANKS:
        raise ValueError(f"n_ranks must be in [1, {MAX_RANKS}], got "
                         f"{dims.n_ranks}")
    if dims.moe:
        if dims.num_experts % dims.n_ranks:
            raise ValueError(
                f"num_experts {dims.num_experts} not divisible by "
                f"tp={dims.n_ranks} (EP shards the expert axis)")
        if not dims.moe_top_k:
            raise ValueError("MoE dims need moe_top_k > 0")
    if dims.prefill:
        if dims.nsteps != 1 or dims.trace or dims.ring or dims.eos:
            raise ValueError("the prefill graph runs one step, without a "
                             "trace ring, a work ring or eos")
        if prefill_smem_bytes(dims) > MAX_SMEM_BYTES:
            raise ValueError(
                f"a {dims.batch}-row prefill needs "
                f"{prefill_smem_bytes(dims)} bytes of shared memory per "
                f"block, more than {MAX_SMEM_BYTES}")
    if dims.kv_quant and not dims.page:
        raise ValueError("kv_quant requires the paged cache (scales live "
                         "on pool pages)")
    if (dims.sampled or dims.filtered) and not _kernels.takes_argmax(dims):
        raise ValueError("sampled / filtered decode rides the multi-step "
                         "build: the LM head takes the argmax")
    if dims.filtered and not dims.sampled:
        raise ValueError("filtered decode requires sampled (its winner is "
                         "the argmax over logits + noise)")
    if dims.eos and (not dims.page or dims.nsteps <= 1):
        raise ValueError("device stop-token testing rides the paged "
                         "multi-step decode (page > 0, nsteps > 1)")
    if dims.hq_loc % dims.hkv_loc or dims.hq_loc // dims.hkv_loc > 8:
        raise ValueError("q heads must be a multiple (<= 8x) of kv heads")
    if dims.head_dim not in (32, 64, 128, 256):
        raise ValueError("head_dim must be 32, 64, 128 or 256")
    for name, n in (("qkv", dims.qkv_loc), ("d", dims.d),
                    ("2*f", 2 * dims.f_loc), ("vocab", dims.v_loc)):
        if n % 8:
            raise ValueError(f"GEMM width {name}={n} must be a multiple "
                             "of 8 (16-byte weight rows)")


def workspace_floats(dims: MegaDims, n_sms: int) -> int:
    """f32 workspace the kernel needs (``csrc/megakernel.cu``'s layout):
    the state between tasks, split-K partials, attention partials, the
    per-block argmax candidates; an MoE graph adds its scratch (combine
    weights ``[E, B]``, the combine accumulator and the two exchange
    buffers ``[B, d]`` each, FC2's split-K partials)."""
    B, d, hd = dims.batch, dims.d, dims.head_dim
    hq, hkv = dims.hq_loc, dims.hkv_loc
    g = hq // hkv
    nch = -(-dims.s_max // ATTN_CHUNK)
    nblk = n_sms * MAX_BLOCKS_PER_SM
    moe = (dims.num_experts * B + 3 * B * d + MAX_SPLIT * B * d
           if dims.moe else 0)
    return (2 * B * d + B * dims.qkv_loc + B * hq * hd + B * dims.f_loc
            + MAX_SPLIT * B * max(dims.qkv_loc, d, 2 * dims.f_loc)
            + B * hkv * nch * g * (hd + 2)
            + B * hq * hd + 2 * B * hkv * hd + 2 * nblk * B + moe)


def prefill_workspace_floats(dims: MegaDims) -> int:
    """f32 workspace of the prefill kernel: the state of the S rows (x, h,
    qkv, attention out, mlp), fc1's gate|up sums, the prepared q and k
    heads and the rows' rstd."""
    S, d, hd = dims.batch, dims.d, dims.head_dim
    return (S * (2 * d + dims.qkv_loc + dims.o_k + 3 * dims.f_loc)
            + (dims.hq_loc + dims.hkv_loc) * S * hd + S)


def prefill_smem_bytes(dims: MegaDims) -> int:
    """Dynamic shared memory of one prefill block (``prefill_region`` in
    ``csrc/megakernel.cu``): the GEMM reduction buffer, 4 staged rstd
    values, and the larger of the GEMM input staging, the head
    preparation scratch and the attention unit (q rows, a staged key
    chunk, the rows' scores)."""
    hd = dims.head_dim
    kmax = max(dims.d, dims.o_k, dims.f_loc)
    region = max(_GROUP_B * kmax, _WARPS * hd,
                 _PREFILL_ROWS * hd + _PREFILL_KEYS * (hd + 1)
                 + _PREFILL_ROWS * dims.batch)
    return 4 * (_WARPS * _GROUP_B * _TILE_N + _GROUP_B + region)


def mega_decode(dims: MegaDims, cfg: MegaConfig, table: torch.Tensor,
                w: MegaWeights, kc, vc, page_table, kv_len, tokens,
                stop_tok=None, inv_freq=None, bar=None,
                info: dict | None = None, k_scale=None, v_scale=None,
                noise=None, sampcfg=None, ring_state=None, moe_route=None,
                moe_x=None):
    """Run the packed task ``table [T, 8]`` for ``dims.nsteps`` steps.

    On CUDA tensors: one cooperative launch of ``csrc/megakernel.cu``
    (counted in ``cuda_kernels.MEGA_DECODE``); on CPU tensors: the plain
    version. Returns ``(logits [B, v_loc] f32 of the last step, knew,
    vnew [NS, L, B, hkv, hd] in the model dtype, toks [NS, B] int32,
    stop_step [B] int32)``. ``inv_freq`` is the rope table
    (``kernels.rope_inv_freq``) and ``bar`` the grid barrier's int32
    counter; both are made afresh when not given (:class:`MegaCall` keeps
    its own). ``info`` (optional) receives the launch geometry (blocks,
    shared memory bytes, occupancy per SM). Under ``dims.kv_quant`` the
    pool holds int8 codes and ``k_scale``/``v_scale [L, P, Hkv]`` f32 are
    its scales; under ``cfg.wq8`` ``w`` holds int8 weights and their
    scales. ``dims.sampled`` takes ``noise [NS, B, v_loc]`` f32 (added to
    the argmax's scores, zero rows stay greedy) and ``dims.filtered``
    ``sampcfg [B, 4]`` f32 rows ``[1/T, top-k window, top-p, enable]``
    (``sampling.sampcfg_row``). ``dims.ring`` takes ``ring_state [4]``
    int32 (``WorkRing.publish``), whose doorbell the RING_POLL task
    stamps; an MoE graph takes ``moe_route [NS, L, E, B]`` and ``moe_x
    [NS, L, B, d]`` f32 (optional, together), into which every MOE_GATE
    writes its combine weights and the residual rows it read (the routing
    and the state it was computed from, for a check to hold);
    ``dims.trace`` appends the trace ring ``[NS, T, 8]`` int32 to
    the returns (a traced CUDA launch is counted in
    ``cuda_kernels.MEGA_DECODE_TRACED``; an MoE launch, traced or not, in
    ``cuda_kernels.MEGA_DECODE_MOE``)."""
    check_dims(dims, cfg)
    if dims.prefill:
        raise ValueError("a prefill graph launches through mega_prefill")
    if dims.n_ranks > 1:
        raise ValueError("a tp > 1 graph launches through mega_decode_tp")
    if dims.ring != (ring_state is not None):
        raise ValueError("ring_state is given exactly when dims.ring is "
                         "set")
    if ring_state is not None and (tuple(ring_state.shape) != (4,)
                                   or ring_state.dtype != torch.int32):
        raise ValueError(f"ring_state must be [4] int32, got "
                         f"{tuple(ring_state.shape)} {ring_state.dtype}")
    if cfg.wq8 != w.q8:
        raise ValueError("MegaConfig(wq8=True) takes int8 weights with "
                         "their scales (Q8Params), and only wq8 does")
    if dims.kv_quant != (k_scale is not None and v_scale is not None) or (
            dims.kv_quant != (kc.dtype == torch.int8)):
        raise ValueError("an int8 pool, its scales and dims.kv_quant go "
                         "together")
    for name, t, mode, shape in (
            ("noise", noise, "sampled",
             (dims.nsteps, dims.batch, dims.v_loc)),
            ("sampcfg", sampcfg, "filtered", (dims.batch, 4))):
        if getattr(dims, mode) != (t is not None):
            raise ValueError(f"{name} is given exactly when dims.{mode} "
                             "is set")
        if t is not None and (tuple(t.shape) != shape
                              or t.dtype != torch.float32):
            raise ValueError(f"{name} must be {shape} f32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    _check_moe_records(dims, moe_route, moe_x)
    dev = kv_len.device
    if inv_freq is None:
        inv_freq = _kernels.rope_inv_freq(dims.head_dim, dims.rope_theta,
                                          dev)
    if dev.type != "cuda":
        return _kernels.mega_decode_plain(
            dims, cfg.fuse_norms, table.cpu().numpy(), w, kc, vc,
            page_table, kv_len, tokens, stop_tok, inv_freq, k_scale, v_scale,
            noise, sampcfg, ring_state, moe_route=moe_route,
            moe_x=moe_x)
    if bar is None:
        bar = torch.zeros(4, dtype=torch.int32, device=dev)
    return _launch(dims, cfg, table, w, kc, vc, page_table, kv_len, tokens,
                   stop_tok, inv_freq, bar, info, k_scale, v_scale, noise,
                   sampcfg, ring_state, moe_route, moe_x)


def _check_weights(w: MegaWeights, cfg: MegaConfig, dims: MegaDims, dev):
    """Device, dtype, contiguity and scale-count checks of the weights;
    returns the model dtype."""
    L = dims.num_layers
    mdt = w.embed.dtype
    if mdt not in ck.DTYPE_CODES:
        raise ValueError(f"megakernel model dtype must be f32/bf16, got {mdt}")
    wdt = torch.int8 if cfg.wq8 else mdt
    if dims.moe != (w.wrouter is not None):
        raise ValueError("the router weight is given exactly when dims.moe "
                         "is set")
    if dims.moe:
        # The router ranks every expert; w1/w2 hold this rank's experts
        # (all of them at tp=1, E/n expert-parallel at tp=n).
        E, d, f = dims.num_experts, dims.d, dims.f_loc
        el = dims.experts_loc
        for name, t, shape in (("wrouter", w.wrouter, (L, d, E)),
                               ("w1", w.w1, (L, el, d, 2 * f)),
                               ("w2", w.w2, (L, el, f, d))):
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} {tuple(t.shape)} disagrees with "
                                 f"dims {shape}")
        if E > MAX_EXPERTS or E % 8 or dims.moe_top_k > E:
            raise ValueError(f"the MoE gate ranks a multiple of 8 experts, "
                             f"at most {MAX_EXPERTS}, and top_k <= experts; "
                             f"got E={E}, top_k={dims.moe_top_k}")
    for f in dataclasses.fields(w):  # (asdict would deep-copy tensors)
        t = getattr(w, f.name)
        if f.name == "wrouter":
            if t is not None:
                ck.check_cuda_operand(f.name, t, dev, mdt)
        elif f.name.startswith("sc_"):
            if cfg.wq8:
                ck.check_cuda_operand(f.name, t, dev, torch.float32)
        elif f.name in ("wqkv", "wo", "w1", "w2", "lm_head"):
            ck.check_cuda_operand(f.name, t, dev, wdt)
        else:
            ck.check_cuda_operand(f.name, t, dev, mdt)
    if cfg.wq8:
        for name, n in (("sc_qkv", L * dims.qkv_loc), ("sc_o", L * dims.d),
                        ("sc_w1", 2 * L * dims.f_loc), ("sc_w2", L * dims.d),
                        ("sc_lm", dims.v_loc)):
            if getattr(w, name).numel() != n:
                raise ValueError(f"{name} has {getattr(w, name).numel()} "
                                 f"scales, expected {n}")
    return mdt


def _check_shared(dims, kc, page_table, table, kv_len, tokens, inv_freq,
                  bar, stop_tok, ring_state, dev) -> None:
    """The checks of the operands every decode launch takes (``kc`` one
    rank's cache shard: its geometry against ``dims``)."""
    B, hkv = dims.batch, dims.hkv_loc
    if dims.page:
        ck.check_cuda_operand("page_table", page_table, dev, torch.int32, 2)
        if (kc.shape[3] != dims.page or page_table.shape[0] != B
                or page_table.shape[1] * dims.page != dims.s_max):
            raise ValueError("paged operands disagree with dims")
    elif tuple(kc.shape[1:4]) != (B, hkv, dims.s_max):
        raise ValueError(f"dense cache {tuple(kc.shape)} disagrees with "
                         f"dims (B={B}, hkv={hkv}, s_max={dims.s_max})")
    ck.check_cuda_operand("table", table, dev, torch.int32, 2)
    ck.check_cuda_operand("kv_len", kv_len, dev, torch.int32, 1)
    ck.check_cuda_operand("tokens", tokens, dev, torch.int32, 1)
    ck.check_cuda_operand("inv_freq", inv_freq, dev, torch.float32, 1)
    ck.check_cuda_operand("bar", bar, dev, torch.int32, 1)
    if dims.eos:
        ck.check_cuda_operand("stop_tok", stop_tok, dev, torch.int32, 1)
    if dims.ring:
        ck.check_cuda_operand("ring_state", ring_state, dev, torch.int32, 1)


def _launch(dims, cfg, table, w, kc, vc, page_table, kv_len, tokens,
            stop_tok, inv_freq, bar, info, k_scale, v_scale, noise, sampcfg,
            ring_state, moe_route, moe_x):
    dev = kv_len.device
    B, NS, L = dims.batch, dims.nsteps, dims.num_layers
    hkv, hd = dims.hkv_loc, dims.head_dim
    # Three storage types: the model dtype (embed, norms, the new K/V
    # rows, a full-width cache), the weights' (the model dtype, or int8
    # under wq8) and the cache's (the model dtype, or int8 codes).
    mdt = _check_weights(w, cfg, dims, dev)
    cdt = torch.int8 if dims.kv_quant else mdt
    for name, t in (("kc", kc), ("vc", vc)):
        ck.check_cuda_operand(name, t, dev, cdt, 5)
    if dims.kv_quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            ck.check_cuda_operand(name, t, dev, torch.float32, 3)
            if tuple(t.shape) != (L, kc.shape[1], hkv):
                raise ValueError(f"{name} {tuple(t.shape)} disagrees with "
                                 f"the pool {tuple(kc.shape)}")
    _check_shared(dims, kc, page_table, table, kv_len, tokens, inv_freq,
                  bar, stop_tok, ring_state, dev)
    if dims.sampled:
        ck.check_cuda_operand("noise", noise, dev, torch.float32, 3)
    if dims.filtered:
        ck.check_cuda_operand("sampcfg", sampcfg, dev, torch.float32, 2)
    if moe_route is not None:
        ck.check_cuda_operand("moe_route", moe_route, dev, torch.float32, 4)
        ck.check_cuda_operand("moe_x", moe_x, dev, torch.float32, 4)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ws_n = workspace_floats(dims, n_sms)
    ws = torch.empty(ws_n, dtype=torch.float32, device=dev)
    logits = torch.empty((B, dims.v_loc), dtype=torch.float32, device=dev)
    knew = torch.empty((NS, L, B, hkv, hd), dtype=mdt, device=dev)
    vnew = torch.empty_like(knew)
    toks = torch.zeros((NS, B), dtype=torch.int32, device=dev)
    stop_step = torch.full((B,), NS, dtype=torch.int32, device=dev)
    # Zeros: a record the kernel never reached keeps flag 0, a gap.
    trace = (torch.zeros((NS, table.shape[0], TRACE_INTS),
                         dtype=torch.int32, device=dev)
             if dims.trace else None)

    ptrs = (ctypes.c_uint64 * 40)(*[_ptr(t) for t in (
        w.embed, w.wqkv, w.wo, w.w1, w.w2, w.lm_head, w.ln1, w.ln2,
        w.normf, w.qn, w.kn, kc, vc, page_table if dims.page else None,
        kv_len, tokens, stop_tok if dims.eos else None, table, inv_freq,
        logits, knew, vnew, toks, stop_step, ws, bar,
        w.sc_qkv, w.sc_o, w.sc_w1, w.sc_w2, w.sc_lm, k_scale, v_scale,
        noise, sampcfg, trace, ring_state if dims.ring else None,
        w.wrouter, moe_route, moe_x)])
    ints = (ctypes.c_int * 28)(*_decode_ints(
        dims, cfg, table, kc, mdt, ws_n, w.embed.shape[0],
        _kernels.rank_v_real(dims, 0)))
    out = (ctypes.c_int * 4)()
    kernel = (ck.MEGA_DECODE_MOE if dims.moe else ck.MEGA_DECODE_TRACED
              if dims.trace else ck.MEGA_DECODE)
    kernel(ptrs, ints, ctypes.c_float(dims.rms_eps),
           ctypes.c_float(hd ** -0.5), out, ck.stream_ptr(kv_len))
    if info is not None:
        info.update(blocks=out[0], smem_bytes=out[1], blocks_per_sm=out[2])
    if dims.trace:
        return logits, knew, vnew, toks, stop_step, trace
    return logits, knew, vnew, toks, stop_step


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _decode_ints(dims, cfg, table, kc, mdt, ws_n, vocab, v_real):
    """The geometry ints of one rank's decode launch (``tdt_mega_decode``'s
    layout); ``v_real`` is the rank's real vocab columns."""
    return (table.shape[0], dims.nsteps, dims.batch, dims.d, dims.hq_loc,
            dims.hkv_loc, dims.head_dim, dims.f_loc, dims.v_loc, v_real,
            dims.num_layers, dims.s_max, dims.page,
            dims.s_max // dims.page if dims.page else 0,
            kc.shape[1] if dims.page else 0, int(cfg.fuse_norms),
            int(dims.eos), ck.DTYPE_CODES[mdt], ws_n, vocab,
            int(_kernels.takes_argmax(dims)), int(cfg.wq8),
            int(dims.kv_quant), int(dims.sampled), int(dims.filtered),
            dims.num_experts, dims.moe_top_k, int(dims.norm_topk))


def mega_decode_tp(dims: MegaDims, cfg: MegaConfig, table: torch.Tensor,
                   w: list, kc: list, vc: list, page_table, kv_len, tokens,
                   ctx, stop_tok=None, inv_freq=None, bar=None,
                   info: dict | None = None, ring_state=None,
                   blocks_per_rank: int = 0, moe_route=None, moe_x=None):
    """Run the packed task ``table`` of a decode graph over ``dims.n_ranks
    = n > 1`` co-located ranks for ``dims.nsteps`` steps.

    ``w``, ``kc`` and ``vc`` hold one entry per rank (its weight shards as
    :class:`MegaWeights`, an MoE graph's with its E/n experts
    expert-parallel (``MegaQwen3.moe_params``); its cache shard:
    ``cache.rank(r)``'s tensors); ``page_table``, ``kv_len``, ``tokens``,
    ``stop_tok`` and ``ring_state`` are shared. On CUDA tensors: one
    cooperative launch of ``csrc/megakernel.cu`` over all ranks (counted
    in ``cuda_kernels.MEGA_DECODE_TP``, an MoE graph in
    ``MEGA_DECODE_MOE_TP``), whose exchanges go through ``ctx``'s
    symmetric slots and flags; ``blocks_per_rank`` (0 = the card's
    co-resident capacity over n) sets the blocks of each rank, and a grid
    whose n ranks cannot all be resident is refused. On CPU tensors: the
    plain version (``kernels.mega_decode_plain_tp``). Returns ``(logits
    [B, n·v_loc] f32 (rank r's columns from r·v_loc), knew, vnew [n, NS,
    L, B, hkv, hd] in the model dtype, toks [NS, B] int32, stop_step [B]
    int32)`` and, under ``dims.trace``, the per-rank trace rings ``[n,
    NS, T, 8]``. Every rank emits the same tokens: ``info`` (optional)
    receives each rank's ``toks [n, NS, B]``, ``stop_step [n, B]`` and
    final residual ``x [n, B, d]`` f32, with the launch geometry on the
    card. An MoE graph takes ``moe_route [n, NS, L, E, B]`` and ``moe_x
    [n, NS, L, B, d]`` f32 (optional, together): each rank's gates'
    records, as :func:`mega_decode`'s."""
    check_dims(dims, cfg)
    n = dims.n_ranks
    if n < 2 or dims.prefill:
        raise ValueError("mega_decode_tp runs a decode graph at n_ranks > 1")
    if not len(w) == len(kc) == len(vc) == n:
        raise ValueError(f"want {n} per-rank weights and cache shards, got "
                         f"{len(w)}, {len(kc)}, {len(vc)}")
    if dims.ring != (ring_state is not None):
        raise ValueError("ring_state is given exactly when dims.ring is "
                         "set")
    _check_moe_records(dims, moe_route, moe_x, (n,))
    dev = kv_len.device
    if inv_freq is None:
        inv_freq = _kernels.rope_inv_freq(dims.head_dim, dims.rope_theta,
                                          dev)
    if dev.type != "cuda":
        return _kernels.mega_decode_plain_tp(
            dims, cfg.fuse_norms, table.cpu().numpy(), w, kc, vc,
            page_table, kv_len, tokens, stop_tok, inv_freq, ring_state,
            info=info, moe_route=moe_route, moe_x=moe_x)
    if bar is None:
        bar = torch.zeros(4 * n, dtype=torch.int32, device=dev)
    return _launch_tp(dims, cfg, table, w, kc, vc, page_table, kv_len,
                      tokens, stop_tok, inv_freq, bar, info, ring_state, ctx,
                      blocks_per_rank, moe_route, moe_x)


def _check_moe_records(dims, moe_route, moe_x, lead=()) -> None:
    """``moe_route [*lead, NS, L, E, B]`` and ``moe_x [*lead, NS, L, B,
    d]`` f32 go together, on an MoE graph only."""
    if (moe_route is None) != (moe_x is None):
        raise ValueError("moe_route and moe_x go together")
    if moe_route is None:
        return
    steps = tuple(lead) + (dims.nsteps, dims.num_layers)
    for name, t, shape in (
            ("moe_route", moe_route, steps + (dims.num_experts, dims.batch)),
            ("moe_x", moe_x, steps + (dims.batch, dims.d))):
        if not dims.moe or tuple(t.shape) != shape or (
                t.dtype != torch.float32):
            raise ValueError(f"{name} must be {shape} f32 on an MoE graph, "
                             f"got {tuple(t.shape)}")


def _tp_site(ctx, site: str, n: int, g_cap: int, floats: int):
    """A tp launch's exchange at ``site``: its flags (the entry barrier's
    n, then one a (source rank, block)), its slots (``floats`` a rank) and
    this launch's epoch."""
    from triton_distributed_tpu_torch.language import primitives as prim

    fs = prim.site_flags(ctx, site, n + n * g_cap)
    slots = ctx.workspace(site, (floats,), torch.float32)
    return fs, slots, prim.next_epoch(fs)


def _launch_tp(dims, cfg, table, w, kc, vc, page_table, kv_len, tokens,
               stop_tok, inv_freq, bar, info, ring_state, ctx,
               blocks_per_rank, moe_route, moe_x):
    dev = kv_len.device
    n, B, NS, L = dims.n_ranks, dims.batch, dims.nsteps, dims.num_layers
    hkv, hd, T = dims.hkv_loc, dims.head_dim, table.shape[0]
    if ctx is None or ctx.tp != n or ctx.device != dev:
        raise ValueError(f"a tp={n} launch needs the ranks' DistContext on "
                         f"{dev}, got {ctx}")
    mdt = _check_weights(w[0], cfg, dims, dev)
    for wr in w[1:]:
        if _check_weights(wr, cfg, dims, dev) != mdt:
            raise ValueError("the ranks' weights differ in dtype")
    for r in range(n):
        for name, t in (("kc", kc[r]), ("vc", vc[r])):
            ck.check_cuda_operand(f"{name}[{r}]", t, dev, mdt, 5)
            if tuple(t.shape) != tuple(kc[0].shape):
                raise ValueError("the ranks' cache shards differ in shape")
    _check_shared(dims, kc[0], page_table, table, kv_len, tokens, inv_freq,
                  bar, stop_tok, ring_state, dev)
    if moe_route is not None:
        ck.check_cuda_operand("moe_route", moe_route, dev, torch.float32, 5)
        ck.check_cuda_operand("moe_x", moe_x, dev, torch.float32, 5)
    if bar.numel() < 4 * n:
        raise ValueError(f"bar needs 4 counters a rank, got {bar.numel()}")
    # Exchange ordinals ride the flag values' low 20 bits.
    if NS * T >= 1 << 20:
        raise ValueError(f"{NS} steps of {T} tasks exceed one launch's "
                         "exchange ordinals")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g_cap = n_sms * MAX_BLOCKS_PER_SM
    ws_n = -(-workspace_floats(dims, n_sms) // 4) * 4  # 16-byte rank rows
    ws = torch.empty((n, ws_n), dtype=torch.float32, device=dev)
    logits = torch.empty((n, B, dims.v_loc), dtype=torch.float32, device=dev)
    knew = torch.empty((n, NS, L, B, hkv, hd), dtype=mdt, device=dev)
    vnew = torch.empty_like(knew)
    toks = torch.zeros((n, NS, B), dtype=torch.int32, device=dev)
    stop_step = torch.full((n, B), NS, dtype=torch.int32, device=dev)
    trace = (torch.zeros((n, NS, T, TRACE_INTS), dtype=torch.int32,
                         device=dev) if dims.trace else None)
    # The exchange: per rank two alternating slot sets of the residual
    # partials [n, B, d] and of the LM head's candidates [n, g_cap, B, 2],
    # then (MoE) two of the combine's phase-0 partials [n, B, d]; flags
    # [n] (the entry barrier) + [n, g_cap] (one a source block).
    per_set = B * dims.d + 2 * B * g_cap + (B * dims.d if dims.moe else 0)
    fs, slots, epoch = _tp_site(ctx, "mega_decode", n, g_cap,
                                2 * n * per_set)
    vocab = w[0].embed.shape[0]
    ptrs, ints = [], []
    for r in range(n):
        ptrs += [_ptr(t) for t in (
            w[r].embed, w[r].wqkv, w[r].wo, w[r].w1, w[r].w2, w[r].lm_head,
            w[r].ln1, w[r].ln2, w[r].normf, w[r].qn, w[r].kn, kc[r], vc[r],
            page_table if dims.page else None, kv_len, tokens,
            stop_tok if dims.eos else None, table, inv_freq, logits[r],
            knew[r], vnew[r], toks[r], stop_step[r], ws[r], bar[4 * r:],
            None, None, None, None, None, None, None, None, None,
            None if trace is None else trace[r],
            ring_state if dims.ring else None, w[r].wrouter,
            None if moe_route is None else moe_route[r],
            None if moe_x is None else moe_x[r])]
        ints += _decode_ints(dims, cfg, table, kc[0], mdt, ws_n, vocab,
                             _kernels.rank_v_real(dims, r))
    lag = -1 if dims.straggler_rank is None else int(dims.straggler_rank)
    out = (ctypes.c_int * 4)()
    kernel = ck.MEGA_DECODE_MOE_TP if dims.moe else ck.MEGA_DECODE_TP
    kernel(n, (ctypes.c_uint64 * len(ptrs))(*ptrs),
           (ctypes.c_int * len(ints))(*ints), ctypes.c_float(dims.rms_eps),
           ctypes.c_float(hd ** -0.5), slots.table.data_ptr(),
           fs.flags.table.data_ptr(), epoch, fs.capacity, g_cap,
           int(blocks_per_rank), lag, int(dims.straggler_nanos), out,
           ck.stream_ptr(kv_len))
    if info is not None:
        info.update(blocks=out[0], smem_bytes=out[1], blocks_per_sm=out[2],
                    toks=toks, stop_step=stop_step,
                    x=ws[:, :B * dims.d].view(n, B, dims.d))
    ret = (logits.permute(1, 0, 2).reshape(B, n * dims.v_loc), knew, vnew,
           toks[0], stop_step[0])
    return ret + (trace,) if dims.trace else ret


def mega_prefill(dims: MegaDims, cfg: MegaConfig, table: torch.Tensor,
                 w: MegaWeights, x0: torch.Tensor, true_len: torch.Tensor,
                 inv_freq=None, bar=None, info: dict | None = None):
    """Run the prefill ``table`` (``build_prefill_graph``) once over the
    prompt's S rows: ``x0 [S, d]`` is the embedded prompt in the model
    dtype, ``true_len [1]`` int32 its real length (rows past it are pad).

    On CUDA tensors: one cooperative launch of ``csrc/megakernel.cu``'s
    prefill kernel (counted in ``cuda_kernels.MEGA_PREFILL``); on CPU
    tensors: the plain version. Returns ``(logits [1, v_loc] f32 of row
    true_len - 1, knew, vnew [L, hkv, S, hd] in the model dtype)``."""
    check_dims(dims, cfg)
    if not dims.prefill or dims.n_ranks > 1:
        raise ValueError("mega_prefill runs a prefill graph (dims.prefill) "
                         "at n_ranks = 1 (mega_prefill_tp above it)")
    if cfg.wq8 != w.q8:
        raise ValueError("MegaConfig(wq8=True) takes int8 weights with "
                         "their scales (Q8Params), and only wq8 does")
    _check_prefill_inputs(dims, w, x0, true_len)
    dev = x0.device
    if inv_freq is None:
        inv_freq = _kernels.rope_inv_freq(dims.head_dim, dims.rope_theta, dev)
    if dev.type != "cuda":
        return _kernels.mega_prefill_plain(
            dims, cfg.fuse_norms, table.cpu().numpy(), w, x0, true_len,
            inv_freq)
    if bar is None:
        bar = torch.zeros(4, dtype=torch.int32, device=dev)
    mdt = _check_weights(w, cfg, dims, dev)
    _check_prefill_operands(x0, true_len, table, inv_freq, bar, mdt)
    ws_n = prefill_workspace_floats(dims)
    ws = torch.empty(ws_n, dtype=torch.float32, device=dev)
    logits = torch.empty((1, dims.v_loc), dtype=torch.float32, device=dev)
    knew = torch.empty((dims.num_layers, dims.hkv_loc, dims.batch,
                        dims.head_dim), dtype=mdt, device=dev)
    vnew = torch.empty_like(knew)
    ptrs = (ctypes.c_uint64 * 24)(*_prefill_ptrs(
        w, x0, true_len, table, inv_freq, logits, knew, vnew, ws, bar))
    ints = (ctypes.c_int * 13)(*_prefill_ints(dims, cfg, table, mdt, ws_n))
    out = (ctypes.c_int * 4)()
    ck.MEGA_PREFILL(ptrs, ints, ctypes.c_float(dims.rms_eps),
                    ctypes.c_float(dims.head_dim ** -0.5), out,
                    ck.stream_ptr(x0))
    if info is not None:
        info.update(blocks=out[0], smem_bytes=out[1], blocks_per_sm=out[2])
    return logits, knew, vnew


def mega_prefill_tp(dims: MegaDims, cfg: MegaConfig, table: torch.Tensor,
                    w: list, x0: torch.Tensor, true_len: torch.Tensor, ctx,
                    inv_freq=None, bar=None, info: dict | None = None,
                    blocks_per_rank: int = 0):
    """The prefill ``table`` over ``dims.n_ranks = n > 1`` co-located ranks
    (``w`` one :class:`MegaWeights` a rank; ``x0`` and ``true_len``
    shared). On CUDA tensors: one cooperative launch of the prefill
    kernel over all ranks (counted in ``cuda_kernels.MEGA_PREFILL_TP``):
    the (G, n) grid of :func:`mega_decode_tp`, the entry BARRIER, and each
    ALLREDUCE's ``[S, d]`` partials through ``ctx``'s slots; on CPU
    tensors: the plain version (``kernels.mega_prefill_plain_tp``).
    Returns ``(logits [1, n·v_loc] f32 of row true_len - 1 (rank r's
    columns from r·v_loc), knew, vnew [n, L, hkv, S, hd])``; ``info``
    (optional) receives each rank's final ``x [n, S, d]`` and, on the
    card, the launch geometry."""
    check_dims(dims, cfg)
    n = dims.n_ranks
    if not dims.prefill or n < 2:
        raise ValueError("mega_prefill_tp runs a prefill graph at "
                         "n_ranks > 1")
    if len(w) != n:
        raise ValueError(f"want {n} per-rank weights, got {len(w)}")
    for wr in w:
        _check_prefill_inputs(dims, wr, x0, true_len)
    dev = x0.device
    if inv_freq is None:
        inv_freq = _kernels.rope_inv_freq(dims.head_dim, dims.rope_theta, dev)
    if dev.type != "cuda":
        return _kernels.mega_prefill_plain_tp(
            dims, cfg.fuse_norms, table.cpu().numpy(), w, x0, true_len,
            inv_freq, info=info)
    if ctx is None or ctx.tp != n or ctx.device != dev:
        raise ValueError(f"a tp={n} launch needs the ranks' DistContext on "
                         f"{dev}, got {ctx}")
    if bar is None:
        bar = torch.zeros(4 * n, dtype=torch.int32, device=dev)
    if bar.numel() < 4 * n:
        raise ValueError(f"bar needs 4 counters a rank, got {bar.numel()}")
    mdt = _check_weights(w[0], cfg, dims, dev)
    for wr in w[1:]:
        if _check_weights(wr, cfg, dims, dev) != mdt:
            raise ValueError("the ranks' weights differ in dtype")
    _check_prefill_operands(x0, true_len, table, inv_freq, bar, mdt)
    S, d = dims.batch, dims.d
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g_cap = n_sms * MAX_BLOCKS_PER_SM
    ws_n = -(-prefill_workspace_floats(dims) // 4) * 4  # 16-byte rank rows
    ws = torch.empty((n, ws_n), dtype=torch.float32, device=dev)
    logits = torch.empty((n, 1, dims.v_loc), dtype=torch.float32,
                         device=dev)
    knew = torch.empty((n, dims.num_layers, dims.hkv_loc, S, dims.head_dim),
                       dtype=mdt, device=dev)
    vnew = torch.empty_like(knew)
    # Per rank two alternating slot sets of the partials [n, S, d].
    fs, slots, epoch = _tp_site(ctx, "mega_prefill", n, g_cap,
                                2 * n * S * d)
    ptrs, ints = [], []
    for r in range(n):
        ptrs += _prefill_ptrs(w[r], x0, true_len, table, inv_freq, logits[r],
                              knew[r], vnew[r], ws[r], bar[4 * r:])
        ints += _prefill_ints(dims, cfg, table, mdt, ws_n)
    out = (ctypes.c_int * 4)()
    ck.MEGA_PREFILL_TP(
        n, (ctypes.c_uint64 * len(ptrs))(*ptrs),
        (ctypes.c_int * len(ints))(*ints), ctypes.c_float(dims.rms_eps),
        ctypes.c_float(dims.head_dim ** -0.5), slots.table.data_ptr(),
        fs.flags.table.data_ptr(), epoch, fs.capacity, g_cap,
        int(blocks_per_rank), out, ck.stream_ptr(x0))
    if info is not None:
        info.update(blocks=out[0], smem_bytes=out[1], blocks_per_sm=out[2],
                    x=ws[:, :S * d].view(n, S, d))
    return (logits.permute(1, 0, 2).reshape(1, n * dims.v_loc), knew, vnew)


def _check_prefill_inputs(dims, w, x0, true_len) -> None:
    if tuple(x0.shape) != (dims.batch, dims.d) or x0.dtype != w.embed.dtype:
        raise ValueError(f"x0 must be [{dims.batch}, {dims.d}] "
                         f"{w.embed.dtype}, got {tuple(x0.shape)} {x0.dtype}")
    if tuple(true_len.shape) != (1,) or true_len.dtype != torch.int32:
        raise ValueError("true_len must be [1] int32")


def _check_prefill_operands(x0, true_len, table, inv_freq, bar, mdt):
    dev = x0.device
    for name, t, dt, nd in (("x0", x0, mdt, 2),
                            ("true_len", true_len, torch.int32, 1),
                            ("table", table, torch.int32, 2),
                            ("inv_freq", inv_freq, torch.float32, 1),
                            ("bar", bar, torch.int32, 1)):
        ck.check_cuda_operand(name, t, dev, dt, nd)


def _prefill_ptrs(w, x0, true_len, table, inv_freq, logits, knew, vnew, ws,
                  bar) -> list:
    """One rank's operand pointers (``tdt_mega_prefill``'s layout)."""
    return [_ptr(t) for t in (
        x0, w.wqkv, w.wo, w.w1, w.w2, w.lm_head, w.ln1, w.ln2, w.normf,
        w.qn, w.kn, true_len, table, inv_freq, logits, knew, vnew, ws, bar,
        w.sc_qkv, w.sc_o, w.sc_w1, w.sc_w2, w.sc_lm)]


def _prefill_ints(dims, cfg, table, mdt, ws_n) -> tuple:
    """One rank's geometry ints (``tdt_mega_prefill``'s layout)."""
    return (table.shape[0], dims.batch, dims.d, dims.hq_loc, dims.hkv_loc,
            dims.head_dim, dims.f_loc, dims.v_loc, dims.num_layers,
            int(cfg.fuse_norms), ck.DTYPE_CODES[mdt], ws_n, int(cfg.wq8))


class MegaCall:
    """A scheduled task table bound to its device (the JAX
    ``build_mega_call``): ``__call__`` runs one launch (``nsteps`` decode
    steps) through :func:`mega_decode`, and :meth:`prefill` one prefill
    launch through :func:`mega_prefill`, with the rope table and the grid
    barrier's counter made once. Every barrier adds exactly 2^31 to the
    counter, so a finished launch leaves it ready for the next; launches
    of one call run one after another on the stream."""

    def __init__(self, dims: MegaDims, cfg: MegaConfig, tasks: list[Task],
                 table: np.ndarray, device, ctx=None):
        check_dims(dims, cfg)
        used = {t.task_type for t in tasks}
        bodies = (PREFILL_TASKS if dims.prefill
                  else KERNEL_TASKS | MOE_TASKS if dims.moe else KERNEL_TASKS)
        if dims.n_ranks > 1:
            bodies = bodies | ({TaskType.BARRIER} if dims.prefill
                               else TP_TASKS)
        if not used <= bodies:
            raise NotImplementedError(
                f"no CUDA megakernel body for "
                f"{sorted(t.name for t in used - bodies)}")
        self.dims, self.cfg = dims, cfg
        self.table = torch.from_numpy(np.asarray(table, np.int32)).to(device)
        self.inv_freq = _kernels.rope_inv_freq(dims.head_dim,
                                               dims.rope_theta, device)
        self.ctx = ctx
        self.bar = torch.zeros(4 * dims.n_ranks, dtype=torch.int32,
                               device=device)

    def __call__(self, w: MegaWeights, kc, vc, page_table, kv_len, tokens,
                 stop_tok=None, info: dict | None = None, k_scale=None,
                 v_scale=None, noise=None, sampcfg=None, ring_state=None,
                 moe_route=None, moe_x=None):
        """One launch. At ``n_ranks > 1``, ``w``, ``kc`` and ``vc`` are
        per-rank lists and the MoE records carry a rank axis
        (:func:`mega_decode_tp`)."""
        if self.dims.n_ranks > 1:
            if any(t is not None for t in (k_scale, v_scale, noise,
                                           sampcfg)):
                raise ValueError("a tp > 1 launch takes no int8 scales or "
                                 "noise")
            return mega_decode_tp(self.dims, self.cfg, self.table, w, kc, vc,
                                  page_table, kv_len, tokens, self.ctx,
                                  stop_tok, self.inv_freq, self.bar, info,
                                  ring_state, moe_route=moe_route,
                                  moe_x=moe_x)
        return mega_decode(self.dims, self.cfg, self.table, w, kc, vc,
                           page_table, kv_len, tokens, stop_tok,
                           self.inv_freq, self.bar, info, k_scale, v_scale,
                           noise, sampcfg, ring_state, moe_route, moe_x)

    def prefill(self, w, x0, true_len, info: dict | None = None):
        """One prefill launch (``w`` per-rank at ``n_ranks > 1``:
        :func:`mega_prefill_tp`)."""
        if self.dims.n_ranks > 1:
            return mega_prefill_tp(self.dims, self.cfg, self.table, w, x0,
                                   true_len, self.ctx, self.inv_freq,
                                   self.bar, info)
        return mega_prefill(self.dims, self.cfg, self.table, w, x0,
                            true_len, self.inv_freq, self.bar, info)
