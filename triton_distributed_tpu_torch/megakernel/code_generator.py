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

Built here: greedy decode at tp=1 over a dense or a full-width paged
cache, f32 or bf16 weights, ``nsteps >= 1``, ``eos``. Every other
``MegaDims`` mode, and ``MegaConfig.wq8``, raise ``NotImplementedError``
naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from triton_distributed_tpu_torch.megakernel import kernels as _kernels
from triton_distributed_tpu_torch.megakernel.task import Task, TaskType
from triton_distributed_tpu_torch.ops import cuda_kernels as ck

# Task types the CUDA kernel has bodies for (the decode graph at tp=1).
KERNEL_TASKS = frozenset({
    TaskType.EMBED, TaskType.NORM, TaskType.QKV_PROJ, TaskType.ATTN,
    TaskType.O_PROJ, TaskType.FC1, TaskType.FC2, TaskType.ALLREDUCE,
    TaskType.LM_HEAD,
})
# Kernel geometry shared with csrc/megakernel.cu (kMaxSplit, kAttnChunk,
# blocks per SM at most): the workspace is sized from it.
MAX_SPLIT = 16
ATTN_CHUNK = 128
MAX_BLOCKS_PER_SM = 2


@dataclasses.dataclass(frozen=True)
class MegaDims:
    """Static geometry of the decode step (the JAX fields, so a JAX
    ``MegaDims`` reads the same). Modes outside this slice — ``kv_quant``,
    ``prefill``, ``sampled``, ``filtered``, ``ring``, ``trace``, MoE and
    ``n_ranks > 1`` — are refused by :func:`check_dims`."""

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
    only at tp > 1. The TPU staging knobs — ``tile_n``, ``tile_k``,
    ``s_blk``, ``nbuf``, ``cross_prefetch`` — are accepted so configs
    and spec strings carry over, and do not change the CUDA kernel,
    which sizes its own tiles. ``wq8`` (int8 weights) is not ported."""

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


WQ8_UNPORTED = ("MegaConfig(wq8=True) (int8 weights with per-channel "
                "scales) is not ported yet (ROADMAP queue 2 row 6, wq8)")


@dataclasses.dataclass(frozen=True)
class MegaWeights:
    """The tensors the kernel reads, as the model holds them (views of
    ``Qwen3.params``, never copies): stacked per layer, contiguous."""

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

    @classmethod
    def from_params(cls, params: dict) -> "MegaWeights":
        lp = params["layers"]
        return cls(
            embed=params["embed"], wqkv=lp["attn"]["wqkv"],
            wo=lp["attn"]["wo"], w1=lp["mlp"]["w1"], w2=lp["mlp"]["w2"],
            lm_head=params["lm_head"], ln1=lp["ln1"], ln2=lp["ln2"],
            normf=params["norm"], qn=lp["attn"]["q_norm"],
            kn=lp["attn"]["k_norm"],
        )


def check_dims(dims: MegaDims, cfg: MegaConfig) -> None:
    """Refuse what this slice does not build, naming the ROADMAP item."""
    refused = [
        (cfg.wq8, WQ8_UNPORTED),
        (dims.kv_quant, "kv_quant (the int8 pool in the megakernel) is not "
                        "ported yet (ROADMAP queue 2 row 6, int8 pool)"),
        (dims.prefill, "the prefill megakernel is not ported yet (ROADMAP "
                       "queue 2 row 6(d)); the engines prefill with 'xla'"),
        (dims.sampled or dims.filtered,
         "sampled / filtered multi-step decode is not ported yet (ROADMAP "
         "queue 2 row 6(b))"),
        (dims.ring, "the resident work ring is not ported yet (ROADMAP "
                    "queue 2 row 6(c))"),
        (dims.trace, "the device task tracer is not ported yet (ROADMAP "
                     "queue 2 row 6(c))"),
        (dims.moe, "MoE megakernel bodies are not ported yet (ROADMAP "
                   "queue 2 row 6(e))"),
        (dims.n_ranks != 1 or dims.straggler_rank is not None,
         "multi-rank megakernel bodies are not ported yet (ROADMAP queue 2 "
         "row 6(e), tp > 1)"),
    ]
    for bad, msg in refused:
        if bad:
            raise NotImplementedError(msg)
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
    per-block argmax candidates."""
    B, d, hd = dims.batch, dims.d, dims.head_dim
    hq, hkv = dims.hq_loc, dims.hkv_loc
    g = hq // hkv
    nch = -(-dims.s_max // ATTN_CHUNK)
    nblk = n_sms * MAX_BLOCKS_PER_SM
    return (2 * B * d + B * dims.qkv_loc + B * hq * hd + B * dims.f_loc
            + MAX_SPLIT * B * max(dims.qkv_loc, d, 2 * dims.f_loc)
            + B * hkv * nch * g * (hd + 2)
            + B * hq * hd + 2 * B * hkv * hd + 2 * nblk * B)


def mega_decode(dims: MegaDims, cfg: MegaConfig, table: torch.Tensor,
                w: MegaWeights, kc, vc, page_table, kv_len, tokens,
                stop_tok=None, inv_freq=None, bar=None,
                info: dict | None = None):
    """Run the packed task ``table [T, 8]`` for ``dims.nsteps`` steps.

    On CUDA tensors: one cooperative launch of ``csrc/megakernel.cu``
    (counted in ``cuda_kernels.MEGA_DECODE``); on CPU tensors: the plain
    version. Returns ``(logits [B, v_loc] f32 of the last step, knew,
    vnew [NS, L, B, hkv, hd] in the cache dtype, toks [NS, B] int32,
    stop_step [B] int32)``. ``inv_freq`` is the rope table
    (``kernels.rope_inv_freq``) and ``bar`` the grid barrier's int32
    counter; both are made afresh when not given (:class:`MegaCall` keeps
    its own). ``info`` (optional) receives the launch geometry (blocks,
    shared memory bytes, occupancy per SM)."""
    check_dims(dims, cfg)
    dev = kv_len.device
    if inv_freq is None:
        inv_freq = _kernels.rope_inv_freq(dims.head_dim, dims.rope_theta,
                                          dev)
    if dev.type != "cuda":
        return _kernels.mega_decode_plain(
            dims, cfg.fuse_norms, table.cpu().numpy(), w, kc, vc,
            page_table, kv_len, tokens, stop_tok, inv_freq)
    if bar is None:
        bar = torch.zeros(4, dtype=torch.int32, device=dev)
    return _launch(dims, cfg, table, w, kc, vc, page_table, kv_len, tokens,
                   stop_tok, inv_freq, bar, info)


def _launch(dims, cfg, table, w, kc, vc, page_table, kv_len, tokens,
            stop_tok, inv_freq, bar, info):
    dev = kv_len.device
    B, NS, L = dims.batch, dims.nsteps, dims.num_layers
    hkv, hd = dims.hkv_loc, dims.head_dim
    wdt = w.wqkv.dtype
    if wdt not in ck.DTYPE_CODES:
        raise ValueError(f"megakernel weights must be f32/bf16, got {wdt}")
    for f in dataclasses.fields(w):  # (asdict would deep-copy tensors)
        ck.check_cuda_operand(f.name, getattr(w, f.name), dev, wdt)
    for name, t in (("kc", kc), ("vc", vc)):
        ck.check_cuda_operand(name, t, dev, wdt, 5)
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
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ws_n = workspace_floats(dims, n_sms)
    ws = torch.empty(ws_n, dtype=torch.float32, device=dev)
    logits = torch.empty((B, dims.v_loc), dtype=torch.float32, device=dev)
    knew = torch.empty((NS, L, B, hkv, hd), dtype=wdt, device=dev)
    vnew = torch.empty_like(knew)
    toks = torch.zeros((NS, B), dtype=torch.int32, device=dev)
    stop_step = torch.full((B,), NS, dtype=torch.int32, device=dev)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    ptrs = (ctypes.c_uint64 * 26)(*[ptr(t) for t in (
        w.embed, w.wqkv, w.wo, w.w1, w.w2, w.lm_head, w.ln1, w.ln2,
        w.normf, w.qn, w.kn, kc, vc, page_table if dims.page else None,
        kv_len, tokens, stop_tok if dims.eos else None, table, inv_freq,
        logits, knew, vnew, toks, stop_step, ws, bar)])
    ints = (ctypes.c_int * 24)(
        table.shape[0], NS, B, dims.d, dims.hq_loc, hkv, hd, dims.f_loc,
        dims.v_loc, min(dims.v_real or dims.v_loc, dims.v_loc), L,
        dims.s_max, dims.page, dims.s_max // dims.page if dims.page else 0,
        kc.shape[1] if dims.page else 0, int(cfg.fuse_norms),
        int(dims.eos), ck.DTYPE_CODES[wdt], ws_n, w.embed.shape[0],
        int(_kernels.takes_argmax(dims)), 0, 0, 0)
    out = (ctypes.c_int * 4)()
    ck.MEGA_DECODE(ptrs, ints, ctypes.c_float(dims.rms_eps),
                   ctypes.c_float(hd ** -0.5), out, ck.stream_ptr(kv_len))
    if info is not None:
        info.update(blocks=out[0], smem_bytes=out[1], blocks_per_sm=out[2])
    return logits, knew, vnew, toks, stop_step


class MegaCall:
    """A scheduled task table bound to its device (the JAX
    ``build_mega_call``): ``__call__`` runs one launch (``nsteps`` decode
    steps) through :func:`mega_decode`, with the rope table and the grid
    barrier's counter made once. Every barrier adds exactly 2^31 to the
    counter, so a finished launch leaves it ready for the next; launches
    of one call run one after another on the stream."""

    def __init__(self, dims: MegaDims, cfg: MegaConfig, tasks: list[Task],
                 table: np.ndarray, device):
        check_dims(dims, cfg)
        used = {t.task_type for t in tasks}
        if not used <= KERNEL_TASKS:
            raise NotImplementedError(
                f"no CUDA megakernel body for "
                f"{sorted(t.name for t in used - KERNEL_TASKS)}")
        self.dims, self.cfg = dims, cfg
        self.table = torch.from_numpy(np.asarray(table, np.int32)).to(device)
        self.inv_freq = _kernels.rope_inv_freq(dims.head_dim,
                                               dims.rope_theta, device)
        self.bar = torch.zeros(4, dtype=torch.int32, device=device)

    def __call__(self, w: MegaWeights, kc, vc, page_table, kv_len, tokens,
                 stop_tok=None, info: dict | None = None):
        return mega_decode(self.dims, self.cfg, self.table, w, kc, vc,
                           page_table, kv_len, tokens, stop_tok,
                           self.inv_freq, self.bar, info)
