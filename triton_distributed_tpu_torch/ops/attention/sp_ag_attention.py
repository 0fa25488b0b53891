"""Sequence-parallel all-gather attention (long-context causal prefill).

Counterpart of ``triton_distributed_tpu/ops/attention/sp_ag_attention.py``:
``sp_ag_attention`` (:150) and ``sp_ag_attention_2level`` (:219). The
sequence is sharded over the context's ranks in rank order: rank ``me``
holds q/k/v rows ``[me * s_loc, (me + 1) * s_loc)`` and attends, causally,
over K/V chunks ``0..me`` (earlier chunks fully, its own in local
indices). Each function takes and returns one tensor per rank.

On the card :func:`sp_ag_attention` launches the hand-written kernel
(``csrc/sp_attention.cu``, replacing ``_sp_ag_attn_kernel`` :39): each
rank pushes its K/V shard to every later rank's workspace and runs a
causal flash attention over the chunks as they arrive, in one cooperative
launch of all ranks. It takes head dim 128 and GQA groups 1, 2, 4 and 8
(the Qwen3 presets'), f32 or bf16; other shapes raise ``ValueError``. On
the CPU it runs :func:`sp_ag_attention_plain`: the shards gathered in
rank order, then :func:`~triton_distributed_tpu_torch.ops.attention.
flash_attention.mha_reference` (causal, at ``kv_offset = me * s_loc``) on
this rank's rows.

:func:`sp_ag_attention_2level` runs over a ``dp x tp`` context (the
sequence in global rank order ``d * tp + t``): the SP attention inside
each dp group, then the earlier groups' K/V, fully visible, through
``flash_attention(causal=False)``, merged by log-sum-exp (the plain
merge: no kernel of its own).
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.language.primitives import (
    next_epoch,
    site_flags,
)
from triton_distributed_tpu_torch.ops import cuda_kernels as ck
from triton_distributed_tpu_torch.ops.attention.flash_attention import (
    _NEG_INF,
    flash_attention,
    mha_reference,
)
from triton_distributed_tpu_torch.ops.attention.flash_decode import (
    lse_combine,
)
from triton_distributed_tpu_torch.ops.common import (
    check_ranks,
    device_initiable,
    rank_ptrs,
)

HEAD_DIM = 128
GROUPS = (1, 2, 4, 8)
_capacity: dict = {}


def _check_shapes(qs, ks, vs, ctx) -> tuple:
    check_ranks("q", qs, ctx, ndim=3)
    check_ranks("k", ks, ctx, ndim=3)
    check_ranks("v", vs, ctx, ndim=3)
    hq, s_loc, hd = qs[0].shape
    hkv = ks[0].shape[0]
    if tuple(ks[0].shape) != (hkv, s_loc, hd) or vs[0].shape != ks[0].shape:
        raise ValueError(f"k/v {tuple(ks[0].shape)} do not match q "
                         f"{tuple(qs[0].shape)}")
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    return hq, hkv, s_loc, hd


def sp_ag_attention_plain(qs, ks, vs, *, sm_scale: float | None = None):
    """Each rank's ``(o [hq, s_loc, hd], lse [hq, s_loc] f32)``: its rows
    against the shards 0..me gathered in rank order, causal, in f32."""
    s_loc = qs[0].shape[1]
    outs, lses = [], []
    for me, q in enumerate(qs):
        k = torch.cat(ks[:me + 1], dim=1)
        v = torch.cat(vs[:me + 1], dim=1)
        o, lse = mha_reference(q[None], k[None], v[None], causal=True,
                               sm_scale=sm_scale, kv_offset=me * s_loc,
                               return_lse=True)
        outs.append(o[0])
        lses.append(lse[0])
    return outs, lses


def q_tile(dtype: torch.dtype, group: int) -> int:
    """The kernel's q rows a head a block: 16 (head, row) rows a warp on
    the tensor cores (4 warps, 8 at G = 8) in bf16, 16 rows a block in
    f32."""
    rows = 16 * max(4, group) if dtype == torch.bfloat16 else 16
    return rows // group


def sp_ag_attention_kernel(qs, ks, vs, ctx, *, sm_scale: float,
                           blocks_per_rank: int | None = None):
    """One cooperative launch of the kernel over all ranks: ``(o, lse)``
    lists. The grid defaults to every co-resident block, split evenly over
    the ranks (``blocks_per_rank`` overrides it; a grid that cannot be
    co-resident raises)."""
    n = ctx.tp
    hq, s_loc, hd = qs[0].shape
    hkv = ks[0].shape[0]
    dt = qs[0].dtype
    group = hq // hkv
    if dt not in ck.DTYPE_CODES:
        raise ValueError(f"sp_ag_attention: dtype {dt} not f32/bf16")
    if hd != HEAD_DIM:
        raise ValueError(f"sp_ag_attention: head_dim {hd}, the kernel takes "
                         f"{HEAD_DIM}")
    if group not in GROUPS:
        raise ValueError(f"sp_ag_attention: q/kv head ratio {group} not in "
                         f"{GROUPS}")
    for name, ts in (("q", qs), ("k", ks), ("v", vs)):
        for r, t in enumerate(ts):
            ck.check_cuda_operand(f"{name}[{r}]", t, ctx.device, dt, 3)
    key = (ck.DTYPE_CODES[dt], group)
    if key not in _capacity:
        _capacity[key] = ck.coresident_blocks(
            "sp_attention", "tdt_sp_ag_attention_capacity", *key)
    items = hkv * -(-s_loc // q_tile(dt, group))
    blocks = (int(blocks_per_rank) if blocks_per_rank is not None
              else max(1, min(_capacity[key] // n, items)))
    ws = ctx.workspace("sp_ag_attention", (n, 2, hkv, s_loc, hd), dt)
    fs = site_flags(ctx, "sp_ag_attention", n + n * blocks)
    o = torch.empty((n, hq, s_loc, hd), dtype=dt, device=ctx.device)
    lse = torch.empty((n, hq, s_loc), dtype=torch.float32, device=ctx.device)
    os_ = [o[r] for r in range(n)]
    ls = [lse[r] for r in range(n)]
    ck.SP_AG_ATTENTION(
        key[0], group, rank_ptrs(qs), rank_ptrs(ks), rank_ptrs(vs),
        rank_ptrs(os_), rank_ptrs(ls), ws.table.data_ptr(),
        fs.flags.table.data_ptr(), n, hkv, s_loc, hd, float(sm_scale),
        next_epoch(fs), blocks, ck.stream_ptr(qs[0]))
    return os_, ls


def sp_ag_attention(qs, ks, vs, ctx, *, sm_scale: float | None = None,
                    return_lse: bool = False):
    """Causal SP attention: ``qs[r] [hq, s_loc, hd]``, ``ks[r]``/``vs[r]
    [hkv, s_loc, hd]`` rank r's shards. Returns ``o [hq, s_loc, hd]`` a
    rank (q's dtype), plus ``lse [hq, s_loc]`` f32 a rank when
    ``return_lse``. The JAX function's ``block_q`` has no counterpart: the
    card's kernel picks its own tiles and takes any s_loc."""
    _, _, s_loc, hd = _check_shapes(qs, ks, vs, ctx)
    if sm_scale is None:
        sm_scale = hd**-0.5
    if device_initiable(ctx):
        o, lse = sp_ag_attention_kernel(qs, ks, vs, ctx, sm_scale=sm_scale)
    else:
        o, lse = sp_ag_attention_plain(qs, ks, vs, sm_scale=sm_scale)
    return (o, lse) if return_lse else o


def sp_ag_attention_2level(qs, ks, vs, ctx, *,
                           sm_scale: float | None = None):
    """Two-level causal SP attention over a ``dp x tp`` context: one
    tensor per global rank (``d * tp + t``, the sequence in that order).
    The inner level is :func:`sp_ag_attention` in each dp group; the
    outer attends this rank's rows over the earlier groups' K/V (fully
    visible) and merges the two partials by log-sum-exp."""
    tp = ctx.tp
    if len(qs) != ctx.world:
        raise ValueError(f"q: {len(qs)} tensors for dp x tp = {ctx.world}")
    hd = qs[0].shape[2]
    if sm_scale is None:
        sm_scale = hd**-0.5
    intra = []
    for d in range(ctx.dp):
        sl = slice(d * tp, (d + 1) * tp)
        o, lse = sp_ag_attention(qs[sl], ks[sl], vs[sl], ctx.group(d),
                                 sm_scale=sm_scale, return_lse=True)
        intra += list(zip(o, lse))
    if ctx.dp == 1:
        return [o for o, _ in intra]
    outs = []
    for r, q in enumerate(qs):
        o_in, lse_in = intra[r]
        d = r // tp
        if d == 0:  # no earlier group: a weight-0 partial
            o_prev = torch.zeros(q.shape, dtype=torch.float32,
                                 device=q.device)
            lse_prev = torch.full(q.shape[:2], _NEG_INF, dtype=torch.float32,
                                  device=q.device)
        else:
            k = torch.cat(ks[:d * tp], dim=1)
            v = torch.cat(vs[:d * tp], dim=1)
            o_prev, lse_prev = flash_attention(
                q[None], k[None], v[None], causal=False, sm_scale=sm_scale,
                return_lse=True)
            o_prev, lse_prev = o_prev[0].to(torch.float32), lse_prev[0]
        o, _ = lse_combine(torch.stack([o_in.to(torch.float32), o_prev]),
                           torch.stack([lse_in, lse_prev]), part_axis=0)
        outs.append(o.to(q.dtype))
    return outs
