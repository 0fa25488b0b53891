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
launch of all ranks whose grid is split by each rank's causal work
(:func:`plan`). It takes head dim 128 and GQA groups 1, 2, 4 and 8
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

import ctypes

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
    """The kernel's q rows a head an item: 128 (head, row) rows on the
    tensor cores (two warpgroups of 64) in bf16, 16 a block in f32, over
    the ``group`` q heads of one kv head."""
    rows = 128 if dtype == torch.bfloat16 else 16
    return rows // group


def split_by_work(n: int, capacity: int, items: int) -> list[int]:
    """Blocks of each rank in one cooperative launch of ``capacity``
    co-resident blocks: rank r does (2r + 1) / n^2 of the causal work
    (``me * s_loc^2`` full chunks and a causal one), so it gets about that
    share, by largest remainder, at least one block (one push piece) and at
    most its ``items``. Non-decreasing in r; sums to at most ``capacity``."""
    if capacity < n:
        raise ValueError(f"sp_ag_attention: {capacity} co-resident blocks "
                         f"for {n} ranks")
    want = [capacity * (2 * r + 1) / n**2 for r in range(n)]
    counts = [max(1, int(w)) for w in want]
    spare = capacity - sum(counts)
    # The largest remainders (the later rank on a tie) take what is left.
    for r in sorted(range(n), key=lambda r: (want[r] - int(want[r]), r),
                    reverse=True):
        if spare <= 0:
            break
        if want[r] >= 1:
            counts[r] += 1
            spare -= 1
    while sum(counts) > capacity:  # the floors of 1 overran: take back
        r = max(range(n), key=lambda r: (counts[r], -r))
        counts[r] -= 1
    return [min(c, max(1, items)) for c in counts]


def flag_count(counts) -> int:
    """Flags a rank at the site: the entry barrier's n, then one a push
    piece of every source (``n + prefix(src) + g``)."""
    return len(counts) + sum(counts)


def plan(n: int, capacity: int, items: int,
         blocks_per_rank: int | None = None) -> tuple[list[int], int]:
    """The launch's blocks of each rank and its flags a rank: the split by
    work, or ``blocks_per_rank`` for every rank (the even grid)."""
    counts = ([int(blocks_per_rank)] * n if blocks_per_rank is not None
              else split_by_work(n, capacity, items))
    return counts, flag_count(counts)


def sp_ag_attention_kernel(qs, ks, vs, ctx, *, sm_scale: float,
                           blocks_per_rank: int | None = None):
    """One cooperative launch of the kernel over all ranks: ``(o, lse)``
    lists. The grid defaults to the co-resident blocks split by each
    rank's causal work (:func:`split_by_work`); ``blocks_per_rank`` gives
    every rank that many instead (a grid that cannot be co-resident
    raises). The two grids give bitwise the same outputs."""
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
    counts, n_flags = plan(n, _capacity[key], items, blocks_per_rank)
    ws = ctx.workspace("sp_ag_attention", (n, 2, hkv, s_loc, hd), dt)
    fs = site_flags(ctx, "sp_ag_attention", n_flags)
    o = torch.empty((n, hq, s_loc, hd), dtype=dt, device=ctx.device)
    lse = torch.empty((n, hq, s_loc), dtype=torch.float32, device=ctx.device)
    os_ = [o[r] for r in range(n)]
    ls = [lse[r] for r in range(n)]
    ck.SP_AG_ATTENTION(
        key[0], group, rank_ptrs(qs), rank_ptrs(ks), rank_ptrs(vs),
        rank_ptrs(os_), rank_ptrs(ls), rank_ptrs(list(ws.data)),
        ws.table.data_ptr(), fs.flags.table.data_ptr(), n, hkv, s_loc, hd,
        float(sm_scale), next_epoch(fs), (ctypes.c_int * n)(*counts),
        ck.stream_ptr(qs[0]))
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
