"""Expert-parallel MoE dispatch and combine over co-located ranks.

Counterpart of ``triton_distributed_tpu/ops/moe/ep_a2a.py``:
``DispatchState``, ``_fp8_encode``, ``_resolve_method``, ``ep_dispatch``
(:89), ``ep_combine`` (:218) and ``ep_moe_ffn`` (:268). The JAX functions
run inside ``shard_map`` on one rank's tokens; here each takes one
tensor per rank of the context (the EP axis is the context's ``tp``
ranks) and returns one per rank, each rank's work in a loop, the
exchanges over all ranks at once.

Lossless by default (``capacity=None``: every per-destination segment
holds the provable worst case ``T * k`` rows and the real splits ride
along); a ``capacity`` bounds memory and counts the overflow in
``DispatchState.num_dropped``. ``payload_dtype="fp8"`` quantizes the
dispatched rows to ``torch.float8_e4m3fn`` with a per-row f32 scale.

Transports (``method``): ``"pallas"`` packs payload (+ scale) + expert id
into one uint8 row a token and moves the filled prefixes through
:func:`~triton_distributed_tpu_torch.ops.moe.ep_exchange.ep_exchange`
(the hand-written kernel on the card); ``"xla"`` moves whole segments
with the plain all-to-all; ``"auto"`` is ``"pallas"`` on the card and
``"xla"`` on the CPU. Both give the same bits: rows past a count are
masked to expert 0 and a zero payload.

The combine sums each token's ``k`` contributions in ``k`` order (JAX's
``out.at[token_ids].add`` over ``token_ids = arange(T * k) // k`` adds
them in that order), never with atomics, so the transports agree bit for
bit on the card too. Nothing here reads a count on the host; the grouped
expert FFN reads its group sizes once a rank (``ops/moe/grouped_gemm``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from triton_distributed_tpu_torch.ops.collectives.all_to_all import (
    all_to_all,
)
from triton_distributed_tpu_torch.ops.common import device_initiable
from triton_distributed_tpu_torch.ops.moe.ep_exchange import (
    ep_exchange,
    pack_rows,
    unpack_row,
)
from triton_distributed_tpu_torch.ops.moe.grouped_gemm import grouped_ffn
from triton_distributed_tpu_torch.ops.moe.routing import (
    RouterOut,
    router_topk,
)

FP8_MAX = 448.0  # float8_e4m3fn's largest normal
# Under jit XLA turns the JAX ``/ 448.0`` into a product with the f32
# reciprocal; the port multiplies by it, so its scales are the jitted
# JAX program's bit for bit (an eager JAX call divides: an ulp apart).
_INV_FP8_MAX = torch.tensor(1.0 / FP8_MAX, dtype=torch.float32).item()


class DispatchState(NamedTuple):
    """Everything a source rank needs to route results back."""

    dest: torch.Tensor         # [T*k] int32 destination rank a assignment
    slot: torch.Tensor         # [T*k] int32 slot in the destination segment
    valid: torch.Tensor        # [T*k] bool: False only past a capacity
    weights: torch.Tensor      # [T*k] f32 gate weights
    token_ids: torch.Tensor    # [T*k] int32 source token
    num_dropped: torch.Tensor  # [] int32: 0 lossless, by construction
    splits: torch.Tensor       # [n] int32 rows sent a destination (clipped)
    recv_counts: torch.Tensor  # [n] int32 rows received a source


def _fp8_encode(x: torch.Tensor):
    """Per-row fp8 quantization: codes ``float8_e4m3fn`` and f32 scales
    ``max(|x|, 1e-12) / 448`` (as the f32 reciprocal's product)."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) * _INV_FP8_MAX
    return (xf / scale).to(torch.float8_e4m3fn), scale


def _resolve_method(method: str, ctx) -> str:
    """``auto``: the kernel transport on the card, the plain one on the
    CPU."""
    if method not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown EP method {method!r}")
    if method != "auto":
        return method
    return "pallas" if device_initiable(ctx) else "xla"


def _dispatch_local(x: torch.Tensor, route: RouterOut, n: int, epr: int,
                    capacity: int):
    """One rank's send buffers and state (no exchange): the segment a
    (token, expert) assignment goes to and its slot there (its occurrence
    index among the assignments of that destination)."""
    t, d = x.shape
    k = route.expert_ids.shape[1]
    dev = x.device
    flat_e = route.expert_ids.reshape(-1).long()
    dest = flat_e // epr
    token_ids = torch.arange(t * k, device=dev) // k
    onehot = torch.nn.functional.one_hot(dest, n).to(torch.int32)
    occ = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    slot = torch.gather(occ, 1, dest[:, None])[:, 0]
    valid = slot < capacity
    splits = onehot.sum(dim=0, dtype=torch.int32)
    num_dropped = torch.clamp(splits - capacity, min=0).sum(
        dtype=torch.int32)
    # Dropped assignments land in a spare row past the capacity, cut off.
    at = torch.where(valid, slot.long(), torch.full_like(slot.long(),
                                                         capacity))
    send_x = torch.zeros((n, capacity + 1, d), dtype=x.dtype, device=dev)
    send_x[dest, at] = x[token_ids]
    send_e = torch.zeros((n, capacity + 1), dtype=torch.int32, device=dev)
    send_e[dest, at] = (flat_e % epr).to(torch.int32)
    state = DispatchState(
        dest.to(torch.int32), slot, valid, route.weights.reshape(-1),
        token_ids.to(torch.int32), num_dropped,
        torch.clamp(splits, max=capacity), None)
    return send_x[:, :capacity].contiguous(), \
        send_e[:, :capacity].contiguous(), state


def ep_dispatch(xs, routes, num_experts: int, capacity: int | None = None,
                *, ctx, method: str = "auto",
                payload_dtype: str | None = None):
    """Send each (token, expert) assignment to the expert's owner rank.
    ``xs[r] [T, d]`` and ``routes[r]`` are rank r's tokens and routing.
    Returns per-rank lists ``(recv_x [n*C, d], recv_expert [n*C] local
    expert ids, recv_valid [n*C], states)``: rows where ``recv_valid`` is
    False hold expert 0 and a zero payload on both transports."""
    n = ctx.tp
    t, d = xs[0].shape
    k = routes[0].expert_ids.shape[1]
    epr = num_experts // n
    if capacity is None:
        capacity = t * k  # the provable per-source worst case
    local = [_dispatch_local(x, rt, n, epr, capacity)
             for x, rt in zip(xs, routes)]
    send_x = [s[0] for s in local]
    send_e = [s[1] for s in local]
    splits = [s[2].splits for s in local]
    recv_counts = [c[:, 0, 0] for c in all_to_all(
        [s[:, None, None] for s in splits], ctx, method="xla")]
    method = _resolve_method(method, ctx)
    recv_v = [(torch.arange(capacity, device=c.device)[None, :]
               < c[:, None]).reshape(n * capacity) for c in recv_counts]
    dt = xs[0].dtype
    if payload_dtype == "fp8":
        coded = [_fp8_encode(s.reshape(n * capacity, d)) for s in send_x]
    recv_x, recv_e = [], []
    if method == "pallas":
        if payload_dtype == "fp8":
            packed = [pack_rows([q.reshape(n, capacity, d),
                                 sc.reshape(n, capacity, 1), e[..., None]])
                      for (q, sc), e in zip(coded, send_e)]
        else:
            packed = [pack_rows([s, e[..., None]])
                      for s, e in zip(send_x, send_e)]
        offs = packed[0][1]
        out_rows = ep_exchange([p[0] for p in packed],
                               [sp.contiguous() for sp in splits],
                               recv_counts, ctx)
        for rows, v in zip(out_rows, recv_v):
            if payload_dtype == "fp8":
                q = unpack_row(rows, offs[0], torch.float8_e4m3fn, d)
                sc = unpack_row(rows, offs[1], torch.float32, 1)
                x = (q.to(torch.float32) * sc).to(dt)
                e = unpack_row(rows, offs[2], torch.int32, 1)[..., 0]
            else:
                x = unpack_row(rows, offs[0], dt, d)
                e = unpack_row(rows, offs[1], torch.int32, 1)[..., 0]
            # Rows past each source's count were never written.
            x = x.reshape(n * capacity, d)
            recv_x.append(torch.where(v[:, None], x, torch.zeros_like(x)))
            e = e.reshape(n * capacity)
            recv_e.append(torch.where(v, e, torch.zeros_like(e)))
    else:
        if payload_dtype == "fp8":
            rq = all_to_all([q.reshape(n, capacity, d) for q, _ in coded],
                            ctx, method="xla")
            rs = all_to_all([sc.reshape(n, capacity, 1) for _, sc in coded],
                            ctx, method="xla")
            xs_ = [(q.to(torch.float32) * sc).to(dt) for q, sc in zip(rq, rs)]
        else:
            xs_ = all_to_all(send_x, ctx, method=method)
        recv_x = [x.reshape(n * capacity, d) for x in xs_]
        recv_e = [e[..., 0].reshape(n * capacity) for e in all_to_all(
            [e[..., None] for e in send_e], ctx, method="xla")]
    states = [s[2]._replace(recv_counts=c) for s, c in zip(local,
                                                          recv_counts)]
    return recv_x, recv_e, recv_v, states


def combine_rows(back: torch.Tensor, state: DispatchState,
                 num_tokens: int) -> torch.Tensor:
    """The weighted reduce of the rows a rank got back ``[n, C, d]``: each
    assignment's row (slot clamped, as JAX's gathers clamp) times its gate
    weight (0 where dropped), in f32, summed over a token's ``k``
    assignments in order from 0, rounded to ``back``'s dtype."""
    c = back.shape[1]
    slot = torch.clamp(state.slot.long(), max=c - 1)
    picked = back[state.dest.long(), slot].to(torch.float32)
    w = torch.where(state.valid, state.weights,
                    torch.zeros_like(state.weights))
    contrib = (picked * w[:, None]).reshape(num_tokens, -1, back.shape[2])
    out = torch.zeros((num_tokens, back.shape[2]), dtype=torch.float32,
                      device=back.device)
    for j in range(contrib.shape[1]):
        out = out + contrib[:, j]
    return out.to(back.dtype)


def ep_combine(expert_outs, states, num_tokens: int, *, ctx,
               method: str = "auto") -> list[torch.Tensor]:
    """Route the expert outputs ``expert_outs[r] [n*C, d]`` (receiver
    order) back and reduce them weighted per token: ``[T, d]`` a rank. The
    payload stays in the model dtype."""
    n = ctx.tp
    capacity = expert_outs[0].shape[0] // n
    d = expert_outs[0].shape[1]
    method = _resolve_method(method, ctx)
    if method == "pallas":
        packed = [pack_rows([e.reshape(n, capacity, d)]) for e in expert_outs]
        out_rows = ep_exchange([p[0] for p in packed],
                               [s.recv_counts for s in states],
                               [s.splits for s in states], ctx)
        backs = []
        for rows, s in zip(out_rows, states):
            b = unpack_row(rows, packed[0][1][0], expert_outs[0].dtype, d)
            # Rows past each destination's count were never written: they
            # would poison the sum through the clamped gathers (NaN*0).
            sent = (torch.arange(capacity, device=b.device)[None, :]
                    < s.splits[:, None])
            backs.append(torch.where(sent[..., None], b, torch.zeros_like(b)))
    else:
        backs = all_to_all([e.reshape(n, capacity, d) for e in expert_outs],
                           ctx, method=method)
    return [combine_rows(b, s, num_tokens) for b, s in zip(backs, states)]


def ep_moe_ffn(xs, w_router, w1, w2, k: int, *, ctx,
               capacity_factor: float | None = None, method: str = "auto",
               norm_topk_prob: bool = True, payload_dtype: str | None = None,
               return_state: bool = False):
    """The expert-parallel MoE FFN: ``xs[r] [T, d]`` rank r's tokens,
    ``w_router [d, E]`` (replicated), ``w1[r] [E/n, d, 2f]``
    (gate | up fused) and ``w2[r] [E/n, f, d]`` rank r's experts
    (experts ``r * E/n ..``). Returns ``[T, d]`` a rank (with the
    per-rank ``DispatchState`` when ``return_state``)."""
    n = ctx.tp
    t = xs[0].shape[0]
    epr = w1[0].shape[0]
    num_experts = epr * n
    capacity = None
    if capacity_factor is not None:
        # Expected load a destination is t*k/n; rounded up to 8 rows.
        capacity = int(-(-(t * k * capacity_factor / n) // 8) * 8)
    routes = [router_topk(x, w_router, k, norm_topk_prob=norm_topk_prob)
              for x in xs]
    recv_x, recv_e, _, states = ep_dispatch(
        xs, routes, num_experts, capacity, ctx=ctx, method=method,
        payload_dtype=payload_dtype)
    expert_outs = []
    for rx, re, a, b in zip(recv_x, recv_e, w1, w2):
        # Invalid rows arrive as expert 0 with a zero payload: one extra
        # group row each, contributing nothing.
        order = torch.argsort(re, stable=True)
        inv = torch.argsort(order)
        sizes = torch.bincount(re.long(), minlength=epr).to(torch.int32)
        expert_outs.append(grouped_ffn(rx[order], a, b, sizes)[inv])
    outs = ep_combine(expert_outs, states, t, ctx=ctx, method=method)
    return (outs, states) if return_state else outs
