"""MoE routing: top-k gating, expert sort, weighted combine.

Counterpart of ``triton_distributed_tpu/ops/moe/routing.py``
(``router_topk`` :36, ``moe_sort`` :56, ``AlignedBlocks``,
``align_capacities`` and ``moe_align_block_size`` :72-129,
``moe_combine`` :131): the same functions as torch ops.
``jax.lax.top_k`` resolves ties to the lowest index, which ``torch.topk``
does not promise, so the top-k here is a stable descending sort; the
expert sort is a stable argsort, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RouterOut(NamedTuple):
    expert_ids: torch.Tensor  # [T, k] int32
    weights: torch.Tensor     # [T, k] f32, normalized gate weights


class SortedTokens(NamedTuple):
    order: torch.Tensor        # [T*k] argsort of the flattened expert ids
    token_ids: torch.Tensor    # [T*k] source token of each sorted slot
    expert_ids: torch.Tensor   # [T*k] expert of each sorted slot (ascending)
    weights: torch.Tensor      # [T*k] f32 gate weight of each sorted slot
    group_sizes: torch.Tensor  # [E] int32 tokens per expert


def router_topk(x: torch.Tensor, w_router: torch.Tensor, k: int, *,
                norm_topk_prob: bool = True) -> RouterOut:
    """Qwen3-MoE gate over ``x [T, d]`` and ``w_router [d, E]``: f32
    logits, softmax over every expert, the top ``k`` (ties to the lowest
    expert index), renormalized to sum to 1 under ``norm_topk_prob``."""
    logits = x.to(torch.float32) @ w_router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = vals[:, :k], ids[:, :k]
    if norm_topk_prob:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return RouterOut(ids.to(torch.int32), weights)


def moe_sort(route: RouterOut, num_experts: int) -> SortedTokens:
    """(token, expert) assignments in expert-contiguous order: a stable
    argsort of the flattened expert ids."""
    flat_e = route.expert_ids.reshape(-1).long()
    flat_w = route.weights.reshape(-1)
    k = route.expert_ids.shape[1]
    order = torch.argsort(flat_e, stable=True)
    return SortedTokens(
        order=order,
        token_ids=(order // k).to(torch.int32),
        expert_ids=flat_e[order].to(torch.int32),
        weights=flat_w[order],
        group_sizes=torch.bincount(flat_e, minlength=num_experts).to(
            torch.int32),
    )


class AlignedBlocks(NamedTuple):
    """The block-aligned grouped-GEMM schedule."""

    sorted_ids: torch.Tensor    # [cap] slot -> flattened source index; pad n
    block_expert: torch.Tensor  # [bcap] tile -> expert id; past the end -1
    num_blocks: torch.Tensor    # [] int32
    num_padded: torch.Tensor    # [] int32


def align_capacities(n: int, num_experts: int, block_size: int
                     ) -> tuple[int, int]:
    """Static worst-case output sizes: every expert padded by up to
    ``block_size - 1`` slots."""
    cap = n + num_experts * (block_size - 1)
    cap = (cap + block_size - 1) // block_size * block_size
    return cap, cap // block_size


def moe_align_block_size(expert_ids: torch.Tensor, num_experts: int,
                         block_size: int) -> AlignedBlocks:
    """The block-aligned expert sort of ``expert_ids`` (``[T, k]`` or
    ``[N]``): each expert's slots in ascending source order, its segment
    padded to a multiple of ``block_size`` with the sentinel ``N``, and
    the expert of every block (``-1`` past the last)."""
    flat = expert_ids.reshape(-1).to(torch.int64)
    n = flat.shape[0]
    dev = flat.device
    cap, bcap = align_capacities(n, num_experts, block_size)
    counts = torch.bincount(flat, minlength=num_experts)
    padded = (counts + block_size - 1) // block_size * block_size
    start = torch.cumsum(padded, 0) - padded
    order = torch.argsort(flat, stable=True)
    es = flat[order]
    first_sorted = torch.cumsum(counts, 0) - counts
    dest = start[es] + torch.arange(n, device=dev) - first_sorted[es]
    sorted_ids = torch.full((cap,), n, dtype=torch.int32, device=dev)
    sorted_ids[dest] = order.to(torch.int32)
    bounds = torch.cumsum(padded, 0) // block_size
    blk = torch.arange(bcap, device=dev)
    num_blocks = padded.sum() // block_size
    block_expert = torch.searchsorted(bounds, blk, right=True).to(
        torch.int32)
    block_expert = torch.where(blk < num_blocks, block_expert,
                               torch.full_like(block_expert, -1))
    return AlignedBlocks(sorted_ids=sorted_ids, block_expert=block_expert,
                         num_blocks=num_blocks.to(torch.int32),
                         num_padded=padded.sum().to(torch.int32))


def moe_combine(expert_out: torch.Tensor, sorted_tokens: SortedTokens,
                num_tokens: int) -> torch.Tensor:
    """Weighted scatter-add of the per-slot expert outputs ``[T*k, d]``
    back to token order, in f32, rounded to ``expert_out``'s dtype:
    ``[T, d]``."""
    weighted = (expert_out.to(torch.float32)
                * sorted_tokens.weights[:, None])
    out = torch.zeros((num_tokens, expert_out.shape[1]), dtype=torch.float32,
                      device=expert_out.device)
    out.index_add_(0, sorted_tokens.token_ids.long(), weighted)
    return out.to(expert_out.dtype)
