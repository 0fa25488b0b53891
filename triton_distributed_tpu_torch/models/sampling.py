"""Token sampling: greedy, temperature, top-k, top-p nucleus.

Counterpart of ``triton_distributed_tpu/models/sampling.py``. ``jax.random``
keys become ``torch.Generator``s, so a sampled draw does not reproduce
the JAX package's bits for the same seed; the serving engines of this
slice are greedy only.
"""

from __future__ import annotations

import torch


class NonFiniteLogitsError(RuntimeError):
    """The model produced NaN/Inf logits. Raised by the serving-path
    guards so engines map it to a structured ``nan_logits`` request
    failure instead of silently argmax-ing garbage; ``slot`` (when set)
    attributes it."""

    def __init__(self, msg: str, slot: int | None = None):
        super().__init__(msg)
        self.slot = slot


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """``logits [..., V]`` → token ids ``[...]`` (first maximum on ties)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def filter_logits(
    logits: torch.Tensor,
    temperature: float = 1.0,
    top_p: float = 1.0,
    top_k: int = 0,
) -> torch.Tensor:
    """Temperature-scale then mask ``logits [..., V]`` to the sampled
    support: tokens outside the top-k / nucleus go to ``-inf``.
    ``top_k=0`` disables the top-k filter; ties at the k-th value all
    survive. Requires ``temperature > 0``."""
    logits = logits.to(torch.float32) / temperature
    v = logits.shape[-1]
    neg = torch.tensor(float("-inf"), device=logits.device)
    if top_k and 0 < top_k < v:
        kth = torch.sort(logits, dim=-1).values[..., v - top_k, None]
        logits = torch.where(logits >= kth, logits, neg)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # Keep the smallest prefix with cumulative prob >= top_p (always
        # keep the top token).
        keep = cum - probs < top_p
        cutoff = torch.amin(
            torch.where(keep, sorted_logits, torch.full_like(
                sorted_logits, float("inf"))),
            dim=-1, keepdim=True,
        )
        logits = torch.where(logits >= cutoff, logits, neg)
    return logits


def sample(
    logits: torch.Tensor,
    generator: torch.Generator | None,
    temperature: float = 1.0,
    top_p: float = 1.0,
    top_k: int = 0,
) -> torch.Tensor:
    """Temperature + top-k + nucleus sampling from ``generator``.
    ``temperature <= 0`` → greedy."""
    if temperature <= 0.0:
        return greedy(logits)
    probs = torch.softmax(filter_logits(logits, temperature, top_p, top_k),
                          dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    toks = torch.multinomial(flat, 1, generator=generator)[:, 0]
    return toks.reshape(probs.shape[:-1]).to(torch.int32)
