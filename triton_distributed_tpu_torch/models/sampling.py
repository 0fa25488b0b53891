"""Token sampling: greedy, temperature, top-k, top-p nucleus.

Counterpart of ``triton_distributed_tpu/models/sampling.py``: ``filter_logits``
is the one definition of the post-processing chain (temperature, top-k,
top-p); ``sample`` draws a categorical over it and ``target_probs``
gives the same distribution as probabilities (the speculative
verifier scores drafts against exactly what ``sample`` draws from).
``jax.random`` keys become ``torch.Generator``s, so a sampled draw does
not reproduce the JAX package's bits for the same seed.

The megakernel samples in-kernel by the Gumbel-max trick: the argmax of
``logits + T·gumbel`` is a draw of ``softmax(logits / T)``.
:func:`gumbel` makes that noise, and :func:`filtered_winner_plain` is
the plain version of the kernel's top-k/top-p branch (the JAX kernel's
``_filtered_winner``): the exact keep-set of ``filter_logits`` found by
two 64-step bisections on monotone counts, then the noisy argmax.
"""

from __future__ import annotations

import torch

# Pad columns' score in the filtered winner (the JAX kernel's NEGF).
NEGF = -3.0e38
_MASK64 = (1 << 64) - 1


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


def target_probs(
    logits: torch.Tensor,
    temperature: float = 1.0,
    top_p: float = 1.0,
    top_k: int = 0,
) -> torch.Tensor:
    """The exact distribution :func:`sample` draws from, as probabilities
    ``[..., V]`` f32. ``temperature <= 0`` → one-hot at the argmax."""
    if temperature <= 0.0:
        return torch.nn.functional.one_hot(
            torch.argmax(logits, dim=-1), logits.shape[-1]).to(torch.float32)
    return torch.softmax(filter_logits(logits, temperature, top_p, top_k),
                         dim=-1)


def gumbel(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` f32, ``u`` uniform from
    ``generator`` clamped below at the smallest normal f32, as
    ``jax.random.gumbel`` draws it: every value is finite."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def mix64(seed: int, step: int) -> int:
    """A splitmix64 finalizer over ``(seed, step)``: the seed of a
    request's ``step``-th sampled draw. A draw is then a pure function of
    the request's seed and its draw counter, whatever else shares the
    batch (the JAX ``fold_in(key, key_step)`` property)."""
    z = (int(seed) + (int(step) + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def sampcfg_row(temperature: float, top_p: float, top_k: int,
                vocab: int) -> list[float]:
    """One row of the megakernel's ``sampcfg [B, 4]``: ``[1/T, top-k
    window, top-p, enable]``. The window is ``k`` when ``0 < k < V`` and
    ``V`` otherwise, p is clamped to ``[1e-6, 1]`` (so the top-p
    bisection starts with ``H(hi) = 0 < p·Z``), and ``enable`` is set
    exactly when ``filter_logits`` would filter: ``T > 0`` and top-k or
    top-p applies. A greedy row is inert: ``[1, V, 1, 0]``."""
    t, p, k = float(temperature), float(top_p), int(top_k)
    en = t > 0.0 and (0 < k < vocab or p < 1.0)
    return [1.0 / t if t > 0.0 else 1.0,
            float(k) if 0 < k < vocab else float(vocab),
            min(max(p, 1e-6), 1.0), 1.0 if en else 0.0]


def filtered_winner_plain(logits: torch.Tensor, noise: torch.Tensor,
                          sampcfg: torch.Tensor, v_real: int) -> torch.Tensor:
    """The megakernel's filtered winner, in torch ops: for each row of
    ``logits [B, Vp]`` f32 the argmax of ``logits + noise`` over the
    keep-set of ``filter_logits`` (first occurrence on ties), ``[B]``
    int64. ``sampcfg [B, 4]`` rows are ``[1/T, k, p, enable]``
    (:func:`sampcfg_row`); columns at or past ``v_real`` are padding.

    Both filters are threshold rules, found by bisection instead of a
    sort, in the scaled domain ``ls = logits · (1/T)`` (pad columns at
    ``NEGF``): top-k keeps ``ls > lo_k`` where 64 halvings of
    ``count(ls > t) >= k`` bracket the k-th largest value (ties
    survive); over those survivors, with ``w = exp(ls - max)`` and ``Z =
    sum w``, top-p keeps ``ls > lo_p`` where 64 halvings of ``sum(w; ls >
    t) >= p·Z`` bracket the nucleus cutoff. Rows with ``enable = 0``
    keep every real column."""
    lg = logits.to(torch.float32)
    cols = torch.arange(lg.shape[-1], device=lg.device)
    real = cols[None, :] < v_real
    cfg = sampcfg.to(torch.float32)
    inv_t, kk, pp = cfg[:, 0:1], cfg[:, 1:2], cfg[:, 2:3]
    en = cfg[:, 3:4] > 0.0
    neg = torch.tensor(NEGF, dtype=torch.float32, device=lg.device)
    ls = torch.where(real, lg * inv_t, neg)
    mx = ls.max(dim=-1, keepdim=True).values
    mn = torch.where(real, ls, -neg).min(dim=-1, keepdim=True).values

    def bisect(count_ge):
        # Invariant: count_ge(lo) holds, count_ge(hi) does not.
        lo, hi = mn - 1.0, mx
        for _ in range(64):
            mid = 0.5 * (lo + hi)
            take = count_ge(mid)
            lo, hi = torch.where(take, mid, lo), torch.where(take, hi, mid)
        return lo

    zero = torch.zeros((), dtype=torch.float32, device=lg.device)
    lo_k = bisect(lambda t: (ls > t).to(torch.float32).sum(
        dim=-1, keepdim=True) >= kk)
    tk = ls > lo_k
    w = torch.where(tk, torch.exp(ls - mx), zero)
    z = w.sum(dim=-1, keepdim=True)
    lo_p = bisect(lambda t: torch.where(ls > t, w, zero).sum(
        dim=-1, keepdim=True) >= pp * z)
    keep = torch.where(en, tk & (ls > lo_p), real)
    score = torch.where(keep, lg + noise.to(torch.float32), neg)
    best = score.max(dim=-1, keepdim=True).values
    return torch.where(score == best, cols[None, :],
                       lg.shape[-1]).min(dim=-1).values

