"""Self-drafting speculative decoding: n-gram chains and draft trees.

Counterpart of ``triton_distributed_tpu/models/speculative.py``. A slot
drafts K tokens from its own history (``NGramDraft``, prompt lookup),
scores all of them in ONE chunked paged-prefill forward
(``Qwen3.prefill_paged_chunk(all_logits=True)``), accepts a prefix, and
the caller rolls the KV back past the first rejection. One target step
then emits ``accepted + 1`` tokens. Greedy (``temperature <= 0``):
accept while the draft equals the target's argmax, so the output is
exactly that of plain greedy decode. Sampled: ``verify_sampled`` accepts
a drafted token with its probability under the filtered target
distribution and otherwise draws from the residual, and
``verify_tree_sampled`` samples the target first and then matches it
against the drafted children; either way each emitted token's law is
that of plain sampled decode.

Tree speculation: when the radix tree remembers SEVERAL continuations of
the slot's history, ``TreeDraft`` stacks them into a token trie verified
in the same single forward. An additive ancestor mask keeps sibling
branches out of each other's softmax (the ``flash_attention_bias``
kernel on the card) and each node ropes at ``kv + depth``, so an accepted
branch's K/V rows equal the rows linear decode would write and the
commit is a row-move (``paged_kv_cache.move_kv_rows``).

``jax.random`` keys become ``torch.Generator``s: a linear verify draws
from the one generator it is given, a tree verify asks ``next_gen()`` for
one per emitted token (the continuous engine hands out per-request
generators, see ``ContinuousEngine._req_gen``). Each verify fetches the
per-position argmax and the all-finite flag in one device-to-host copy;
the ``[C, V]`` logits stay on the device (a sampled verify also fetches
the draft tokens' probabilities and, on a rejection, one probability
row). The JAX module's fault seams and trace spans are not ported
(ROADMAP queue 1, item 6).
"""

from __future__ import annotations

import numpy as np
import torch

from triton_distributed_tpu_torch.models import sampling
from triton_distributed_tpu_torch.models.paged_kv_cache import (
    gather_bucket,
    move_kv_rows,
)
from triton_distributed_tpu_torch.models.prefix_cache import round_chunk
from triton_distributed_tpu_torch.obs import events as obs_events


class NGramDraft:
    """Prompt-lookup drafter: an n-gram table over one request's token
    history (prompt + every emitted token). For each n in ``[min_ngram,
    max_ngram]`` the table maps every n-gram to its two most recent end
    positions; drafting takes the history's tail n-gram (longest n
    first), finds its PREVIOUS occurrence and proposes what followed."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"[{min_ngram}, {max_ngram}]"
            )
        self.history: list[int] = []
        # n → {ngram tuple: (latest end pos, previous end pos | None)}
        self._index: dict[int, dict] = {
            n: {} for n in range(min_ngram, max_ngram + 1)
        }

    def observe(self, tokens) -> None:
        """Append ``tokens`` to the history, updating every n-gram's
        latest/previous occurrence."""
        for t in tokens:
            self.history.append(int(t))
            end = len(self.history)
            for n, idx in self._index.items():
                if end >= n:
                    key = tuple(self.history[end - n:end])
                    prev = idx.get(key)
                    idx[key] = (end, prev[0] if prev is not None else None)

    def propose(self, k: int) -> list[int]:
        """Up to ``k`` draft tokens continuing the history's tail, from
        the longest n-gram with a previous occurrence; ``[]`` when
        nothing matches."""
        end = len(self.history)
        if k <= 0 or end == 0:
            return []
        for n in sorted(self._index, reverse=True):
            if end < n:
                continue
            entry = self._index[n].get(tuple(self.history[end - n:end]))
            if entry is None:
                continue
            # The latest occurrence IS the tail; the previous one (if
            # any) carries the continuation.
            pos = entry[1] if entry[0] == end else entry[0]
            if pos is None:
                continue
            cont = self.history[pos:pos + k]
            if cont:
                return list(cont)
        return []


class SpecState:
    """Per-slot speculative state: the drafter, the adaptive draft length
    K, the tree width and the propose/accept counters.

    A fully accepted draft grows K by 2; a rejection resets K to
    ``accepted + 1`` (floored at ``k_min``). Tree rounds
    (:meth:`record_tree`) also move the width: a full-depth accept widens
    the next tree by one branch (up to ``w_max``), a zero-accept round
    narrows it by one, and at width 1 the slot drafts linear chains."""

    def __init__(self, k_max: int, *, k_min: int = 1, max_ngram: int = 3,
                 min_ngram: int = 1, w_max: int = 1):
        self.k_max = max(int(k_max), 1)
        self.k_min = max(min(int(k_min), self.k_max), 1)
        self.k = self.k_max
        self.w_max = max(int(w_max), 1)
        self.width = self.w_max
        self.draft = NGramDraft(max_ngram, min_ngram)
        self.proposed = 0
        self.accepted = 0

    def observe(self, tokens) -> None:
        self.draft.observe(tokens)

    def propose(self, budget: int) -> list[int]:
        """Draft up to ``min(current K, budget)`` tokens."""
        return self.draft.propose(min(self.k, int(budget)))

    def record(self, proposed: int, accepted: int) -> None:
        """Fold one linear verify's outcome into the counters and K."""
        self.proposed += proposed
        self.accepted += accepted
        if proposed:
            if accepted == proposed:
                self.k = min(self.k + 2, self.k_max)
            else:
                self.k = min(max(accepted + 1, self.k_min), self.k_max)

    def record_tree(self, nodes: int, depth: int, accepted: int) -> None:
        """Fold one TREE verify: ``nodes`` drafted trie nodes (root
        excluded), ``depth`` the deepest drafted path, ``accepted`` the
        accepted path length."""
        self.proposed += nodes
        self.accepted += accepted
        if nodes:
            if depth and accepted >= depth:
                self.k = min(self.k + 2, self.k_max)
                self.width = min(self.width + 1, self.w_max)
            else:
                self.k = min(max(accepted + 1, self.k_min), self.k_max)
                if accepted == 0:
                    self.width = max(self.width - 1, 1)

    @property
    def accept_rate(self) -> float:
        return self.accepted / max(self.proposed, 1)


def cap_draft(k: int, kv_len: int, budget: int, max_length: int) -> int:
    """Largest usable draft length this step: at most ``k``, at most
    ``budget - 1`` (a verify emits up to ``draft + 1`` tokens), and small
    enough that the PADDED chunk (``round_chunk(draft + 1)``, whose pad
    rows write KV too) stays under ``max_length``. ``-1`` when not even a
    zero-draft chunk fits (the slot must take a plain decode step)."""
    k = min(int(k), int(budget) - 1)
    while k >= 0 and int(kv_len) + round_chunk(k + 1) > int(max_length):
        k -= 1
    return k


def verify_greedy(preds, draft: list[int]) -> tuple[int, int]:
    """Greedy acceptance: ``preds [n+1]`` are the target's argmax tokens
    at the inputs ``[pending, d_1..d_n]``. Accept ``d_i`` while it equals
    the argmax at its position; the token at the first mismatch (or the
    bonus token after a full accept) is the target's own. Returns
    ``(accepted, next_token)``."""
    a = 0
    while a < len(draft) and int(preds[a]) == int(draft[a]):
        a += 1
    return a, int(preds[a])


def _uniform(generator: torch.Generator, n: int = 1,
             dtype=torch.float32) -> torch.Tensor:
    """``n`` uniform draws in [0, 1) from ``generator``, on its device."""
    return torch.rand(n, generator=generator, device=generator.device,
                      dtype=dtype)


def verify_sampled(logits: torch.Tensor, draft: list[int],
                   generator: torch.Generator, temperature: float,
                   top_p: float = 1.0, top_k: int = 0) -> tuple[int, int]:
    """Distribution-preserving acceptance for ``temperature > 0`` over the
    target's ``logits [n+1, V]`` at the inputs ``[pending, d_1..d_n]``.

    With a deterministic (delta) draft the rejection-sampling rule is:
    accept ``d_i`` with probability ``p_i(d_i)`` under the filtered target
    distribution; on the first rejection emit a draw of the residual
    ``p_i`` with ``d_i`` zeroed and renormalized (float64, on the host);
    after a full accept, a bonus draw of ``p_n``. Each emitted token's
    marginal is exactly ``p_i``. The accept draws come from ``generator``
    first (one per drafted token, in one call), then the residual's or
    the bonus's. Returns ``(accepted, next_token)``."""
    n = len(draft)
    if n:
        probs = sampling.target_probs(logits[:n], temperature, top_p, top_k)
        idx = torch.arange(n, device=logits.device)
        pd = probs[idx, torch.as_tensor(draft, device=logits.device)]
        both = torch.stack([_uniform(generator, n).to(pd.device), pd])
        u, pd = both.cpu().numpy()
        for i, d in enumerate(draft):
            if u[i] < pd[i]:
                continue
            resid = probs[i].cpu().numpy().astype(np.float64)
            resid[int(d)] = 0.0
            total = resid.sum()
            if total <= 0.0:
                # p(d) was numerically 1 yet the draw rejected: the target
                # IS d's one-hot, so draw it directly.
                return i, int(sampling.sample(logits[i], generator,
                                              temperature, top_p, top_k))
            cum = np.cumsum(resid / total)
            r = float(_uniform(generator, dtype=torch.float64)[0])
            nxt = min(int(np.searchsorted(cum, r * cum[-1], side="right")),
                      len(cum) - 1)
            while resid[nxt] <= 0.0:  # never a zero-mass token
                nxt -= 1
            return i, nxt
    return n, int(sampling.sample(logits[n], generator, temperature, top_p,
                                  top_k))


def verify_tree_sampled(logits: torch.Tensor, tree: "TreeDraft", next_gen,
                        temperature: float, top_p: float = 1.0,
                        top_k: int = 0) -> tuple[list[int], list[int]]:
    """Distribution-preserving tree acceptance: sample, then match. At
    each node the target token is drawn first (``sampling.sample`` under
    the node's filtered distribution, one generator from ``next_gen()``
    per emitted token: the draws of plain sampled decode) and the walk
    descends into the drafted child carrying it, if any. The emitted
    stream's law is that of plain sampled decode, whatever the tree's
    shape. Returns ``(path, emitted)`` as :func:`verify_tree_greedy`."""
    path: list[int] = []
    emitted: list[int] = []
    cur = 0
    while True:
        t = int(sampling.sample(logits[cur], next_gen(), temperature, top_p,
                                top_k))
        emitted.append(t)
        nxt = tree.child(cur, t)
        if nxt is None:
            return path, emitted
        path.append(nxt)
        cur = nxt


def _greedy_rows(logits: torch.Tensor, n: int):
    """Argmax of the first ``n`` logit rows and whether they are all
    finite, fetched to the host in one copy. ``torch.argmax`` takes the
    first maximal index on ties, as ``np.argmax`` does."""
    rows = logits[:n]
    both = torch.cat([torch.isfinite(rows).all(dim=-1).long(),
                      torch.argmax(rows, dim=-1)]).cpu().numpy()
    return both[n:], bool(both[:n].all())


def _verify_chunk(model, cache, slot: int, tokens: list[int], kv_len: int,
                  mode, **tree):
    """Run ``tokens`` (padded to ``round_chunk``) through one chunk
    forward at ``kv_len`` with per-position logits. The chunk writes KV
    for every row and sets the slot's kv_len to ``kv_len + n``. Returns
    ``(preds [n] or None if non-finite, logits [n, V] on the device,
    cache)``."""
    n = len(tokens)
    c = round_chunk(n)
    page = int(cache.k_pages.shape[3])
    pps = int(cache.page_table.shape[1])
    buf = np.zeros(c, np.int32)
    buf[:n] = tokens
    logits, cache = model.prefill_paged_chunk(
        buf, slot, int(kv_len), int(kv_len) + n, n - 1, cache, mode,
        kv_pages=gather_bucket(int(kv_len) + c, page, pps), all_logits=True,
        **{k: v(c) for k, v in tree.items()},
    )
    preds, finite = _greedy_rows(logits, n)
    return (preds if finite else None), logits[:n], cache


def spec_verify_slot(model, cache, slot: int, pending: int, draft: list[int],
                     kv_len: int, mode, *, generator=None,
                     temperature: float = 0.0, top_p: float = 1.0,
                     top_k: int = 0):
    """One linear verify of ``slot``: ``[pending] + draft`` through a
    single chunk forward, greedy acceptance, or with ``temperature > 0``
    :func:`verify_sampled` drawing from ``generator``. Returns
    ``(emitted, cache, accepted)``; ``emitted`` is ``draft[:accepted]``
    plus one token from the target's own distribution, or None when the
    chunk's logits were not finite (the caller fails the slot's request
    as ``nan_logits``). The CALLER owns the rollback to ``kv_len +
    accepted + 1``."""
    preds, logits, cache = _verify_chunk(
        model, cache, slot, [int(pending)] + [int(d) for d in draft], kv_len,
        mode,
    )
    if preds is None:
        return None, cache, 0
    if temperature <= 0.0:
        accepted, nxt = verify_greedy(preds, draft)
    else:
        accepted, nxt = verify_sampled(logits, draft, generator, temperature,
                                       top_p, top_k)
    obs_events.emit("spec_verify", slot=slot, drafted=len(draft),
                    accepted=accepted)
    return [int(d) for d in draft[:accepted]] + [nxt], cache, accepted


class TreeDraft:
    """A multi-branch draft: a token trie rooted at the slot's pending
    token, flattened in insertion (DFS) order for one verify chunk.

    Node 0 is the ROOT, the pending token; nodes ``1..n-1`` are drafted
    continuations. Children are appended after their parent, so a node's
    storage index is always >= its depth: the commit's row-moves are all
    leftward (``dst <= src``)."""

    def __init__(self, pending: int):
        self.tokens: list[int] = [int(pending)]
        self.parent: list[int] = [-1]
        self.depth: list[int] = [0]
        self._children: list[dict[int, int]] = [{}]

    def __len__(self) -> int:
        return len(self.tokens)

    @property
    def num_drafted(self) -> int:
        return len(self.tokens) - 1

    @property
    def max_depth(self) -> int:
        return max(self.depth)

    @property
    def is_chain(self) -> bool:
        """True when the trie is a single path: it behaves exactly like a
        linear draft."""
        return all(len(c) <= 1 for c in self._children)

    def chain_tokens(self) -> list[int]:
        """The drafted tokens of a single-path trie, root excluded."""
        return [int(t) for t in self.tokens[1:]]

    def child(self, node: int, token: int) -> int | None:
        return self._children[node].get(int(token))

    def add_path(self, path, budget: int | None = None) -> int:
        """Insert one candidate continuation below the root, sharing any
        already-inserted prefix; stop growing at ``budget`` total nodes.
        Returns the nodes added."""
        cur = 0
        added = 0
        for t in path:
            t = int(t)
            nxt = self._children[cur].get(t)
            if nxt is None:
                if budget is not None and len(self.tokens) >= budget:
                    break
                nxt = len(self.tokens)
                self.tokens.append(t)
                self.parent.append(cur)
                self.depth.append(self.depth[cur] + 1)
                self._children.append({})
                self._children[cur][t] = nxt
                added += 1
            cur = nxt
        return added

    def mask(self, c: int) -> np.ndarray:
        """The ``[c, c]`` additive attention bias of a ``c``-row chunk:
        row ``i`` sees column ``j`` (0) iff ``j`` is an ancestor of or
        equal to ``i``, else -1e30. Pad rows ``i >= n`` get plain causal
        rows. Columns outside the chunk (the committed prefix) are the
        model's to extend with zeros."""
        n = len(self.tokens)
        m = np.full((c, c), -1e30, np.float32)
        for i in range(n):
            j = i
            while j >= 0:
                m[i, j] = 0.0
                j = self.parent[j]
        for i in range(n, c):
            m[i, : i + 1] = 0.0
        return m

    def depths(self, c: int) -> np.ndarray:
        """Per-row rope depth of a ``c``-row chunk: node ``i`` ropes at
        ``kv + depth[i]``, pad rows at their storage index."""
        n = len(self.tokens)
        return np.asarray(self.depth + list(range(n, c)), np.int32)


def verify_tree_greedy(preds, tree: TreeDraft) -> tuple[list[int], list[int]]:
    """Greedy tree acceptance over ``preds`` (the target's argmax at each
    node): from the root, take the argmax and descend into the drafted
    child carrying it, if any. Returns ``(path, emitted)``: the accepted
    node indices root-down (root excluded) and their tokens plus the
    final correction/bonus token."""
    path: list[int] = []
    emitted: list[int] = []
    cur = 0
    while True:
        t = int(preds[cur])
        emitted.append(t)
        nxt = tree.child(cur, t)
        if nxt is None:
            return path, emitted
        path.append(nxt)
        cur = nxt


def spec_verify_tree(model, cache, slot: int, tree: TreeDraft, kv_len: int,
                     mode, *, next_gen=None, temperature: float = 0.0,
                     top_p: float = 1.0, top_k: int = 0):
    """One TREE verify of ``slot``: every trie node through a single
    chunk forward under the ancestor mask and depth rope, then the greedy
    walk, or with ``temperature > 0`` the sample-then-match walk
    (:func:`verify_tree_sampled`, one generator from ``next_gen()`` per
    emitted token). Returns ``(emitted, cache, path)``; ``emitted`` is
    None on non-finite logits. The chunk writes every node's KV at ``kv +
    i``; the CALLER commits the path (:func:`commit_tree_path`) and rolls
    kv_len back to ``kv + len(path) + 1``."""
    preds, logits, cache = _verify_chunk(
        model, cache, slot, tree.tokens, kv_len, mode, tree_mask=tree.mask,
        tree_depth=tree.depths)
    if preds is None:
        return None, cache, []
    if temperature <= 0.0:
        path, emitted = verify_tree_greedy(preds, tree)
    else:
        path, emitted = verify_tree_sampled(logits, tree, next_gen,
                                            temperature, top_p, top_k)
    obs_events.emit("spec_verify", slot=slot, drafted=tree.num_drafted,
                    accepted=len(path), tree=True)
    return emitted, cache, path


def commit_tree_path(cache, slot: int, kv_len: int, path: list[int]):
    """Commit an accepted root path: move its nodes' KV rows from their
    storage positions ``kv + node`` to ``kv+1 .. kv+len(path)``. A
    primary-branch accept is already in place and moves nothing."""
    src = [int(kv_len) + int(i) for i in path]
    dst = [int(kv_len) + j for j in range(1, len(path) + 1)]
    return move_kv_rows(cache, slot, src, dst)
