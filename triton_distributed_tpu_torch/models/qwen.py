"""Qwen3 (dense), over one or more co-located ranks.

Counterpart of ``triton_distributed_tpu/models/qwen.py``: the same
forward (embed → per layer [RMSNorm → attention → residual → RMSNorm →
SwiGLU MLP → residual] → RMSNorm → LM head), the same parameter layout
and the same entry points: ``prefill_batched``,
``prefill_paged_chunk`` and ``decode_step`` over a dense
:class:`KVCache` or a :class:`PagedKVCache`, and the sharded long-context
slot's ``prefill_paged_chunk_cold`` and ``decode_step_sharded``. The JAX
``lax.scan`` over stacked layers is a Python loop over the layers; the jitted, donated
programs are eager calls that write the cache in place and return it.

Parameters are a dict mirroring the JAX ``Qwen3Params`` tree, leaves
stacked over layers: ``embed [V, d]``, ``layers.{ln1 [L, d], attn.{wqkv
[L, d, (hq+2hkv)hd], wo [L, hq*hd, d], q_norm [L, hd], k_norm [L, hd]},
ln2 [L, d], mlp.{w1 [L, d, 2ff], w2 [L, ff, d]}}``, ``norm [d]`` and
``lm_head [d, V_pad]`` (V padded to a multiple of 128 and sliced back
off by the logits).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from triton_distributed_tpu_torch.layers.tp_attn import (
    TPAttnDims,
    cold_mask,
    tp_attn_decode,
    tp_attn_decode_paged,
    tp_attn_decode_sharded,
    tp_attn_prefill,
    tp_attn_prefill_paged_chunk,
    tp_attn_prefill_paged_chunk_cold,
)
from triton_distributed_tpu_torch.layers.tp_mlp import check_mode, tp_mlp_fwd
from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.models.kv_cache import KVCache, init_cache
from triton_distributed_tpu_torch.models.paged_kv_cache import PagedKVCache
from triton_distributed_tpu_torch.runtime.mesh import (
    DistContext,
    resolve_device,
)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    xf = x.to(torch.float32)
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * w.to(torch.float32)).to(x.dtype)


def pad_vocab(v: int, n: int = 1) -> int:
    """Vocab width padded to a multiple of 128·tp (``qwen.py:73-80``), so
    each rank's LM-head shard has the JAX package's column split (Qwen3's
    151936 = 2^7·1187 leaves a 64/96/48 residue at tp=2/4/8)."""
    align = 128 * n
    return -(-v // align) * align


_LAYER_LEAVES = (
    ("ln1",), ("attn", "wqkv"), ("attn", "wo"), ("attn", "q_norm"),
    ("attn", "k_norm"), ("ln2",), ("mlp", "w1"), ("mlp", "w2"),
)


class Qwen3:
    """Dense Qwen3 over the ranks of a :class:`DistContext` (one rank by
    default). Runs on ``cuda`` unless ``device`` (or ``ctx``) says
    otherwise (``device="cpu"`` runs the kernels' plain versions).

    At tp=n (``ctx=initialize_distributed(tp=n)`` or ``tp=n``) each rank
    holds its own shards (``params`` is then the list of per-rank dicts
    :func:`shard_params` makes: ``wqkv`` ``[q_loc | k_loc | v_loc]``,
    ``w1`` ``[gate_loc | up_loc]``, ``wo``/``w2`` by rows, the LM head by
    columns of the vocab padded to 128·n, the norms and the embedding
    replicated) and its own copy of every replicated activation. Every
    entry point runs the per-rank work in a loop over ranks and crosses
    ranks through the collective seams of ``layers/``; modes ``pallas``
    (the hand-written kernels on the card) and ``xla`` (plain torch
    collectives)."""

    def __init__(self, cfg: ModelConfig, *, device=None, ctx=None,
                 tp: int | None = None):
        self.cfg = cfg
        if ctx is None:
            ctx = DistContext.create(device, cfg.dtype, tp or 1)
        elif ((device is not None and resolve_device(device) != ctx.device)
              or (tp is not None and tp != ctx.tp)):
            raise ValueError(f"device={device}, tp={tp} disagree with {ctx}")
        self.ctx = ctx
        self.device = ctx.device
        self.tp = n = ctx.tp
        _check_tp(cfg, n)
        self.dims = TPAttnDims(
            hq_loc=cfg.num_q_heads // n, hkv_loc=cfg.num_kv_heads // n,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
        )
        self.params: dict | list | None = None
        # Per rank, per layer views of the rank's parameters.
        self._rank_layers: list[list[dict]] = []
        self._layers: list[dict] = []

    # -- parameter construction ------------------------------------------
    def init_params(self, seed: int = 0):
        """Random init from a ``torch.Generator`` seeded with ``seed`` on
        the model's device; the same scales as the JAX ``init_params``
        (normal × fan_in^-1/2, embed × 0.02, norms 1). The global
        (tp=1-layout) weights are drawn and then sharded, so a tp=n model
        holds the shards of the tp=1 model of the same seed."""
        cfg = self.cfg
        hd, d, L = cfg.head_dim, cfg.hidden_size, cfg.num_layers
        dev, dt = self.device, cfg.dtype
        g = torch.Generator(device=dev).manual_seed(int(seed))

        def rnd(*shape, scale=None):
            scale = shape[-2] ** -0.5 if scale is None else scale
            w = torch.randn(shape, generator=g, device=dev,
                            dtype=torch.float32)
            return (w.mul_(scale)).to(dt)

        qkv = (cfg.num_q_heads + 2 * cfg.num_kv_heads) * hd
        params = {
            "embed": rnd(cfg.vocab_size, d, scale=0.02),
            "layers": {
                "ln1": torch.ones((L, d), dtype=dt, device=dev),
                "attn": {
                    "wqkv": rnd(L, d, qkv, scale=d**-0.5),
                    "wo": rnd(L, cfg.num_q_heads * hd, d),
                    "q_norm": torch.ones((L, hd), dtype=dt, device=dev),
                    "k_norm": torch.ones((L, hd), dtype=dt, device=dev),
                },
                "ln2": torch.ones((L, d), dtype=dt, device=dev),
                "mlp": {
                    "w1": rnd(L, d, 2 * cfg.intermediate_size, scale=d**-0.5),
                    "w2": rnd(L, cfg.intermediate_size, d),
                },
            },
            "norm": torch.ones((d,), dtype=dt, device=dev),
            "lm_head": rnd(d, cfg.vocab_size),
        }
        return self.set_params(params)

    def set_params(self, params):
        """Take the model's parameters: a tp=1-layout dict (sharded here
        at tp=n) or, at tp=n, the list of per-rank shards
        (:func:`shard_params`, :func:`params_from_jax` with ``tp=n``).
        Leaves move to the model's device and dtype, the LM head's vocab
        axis is padded to a multiple of 128·tp (zero columns, sliced off
        by the logits), and per-layer views are cached."""
        n = self.tp
        if isinstance(params, (list, tuple)):
            if len(params) != n:
                raise ValueError(f"{len(params)} shards for tp={n}")
            shards = list(params)
        elif n > 1:
            shards = shard_params(params, n, self.cfg)
        else:
            shards = [params]
        ranks = [self._rank_params(p) for p in shards]
        self.params = ranks[0] if n == 1 else ranks
        self._rank_layers = [
            [{
                "ln1": p["layers"]["ln1"][i], "ln2": p["layers"]["ln2"][i],
                "attn": {k: (None if w is None else w[i])
                         for k, w in p["layers"]["attn"].items()},
                "mlp": {k: w[i] for k, w in p["layers"]["mlp"].items()},
            } for i in range(self.cfg.num_layers)]
            for p in ranks
        ]
        self._layers = self._rank_layers[0]
        return self.params

    def _rank_params(self, params: dict) -> dict:
        """One rank's dict on the device, its LM head padded, every leaf
        contiguous (a row or column shard is a strided view of the tp=1
        leaf; the megakernel streams each weight as a dense array)."""
        def conv(t):
            return torch.as_tensor(t).to(self.device,
                                         self.cfg.dtype).contiguous()

        lp = params["layers"]
        layers = {
            "ln1": conv(lp["ln1"]), "ln2": conv(lp["ln2"]),
            "attn": {k: (None if lp["attn"].get(k) is None
                         else conv(lp["attn"][k]))
                     for k in ("wqkv", "wo", "q_norm", "k_norm")},
            "mlp": {k: conv(w) for k, w in lp["mlp"].items()},
        }
        lm_head = conv(params["lm_head"])
        v_loc = pad_vocab(self.cfg.vocab_size, self.tp) // self.tp
        if lm_head.shape[1] < v_loc:
            lm_head = F.pad(lm_head, (0, v_loc - lm_head.shape[1]))
        return {
            "embed": conv(params["embed"]), "layers": layers,
            "norm": conv(params["norm"]), "lm_head": lm_head,
        }

    @property
    def rank_params(self) -> list[dict]:
        """The per-rank parameter dicts (one at tp=1)."""
        return [self.params] if self.tp == 1 else self.params

    # -- forward pieces ----------------------------------------------------
    def _embed(self, tokens) -> list[torch.Tensor]:
        """Each rank's copy of the embedded ``tokens``."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        return [F.embedding(tokens, p["embed"]) for p in self.rank_params]

    def _norm(self, xs: list) -> list:
        eps = self.cfg.rms_eps
        return [rms_norm(x, p["norm"], eps)
                for x, p in zip(xs, self.rank_params)]

    def _logits(self, xs: list) -> torch.Tensor:
        """Each rank's ``[..., d]`` rows → f32 logits ``[..., V]``: every
        rank's partial logits over its vocab shard, concatenated over
        ranks (``qwen.py:229-236``), vocab padding sliced off. Each GEMM
        rounds to the model dtype before the f32 cast."""
        parts = [(x @ p["lm_head"]).to(torch.float32)
                 for x, p in zip(xs, self.rank_params)]
        full = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        return full[..., : self.cfg.vocab_size]

    def _mlp_fwd(self, mlp_params, h, mode: str):
        """The layer's MLP on the normed ``h`` (per-rank lists): the dense
        SwiGLU here, the routed experts in ``Qwen3MoE``."""
        return tp_mlp_fwd(mlp_params, h, mode=mode, ctx=self.ctx)

    def _block(self, xs: list, i: int, attn, mode: str) -> list:
        """Decoder layer ``i`` over per-rank activations, around
        ``attn(hs) -> per-rank attention outputs``."""
        eps = self.cfg.rms_eps
        lyrs = [layers[i] for layers in self._rank_layers]
        a = attn([rms_norm(x, ly["ln1"], eps) for x, ly in zip(xs, lyrs)])
        xs = [x + t for x, t in zip(xs, a)]
        m = self._mlp_fwd([ly["mlp"] for ly in lyrs],
                          [rms_norm(x, ly["ln2"], eps)
                           for x, ly in zip(xs, lyrs)], mode)
        return [x + t for x, t in zip(xs, m)]

    def _attn(self, i: int) -> list[dict]:
        return [layers[i]["attn"] for layers in self._rank_layers]

    # -- entry points --------------------------------------------------------
    def decode_step(self, tokens, cache, mode: str = "xla"):
        """One token for every sequence of the batch: ``tokens [B]`` →
        ``(logits [B, V] f32, cache)``. Accepts a dense :class:`KVCache`
        or a :class:`PagedKVCache` (full width or int8); K/V (and an int8
        pool's scales) are written in place and the returned cache
        carries ``kv_len + 1``. The o-proj and FC2 sum over ranks
        (``gemm_ar`` in mode ``pallas``)."""
        check_mode(mode)
        ar = "pallas_ar" if mode.startswith("pallas") else "xla_ar"
        paged = isinstance(cache, PagedKVCache)
        ranks = [cache.rank(r) for r in range(self.tp)]
        xs = self._embed(tokens)
        for i in range(self.cfg.num_layers):
            if paged:
                def attn(hs, i=i):
                    sc = [_layer_scales(c, i) for c in ranks]
                    return tp_attn_decode_paged(
                        self._attn(i), hs, [c.k_pages[i] for c in ranks],
                        [c.v_pages[i] for c in ranks], cache.page_table,
                        cache.kv_len, self.dims, mode=ar, ctx=self.ctx,
                        k_scale=_scale_list(sc, "k_scale"),
                        v_scale=_scale_list(sc, "v_scale"),
                    )[0]
            else:
                def attn(hs, i=i):
                    return tp_attn_decode(
                        self._attn(i), hs, [c.k[i] for c in ranks],
                        [c.v[i] for c in ranks], cache.kv_len, self.dims,
                        mode=ar, ctx=self.ctx,
                    )[0]
            xs = self._block(xs, i, attn, ar)
        return self._logits(self._norm(xs)), dataclasses.replace(
            cache, kv_len=cache.kv_len + 1
        )

    def prefill_batched(self, tokens, cache: KVCache, mode: str = "xla",
                        true_lens=None):
        """Prefill every row of ``tokens [B, S]`` into cache rows
        ``[0, B)`` at positions ``[0, S)``. ``true_lens[i]`` is row i's
        real length: positions past it are right-padding, inert under
        causal masking; logits come from position ``true_lens[i] - 1``
        and ``kv_len[i]`` is set to ``true_lens[i]``. Returns
        ``(logits [B, V], cache)``.

        At tp=n the activations are sequence-sharded (``S`` divisible by
        n; the engines right-pad): QKV and FC1 through ``ag_gemm``, the
        o-proj and FC2 through ``gemm_rs`` in mode ``pallas``; the last
        real row is picked from the rank that holds it
        (``qwen.py:349-354``)."""
        check_mode(mode)
        seq = "pallas" if mode.startswith("pallas") else "xla"
        n = self.tp
        tokens = torch.as_tensor(tokens, device=self.device)
        b, s = tokens.shape
        if s % n:
            raise ValueError(f"prompt width {s} not divisible by tp={n}; "
                             "right-pad it and pass true_lens")
        s_loc = s // n
        lens = [s] * b if true_lens is None else [
            int(t) for t in np.asarray(true_lens).reshape(-1)
        ]
        ranks = [cache.rank(r) for r in range(n)]
        logits = []
        for row in range(b):
            xs = [t[r * s_loc:(r + 1) * s_loc]
                  for r, t in enumerate(self._embed(tokens[row]))]
            for i in range(self.cfg.num_layers):
                def attn(hs, i=i, row=row):
                    out, k, v = tp_attn_prefill(self._attn(i), hs, self.dims,
                                                mode=seq, ctx=self.ctx)
                    for c, kr, vr in zip(ranks, k, v):
                        c.k[i, row, :, :s] = kr.to(c.k.dtype)
                        c.v[i, row, :, :s] = vr.to(c.v.dtype)
                    return out
                xs = self._block(xs, i, attn, seq)
            xs = self._norm(xs)
            last = lens[row] - 1
            own = xs[last // s_loc][last % s_loc: last % s_loc + 1]
            logits.append(self._logits([own] * n)[0])
        cache.kv_len[:b] = torch.as_tensor(lens, dtype=torch.int32)
        return torch.stack(logits), cache

    def prefill_paged_chunk(
        self,
        tokens,           # [C] int32 — one (padded) suffix chunk
        slot: int,
        q_offset: int,
        new_len: int,
        last_idx: int,
        cache: PagedKVCache,
        mode: str = "xla",
        kv_pages: int | None = None,
        all_logits: bool = False,
        tree_mask=None,   # [C, C] f32 — 0 visible / -1e30 masked
        tree_depth=None,  # [C] int — per-node depth below q_offset
    ):
        """Chunked prefill of ``slot``'s suffix over the paged pool: the
        matched prefix pages are attended, only the chunk is computed.
        ``new_len`` is set absolutely as the slot's kv_len (decode steps
        may run between chunks); on an int8 pool it is also the end of
        the chunk's real rows (``q_end``), past which rows are padding.
        Returns ``(logits [V] at last_idx, cache)``, or per-position
        logits ``[C, V]`` with ``all_logits=True`` (a speculative verify
        scores every chunk position; they stay on the device). At tp=n
        the chunk is replicated, each rank attending over its pool shard,
        and the o-proj and FC2 sum over ranks (``gemm_ar`` in mode
        ``pallas``).

        ``tree_mask``/``tree_depth`` (passed together) run the chunk as a
        speculative draft TREE: rows are trie nodes in DFS storage order,
        ``tree_mask[i, j]`` is 0 where node j is an ancestor-or-self of
        node i and -1e30 otherwise, and node i ropes at ``q_offset +
        tree_depth[i]`` while its KV scatters at ``q_offset + i``. The
        mask expands to the gathered view's ``[C, S_kv]`` bias once here
        (prefix columns visible, columns past the chunk left to
        causality) and every layer shares it."""
        check_mode(mode)
        ar = "pallas_ar" if mode.startswith("pallas") else "xla_ar"
        if (tree_mask is None) != (tree_depth is None):
            raise ValueError("tree_mask and tree_depth go together")
        q_offset = int(q_offset)
        table_row = cache.page_table[int(slot)]
        ranks = [cache.rank(r) for r in range(self.tp)]
        xs = self._embed(np.asarray(tokens))
        tree = {}
        if tree_mask is not None:
            page = cache.page_size
            s_kv = (table_row.shape[0] if kv_pages is None else kv_pages) * page
            depth = torch.as_tensor(np.asarray(tree_depth, np.int64))
            tree = {"attn_bias": expand_tree_mask(tree_mask, q_offset, s_kv,
                                                  self.device),
                    "rope_pos": (q_offset + depth).to(self.device)}
        for i in range(self.cfg.num_layers):
            def attn(hs, i=i):
                sc = [_layer_scales(c, i) for c in ranks]
                return tp_attn_prefill_paged_chunk(
                    self._attn(i), hs, [c.k_pages[i] for c in ranks],
                    [c.v_pages[i] for c in ranks], table_row, q_offset,
                    self.dims, kv_pages=kv_pages, mode=ar, ctx=self.ctx,
                    q_end=int(new_len), k_scale=_scale_list(sc, "k_scale"),
                    v_scale=_scale_list(sc, "v_scale"), **tree,
                )[0]
            xs = self._block(xs, i, attn, ar)
        xs = self._norm(xs)
        if all_logits:
            logits = self._logits(xs)
        else:
            last = int(last_idx)
            logits = self._logits([x[last: last + 1] for x in xs])[0]
        kv_len = cache.kv_len.clone()
        kv_len[int(slot)] = int(new_len)
        return logits, dataclasses.replace(cache, kv_len=kv_len)

    # -- sharded long-context slots (tp=1) -----------------------------------
    #
    # A slot whose KV exceeds the per-rank page budget splits into a
    # RESIDENT paged window (local positions, its own explicit
    # ``table_row``: the slot's pages are not in the batched table) and a
    # COLD dense window of tier-demoted pages (pool dtype + per-page
    # scales, read-only, ``[L, Hkv, S_bucket, hd]``). Both forwards merge
    # the two attention partials with ``lse_combine``; neither touches the
    # batched ``kv_len``/``page_table``.

    def _tp1_only(self, what: str) -> None:
        if self.tp != 1:
            raise NotImplementedError(
                f"{what} at tp>1 is not ported yet (ROADMAP queue 1, "
                "item 11)")

    def prefill_paged_chunk_cold(
        self,
        tokens,          # [C] int32 — one (padded) chunk
        table_row,       # [budget_pages] int32 — the slot's resident row
        q_offset: int,   # absolute chunk start
        q_end: int,      # absolute end of the REAL rows
        last_idx: int,
        cache: PagedKVCache,
        k_cold, v_cold,  # [L, Hkv, S_bucket, hd] pool-dtype cold window
        ks_cold=None, vs_cold=None,  # [L, Hkv, S_bucket/page] f32
        s_cold: int = 0,             # valid cold tokens (<= S_bucket)
        mode: str = "xla",
    ):
        """Chunk-prefill a sharded slot: K/V rows land at LOCAL resident
        positions through ``table_row`` (written in place) and every
        layer's attention adds the cold-window partial. Returns
        ``(logits [V] at last_idx, cache)``."""
        check_mode(mode)
        self._tp1_only("prefill_paged_chunk_cold")
        table_row = torch.as_tensor(np.asarray(table_row, np.int32)).to(
            self.device)
        (x,) = self._embed(np.asarray(tokens))
        bias = cold_mask(x.shape[0], k_cold.shape[2], s_cold, self.device)
        for i in range(self.cfg.num_layers):
            def attn(hs, i=i):
                return [tp_attn_prefill_paged_chunk_cold(
                    self._layers[i]["attn"], hs[0], cache.k_pages[i],
                    cache.v_pages[i], table_row, k_cold[i], v_cold[i],
                    s_cold, q_offset, self.dims, q_end=int(q_end),
                    cold_bias=bias, **_layer_scales(cache, i),
                    **_cold_scales(ks_cold, vs_cold, i),
                )[0]]
            (x,) = self._block([x], i, attn, mode)
        (x,) = self._norm([x])
        last = int(last_idx)
        return self._logits([x[last: last + 1]])[0], cache

    def decode_step_sharded(
        self,
        token,           # [1] int32 — the slot's new token
        cache: PagedKVCache,
        table_row,       # [budget_pages] int32
        kv_len_loc: int,  # tokens in the resident region
        k_cold, v_cold,  # [L, Hkv, S_bucket, hd] pool-dtype cold window
        ks_cold=None, vs_cold=None,
        s_cold: int = 0,
        mode: str = "xla",
    ):
        """One decode step of one sharded slot: resident paged partial
        plus cold dense partial, merged. Returns ``(logits [1, V],
        cache)``; the pool is written in place."""
        check_mode(mode)
        self._tp1_only("decode_step_sharded")
        table_row = torch.as_tensor(np.asarray(table_row, np.int32)).to(
            self.device)
        (x,) = self._embed(np.asarray(token))
        for i in range(self.cfg.num_layers):
            def attn(hs, i=i):
                return [tp_attn_decode_sharded(
                    self._layers[i]["attn"], hs[0], cache.k_pages[i],
                    cache.v_pages[i], table_row, kv_len_loc, k_cold[i],
                    v_cold[i], s_cold, self.dims, **_layer_scales(cache, i),
                    **_cold_scales(ks_cold, vs_cold, i),
                )[0]]
            (x,) = self._block([x], i, attn, mode)
        (x,) = self._norm([x])
        return self._logits([x]), cache

    def new_cache(self, batch_size: int,
                  max_length: int | None = None) -> KVCache:
        return init_cache(self.cfg, batch_size, self.device, max_length,
                          tp=self.tp)


def expand_tree_mask(tree_mask, q_offset: int, s_kv: int,
                     device) -> torch.Tensor:
    """A ``[C, C]`` draft-tree mask as the ``[C, S_kv]`` additive bias
    over a sequence's gathered view: the chunk's columns ``[q_offset,
    q_offset + C)`` carry the mask, every other column is 0 (the
    committed prefix is visible to every node; columns past the chunk are
    left to the causal mask)."""
    mask = np.asarray(tree_mask, np.float32)
    c = mask.shape[0]
    bias = torch.zeros((c, s_kv), dtype=torch.float32, device=device)
    width = max(min(c, s_kv - q_offset), 0)
    bias[:, q_offset : q_offset + width] = torch.from_numpy(
        np.ascontiguousarray(mask[:, :width])).to(device)
    return bias


def _scale_list(scales: list[dict], key: str):
    """The per-rank int8 scales of one layer as a list (None on a
    full-width pool)."""
    return None if not scales[0] else [sc[key] for sc in scales]


def _layer_scales(cache: PagedKVCache, i: int) -> dict:
    """Layer ``i``'s int8 scale views as attention kwargs (empty on a
    full-width pool)."""
    if not cache.quantized:
        return {}
    return {"k_scale": cache.k_scale[i], "v_scale": cache.v_scale[i]}


def _cold_scales(ks_cold, vs_cold, i: int) -> dict:
    """Layer ``i``'s cold-window scales as attention kwargs (empty for a
    full-width window)."""
    if ks_cold is None:
        return {}
    return {"ks_cold": ks_cold[i], "vs_cold": vs_cold[i]}


def _fuse(parts) -> np.ndarray:
    """Column-parallel weights fused per shard; at tp=1 a plain concat
    of ``[L, d, cols]`` parts along the columns."""
    return np.concatenate(parts, axis=-1)


def load_hf_state_dict(cfg: ModelConfig, state: dict) -> dict:
    """Map an HF Qwen3 state dict (numpy arrays or tensors, torch layout
    ``weight [out, in]``) to the port's parameter dict."""
    L = cfg.num_layers

    def get(name):
        return _np32(state[name])

    def stack(fmt, transpose=True):
        ws = [get(fmt.format(i)) for i in range(L)]
        return np.stack([w.T if transpose else w for w in ws])

    wq = stack("model.layers.{}.self_attn.q_proj.weight")
    wk = stack("model.layers.{}.self_attn.k_proj.weight")
    wv = stack("model.layers.{}.self_attn.v_proj.weight")
    gate = stack("model.layers.{}.mlp.gate_proj.weight")
    up = stack("model.layers.{}.mlp.up_proj.weight")
    embed = get("model.embed_tokens.weight")
    lm_head = embed.T if cfg.tie_word_embeddings else get("lm_head.weight").T
    return {
        "embed": embed,
        "layers": {
            "ln1": stack("model.layers.{}.input_layernorm.weight", False),
            "attn": {
                "wqkv": _fuse([wq, wk, wv]),
                "wo": stack("model.layers.{}.self_attn.o_proj.weight"),
                "q_norm": stack("model.layers.{}.self_attn.q_norm.weight",
                                False),
                "k_norm": stack("model.layers.{}.self_attn.k_norm.weight",
                                False),
            },
            "ln2": stack("model.layers.{}.post_attention_layernorm.weight",
                         False),
            "mlp": {
                "w1": _fuse([gate, up]),
                "w2": stack("model.layers.{}.mlp.down_proj.weight"),
            },
        },
        "norm": get("model.norm.weight"),
        "lm_head": np.ascontiguousarray(lm_head),
    }


def _np32(a) -> np.ndarray:
    """A float leaf as f32 numpy (bf16 leaves widen exactly)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).cpu().numpy()
    return np.asarray(a).astype(np.float32)


def _cat(parts, axis: int):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=axis)
    return np.concatenate(parts, axis=axis)


def _copy(t):
    if t is None:
        return None
    return t.clone() if isinstance(t, torch.Tensor) else np.array(t)


def _split(t, n: int, axis: int) -> list:
    """``n`` equal contiguous parts of ``t`` along ``axis``."""
    if t.shape[axis] % n:
        raise ValueError(f"axis {axis} of {tuple(t.shape)} not divisible by "
                         f"tp={n}")
    w = t.shape[axis] // n
    idx = [slice(None)] * t.ndim
    out = []
    for r in range(n):
        idx[axis] = slice(r * w, (r + 1) * w)
        out.append(t[tuple(idx)])
    return out


def shard_leaf(path: tuple, t, n: int, q_width: int = 0) -> list:
    """The ``n`` rank parts of one parameter leaf (``path`` below
    ``layers``, or ``("lm_head",)``), all layers or one layer's slice:
    the rules index trailing axes. ``wqkv`` ``[q_r | k_r | v_r]`` (its
    first ``q_width`` columns are q), ``w1`` ``[gate_r | up_r]`` (dense
    ``[L, d, 2ff]`` or MoE ``[L, E, d, 2f]``), ``wo`` and ``w2`` by rows,
    the LM head by columns padded to a multiple of 128·n; every other
    leaf (norms, the MoE router, the embedding) replicated, each rank its
    own copy."""
    if t is None:
        return [None] * n
    if path == ("attn", "wqkv"):
        kvw = (t.shape[-1] - q_width) // 2
        q, k, v = (_split(t[..., a:b], n, -1) for a, b in (
            (0, q_width), (q_width, q_width + kvw),
            (q_width + kvw, q_width + 2 * kvw)))
        return [_cat([q[r], k[r], v[r]], -1) for r in range(n)]
    if path == ("mlp", "w1"):
        ff = t.shape[-1] // 2
        gate, up = _split(t[..., :ff], n, -1), _split(t[..., ff:], n, -1)
        return [_cat([gate[r], up[r]], -1) for r in range(n)]
    if path in (("attn", "wo"), ("mlp", "w2")):
        return _split(t, n, -2)
    if path == ("lm_head",):
        vp = pad_vocab(t.shape[-1], n)
        if vp != t.shape[-1]:
            t = (F.pad(t, (0, vp - t.shape[-1]))
                 if isinstance(t, torch.Tensor)
                 else np.pad(t, ((0, 0), (0, vp - t.shape[-1]))))
        return _split(t, n, -1)
    return [t] + [_copy(t) for _ in range(n - 1)]


def _check_tp(cfg: ModelConfig, n: int) -> None:
    if cfg.num_q_heads % n or cfg.num_kv_heads % n:
        raise ValueError(f"heads not divisible by tp={n}")
    ff = cfg.moe_intermediate_size if cfg.num_experts else cfg.intermediate_size
    if ff % n:
        raise ValueError(f"d_ff {ff} not divisible by tp={n}")


def shard_params(params: dict, n: int, cfg: ModelConfig | None = None
                 ) -> list[dict]:
    """A tp=1-layout parameter dict (numpy arrays or tensors) as ``n``
    per-rank dicts in the JAX package's per-shard layouts
    (``_fuse_by_shard``, ``qwen.py:837``; the MoE ``w1`` fused per shard
    as ``models/qwen_moe.py:73-80`` does): each leaf by
    :func:`shard_leaf`. A Qwen3-MoE dict's MLP (``w_router``, ``w1 [L, E,
    d, 2f]``, ``w2 [L, E, f, d]``) shards by the same rules."""
    if cfg is not None:
        _check_tp(cfg, n)
    lp = params["layers"]
    qw = lp["attn"]["wo"].shape[-2]
    parts = {("embed",): shard_leaf(("embed",), params["embed"], n),
             ("norm",): shard_leaf(("norm",), params["norm"], n),
             ("lm_head",): shard_leaf(("lm_head",), params["lm_head"], n)}
    for key in ("ln1", "ln2"):
        parts[(key,)] = shard_leaf((key,), lp[key], n)
    for group in ("attn", "mlp"):
        for key, t in lp[group].items():
            parts[(group, key)] = shard_leaf((group, key), t, n, qw)
    shards = []
    for r in range(n):
        layers: dict = {"attn": {}, "mlp": {}}
        for path, ps in parts.items():
            if path[0] in ("ln1", "ln2"):
                layers[path[0]] = ps[r]
            elif path[0] in ("attn", "mlp"):
                layers[path[0]][path[1]] = ps[r]
        shards.append({"embed": parts[("embed",)][r], "layers": layers,
                       "norm": parts[("norm",)][r],
                       "lm_head": parts[("lm_head",)][r]})
    return shards


def unshard_params(shards: list[dict], mlp: bool = True) -> dict:
    """The inverse of :func:`shard_params`: per-rank dicts back to the
    tp=1 layout (rank 0's replicated leaves; the LM head keeps its
    128·n padding). ``mlp=False`` leaves the MLP as the list of the
    ranks' MLP dicts (a Qwen3-MoE model's experts do not fit twice on one
    card)."""
    s0 = shards[0]
    wo = [s["layers"]["attn"]["wo"] for s in shards]
    qw = wo[0].shape[-2]
    parts = [s["layers"]["attn"]["wqkv"] for s in shards]
    kvw = (parts[0].shape[-1] - qw) // 2
    wqkv = _cat([_cat([p[..., a:b] for p in parts], -1) for a, b in
                 ((0, qw), (qw, qw + kvw), (qw + kvw, qw + 2 * kvw))], -1)
    if mlp:
        w1s = [s["layers"]["mlp"]["w1"] for s in shards]
        ff = w1s[0].shape[-1] // 2
        w1 = _cat([_cat([w[..., :ff] for w in w1s], -1),
                   _cat([w[..., ff:] for w in w1s], -1)], -1)
        mlp = dict(s0["layers"]["mlp"])  # replicated leaves (the router)
        mlp.update(w1=w1, w2=_cat([s["layers"]["mlp"]["w2"]
                                   for s in shards], -2))
    else:
        mlp = [s["layers"]["mlp"] for s in shards]
    return {
        "embed": s0["embed"],
        "layers": {
            "ln1": s0["layers"]["ln1"], "ln2": s0["layers"]["ln2"],
            "attn": {"wqkv": wqkv, "wo": _cat(wo, -2),
                     "q_norm": s0["layers"]["attn"].get("q_norm"),
                     "k_norm": s0["layers"]["attn"].get("k_norm")},
            "mlp": mlp,
        },
        "norm": s0["norm"],
        "lm_head": _cat([s["lm_head"] for s in shards], -1),
    }


def _unfuse_by_shard(fused: np.ndarray, n: int, widths: list[int]) -> list:
    """Undo the JAX ``_fuse_by_shard``: ``[..., n * sum(widths)]`` whose
    shard r is ``[p0_r | p1_r | ...]`` → the global parts ``[..., n *
    w_i]`` (dense ``[L, d, ...]`` or MoE ``[L, E, d, ...]``)."""
    lead = fused.shape[:-1]
    per = fused.reshape(*lead, n, sum(widths))
    out, off = [], 0
    for w in widths:
        out.append(per[..., off:off + w].reshape(*lead, n * w))
        off += w
    return out


def params_from_jax(tree, tp: int = 1):
    """The leaves of a JAX ``Qwen3Params`` (numpy arrays, reached by
    attribute or key: ``embed``, ``layers.{ln1, attn.{wqkv, wo, q_norm,
    k_norm}, ln2, mlp.{w1, w2}}``, ``norm``, ``lm_head``; a Qwen3-MoE
    tree's ``mlp`` adds ``w_router``) in the port's layout. At tp=1 the
    JAX fused layouts (``wqkv = [q|k|v]``, ``w1 = [gate|up]``) are the
    port's, so leaves carry over as they are: a dict for
    :meth:`Qwen3.set_params`. A tree built at ``tp=n`` (global arrays)
    has its fused weights laid out by shard (``_fuse_by_shard``, applied
    after the draws of ``wq/wk/wv/gate/up``, ``qwen.py:149-156``; the MoE
    ``w1`` by ``models/qwen_moe.py:73-80``): they are unfused to the
    global parts, and the result is the list of
    per-rank shards :func:`shard_params` makes of them."""
    def leaf(*path):
        node = tree
        for name in path:
            node = node[name] if isinstance(node, dict) else getattr(node,
                                                                     name)
        return None if node is None else _np32(node)

    layers: dict = {"attn": {}, "mlp": {}}
    paths = _LAYER_LEAVES
    mlp = tree["layers"] if isinstance(tree, dict) else tree.layers
    mlp = mlp["mlp"] if isinstance(mlp, dict) else mlp.mlp
    if (isinstance(mlp, dict) and "w_router" in mlp) or hasattr(mlp,
                                                                "w_router"):
        # MoE (the JAX TPMoEParams leaves, [L, d, E], [L, E, d, 2f] and
        # [L, E, f, d]; gate | up fused per expert, the port's layout; at
        # tp=n fused per shard, unfused below like the dense w1).
        paths += (("mlp", "w_router"),)
    for path in paths:
        dst = layers if len(path) == 1 else layers[path[0]]
        dst[path[-1]] = leaf("layers", *path)
    params = {
        "embed": leaf("embed"), "layers": layers,
        "norm": leaf("norm"), "lm_head": leaf("lm_head"),
    }
    if tp == 1:
        return params
    qw = layers["attn"]["wo"].shape[-2]
    qkv_loc = layers["attn"]["wqkv"].shape[-1] // tp
    q_loc = qw // tp
    kv_loc = (qkv_loc - q_loc) // 2
    layers["attn"]["wqkv"] = np.concatenate(_unfuse_by_shard(
        layers["attn"]["wqkv"], tp, [q_loc, kv_loc, kv_loc]), axis=-1)
    ff_loc = layers["mlp"]["w1"].shape[-1] // (2 * tp)
    layers["mlp"]["w1"] = np.concatenate(_unfuse_by_shard(
        layers["mlp"]["w1"], tp, [ff_loc, ff_loc]), axis=-1)
    return shard_params(params, tp)


def q8_params_from_jax(tree, device=None, dtype=torch.float32):
    """The leaves of a JAX ``Q8Params`` at tp=1 (``MegaQwen3(model,
    cfg=MegaConfig(wq8=True)).quantized_params()`` as numpy, reached by
    attribute or key) as the port's ``megakernel.Q8Params`` on
    ``device``: int8 codes and f32 scales as they are (the JAX shapes:
    ``sc_qkv [L, 1, qkv]``, ``sc_lm [1, v_pad]``), the embed and norms in
    ``dtype`` (the model's). Both packages then decode from identical
    int8 weights."""
    from triton_distributed_tpu_torch.megakernel.qwen3 import Q8Params

    def leaf(name):
        a = tree[name] if isinstance(tree, dict) else getattr(tree, name)
        if np.asarray(a).dtype == np.int8:
            t = torch.from_numpy(np.array(a, np.int8))
        elif name.startswith("sc_"):
            t = torch.from_numpy(_np32(a))
        else:
            t = torch.from_numpy(_np32(a)).to(dtype)
        return t.to(device)

    return Q8Params(**{f.name: leaf(f.name)
                       for f in dataclasses.fields(Q8Params)})
