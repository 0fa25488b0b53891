"""Qwen3 (dense) at tp=1.

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
from triton_distributed_tpu_torch.runtime.context import DeviceContext


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    xf = x.to(torch.float32)
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * w.to(torch.float32)).to(x.dtype)


def pad_vocab(v: int) -> int:
    """Vocab width padded to a multiple of 128 (the JAX package's 128·tp
    at tp=1, so both packages hold the same LM-head shape)."""
    return -(-v // 128) * 128


_LAYER_LEAVES = (
    ("ln1",), ("attn", "wqkv"), ("attn", "wo"), ("attn", "q_norm"),
    ("attn", "k_norm"), ("ln2",), ("mlp", "w1"), ("mlp", "w2"),
)


class Qwen3:
    """Dense Qwen3 on one device. Runs on ``cuda`` unless ``device`` says
    otherwise (``device="cpu"`` runs the kernels' plain versions)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        self.cfg = cfg
        self.ctx = DeviceContext.create(device, cfg.dtype)
        self.device = self.ctx.device
        self.dims = TPAttnDims(
            hq_loc=cfg.num_q_heads, hkv_loc=cfg.num_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
        )
        self.params: dict | None = None
        self._layers: list[dict] = []

    # -- parameter construction ------------------------------------------
    def init_params(self, seed: int = 0) -> dict:
        """Random init from a ``torch.Generator`` seeded with ``seed`` on
        the model's device; the same scales as the JAX ``init_params``
        (normal × fan_in^-1/2, embed × 0.02, norms 1)."""
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

    def set_params(self, params: dict) -> dict:
        """Move ``params`` to the model's device and dtype, pad the LM
        head's vocab axis to a multiple of 128 (zero columns, sliced off
        by the logits), and cache per-layer views."""
        def conv(t):
            return torch.as_tensor(t).to(self.device, self.cfg.dtype)

        lp = params["layers"]
        layers = {
            "ln1": conv(lp["ln1"]), "ln2": conv(lp["ln2"]),
            "attn": {k: (None if lp["attn"].get(k) is None
                         else conv(lp["attn"][k]))
                     for k in ("wqkv", "wo", "q_norm", "k_norm")},
            "mlp": {k: conv(w) for k, w in lp["mlp"].items()},
        }
        lm_head = conv(params["lm_head"])
        v = lm_head.shape[1]
        if pad_vocab(v) != v:
            lm_head = F.pad(lm_head, (0, pad_vocab(v) - v))
        self.params = {
            "embed": conv(params["embed"]), "layers": layers,
            "norm": conv(params["norm"]), "lm_head": lm_head,
        }
        self._layers = [
            {
                "ln1": layers["ln1"][i], "ln2": layers["ln2"][i],
                "attn": {k: (None if w is None else w[i])
                         for k, w in layers["attn"].items()},
                "mlp": {k: w[i] for k, w in layers["mlp"].items()},
            }
            for i in range(self.cfg.num_layers)
        ]
        return self.params

    # -- forward pieces ----------------------------------------------------
    def _embed(self, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=self.device).long()
        return F.embedding(tokens, self.params["embed"])

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """``[..., d]`` → f32 logits ``[..., V]`` (vocab padding sliced
        off). The GEMM rounds to the model dtype before the f32 cast."""
        return (x @ self.params["lm_head"]).to(torch.float32)[
            ..., : self.cfg.vocab_size
        ]

    def _mlp_fwd(self, mlp_params: dict, h: torch.Tensor, mode: str):
        """The layer's MLP on the normed ``h``: the dense SwiGLU here,
        the routed experts in ``Qwen3MoE``."""
        return tp_mlp_fwd(mlp_params, h, mode=mode)

    def _block(self, x, lyr, attn, mode: str):
        """One decoder layer around ``attn(h) -> attention output``."""
        eps = self.cfg.rms_eps
        x = x + attn(rms_norm(x, lyr["ln1"], eps))
        return x + self._mlp_fwd(lyr["mlp"], rms_norm(x, lyr["ln2"], eps),
                                 mode)

    # -- entry points --------------------------------------------------------
    def decode_step(self, tokens, cache, mode: str = "xla"):
        """One token for every sequence of the batch: ``tokens [B]`` →
        ``(logits [B, V] f32, cache)``. Accepts a dense :class:`KVCache`
        or a :class:`PagedKVCache` (full width or int8); K/V (and an int8
        pool's scales) are written in place and the returned cache
        carries ``kv_len + 1``."""
        check_mode(mode)
        paged = isinstance(cache, PagedKVCache)
        x = self._embed(tokens)
        for i, lyr in enumerate(self._layers):
            if paged:
                def attn(h, i=i, lyr=lyr):
                    return tp_attn_decode_paged(
                        lyr["attn"], h, cache.k_pages[i], cache.v_pages[i],
                        cache.page_table, cache.kv_len, self.dims,
                        **_layer_scales(cache, i),
                    )[0]
            else:
                def attn(h, i=i, lyr=lyr):
                    return tp_attn_decode(
                        lyr["attn"], h, cache.k[i], cache.v[i],
                        cache.kv_len, self.dims,
                    )[0]
            x = self._block(x, lyr, attn, mode)
        x = rms_norm(x, self.params["norm"], self.cfg.rms_eps)
        return self._logits(x), dataclasses.replace(
            cache, kv_len=cache.kv_len + 1
        )

    def prefill_batched(self, tokens, cache: KVCache, mode: str = "xla",
                        true_lens=None):
        """Prefill every row of ``tokens [B, S]`` into cache rows
        ``[0, B)`` at positions ``[0, S)``. ``true_lens[i]`` is row i's
        real length: positions past it are right-padding, inert under
        causal masking; logits come from position ``true_lens[i] - 1``
        and ``kv_len[i]`` is set to ``true_lens[i]``. Returns
        ``(logits [B, V], cache)``."""
        check_mode(mode)
        tokens = torch.as_tensor(tokens, device=self.device)
        b, s = tokens.shape
        lens = [s] * b if true_lens is None else [
            int(t) for t in np.asarray(true_lens).reshape(-1)
        ]
        logits = []
        for row in range(b):
            x = self._embed(tokens[row])  # [S, d]
            for i, lyr in enumerate(self._layers):
                def attn(h, i=i, lyr=lyr):
                    out, k, v = tp_attn_prefill(lyr["attn"], h, self.dims)
                    cache.k[i, row, :, :s] = k.to(cache.k.dtype)
                    cache.v[i, row, :, :s] = v.to(cache.v.dtype)
                    return out
                x = self._block(x, lyr, attn, mode)
            x = rms_norm(x, self.params["norm"], self.cfg.rms_eps)
            last = lens[row] - 1
            logits.append(self._logits(x[last : last + 1])[0])
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
        scores every chunk position; they stay on the device).

        ``tree_mask``/``tree_depth`` (passed together) run the chunk as a
        speculative draft TREE: rows are trie nodes in DFS storage order,
        ``tree_mask[i, j]`` is 0 where node j is an ancestor-or-self of
        node i and -1e30 otherwise, and node i ropes at ``q_offset +
        tree_depth[i]`` while its KV scatters at ``q_offset + i``. The
        mask expands to the gathered view's ``[C, S_kv]`` bias once here
        (prefix columns visible, columns past the chunk left to
        causality) and every layer shares it."""
        check_mode(mode)
        if (tree_mask is None) != (tree_depth is None):
            raise ValueError("tree_mask and tree_depth go together")
        q_offset = int(q_offset)
        table_row = cache.page_table[int(slot)]
        x = self._embed(np.asarray(tokens))
        tree = {}
        if tree_mask is not None:
            page = cache.k_pages.shape[3]
            s_kv = (table_row.shape[0] if kv_pages is None else kv_pages) * page
            depth = torch.as_tensor(np.asarray(tree_depth, np.int64))
            tree = {"attn_bias": expand_tree_mask(tree_mask, q_offset, s_kv,
                                                  self.device),
                    "rope_pos": (q_offset + depth).to(self.device)}
        for i, lyr in enumerate(self._layers):
            def attn(h, i=i, lyr=lyr):
                return tp_attn_prefill_paged_chunk(
                    lyr["attn"], h, cache.k_pages[i], cache.v_pages[i],
                    table_row, q_offset, self.dims, kv_pages=kv_pages,
                    q_end=int(new_len), **_layer_scales(cache, i), **tree,
                )[0]
            x = self._block(x, lyr, attn, mode)
        x = rms_norm(x, self.params["norm"], self.cfg.rms_eps)
        if all_logits:
            logits = self._logits(x)
        else:
            last = int(last_idx)
            logits = self._logits(x[last : last + 1])[0]
        kv_len = cache.kv_len.clone()
        kv_len[int(slot)] = int(new_len)
        return logits, dataclasses.replace(cache, kv_len=kv_len)

    # -- sharded long-context slots ------------------------------------------
    #
    # A slot whose KV exceeds the per-rank page budget splits into a
    # RESIDENT paged window (local positions, its own explicit
    # ``table_row``: the slot's pages are not in the batched table) and a
    # COLD dense window of tier-demoted pages (pool dtype + per-page
    # scales, read-only, ``[L, Hkv, S_bucket, hd]``). Both forwards merge
    # the two attention partials with ``lse_combine``; neither touches the
    # batched ``kv_len``/``page_table``.

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
        table_row = torch.as_tensor(np.asarray(table_row, np.int32)).to(
            self.device)
        x = self._embed(np.asarray(tokens))
        bias = cold_mask(x.shape[0], k_cold.shape[2], s_cold, self.device)
        for i, lyr in enumerate(self._layers):
            def attn(h, i=i, lyr=lyr):
                return tp_attn_prefill_paged_chunk_cold(
                    lyr["attn"], h, cache.k_pages[i], cache.v_pages[i],
                    table_row, k_cold[i], v_cold[i], s_cold, q_offset,
                    self.dims, q_end=int(q_end), cold_bias=bias,
                    **_layer_scales(cache, i),
                    **_cold_scales(ks_cold, vs_cold, i),
                )[0]
            x = self._block(x, lyr, attn, mode)
        x = rms_norm(x, self.params["norm"], self.cfg.rms_eps)
        last = int(last_idx)
        return self._logits(x[last : last + 1])[0], cache

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
        table_row = torch.as_tensor(np.asarray(table_row, np.int32)).to(
            self.device)
        x = self._embed(np.asarray(token))
        for i, lyr in enumerate(self._layers):
            def attn(h, i=i, lyr=lyr):
                return tp_attn_decode_sharded(
                    lyr["attn"], h, cache.k_pages[i], cache.v_pages[i],
                    table_row, kv_len_loc, k_cold[i], v_cold[i], s_cold,
                    self.dims, **_layer_scales(cache, i),
                    **_cold_scales(ks_cold, vs_cold, i),
                )[0]
            x = self._block(x, lyr, attn, mode)
        x = rms_norm(x, self.params["norm"], self.cfg.rms_eps)
        return self._logits(x), cache

    def new_cache(self, batch_size: int,
                  max_length: int | None = None) -> KVCache:
        return init_cache(self.cfg, batch_size, self.device, max_length)


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


def params_from_jax(tree) -> dict:
    """The leaves of a JAX ``Qwen3Params`` (numpy arrays, reached by
    attribute or key: ``embed``, ``layers.{ln1, attn.{wqkv, wo, q_norm,
    k_norm}, ln2, mlp.{w1, w2}}``, ``norm``, ``lm_head``; a Qwen3-MoE
    tree's ``mlp`` adds ``w_router``) as the port's parameter dict. At
    tp=1 the JAX fused layouts (``wqkv = [q|k|v]``, ``w1 = [gate|up]``)
    are the port's, so leaves carry over as they are; pass the result to
    :meth:`Qwen3.set_params`."""
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
        # [L, E, f, d]; gate | up fused per expert, the port's layout).
        paths += (("mlp", "w_router"),)
    for path in paths:
        dst = layers if len(path) == 1 else layers[path[0]]
        dst[path[-1]] = leaf("layers", *path)
    return {
        "embed": leaf("embed"), "layers": layers,
        "norm": leaf("norm"), "lm_head": leaf("lm_head"),
    }


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
