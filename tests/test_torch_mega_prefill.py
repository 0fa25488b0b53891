"""The port's prefill megakernel against the JAX package, on the CPU.

On the CPU ``MegaQwen3.prefill`` runs the prefill kernel's plain version
(``megakernel/kernels.py``: LOAD_X, ATTN_PREFILL, the last-row LM head),
the function the CUDA kernel is held against on the card
(``tests/test_torch_cuda.py``). Here, on the f32 ``tiny`` preset with a
right-padded prompt (S=16, true_len=13):

- the packed prefill table equals the JAX ``build_prefill_graph`` table;
- the logits and the K/V rows of the real positions equal the JAX
  megakernel's (``MegaQwen3.prefill``, interpret mode) within 1e-4 and
  1e-5 (f32 on both sides; the JAX kernel streams its GEMMs in tiles, so
  only summation order differs), ``kv_len`` exactly;
- the same against the JAX ``xla`` prefill within 2e-3, the JAX test's
  limit (tests/test_megakernel.py:215-246);
- the same under ``wq8`` against the JAX megakernel's int8-weight
  prefill;
- a greedy continuation through the dense mega decode from the prefilled
  cache emits the JAX ``xla`` stream's tokens;
- paged and sampled prefill builds are refused, as in the JAX package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.megakernel import MegaQwen3 as JaxMegaQwen3
from triton_distributed_tpu.megakernel.code_generator import (
    MegaConfig as JaxMegaConfig,
)
from triton_distributed_tpu.megakernel.code_generator import (
    MegaDims as JaxMegaDims,
)
from triton_distributed_tpu.megakernel.model_builder import (
    ModelBuilder as JaxModelBuilder,
)
from triton_distributed_tpu.megakernel.scheduler import schedule as jax_schedule
from triton_distributed_tpu.megakernel.task import pack_table as jax_pack
from triton_distributed_tpu.models import AutoLLM as JaxAutoLLM
from triton_distributed_tpu.runtime import mesh as mesh_mod
from triton_distributed_tpu_torch.megakernel import (
    MegaConfig,
    MegaDims,
    MegaQwen3,
    ModelBuilder,
    pack_table,
    schedule,
)
from triton_distributed_tpu_torch.megakernel.code_generator import check_dims
from triton_distributed_tpu_torch.models import Qwen3, get_config, params_from_jax

torch.set_num_threads(1)  # leave the CPU to the JAX test workers

S, TRUE_LEN, MAXLEN = 16, 13, 64
TOKS = (np.arange(S) % 251 + 1).astype(np.int32)
LOGIT_ATOL, KV_ATOL, XLA_ATOL = 1e-4, 1e-5, 2e-3


@pytest.fixture(scope="module")
def models():
    ctx = mesh_mod.initialize_distributed(tp=1, devices=jax.devices()[:1])
    jm = JaxAutoLLM.from_pretrained("tiny", ctx=ctx, seed=0)
    tm = Qwen3(get_config("tiny"), device="cpu")
    tm.set_params(params_from_jax(jax.tree.map(np.asarray, jm.params)))
    yield jm, tm
    mesh_mod.finalize_distributed()


def _jax_prefill(jm, wq8=False):
    mega = JaxMegaQwen3(jm, cfg=JaxMegaConfig(wq8=wq8))
    logits, cache = mega.prefill(jnp.asarray(TOKS), jm.new_cache(1, MAXLEN),
                                 true_len=TRUE_LEN)
    return np.asarray(logits), jax.tree.map(np.asarray, cache)


def _port_prefill(tm, wq8=False, fuse_norms=False):
    mega = MegaQwen3(tm, cfg=MegaConfig(wq8=wq8, fuse_norms=fuse_norms))
    logits, cache = mega.prefill(TOKS, tm.new_cache(1, MAXLEN),
                                 true_len=TRUE_LEN)
    return mega, logits, cache


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("fuse_norms", [False, True])
def test_prefill_table_matches_jax(models, fuse_norms):
    jm, _ = models
    dims = dict(batch=S, d=64, hq_loc=8, hkv_loc=4, head_dim=32, f_loc=128,
                v_loc=256, num_layers=2, s_max=S, n_ranks=1, prefill=True)
    jb = JaxModelBuilder(JaxMegaDims(**dims),
                         cfg=JaxMegaConfig(fuse_norms=fuse_norms), ctx=jm.ctx)
    jb.build_prefill_graph()
    tb = ModelBuilder(MegaDims(**dims), cfg=MegaConfig(fuse_norms=fuse_norms))
    tb.build_prefill_graph()
    np.testing.assert_array_equal(pack_table(schedule(tb.tasks)),
                                  jax_pack(jax_schedule(jb.tasks)))


@pytest.fixture(scope="module")
def jax_prefills(models):
    jm, _ = models
    return {wq8: _jax_prefill(jm, wq8) for wq8 in (False, True)}


@pytest.mark.parametrize("wq8", [False, True])
def test_prefill_matches_jax_megakernel(models, jax_prefills, wq8):
    _, tm = models
    want_logits, want = jax_prefills[wq8]
    _, logits, cache = _port_prefill(tm, wq8)
    assert logits.shape == (tm.cfg.vocab_size,)
    _close(logits, want_logits, LOGIT_ATOL)
    for got, ref in ((cache.k, want.k), (cache.v, want.v)):
        _close(got[:, :, :, :TRUE_LEN], ref[:, :, :, :TRUE_LEN], KV_ATOL)
    assert cache.kv_len.tolist() == want.kv_len.tolist() == [TRUE_LEN]


@pytest.mark.parametrize("fuse_norms", [False, True])
def test_prefill_matches_jax_xla(models, fuse_norms):
    jm, tm = models
    want_logits, want = jm.prefill(jnp.asarray(TOKS), jm.new_cache(1, MAXLEN),
                                   "xla", true_len=TRUE_LEN)
    _, logits, cache = _port_prefill(tm, fuse_norms=fuse_norms)
    _close(logits, want_logits, XLA_ATOL)
    _close(cache.k[:, :, :, :TRUE_LEN], np.asarray(want.k)[:, :, :, :TRUE_LEN],
           XLA_ATOL)
    # The port's own xla prefill, the oracle on the card.
    xla_logits, _ = tm.prefill_batched(TOKS[None], tm.new_cache(1, MAXLEN),
                                       "xla", [TRUE_LEN])
    _close(logits, xla_logits[0], XLA_ATOL)


def test_prefill_then_mega_decode_matches_jax(models):
    """Greedy continuation: the argmax of the prefill logits, then one
    4-step dense mega launch, emits the JAX xla stream's 5 tokens."""
    jm, tm = models
    logits, jcache = jm.prefill(jnp.asarray(TOKS), jm.new_cache(1, MAXLEN),
                                "xla", true_len=TRUE_LEN)
    tok = jnp.argmax(logits)[None].astype(jnp.int32)
    want = [int(tok[0])]
    for _ in range(4):
        logits, jcache = jm.decode_step(tok, jcache, "xla")
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(int(tok[0]))
    mega, logits, cache = _port_prefill(tm)
    first = logits.argmax()[None].to(torch.int32)
    toks, _, cache = mega.decode_multi_fn(1, MAXLEN, 4)(tm.params, first,
                                                        cache)
    assert [int(first)] + toks[:, 0].tolist() == want
    assert cache.kv_len.tolist() == [TRUE_LEN + 4]


def test_paged_and_sampled_prefill_are_refused(models):
    _, tm = models
    mega = MegaQwen3(tm)
    dims = dataclasses.replace(mega._dims(S, S), prefill=True)
    check_dims(dims, MegaConfig())
    with pytest.raises(NotImplementedError, match="paged prefill"):
        check_dims(dataclasses.replace(dims, page=16), MegaConfig())
    with pytest.raises(NotImplementedError, match="sampled"):
        check_dims(dataclasses.replace(dims, sampled=True), MegaConfig())
    with pytest.raises(ValueError, match="one step"):
        check_dims(dataclasses.replace(dims, trace=True), MegaConfig())
    with pytest.raises(ValueError, match="true_len"):
        mega.prefill(TOKS, tm.new_cache(1, MAXLEN), true_len=S + 1)
    with pytest.raises(ValueError, match="positions"):
        mega.prefill(TOKS, tm.new_cache(1, 8))
