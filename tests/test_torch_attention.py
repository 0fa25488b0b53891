"""The port's attention ops against the JAX package's, on the CPU.

On a CPU tensor each port wrapper runs its kernel's plain PyTorch
version; the JAX side runs its Pallas kernels in interpret mode, as the
JAX package's own tests do. Inputs come from numpy with a seed and go
to both packages.

Tolerances: f32 ops agree to atol 1e-5 (the port's plain versions take a
full softmax where the Pallas kernels take a blockwise online one; both
are f32, so only summation order differs). The bf16 case allows 2e-2:
the Pallas kernel rounds P to bf16 before P·V, the plain version does
not, and the output is rounded to bf16 (2^-8 relative) on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.ops.attention.flash_attention import (
    flash_attention as jax_flash_attention,
)
from triton_distributed_tpu.ops.attention.flash_decode import (
    flash_decode as jax_flash_decode,
    lse_combine as jax_lse_combine,
    paged_flash_decode as jax_paged_flash_decode,
    pages_to_dense as jax_pages_to_dense,
)
from triton_distributed_tpu_torch.ops import cuda_kernels as ck
from triton_distributed_tpu_torch.ops.attention import (
    flash_attention,
    flash_decode,
    lse_combine,
    paged_flash_decode,
    pages_to_dense,
)

torch.set_num_threads(1)  # leave the CPU to the JAX test workers

F32_ATOL = 1e-5
BF16_ATOL = 2e-2


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# head_dim 128 at the card's tensor-core body's edges (its tiles are 64
# q rows by 64 keys): Sq and Sk off the tiles, the diagonal inside a tile
# (kv_offset 135), G = 4 and 8. The plain version here is the card tests'
# oracle for that body. The JAX kernel takes whole blocks: block_k 40
# splits Sk = 200 into 5 (its online softmax across blocks).
@pytest.mark.parametrize("sq,sk,off,lse,d,hq,hkv,block_k", [
    pytest.param(64, 64, 0, False, 32, 8, 4, 128, id="64-64-0-False"),
    pytest.param(32, 96, 64, True, 32, 8, 4, 128, id="32-96-64-True"),
    pytest.param(16, 128, 112, True, 32, 8, 4, 128, id="16-128-112-True"),
    pytest.param(65, 200, 135, False, 128, 16, 4, 40, id="d128-g4"),
    pytest.param(65, 200, 135, True, 128, 16, 4, 40, id="d128-g4-lse"),
    pytest.param(65, 200, 135, True, 128, 8, 1, 40, id="d128-g8-lse"),
    pytest.param(65, 65, 0, False, 128, 8, 1, 65, id="d128-g8-sq65"),
])
def test_flash_attention_matches_jax(sq, sk, off, lse, d, hq, hkv, block_k):
    rng = np.random.default_rng(sq + sk)
    q = rng.standard_normal((2, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((2, hkv, sk, d)).astype(np.float32)
    v = rng.standard_normal((2, hkv, sk, d)).astype(np.float32)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, kv_offset=off, return_lse=lse,
                               block_k=block_k)
    got = flash_attention(_t(q), _t(k), _t(v), causal=True, kv_offset=off,
                          return_lse=lse)
    if lse:
        (want, want_lse), (got, got_lse) = want, got
        np.testing.assert_allclose(got_lse.numpy(), _np(want_lse),
                                   atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=F32_ATOL, rtol=0)
    assert ck.FLASH_ATTENTION.launches == 0  # CPU tensors never launch


def test_flash_attention_bf16_matches_jax():
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 8, 32, 32)).astype(np.float32)
    k = rng.standard_normal((1, 2, 64, 32)).astype(np.float32)
    v = rng.standard_normal((1, 2, 64, 32)).astype(np.float32)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = jax_flash_attention(*jb, causal=True, kv_offset=32)
    got = flash_attention(*[_t(a, torch.bfloat16) for a in (q, k, v)],
                          causal=True, kv_offset=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               atol=BF16_ATOL, rtol=0)


def test_flash_attention_takes_only_causal():
    """``causal`` selects the mask: with ``causal=False`` (the sharded
    long-context slot's cold partial) every query row attends every key,
    as in the JAX kernel, and ``kv_offset`` plays no part; with
    ``causal=True`` the same inputs are masked."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((1, 8, 16, 32)).astype(np.float32)
    k = rng.standard_normal((1, 4, 48, 32)).astype(np.float32)
    v = rng.standard_normal((1, 4, 48, 32)).astype(np.float32)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=False, block_q=16,
                               block_k=16)
    got = flash_attention(_t(q), _t(k), _t(v), causal=False, kv_offset=5)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=F32_ATOL, rtol=0)
    causal = flash_attention(_t(q), _t(k), _t(v), kv_offset=5)
    assert (causal - got).abs().max().item() > 100 * F32_ATOL
    assert ck.FLASH_ATTENTION_COLD.launches == 0  # CPU tensors never launch


PAGE = 16
LENS = np.array([1, PAGE - 1, PAGE, PAGE + 1, 4 * PAGE], np.int32)


def test_flash_decode_matches_jax():
    rng = np.random.default_rng(3)
    b, s = len(LENS), 4 * PAGE
    q = rng.standard_normal((b, 8, 32)).astype(np.float32)
    k = rng.standard_normal((b, 4, s, 32)).astype(np.float32)
    v = rng.standard_normal((b, 4, s, 32)).astype(np.float32)
    want, want_lse = jax_flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(LENS),
        chunk_k=PAGE, return_lse=True)
    got, got_lse = flash_decode(_t(q), _t(k), _t(v), torch.from_numpy(LENS),
                                chunk_k=PAGE, return_lse=True)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), _np(want_lse), atol=F32_ATOL,
                               rtol=0)


def test_paged_flash_decode_matches_jax():
    """Unused table entries point at the trash page 0, which holds
    garbage: neither side may read it."""
    rng = np.random.default_rng(4)
    b, pps, n_pages = len(LENS), 4, 24
    pages_k = rng.standard_normal((n_pages, 4, PAGE, 32)).astype(np.float32)
    pages_v = rng.standard_normal((n_pages, 4, PAGE, 32)).astype(np.float32)
    pages_k[0] = pages_v[0] = 1e4  # the trash page
    perm = rng.permutation(np.arange(1, n_pages))[: b * pps].reshape(b, pps)
    used = np.arange(pps)[None] < -(-LENS[:, None] // PAGE)
    table = np.where(used, perm, 0).astype(np.int32)
    q = rng.standard_normal((b, 8, 32)).astype(np.float32)
    want, want_lse = jax_paged_flash_decode(
        jnp.asarray(q), jnp.asarray(pages_k), jnp.asarray(pages_v),
        jnp.asarray(table), jnp.asarray(LENS), return_lse=True)
    got, got_lse = paged_flash_decode(
        _t(q), _t(pages_k), _t(pages_v), torch.from_numpy(table),
        torch.from_numpy(LENS), return_lse=True)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), _np(want_lse), atol=F32_ATOL,
                               rtol=0)
    dense = pages_to_dense(_t(pages_k), torch.from_numpy(table))
    want_dense = jax_pages_to_dense(jnp.asarray(pages_k), jnp.asarray(table))
    np.testing.assert_array_equal(dense.numpy(), _np(want_dense))


def test_lse_combine_matches_jax():
    """Includes a fully masked partial (LSE -1e30, weight 0) and an
    all-masked row."""
    rng = np.random.default_rng(5)
    o = rng.standard_normal((3, 4, 6, 32)).astype(np.float32)
    lse = rng.standard_normal((3, 4, 6)).astype(np.float32)
    lse[1, :, 2] = -1e30
    lse[:, 3, 5] = -1e30
    want_o, want_lse = jax_lse_combine(jnp.asarray(o), jnp.asarray(lse), 0)
    got_o, got_lse = lse_combine(_t(o), _t(lse), 0)
    np.testing.assert_allclose(got_o.numpy(), _np(want_o), atol=F32_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), _np(want_lse), rtol=1e-6)
