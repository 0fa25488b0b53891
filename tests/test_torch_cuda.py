"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc; without one they skip (the
CPU tests hold the plain versions against the JAX package). On the
card they run without the repo's conftest, which imports JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: f32 runs with TF32 off and differs from the plain version
only in summation order (atol 2e-5); bf16 differs by the kernels'
rounding of P to bf16 before P·V, which the plain f32 softmax does not
do (atol 2e-2 on O of unit-scale inputs). The int8 kernels take int8
codes and per-page (per-block) f32 scales; their plain versions
dequantize first, so only where the scale is multiplied in differs: the
same limits hold (bf16 q/o still round O to bf16). The bias kernel
adds a draft-tree mask to the scores; the same limits hold, and the
plain version with the mask shifted by one column must break them.
"""

import numpy as np
import pytest
import torch

from triton_distributed_tpu_torch.models.paged_kv_cache import quantize_pages
from triton_distributed_tpu_torch.models.speculative import TreeDraft
from triton_distributed_tpu_torch.ops import cuda_kernels as ck
from triton_distributed_tpu_torch.ops.attention import (
    flash_attention,
    flash_decode,
    gqa_decode_reference,
    mha_reference,
    paged_flash_decode,
    pages_to_dense,
)
from triton_distributed_tpu_torch.ops.attention.flash_decode import (
    scales_to_dense,
)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,hq,hkv,sq,sk,off", [
    (128, 16, 8, 256, 768, 512),
    (128, 16, 8, 200, 200, 0),
    (32, 8, 4, 37, 90, 53),
    (32, 4, 4, 16, 16, 0),
])
def test_flash_attention_matches_plain(dev, dtype, d, hq, hkv, sq, sk, off):
    rng = np.random.default_rng(0)
    q = _rand(rng, (2, hq, sq, d), dtype, dev)
    k = _rand(rng, (2, hkv, sk, d), dtype, dev)
    v = _rand(rng, (2, hkv, sk, d), dtype, dev)
    before = ck.FLASH_ATTENTION.launches
    o, lse = flash_attention(q, k, v, kv_offset=off, return_lse=True)
    torch.cuda.synchronize()
    assert ck.FLASH_ATTENTION.launches == before + 1
    o_ref, lse_ref = mha_reference(q, k, v, kv_offset=off, return_lse=True)
    assert torch.isfinite(o.float()).all()
    assert (o.float() - o_ref.float()).abs().max().item() < TOL[dtype]
    assert (lse - lse_ref).abs().max().item() < 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,hq,hkv,page", [(128, 16, 8, 128), (32, 8, 4, 16),
                                           (128, 32, 4, 64), (128, 16, 4, 32)])
def test_paged_decode_matches_plain(dev, dtype, d, hq, hkv, page):
    rng = np.random.default_rng(1)
    pps, b = 16, 6
    n_pages = b * pps + 1
    k_pages = _rand(rng, (n_pages, hkv, page, d), dtype, dev)
    v_pages = _rand(rng, (n_pages, hkv, page, d), dtype, dev)
    perm = rng.permutation(np.arange(1, n_pages))[: b * pps].reshape(b, pps)
    lens = np.array([1, page - 1, page, page + 1, 5 * page + 3, pps * page])
    table = np.where(np.arange(pps)[None] < -(-lens[:, None] // page), perm, 0)
    table = torch.from_numpy(table.astype(np.int32)).to(dev)
    kv_len = torch.from_numpy(lens.astype(np.int32)).to(dev)
    q = _rand(rng, (b, hq, d), dtype, dev)
    o, lse = paged_flash_decode(q, k_pages, v_pages, table, kv_len,
                                return_lse=True)
    torch.cuda.synchronize()
    o_ref, lse_ref = gqa_decode_reference(
        q, pages_to_dense(k_pages, table), pages_to_dense(v_pages, table),
        kv_len, return_lse=True)
    assert (o.float() - o_ref.float()).abs().max().item() < TOL[dtype]
    assert (lse - lse_ref).abs().max().item() < 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_matches_plain(dev, dtype):
    rng = np.random.default_rng(2)
    b, hq, hkv, s, d = 4, 16, 8, 1024, 128
    k = _rand(rng, (b, hkv, s, d), dtype, dev)
    v = _rand(rng, (b, hkv, s, d), dtype, dev)
    q = _rand(rng, (b, hq, d), dtype, dev)
    kv_len = torch.tensor([1, 255, 256, 1024], dtype=torch.int32, device=dev)
    o = flash_decode(q, k, v, kv_len)
    torch.cuda.synchronize()
    o_ref = gqa_decode_reference(q, k, v, kv_len)
    assert (o.float() - o_ref.float()).abs().max().item() < TOL[dtype]


def test_decode_empty_sequence_is_zero(dev):
    """kv_len 0 reads nothing: O = 0 and LSE = -1e30, what lse_combine
    gives for all-masked partials."""
    rng = np.random.default_rng(3)
    k = _rand(rng, (2, 2, 64, 32), torch.float32, dev)
    q = _rand(rng, (2, 4, 32), torch.float32, dev)
    o, lse = flash_decode(q, k, k, torch.zeros(2, dtype=torch.int32,
                                               device=dev), return_lse=True)
    assert o.abs().max().item() == 0.0
    assert (lse <= -1e29).all()


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 2, 8, 48, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), q, q)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q.half(), q.half(), q.half())


def _int8_pool(rng, shape, dev):
    """int8 codes + per-(page, head) scales quantized from ~N(0, 1)."""
    codes, scales = quantize_pages(_rand(rng, shape, torch.float32, dev))
    return codes, scales


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,hq,hkv,page,lens", [
    (128, 16, 8, 128, [1, 127, 128, 129, 700, 2047]),  # Qwen3-0.6B serving
    (32, 8, 4, 16, [1, 15, 16, 17, 33, 64]),            # tiny
])
def test_paged_decode_int8_matches_plain(dev, dtype, d, hq, hkv, page, lens):
    rng = np.random.default_rng(4)
    b = len(lens)
    pps = -(-max(lens) // page)
    n_pages = b * pps + 1
    kp, ks = _int8_pool(rng, (n_pages, hkv, page, d), dev)
    vp, vs = _int8_pool(rng, (n_pages, hkv, page, d), dev)
    kp[0], ks[0] = 127, 1e4  # the trash page: never read
    perm = rng.permutation(np.arange(1, n_pages))[: b * pps].reshape(b, pps)
    lens = np.asarray(lens)
    table = np.where(np.arange(pps)[None] < -(-lens[:, None] // page), perm, 0)
    table = torch.from_numpy(table.astype(np.int32)).to(dev)
    kv_len = torch.from_numpy(lens.astype(np.int32)).to(dev)
    q = _rand(rng, (b, hq, d), dtype, dev)
    before = ck.PAGED_FLASH_DECODE_INT8.launches
    o, lse = paged_flash_decode(q, kp, vp, table, kv_len, return_lse=True,
                                k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert ck.PAGED_FLASH_DECODE_INT8.launches == before + 1
    kd = pages_to_dense(kp, table).float() * scales_to_dense(
        ks, table, page)[..., None]
    vd = pages_to_dense(vp, table).float() * scales_to_dense(
        vs, table, page)[..., None]
    o_ref, lse_ref = gqa_decode_reference(q, kd, vd, kv_len, return_lse=True)
    assert torch.isfinite(o.float()).all()
    assert (o.float() - o_ref.float()).abs().max().item() < TOL[dtype]
    assert (lse - lse_ref).abs().max().item() < 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,hq,hkv,sq,sk,off,blk", [
    (128, 16, 8, 256, 768, 512, 128),  # the serving chunk, block_k = page
    (128, 16, 8, 129, 256, 127, 128),  # page-boundary offsets
    (32, 8, 4, 32, 64, 32, 16),        # tiny: one 32-key tile, two pages
    (32, 8, 4, 1, 16, 15, 16),
])
def test_flash_attention_int8_matches_plain(dev, dtype, d, hq, hkv, sq, sk,
                                            off, blk):
    rng = np.random.default_rng(5)
    q = _rand(rng, (1, hq, sq, d), dtype, dev)
    kb, ks = _int8_pool(rng, (hkv, sk // blk, blk, d), dev)
    vb, vs = _int8_pool(rng, (hkv, sk // blk, blk, d), dev)
    k, v = kb.reshape(1, hkv, sk, d), vb.reshape(1, hkv, sk, d)
    ks, vs = ks[None].contiguous(), vs[None].contiguous()
    before = ck.FLASH_ATTENTION_INT8.launches
    o, lse = flash_attention(q, k, v, kv_offset=off, block_k=blk,
                             k_scale=ks, v_scale=vs, return_lse=True)
    torch.cuda.synchronize()
    assert ck.FLASH_ATTENTION_INT8.launches == before + 1
    kd = k.float() * ks.repeat_interleave(blk, dim=-1)[..., None]
    vd = v.float() * vs.repeat_interleave(blk, dim=-1)[..., None]
    o_ref, lse_ref = mha_reference(q, kd, vd, kv_offset=off, return_lse=True)
    assert torch.isfinite(o.float()).all()
    assert (o.float() - o_ref.float()).abs().max().item() < TOL[dtype]
    assert (lse - lse_ref).abs().max().item() < 1e-3


def test_int8_wrappers_reject_what_the_kernels_do_not_take(dev):
    kp = torch.zeros(3, 2, 16, 32, dtype=torch.int8, device=dev)
    sc = torch.ones(3, 2, device=dev)
    q = torch.zeros(1, 4, 32, device=dev)
    table = torch.ones(1, 2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="dtype"):  # codes must be int8
        paged_flash_decode(q, kp.float(), kp.float(), table, 3,
                           k_scale=sc, v_scale=sc)
    with pytest.raises(ValueError, match="dtype"):  # scales must be f32
        paged_flash_decode(q, kp, kp, table, 3, k_scale=sc.double(),
                           v_scale=sc.double())
    with pytest.raises(ValueError, match="together"):
        paged_flash_decode(q, kp, kp, table, 3, k_scale=sc)


def _tree_bias(off: int, sq: int, sk: int, dev) -> torch.Tensor:
    """A real draft-tree mask (14 nodes, 5 branches) expanded over the
    gathered view as the model does: 0 on the prefix, the [Sq, Sq] tree
    mask on the chunk's columns."""
    tree = TreeDraft(4)
    for path in ([1, 2, 3, 4], [1, 5, 6], [7, 8, 9, 10], [7, 2], [11, 12]):
        tree.add_path(path, budget=sq)
    bias = torch.zeros(sq, sk)
    bias[:, off:off + sq] = torch.from_numpy(tree.mask(sq))
    return bias.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,hq,hkv,sk,off", [
    (128, 16, 8, 2048, 700),   # Qwen3-0.6B tree verify, gathered view
    (128, 16, 8, 2048, 2031),  # the chunk ends at the view's last key
    (32, 8, 4, 64, 40),        # tiny
])
def test_flash_attention_bias_matches_plain(dev, dtype, d, hq, hkv, sk, off):
    rng = np.random.default_rng(6)
    q = _rand(rng, (1, hq, 16, d), dtype, dev)
    k = _rand(rng, (1, hkv, sk, d), dtype, dev)
    v = _rand(rng, (1, hkv, sk, d), dtype, dev)
    bias = _tree_bias(off, 16, sk, dev)
    before = (ck.FLASH_ATTENTION_BIAS.launches, ck.FLASH_ATTENTION.launches)
    o, lse = flash_attention(q, k, v, kv_offset=off, bias=bias,
                             return_lse=True)
    torch.cuda.synchronize()
    assert (ck.FLASH_ATTENTION_BIAS.launches,
            ck.FLASH_ATTENTION.launches) == (before[0] + 1, before[1])
    o_ref, lse_ref = mha_reference(q, k, v, kv_offset=off, bias=bias,
                                   return_lse=True)
    assert torch.isfinite(o.float()).all()
    assert (o.float() - o_ref.float()).abs().max().item() < TOL[dtype]
    assert (lse - lse_ref).abs().max().item() < 1e-3
    if dtype == torch.float32:
        shifted = mha_reference(q, k, v, kv_offset=off,
                                bias=torch.roll(bias, 1, dims=1))
        assert (o - shifted).abs().max().item() > 10 * TOL[dtype]


def test_bias_wrapper_rejects_what_the_kernel_does_not_take(dev):
    q = torch.zeros(1, 4, 16, 32, device=dev)
    bias = torch.zeros(16, 16, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q, q, q, bias=bias.double())
    with pytest.raises(ValueError, match="bias shape"):
        flash_attention(q, q, q, bias=bias[:, :8])
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, q, q, bias=bias.t())
