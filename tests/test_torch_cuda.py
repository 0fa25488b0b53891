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
plain version with the mask shifted by one column must break them. The
long-context cold partials (non-causal attention over a cold window
under its ``s_cold`` bias, model dtype and int8; the dense int8 decode)
hold the same limits at ``s_cold`` = 0 (every column masked, or an empty
context), mid-bucket and full, and in f32 the plain version with
``s_cold`` one page off must break them. The megakernel's tests (below)
state their own limits: its traced launch equals the untraced one bit for
bit, and its prefill kernel is held to its plain version within 2e-3 in
f32 and the decode kernel's limit in bf16.
"""

import functools
import importlib.util
import pathlib

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


# bf16 at head_dim 128 runs the tensor-core body (64-row q tiles, 64-key
# tiles): the cases below put Sq, Sk and kv_offset off those tiles, the
# causal diagonal inside a tile, G from 1 to 8, and the non-causal call
# without a bias (ring attention, SP's plain walk).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,hq,hkv,sq,sk,off,causal", [
    (128, 16, 8, 256, 768, 512, True),
    (128, 16, 8, 200, 200, 0, True),
    (128, 32, 4, 256, 768, 512, True),  # Qwen3-30B-A3B: G = 8
    (32, 8, 4, 37, 90, 53, True),
    (32, 4, 4, 16, 16, 0, True),
    (128, 8, 8, 37, 37, 0, True),       # Sq = Sk below one tile, G = 1
    (128, 16, 8, 65, 65, 0, True),      # one row past a tile
    (128, 16, 4, 65, 200, 135, True),   # diagonal inside a tile, G = 4
    (128, 16, 2, 90, 127, 37, True),    # Sk = 90 + kv_offset, G = 8
    (128, 16, 4, 384, 384, 0, True),    # Qwen3-8B tp=2 chunk
    (128, 16, 8, 128, 2048, 0, False),  # non-causal, no bias
    (128, 16, 4, 65, 200, 0, False),
])
def test_flash_attention_matches_plain(dev, dtype, d, hq, hkv, sq, sk, off,
                                       causal):
    rng = np.random.default_rng(0)
    q = _rand(rng, (2, hq, sq, d), dtype, dev)
    k = _rand(rng, (2, hkv, sk, d), dtype, dev)
    v = _rand(rng, (2, hkv, sk, d), dtype, dev)
    counter = ck.FLASH_ATTENTION if causal else ck.FLASH_ATTENTION_COLD
    before = counter.launches
    o, lse = flash_attention(q, k, v, kv_offset=off, return_lse=True,
                             causal=causal)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    o_ref, lse_ref = mha_reference(q, k, v, kv_offset=off, return_lse=True,
                                   causal=causal)
    assert torch.isfinite(o.float()).all()
    assert (o.float() - o_ref.float()).abs().max().item() < TOL[dtype]
    assert (lse - lse_ref).abs().max().item() < 1e-3


def test_flash_attention_back_to_back(dev):
    """100 launches of the tensor-core body in a row (causal chunks at
    moving offsets and cold partials, fresh inputs each), every output
    checked against the plain version."""
    gen = torch.Generator(device=dev).manual_seed(5)
    bf16 = torch.bfloat16
    for i in range(100):
        causal = i % 2 == 0
        sq, off = 64 + 7 * (i % 9), 13 * i
        sk = off + sq if causal else 128 + 61 * (i % 5)
        q = torch.randn((1, 16, sq, 128), generator=gen, device=dev).to(bf16)
        k = torch.randn((1, 8, sk, 128), generator=gen, device=dev).to(bf16)
        v = torch.randn((1, 8, sk, 128), generator=gen, device=dev).to(bf16)
        o, lse = flash_attention(q, k, v, kv_offset=off, causal=causal,
                                 return_lse=True)
        o_ref, lse_ref = mha_reference(q, k, v, kv_offset=off,
                                       causal=causal, return_lse=True)
        err = (o.float() - o_ref.float()).abs().max().item()
        assert err < TOL[bf16], (i, err)
        assert (lse - lse_ref).abs().max().item() < 1e-3, i


@pytest.mark.parametrize("sq,sk,off", [(200, 200, 0), (65, 72, 7),
                                       (65, 200, 135)])
def test_flash_attention_diagonal_off_by_one_breaks_the_limit(dev, sq, sk,
                                                              off):
    """Control: the plain version with kv_offset one row off (the causal
    diagonal one column over) breaks the limit the kernel meets."""
    rng = np.random.default_rng(6)
    bf16 = torch.bfloat16
    q = _rand(rng, (1, 16, sq, 128), bf16, dev)
    k = _rand(rng, (1, 4, sk, 128), bf16, dev)
    v = _rand(rng, (1, 4, sk, 128), bf16, dev)
    o = flash_attention(q, k, v, kv_offset=off)
    assert (o.float() - mha_reference(q, k, v, kv_offset=off).float()).abs(
        ).max().item() < TOL[bf16]
    for wrong in {off + 1, max(off - 1, 0)} - {off}:
        diff = (o.float() - mha_reference(q, k, v, kv_offset=wrong).float())
        assert diff.abs().max().item() > TOL[bf16], wrong


def test_fma_builds_keep_their_counters(dev):
    """The builds left on the FMA body (f32, head_dim 32, int8 K/V causal
    and cold, the causal call with a bias) each count one launch on their
    own counter and none on another's."""
    f32, bf16 = torch.float32, torch.bfloat16
    rng = np.random.default_rng(4)
    cases = []
    for dtype, d in ((f32, 128), (bf16, 32)):
        q = _rand(rng, (1, 8, 40, d), dtype, dev)
        k = _rand(rng, (1, 4, 100, d), dtype, dev)
        cases.append((ck.FLASH_ATTENTION, q, k, k, {"kv_offset": 60}))
    q = _rand(rng, (1, 8, 16, 128), bf16, dev)
    codes, sc = _int8_pool(rng, (4, 2, 64, 128), dev)
    k8 = codes.reshape(1, 4, 128, 128)
    q8 = {"k_scale": sc[None].contiguous(), "v_scale": sc[None].contiguous(),
          "block_k": 64}
    cases.append((ck.FLASH_ATTENTION_INT8, q, k8, k8,
                   {"kv_offset": 112, **q8}))
    cases.append((ck.FLASH_ATTENTION_COLD_INT8, q, k8, k8,
                  {"causal": False, **q8}))
    kb = _rand(rng, (1, 4, 128, 128), bf16, dev)
    bias = torch.zeros((16, 128), device=dev)
    cases.append((ck.FLASH_ATTENTION_BIAS, q, kb, kb,
                  {"kv_offset": 112, "bias": bias}))
    for counter, q_, k_, v_, kw in cases:
        others = [c for c in (ck.FLASH_ATTENTION, ck.FLASH_ATTENTION_INT8,
                              ck.FLASH_ATTENTION_BIAS,
                              ck.FLASH_ATTENTION_COLD,
                              ck.FLASH_ATTENTION_COLD_INT8)
                  if c is not counter]
        before = [c.launches for c in others]
        n = counter.launches
        flash_attention(q_, k_, v_, **kw)
        torch.cuda.synchronize()
        assert counter.launches == n + 1
        assert [c.launches for c in others] == before


def test_bf16_d128_never_reaches_the_plain_version(dev, monkeypatch):
    """A bf16 head_dim-128 CUDA call launches its kernel or raises: with
    the plain version made to fail, the causal and cold calls still run
    and count one launch each."""
    fa_mod = importlib.import_module(
        "triton_distributed_tpu_torch.ops.attention.flash_attention")

    def refuse(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(fa_mod, "mha_reference", refuse)
    rng = np.random.default_rng(3)
    bf16 = torch.bfloat16
    q = _rand(rng, (1, 16, 100, 128), bf16, dev)
    k = _rand(rng, (1, 8, 300, 128), bf16, dev)
    bias = torch.zeros((100, 300), device=dev)
    for counter, kw in ((ck.FLASH_ATTENTION, {"kv_offset": 200}),
                        (ck.FLASH_ATTENTION_COLD, {"causal": False}),
                        (ck.FLASH_ATTENTION_COLD, {"causal": False,
                                                   "bias": bias})):
        n = counter.launches
        o = fa_mod.flash_attention(q, k, k, **kw)
        torch.cuda.synchronize()
        assert counter.launches == n + 1 and torch.isfinite(o.float()).all()


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_g8_matches_plain(dev, dtype):
    """The xla decode kernel at Qwen3-30B-A3B's heads: 32 q over 4 kv
    heads (G = 8)."""
    rng = np.random.default_rng(2)
    b, hq, hkv, s, d = 4, 32, 4, 2048, 128
    k = _rand(rng, (b, hkv, s, d), dtype, dev)
    v = _rand(rng, (b, hkv, s, d), dtype, dev)
    q = _rand(rng, (b, hq, d), dtype, dev)
    kv_len = torch.tensor([1, 700, 2040, 2048], dtype=torch.int32,
                          device=dev)
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
    (128, 32, 4, 2048, 700),   # Qwen3-30B-A3B: G = 8
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


def _verify_bias(off: int, sq: int, sk: int, dev) -> torch.Tensor:
    """A draft-tree mask of ``sq`` nodes over the gathered view (0 on the
    prefix), then masked further so that whole 64-key tiles hold only
    bias-masked columns for some rows while causally visible columns
    remain: rows 1, 4, .. see none of the prefix (their only visible
    columns are their tree ancestors), rows 0, 3, .. none of the prefix
    in odd 64-key tiles (which the second warpgroup takes). The paths go
    in so that the first 5 nodes already branch."""
    tree = TreeDraft(4)
    for path in ([1, 2], [7, 8], [1, 5, 6], [7, 2], [11, 12], [1, 2, 3, 4],
                 [7, 8, 9, 10]):
        tree.add_path(path, budget=sq)
    bias = torch.zeros(sq, sk)
    bias[:, off:off + sq] = torch.from_numpy(tree.mask(sq))
    odd = (torch.arange(off) // 64) % 2 == 1
    for r in range(sq):
        if r % 3 == 1:
            bias[r, :off] = -1e30
        elif r % 3 == 0:
            bias[r, :off][odd] = -1e30
    return bias.to(dev)


@pytest.mark.parametrize("off", [0, 40, 700, 2031])
@pytest.mark.parametrize("hq,hkv", [(16, 8), (32, 4)])
@pytest.mark.parametrize("sq", [16, 5])
def test_flash_attention_bias_tc_rows_and_masks(dev, off, hq, hkv, sq):
    """bf16 tree verify on the tensor-core body: Sq 16 and 5 rows in the
    64-row q tile, G 2 and 8, kv_offset 0 to the view's end, with tiles
    whose visible columns are all bias-masked for a row (and a warpgroup
    whose every tile is, before the merge). Counted on
    FLASH_ATTENTION_BIAS; O within TOL, the LSE within 1e-3; the plain
    version with the bias one column off breaks the O limit."""
    bf16, sk = torch.bfloat16, 2048
    rng = np.random.default_rng(off + sq)
    q = _rand(rng, (1, hq, sq, 128), bf16, dev)
    k = _rand(rng, (1, hkv, sk, 128), bf16, dev)
    v = _rand(rng, (1, hkv, sk, 128), bf16, dev)
    bias = _verify_bias(off, sq, sk, dev)
    before = (ck.FLASH_ATTENTION_BIAS.launches, ck.FLASH_ATTENTION.launches)
    o, lse = flash_attention(q, k, v, kv_offset=off, bias=bias,
                             return_lse=True)
    torch.cuda.synchronize()
    assert (ck.FLASH_ATTENTION_BIAS.launches,
            ck.FLASH_ATTENTION.launches) == (before[0] + 1, before[1])
    o_ref, lse_ref = mha_reference(q, k, v, kv_offset=off, bias=bias,
                                   return_lse=True)
    assert torch.isfinite(o.float()).all()
    assert (o.float() - o_ref.float()).abs().max().item() < TOL[bf16]
    assert (lse - lse_ref).abs().max().item() < 1e-3
    shifted = mha_reference(q, k, v, kv_offset=off,
                            bias=torch.roll(bias, 1, dims=1))
    assert (o.float() - shifted.float()).abs().max().item() > TOL[bf16]


def test_bias_wrapper_rejects_what_the_kernel_does_not_take(dev):
    q = torch.zeros(1, 4, 16, 32, device=dev)
    bias = torch.zeros(16, 16, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q, q, q, bias=bias.double())
    with pytest.raises(ValueError, match="bias shape"):
        flash_attention(q, q, q, bias=bias[:, :8])
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, q, q, bias=bias.t())


# -- the long-context cold partials -------------------------------------------

# (head_dim, q heads, kv heads, page, bucket pages, s_cold values): the
# tiny preset (a 4-page bucket, and the 1-page bucket a slot starts with:
# 16 keys, half the kernel's 32-key tile) and Qwen3-0.6B (16 pages).
COLD_SHAPES = {
    "tiny": (32, 8, 4, 16, 4, (0, 48, 64)),
    "tiny1": (32, 8, 4, 16, 1, (0, 16)),
    "qwen": (128, 16, 8, 128, 16, (0, 1536, 2048)),
}


def _cold_window(rng, dev, dtype, int8, hkv, n, page, d):
    """A cold window ``[1, hkv, n * page, d]`` (and ``[1, hkv, n]`` scales
    when int8) plus its dequantized f32 view for the plain versions."""
    if not int8:
        w = _rand(rng, (1, hkv, n * page, d), dtype, dev)
        return w, None, w
    codes, sc = _int8_pool(rng, (hkv, n, page, d), dev)
    w = codes.reshape(1, hkv, n * page, d)
    sc = sc[None].contiguous()
    return w, sc, w.float() * sc.repeat_interleave(page, dim=-1)[..., None]


def _cold_bias(sq, sk, s_cold, dev):
    cols = torch.arange(sk, device=dev)
    return torch.where(cols < s_cold, 0.0, -1e30)[None].expand(
        sq, sk).contiguous()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(COLD_SHAPES))
def test_cold_flash_attention_matches_plain(dev, shape, dtype, int8):
    """A page-row chunk against the cold window, non-causal, for every
    ``s_cold`` of the shape: finite, within the limits, and the plain
    version with ``s_cold`` one page off outside them."""
    d, hq, hkv, page, n, s_colds = COLD_SHAPES[shape]
    rng = np.random.default_rng(8)
    sk = n * page
    q = _rand(rng, (1, hq, page, d), dtype, dev)
    k, ks, kd = _cold_window(rng, dev, dtype, int8, hkv, n, page, d)
    v, vs, vd = _cold_window(rng, dev, dtype, int8, hkv, n, page, d)
    kw = dict(k_scale=ks, v_scale=vs, block_k=page) if int8 else {}
    counter = ck.FLASH_ATTENTION_COLD_INT8 if int8 else ck.FLASH_ATTENTION_COLD
    for s_cold in s_colds:
        bias = _cold_bias(page, sk, s_cold, dev)
        before = counter.launches
        o, lse = flash_attention(q, k, v, causal=False, bias=bias,
                                 return_lse=True, **kw)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        o_ref, lse_ref = mha_reference(q, kd, vd, causal=False, bias=bias,
                                       return_lse=True)
        assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
        assert (o.float() - o_ref.float()).abs().max().item() < TOL[dtype]
        if s_cold == 0:
            assert (lse <= -1e29).all()  # weight 0 in the combine
        else:
            assert (lse - lse_ref).abs().max().item() < 1e-3
        if dtype == torch.float32:
            off = s_cold - page if s_cold else page
            wrong = mha_reference(q, kd, vd, causal=False,
                                  bias=_cold_bias(page, sk, off, dev))
            assert (o - wrong).abs().max().item() > 10 * TOL[dtype]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(COLD_SHAPES))
def test_cold_flash_decode_matches_plain(dev, shape, dtype, int8):
    """One query row per ``s_cold`` of the shape (a batch), decoding over
    its own cold window with ``chunk_k = page``; an empty context gives
    O = 0 and LSE ~ -1e30; ``s_cold`` one page off breaks the limit."""
    d, hq, hkv, page, n, s_colds = COLD_SHAPES[shape]
    rng = np.random.default_rng(9)
    b = len(s_colds)
    wins = [_cold_window(rng, dev, dtype, int8, hkv, n, page, d)
            for _ in range(2 * b)]
    k, v = (torch.cat([w[0] for w in wins[i::2]]) for i in (0, 1))
    kd, vd = (torch.cat([w[2] for w in wins[i::2]]) for i in (0, 1))
    kw = {}
    if int8:
        kw = {name: torch.cat([w[1] for w in wins[i::2]])
              for i, name in enumerate(("k_scale", "v_scale"))}
    counter = ck.FLASH_DECODE_INT8 if int8 else ck.FLASH_DECODE
    q = _rand(rng, (b, hq, d), dtype, dev)
    lens = torch.tensor(s_colds, dtype=torch.int32, device=dev)
    before = counter.launches
    o, lse = flash_decode(q, k, v, lens, chunk_k=page, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    o_ref, lse_ref = gqa_decode_reference(q, kd, vd, lens, return_lse=True)
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    assert (o.float() - o_ref.float()).abs().max().item() < TOL[dtype]
    live = lens > 0
    assert o[~live].abs().max().item() == 0.0 and (lse[~live] <= -1e29).all()
    assert (lse[live] - lse_ref[live]).abs().max().item() < 1e-3
    if dtype == torch.float32:
        wrong = gqa_decode_reference(q, kd, vd,
                                     torch.where(live, lens - page, page))
        err = (o - wrong).abs().amax(dim=(1, 2))
        assert (err > 10 * TOL[dtype]).all()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_sharded_engine_on_card_matches_cpu(dev, kv_dtype):
    """The tiny f32 sharded engine (a 64-token budget over a 6-page pool)
    emits the same tokens on the card as on the CPU and as a big-pool
    engine, through the cold-partial kernels, with clean audits."""
    from triton_distributed_tpu_torch.models import (
        AutoLLM,
        ContinuousEngine,
    )

    gpu = AutoLLM.from_pretrained("tiny", device=dev, seed=0)
    cpu = AutoLLM.from_pretrained("tiny", device="cpu", seed=0)
    cpu.set_params(gpu.params)
    prompt = np.random.default_rng(8).integers(1, 200, 120).astype(np.int32)
    kw = dict(max_batch=1, page_size=16, max_length=256, kv_dtype=kv_dtype)
    sharded = dict(rank_page_budget=64, tier_bytes=32 << 20, num_pages=6)
    cold = ((ck.FLASH_ATTENTION_COLD_INT8, ck.FLASH_DECODE_INT8) if kv_dtype
            else (ck.FLASH_ATTENTION_COLD, ck.FLASH_DECODE))
    outs = []
    for m, d in ((gpu, dev), (cpu, "cpu")):
        before = [c.launches for c in cold]
        eng = ContinuousEngine(m, device=d, **kw, **sharded)
        outs.append(eng.run([(prompt, 6)])[0])
        st = eng.last_stats
        assert eng.audit() == []
        assert st["longctx_sharded_slots"] == 1
        assert st["longctx_demoted_pages"] > 0
        ran = [c.launches - b for c, b in zip(cold, before)]
        assert all(ran) if d == dev else not any(ran)
    big = ContinuousEngine(cpu, device="cpu", **kw).run([(prompt, 6)])[0]
    np.testing.assert_array_equal(outs[0], outs[1])
    if kv_dtype is None:
        np.testing.assert_array_equal(outs[0], big)


# -- the decode megakernel ----------------------------------------------------
#
# mega_decode (csrc/megakernel.cu) against its plain version
# (megakernel/kernels.py) on the same weights, caches and tokens: the
# tiny preset's widths (4 rows, and 10 rows: two full 4-row batch groups
# of the kernel's GEMMs and a partial one) and Qwen3-0.6B's widths at 2
# layers (4 rows, and 16 rows in f32, where tokens must match exactly at
# any batch: in bf16 a 16-row batch meets near ties), dense and
# paged (trash page 0, a bucket filler row with kv_len 0), NS = 1 and
# NS = 8, f32 (TF32 off) and bf16. Tokens must be equal. Logit limits:
# f32 differs only in summation order (2e-3 on logits of size ~5);
# bf16 additionally rounds each GEMM input to bf16 on both sides, and a
# summation-order difference can flip one rounding by an ulp (2^-8), so
# 0.05 + 2^-6 |plain| on logits.
MEGA_TOL = {torch.float32: (2e-3, 0.0), torch.bfloat16: (5e-2, 2.0**-6)}
MEGA_SHAPES = {
    # preset overrides, kv_len per row (0 = bucket filler), page size
    "tiny": (dict(), [17, 0, 40, 3], 16),
    "tiny10": (dict(), [17, 0, 40, 3, 56, 9, 1, 33, 0, 48], 16),
    "qwen": (dict(num_layers=2), [700, 0, 700, 2040], 128),
    "qwen16": (dict(num_layers=2), [700, 0, 700, 2040, 1, 300, 129, 1500,
                                    64, 0, 900, 2040, 17, 1024, 128, 5], 128),
}


def _mega_inputs(dev, shape, dtype, paged, ns, seed=0):
    """A model, a filled cache and a built multi-step call: returns
    ``(model, call, args)`` where ``call.run(*args)`` launches."""
    import dataclasses as dc

    from triton_distributed_tpu_torch.megakernel import MegaConfig, MegaQwen3
    from triton_distributed_tpu_torch.models import AutoLLM

    over, lens, page = MEGA_SHAPES[shape]
    qwen = shape.startswith("qwen")
    name = "Qwen/Qwen3-0.6B" if qwen else "tiny"
    s_max = 2048 if qwen else 64
    model = AutoLLM.from_pretrained(name, device=dev, seed=seed, dtype=dtype,
                                    max_length=s_max, **over)
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    b, L, hkv, hd = len(lens), cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    lens_np = np.asarray(lens)
    if paged:
        pps = s_max // page
        n_pages = b * pps + 1
        kc = _rand(rng, (L, n_pages, hkv, page, hd), dtype, dev)
        vc = _rand(rng, (L, n_pages, hkv, page, hd), dtype, dev)
        perm = rng.permutation(np.arange(1, n_pages))[: b * pps].reshape(
            b, pps)
        # Rows own the pages their ns new rows reach; the filler row
        # (kv_len 0) keeps a zeroed table row: the trash page.
        need = -(-(lens_np + ns) // page)
        table = np.where(np.arange(pps)[None] < need[:, None], perm, 0)
        table[lens_np == 0] = 0
        table = torch.from_numpy(table.astype(np.int32)).to(dev)
    else:
        kc = _rand(rng, (L, b, hkv, s_max, hd), dtype, dev)
        vc = _rand(rng, (L, b, hkv, s_max, hd), dtype, dev)
        table = None
    mega = MegaQwen3(model, cfg=MegaConfig(fuse_norms=True))
    dims = dc.replace(mega._dims(b, s_max, page if paged else 0),
                      nsteps=ns, v_real=cfg.vocab_size)
    kv_len = torch.from_numpy(lens_np.astype(np.int32)).to(dev)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, b).astype(
        np.int32)).to(dev)
    return model, mega, dims, (kc, vc, table, kv_len, tokens)


def _mega_run(mega, dims, args, stop_tok=None, plain=False, scales=None,
              w=None, samp=None):
    from triton_distributed_tpu_torch.megakernel import MegaWeights
    from triton_distributed_tpu_torch.megakernel.kernels import (
        mega_decode_plain,
    )

    compiled = mega._compile(dims)
    if w is None:
        w = MegaWeights.from_params(mega._step_params())
    kw = {**(scales or {}), **(samp or {})}
    if plain:
        return mega_decode_plain(dims, True, compiled.table, w, *args,
                                 stop_tok=stop_tok, **kw)
    return compiled.run(w, *args, stop_tok=stop_tok, **kw)


@pytest.mark.parametrize("ns", [1, 8])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("shape,dtype", [
    ("tiny", torch.float32), ("qwen", torch.float32),
    ("tiny", torch.bfloat16), ("qwen", torch.bfloat16),
    ("tiny10", torch.float32), ("tiny10", torch.bfloat16),
    ("qwen16", torch.float32),
])
def test_mega_decode_matches_plain(dev, shape, dtype, paged, ns):
    model, mega, dims, args = _mega_inputs(dev, shape, dtype, paged, ns)
    before = ck.MEGA_DECODE.launches
    got = _mega_run(mega, dims, args)
    torch.cuda.synchronize()
    assert ck.MEGA_DECODE.launches == before + 1
    again = _mega_run(mega, dims, args)
    ref = _mega_run(mega, dims, args, plain=True)
    logits, knew, vnew, toks, _ = got
    atol, rtol = MEGA_TOL[dtype]
    assert torch.isfinite(logits).all()
    # Two launches on the same inputs are bit-identical (no float atomics).
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert torch.equal(toks, ref[3]), (toks.tolist(), ref[3].tolist())
    err = (logits - ref[0]).abs()
    used = (err / (atol + rtol * ref[0].abs())).max().item()
    print(f"mega {shape} {dtype} paged={paged} ns={ns}: logits max err "
          f"{err.max().item():.3e}, {used:.3f} of the limit; knew max err "
          f"{(knew.float() - ref[1].float()).abs().max().item():.3e}")
    assert used <= 1.0
    for a, b in ((knew, ref[1]), (vnew, ref[2])):
        assert (a.float() - b.float()).abs().max().item() <= 2 * atol + 0.02


def _mega_quant_inputs(dev, shape, dtype, quant, ns):
    """``_mega_inputs`` over an int8 pool and/or with int8 weights: the
    random paged pool quantized per (page, kv head), its V pool first
    multiplied by 4 so that the K and V scale planes differ (the negative
    control swaps them); under wq8 the model's quantized weights."""
    import dataclasses as dc

    from triton_distributed_tpu_torch.megakernel import MegaConfig, MegaQwen3

    model, _, dims, (kc, vc, table, kv_len, tokens) = _mega_inputs(
        dev, shape, dtype, True, ns)
    scales = None
    if "pool" in quant:
        kc, ks = quantize_pages(kc.float())
        vc, vs = quantize_pages(vc.float() * 4)
        scales = {"k_scale": ks, "v_scale": vs}
        dims = dc.replace(dims, kv_quant=True)
    mega = MegaQwen3(model, cfg=MegaConfig(fuse_norms=True,
                                           wq8="wq8" in quant))
    return mega, dims, (kc, vc, table, kv_len, tokens), scales


# The int8 pool, int8 weights (wq8) and both: the same limits as the
# full-width kernel (an int8 code is exact in f32 and bf16, and each scale
# multiplies an f32 value), tokens equal, and a negative control that must
# break the logit limit: the plain version with the K and V scale planes
# swapped (pool variants) or with sc_qkv set to ones (wq8 alone).
@pytest.mark.parametrize("ns", [1, 8])
@pytest.mark.parametrize("quant", ["pool", "wq8", "wq8_pool"])
@pytest.mark.parametrize("shape,dtype", [
    ("tiny", torch.float32), ("tiny", torch.bfloat16),
    ("qwen", torch.float32), ("qwen", torch.bfloat16),
])
def test_mega_decode_quant_matches_plain(dev, shape, dtype, quant, ns):
    import dataclasses as dc

    from triton_distributed_tpu_torch.megakernel import MegaWeights

    mega, dims, args, scales = _mega_quant_inputs(dev, shape, dtype, quant,
                                                  ns)
    before = ck.MEGA_DECODE.launches
    got = _mega_run(mega, dims, args, scales=scales)
    torch.cuda.synchronize()
    assert ck.MEGA_DECODE.launches == before + 1
    again = _mega_run(mega, dims, args, scales=scales)
    ref = _mega_run(mega, dims, args, plain=True, scales=scales)
    logits, knew, vnew, toks, _ = got
    assert knew.dtype == dtype  # new rows leave in the model dtype
    atol, rtol = MEGA_TOL[dtype]
    assert torch.isfinite(logits).all()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    # Tokens equal; in bf16 a row may leave the plain stream only at a
    # near tie of the plain logits (within the logit limit's atol), as
    # chip_smoke.py's rule: later steps then decode other inputs, so the
    # logit and row checks keep the rows that agree before the last step.
    for b in (toks != ref[3]).any(dim=0).nonzero().flatten().tolist():
        assert dtype == torch.bfloat16, (toks.tolist(), ref[3].tolist())
        s = int((toks[:, b] != ref[3][:, b]).nonzero()[0])
        lg = _mega_run(mega, dc.replace(dims, nsteps=s + 1), args,
                       plain=True, scales=scales)[0][b]
        gap = (lg[ref[3][s, b]] - lg[toks[s, b]]).item()
        print(f"near tie: row {b} step {s} gap {gap:.4f}")
        assert 0 <= gap <= atol
    keep = (toks[:-1] == ref[3][:-1]).all(dim=0)
    used = ((logits - ref[0]).abs() / (atol + rtol * ref[0].abs()))[keep]
    for a, b in ((knew, ref[1]), (vnew, ref[2])):
        diff = (a.float() - b.float())[:, :, keep].abs().max().item()
        assert diff <= 2 * atol + 0.02
    if "pool" in quant:
        bad = _mega_run(mega, dims, args, plain=True, scales={
            "k_scale": scales["v_scale"], "v_scale": scales["k_scale"]})
    else:
        w = MegaWeights.from_params(mega._step_params())
        bad = _mega_run(mega, dims, args, plain=True, w=dc.replace(
            w, sc_qkv=torch.ones_like(w.sc_qkv)))
    bad_used = ((logits - bad[0]).abs() / (atol + rtol * bad[0].abs())).max()
    print(f"mega {quant} {shape} {dtype} ns={ns}: {used.max().item():.3f} "
          f"of the limit; negative control {bad_used.item():.1f}x")
    assert used.max().item() <= 1.0
    assert bad_used.item() > 1.0


def test_mega_quant_wrappers_reject_mismatched_operands(dev):
    """An int8 pool without its scales, scales without kv_quant, and wq8
    without int8 weights raise before any launch."""
    import dataclasses as dc

    from triton_distributed_tpu_torch.megakernel import MegaWeights

    mega, dims, args, scales = _mega_quant_inputs(dev, "tiny",
                                                  torch.float32, "wq8_pool", 1)
    before = ck.MEGA_DECODE.launches
    with pytest.raises(ValueError, match="kv_quant"):
        _mega_run(mega, dims, args)
    with pytest.raises(ValueError, match="kv_quant"):
        _mega_run(mega, dc.replace(dims, kv_quant=False), args,
                  scales=scales)
    with pytest.raises(ValueError, match="wq8"):
        _mega_run(mega, dims, args, scales=scales,
                  w=MegaWeights.from_params(mega.model.params))
    assert ck.MEGA_DECODE.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mega_decode_eos_matches_plain(dev, dtype):
    """The stop-token stamp: the first step whose token is the row's stop
    token, NS when it never comes, on the kernel as on the plain version."""
    _, mega, dims, args = _mega_inputs(dev, "tiny", dtype, True, 8, seed=1)
    toks = _mega_run(mega, dims, args, plain=True)[3].cpu().numpy()
    stop = np.full(toks.shape[1], -1, np.int32)
    stop[0] = toks[3, 0]  # row 0 stops at its first occurrence of this
    stop[2] = toks[0, 2]  # row 2 at step 0
    stop_t = torch.from_numpy(stop).to(dev)
    import dataclasses as dc

    dims = dc.replace(dims, eos=True)
    got = _mega_run(mega, dims, args, stop_tok=stop_t)
    ref = _mega_run(mega, dims, args, stop_tok=stop_t, plain=True)
    assert torch.equal(got[3], ref[3])
    assert torch.equal(got[4], ref[4])
    want = [int(np.argmax(toks[:, b] == stop[b])) if (toks[:, b] == stop[b])
            .any() else 8 for b in range(toks.shape[1])]
    assert got[4].tolist() == want


def _serve_card_and_cpu(dev, kv_dtype=None, wq8=False):
    """Tiny f32 through ``Engine(mode='mega', ns=4)`` (dense, or paged
    under ``kv_dtype``) and ``ContinuousEngine(mode='mega', ns=4)`` on the
    card and on the CPU: ``(gpu model, outputs, megakernel launches)``
    per device."""
    from triton_distributed_tpu_torch.megakernel import MegaConfig
    from triton_distributed_tpu_torch.models import (
        AutoLLM,
        ContinuousEngine,
        Engine,
    )

    gpu = AutoLLM.from_pretrained("tiny", device=dev, seed=0)
    cpu = AutoLLM.from_pretrained("tiny", device="cpu", seed=0)
    cpu.set_params(gpu.params)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, 20).astype(np.int32) for _ in range(3)]
    outs, launches = [], []
    cfg = MegaConfig(fuse_norms=True, wq8=wq8)
    for m, d in ((gpu, dev), (cpu, "cpu")):
        before = ck.MEGA_DECODE.launches
        dense = Engine(m, mode="mega", paged=kv_dtype is not None,
                       page_size=16, kv_dtype=kv_dtype, mega_cfg=cfg,
                       device=d).serve(np.stack(prompts), 11, 64, ns=4)
        eng = ContinuousEngine(m, max_batch=2, page_size=16, max_length=64,
                               prefix_cache=True, mode="mega", ns=4,
                               kv_dtype=kv_dtype, mega_cfg=cfg, device=d)
        toks = eng.run([(p, 9) for p in prompts])
        assert eng.audit() == []
        outs.append((dense, np.concatenate(toks)))
        launches.append(ck.MEGA_DECODE.launches - before)
    return gpu, outs, launches


def test_mega_serving_launches_the_kernel(dev):
    """Engine and ContinuousEngine in mode='mega' launch the megakernel
    for every decode step (multi launches and single-step remainders) and
    emit the plain version's tokens (tiny f32 on the card == CPU)."""
    gpu, outs, launches = _serve_card_and_cpu(dev)
    assert all(np.array_equal(a, b) for a, b in zip(*outs))
    assert launches[0] > 0 and launches[1] == 0
    with pytest.raises(ValueError, match="contiguous|dims|dtype"):
        from triton_distributed_tpu_torch.megakernel import MegaQwen3

        mega = MegaQwen3(gpu)
        cache = gpu.new_cache(2, 64)
        mega.decode_fn(2, 32)(gpu.params, torch.zeros(2, dtype=torch.int32),
                              cache)


@pytest.mark.parametrize("wq8", [False, True])
def test_mega_int8_serving_launches_the_kernel(dev, wq8):
    """The same over an int8 pool, with model or int8 weights."""
    _, outs, launches = _serve_card_and_cpu(dev, "int8", wq8)
    assert all(np.array_equal(a, b) for a, b in zip(*outs))
    assert launches[0] > 0 and launches[1] == 0


# -- the megakernel's sampled and filtered launches ----------------------------
#
# Sampled: the argmax over logits + noise (noise = T_b * gumbel, zero for
# greedy rows); filtered: over each row's top-k/top-p keep-set, found in
# the kernel by bisection (csrc/megakernel.cu `filtered_winner`). Held
# against the plain version on the same noise: logits and greedy-row
# tokens as in the greedy tests; a sampled row may leave the plain stream
# only where the plain logits allow the kernel's token: an exact filter
# over them may pick it (chip_smoke.filter_band: the keep-sets between the
# top-p cut at p·Z·(1 - 1e-5) and at p·Z·(1 + 1e-5), where summation order
# decides), or (bf16) its noisy score lies within MEGA_TIE below the plain
# winner's and, on a filtered row, its logit within MEGA_TIE below the
# plain keep-set's lowest.
# The filter alone: the kernel's last-step winner is an exact filter's
# over the kernel's own last-step logits and noise (filter_band); the
# top_k=1 row's winner is the argmax of the clean logits, while the
# unfiltered noisy argmax is not (negative control, at Qwen3 width where
# 151936 noisy columns make it certain); and with a large noise planted
# at the last step on each filtered row's lowest-logit token, the kernel
# still keeps the filter while the unfiltered argmax takes the planted
# token (chip_smoke._planted_control).
MEGA_TIE = 0.1
SAMPLED_ROWS = {
    "sampled": [(0.0, 1.0, 0), (0.8, 1.0, 0), (0.0, 1.0, 0), (0.8, 1.0, 0)],
    "filtered": [(0.0, 1.0, 0), (0.8, 1.0, 64), (1.0, 1.0, 1),
                 (0.8, 0.9, 0)],
}


def _sampling_operands(dims, rows, dev, seed=5):
    from triton_distributed_tpu_torch.models import sampling

    gen = torch.Generator(device=dev).manual_seed(seed)
    temps = torch.tensor([t for t, _, _ in rows], device=dev)
    noise = sampling.gumbel((dims.nsteps, dims.batch, dims.v_loc), gen,
                            dev) * temps[None, :, None]
    cfg = torch.tensor([sampling.sampcfg_row(*r, dims.v_real) for r in rows],
                       dtype=torch.float32, device=dev)
    return noise, cfg


@functools.cache
def _chip_smoke():
    """``chip_smoke.py``, for its sampling checks (``filter_band``,
    ``_planted_control``) and its collective kernels' table."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sampled_tokens_ok(toks, ref, plain_at, noise, cfg, v_real, bf16):
    """Rows whose kernel tokens leave the plain stream, each where an
    exact filter over the plain logits picks the kernel's token or at a
    near tie the plain version cannot resolve; raises otherwise."""
    from triton_distributed_tpu_torch.models import sampling

    ties = []
    for b in (toks != ref).any(dim=0).nonzero().flatten().tolist():
        s = int((toks[:, b] != ref[:, b]).nonzero()[0])
        lg = plain_at(s)
        band = _chip_smoke().filter_band(lg[b: b + 1], noise[s, b: b + 1],
                                         cfg[b: b + 1], v_real)[0]
        if int(toks[s, b]) in band["winners"]:
            ties.append(("exact filter", b, s, band["cuts"]))
            continue
        row = lg[b, :v_real]
        score = row + noise[s, b, :v_real]
        gap = (score[ref[s, b]] - score[toks[s, b]]).item()
        inv_t, k, p, en = cfg[b].tolist()
        edge = float("-inf")
        if en > 0:
            kept = torch.isfinite(sampling.filter_logits(
                row, 1.0 / inv_t, p, int(k) if k < v_real else 0))
            edge = (row[kept].min() - row[toks[s, b]]).item()
        assert bf16 and gap <= MEGA_TIE and edge <= MEGA_TIE, (b, s, gap,
                                                               edge)
        ties.append(("score", b, s, gap, edge))
    return ties


@pytest.mark.parametrize("ns", [1, 8])
@pytest.mark.parametrize("kind", ["sampled", "filtered"])
@pytest.mark.parametrize("shape,dtype", [
    ("tiny", torch.float32), ("tiny", torch.bfloat16),
    ("qwen", torch.float32), ("qwen", torch.bfloat16),
])
def test_mega_decode_sampled_matches_plain(dev, shape, dtype, kind, ns):
    import dataclasses as dc

    from triton_distributed_tpu_torch.models import sampling

    model, mega, dims, args = _mega_inputs(dev, shape, dtype, True, ns)
    rows = SAMPLED_ROWS[kind]
    filt = kind == "filtered"
    greedy_dims = dims
    dims = dc.replace(dims, sampled=True, filtered=filt)
    noise, cfg = _sampling_operands(dims, rows, dev)
    samp = {"noise": noise, "sampcfg": cfg if filt else None}
    before = ck.MEGA_DECODE.launches
    got = _mega_run(mega, dims, args, samp=samp)
    torch.cuda.synchronize()
    assert ck.MEGA_DECODE.launches == before + 1
    again = _mega_run(mega, dims, args, samp=samp)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    ref = _mega_run(mega, dims, args, plain=True, samp=samp)
    logits, toks = got[0], got[3]
    v_real = dims.v_real

    def plain_at(s):
        d1 = dc.replace(dims, nsteps=s + 1)
        return _mega_run(mega, d1, args, plain=True, samp={
            "noise": noise[: s + 1].contiguous(),
            "sampcfg": samp["sampcfg"]})[0]

    ties = _sampled_tokens_ok(toks, ref[3], plain_at, noise, cfg, v_real,
                              dtype == torch.bfloat16)
    # Greedy rows (zero noise) are the greedy launch's, bit for bit.
    greedy = _mega_run(mega, greedy_dims, args)[3]
    for b, (t, _, _) in enumerate(rows):
        if t == 0.0:
            assert torch.equal(toks[:, b], greedy[:, b])
    keep = (toks[:-1] == ref[3][:-1]).all(dim=0)
    atol, rtol = MEGA_TOL[dtype]
    err = (logits - ref[0]).abs()[keep]
    assert (err / (atol + rtol * ref[0].abs()[keep])).max().item() <= 1.0
    msg = f"mega {kind} {shape} {dtype} ns={ns}: near ties {ties}"
    if filt:
        # The filter alone, over the kernel's own last-step logits.
        from triton_distributed_tpu_torch.megakernel import MegaWeights

        smoke = _chip_smoke()
        want = sampling.filtered_winner_plain(logits, noise[-1], cfg, v_real)
        bands = smoke.filter_band(logits, noise[-1], cfg, v_real)
        differ = [b for b in range(dims.batch)
                  if int(toks[-1, b]) != int(want[b])]
        for b in range(dims.batch):
            assert int(toks[-1, b]) in bands[b]["winners"], (b, bands[b])
        clean = int(logits[2, :v_real].argmax())
        noisy = int((logits[2, :v_real] + noise[-1, 2, :v_real]).argmax())
        assert int(toks[-1, 2]) == clean  # top_k = 1: the clean argmax
        if shape == "qwen":
            assert noisy != clean  # the noise alone would move it
        planted = smoke._planted_control(
            mega._compile(dims), MegaWeights.from_params(mega._step_params()),
            args, noise, cfg, got, bands, v_real)
        assert 3 in planted["rows"] and not planted["bad"], planted
        msg += (f", filter alone: top-p band cuts "
                f"{[bd['cuts'] for bd in bands]}, differs from "
                f"filtered_winner_plain on rows {differ}, top_k=1 {clean} vs "
                f"{noisy}, planted control on rows {planted['rows']}")
    print(msg)


def test_mega_sampled_serving_launches_the_kernel(dev):
    """Sampled tiny serving through both engines in mode='mega' on the
    card: every decode step launches the kernel, filtered rounds run in
    it, and the same seed replays the same tokens."""
    from triton_distributed_tpu_torch.models import (
        AutoLLM,
        ContinuousEngine,
        Engine,
        Request,
    )

    model = AutoLLM.from_pretrained("tiny", device=dev, seed=0)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, 20).astype(np.int32) for _ in range(3)]
    outs = []
    for _ in range(2):
        before = ck.MEGA_DECODE.launches
        fixed = Engine(model, mode="mega", temperature=0.8, top_k=16,
                       seed=3, device=dev)
        dense = fixed.serve(np.stack(prompts), 11, 64, ns=4)
        assert fixed.last_stats["mega_filtered_rounds"] == 2
        eng = ContinuousEngine(model, max_batch=4, page_size=16,
                               max_length=64, mode="mega", ns=4,
                               temperature=0.8, top_p=0.9, seed=3,
                               device=dev)
        toks = eng.run([Request(prompts[0], 9, temperature=0.0),
                        Request(prompts[1], 9),
                        Request(prompts[2], 9, top_k=5)])
        assert eng.audit() == []
        assert eng.last_stats["mega_filtered_rounds"] > 0
        assert eng.last_stats["mega_fallback_steps"] == 0
        assert ck.MEGA_DECODE.launches > before
        outs.append((dense, np.concatenate(toks)))
    assert all(np.array_equal(a, b) for a, b in zip(*outs))


# -- the device task tracer, the work ring's RING_POLL, the prefill kernel ----
#
# A traced launch (a trace ring operand) computes what the untraced one
# does, bit for bit: tokens, logits, knew/vnew. Its ring decodes strictly
# (no gap) and validates against the scheduled order: every record begins
# before it ends, no record before the previous one ends, no consumer
# before its producer, and each ALLREDUCE's phase mark lies inside its
# record. A ring launch's RING_POLL records carry the published doorbell;
# validate_ring with another doorbell must report them.


def _ring_order(mega, dims):
    return mega._compile(dims).order


@pytest.mark.parametrize("ns", [1, 8])
@pytest.mark.parametrize("shape,dtype", [
    ("tiny", torch.float32), ("tiny", torch.bfloat16),
    ("qwen", torch.bfloat16),
])
def test_mega_decode_traced_matches_untraced(dev, shape, dtype, ns):
    import dataclasses as dc

    from triton_distributed_tpu_torch.megakernel.task import TaskType
    from triton_distributed_tpu_torch.obs import kernel_trace as kt

    _, mega, dims, args = _mega_inputs(dev, shape, dtype, True, ns)
    plain = _mega_run(mega, dims, args)
    tdims = dc.replace(dims, trace=True)
    before = (ck.MEGA_DECODE.launches, ck.MEGA_DECODE_TRACED.launches)
    got = _mega_run(mega, tdims, args)
    torch.cuda.synchronize()
    assert (ck.MEGA_DECODE.launches, ck.MEGA_DECODE_TRACED.launches) == (
        before[0], before[1] + 1)
    for a, b in zip(plain, got[:5]):
        assert torch.equal(a, b)
    ring = got[5].cpu().numpy()
    order = _ring_order(mega, tdims)
    assert ring.shape == (ns, len(order), 8)
    records = kt.decode_trace(ring)
    assert kt.validate_ring(records, order) == []
    ar = [r for r in records if r.opcode == int(TaskType.ALLREDUCE)]
    assert ar and all(r.begin <= r.mid <= r.end for r in ar)
    # The plain version's ring: the same header columns and flags (its
    # clock is logical).
    ref = _mega_run(mega, tdims, args, plain=True)[5].cpu().numpy()
    np.testing.assert_array_equal(ring[..., :4], ref[..., :4])
    np.testing.assert_array_equal(ring[..., 7], ref[..., 7])


@pytest.mark.parametrize("traced", [False, True])
def test_mega_ring_poll_stamps_the_doorbell(dev, traced):
    import dataclasses as dc

    from triton_distributed_tpu_torch.megakernel.task import TaskType
    from triton_distributed_tpu_torch.obs import kernel_trace as kt

    _, mega, dims, args = _mega_inputs(dev, "tiny", torch.float32, True, 4)
    plain = _mega_run(mega, dims, args)
    rdims = dc.replace(dims, ring=True, trace=traced)
    compiled = mega._compile(rdims)
    from triton_distributed_tpu_torch.megakernel import MegaWeights

    w = MegaWeights.from_params(mega._step_params())
    state = torch.tensor([7, 0, 2, 2], dtype=torch.int32, device=dev)
    got = compiled.run(w, *args, ring_state=state)
    for a, b in zip(plain, got[:5]):  # RING_POLL changes no output
        assert torch.equal(a, b)
    if not traced:
        return
    records = kt.decode_trace(got[5].cpu().numpy())
    polls = [r for r in records if r.opcode == int(TaskType.RING_POLL)]
    assert len(polls) == 4 and all(r.mid == 7 for r in polls)
    assert kt.validate_ring(records, compiled.order, doorbell=7) == []
    assert kt.validate_ring(records, compiled.order, doorbell=8)


# The prefill megakernel against its plain version on the same prompt:
# logits of row true_len - 1 and the K/V rows [0, true_len), f32 with TF32
# off within 2e-3 (summation order), bf16 within the decode kernel's
# MEGA_TOL; the wq8 build against its own plain version.
@pytest.mark.parametrize("wq8", [False, True])
@pytest.mark.parametrize("shape,dtype,S,true_len", [
    ("tiny", torch.float32, 16, 13), ("tiny", torch.bfloat16, 40, 37),
    ("qwen", torch.float32, 256, 250), ("qwen", torch.bfloat16, 256, 250),
])
def test_mega_prefill_matches_plain(dev, shape, dtype, S, true_len, wq8):
    import dataclasses as dc

    from triton_distributed_tpu_torch.megakernel import (
        MegaConfig,
        MegaQwen3,
        MegaWeights,
    )
    from triton_distributed_tpu_torch.megakernel.kernels import (
        mega_prefill_plain,
    )
    from triton_distributed_tpu_torch.models import AutoLLM

    over = MEGA_SHAPES[shape][0]
    name = "Qwen/Qwen3-0.6B" if shape == "qwen" else "tiny"
    model = AutoLLM.from_pretrained(name, device=dev, seed=0, dtype=dtype,
                                    max_length=2048 if shape == "qwen" else 64,
                                    **over)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, S).astype(
        np.int64)).to(dev)
    results = []
    for fuse in (False, True):
        mega = MegaQwen3(model, cfg=MegaConfig(fuse_norms=fuse, wq8=wq8))
        dims = dc.replace(mega._dims(S, S), prefill=True)
        compiled = mega._compile(dims)
        w = MegaWeights.from_params(mega._step_params())
        x0 = w.embed.index_select(0, toks)
        tl = torch.tensor([true_len], dtype=torch.int32, device=dev)
        before = ck.MEGA_PREFILL.launches
        got = compiled.run.prefill(w, x0, tl)
        torch.cuda.synchronize()
        assert ck.MEGA_PREFILL.launches == before + 1
        again = compiled.run.prefill(w, x0, tl)
        for a, b in zip(got, again):
            assert torch.equal(a, b)
        ref = mega_prefill_plain(dims, fuse, compiled.table, w, x0, tl)
        atol, rtol = MEGA_TOL[dtype]
        if dtype == torch.float32:
            atol, rtol = 2e-3, 0.0
        used = ((got[0] - ref[0]).abs() / (atol + rtol * ref[0].abs())).max()
        kv = max((a[:, :, :true_len].float() - b[:, :, :true_len].float())
                 .abs().max().item() for a, b in zip(got[1:], ref[1:]))
        print(f"mega_prefill {shape} {dtype} S={S} wq8={wq8} fuse={fuse}: "
              f"logits {used.item():.3f} of the limit, K/V max err {kv:.3e}")
        assert torch.isfinite(got[0]).all()
        assert used.item() <= 1.0
        assert kv <= 2 * atol + 0.02
        results.append(got[0])
    if dtype == torch.float32:  # fused and unfused norms compute alike
        assert (results[0] - results[1]).abs().max().item() <= 2e-3


def test_mega_prefill_rejects_what_the_kernel_does_not_take(dev):
    import dataclasses as dc

    from triton_distributed_tpu_torch.megakernel import MegaQwen3, MegaWeights
    from triton_distributed_tpu_torch.models import AutoLLM

    model = AutoLLM.from_pretrained("tiny", device=dev, seed=0)
    mega = MegaQwen3(model)
    dims = dc.replace(mega._dims(16, 16), prefill=True)
    run = mega._compile(dims).run
    w = MegaWeights.from_params(model.params)
    x0 = w.embed[:16].contiguous()
    before = ck.MEGA_PREFILL.launches
    with pytest.raises(ValueError, match="x0"):
        run.prefill(w, x0[:15], torch.tensor([3], dtype=torch.int32,
                                             device=dev))
    with pytest.raises(ValueError, match="true_len"):
        run.prefill(w, x0, torch.tensor([3], device=dev))
    assert ck.MEGA_PREFILL.launches == before


def test_mega_prefill_and_resident_serving_on_card_equal_cpu(dev):
    """Tiny f32 on the card and on the CPU: ``MegaQwen3.prefill`` then
    greedy dense mega decode; a resident, traced ContinuousEngine whose
    chained launch issues under ``torch.cuda.set_sync_debug_mode
    ("error")`` (no host sync between issue and drain), and whose rings
    validate against their doorbells."""
    from triton_distributed_tpu_torch.megakernel import MegaQwen3
    from triton_distributed_tpu_torch.models import (
        AutoLLM,
        ContinuousEngine,
    )
    from triton_distributed_tpu_torch.obs import kernel_trace as kt

    gpu = AutoLLM.from_pretrained("tiny", device=dev, seed=0)
    cpu = AutoLLM.from_pretrained("tiny", device="cpu", seed=0)
    cpu.set_params(gpu.params)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (20, 9, 30)]
    outs = []
    for m, d in ((gpu, dev), (cpu, "cpu")):
        mega = MegaQwen3(m)
        logits, cache = mega.prefill(prompts[0], m.new_cache(1, 64),
                                     true_len=17)
        tok = logits.argmax()[None].to(torch.int32)
        toks, _, cache = mega.decode_multi_fn(1, 64, 4)(m.params, tok, cache)
        eng = ContinuousEngine(m, max_batch=2, page_size=16, max_length=64,
                               mode="mega", ns=4, resident=True,
                               kernel_trace=True, device=d)
        issue = eng._issue_resident

        def strict_issue(chain, issue=issue, d=d):
            if torch.device(d).type != "cuda":
                return issue(chain)
            torch.cuda.set_sync_debug_mode("error")
            try:
                return issue(chain)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        eng._issue_resident = strict_issue
        got = eng.run([(p, 13) for p in prompts])
        assert eng.audit() == [] and eng._ring.occupancy == 0
        st = eng.last_stats
        assert st["mega_resident_rounds"] > 0, st
        for ln in eng.kernel_trace_launches():
            assert kt.validate_ring(ln.get_records(),
                                    doorbell=ln.doorbell) == []
        outs.append((int(tok), toks.cpu().numpy(), np.concatenate(got)))
    assert outs[0][0] == outs[1][0]
    for a, b in zip(outs[0][1:], outs[1][1:]):
        np.testing.assert_array_equal(a, b)


# -- the MoE megakernel -------------------------------------------------------
#
# tiny-moe in f32 (8 experts, top-2: the routing equal, tokens equal, logits
# within 2e-3) and a bf16 shape at Qwen3-30B-A3B's width with G = 8, 2
# layers, 16 experts, top-4 (chip_smoke._moe_rows_ok: the plain version
# routed as the kernel routed, each routing flip a near tie, every row
# within the bf16 limit).
MOE_SHAPES = {
    # preset, overrides, kv_len per row (0 = bucket filler), page, s_max
    "tiny-moe": ("tiny-moe", dict(), [17, 0, 40, 3], 16, 64),
    "moe16": ("Qwen/Qwen3-30B-A3B", dict(num_layers=2, num_experts=16,
                                          num_experts_per_tok=4),
              [700, 0, 700, 2040], 128, 2048),
}


def _moe_inputs(dev, shape, dtype, ns, overlap=True, int8=False, seed=0,
                **over):
    import dataclasses as dc

    from triton_distributed_tpu_torch.megakernel import (
        MegaConfig,
        MegaQwen3,
        MegaWeights,
    )
    from triton_distributed_tpu_torch.models import AutoLLM

    name, base, lens, page, s_max = MOE_SHAPES[shape]
    model = AutoLLM.from_pretrained(name, device=dev, seed=seed, dtype=dtype,
                                    max_length=s_max, **{**base, **over})
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    b, L, hkv, hd = len(lens), cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    lens_np = np.asarray(lens)
    pps = s_max // page
    n_pages = b * pps + 1
    kc = _rand(rng, (L, n_pages, hkv, page, hd), dtype, dev)
    vc = _rand(rng, (L, n_pages, hkv, page, hd), dtype, dev)
    perm = rng.permutation(np.arange(1, n_pages))[: b * pps].reshape(b, pps)
    need = -(-(lens_np + ns) // page)
    table = np.where(np.arange(pps)[None] < need[:, None], perm, 0)
    table[lens_np == 0] = 0
    table = torch.from_numpy(table.astype(np.int32)).to(dev)
    scales = {}
    if int8:
        kc, ks = quantize_pages(kc)
        vc, vs = quantize_pages(vc)
        scales = {"k_scale": ks, "v_scale": vs}
    mega = MegaQwen3(model, cfg=MegaConfig(
        fuse_norms=True, cross_prefetch=overlap, overlap_ar=overlap))
    dims = dc.replace(mega._dims(b, s_max, page, kv_quant=int8,
                                 num_pages=n_pages),
                      nsteps=ns, v_real=cfg.vocab_size)
    kv_len = torch.from_numpy(lens_np.astype(np.int32)).to(dev)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, b).astype(
        np.int32)).to(dev)
    w = MegaWeights.from_params(model.params)
    return model, mega, dims, w, (kc, vc, table, kv_len, tokens), scales


@pytest.mark.parametrize("ns", [1, 8])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("shape,dtype,int8", [
    ("tiny-moe", torch.float32, False), ("tiny-moe", torch.float32, True),
    ("moe16", torch.bfloat16, False), ("moe16", torch.bfloat16, True),
])
def test_mega_moe_matches_plain(dev, shape, dtype, int8, overlap, ns):
    from triton_distributed_tpu_torch.megakernel.kernels import (
        mega_decode_plain,
    )

    model, mega, dims, w, args, sc = _moe_inputs(dev, shape, dtype, ns,
                                                 overlap, int8)
    comp = mega._compile(dims)
    cfg = model.cfg
    route = torch.zeros((ns, cfg.num_layers, cfg.num_experts, dims.batch),
                        dtype=torch.float32, device=dev)
    x_rec = torch.zeros((ns, cfg.num_layers, dims.batch, dims.d),
                        dtype=torch.float32, device=dev)
    before = (ck.MEGA_DECODE.launches, ck.MEGA_DECODE_MOE.launches)
    got = comp.run(w, *args, **sc, moe_route=route, moe_x=x_rec)
    torch.cuda.synchronize()
    assert (ck.MEGA_DECODE.launches, ck.MEGA_DECODE_MOE.launches) == (
        before[0], before[1] + 1)
    again = comp.run(w, *args, **sc)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    atol, rtol = MEGA_TOL[dtype]
    assert torch.isfinite(got[0]).all()
    if dtype == torch.float32:
        # f32: the routing, the state at every gate, the tokens and the
        # logits of the plain version as it runs by itself.
        p_route, p_x = torch.zeros_like(route), torch.zeros_like(x_rec)
        ref = mega_decode_plain(dims, True, comp.table, w, *args, **sc,
                                moe_route=p_route, moe_x=p_x)
        assert torch.equal(route != 0, p_route != 0)
        assert (route - p_route).abs().max().item() < 1e-5
        assert (x_rec - p_x).abs().max().item() < 1e-3
        assert torch.equal(got[3], ref[3])
        assert ((got[0] - ref[0]).abs() / atol).max().item() <= 1.0
        return
    cs = _chip_smoke()
    forced = (route, x_rec, cfg.num_experts_per_tok, cfg.norm_topk_prob)
    log = cs._ForcedGate(*forced)
    ref = mega_decode_plain(dims, True, comp.table, w, *args, **sc,
                            gate_hook=log)

    def plain_at(s):
        import dataclasses as dc

        return mega_decode_plain(dc.replace(dims, nsteps=s + 1), True,
                                 comp.table, w, *args, **sc,
                                 gate_hook=cs._ForcedGate(*forced))[0]

    rows = cs._moe_rows_ok(got, ref, log, plain_at, atol, rtol,
                           f"{shape} ns={ns}")
    print(f"moe {shape} int8={int8} overlap={overlap} ns={ns}: "
          f"{ {key: v for key, v in rows.items() if key != 'ties'} }")


def test_mega_moe_skips_unrouted_experts(dev):
    """A batch routed to one expert (top-1 over a zero router: every
    probability ties, the lowest index wins): the other experts' weights
    are NaN, so only a kernel that skips them, barriers and all, stays
    finite; it equals the plain version, which skips them too."""
    from triton_distributed_tpu_torch.megakernel.kernels import (
        mega_decode_plain,
    )

    for overlap in (False, True):
        model, mega, dims, w, args, sc = _moe_inputs(
            dev, "tiny-moe", torch.float32, 4, overlap,
            num_experts_per_tok=1)
        mlp = model.params["layers"]["mlp"]
        mlp["w_router"].zero_()
        mlp["w1"][:, 1:] = float("nan")
        mlp["w2"][:, 1:] = float("nan")
        comp = mega._compile(dims)
        got = comp.run(w, *args)
        torch.cuda.synchronize()
        ref = mega_decode_plain(dims, True, comp.table, w, *args)
        assert torch.isfinite(got[0]).all() and torch.isfinite(ref[0]).all()
        assert torch.equal(got[3], ref[3])
        assert (got[0] - ref[0]).abs().max().item() <= MEGA_TOL[
            torch.float32][0]


@pytest.mark.parametrize("ns", [1, 8])
def test_mega_moe_traced_matches_untraced(dev, ns):
    import dataclasses as dc

    from triton_distributed_tpu_torch.megakernel.task import TaskType
    from triton_distributed_tpu_torch.obs import kernel_trace as kt

    model, mega, dims, w, args, _ = _moe_inputs(dev, "moe16",
                                                torch.bfloat16, ns)
    plain = mega._compile(dims).run(w, *args)
    tdims = dc.replace(dims, trace=True)
    comp = mega._compile(tdims)
    got = comp.run(w, *args)
    torch.cuda.synchronize()
    for a, b in zip(plain, got[:5]):
        assert torch.equal(a, b)
    records = kt.decode_trace(got[5].cpu().numpy())
    assert kt.validate_ring(records, comp.order) == []
    rep = kt.overlap_report(records)
    assert rep["a2a_windows"] == model.cfg.num_layers * ns
    a2a = [r for r in records
           if r.opcode in (int(TaskType.A2A_SEND), int(TaskType.A2A_WAIT))]
    assert a2a and all(r.begin <= r.mid <= r.end for r in a2a)


def test_mega_moe_serving_on_card_equals_cpu(dev):
    """tiny-moe f32 served on the card and on the CPU: ContinuousEngine in
    mode xla and mode mega (NS 4, the A2A combine, traced; the int8 pool
    too) emits the same tokens; the mega runs launch the MoE kernel."""
    from triton_distributed_tpu_torch.models import (
        AutoLLM,
        ContinuousEngine,
    )

    gpu = AutoLLM.from_pretrained("tiny-moe", device=dev, seed=0)
    cpu = AutoLLM.from_pretrained("tiny-moe", device="cpu", seed=0)
    cpu.set_params(gpu.params)
    rng = np.random.default_rng(12)
    reqs = [(rng.integers(0, 256, n).astype(np.int32), 9) for n in (20, 9, 30)]
    for kw in (dict(), dict(mode="mega", ns=4, kernel_trace=True),
               dict(mode="mega", ns=4, kv_dtype="int8")):
        outs = []
        for m, d in ((gpu, dev), (cpu, "cpu")):
            before = ck.MEGA_DECODE_MOE.launches
            eng = ContinuousEngine(m, max_batch=2, page_size=16,
                                   max_length=64, prefix_cache=True,
                                   device=d, **kw)
            outs.append(np.concatenate(eng.run(reqs)))
            assert eng.audit() == []
            if d == dev and kw:
                assert ck.MEGA_DECODE_MOE.launches > before
        np.testing.assert_array_equal(outs[0], outs[1])



# -- the cross-rank kernels over co-located ranks (tensor parallelism) ------
#
# Each kernel against its plain version on the same per-rank inputs. The
# GEMM sums in another order than cuBLAS: f32 (TF32 off) within 1e-4 +
# 1e-5·|p| of outputs of size ~1; bf16 rounds each rank's partial (and,
# in the ring, each hop's sum) to bf16, where a flip is one ulp, so the
# limit is n ulps: (2^-6 + 2^-7·|p|)·n.


def _tp_ok(got, want, dtype, n):
    atol, rtol = ((1e-4, 1e-5) if dtype == torch.float32
                  else (2.0**-6 * n, 2.0**-7 * n))
    err = (got.float() - want.float()).abs()
    return bool((err <= atol + rtol * want.float().abs()).all()), float(
        err.max())


def _tp_operands(dev, n, dtype, m, k, nout, seed, rows=False):
    """Per-rank A (column shards, or row shards with ``rows``) and B of
    unit-scale products."""
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    ctx = initialize_distributed(n, device=dev, dtype=dtype)
    rng = np.random.default_rng(seed)
    a = _rand(rng, (m, k), dtype, dev)
    b = (_rand(rng, (k, nout), torch.float32, dev) * k**-0.5).to(dtype)
    return ctx, (ctx.shard(a, 0) if rows else ctx.shard(a, 1)), (
        ctx.shard(b, 1) if rows else ctx.shard(b, 0))


TP_SHAPES = [(2, 8, 128, 256), (4, 8, 128, 256), (2, 4, 4096, 4096),
             (2, 48, 4096, 4096), (4, 32, 1024, 512)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,k,nout", TP_SHAPES)
def test_gemm_ar_one_shot_matches_plain(dev, dtype, n, m, k, nout):
    from triton_distributed_tpu_torch.ops.overlap import gemm_ar_plain
    from triton_distributed_tpu_torch.ops.overlap.gemm_ar import (
        gemm_ar_one_shot,
    )

    ctx, a, b = _tp_operands(dev, n, dtype, m, k, nout, seed=n + m)
    before = ck.GEMM_AR.launches
    got = gemm_ar_one_shot(a, b, ctx)
    want = gemm_ar_plain(a, b)
    torch.cuda.synchronize()
    assert ck.GEMM_AR.launches == before + 1
    for g in got[1:]:
        assert torch.equal(g, got[0])  # every rank bitwise the same
    ok, err = _tp_ok(got[0], want[0], dtype, n)
    assert ok, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("n,m,k,nout", [(2, 32, 128, 256), (4, 64, 256, 128),
                                        (2, 300, 2048, 4096),
                                        (4, 96, 512, 256)])
def test_gemm_rs_matches_plain(dev, dtype, bidir, n, m, k, nout):
    from triton_distributed_tpu_torch.ops.overlap import (
        GemmRSConfig,
        create_gemm_rs_context,
        gemm_rs_plain,
    )
    from triton_distributed_tpu_torch.ops.overlap.gemm_rs import (
        gemm_rs_ring,
        ring_split,
    )

    ctx, a, b = _tp_operands(dev, n, dtype, m, k, nout, seed=2 * n + m)
    cfg = create_gemm_rs_context(m, k // n, dtype, n_ranks=n, bidir=bidir)
    half = ring_split(m // n, cfg)
    assert bidir == (half < m // n) or m // n < 16
    got = gemm_rs_ring(a, b, ctx, half)
    want = gemm_rs_plain(a, b, half)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        ok, err = _tp_ok(g, w, dtype, n)
        assert ok, err
    assert isinstance(cfg, GemmRSConfig)


@pytest.mark.parametrize("bidir", [False, True])
def test_gemm_rs_kernel_follows_the_ring_order(dev, bidir):
    """Planted bf16 partials (rank r's = A_r, B_r = I): by a rank's ring
    position 256, 1, -256, 0. The ring rounds 256 + 1 back to 256 and
    ends at 0; a sum in rank order gives 1. The kernel must give 0."""
    from triton_distributed_tpu_torch.ops.overlap.gemm_rs import gemm_rs_ring
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    n, m_per, kl = 4, 16, 128
    half = 8 if bidir else m_per
    a = np.zeros((n * m_per, n * kl), np.float32)
    for r in range(n):
        for c in range(n):
            for i in range(m_per):
                s = (r - c - 1) % n if i < half else (c - 1 - r) % n
                a[c * m_per + i, r * kl] = (256.0, 1.0, -256.0, 0.0)[s]
    ctx = initialize_distributed(n, device=dev, dtype=torch.bfloat16)
    at = torch.from_numpy(a).to(dev, torch.bfloat16)
    b = torch.eye(kl, device=dev, dtype=torch.bfloat16).repeat(n, 1)
    got = torch.cat(gemm_rs_ring(ctx.shard(at, 1), ctx.shard(b, 0), ctx,
                                 half))
    assert (got[:, 0] == 0).all()
    assert (at.float().reshape(n * m_per, n, kl)[:, :, 0].sum(1) == 1).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,k,nout", [(2, 64, 128, 256), (4, 64, 64, 512),
                                        (2, 300, 4096, 6144),
                                        (4, 40, 256, 128)])
def test_ag_gemm_matches_plain(dev, dtype, n, m, k, nout):
    from triton_distributed_tpu_torch.ops.overlap import ag_gemm_plain
    from triton_distributed_tpu_torch.ops.overlap.ag_gemm import (
        ag_gemm_kernel,
    )

    ctx, a, b = _tp_operands(dev, n, dtype, m, k, nout, seed=3 * n + m,
                             rows=True)
    got, order = ag_gemm_kernel(a, b, ctx)
    want = ag_gemm_plain(a, b)
    torch.cuda.synchronize()
    assert order.tolist() == [[(r + s) % n for s in range(n)]
                              for r in range(n)]
    for g, w in zip(got, want):
        ok, err = _tp_ok(g, w, dtype, n)
        assert ok, err


# -- the options' builds: the adaptive ag_gemm, gemm_rs's narrow wire and
# one-rank ring, the traced gemm_ar. Each build's output equals the base
# build's bitwise where the arithmetic is the same (the adaptive order,
# the trace), or its plain version's: bitwise on integer-valued inputs
# (every f32 partial exact), else within the base limits plus, for the
# e4m3 wire, (n - 1) e4m3 ulps of the row's largest hop sum.


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,k,nout", [(2, 64, 128, 256), (4, 64, 64, 512),
                                        (2, 384, 4096, 6144),
                                        (4, 40, 256, 128)])
def test_ag_gemm_adaptive_matches_the_ring_build(dev, dtype, n, m, k, nout):
    from triton_distributed_tpu_torch.ops.overlap import ag_gemm_plain
    from triton_distributed_tpu_torch.ops.overlap.ag_gemm import (
        ag_gemm_kernel,
    )

    ctx, a, b = _tp_operands(dev, n, dtype, m, k, nout, seed=5 * n + m,
                             rows=True)
    before = ck.AG_GEMM_ADAPTIVE.launches
    got, order = ag_gemm_kernel(a, b, ctx, adaptive=True)
    ring, _ = ag_gemm_kernel(a, b, ctx)
    want = ag_gemm_plain(a, b)
    torch.cuda.synchronize()
    assert ck.AG_GEMM_ADAPTIVE.launches == before + 1
    for r in range(n):
        assert order[r, 0] == r
        assert sorted(order[r].tolist()) == list(range(n))
        assert torch.equal(got[r], ring[r])
        ok, err = _tp_ok(got[r], want[r], dtype, n)
        assert ok, err


def _launch_ms(fn, reps=5):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def test_ag_gemm_adaptive_defers_a_straggler(dev):
    """n = 4, Qwen3-8B's QKV at tp=4 (m_per 96, K 4096, n_loc 1536), rank 2
    lagging before its puts for at least 500 us and at least one whole
    un-lagged launch (so its chunk has not landed at any step boundary of
    the others): every other rank computes chunk 2 last. The ring build
    under the same lag, whose realized order comes back the same way,
    computes it at step 1 on rank 1 (the control the check must fail).
    Both outputs bitwise equal; the for_correctness delay changes nothing
    either."""
    from triton_distributed_tpu_torch.ops.overlap.ag_gemm import (
        ag_gemm_kernel,
    )

    n = 4
    ctx, a, b = _tp_operands(dev, n, torch.bfloat16, 384, 4096, 4 * 1536,
                             seed=11, rows=True)
    ns = max(500_000, int(1e6 * _launch_ms(lambda: ag_gemm_kernel(a, b, ctx))))
    lag = dict(straggler_rank=2, straggler_nanos=ns)
    got, order = ag_gemm_kernel(a, b, ctx, adaptive=True, **lag)
    ring, ring_order = ag_gemm_kernel(a, b, ctx, **lag)
    slow, _ = ag_gemm_kernel(a, b, ctx, adaptive=True, for_correctness=True)
    torch.cuda.synchronize()

    def deferred(rows):
        return all(rows[r][-1] == 2 for r in range(n) if r != 2)

    rows, ring_rows = order.tolist(), ring_order.tolist()
    assert deferred(rows), (rows, ns)
    assert ring_rows[1][1] == 2 and not deferred(ring_rows), ring_rows
    for r in range(n):
        assert torch.equal(got[r], ring[r]) and torch.equal(slow[r], ring[r])


def test_ag_gemm_adaptive_across_layouts_on_one_context(dev):
    """A fresh n = 4 context, adaptive launches at m_per 64, then 192, then
    256 (bf16, K 256, n_loc 128): the site's flag layout moves with m_per
    and its flags are never reset, so a slot that held anything but an
    epoch could pass a later launch's claim, publish or row-tile wait.
    Each launch is bitwise the ring build's, its order a permutation that
    starts with the own chunk."""
    from triton_distributed_tpu_torch.ops.overlap.ag_gemm import (
        ag_gemm_kernel,
    )
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    n, k, nl = 4, 256, 128
    ctx = initialize_distributed(n, device=dev, dtype=torch.bfloat16)
    rng = np.random.default_rng(23)
    b = ctx.shard((_rand(rng, (k, n * nl), torch.float32, dev)
                   * k**-0.5).to(torch.bfloat16), 1)
    for m_per in (64, 192, 256, 64, 192):
        a = ctx.shard(_rand(rng, (n * m_per, k), torch.bfloat16, dev), 0)
        got, order = ag_gemm_kernel(a, b, ctx, adaptive=True)
        ring, _ = ag_gemm_kernel(a, b, ctx)
        torch.cuda.synchronize()
        for r, row in enumerate(order.tolist()):
            assert row[0] == r and sorted(row) == list(range(n)), (m_per,
                                                                   row)
            assert torch.equal(got[r], ring[r]), m_per


def _e4m3_ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.clamp_min(2.0**-6))) - 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4])
def test_gemm_rs_e4m3_wire_matches_plain(dev, dtype, n):
    from triton_distributed_tpu_torch.ops.overlap import gemm_rs_plain
    from triton_distributed_tpu_torch.ops.overlap.gemm_rs import gemm_rs_ring
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    e4m3 = torch.float8_e4m3fn
    m, k, nout = 64 * n, 256 * n, 512
    ctx = initialize_distributed(n, device=dev, dtype=dtype)
    rng = np.random.default_rng(n)
    # Integer-valued: every partial exact in f32, so both sides round the
    # same hop sums (bitwise).
    ai = torch.from_numpy(rng.integers(-2, 3, (m, k)).astype(np.float32))
    bi = torch.from_numpy(rng.integers(-1, 2, (k, nout)).astype(np.float32))
    a, b = ctx.shard(ai.to(dev, dtype), 1), ctx.shard(bi.to(dev, dtype), 0)
    before = ck.GEMM_RS_WIRE_E4M3.launches
    got = gemm_rs_ring(a, b, ctx, 32, wire_dtype=e4m3)
    want = gemm_rs_plain(a, b, 32, e4m3)
    torch.cuda.synchronize()
    assert ck.GEMM_RS_WIRE_E4M3.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # Random: within (n-1) e4m3 ulps of the row's largest sum of |partial|
    # plus the base limit; the bf16 wire (control) differs.
    ctx, a, b = _tp_operands(dev, n, dtype, m, k, nout, seed=7 * n)
    got = gemm_rs_ring(a, b, ctx, 32, wire_dtype=e4m3)
    want = gemm_rs_plain(a, b, 32, e4m3)
    mp = m // n
    for c, (g, w) in enumerate(zip(got, want)):
        parts = sum((a[r][c * mp:(c + 1) * mp].float() @ b[r].float()).abs()
                    for r in range(n))
        lim = (n - 1) * _e4m3_ulp(parts.amax(1, keepdim=True))
        atol, rtol = ((1e-4, 1e-5) if dtype == torch.float32
                      else (2.0**-6 * n, 2.0**-7 * n))
        err = (g.float() - w.float()).abs()
        assert (err <= lim + atol + rtol * w.float().abs()).all()
    if dtype == torch.float32:
        narrow = gemm_rs_ring(a, b, ctx, 32, wire_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert not all(torch.equal(x, y) for x, y in zip(narrow, got))


@pytest.mark.parametrize("n", [2, 4])
def test_gemm_rs_e4m3_wire_overflow_is_nan(dev, n):
    """Planted first-hop sums of 448, 460, 464, 465 and -1000 (B = I, the
    other ranks' partials 0): 448, 448, 448, NaN, NaN, as the plain
    version (and the JAX cast) give, not torch's saturated 448."""
    from triton_distributed_tpu_torch.ops.overlap import gemm_rs_plain
    from triton_distributed_tpu_torch.ops.overlap.gemm_rs import gemm_rs_ring
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    planted = (448.0, 460.0, 464.0, 465.0, -1000.0)
    m_per, w = 40, 64
    a = np.zeros((n * m_per, n * w), np.float32)
    for c in range(n):
        for i in range(m_per):
            r = (c + 1) % n   # single ring: c + 1 opens chunk c's ring
            a[c * m_per + i, r * w:(r + 1) * w] = planted[i % 5]
    ctx = initialize_distributed(n, device=dev, dtype=torch.float32)
    at = ctx.shard(torch.from_numpy(a).to(dev), 1)
    b = ctx.shard(torch.eye(w, device=dev).repeat(n, 1), 0)
    got = gemm_rs_ring(at, b, ctx, m_per, wire_dtype=torch.float8_e4m3fn)
    want = gemm_rs_plain(at, b, m_per, torch.float8_e4m3fn)
    torch.cuda.synchronize()
    expect = torch.tensor([448.0, 448.0, 448.0, float("nan"), float("nan")],
                          device=dev).repeat(m_per // 5)
    for g, wt in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(wt))
        assert torch.equal(g.nan_to_num(7.0), wt.nan_to_num(7.0))
        assert torch.equal(g[:, 0].nan_to_num(7.0), expect.nan_to_num(7.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_rs_one_rank_ring(dev, dtype):
    """force_kernel at n = 1: the one-rank ring launches (its counter) and
    equals its plain version, bitwise on integer-valued inputs, within the
    base limit on random ones."""
    from triton_distributed_tpu_torch.ops.overlap import (
        GemmRSConfig,
        gemm_rs,
        gemm_rs_plain,
    )
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    ctx = initialize_distributed(1, device=dev, dtype=dtype)
    rng = np.random.default_rng(1)
    ai = torch.from_numpy(rng.integers(-2, 3, (384, 1024)).astype(np.float32))
    bi = torch.from_numpy(rng.integers(-1, 2, (1024, 512)).astype(np.float32))
    a, b = [ai.to(dev, dtype)], [bi.to(dev, dtype)]
    cfg = GemmRSConfig(force_kernel=True)
    before = ck.GEMM_RS_N1.launches
    got = gemm_rs(a, b, ctx, cfg)
    torch.cuda.synchronize()
    assert ck.GEMM_RS_N1.launches == before + 1
    assert torch.equal(got[0], gemm_rs_plain(a, b)[0])
    ctx, a, b = _tp_operands(dev, 1, dtype, 384, 1024, 512, seed=4)
    ok, err = _tp_ok(gemm_rs(a, b, ctx, cfg)[0], gemm_rs_plain(a, b)[0],
                     dtype, 1)
    assert ok, err


# -- the wgmma tile of ag_gemm's and gemm_rs's bf16 builds (m_per above
# SMALL_M): 64 x 128 tiles over 64-deep K slices. Its edges: a row tile
# that straddles the bidirectional split (half_m 96 at m_per 192, 75 at
# m_per 150), ragged m_per (150; 32 at n = 4), K only a multiple of 8 (64,
# 136: a slice of 8, 4096) and N not a multiple of 128. Each case against
# the plain version at the cross-rank limit; the ring's order and the
# e4m3 wire's overflow on planted values; integer inputs bitwise; the
# adaptive build bitwise the ring build; 100 launches back to back.


@pytest.mark.parametrize("n,m,k,nout,half", [
    (2, 384, 2 * 64, 392, 96), (2, 384, 2 * 4096, 4096, 96),
    (2, 300, 2 * 136, 520, 75), (2, 300, 2 * 4096, 4096, 75),
    (4, 128, 4 * 136, 264, 16), (4, 128, 4 * 4096, 520, 32)])
def test_gemm_rs_wgmma_tile_edges(dev, n, m, k, nout, half):
    from triton_distributed_tpu_torch.ops.overlap import gemm_rs_plain
    from triton_distributed_tpu_torch.ops.overlap.gemm_rs import gemm_rs_ring

    dt = torch.bfloat16
    ctx, a, b = _tp_operands(dev, n, dt, m, k, nout, seed=m + k + nout)
    before = ck.GEMM_RS.launches
    got = gemm_rs_ring(a, b, ctx, half)
    want = gemm_rs_plain(a, b, half)
    torch.cuda.synchronize()
    assert ck.GEMM_RS.launches == before + 1
    for g, w in zip(got, want):
        ok, err = _tp_ok(g, w, dt, n)
        assert ok, err


@pytest.mark.parametrize("n,m,k,n_loc", [
    (2, 300, 136, 200), (2, 300, 4096, 1000), (2, 384, 64, 392),
    (4, 128, 64, 72), (4, 128, 4096, 136)])
def test_ag_gemm_wgmma_tile_edges(dev, n, m, k, n_loc):
    """Both builds against the plain version; the adaptive one bitwise
    the ring one."""
    from triton_distributed_tpu_torch.ops.overlap import ag_gemm_plain
    from triton_distributed_tpu_torch.ops.overlap.ag_gemm import (
        ag_gemm_kernel,
    )

    dt = torch.bfloat16
    ctx, a, b = _tp_operands(dev, n, dt, m, k, n * n_loc, seed=m + k + n_loc,
                             rows=True)
    got, _ = ag_gemm_kernel(a, b, ctx)
    adaptive, order = ag_gemm_kernel(a, b, ctx, adaptive=True)
    want = ag_gemm_plain(a, b)
    torch.cuda.synchronize()
    for r in range(n):
        assert order[r, 0] == r and sorted(order[r].tolist()) == list(
            range(n))
        assert torch.equal(adaptive[r], got[r])
        ok, err = _tp_ok(got[r], want[r], dt, n)
        assert ok, err


@pytest.mark.parametrize("m_per,half", [(64, 32), (150, 75), (192, 192)])
def test_gemm_rs_wgmma_follows_the_ring_order(dev, m_per, half):
    """The planted partials of test_gemm_rs_kernel_follows_the_ring_order
    (256, 1, -256, 0 by ring position; the ring gives 0, rank order 1) on
    the wgmma tile, whose row tiles straddle the split at m_per 150."""
    from triton_distributed_tpu_torch.ops.overlap.gemm_rs import gemm_rs_ring
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    n, kl = 4, 128
    a = np.zeros((n * m_per, n * kl), np.float32)
    for r in range(n):
        for c in range(n):
            for i in range(m_per):
                s = (r - c - 1) % n if i < half else (c - 1 - r) % n
                a[c * m_per + i, r * kl] = (256.0, 1.0, -256.0, 0.0)[s]
    ctx = initialize_distributed(n, device=dev, dtype=torch.bfloat16)
    at = torch.from_numpy(a).to(dev, torch.bfloat16)
    b = torch.eye(kl, device=dev, dtype=torch.bfloat16).repeat(n, 1)
    got = torch.cat(gemm_rs_ring(ctx.shard(at, 1), ctx.shard(b, 0), ctx,
                                 half))
    assert (got[:, 0] == 0).all()
    assert (at.float().reshape(n * m_per, n, kl)[:, :, 0].sum(1) == 1).all()


@pytest.mark.parametrize("n", [2, 4])
def test_gemm_rs_wgmma_e4m3_overflow_is_nan(dev, n):
    """bf16 inputs at m_per 40 (the wgmma tile), planted first-hop sums of
    448, 460, 464, 466 and -1000 (bf16 holds no 465): 448, 448, 448, NaN,
    NaN, as the plain version gives."""
    from triton_distributed_tpu_torch.ops.overlap import gemm_rs_plain
    from triton_distributed_tpu_torch.ops.overlap.gemm_rs import gemm_rs_ring
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    planted = (448.0, 460.0, 464.0, 466.0, -1000.0)
    m_per, w = 40, 64
    a = np.zeros((n * m_per, n * w), np.float32)
    for c in range(n):
        for i in range(m_per):
            r = (c + 1) % n
            a[c * m_per + i, r * w:(r + 1) * w] = planted[i % 5]
    bf16 = torch.bfloat16
    ctx = initialize_distributed(n, device=dev, dtype=bf16)
    at = ctx.shard(torch.from_numpy(a).to(dev, bf16), 1)
    b = ctx.shard(torch.eye(w, device=dev, dtype=bf16).repeat(n, 1), 0)
    before = ck.GEMM_RS_WIRE_E4M3.launches
    got = gemm_rs_ring(at, b, ctx, m_per, wire_dtype=torch.float8_e4m3fn)
    want = gemm_rs_plain(at, b, m_per, torch.float8_e4m3fn)
    torch.cuda.synchronize()
    assert ck.GEMM_RS_WIRE_E4M3.launches == before + 1
    expect = torch.tensor([448.0, 448.0, 448.0, float("nan"), float("nan")],
                          device=dev).repeat(m_per // 5)
    for g, wt in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(wt))
        assert torch.equal(g.nan_to_num(7.0), wt.nan_to_num(7.0))
        assert torch.equal(g[:, 0].float().nan_to_num(7.0),
                           expect.nan_to_num(7.0))


@pytest.mark.parametrize("m,k,nout", [(150, 136, 520), (384, 4096, 392)])
def test_gemm_rs_wgmma_one_rank_ring_integer_bitwise(dev, m, k, nout):
    """The one-rank ring on the wgmma tile at ragged shapes: integer-valued
    bf16 inputs make every f32 partial exact, so the output is bitwise
    the plain version's."""
    from triton_distributed_tpu_torch.ops.overlap import (
        GemmRSConfig,
        gemm_rs,
        gemm_rs_plain,
    )
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    ctx = initialize_distributed(1, device=dev, dtype=torch.bfloat16)
    rng = np.random.default_rng(m + k)
    a = [torch.from_numpy(rng.integers(-2, 3, (m, k)).astype(
        np.float32)).to(dev, torch.bfloat16)]
    b = [torch.from_numpy(rng.integers(-1, 2, (k, nout)).astype(
        np.float32)).to(dev, torch.bfloat16)]
    before = ck.GEMM_RS_N1.launches
    got = gemm_rs(a, b, ctx, GemmRSConfig(force_kernel=True))
    torch.cuda.synchronize()
    assert ck.GEMM_RS_N1.launches == before + 1
    assert torch.equal(got[0], gemm_rs_plain(a, b)[0])


def test_ag_gemm_wgmma_adaptive_across_layouts_on_one_context(dev):
    """n = 2 at Qwen3-8B's K (4096) and a ragged n_loc (1000): adaptive
    launches at m_per 64, 192, 256 on one context, each bitwise the ring
    build's (the put tiles' flag layout moves with m_per)."""
    from triton_distributed_tpu_torch.ops.overlap.ag_gemm import (
        ag_gemm_kernel,
    )
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    n, k, nl = 2, 4096, 1000
    ctx = initialize_distributed(n, device=dev, dtype=torch.bfloat16)
    rng = np.random.default_rng(29)
    b = ctx.shard((_rand(rng, (k, n * nl), torch.float32, dev)
                   * k**-0.5).to(torch.bfloat16), 1)
    for m_per in (64, 192, 256):
        a = ctx.shard(_rand(rng, (n * m_per, k), torch.bfloat16, dev), 0)
        got, order = ag_gemm_kernel(a, b, ctx, adaptive=True)
        ring, _ = ag_gemm_kernel(a, b, ctx)
        torch.cuda.synchronize()
        assert order.tolist() == [[0, 1], [1, 0]], m_per
        for r in range(n):
            assert torch.equal(got[r], ring[r]), m_per


def test_wgmma_builds_stress_back_to_back(dev):
    """100 launches each of ag_gemm (both builds) and gemm_rs on the wgmma
    tile back to back, fresh inputs each, every output checked after one
    sync."""
    from triton_distributed_tpu_torch.ops.overlap import (
        ag_gemm_plain,
        gemm_rs_plain,
    )
    from triton_distributed_tpu_torch.ops.overlap.ag_gemm import (
        ag_gemm_kernel,
    )
    from triton_distributed_tpu_torch.ops.overlap.gemm_rs import gemm_rs_ring

    n, dt = 2, torch.bfloat16
    ctx, a, b = _tp_operands(dev, n, dt, 384, 1024, 520, seed=31)
    ctx2, ar, br = _tp_operands(dev, n, dt, 300, 512, 2 * 392, seed=37,
                                rows=True)
    kept = []
    for i in range(100):
        a = [t + 2.0**-5 for t in a]
        ar = [t - 2.0**-5 for t in ar]
        kept.append((a, ar, gemm_rs_ring(a, b, ctx, 96),
                     ag_gemm_kernel(ar, br, ctx2)[0],
                     ag_gemm_kernel(ar, br, ctx2, adaptive=True)[0]))
    torch.cuda.synchronize()
    for a, ar, g_rs, g_ag, g_ad in kept:
        for g, w in zip(g_rs, gemm_rs_plain(a, b, 96)):
            ok, err = _tp_ok(g, w, dt, n)
            assert ok, err
        for g, x, w in zip(g_ag, g_ad, ag_gemm_plain(ar, br)):
            assert torch.equal(g, x)
            ok, err = _tp_ok(g, w, dt, n)
            assert ok, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,k,nout,tile_n", [(2, 4, 4096, 4096, 512),
                                               (2, 4, 12288, 4096, 512),
                                               (4, 16, 256, 256, 64),
                                               (2, 40, 512, 384, 128)])
def test_gemm_ar_traced_ring(dev, dtype, n, m, k, nout, tile_n):
    """The traced one-shot: its ring bitwise the plain ring, decoded
    (strict=False) and valid, one window a column group a rank reshaped
    to one step; its outputs bitwise the untraced launch's."""
    from triton_distributed_tpu_torch.obs import kernel_trace as kt
    from triton_distributed_tpu_torch.ops.overlap import gemm_ar_ring_plain
    from triton_distributed_tpu_torch.ops.overlap.gemm_ar import (
        gemm_ar_one_shot,
        gemm_ar_traced,
    )

    ctx, a, b = _tp_operands(dev, n, dtype, m, k, nout, seed=9 * n + m)
    before = ck.GEMM_AR_TRACED.launches
    got, ring = gemm_ar_traced(a, b, ctx, tile_n)
    base = gemm_ar_one_shot(a, b, ctx)
    torch.cuda.synchronize()
    assert ck.GEMM_AR_TRACED.launches == before + 1
    num_j = nout // tile_n
    assert torch.equal(ring.cpu(), gemm_ar_ring_plain(n, num_j))
    recs = kt.decode_trace(ring.cpu().numpy(), strict=False)
    assert len(recs) == n * (2 * num_j + 1) and kt.validate_ring(recs) == []
    one = kt.decode_trace(ring.cpu().numpy().reshape(n, 1, -1, 8),
                          strict=False)
    assert kt.overlap_report(one)["windows"] == n * num_j
    for g, u in zip(got, base):
        assert torch.equal(g, u)


# The one-shot's builds at every row count the AUTO may give it (decode
# B, the 48-row chunks, odd M past 512 KB): bf16 runs the split-K
# mma.sync tile (16 rows up to SMALL_M, then 64), f32 the FMA tile; K
# 1000 a rank (a multiple of 8, not of 64: a split's last slice is
# zero-filled), N 1000 (a ragged last column tile).
AR_M = [1, 4, 5, 16, 17, 48, 64, 301]


def _ar_operands(ctx, dtype, m, k, nout, gen):
    """Per-rank column shards of A [m, k] and row shards of B [k, nout],
    unit-scale products, made on the card from ``gen``."""
    dev = ctx.device
    a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    b = (torch.randn((k, nout), generator=gen, device=dev)
         * k**-0.5).to(dtype)
    return ctx.shard(a, 1), ctx.shard(b, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("m", AR_M)
@pytest.mark.parametrize("k_loc", [1000, 2048, 6144])
@pytest.mark.parametrize("nout", [4096, 1000])
def test_gemm_ar_builds_at_every_m(dev, dtype, n, m, k_loc, nout):
    """Every rank bitwise the same and two launches bitwise the same (a
    tile's K atoms are summed in atom order, never by atomics), within
    the cross-rank limit of the plain version; at N 4096 the traced
    build's outputs bitwise the untraced launch's and its ring the plain
    ring."""
    from triton_distributed_tpu_torch.ops.overlap import (
        gemm_ar_plain,
        gemm_ar_ring_plain,
    )
    from triton_distributed_tpu_torch.ops.overlap.gemm_ar import (
        gemm_ar_one_shot,
        gemm_ar_traced,
    )
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    ctx = initialize_distributed(n, device=dev, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(m * 7 + k_loc + n)
    a, b = _ar_operands(ctx, dtype, m, k_loc * n, nout, gen)
    before = ck.GEMM_AR.launches
    got = gemm_ar_one_shot(a, b, ctx)
    again = gemm_ar_one_shot(a, b, ctx)
    want = gemm_ar_plain(a, b)
    torch.cuda.synchronize()
    assert ck.GEMM_AR.launches == before + 2
    for g, h in zip(got, again):
        assert torch.equal(g, got[0]) and torch.equal(h, got[0])
    ok, err = _tp_ok(got[0], want[0], dtype, n)
    assert ok, err
    if nout % 512 == 0:
        traced, ring = gemm_ar_traced(a, b, ctx, 512)
        torch.cuda.synchronize()
        for g in traced:
            assert torch.equal(g, got[0])
        assert torch.equal(ring.cpu(), gemm_ar_ring_plain(n, nout // 512))


def test_gemm_ar_rank_partial_dropped_breaks_the_limit(dev):
    """Control: the plain version with rank 1's partial zeroed leaves the
    cross-rank limit the kernel meets, at the decode o-proj shape."""
    from triton_distributed_tpu_torch.ops.overlap import gemm_ar_plain
    from triton_distributed_tpu_torch.ops.overlap.gemm_ar import (
        gemm_ar_one_shot,
    )
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    n, dt = 2, torch.bfloat16
    ctx = initialize_distributed(n, device=dev, dtype=dt)
    gen = torch.Generator(device=dev).manual_seed(3)
    a, b = _ar_operands(ctx, dt, 4, 4096, 4096, gen)
    got = gemm_ar_one_shot(a, b, ctx)
    assert _tp_ok(got[0], gemm_ar_plain(a, b)[0], dt, n)[0]
    dropped = gemm_ar_plain([a[0], torch.zeros_like(a[1])], b)
    ok, err = _tp_ok(got[0], dropped[0], dt, n)
    assert not ok and err > 0.1


def test_gemm_ar_across_layouts_on_one_context(dev):
    """M in {4, 48, 5} and K in {2048, 6144} a rank, alternating on one
    context, both builds: the flag site's layout (split and put flags)
    and the partials' scratch move with every launch, and a word left by
    an earlier layout must never pass a later launch's wait."""
    from triton_distributed_tpu_torch.ops.overlap import (
        gemm_ar_plain,
        gemm_ar_ring_plain,
    )
    from triton_distributed_tpu_torch.ops.overlap.gemm_ar import (
        gemm_ar_one_shot,
        gemm_ar_traced,
    )
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    n, dt = 2, torch.bfloat16
    ctx = initialize_distributed(n, device=dev, dtype=dt)
    gen = torch.Generator(device=dev).manual_seed(11)
    kept = []
    for _ in range(3):
        for m, k_loc in ((4, 2048), (48, 6144), (5, 2048), (4, 6144),
                         (48, 2048), (5, 6144)):
            a, b = _ar_operands(ctx, dt, m, k_loc * n, 4096, gen)
            kept.append((a, b, gemm_ar_one_shot(a, b, ctx),
                         gemm_ar_traced(a, b, ctx, 512)))
    torch.cuda.synchronize()
    for a, b, got, (traced, ring) in kept:
        want = gemm_ar_plain(a, b)[0]
        for g, t in zip(got, traced):
            assert torch.equal(g, got[0]) and torch.equal(t, got[0])
        ok, err = _tp_ok(got[0], want, dt, n)
        assert ok, err
        assert torch.equal(ring.cpu(), gemm_ar_ring_plain(n, 8))


@pytest.mark.parametrize("m,k_loc", [(4, 2048), (48, 6144)])
def test_gemm_ar_bits_do_not_depend_on_the_grid(dev, m, k_loc):
    """bf16, both builds at several blocks a rank: the atoms are the
    kernel's, not the grid's, so every launch gives the same bits."""
    from triton_distributed_tpu_torch.ops.overlap.gemm_ar import (
        gemm_ar_one_shot,
        gemm_ar_traced,
    )
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    n, dt = 2, torch.bfloat16
    ctx = initialize_distributed(n, device=dev, dtype=dt)
    gen = torch.Generator(device=dev).manual_seed(m + k_loc)
    a, b = _ar_operands(ctx, dt, m, k_loc * n, 4096, gen)
    want = gemm_ar_one_shot(a, b, ctx)[0]
    got = [gemm_ar_one_shot(a, b, ctx, blocks_per_rank=g)[0]
           for g in (1, 7, 64)]
    got += [gemm_ar_traced(a, b, ctx, 512, blocks_per_rank=g)[0][0]
            for g in (None, 3, 40)]
    torch.cuda.synchronize()
    for g in got:
        assert torch.equal(g, want)


@pytest.mark.parametrize("m", [4, 48])
def test_gemm_ar_bf16_back_to_back(dev, m):
    """100 bf16 launches back to back at Qwen3-8B's tp=2 o-proj, fresh
    inputs each, every output checked against the plain version."""
    from triton_distributed_tpu_torch.ops.overlap import gemm_ar_plain
    from triton_distributed_tpu_torch.ops.overlap.gemm_ar import (
        gemm_ar_one_shot,
    )
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    n, dt = 2, torch.bfloat16
    ctx = initialize_distributed(n, device=dev, dtype=dt)
    gen = torch.Generator(device=dev).manual_seed(17 + m)
    a, b = _ar_operands(ctx, dt, m, 4096, 4096, gen)
    kept = []
    for i in range(100):
        a = [t + 2.0**-4 for t in a]
        kept.append((a, gemm_ar_one_shot(a, b, ctx)))
    torch.cuda.synchronize()
    for a, got in kept:
        for g in got[1:]:
            assert torch.equal(g, got[0])
        ok, err = _tp_ok(got[0], gemm_ar_plain(a, b)[0], dt, n)
        assert ok, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m_per,cols", [(2, 8, 64), (4, 8, 64),
                                          (2, 150, 4096), (4, 3, 40)])
def test_all_gather_full_mesh_matches_plain(dev, dtype, n, m_per, cols):
    from triton_distributed_tpu_torch.ops.collectives import (
        all_gather_full_mesh,
        all_gather_plain,
    )
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    ctx = initialize_distributed(n, device=dev, dtype=dtype)
    rng = np.random.default_rng(n + m_per)
    xs = [_rand(rng, (m_per, cols), dtype, dev) for _ in range(n)]
    got = all_gather_full_mesh(xs, ctx)
    want = all_gather_plain(xs)
    torch.cuda.synchronize()
    for g in got:
        assert torch.equal(g, want[0])


@pytest.mark.parametrize("n,m,method", [(2, 48, "one_shot"),
                                         (2, 96, "two_shot"),
                                         (2, 640, "two_shot"),
                                         (4, 520, "two_shot"),
                                         (2, 641, "one_shot")])
def test_gemm_ar_auto_launches_a_kernel_at_every_size(dev, n, m, method):
    """gemm_ar's AUTO on the card, bf16 at N=4096: ONE_SHOT up to 512 KB
    of output; above it TWO_SHOT (gemm_rs, then the all-gather AUTO)
    when m % n == 0, also past the 4 MB (m > 512 rows) where the JAX
    AUTO hands over to XLA, else ONE_SHOT. Never the plain version: a
    kernel launches every time, and the output equals the plain version
    of the method taken, on every rank bitwise."""
    from triton_distributed_tpu_torch.ops.overlap import (
        gemm_ar,
        gemm_ar_plain,
        gemm_rs_plain,
    )

    dt = torch.bfloat16
    ctx, a, b = _tp_operands(dev, n, dt, m, 4096, 4096, seed=m)
    ck.reset_launch_counts()
    got = gemm_ar(a, b, ctx)
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    two = method == "two_shot"
    # TWO_SHOT's gather is the all-gather AUTO: the full mesh at n = 2,
    # the bidirectional ring at n = 4 (a shard over 64 KB).
    gather = "all_gather" if n == 2 else "all_gather_bidir_ring"
    assert counts["gemm_ar"] == int(not two)
    assert counts["gemm_rs"] == counts[gather] == int(two)
    want = torch.cat(gemm_rs_plain(a, b)) if two else gemm_ar_plain(a, b)[0]
    for g in got:
        assert torch.equal(g, got[0])
    ok, err = _tp_ok(got[0], want, dt, n)
    assert ok, err


def test_tp_kernels_refuse_a_grid_that_cannot_be_coresident(dev):
    """A cooperative grid larger than the card holds resident is refused
    before it launches (a spinning block would wait for one never
    scheduled); the default grid fits."""
    from triton_distributed_tpu_torch.ops.collectives import (
        all_gather_full_mesh,
    )
    from triton_distributed_tpu_torch.ops.overlap import _launch
    from triton_distributed_tpu_torch.ops.overlap.gemm_ar import (
        gemm_ar_one_shot,
    )

    ctx, a, b = _tp_operands(dev, 2, torch.bfloat16, 4, 256, 4096, seed=1)
    cap = _launch.capacity("gemm_ar", torch.bfloat16, True)
    before = ck.GEMM_AR.launches
    with pytest.raises(RuntimeError, match="cudaError"):
        gemm_ar_one_shot(a, b, ctx, blocks_per_rank=cap)
    assert ck.GEMM_AR.launches == before
    gemm_ar_one_shot(a, b, ctx, blocks_per_rank=cap // 2)
    from triton_distributed_tpu_torch.ops.collectives import _launch as coll

    cap_ag = coll.capacity(coll.ALL_GATHER, 0, torch.bfloat16)
    with pytest.raises(RuntimeError, match="cudaError"):
        all_gather_full_mesh(a, ctx, blocks_per_rank=cap_ag)
    torch.cuda.synchronize()


def test_tp_kernels_stress_back_to_back(dev):
    """100 launches of each kernel back to back, fresh inputs each, every
    output checked: a flag or epoch reused across launches would let a
    rank read a stale slot."""
    from triton_distributed_tpu_torch.ops.collectives import (
        all_gather_full_mesh,
    )
    from triton_distributed_tpu_torch.ops.overlap.ag_gemm import (
        ag_gemm_kernel,
    )
    from triton_distributed_tpu_torch.ops.overlap.gemm_ar import (
        gemm_ar_one_shot,
    )
    from triton_distributed_tpu_torch.ops.overlap.gemm_rs import gemm_rs_ring

    n, dt = 4, torch.float32
    ctx, a, b = _tp_operands(dev, n, dt, 32, 256, 128, seed=9)
    ctx2, ar, br = _tp_operands(dev, n, dt, 32, 64, 256, seed=10, rows=True)
    outs = []
    for i in range(100):
        a = [t + 0.01 * i for t in a]
        ar = [t - 0.01 * i for t in ar]
        outs.append((
            a, ar,
            gemm_ar_one_shot(a, b, ctx), gemm_rs_ring(a, b, ctx, 4),
            ag_gemm_kernel(ar, br, ctx2)[0], all_gather_full_mesh(ar, ctx2)))
    torch.cuda.synchronize()
    from triton_distributed_tpu_torch.ops.overlap import (
        ag_gemm_plain,
        gemm_ar_plain,
        gemm_rs_plain,
    )

    for a, ar, g_ar, g_rs, g_ag, g_all in outs:
        assert _tp_ok(g_ar[2], gemm_ar_plain(a, b)[0], dt, n)[0]
        for g, w in zip(g_rs, gemm_rs_plain(a, b, 4)):
            assert _tp_ok(g, w, dt, n)[0]
        for g, w in zip(g_ag, ag_gemm_plain(ar, br)):
            assert _tp_ok(g, w, dt, n)[0]
        assert torch.equal(g_all[3], torch.cat(ar))


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_serving_on_card_equals_cpu(dev, tp):
    """Tiny f32 at tp=2/4 in mode='pallas' on the card emits the CPU's
    tokens (the plain versions there) through both engines, and launches
    each kernel its path uses."""
    from triton_distributed_tpu_torch.models import (
        AutoLLM,
        ContinuousEngine,
        Engine,
    )
    from triton_distributed_tpu_torch.models.qwen import Qwen3

    src = AutoLLM.from_pretrained("tiny", device="cpu", seed=3)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, k).astype(np.int32) for k in (20, 41, 9)]
    ids = np.stack([prompts[0], prompts[1][:20]])
    outs, counts = [], []
    for d in (dev, "cpu"):
        m = Qwen3(src.cfg, device=d, tp=tp)
        m.set_params(src.params)
        ck.reset_launch_counts()
        res = []
        for pc in (False, True):
            eng = ContinuousEngine(m, max_batch=2, page_size=16,
                                   max_length=64, prefix_cache=pc,
                                   mode="pallas", device=d)
            res.append(np.concatenate(eng.run([(p, 8) for p in prompts])))
            assert eng.audit() == []
        res.append(Engine(m, mode="pallas", paged=True, page_size=16,
                          device=d).serve(ids, 7, 64))
        counts.append(ck.launch_counts())
        outs.append(res)
    assert all(np.array_equal(x, y) for x, y in zip(*outs))
    # The card's prefill runs ag_gemm (its adaptive build, the default on
    # the card) and gemm_rs, its decode and chunks gemm_ar; the CPU run
    # launches nothing.
    assert all(counts[0][k] > 0 for k in ("ag_gemm_adaptive", "gemm_rs",
                                          "gemm_ar"))
    assert sum(counts[1].values()) == 0


# -- the collectives (tensor-parallel MoE) -------------------------------------
#
# Each kernel against its plain version (the same order of sums and the
# same roundings) on the same per-rank inputs, with PR 10's limits: f32
# (TF32 off) 1e-4 + 1e-5·|p|, bf16 n·(2^-6 + 2^-7·|p|); the all-gathers
# move bytes and equal the shards. The ONE_SHOT all-reduce is bitwise the
# same on every rank; DOUBLING is held rank by rank.


def _coll(name):
    """(kernel launcher, plain version, counter) of a collective kernel:
    ``chip_smoke._coll_ops``'s pair."""
    fn, plain, _ = _chip_smoke()._coll_ops()[name]
    return fn, plain, getattr(ck, name.upper())


COLLECTIVE_KERNELS = ("all_reduce_one_shot", "all_reduce_doubling",
                      "reduce_scatter_one_shot", "reduce_scatter_ring",
                      "reduce_scatter_bidir_ring", "reduce_scatter_ring_hbm",
                      "all_gather_ring", "all_gather_bidir_ring")
# Per-rank rows at d = 2048 (the slice's shapes; an all-gather's are its
# shard) and a small case; the HBM ring's 1152 rows take 1 MB tiles.
COLLECTIVE_ROWS = {"all_reduce": (4, 112, 384), "reduce_scatter":
                   (48, 304, 1152), "all_gather": (192, 3)}


def _coll_inputs(dev, name, n, rows, dtype, seed):
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    ctx = initialize_distributed(n, device=dev, dtype=dtype)
    rng = np.random.default_rng(seed)
    if name.startswith("reduce_scatter"):
        rows = -(-rows // (2 * n)) * 2 * n  # n even chunks
    return ctx, [_rand(rng, (rows, 2048), dtype, dev) for _ in range(n)]


def _coll_check(name, got, want, dtype, n):
    if name.startswith("all_gather"):
        for g in got:
            assert torch.equal(g, want[0])
        return
    for g, w in zip(got, want):
        ok, err = _tp_ok(g, w, dtype, n)
        assert ok, (name, err)
    if name == "all_reduce_one_shot":
        for g in got[1:]:
            assert torch.equal(g, got[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", COLLECTIVE_KERNELS)
def test_collective_kernel_matches_plain(dev, name, n, dtype):
    fn, plain, counter = _coll(name)
    family = "_".join(name.split("_")[:2])
    for i, rows in enumerate(COLLECTIVE_ROWS[family]):
        ctx, xs = _coll_inputs(dev, name, n, rows, dtype, seed=n + i)
        before = counter.launches
        got = fn(xs, ctx)
        want = plain(xs)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        _coll_check(name, got, want, dtype, n)


@pytest.mark.parametrize("name", ["reduce_scatter_ring",
                                  "reduce_scatter_bidir_ring",
                                  "reduce_scatter_ring_hbm"])
def test_reduce_scatter_kernels_follow_the_ring_order(dev, name):
    """Planted bf16 partials, by a rank's position on the chunk's ring
    256, 1, -256, 0: the ring rounds 256 + 1 back to 256 and ends at 0; a
    sum in rank order gives 1. The kernel must give 0."""
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    fn, plain, _ = _coll(name)
    n, m_per = 4, 8
    half = m_per // 2 if "bidir" in name else m_per
    xs = np.zeros((n, n * m_per, 2048), np.float32)
    for r in range(n):
        for c in range(n):
            for i in range(m_per):
                s = (r - c - 1) % n if i < half else (c - 1 - r) % n
                xs[r, c * m_per + i, 0] = (256.0, 1.0, -256.0, 0.0)[s]
    ctx = initialize_distributed(n, device=dev, dtype=torch.bfloat16)
    ts = [torch.from_numpy(x).to(dev, torch.bfloat16) for x in xs]
    got = torch.cat(fn(ts, ctx))
    torch.cuda.synchronize()
    assert (got[:, 0] == 0).all()
    assert torch.equal(got, torch.cat(plain(ts)))
    assert (xs[:, :, 0].sum(0) == 1).all()


def test_collective_kernels_stress_back_to_back(dev):
    """100 launches of each collective kernel back to back at n = 4,
    fresh inputs each, every output checked after one sync."""
    n, dt = 4, torch.float32
    kept = {name: [] for name in COLLECTIVE_KERNELS}
    for name in COLLECTIVE_KERNELS:
        fn, _, _ = _coll(name)
        ctx, xs = _coll_inputs(dev, name, n, 32, dt, seed=1)
        for i in range(100):
            xs = [t + 0.01 * i for t in xs]
            kept[name].append((xs, fn(xs, ctx)))
    torch.cuda.synchronize()
    for name, runs in kept.items():
        _, plain, _ = _coll(name)
        for xs, got in runs:
            _coll_check(name, got, plain(xs), dt, n)


@pytest.mark.parametrize("method", ["ONE_SHOT", "DOUBLING", "TWO_SHOT"])
def test_all_reduce_straggler_lags_the_launch(dev, method):
    """A 500 µs straggler on rank 1: the launch (for TWO_SHOT its two
    kernels) takes at least the lag, and the sum is still right."""
    from triton_distributed_tpu_torch.ops.collectives import (
        AllReduceMethod,
        all_reduce,
        all_reduce_plain,
    )
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    n, dt = 4, torch.bfloat16
    ctx = initialize_distributed(n, device=dev, dtype=dt)
    rng = np.random.default_rng(2)
    xs = [_rand(rng, (64, 2048), dt, dev) for _ in range(n)]
    m = AllReduceMethod[method]
    all_reduce(xs, ctx, m)  # warm
    times = []
    for lag in (0, 500_000):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = all_reduce(xs, ctx, m, straggler_rank=1 if lag else None,
                         straggler_nanos=lag)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        want = all_reduce_plain(xs)
        for g in got:
            assert _tp_ok(g, want[0], dt, n)[0]
    assert times[1] >= 0.5, times


def test_collective_kernels_refuse_a_grid_that_cannot_be_coresident(dev):
    from triton_distributed_tpu_torch.ops.collectives import _launch

    for name, fam, kind in (("all_reduce_one_shot", _launch.ALL_REDUCE, 0),
                            ("reduce_scatter_ring", _launch.REDUCE_SCATTER, 1),
                            ("all_gather_ring", _launch.ALL_GATHER, 1)):
        fn, _, counter = _coll(name)
        ctx, xs = _coll_inputs(dev, name, 2, 16, torch.bfloat16, seed=0)
        cap = _launch.capacity(fam, kind, torch.bfloat16)
        before = counter.launches
        with pytest.raises(RuntimeError, match="cudaError"):
            fn(xs, ctx, blocks_per_rank=cap)
        assert counter.launches == before
        fn(xs, ctx, blocks_per_rank=cap // 2)
    torch.cuda.synchronize()


# (op, rows a rank at d = 2048 bf16, n, the kernels the AUTO launches):
# the JAX AUTO's picks on the slice's path (tests/test_torch_moe_tp.py
# holds the same table on the CPU), the indivisible row count included.
AUTO_CASES = [
    ("ar", 4, 2, ("all_reduce_one_shot",)),
    ("ar", 112, 2, ("all_reduce_doubling",)),
    ("ar", 384, 2, ("reduce_scatter_ring", "all_gather_ring")),
    ("ar", 1152, 2, ("reduce_scatter_ring_hbm", "all_gather_ring")),
    ("ar", 112, 4, ("all_reduce_doubling",)),
    ("ar", 384, 4, ("reduce_scatter_bidir_ring", "all_gather_bidir_ring")),
    ("ar", 385, 2, ("all_reduce_one_shot",)),
    ("rs", 48, 2, ("reduce_scatter_one_shot",)),
    ("rs", 300, 2, ("reduce_scatter_ring",)),
    ("rs", 1152, 2, ("reduce_scatter_ring_hbm",)),
    ("rs", 304, 4, ("reduce_scatter_bidir_ring",)),
    ("ag", 150, 2, ("all_gather",)),
    ("ag", 76, 4, ("all_gather_bidir_ring",)),
]


@pytest.mark.parametrize("op,rows,n,kernels", AUTO_CASES)
def test_collective_auto_launches_a_kernel_at_every_size(dev, op, rows, n,
                                                         kernels):
    from triton_distributed_tpu_torch.ops import collectives as col
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    dt = torch.bfloat16
    ctx = initialize_distributed(n, device=dev, dtype=dt)
    rng = np.random.default_rng(rows)
    xs = [_rand(rng, (rows, 2048), dt, dev) for _ in range(n)]
    fn, plain = {"ar": (col.all_reduce, col.all_reduce_plain),
                 "rs": (col.reduce_scatter, col.reduce_scatter_one_shot_plain),
                 "ag": (col.all_gather, col.all_gather_plain)}[op]
    ck.reset_launch_counts()
    got = fn(xs, ctx)
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    assert {k for k, v in counts.items() if v} == set(kernels)
    assert all(counts[k] == 1 for k in kernels)
    for g, w in zip(got, plain(xs)):
        assert _tp_ok(g, w, dt, n)[0] if op != "ag" else torch.equal(g, w)


@pytest.mark.parametrize("tp", [2, 4])
def test_moe_tp_serving_on_card_equals_cpu(dev, tp):
    """tiny-moe f32 at tp=2/4 on the card emits the CPU's tokens through
    both engines in modes pallas and xla; the card's pallas runs launch
    the collectives (one-shot all-reduce in decode and chunks, the
    reduce-scatter and all-gather in the sequence-sharded prefill)."""
    from triton_distributed_tpu_torch.models import (
        AutoLLM,
        ContinuousEngine,
        Engine,
        Qwen3MoE,
    )

    src = AutoLLM.from_pretrained("tiny-moe", device="cpu", seed=3)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, k).astype(np.int32) for k in (20, 41, 9)]
    ids = np.stack([prompts[0], prompts[1][:20]])
    for mode in ("pallas", "xla"):
        outs, counts = [], []
        for d in (dev, "cpu"):
            m = Qwen3MoE(src.cfg, device=d, tp=tp)
            m.set_params(src.params)  # the CPU draws, sharded
            ck.reset_launch_counts()
            res = []
            for pc in (False, True):
                eng = ContinuousEngine(m, max_batch=2, page_size=16,
                                       max_length=64, prefix_cache=pc,
                                       mode=mode, device=d)
                res.append(np.concatenate(eng.run([(p, 8) for p in prompts])))
                assert eng.audit() == []
            res.append(Engine(m, mode=mode, paged=True, page_size=16,
                              device=d).serve(ids, 7, 64))
            counts.append(ck.launch_counts())
            outs.append(res)
        assert all(np.array_equal(x, y) for x, y in zip(*outs))
        assert sum(counts[1].values()) == 0
        if mode == "pallas":
            assert all(counts[0][k] > 0 for k in (
                "all_reduce_one_shot", "reduce_scatter_one_shot",
                "all_gather"))


# -- the decode megakernel at tp > 1 -------------------------------------------
#
# mega_decode_tp (one cooperative launch over n co-located ranks, its
# exchanges in csrc/megakernel.cu) against its plain version
# (kernels.mega_decode_plain_tp: the ranks walked in lockstep) on the
# same per-rank weight shards, pool or cache shards and tokens: tiny at
# tp=2 and 4 (hkv_loc 2 and 1), dense and paged, NS 1 and 8, overlap_ar
# on and off. f32 (TF32 off): tokens equal, logits within 2e-3; bf16:
# MEGA_TOL, a token may leave the plain stream only at a near tie. Every
# rank's tokens and final residual are bitwise equal (each folds the same
# partials in rank order).


def _mega_tp_inputs(dev, tp, dtype, paged, ns, overlap=True, seed=0):
    """A tiny tp=n model on the card (the CPU draws, sharded), random
    per-rank cache shards, and a compiled multi-step call: returns
    ``(mega, dims, compiled, w, args)``."""
    import dataclasses as dc

    from triton_distributed_tpu_torch.megakernel import MegaConfig, MegaQwen3
    from triton_distributed_tpu_torch.megakernel.qwen3 import _weights
    from triton_distributed_tpu_torch.models import AutoLLM
    from triton_distributed_tpu_torch.models.qwen import Qwen3

    _over, lens, page = MEGA_SHAPES["tiny"]
    s_max = 64
    src = AutoLLM.from_pretrained("tiny", device="cpu", seed=seed,
                                  dtype=dtype, max_length=s_max)
    model = Qwen3(src.cfg, device=dev, tp=tp)
    model.set_params(src.params)
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    b, L, hkv, hd = len(lens), cfg.num_layers, cfg.num_kv_heads // tp, \
        cfg.head_dim
    lens_np = np.asarray(lens)
    if paged:
        pps = s_max // page
        n_pages = b * pps + 1
        shape = (L, n_pages, hkv, page, hd)
        perm = rng.permutation(np.arange(1, n_pages))[: b * pps].reshape(
            b, pps)
        need = -(-(lens_np + ns) // page)
        table = np.where(np.arange(pps)[None] < need[:, None], perm, 0)
        table[lens_np == 0] = 0
        table = torch.from_numpy(table.astype(np.int32)).to(dev)
    else:
        shape = (L, b, hkv, s_max, hd)
        table = None
    kc = [_rand(rng, shape, dtype, dev) for _ in range(tp)]
    vc = [_rand(rng, shape, dtype, dev) for _ in range(tp)]
    mega = MegaQwen3(model, cfg=MegaConfig(fuse_norms=True,
                                           overlap_ar=overlap))
    dims = dc.replace(mega._dims(b, s_max, page if paged else 0),
                      nsteps=ns, v_real=cfg.vocab_size)
    kv_len = torch.from_numpy(lens_np.astype(np.int32)).to(dev)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, b).astype(
        np.int32)).to(dev)
    return (mega, dims, mega._compile(dims), _weights(model.params),
            [kc, vc, table, kv_len, tokens])


def _mega_tp_plain(dims, compiled, w, args, **kw):
    from triton_distributed_tpu_torch.megakernel.kernels import (
        mega_decode_plain_tp,
    )

    info = {}
    out = mega_decode_plain_tp(dims, True, compiled.table, w, *args,
                               info=info, **kw)
    return out, info


def _mega_tp_check(got, ginfo, ref, dtype, n):
    """Kernel vs plain at tp=n: ranks bitwise equal, tokens (near ties
    only in bf16), logits within MEGA_TOL. Returns the limit's share."""
    logits, _k, _v, toks, _ = got
    assert torch.isfinite(logits).all()
    for r in range(1, n):
        assert torch.equal(ginfo["toks"][r], ginfo["toks"][0])
        assert torch.equal(ginfo["x"][r], ginfo["x"][0])
    if dtype == torch.float32:
        assert torch.equal(toks, ref[3]), (toks.tolist(), ref[3].tolist())
    else:
        _chip_smoke()._mega_tokens_ok(toks, ref[3], lambda s: ref[0])
    atol, rtol = MEGA_TOL[dtype]
    same = (toks == ref[3]).all(dim=0)
    err = (logits - ref[0]).abs()[same]
    return (err / (atol + rtol * ref[0].abs()[same])).max().item()


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("ns", [1, 8])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("tp,dtype", [
    (2, torch.float32), (4, torch.float32), (2, torch.bfloat16),
    (4, torch.bfloat16),
])
def test_mega_tp_matches_plain(dev, tp, dtype, paged, ns, overlap):
    mega, dims, compiled, w, args = _mega_tp_inputs(dev, tp, dtype, paged,
                                                    ns, overlap)
    before = ck.MEGA_DECODE_TP.launches
    info = {}
    got = compiled.run(w, *args, info=info)
    torch.cuda.synchronize()
    assert ck.MEGA_DECODE_TP.launches == before + 1
    assert info["blocks"] * tp <= info["blocks_per_sm"] * 132
    again = compiled.run(w, *args)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    ref, _ = _mega_tp_plain(dims, compiled, w, args)
    used = _mega_tp_check(got, info, ref, dtype, tp)
    print(f"mega tp={tp} {dtype} paged={paged} ns={ns} overlap={overlap}: "
          f"{used:.3f} of the limit")
    assert used <= 1.0


def test_mega_tp_straggler_and_back_to_back(dev):
    """A 500 µs lag on rank 1 leaves every output bit-identical and makes
    the launch at least 0.5 ms longer; then 20 launches back to back on
    fresh tokens, each equal to its plain version (a flag or slot reused
    across launches would let a rank fold a stale partial)."""
    import dataclasses as dc

    mega, dims, compiled, w, args = _mega_tp_inputs(dev, 2, torch.float32,
                                                    True, 8)
    lagged = mega._compile(dc.replace(dims, straggler_rank=1,
                                      straggler_nanos=500_000))

    def timed(c):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = c.run(w, *args)
        e1.record()
        torch.cuda.synchronize()
        return out, e0.elapsed_time(e1)

    timed(compiled), timed(lagged)  # warm
    base, t0 = timed(compiled)
    slow, t1 = timed(lagged)
    for a, b in zip(base, slow):
        assert torch.equal(a, b)
    assert t1 >= t0 + 0.5, (t0, t1)
    rng = np.random.default_rng(11)
    outs = []
    for _ in range(20):
        tok = torch.from_numpy(rng.integers(0, 256, 4).astype(np.int32)).to(
            dev)
        info = {}
        outs.append((tok, compiled.run(w, *args[:4], tok, info=info), info))
    torch.cuda.synchronize()
    for tok, got, info in outs:
        ref, _ = _mega_tp_plain(dims, compiled, w, args[:4] + [tok])
        assert _mega_tp_check(got, info, ref, torch.float32, 2) <= 1.0


def test_mega_tp_refuses_a_grid_that_cannot_be_coresident(dev):
    """n ranks of G blocks each must all be resident: G = the card's
    capacity at n = 2 is refused before it launches, half of it runs."""
    from triton_distributed_tpu_torch.megakernel.code_generator import (
        mega_decode_tp,
    )

    mega, dims, compiled, w, args = _mega_tp_inputs(dev, 2, torch.float32,
                                                    False, 1)
    info = {}
    compiled.run(w, *args, info=info)
    cap = info["blocks"] * 2
    before = ck.MEGA_DECODE_TP.launches
    with pytest.raises(RuntimeError, match="cudaError"):
        mega_decode_tp(dims, mega.cfg, compiled.run.table, w, *args,
                       mega.model.ctx, blocks_per_rank=cap)
    assert ck.MEGA_DECODE_TP.launches == before
    mega_decode_tp(dims, mega.cfg, compiled.run.table, w, *args,
                   mega.model.ctx, blocks_per_rank=cap // 4)
    torch.cuda.synchronize()
    assert ck.MEGA_DECODE_TP.launches == before + 1


@pytest.mark.parametrize("tp", [2, 4])
def test_mega_tp_serving_on_card_equals_cpu(dev, tp):
    """Tiny f32 at tp=2/4 in mode='mega' on the card emits the CPU's tokens
    through both engines (prefix cache, ns 4, eos; resident and traced),
    launching the tp megakernel; the traced rings validate per rank."""
    from triton_distributed_tpu_torch.models import (
        AutoLLM,
        ContinuousEngine,
        Engine,
    )
    from triton_distributed_tpu_torch.models.qwen import Qwen3
    from triton_distributed_tpu_torch.obs import kernel_trace as kt

    src = AutoLLM.from_pretrained("tiny", device="cpu", seed=3)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, k).astype(np.int32) for k in (20, 41, 9)]
    ids = np.stack([prompts[0], prompts[1][:20]])
    outs, counts = [], []
    for d in (dev, "cpu"):
        m = Qwen3(src.cfg, device=d, tp=tp)
        m.set_params(src.params)
        ck.reset_launch_counts()
        res = []
        kw = dict(max_batch=2, page_size=16, max_length=64, mode="mega",
                  ns=4, device=d)
        eng = ContinuousEngine(m, prefix_cache=True, eos_id=int(
            prompts[0][3]), **kw)
        res.append(np.concatenate(eng.run([(p, 9) for p in prompts])))
        assert eng.audit() == []
        res_eng = ContinuousEngine(m, resident=True, kernel_trace=True, **kw)
        res.append(np.concatenate(res_eng.run([(p, 9) for p in prompts])))
        for launch in res_eng.kernel_trace_launches():
            # One ring a rank, every record written, the same tasks.
            records = kt.decode_trace(launch.ring)
            ids_by_rank = [[(x.step, x.task_id) for x in records
                            if x.rank == r] for r in range(tp)]
            assert launch.ring.shape[0] == tp and ids_by_rank[0]
            assert all(i == ids_by_rank[0] for i in ids_by_rank)
        res.append(Engine(m, mode="mega", paged=True, page_size=16,
                          device=d).serve(ids, 7, 64, ns=4))
        res.append(Engine(m, mode="mega", device=d).serve(ids, 7, 64, ns=4))
        counts.append(ck.launch_counts())
        outs.append(res)
    assert all(np.array_equal(x, y) for x, y in zip(*outs))
    assert counts[0]["mega_decode_tp"] > 0
    assert sum(counts[1].values()) == 0


# -- the MoE megakernel at tp > 1 (expert-parallel) --------------------------
#
# The kTp instantiations of the MoE library against the plain EP walk
# (kernels.mega_decode_plain_tp) on the same per-rank operands: each rank's
# E/n experts (MegaQwen3.moe_params), its cache shard, its routing records.
# f32 (tiny-moe): the routing, the tokens and the logits of the plain
# version as it runs by itself, within MEGA_TOL; bf16 (Qwen3-30B-A3B width,
# 2 layers, 16 experts top-4): the plain version held to the kernel layer by
# layer (chip_smoke._ForcedGate, _moe_rows_ok). Every rank's records,
# tokens and final residual are bitwise equal.

MOE_TP_SHAPES = {"tiny-moe": MOE_SHAPES["tiny-moe"],
                 "moe16": MOE_SHAPES["moe16"]}


def _moe_tp_inputs(dev, shape, dtype, tp, ns, overlap=True, seed=0,
                   model=None):
    """A tp=n MoE model drawn on the card (the tp=1 draws, sharded),
    random per-rank pool shards and a compiled multi-step call: returns
    ``(model, mega, dims, compiled, w, args)``."""
    import dataclasses as dc

    from triton_distributed_tpu_torch.megakernel import MegaConfig, MegaQwen3
    from triton_distributed_tpu_torch.megakernel.qwen3 import _weights
    from triton_distributed_tpu_torch.models import AutoLLM

    name, base, lens, page, s_max = MOE_TP_SHAPES[shape]
    if model is None:
        model = AutoLLM.from_pretrained(name, device=dev, seed=seed,
                                        dtype=dtype, max_length=s_max,
                                        tp=tp, **base)
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    b, L, hkv, hd = len(lens), cfg.num_layers, cfg.num_kv_heads // tp, \
        cfg.head_dim
    lens_np = np.asarray(lens)
    pps = s_max // page
    n_pages = b * pps + 1
    kc = [_rand(rng, (L, n_pages, hkv, page, hd), dtype, dev)
          for _ in range(tp)]
    vc = [_rand(rng, (L, n_pages, hkv, page, hd), dtype, dev)
          for _ in range(tp)]
    perm = rng.permutation(np.arange(1, n_pages))[: b * pps].reshape(b, pps)
    need = -(-(lens_np + ns) // page)
    table = np.where(np.arange(pps)[None] < need[:, None], perm, 0)
    table[lens_np == 0] = 0
    table = torch.from_numpy(table.astype(np.int32)).to(dev)
    mega = MegaQwen3(model, cfg=MegaConfig(
        fuse_norms=True, cross_prefetch=overlap, overlap_ar=overlap))
    dims = dc.replace(mega._dims(b, s_max, page, num_pages=n_pages),
                      nsteps=ns, v_real=cfg.vocab_size)
    kv_len = torch.from_numpy(lens_np.astype(np.int32)).to(dev)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, b).astype(
        np.int32)).to(dev)
    return (model, mega, dims, mega._compile(dims),
            _weights(mega._step_params()), [kc, vc, table, kv_len, tokens])


def _moe_records(model, dims, tp, dev):
    cfg = model.cfg
    ns, L, b = dims.nsteps, cfg.num_layers, dims.batch
    return (torch.zeros((tp, ns, L, cfg.num_experts, b), dtype=torch.float32,
                        device=dev),
            torch.zeros((tp, ns, L, b, dims.d), dtype=torch.float32,
                        device=dev))


@pytest.mark.parametrize("ns", [1, 8])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("shape,dtype,tp", [
    ("tiny-moe", torch.float32, 2), ("tiny-moe", torch.float32, 4),
    ("moe16", torch.bfloat16, 2), ("moe16", torch.bfloat16, 4),
])
def test_mega_moe_tp_matches_plain(dev, shape, dtype, tp, overlap, ns):
    from triton_distributed_tpu_torch.megakernel.kernels import (
        mega_decode_plain_tp,
    )

    model, mega, dims, comp, w, args = _moe_tp_inputs(dev, shape, dtype, tp,
                                                      ns, overlap)
    route, x_rec = _moe_records(model, dims, tp, dev)
    before = (ck.MEGA_DECODE_TP.launches, ck.MEGA_DECODE_MOE_TP.launches)
    info = {}
    got = comp.run(w, *args, info=info, moe_route=route, moe_x=x_rec)
    torch.cuda.synchronize()
    assert (ck.MEGA_DECODE_TP.launches, ck.MEGA_DECODE_MOE_TP.launches) == (
        before[0], before[1] + 1)
    again = comp.run(w, *args)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    for r in range(1, tp):
        for t in (route, x_rec, info["toks"], info["x"]):
            assert torch.equal(t[r], t[0])
    assert torch.isfinite(got[0]).all()
    atol, rtol = MEGA_TOL[dtype]
    cfg = model.cfg
    if dtype == torch.float32:
        p_route, p_x = torch.zeros_like(route), torch.zeros_like(x_rec)
        ref = mega_decode_plain_tp(dims, True, comp.table, w, *args,
                                   moe_route=p_route, moe_x=p_x)
        assert torch.equal(route != 0, p_route != 0)
        assert (route - p_route).abs().max().item() < 1e-5
        assert (x_rec - p_x).abs().max().item() < 1e-3
        assert torch.equal(got[3], ref[3])
        assert ((got[0] - ref[0]).abs() / atol).max().item() <= 1.0
        if overlap:  # rank 1's phase-0 partial dropped at layer 0
            bad = mega_decode_plain_tp(dims, True, comp.table, w, *args,
                                       drop_partial=(0, 1, 0))[0]
            assert ((got[0] - bad).abs() / atol).max().item() > 1.0
        return
    cs = _chip_smoke()
    forced = (route[0], x_rec[0], cfg.num_experts_per_tok, cfg.norm_topk_prob)
    log = cs._ForcedGate(*forced)
    ref = mega_decode_plain_tp(dims, True, comp.table, w, *args,
                               gate_hook=log)

    def plain_at(s):
        import dataclasses as dc

        return mega_decode_plain_tp(dc.replace(dims, nsteps=s + 1), True,
                                    comp.table, w, *args,
                                    gate_hook=cs._ForcedGate(*forced))[0]

    rows = cs._moe_rows_ok(got, ref, log, plain_at, atol, rtol,
                           f"{shape} tp={tp} ns={ns}")
    print(f"moe tp={tp} {shape} overlap={overlap} ns={ns}: "
          f"{ {key: v for key, v in rows.items() if key != 'ties'} }")


def test_mega_moe_tp_straggler_and_back_to_back(dev):
    """A 500 µs lag on rank 1 (before its first exchange and its first
    phase-0 combine) leaves every output bit-identical and makes the launch
    at least 0.5 ms longer; then 20 launches back to back on fresh tokens,
    each equal to its plain version."""
    import dataclasses as dc

    from triton_distributed_tpu_torch.megakernel.kernels import (
        mega_decode_plain_tp,
    )

    model, mega, dims, comp, w, args = _moe_tp_inputs(
        dev, "tiny-moe", torch.float32, 2, 8)
    lagged = mega._compile(dc.replace(dims, straggler_rank=1,
                                      straggler_nanos=500_000))

    def timed(c):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = c.run(w, *args)
        e1.record()
        torch.cuda.synchronize()
        return out, e0.elapsed_time(e1)

    timed(comp), timed(lagged)  # warm
    base, t0 = timed(comp)
    slow, t1 = timed(lagged)
    for a, b in zip(base, slow):
        assert torch.equal(a, b)
    assert t1 >= t0 + 0.5, (t0, t1)
    rng = np.random.default_rng(11)
    outs = []
    for _ in range(20):
        tok = torch.from_numpy(rng.integers(0, 256, 4).astype(np.int32)).to(
            dev)
        info = {}
        outs.append((tok, comp.run(w, *args[:4], tok, info=info), info))
    torch.cuda.synchronize()
    atol = MEGA_TOL[torch.float32][0]
    for tok, got, info in outs:
        ref = mega_decode_plain_tp(dims, True, comp.table, w, *args[:4], tok)
        assert torch.equal(info["toks"][1], info["toks"][0])
        assert torch.equal(got[3], ref[3])
        assert (got[0] - ref[0]).abs().max().item() <= atol


@pytest.mark.parametrize("ns", [1, 8])
def test_mega_moe_tp_traced_matches_untraced(dev, ns):
    """A traced launch at Qwen3-30B-A3B width (2 layers, 16 experts, tp=2)
    equals the untraced one bit for bit; each rank's ring validates, with
    one A2A window per layer and step a rank and the phase marks inside
    their records."""
    import dataclasses as dc

    from triton_distributed_tpu_torch.megakernel.task import TaskType
    from triton_distributed_tpu_torch.obs import kernel_trace as kt

    model, mega, dims, comp, w, args = _moe_tp_inputs(
        dev, "moe16", torch.bfloat16, 2, ns)
    plain = comp.run(w, *args)
    tcomp = mega._compile(dc.replace(dims, trace=True))
    got = tcomp.run(w, *args)
    torch.cuda.synchronize()
    for a, b in zip(plain, got[:5]):
        assert torch.equal(a, b)
    ring = got[5].cpu().numpy()
    assert ring.shape[0] == 2
    records = kt.decode_trace(ring)
    assert kt.validate_ring(records, tcomp.order) == []
    rep = kt.overlap_report(records)
    assert rep["a2a_windows"] == model.cfg.num_layers * ns * 2
    a2a = [r for r in records
           if r.opcode in (int(TaskType.A2A_SEND), int(TaskType.A2A_WAIT))]
    assert a2a and all(r.begin <= r.mid <= r.end for r in a2a)


def test_mega_moe_tp_refuses_a_grid_that_cannot_be_coresident(dev):
    from triton_distributed_tpu_torch.megakernel.code_generator import (
        mega_decode_tp,
    )

    model, mega, dims, comp, w, args = _moe_tp_inputs(
        dev, "tiny-moe", torch.float32, 2, 1)
    info = {}
    comp.run(w, *args, info=info)
    cap = info["blocks"] * 2
    before = ck.MEGA_DECODE_MOE_TP.launches
    with pytest.raises(RuntimeError, match="cudaError"):
        mega_decode_tp(dims, mega.cfg, comp.run.table, w, *args,
                       model.ctx, blocks_per_rank=cap)
    assert ck.MEGA_DECODE_MOE_TP.launches == before
    mega_decode_tp(dims, mega.cfg, comp.run.table, w, *args, model.ctx,
                   blocks_per_rank=cap // 4)
    torch.cuda.synchronize()
    assert ck.MEGA_DECODE_MOE_TP.launches == before + 1


@pytest.mark.parametrize("tp", [2, 4])
def test_mega_moe_tp_serving_on_card_equals_cpu(dev, tp):
    """tiny-moe f32 at tp=2/4 in mode='mega' on the card emits the CPU's
    tokens through both engines (prefix cache, ns 4, eos; resident and
    traced; Engine dense and paged), launching the MoE tp megakernel."""
    from triton_distributed_tpu_torch.models import (
        AutoLLM,
        ContinuousEngine,
        Engine,
        Qwen3MoE,
    )

    gpu = AutoLLM.from_pretrained("tiny-moe", device=dev, seed=3, tp=tp)
    cpu = Qwen3MoE(gpu.cfg, device="cpu", tp=tp)
    cpu.set_params(gpu.params)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, k).astype(np.int32) for k in (20, 41, 9)]
    ids = np.stack([prompts[0], prompts[1][:20]])
    outs, counts = [], []
    for m, d in ((gpu, dev), (cpu, "cpu")):
        ck.reset_launch_counts()
        res = []
        kw = dict(max_batch=2, page_size=16, max_length=64, mode="mega",
                  ns=4, device=d)
        eng = ContinuousEngine(m, prefix_cache=True, eos_id=int(
            prompts[0][3]), **kw)
        res.append(np.concatenate(eng.run([(p, 9) for p in prompts])))
        assert eng.audit() == [] and eng.last_stats["a2a_dropped"] == 0
        res_eng = ContinuousEngine(m, resident=True, kernel_trace=True, **kw)
        res.append(np.concatenate(res_eng.run([(p, 9) for p in prompts])))
        res.append(Engine(m, mode="mega", paged=True, page_size=16,
                          device=d).serve(ids, 7, 64, ns=4))
        res.append(Engine(m, mode="mega", device=d).serve(ids, 7, 64, ns=4))
        counts.append(ck.launch_counts())
        outs.append(res)
    assert all(np.array_equal(x, y) for x, y in zip(*outs))
    assert counts[0]["mega_decode_moe_tp"] > 0
    assert counts[0]["mega_decode_tp"] == 0
    assert sum(counts[1].values()) == 0


# -- the prefill megakernel at tp > 1 -----------------------------------------
#
# mega_prefill_kernel's kTp instantiations against the plain lockstep walk
# (kernels.mega_prefill_plain_tp): row true_len - 1's logits (every rank's
# columns) and each rank's K/V rows [0, true_len), f32 within 2e-3, bf16
# within MEGA_TOL (K/V within twice its atol + 0.02, as at tp=1); the ranks'
# final residuals bitwise equal; a dropped partial breaks the f32 limit.

@pytest.mark.parametrize("shape,dtype,S,true_len,tp", [
    ("tiny", torch.float32, 16, 13, 2), ("tiny", torch.float32, 16, 13, 4),
    ("tiny", torch.bfloat16, 40, 37, 2), ("tiny", torch.bfloat16, 40, 37, 4),
    ("qwen8b", torch.float32, 256, 250, 2),
    ("qwen8b", torch.bfloat16, 256, 250, 2),
    ("qwen8b", torch.bfloat16, 256, 250, 4),
])
def test_mega_prefill_tp_matches_plain(dev, shape, dtype, S, true_len, tp):
    import dataclasses as dc

    from triton_distributed_tpu_torch.megakernel import MegaConfig, MegaQwen3
    from triton_distributed_tpu_torch.megakernel.kernels import (
        mega_prefill_plain_tp,
    )
    from triton_distributed_tpu_torch.megakernel.qwen3 import _weights
    from triton_distributed_tpu_torch.models import AutoLLM

    qwen = shape == "qwen8b"
    model = AutoLLM.from_pretrained(
        "Qwen/Qwen3-8B" if qwen else "tiny", device=dev, seed=0, dtype=dtype,
        max_length=512 if qwen else 64, tp=tp,
        **(dict(num_layers=2) if qwen else {}))
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, S).astype(
        np.int64)).to(dev)
    for fuse in (False, True):
        mega = MegaQwen3(model, cfg=MegaConfig(fuse_norms=fuse))
        dims = dc.replace(mega._dims(S, S), prefill=True)
        comp = mega._compile(dims)
        w = _weights(model.params)
        x0 = w[0].embed.index_select(0, toks)
        tl = torch.tensor([true_len], dtype=torch.int32, device=dev)
        before = (ck.MEGA_PREFILL.launches, ck.MEGA_PREFILL_TP.launches)
        info = {}
        got = comp.run.prefill(w, x0, tl, info=info)
        torch.cuda.synchronize()
        assert (ck.MEGA_PREFILL.launches, ck.MEGA_PREFILL_TP.launches) == (
            before[0], before[1] + 1)
        again = comp.run.prefill(w, x0, tl)
        for a, b in zip(got, again):
            assert torch.equal(a, b)
        for r in range(1, tp):
            assert torch.equal(info["x"][r], info["x"][0])
        ref = mega_prefill_plain_tp(dims, fuse, comp.table, w, x0, tl)
        atol, rtol = MEGA_TOL[dtype]
        if dtype == torch.float32:
            atol, rtol = 2e-3, 0.0
        used = ((got[0] - ref[0]).abs() / (atol + rtol * ref[0].abs())).max()
        kv = max((a[..., :true_len, :].float() - b[..., :true_len, :].float())
                 .abs().max().item() for a, b in zip(got[1:], ref[1:]))
        print(f"mega_prefill_tp {shape} tp={tp} {dtype} S={S} fuse={fuse}: "
              f"logits {used.item():.3f} of the limit, K/V max err {kv:.3e}")
        assert torch.isfinite(got[0]).all()
        assert used.item() <= 1.0
        assert kv <= 2 * atol + 0.02
        if dtype == torch.float32 and fuse:
            bad = mega_prefill_plain_tp(dims, fuse, comp.table, w, x0, tl,
                                        drop_partial=(0, 1))[0]
            assert ((got[0] - bad).abs() / atol).max().item() > 1.0


def test_mega_prefill_tp_serving_on_card_equals_cpu(dev):
    """Tiny f32 at tp=2 on the card and on the CPU: MegaQwen3.prefill (each
    rank's K/V into its shard), then greedy tp mega decode from that
    cache: the same logits within 2e-3 and the same tokens."""
    from triton_distributed_tpu_torch.megakernel import MegaQwen3
    from triton_distributed_tpu_torch.models import AutoLLM
    from triton_distributed_tpu_torch.models.qwen import Qwen3

    gpu = AutoLLM.from_pretrained("tiny", device=dev, seed=5, tp=2)
    cpu = Qwen3(gpu.cfg, device="cpu", tp=2)
    cpu.set_params(gpu.params)
    toks = np.random.default_rng(6).integers(0, 256, 24)
    res = []
    for m in (gpu, cpu):
        mega = MegaQwen3(m)
        cache = m.new_cache(1, 64)
        logits, cache = mega.prefill(toks, cache, true_len=21)
        tok = torch.argmax(logits).view(1).to(torch.int32)
        out, _, _ = mega.decode_multi_fn(1, 64, 8)(m.params, tok, cache)
        res.append((logits.cpu(), out.cpu()))
    assert (res[0][0] - res[1][0]).abs().max().item() <= 2e-3
    assert torch.equal(res[0][1], res[1][1])


# -- the dense all-to-all, the EP exchange, the SP attention -------------------


def _ctx(dev, n, dtype=torch.bfloat16):
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    return initialize_distributed(n, device=dev, dtype=dtype)


@pytest.mark.parametrize("shape,dtype", [
    ((3, 5), torch.float32),        # 20-byte rows, 60-byte chunks
    ((128, 2048), torch.bfloat16),  # Qwen3-30B-A3B's width, one EP chunk
    ((7, 129), torch.float32),
])
@pytest.mark.parametrize("n", [2, 4])
def test_all_to_all_kernel_bitwise_plain(dev, n, shape, dtype):
    from triton_distributed_tpu_torch.ops.collectives import (
        all_to_all,
        all_to_all_plain,
    )

    ctx = _ctx(dev, n, dtype)
    rng = np.random.default_rng(n)
    xs = [_rand(rng, (n * shape[0], shape[1]), dtype, dev) for _ in range(n)]
    before = ck.ALL_TO_ALL.launches
    got = all_to_all(xs, ctx)
    torch.cuda.synchronize()
    assert ck.ALL_TO_ALL.launches == before + 1
    for g, w in zip(got, all_to_all_plain(xs)):
        assert torch.equal(g, w)


# (name, splits[r][p] at n = 4 with capacity 64): a peer with 0 rows,
# counts not a multiple of 32, every row to one rank, all full.
EP_SPLITS = {
    "mixed": [[40, 0, 33, 1], [7, 64, 0, 0], [0, 5, 64, 31], [64, 64, 64, 64]],
    "one_rank": [[64, 0, 0, 0]] * 4,
    "empty": [[0, 0, 0, 0]] * 4,
    "full": [[64] * 4] * 4,
}


@pytest.mark.parametrize("case", list(EP_SPLITS))
@pytest.mark.parametrize("n", [2, 4])
def test_ep_exchange_kernel_matches_plain(dev, n, case):
    """Rows within every count bitwise the plain exchange's; every row
    past a count left as the output buffer held it (0xAB)."""
    from triton_distributed_tpu_torch.ops.moe.ep_exchange import (
        ep_exchange_kernel,
        ep_exchange_plain,
    )

    cap, r = 64, 384
    splits = np.array(EP_SPLITS[case], np.int32)[:n, :n]
    ctx = _ctx(dev, n)
    rng = np.random.default_rng(7)
    rows = [torch.from_numpy(rng.integers(0, 255, (n, cap, r),
                                          dtype=np.uint8)).to(dev)
            for _ in range(n)]
    sp = [torch.from_numpy(s.copy()).to(dev) for s in splits]
    rc = [torch.from_numpy(s.copy()).to(dev) for s in splits.T]
    out = [torch.full((n, cap, r), 0xAB, dtype=torch.uint8, device=dev)
           for _ in range(n)]
    before = ck.EP_EXCHANGE.launches
    got = ep_exchange_kernel(rows, sp, rc, ctx, out=out)
    want = ep_exchange_plain(rows, sp)
    torch.cuda.synchronize()
    assert ck.EP_EXCHANGE.launches == before + 1
    for p in range(n):
        for s in range(n):
            c = int(splits[s, p])
            assert torch.equal(got[p][s, :c], want[p][s, :c])
            assert (got[p][s, c:] == 0xAB).all()


def test_ep_exchange_straggler_and_back_to_back(dev):
    """A 500 us lag on rank 1 makes the launch last >= 0.5 ms with the
    same rows; 20 launches back to back with fresh counts, each right."""
    from triton_distributed_tpu_torch.ops.moe.ep_exchange import (
        ep_exchange_kernel,
        ep_exchange_plain,
    )

    n, cap, r = 4, 64, 256
    ctx = _ctx(dev, n)
    rng = np.random.default_rng(8)
    kept = []
    for i in range(20):
        splits = rng.integers(0, cap + 1, (n, n)).astype(np.int32)
        rows = [torch.from_numpy(rng.integers(0, 255, (n, cap, r),
                                              dtype=np.uint8)).to(dev)
                for _ in range(n)]
        sp = [torch.from_numpy(s.copy()).to(dev) for s in splits]
        rc = [torch.from_numpy(s.copy()).to(dev) for s in splits.T]
        kept.append((splits, rows, sp, ep_exchange_kernel(rows, sp, rc, ctx)))
    torch.cuda.synchronize()
    for splits, rows, sp, got in kept:
        want = ep_exchange_plain(rows, sp)
        for p in range(n):
            for s in range(n):
                c = int(splits[s, p])
                assert torch.equal(got[p][s, :c], want[p][s, :c])
    splits, rows, sp, _ = kept[-1]
    rc = [torch.from_numpy(s.copy()).to(dev) for s in splits.T]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    times, outs = [], []
    for lag in (0, 500_000):
        def launch(lag=lag):
            return ep_exchange_kernel(rows, sp, rc, ctx,
                                      straggler_rank=1 if lag else None,
                                      straggle_nanos=lag)
        outs.append(launch())
        # chip_smoke.check_ep's reading: warm-up launches, then the median
        # of 5 device-timed launches, each behind a spin kernel.
        times.append(_chip_smoke().median_ms(launch, flush, iters=5,
                                             warmup=2))
    assert times[1] - times[0] >= 0.5, times
    for p in range(n):
        for s in range(n):
            c = int(splits[s, p])
            assert torch.equal(outs[0][p][s, :c], outs[1][p][s, :c])


# ep_moe_ffn on the card (bf16) against the CPU's f32 run on the same
# bf16-rounded inputs, routed alike (f32 router logits on both): max
# |card - cpu| over max |cpu|, at most EP_CARD_REL. The card rounds each
# expert GEMM, the SiLU product and the token to bf16 (and the fp8
# payload's dequantized rows), a few 2^-9 of the output's scale; a zeroed
# or a shifted output reads ~1.
EP_CARD_REL = 2.0**-5


def _ep_card_outputs(dev, n, cf, skew, payload):
    """``{(where, method): outputs}`` of ``ep_moe_ffn`` at a small MoE
    (16 experts top-4, d 256, f 128, 32 tokens a rank): on the card with
    both transports (each checked to launch the EP exchange twice or not
    at all), on the CPU with the plain one. ``skew``: positive tokens and
    +-1 on the router columns of rank 0's experts, so every top-k lands
    on rank 0 (+-1 keeps the columns distinct in bf16)."""
    from triton_distributed_tpu_torch.ops.moe import ep_moe_ffn

    e, d, f, k, t = 16, 256, 128, 4, 32
    rng = np.random.default_rng(n + 10 * skew)
    x = np.abs(rng.standard_normal((n * t, d))) * 0.1 if skew else \
        rng.standard_normal((n * t, d)) * 0.1
    wr = rng.standard_normal((d, e)) * 0.1
    if skew:
        wr[:, :e // n] += 1.0
        wr[:, e // n:] -= 1.0
    w1 = rng.standard_normal((e, d, 2 * f)) * 0.1
    w2 = rng.standard_normal((e, f, d)) * 0.1
    epr = e // n
    outs = {}
    for where, dt in ((dev, torch.bfloat16), ("cpu", torch.float32)):
        ctx = _ctx(where, n, dt)
        cast = lambda a: torch.from_numpy(a.astype(np.float32)).to(  # noqa: E731
            torch.bfloat16).to(where, dt)
        xs = list(torch.chunk(cast(x), n))
        for method in (("pallas", "xla") if where == dev else ("xla",)):
            before = ck.EP_EXCHANGE.launches
            outs[(where, method)] = ep_moe_ffn(
                xs, cast(wr), [cast(w1[i * epr:(i + 1) * epr])
                               for i in range(n)],
                [cast(w2[i * epr:(i + 1) * epr]) for i in range(n)], k,
                ctx=ctx, method=method, capacity_factor=cf,
                payload_dtype=payload)
            if where == dev:
                torch.cuda.synchronize()
                assert ck.EP_EXCHANGE.launches == before + (
                    2 if method == "pallas" else 0)
    return outs


def _ep_card_rel(got, want) -> float:
    """max |got - want| over max |want|, over every rank's rows."""
    g = torch.cat([a.float().cpu() for a in got])
    w = torch.cat(list(want))
    return float((g - w).abs().max() / w.abs().max())


@pytest.mark.parametrize("payload", [None, "fp8"])
@pytest.mark.parametrize("cf,skew", [(None, False), (1.25, False),
                                     (None, True), (1.0, True)])
@pytest.mark.parametrize("n", [2, 4])
def test_ep_moe_ffn_transports_bitwise_on_card(dev, n, cf, skew, payload):
    """``ep_moe_ffn`` with the kernel transport equals the plain one bit
    for bit (bf16), launches the EP exchange twice, and lies within
    EP_CARD_REL of the CPU's f32 run; a zeroed and a row-shifted output
    break that limit."""
    outs = _ep_card_outputs(dev, n, cf, skew, payload)
    for a, b in zip(outs[(dev, "pallas")], outs[(dev, "xla")]):
        assert torch.equal(a, b)
    got, want = outs[(dev, "pallas")], outs[("cpu", "xla")]
    rel = _ep_card_rel(got, want)
    assert rel <= EP_CARD_REL, rel
    assert _ep_card_rel([torch.zeros_like(a) for a in got], want) > \
        EP_CARD_REL
    assert _ep_card_rel([torch.roll(a, 1, dims=0) for a in got], want) > \
        EP_CARD_REL


# (n, hq, hkv, s_loc, dtype): G 1, 2, 4, 8; n 2, 3, 4; s_loc a multiple of
# every q tile, and not (100, 72, 37, 1000, 4100: the bf16 items are 128 /
# G rows a head, the key tiles 64).
SP_CASES = [
    (2, 8, 8, 128, torch.bfloat16), (4, 8, 4, 100, torch.bfloat16),
    (2, 16, 4, 72, torch.bfloat16), (4, 32, 4, 96, torch.bfloat16),
    (3, 8, 8, 1000, torch.bfloat16), (2, 16, 8, 1000, torch.bfloat16),
    (4, 16, 4, 1000, torch.bfloat16), (3, 16, 2, 4100, torch.bfloat16),
    (4, 8, 2, 37, torch.float32), (2, 32, 8, 64, torch.float32),
    (2, 8, 1, 50, torch.float32), (4, 4, 4, 33, torch.float32),
    (3, 8, 4, 37, torch.float32),
]


def _sp_inputs(dev, n, hq, hkv, s_loc, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return ([_rand(rng, (hq, s_loc, 128), dtype, dev) for _ in range(n)],
            [_rand(rng, (hkv, s_loc, 128), dtype, dev) for _ in range(n)],
            [_rand(rng, (hkv, s_loc, 128), dtype, dev) for _ in range(n)])


@pytest.mark.parametrize("n,hq,hkv,s_loc,dtype", SP_CASES)
def test_sp_ag_attention_kernel_matches_plain(dev, n, hq, hkv, s_loc, dtype):
    from triton_distributed_tpu_torch.ops.attention.sp_ag_attention import (
        sp_ag_attention,
        sp_ag_attention_plain,
    )

    ctx = _ctx(dev, n, dtype)
    qs, ks, vs = _sp_inputs(dev, n, hq, hkv, s_loc, dtype)
    before = ck.SP_AG_ATTENTION.launches
    o, lse = sp_ag_attention(qs, ks, vs, ctx, return_lse=True)
    po, plse = sp_ag_attention_plain(qs, ks, vs)
    torch.cuda.synchronize()
    assert ck.SP_AG_ATTENTION.launches == before + 1
    tol = TOL[dtype]
    for r in range(n):
        assert o[r].dtype == dtype and lse[r].dtype == torch.float32
        torch.testing.assert_close(o[r].float(), po[r].float(), atol=tol,
                                   rtol=0)
        torch.testing.assert_close(lse[r], plse[r], atol=tol, rtol=0)


@pytest.mark.parametrize("n,hq,hkv,s_loc,dtype", [
    (2, 32, 8, 1000, torch.bfloat16), (3, 8, 8, 300, torch.bfloat16),
    (4, 16, 2, 4100, torch.bfloat16), (3, 8, 2, 100, torch.float32),
])
def test_sp_ag_attention_grids_bitwise_equal(dev, n, hq, hkv, s_loc, dtype):
    """The default grid (split by each rank's causal work) and even grids
    of ``blocks_per_rank`` (the capacity's share, 3, 1), launched in turn
    at one flag site: outputs bitwise equal (a row's arithmetic does not
    depend on its block), and within TOL of the plain version."""
    spmod = importlib.import_module(
        "triton_distributed_tpu_torch.ops.attention.sp_ag_attention")

    ctx = _ctx(dev, n, dtype)
    qs, ks, vs = _sp_inputs(dev, n, hq, hkv, s_loc, dtype, seed=n)
    key = (ck.DTYPE_CODES[dtype], hq // hkv)
    split = spmod.sp_ag_attention_kernel(qs, ks, vs, ctx, sm_scale=0.1)
    cap = spmod._capacity[key]
    counts = spmod.split_by_work(
        n, cap, hkv * -(-s_loc // spmod.q_tile(dtype, hq // hkv)))
    assert counts == sorted(counts) and min(counts) >= 1
    assert sum(counts) <= cap
    runs = [spmod.sp_ag_attention_kernel(qs, ks, vs, ctx, sm_scale=0.1,
                                         blocks_per_rank=b)
            for b in (cap // n, 3, 1)]
    torch.cuda.synchronize()
    for o, lse in runs:
        assert _bits_equal(o, split[0]) and _bits_equal(lse, split[1])
    po, plse = spmod.sp_ag_attention_plain(qs, ks, vs, sm_scale=0.1)
    for r in range(n):
        torch.testing.assert_close(split[0][r].float(), po[r].float(),
                                   atol=TOL[dtype], rtol=0)
        torch.testing.assert_close(split[1][r], plse[r], atol=TOL[dtype],
                                   rtol=0)


def test_sp_ag_attention_back_to_back_and_refusals(dev):
    """20 launches back to back at n = 4 with fresh inputs, each checked
    (the workspace and flags reused); unsupported shapes raise
    ValueError; a grid that cannot be co-resident is refused."""
    from triton_distributed_tpu_torch.ops.attention import sp_ag_attention
    from triton_distributed_tpu_torch.ops.attention.sp_ag_attention import (
        sp_ag_attention_kernel,
        sp_ag_attention_plain,
    )

    n, dt = 4, torch.bfloat16
    ctx = _ctx(dev, n, dt)
    kept = []
    for i in range(20):
        qs, ks, vs = _sp_inputs(dev, n, 8, 2, 48, dt, seed=i)
        kept.append((qs, ks, vs, sp_ag_attention(qs, ks, vs, ctx,
                                                 return_lse=True)))
    torch.cuda.synchronize()
    for qs, ks, vs, (o, lse) in kept:
        po, plse = sp_ag_attention_plain(qs, ks, vs)
        for r in range(n):
            torch.testing.assert_close(o[r].float(), po[r].float(),
                                       atol=TOL[dt], rtol=0)
            torch.testing.assert_close(lse[r], plse[r], atol=TOL[dt], rtol=0)
    for hq, hkv, hd, dtype in ((8, 2, 64, dt), (6, 2, 128, dt),
                               (32, 2, 128, dt), (8, 2, 128, torch.float16)):
        rng = np.random.default_rng(0)
        qs = [_rand(rng, (hq, 32, hd), dtype, dev) for _ in range(n)]
        ks = [_rand(rng, (hkv, 32, hd), dtype, dev) for _ in range(n)]
        with pytest.raises(ValueError):
            sp_ag_attention(qs, ks, ks, ctx)
    qs, ks, vs = _sp_inputs(dev, n, 8, 2, 48, dt)
    before = ck.SP_AG_ATTENTION.launches
    with pytest.raises(RuntimeError, match="cudaError"):
        sp_ag_attention_kernel(qs, ks, vs, ctx, sm_scale=0.1,
                               blocks_per_rank=100_000)
    assert ck.SP_AG_ATTENTION.launches == before


@pytest.mark.parametrize("method", ["pallas", "xla"])
@pytest.mark.parametrize("n", [2, 4])
def test_sp_decode_and_ring_on_card_match_plain(dev, n, method):
    """The distributed decode (bf16; the packed [B*Hq, 129] f32 rows
    through the all-gather kernels at method pallas) and ring attention
    on the card against the same calls on the CPU."""
    from triton_distributed_tpu_torch.ops.attention import (
        distributed_flash_decode,
        ring_attention,
    )

    b, hq, hkv, s_loc = 4, 32, 8, 96
    rng = np.random.default_rng(n)
    q = rng.standard_normal((b, hq, 128)).astype(np.float32)
    kc = rng.standard_normal((n, b, hkv, s_loc, 128)).astype(np.float32)
    vc = rng.standard_normal((n, b, hkv, s_loc, 128)).astype(np.float32)
    lens = np.array([n * s_loc, s_loc + 5, 1, s_loc], np.int32)
    got = {}
    for where in (dev, "cpu"):
        ctx = _ctx(where, n, torch.bfloat16)
        t = lambda a: torch.from_numpy(a).to(where, torch.bfloat16)  # noqa: E731
        ck.reset_launch_counts()
        got[where] = distributed_flash_decode(
            [t(q)] * n, [t(kc[r]) for r in range(n)],
            [t(vc[r]) for r in range(n)],
            torch.from_numpy(lens).to(where), ctx, chunk_k=32, method=method)
        if where == dev and method == "pallas":
            torch.cuda.synchronize()
            assert sum(v for k_, v in ck.launch_counts().items()
                       if k_.startswith("all_gather")) == 1
    for a, c in zip(got[dev], got["cpu"]):
        torch.testing.assert_close(a.float().cpu(), c.float(), atol=2e-2,
                                   rtol=0)
    qs, ks, vs = _sp_inputs(dev, n, 8, 2, 64, torch.bfloat16)
    for causal in (True, False):
        o = ring_attention(qs, ks, vs, causal=causal)
        p = ring_attention([x.cpu() for x in qs], [x.cpu() for x in ks],
                           [x.cpu() for x in vs], causal=causal)
        for a, c in zip(o, p):
            torch.testing.assert_close(a.float().cpu(), c.float(),
                                       atol=2e-2, rtol=0)


# -- the shift, the pull and torus gathers, the broadcast, the LL gather -------

# (rows, cols), dtype a rank: a decode-size row block at Qwen3-8B's width,
# f32, and rows of 20 and 198 bytes (not whole 16-byte vectors).
MOVE_SHAPES = [((16, 4096), torch.bfloat16), ((8, 128), torch.float32),
               ((3, 5), torch.float32), ((3, 99), torch.bfloat16)]


def _mods():
    import importlib

    return (importlib.import_module("triton_distributed_tpu_torch.parallel."
                                    "p2p"),
            importlib.import_module("triton_distributed_tpu_torch.ops."
                                    "collectives.all_gather"),
            importlib.import_module("triton_distributed_tpu_torch.ops."
                                    "collectives.broadcast"),
            importlib.import_module("triton_distributed_tpu_torch.ops."
                                    "collectives.low_latency"))


def _bits_equal(got, want) -> bool:
    """Bytes equal (a NaN left in an output never matches)."""
    return all(torch.equal(g.contiguous().view(torch.uint8),
                           w.contiguous().view(torch.uint8))
               for g, w in zip(got, want))


def _nan(n, shape, dtype, dev):
    return [torch.full(shape, float("nan"), dtype=dtype, device=dev)
            for _ in range(n)]


def _shards(dev, n, shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return [_rand(rng, shape, dtype, dev) for _ in range(n)]


# (rows, cols), dtype a rank for the ring all-gathers: the two timed
# shards, 37 rows (pieces and warp sub-pieces of unequal bytes), the SP
# decode's 516-byte f32 rows, and 20-byte rows (no 16-byte vectors).
RING_SHAPES = [((96, 2048), torch.bfloat16), ((192, 2048), torch.bfloat16),
               ((37, 2048), torch.bfloat16), ((7, 129), torch.float32),
               ((3, 5), torch.float32)]


@pytest.mark.parametrize("shape,dtype", RING_SHAPES)
@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("name", ["all_gather_ring", "all_gather_bidir_ring"])
def test_ring_all_gathers_chained_bitwise(dev, name, n, shape, dtype):
    """100 launches back to back, fresh inputs each, into NaN-filled
    outputs, on one flag site: every rank's output the shards in rank
    order, bit for bit (the odd ring n = 3 included)."""
    ag = _mods()[1]
    fn, counter = getattr(ag, name), getattr(ck, name.upper())
    ctx = _ctx(dev, n, dtype)
    full = (n * shape[0], shape[1])
    xs = _shards(dev, n, shape, dtype, 7 * n)
    kept = []
    before = counter.launches
    for i in range(100):
        xs = [x + 1 for x in xs]
        kept.append((xs, fn(xs, ctx, out=_nan(n, full, dtype, dev))))
    torch.cuda.synchronize()
    assert counter.launches == before + 100
    for xs, got in kept:
        assert _bits_equal(got, ag.all_gather_plain(xs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("name", ["reduce_scatter_ring",
                                  "reduce_scatter_bidir_ring",
                                  "reduce_scatter_ring_hbm"])
def test_reduce_scatter_rings_chained_bitwise(dev, name, n, dtype):
    """100 launches back to back on one flag site, fresh inputs each, every
    output bitwise its plain version (the ring's order and per-hop
    rounding; the odd ring n = 3 included); then one launch at every grid
    from 1 block a rank to the most that stays co-resident, each bitwise
    the default grid's. Rows of 1032 elements and 38-row chunks give
    pieces and warp sub-pieces of unequal vectors."""
    from triton_distributed_tpu_torch.ops.collectives import (
        _launch,
        reduce_scatter_ring_plain,
    )

    fn, _, counter = _coll(name)
    kind = {"reduce_scatter_ring": 1, "reduce_scatter_bidir_ring": 2,
            "reduce_scatter_ring_hbm": 3}[name]
    ctx = _ctx(dev, n, dtype)
    xs = _shards(dev, n, (n * 38, 1032), dtype, 30 + n)
    half = 19 if kind == 2 else None
    kept = []
    before = counter.launches
    for i in range(100):
        xs = [x + 1 for x in xs]
        kept.append((xs, fn(xs, ctx)))
    torch.cuda.synchronize()
    assert counter.launches == before + 100
    for xs_i, got in kept:
        assert _bits_equal(got, reduce_scatter_ring_plain(xs_i, half))
    default = kept[-1][1]
    most = _launch.capacity(_launch.REDUCE_SCATTER, kind, dtype) // n
    grids = [(g, fn(xs, ctx, blocks_per_rank=g)) for g in range(1, most + 1)]
    torch.cuda.synchronize()
    for g, got in grids:
        assert _bits_equal(got, default), g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,n", [("reduce_scatter_one_shot", 2),
                                    ("reduce_scatter_one_shot", 3),
                                    ("reduce_scatter_one_shot", 4),
                                    ("all_reduce_doubling", 2),
                                    ("all_reduce_doubling", 4),
                                    ("all_reduce_doubling", 8)])
def test_one_shot_rs_and_doubling_chained_bitwise(dev, name, n, dtype):
    """100 launches back to back on one flag site, fresh inputs each, every
    output bitwise its plain version (the one-shot's source order, the
    doubling's rounded partner sums); then one launch at every grid from 1
    block a rank to the most that stays co-resident, each bitwise the
    default grid's. Rows of 1032 elements (38-row chunks, 37 rows) give
    pieces and warp sub-pieces of unequal vectors; the doubling's sub-pieces
    fit one stripe at the default grid (the running sum held in registers)
    and not at the smallest grids (rebuilt stripe by stripe)."""
    from triton_distributed_tpu_torch.ops.collectives import _launch

    fn, plain, counter = _coll(name)
    fam, kind = ((_launch.REDUCE_SCATTER, 0) if name.startswith("reduce")
                 else (_launch.ALL_REDUCE, 1))
    ctx = _ctx(dev, n, dtype)
    rows = n * 38 if fam == _launch.REDUCE_SCATTER else 37
    xs = _shards(dev, n, (rows, 1032), dtype, 40 + n)
    kept = []
    before = counter.launches
    for i in range(100):
        xs = [x + 1 for x in xs]
        kept.append((xs, fn(xs, ctx)))
    torch.cuda.synchronize()
    assert counter.launches == before + 100
    for xs_i, got in kept:
        assert _bits_equal(got, plain(xs_i))
    default = kept[-1][1]
    most = _launch.capacity(fam, kind, dtype) // n
    grids = [(g, fn(xs, ctx, blocks_per_rank=g)) for g in range(1, most + 1)]
    torch.cuda.synchronize()
    for g, got in grids:
        assert _bits_equal(got, default), g


@pytest.mark.parametrize("shape,dtype", MOVE_SHAPES)
@pytest.mark.parametrize("n", [2, 4, 8])
def test_pp_shift_kernel_bitwise_plain(dev, n, shape, dtype):
    """Into NaN-filled outputs, wrap off and on: every rank's bytes the
    plain shift's (rank 0's zeros included)."""
    p2p = _mods()[0]
    ctx = _ctx(dev, n, dtype)
    for wrap in (False, True):
        xs = _shards(dev, n, shape, dtype, n + wrap)
        before = ck.PP_SHIFT.launches
        got = p2p.pp_shift_kernel(xs, ctx, wrap, out=_nan(n, shape, dtype,
                                                           dev))
        torch.cuda.synchronize()
        assert ck.PP_SHIFT.launches == before + 1
        assert _bits_equal(got, p2p.pp_shift_plain(xs, wrap))


@pytest.mark.parametrize("shape,dtype", MOVE_SHAPES)
@pytest.mark.parametrize("n", [2, 4, 8])
def test_all_gather_pull_kernel_bitwise_plain(dev, n, shape, dtype):
    """Every window from 1 to n - 1 (and one past it), into NaN-filled
    outputs: every rank's gather the shards in rank order."""
    ag = _mods()[1]
    ctx = _ctx(dev, n, dtype)
    full = (n * shape[0], shape[1])
    for w in [*range(1, n), n + 3]:
        xs = _shards(dev, n, shape, dtype, 10 * n + w)
        before = ck.ALL_GATHER_PULL.launches
        got = ag.all_gather_pull(xs, ctx, w, out=_nan(n, full, dtype, dev))
        torch.cuda.synchronize()
        assert ck.ALL_GATHER_PULL.launches == before + 1
        assert _bits_equal(got, ag.all_gather_plain(xs)), w


@pytest.mark.parametrize("shape,dtype", MOVE_SHAPES)
@pytest.mark.parametrize("dp,tp", [(2, 2), (2, 4), (4, 2)])
def test_all_gather_torus_2d_kernel_bitwise_plain(dev, dp, tp, shape, dtype):
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    ag = _mods()[1]
    ctx = initialize_distributed(tp, dp=dp, device=dev, dtype=dtype)
    n = dp * tp
    xs = _shards(dev, n, shape, dtype, n)
    before = ck.ALL_GATHER_TORUS_2D.launches
    got = ag.all_gather_torus_2d_kernel(
        xs, ctx, out=_nan(n, (n * shape[0], shape[1]), dtype, dev))
    torch.cuda.synchronize()
    assert ck.ALL_GATHER_TORUS_2D.launches == before + 1
    assert _bits_equal(got, ag.all_gather_plain(xs))
    assert _bits_equal(ag.all_gather_torus_2d(xs, ctx),
                       ag.all_gather_plain(xs))
    assert ck.ALL_GATHER_TORUS_2D.launches == before + 2


@pytest.mark.parametrize("shape,dtype", MOVE_SHAPES)
@pytest.mark.parametrize("n", [2, 4, 8])
def test_broadcast_kernel_bitwise_plain(dev, n, shape, dtype):
    bc = _mods()[2]
    ctx = _ctx(dev, n, dtype)
    for root in range(n):
        xs = _shards(dev, n, shape, dtype, root)
        before = ck.BROADCAST.launches
        got = bc.broadcast_kernel(xs, ctx, root,
                                  out=_nan(n, shape, dtype, dev))
        torch.cuda.synchronize()
        assert ck.BROADCAST.launches == before + 1
        assert _bits_equal(got, bc.broadcast_plain(xs, root)), root


@pytest.mark.parametrize("blocks", [None, 3])
@pytest.mark.parametrize("barrier_free", [True, False])
@pytest.mark.parametrize("shape,dtype", MOVE_SHAPES)
@pytest.mark.parametrize("n", [2, 4, 8])
def test_ll_all_gather_kernel_chained_calls(dev, n, shape, dtype,
                                            barrier_free, blocks):
    """20 calls back to back on one workspace, a fresh input each, into
    NaN-filled outputs, every call checked; then every rank's arrival and
    ACK flags read what the discipline predicts. At the card's default
    grid and at 3 blocks a rank (warp sub-pieces of other sizes)."""
    ll = _mods()[3]
    ag = _mods()[1]
    ctx = _ctx(dev, n, dtype)
    ws = ll.ll_all_gather_workspace(ctx, shape[0], shape[1], dtype,
                                    blocks_per_rank=blocks)
    full = (n * shape[0], shape[1])
    before = ck.LL_ALL_GATHER.launches
    kept = []
    for phase in range(20):
        xs = _shards(dev, n, shape, dtype, 100 + phase)
        kept.append((xs, ll.ll_all_gather_kernel(
            xs, ws, phase, ctx, barrier_free, out=_nan(n, full, dtype,
                                                       dev))))
    torch.cuda.synchronize()
    assert ck.LL_ALL_GATHER.launches == before + 20
    for xs, got in kept:
        assert _bits_equal(got, ag.all_gather_plain(xs))
    flags = ll.ll_flags(ws)
    want = ll.ll_expected_flags(ws)
    assert torch.equal(flags["acks"].cpu(), want)
    assert torch.equal(flags["arrivals"].cpu(), want)
    with pytest.raises(ValueError, match="advances the phase"):
        ll.ll_all_gather_kernel(xs, ws, 25, ctx)


def test_ll_all_gather_variants_alternate_on_one_workspace(dev):
    """Barrier-free and entry-barrier calls alternate on one workspace
    (both write the ACKs), through the public entry point."""
    ll = _mods()[3]
    n = 4
    ctx = _ctx(dev, n)
    ws = ll.ll_all_gather_workspace(ctx, 8, 4096, torch.bfloat16)
    for phase in range(9):
        xs = _shards(dev, n, (8, 4096), torch.bfloat16, phase)
        out, ws = ll.ll_all_gather(xs, ws, phase, ctx,
                                   barrier_free=None if phase % 3 else False)
        assert _bits_equal(out, [torch.cat(xs)] * n)
    torch.cuda.synchronize()
    assert torch.equal(ll.ll_flags(ws)["acks"].cpu(),
                       ll.ll_expected_flags(ws))


def test_move_kernels_stress_back_to_back(dev):
    """20 launches of each byte mover back to back at n = 4, bf16, fresh
    inputs, every output checked."""
    p2p, ag, bc, _ = _mods()
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    n, shape, dt = 4, (64, 4096), torch.bfloat16
    ctx = _ctx(dev, n)
    ctx2 = initialize_distributed(n, dp=2, device=dev, dtype=dt)
    kept = []
    for i in range(20):
        xs = _shards(dev, n, shape, dt, 1000 + i)
        x8 = _shards(dev, 2 * n, shape, dt, 2000 + i)
        kept += [
            (p2p.pp_shift(xs, ctx, wrap=bool(i % 2)),
             p2p.pp_shift_plain(xs, bool(i % 2))),
            (ag.all_gather(xs, ctx, ag.AllGatherMethod.PALLAS_PULL,
                           pull_window=1 + i % 3), ag.all_gather_plain(xs)),
            (bc.broadcast(xs, ctx, i % n), bc.broadcast_plain(xs, i % n)),
            (ag.all_gather_torus_2d(x8, ctx2), ag.all_gather_plain(x8)),
        ]
    torch.cuda.synchronize()
    for got, want in kept:
        assert _bits_equal(got, want)


def test_move_kernels_auto_and_refusals_on_card(dev):
    """On the card AUTO launches the shift and broadcast kernels for a
    >= 2-D input (the plain version only for 1-D); a grid that cannot be
    co-resident is refused without counting a launch."""
    p2p, ag, bc, _ = _mods()
    n = 4
    ctx = _ctx(dev, n)
    xs = _shards(dev, n, (8, 256), torch.bfloat16, 0)
    ck.reset_launch_counts()
    p2p.pp_shift(xs, ctx)
    bc.broadcast(xs, ctx, 2)
    ag.all_gather(xs, ctx, ag.AllGatherMethod.PALLAS_PULL)
    flat = [x[0] for x in xs]
    assert _bits_equal(p2p.pp_shift(flat, ctx), p2p.pp_shift_plain(flat))
    assert _bits_equal(bc.broadcast(flat, ctx, 1),
                       bc.broadcast_plain(flat, 1))
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    assert (counts["pp_shift"], counts["broadcast"],
            counts["all_gather_pull"]) == (1, 1, 1)
    with pytest.raises(ValueError, match=">= 2-D"):
        p2p.pp_shift(flat, ctx, method="pallas")
    with pytest.raises(ValueError, match=">= 2-D"):
        bc.broadcast(flat, ctx, 1, bc.BroadcastMethod.ONE_SHOT)
    with pytest.raises(RuntimeError, match="cudaError"):
        p2p.pp_shift_kernel(xs, ctx, blocks_per_rank=100_000)
    assert ck.PP_SHIFT.launches == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hierarchical_on_card_match_plain(dev, dtype):
    """dp x tp = 2 x 4: all_gather_2d bitwise the CPU's plain run;
    reduce_scatter_2d with a named inner ring bitwise the CPU's (its
    plain version repeats the ring's roundings); all_reduce_2level (AUTO:
    the bidirectional rings on the card) within the cross-rank kernels'
    limit of the CPU's f32 rank-order sum."""
    from triton_distributed_tpu_torch.ops.collectives import (
        ReduceScatterMethod,
        all_gather_2d,
        all_reduce_2level,
        reduce_scatter_2d,
    )
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    got = {}
    xs_np = [np.random.default_rng(r).standard_normal((384, 512)).astype(
        np.float32) for r in range(8)]
    for where in (dev, "cpu"):
        ctx = initialize_distributed(4, dp=2, device=where, dtype=dtype)
        xs = [torch.from_numpy(a).to(where, dtype) for a in xs_np]
        ck.reset_launch_counts()
        got[where] = (
            all_gather_2d([x[:96].contiguous() for x in xs], ctx),
            reduce_scatter_2d(
                xs, ctx, inner_method=ReduceScatterMethod.PALLAS_BIDIR_RING),
            all_reduce_2level(xs, ctx))
        if where == dev:
            torch.cuda.synchronize()
            c = ck.launch_counts()
            assert c["all_gather_bidir_ring"] == 4
            assert c["reduce_scatter_bidir_ring"] == 4
    card, cpu = got[dev], got["cpu"]
    assert _bits_equal([t.cpu() for t in card[0]], cpu[0])
    assert _bits_equal([t.cpu() for t in card[1]], cpu[1])
    atol, rtol = ((1e-4, 1e-5) if dtype == torch.float32
                  else (2.0**-6 * 8, 2.0**-7 * 8))
    for a, b in zip(card[2], cpu[2]):
        torch.testing.assert_close(a.float().cpu(), b.float(), atol=atol,
                                   rtol=rtol)
