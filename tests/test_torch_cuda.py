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


def _mega_run(mega, dims, args, stop_tok=None, plain=False):
    from triton_distributed_tpu_torch.megakernel import MegaWeights
    from triton_distributed_tpu_torch.megakernel.kernels import (
        mega_decode_plain,
    )

    compiled = mega._compile(dims)
    w = MegaWeights.from_params(mega.model.params)
    if plain:
        return mega_decode_plain(dims, True, compiled.table, w, *args,
                                 stop_tok=stop_tok)
    return compiled.run(w, *args, stop_tok=stop_tok)


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


def test_mega_serving_launches_the_kernel(dev):
    """Engine and ContinuousEngine in mode='mega' launch the megakernel
    for every decode step (multi launches and single-step remainders) and
    emit the plain version's tokens (tiny f32 on the card == CPU)."""
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
    for m, d in ((gpu, dev), (cpu, "cpu")):
        before = ck.MEGA_DECODE.launches
        dense = Engine(m, mode="mega", device=d).serve(np.stack(prompts), 11,
                                                       64, ns=4)
        eng = ContinuousEngine(m, max_batch=2, page_size=16, max_length=64,
                               prefix_cache=True, mode="mega", ns=4,
                               device=d)
        toks = eng.run([(p, 9) for p in prompts])
        assert eng.audit() == []
        outs.append((dense, np.concatenate(toks)))
        launches.append(ck.MEGA_DECODE.launches - before)
    assert all(np.array_equal(a, b) for a, b in zip(*outs))
    assert launches[0] > 0 and launches[1] == 0
    with pytest.raises(ValueError, match="contiguous|dims|dtype"):
        from triton_distributed_tpu_torch.megakernel import MegaQwen3

        mega = MegaQwen3(gpu)
        cache = gpu.new_cache(2, 64)
        mega.decode_fn(2, 32)(gpu.params, torch.zeros(2, dtype=torch.int32),
                              cache)
