#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

from the repository root. It builds the port's CUDA kernels from the
sources in the checkout, holds each kernel against its plain PyTorch
version at the shapes the serving path gives it (bf16, and f32 with
TF32 off) and at the tiny preset's (f32), and times both, then drives
the port's main path at the full width and depth of Qwen/Qwen3-0.6B
(random weights from a seed): ``ContinuousEngine`` with the radix
prefix cache serving 8
requests that share a 512-token system prefix, and ``Engine(paged=False)``
serving 2 rows; then the int8 KV path: the same 8 requests through
``ContinuousEngine(kv_dtype="int8")`` and 2 rows through
``Engine(paged=True, kv_dtype="int8")``; then greedy speculative
decoding with n-gram chains and radix draft trees:
``ContinuousEngine(speculative=4, spec_width=4)`` serving 4 requests
(the shared prefix, a 7-token motif repeated 4 times, 2 more tokens)
twice, a warm pass and a re-ask, and ``Engine(paged=True,
prefix_cache=True, speculative=4, spec_width=4)`` serving the same 4
prompts as one batch, twice; then the megakernel (``mode="mega"``):
``Engine(paged=False, mode="mega")`` serving the 2 rows with ``ns=8``
and ``ContinuousEngine(mode="mega", prefix_cache=True)`` serving the 8
shared-prefix requests with an ``eos_id``. Before the serving paths the
decode megakernel is held against its plain version at Qwen3-0.6B's full
width and depth (B=4, kv_len {700, 2040, 700, 2040}, dense and paged, NS
1 and 8), with a negative control (the plain version with the last layer
skipped must break the limit), and timed beside the ``mode="xla"`` decode
step at the same shape. The generated tokens are checked by teacher forcing
through a plain full-sequence forward, the pool audit must be clean,
and each serving path must have launched its own kernels: the launch
counts are set to 0 just before each path and read just after it.

Output: the card's name and power limit, per-phase lines, one
``{"kernels": [...]}`` JSON line, one ``{"e2e": ...}`` JSON line, and as
the last line ``{"ok": true, "device": {...}}``. Any failure exits
non-zero before that line; so does a machine without CUDA or a
directory without the port.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

SEED = 0
MODEL = "Qwen/Qwen3-0.6B"
PAGE = 128
MAX_LENGTH = 2048
PREFIX_LEN = 512
SUFFIX_LENS = (64, 384)  # distinct suffixes, lengths drawn in this range
GEN_LEN = 64
N_REQUESTS = 8
DENSE_ROWS, DENSE_PROMPT, DENSE_GEN = 2, 256, 32
DECODE_LENS = ([1, 127, 128, 129], [700, 2047, 700, 2047])  # B=4 each
# Kernel tolerances, elementwise |kernel - plain| <= atol + rtol·|plain|
# (inputs ~N(0, 1)). bf16: both sides round O to bf16 and the kernels
# also round P before P·V, so two outputs may differ by an ulp of |O|
# (<= 2^-7·|O|); the errors measured at these shapes on an H100 were
# 1.95e-3 and 3.9e-3, one ulp of an |O| in [0.25, 0.5) and [0.5, 1).
# rtol 2^-6 allows two ulps at any |O|, and where |O| ~ 0.05 the limit
# is ~2.8e-3, below the ~1e-2 that one dropped key or a causal edge one
# column off moves O by. f32 with TF32 off differs only in summation
# order (measured <= 5.2e-7); it runs at the same shapes, so a logic
# error shows at the widths that are served.
TOL = {"bf16": (2e-3, 2.0**-6), "f32": (5e-5, 0.0)}  # (atol, rtol)
# Teacher forcing: the emitted token's logit under the plain
# full-sequence forward must lie within TF_MARGIN of that forward's
# maximum, and at least TF_MIN_EXACT of the tokens must be its argmax.
# With ~N(0, 1) logits over 151936 entries the runner-up trails the top
# by only ~1/sqrt(2 ln V) ~ 0.2, so the margin is set from the readings,
# not from the logit scale: the worst gap measured on an H100 was 0.0625
# (a bf16 ulp of a logit in [8, 16)) with 556/576 tokens exact; 0.125 is
# twice that gap and 0.9 is below that share.
TF_MARGIN = 0.125
TF_MIN_EXACT = 0.9
# The int8 KV runs hold their tokens to the same plain full-width
# forward, so the gap also carries the int8 noise: each cached K/V value
# moves by up to half a quantization step (amax/254 per page and head),
# which moves logits by a few hundredths and flips the argmax where the
# top two logits are closer than that. Starting from the JAX package's
# own int8 limits (tests/test_kv_quant.py: |dlogits| < 0.25, >= 80%
# argmax agreement on tiny), the limits are set from the first reading on
# an H100: worst gap 0.09375 (three bf16 ulps of a logit in [4, 8)) with
# 546/576 tokens exact. The margin is twice that gap, and 0.9 is below
# that share (0.948), as the bf16 limits were set.
TF8_MARGIN = 0.1875
TF8_MIN_EXACT = 0.9
# Speculative paths: draft length, tree width, traffic.
SPEC_K, SPEC_WIDTH = 4, 4
SPEC_REQUESTS, MOTIF_LEN, MOTIF_REPEATS = 4, 7, 4
SPEC_GEN, SPEC_ENGINE_GEN = 64, 48
# The paged Engine serves all SPEC_REQUESTS prompts as one batch: a
# re-ask only drafts from the radix tree while its tokens still follow
# the cached chain, and in bf16 a verify chunk's rows round differently
# from the decode steps that wrote that chain, which flips near-tied
# argmaxes of the random-weight model (one prompt alone left its chain
# after 3 tokens on an H100, the four under ContinuousEngine after
# 27-64).
# The tree verify chunk at Qwen3-0.6B: 16 query rows against a gathered
# view of 2048 keys, at two offsets (mid-view, and ending at its end).
VERIFY_OFFSETS = (700, 2031)
# Serving paths in the order they run, each with the kernels it must
# launch and no others. The int8 Engine prefills dense (flash_attention
# in the model dtype) and quantizes on the write into its pages. The
# speculative paths verify linear drafts with flash_attention and draft
# trees with flash_attention_bias.
PATH_KERNELS = {
    "continuous": ("flash_attention", "paged_flash_decode"),
    "dense_engine": ("flash_attention", "flash_decode"),
    "continuous_int8": ("flash_attention_int8", "paged_flash_decode_int8"),
    "paged_engine_int8": ("flash_attention", "paged_flash_decode_int8"),
    "continuous_spec": ("flash_attention", "flash_attention_bias",
                        "paged_flash_decode"),
    "paged_engine_spec": ("flash_attention", "flash_attention_bias",
                          "paged_flash_decode"),
    # The megakernel paths prefill with flash_attention (mode="xla"
    # prefill) and decode every step, single-step remainders and
    # between-chunk steps included, through the one decode megakernel.
    "dense_engine_mega": ("flash_attention", "mega_decode"),
    "continuous_mega": ("flash_attention", "mega_decode"),
}
# The decode megakernel's check: Qwen3-0.6B, B=4, these cached lengths,
# launch widths NS. Limit on logits |kernel - plain| <= atol + rtol·|plain|.
# bf16: both round every GEMM input to bf16 at the same places, so they
# differ by f32 summation order plus the bf16 roundings it flips; the
# first readings on an H100 were 0.067-0.099 (PERF.md §2), and the limit
# is 1.5x the worst. f32 (TF32 off) differs in summation order only.
# A bf16 greedy token may leave the plain stream only where the plain
# logits put it within MEGA_TIE_GAP of the plain top: the kernel's measured
# logit error (0.099 at worst, PERF.md §2), not the whole limit.
MEGA_LENS = (700, 2040, 700, 2040)
MEGA_NS = (1, 8)
MEGA_TOL = {"bf16": (0.15, 2.0**-6), "f32": (2e-3, 0.0)}
MEGA_TIE_GAP = 0.1
# Card peaks (H100 SXM data sheet, dense): HBM bytes/s, bf16/f16 FLOP/s.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def median_ms(fn, flush, iters: int = 15, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` with L2 flushed before each
    launch (a serving step finds each layer's KV cold in L2)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def check_kernels(dev, flush):
    """Phase 2: each kernel against its plain version at the serving
    path's shapes, in bf16 (timed) and in f32 with TF32 off, plus the
    tiny preset's widths in f32; returns each kernel's record for the
    kernels line (launches are added later)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.models.paged_kv_cache import (
        quantize_pages,
    )
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

    rng = np.random.default_rng(SEED)

    def rand(shape, dtype):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)

    def int8_pool(shape):
        """int8 codes + per-(page, head) f32 scales of ~N(0, 1) pages."""
        return quantize_pages(rand(shape, torch.float32))

    def paged_int8_plain(qd, kp, ks, vp, vs, table, kv_len):
        """Plain int8 paged decode: dequantize through the table, then
        plain attention."""
        page = kp.shape[2]
        kd = pages_to_dense(kp, table).float() * scales_to_dense(
            ks, table, page)[..., None]
        vd = pages_to_dense(vp, table).float() * scales_to_dense(
            vs, table, page)[..., None]
        return gqa_decode_reference(qd, kd, vd, kv_len)

    def attn_int8_plain(q, k, ks, v, vs, off, blk):
        """Plain int8 prefill: dequantize per block_k keys, then plain
        attention."""
        kd = k.float() * ks.repeat_interleave(blk, dim=-1)[..., None]
        vd = v.float() * vs.repeat_interleave(blk, dim=-1)[..., None]
        return mha_reference(q, kd, vd, kv_offset=off)

    def err(a, b):
        """Per-element |a - b| and the plain value |b|, f32."""
        return (a.float() - b.float()).abs(), b.float().abs()

    # Prefill: a 256-token chunk at kv_offset 512 (16 q / 8 kv heads).
    hq, hkv, d, sq, off = 16, 8, 128, 256, 512
    sk = off + sq
    # Decode: B=4, page 128, kv_len over page edges and long contexts;
    # unused table entries point at the trash page 0.
    b, pps = 4, MAX_LENGTH // PAGE
    n_pages = 2 * b * pps + 1
    perm = rng.permutation(np.arange(1, n_pages))
    batches = []
    for lens in DECODE_LENS:
        lens_np = np.asarray(lens)
        used = np.arange(pps)[None] < -(-lens_np[:, None] // PAGE)
        table = np.where(used, perm[: b * pps].reshape(b, pps), 0)
        perm = np.roll(perm, b * pps)
        batches.append((torch.from_numpy(table.astype(np.int32)).to(dev),
                        torch.tensor(lens, dtype=torch.int32, device=dev)))

    errs = {}  # (kernel, dtype tag) -> [(|kernel - plain|, |plain|)]
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        q, k, v = (rand((1, hq, sq, d), dtype), rand((1, hkv, sk, d), dtype),
                   rand((1, hkv, sk, d), dtype))
        out = flash_attention(q, k, v, kv_offset=off)
        errs["flash_attention", tag] = [
            err(out, mha_reference(q, k, v, kv_offset=off))]
        kp, vp = (rand((n_pages, hkv, PAGE, d), dtype),
                  rand((n_pages, hkv, PAGE, d), dtype))
        kd, vd = (rand((b, hkv, MAX_LENGTH, d), dtype),
                  rand((b, hkv, MAX_LENGTH, d), dtype))
        qd = rand((b, hq, d), dtype)
        errs["paged_flash_decode", tag] = [
            err(paged_flash_decode(qd, kp, vp, table, kv_len),
                gqa_decode_reference(qd, pages_to_dense(kp, table),
                                     pages_to_dense(vp, table), kv_len))
            for table, kv_len in batches]
        errs["flash_decode", tag] = [
            err(flash_decode(qd, kd, vd, kv_len),
                gqa_decode_reference(qd, kd, vd, kv_len))
            for table, kv_len in batches]
        # int8 KV: the pool quantized per (page, head), the chunk's keys
        # per block_k = PAGE keys (what the chunk path gathers).
        kq, ksc = int8_pool((n_pages, hkv, PAGE, d))
        vq, vsc = int8_pool((n_pages, hkv, PAGE, d))
        errs["paged_flash_decode_int8", tag] = [
            err(paged_flash_decode(qd, kq, vq, table, kv_len, k_scale=ksc,
                                   v_scale=vsc),
                paged_int8_plain(qd, kq, ksc, vq, vsc, table, kv_len))
            for table, kv_len in batches]
        kb, kbs = int8_pool((hkv, sk // PAGE, PAGE, d))
        vb, vbs = int8_pool((hkv, sk // PAGE, PAGE, d))
        k8, v8 = kb.reshape(1, hkv, sk, d), vb.reshape(1, hkv, sk, d)
        kbs, vbs = kbs[None].contiguous(), vbs[None].contiguous()
        errs["flash_attention_int8", tag] = [err(
            flash_attention(q, k8, v8, kv_offset=off, block_k=PAGE,
                            k_scale=kbs, v_scale=vbs),
            attn_int8_plain(q, k8, kbs, v8, vbs, off, PAGE))]
        if tag == "bf16":
            timed = (q, k, v, out, kp, vp, kd, vd, qd)
            timed8 = (kq, ksc, vq, vsc, k8, kbs, v8, vbs)

    # Tiny f32 case, TF32 off: the tiny preset's widths.
    q = rand((1, 8, 48, 32), torch.float32)
    k, v = rand((1, 4, 80, 32), torch.float32), rand((1, 4, 80, 32),
                                                     torch.float32)
    errs["flash_attention", "f32 tiny"] = [err(
        flash_attention(q, k, v, kv_offset=32),
        mha_reference(q, k, v, kv_offset=32))]
    kp, vp = rand((9, 4, 16, 32), torch.float32), rand((9, 4, 16, 32),
                                                       torch.float32)
    table = torch.tensor([[3, 5, 0, 0], [8, 1, 2, 7]], dtype=torch.int32,
                         device=dev)
    kv_len = torch.tensor([17, 64], dtype=torch.int32, device=dev)
    qd = rand((2, 8, 32), torch.float32)
    errs["paged_flash_decode", "f32 tiny"] = [err(
        paged_flash_decode(qd, kp, vp, table, kv_len),
        gqa_decode_reference(qd, pages_to_dense(kp, table),
                             pages_to_dense(vp, table), kv_len))]
    kd, vd = pages_to_dense(kp, table), pages_to_dense(vp, table)
    errs["flash_decode", "f32 tiny"] = [err(
        flash_decode(qd, kd, vd, kv_len, chunk_k=16),
        gqa_decode_reference(qd, kd, vd, kv_len))]
    kq, ksc = int8_pool((9, 4, 16, 32))
    vq, vsc = int8_pool((9, 4, 16, 32))
    errs["paged_flash_decode_int8", "f32 tiny"] = [err(
        paged_flash_decode(qd, kq, vq, table, kv_len, k_scale=ksc,
                           v_scale=vsc),
        paged_int8_plain(qd, kq, ksc, vq, vsc, table, kv_len))]
    kb, kbs = int8_pool((4, 5, 16, 32))  # 80 keys, block_k = page = 16
    vb, vbs = int8_pool((4, 5, 16, 32))
    k8, v8 = kb.reshape(1, 4, 80, 32), vb.reshape(1, 4, 80, 32)
    kbs, vbs = kbs[None].contiguous(), vbs[None].contiguous()
    errs["flash_attention_int8", "f32 tiny"] = [err(
        flash_attention(q, k8, v8, kv_offset=32, block_k=16, k_scale=kbs,
                        v_scale=vbs),
        attn_int8_plain(q, k8, kbs, v8, vbs, 32, 16))]

    # Tree verify: 16 query rows against the gathered 2048-key view under
    # a real draft-tree mask, expanded as the model expands it; the plain
    # version with the mask one column off must break the limit.
    from triton_distributed_tpu_torch.models.qwen import expand_tree_mask

    tree = verify_tree()
    vrows = 16
    shifted = []  # (tag, offset, kernel out, shifted-mask plain out)
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        qv = rand((1, hq, vrows, d), dtype)
        kv_, vv_ = (rand((1, hkv, MAX_LENGTH, d), dtype),
                    rand((1, hkv, MAX_LENGTH, d), dtype))
        errs["flash_attention_bias", tag] = []
        for voff in VERIFY_OFFSETS:
            bias = expand_tree_mask(tree.mask(vrows), voff, MAX_LENGTH, dev)
            o = flash_attention(qv, kv_, vv_, kv_offset=voff, bias=bias)
            errs["flash_attention_bias", tag].append(err(o, mha_reference(
                qv, kv_, vv_, kv_offset=voff, bias=bias)))
            shifted.append((tag, voff, o, mha_reference(
                qv, kv_, vv_, kv_offset=voff,
                bias=torch.roll(bias, 1, dims=1))))
        if tag == "bf16":
            timed_bias = (qv, kv_, vv_)
    q = rand((1, 8, vrows, 32), torch.float32)
    k, v = rand((1, 4, 80, 32), torch.float32), rand((1, 4, 80, 32),
                                                     torch.float32)
    bias = expand_tree_mask(tree.mask(vrows), 48, 80, dev)
    errs["flash_attention_bias", "f32 tiny"] = [err(
        flash_attention(q, k, v, kv_offset=48, bias=bias),
        mha_reference(q, k, v, kv_offset=48, bias=bias))]

    bad, max_abs = [], {}
    for (name, tag), pairs in errs.items():
        atol, rtol = TOL[tag.split()[0]]
        diff = torch.cat([x.flatten() for x, _ in pairs])
        plain = torch.cat([x.flatten() for _, x in pairs])
        e = max_abs[name, tag] = diff.max().item()
        # Worst share of the limit used; the check fails above 1.
        used = (diff / (atol + rtol * plain)).max().item()
        print(f"[kernels] {name} {tag} max_abs_err={e:.3e} "
              f"limit atol={atol} + rtol={rtol}*|plain|, worst {used:.3f} "
              f"of it")
        if not used <= 1.0:  # NaN fails too
            bad.append(f"{name} {tag} ({used:.3f} of the limit)")
    if bad:
        raise RuntimeError(f"kernels disagree with plain: {bad}")
    for tag, voff, o, wrong in shifted:
        atol, rtol = TOL[tag]
        diff, plain = err(o, wrong)
        used = (diff / (atol + rtol * plain)).max().item()
        print(f"[kernels] flash_attention_bias {tag} kv_offset={voff} vs the "
              f"plain version with the mask one column off: {used:.1f}x the "
              f"limit (must exceed 1)")
        if not used > 1.0:
            raise RuntimeError("a one-column mask shift passes the "
                               f"flash_attention_bias limit ({tag}, {voff})")

    # Times, bounds and library calls at the bf16 serving shapes.
    q, k, v, out, kp, vp, kd, vd, qd = timed
    table, kv_len = batches[-1]
    lens = DECODE_LENS[-1]
    records = {}
    mask = (torch.arange(sk, device=dev)[None, :]
            <= off + torch.arange(sq, device=dev)[:, None])
    flops = 4 * hq * d * sum(off + r + 1 for r in range(sq))
    by = nbytes(q, k, v, out)
    records["flash_attention"] = dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/flash_attention.cu",
        replaces="triton_distributed_tpu/ops/attention/flash_attention.py:32",
        max_abs_err=max_abs["flash_attention", "bf16"],
        ms=median_ms(lambda: flash_attention(q, k, v, kv_offset=off), flush),
        plain_ms=median_ms(lambda: mha_reference(q, k, v, kv_offset=off),
                           flush),
        bound_ms=max(flops / BF16_FLOPS, by / HBM_BPS) * 1e3,
        bound_by="operations" if flops / BF16_FLOPS > by / HBM_BPS
        else "bytes",
        library_ms=median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), flush),
        shape=f"q[1,{hq},{sq},{d}] kv[1,{hkv},{sk},{d}] off={off} bf16",
    )
    kv_bytes = sum(lens) * hkv * d * 2 * 2 + nbytes(qd) * 2
    bound = kv_bytes / HBM_BPS * 1e3
    records["paged_flash_decode"] = dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/flash_decode.cu",
        replaces="triton_distributed_tpu/ops/attention/flash_decode.py:369",
        max_abs_err=max_abs["paged_flash_decode", "bf16"],
        ms=median_ms(lambda: paged_flash_decode(qd, kp, vp, table, kv_len),
                     flush),
        plain_ms=median_ms(lambda: gqa_decode_reference(
            qd, pages_to_dense(kp, table), pages_to_dense(vp, table),
            kv_len), flush),
        bound_ms=bound, bound_by="bytes", library_ms=None,
        shape=f"B=4 page={PAGE} kv_len={lens} bf16",
    )
    pos = torch.arange(MAX_LENGTH, device=dev)
    dmask = (pos[None, :] < kv_len[:, None])[:, None, None, :]
    records["flash_decode"] = dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/flash_decode.cu",
        replaces="triton_distributed_tpu/ops/attention/flash_decode.py:92",
        max_abs_err=max_abs["flash_decode", "bf16"],
        ms=median_ms(lambda: flash_decode(qd, kd, vd, kv_len), flush),
        plain_ms=median_ms(lambda: gqa_decode_reference(qd, kd, vd, kv_len),
                           flush),
        bound_ms=bound, bound_by="bytes",
        library_ms=median_ms(lambda: F.scaled_dot_product_attention(
            qd[:, :, None], kd, vd, attn_mask=dmask, enable_gqa=True), flush),
        shape=f"B=4 S={MAX_LENGTH} chunk=256 kv_len={lens} bf16",
    )
    # int8: the codes of the live pages, their scales and q/o; no single
    # PyTorch call attends over int8 codes with per-page scales.
    kq, ksc, vq, vsc, k8, kbs, v8, vbs = timed8
    live_pages = sum(-(-n // PAGE) for n in lens)
    kv8_bytes = (sum(lens) * hkv * d * 2 + live_pages * hkv * 4 * 2
                 + nbytes(qd) * 2)
    records["paged_flash_decode_int8"] = dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/flash_decode.cu",
        replaces="triton_distributed_tpu/ops/attention/flash_decode.py:374",
        max_abs_err=max_abs["paged_flash_decode_int8", "bf16"],
        ms=median_ms(lambda: paged_flash_decode(
            qd, kq, vq, table, kv_len, k_scale=ksc, v_scale=vsc), flush),
        plain_ms=median_ms(lambda: paged_int8_plain(
            qd, kq, ksc, vq, vsc, table, kv_len), flush),
        bound_ms=kv8_bytes / HBM_BPS * 1e3, bound_by="bytes",
        library_ms=None,
        shape=f"B=4 page={PAGE} kv_len={lens} int8 KV, bf16 q/o",
    )
    by8 = nbytes(q, k8, v8, kbs, vbs, out)
    records["flash_attention_int8"] = dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/flash_attention.cu",
        replaces="triton_distributed_tpu/ops/attention/flash_attention.py:32",
        max_abs_err=max_abs["flash_attention_int8", "bf16"],
        ms=median_ms(lambda: flash_attention(
            q, k8, v8, kv_offset=off, block_k=PAGE, k_scale=kbs,
            v_scale=vbs), flush),
        plain_ms=median_ms(lambda: attn_int8_plain(
            q, k8, kbs, v8, vbs, off, PAGE), flush),
        bound_ms=max(flops / BF16_FLOPS, by8 / HBM_BPS) * 1e3,
        bound_by="operations" if flops / BF16_FLOPS > by8 / HBM_BPS
        else "bytes",
        library_ms=None,
        shape=f"q[1,{hq},{sq},{d}] kv[1,{hkv},{sk},{d}] int8 block_k={PAGE} "
              f"off={off}, bf16 q/o",
    )
    # Tree verify at kv_offset 700: the kernel reads K/V and the bias up
    # to the causal limit of its last row; the work is the scores of the
    # (row, key) pairs the mask and causality leave visible.
    qv, kv_, vv_ = timed_bias
    voff = VERIFY_OFFSETS[0]
    kv_end = voff + vrows
    bias = expand_tree_mask(tree.mask(vrows), voff, MAX_LENGTH, dev)
    cols = torch.arange(MAX_LENGTH, device=dev)
    causal = cols[None, :] <= voff + torch.arange(vrows, device=dev)[:, None]
    visible = int(((bias == 0) & causal).sum().item())
    bflops = 4 * hq * d * visible
    bbytes = (nbytes(qv) * 2 + 2 * hkv * kv_end * d * qv.element_size()
              + vrows * kv_end * 4)
    amask = torch.where(causal, bias, torch.full_like(bias, -1e30)).to(
        qv.dtype)
    records["flash_attention_bias"] = dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/flash_attention.cu",
        replaces="triton_distributed_tpu/ops/attention/flash_attention.py:80",
        max_abs_err=max(max_abs["flash_attention_bias", "bf16"],
                        max_abs["flash_attention_bias", "f32"]),
        ms=median_ms(lambda: flash_attention(qv, kv_, vv_, kv_offset=voff,
                                             bias=bias), flush),
        plain_ms=median_ms(lambda: mha_reference(qv, kv_, vv_,
                                                 kv_offset=voff, bias=bias),
                           flush),
        bound_ms=max(bflops / BF16_FLOPS, bbytes / HBM_BPS) * 1e3,
        bound_by="operations" if bflops / BF16_FLOPS > bbytes / HBM_BPS
        else "bytes",
        library_ms=median_ms(lambda: F.scaled_dot_product_attention(
            qv, kv_, vv_, attn_mask=amask, enable_gqa=True), flush),
        shape=f"q[1,{hq},{vrows},{d}] kv[1,{hkv},{MAX_LENGTH},{d}] "
              f"off={voff} tree bias [{vrows},{MAX_LENGTH}] bf16",
    )
    return records


def _mega_tokens_ok(toks, ref_toks, plain_at) -> list:
    """Kernel vs plain greedy tokens [NS, B]. A row may leave the plain
    stream only where the plain version itself cannot tell the two
    tokens apart: at the first differing step s, the plain logits of
    step s (``plain_at(s)``) must put the kernel's token within
    ``MEGA_TIE_GAP`` of the plain argmax (a near tie; the steps after it
    decode other inputs). Returns the near-tie records; raises
    otherwise."""
    ties = []
    diff = (toks != ref_toks).any(dim=0)
    for b in diff.nonzero().flatten().tolist():
        s = int((toks[:, b] != ref_toks[:, b]).nonzero()[0])
        lg = plain_at(s)[b]
        top, got = int(ref_toks[s, b]), int(toks[s, b])
        gap = (lg[top] - lg[got]).item()
        ties.append(dict(row=b, step=s, gap=gap))
        if not 0 <= gap <= MEGA_TIE_GAP:
            raise RuntimeError(f"kernel token {got} at row {b} step {s} is "
                               f"not a near tie of plain's {top}: gap {gap}")
    return ties


def check_mega(dev, flush):
    """The decode megakernel against its plain version at Qwen3-0.6B's
    full width and depth, dense and paged, NS = 1 and 8, in bf16 (the
    serving dtype, timed) and in f32 with TF32 off: logits within the
    limit, two launches bit-identical, tokens equal (bf16: up to a near
    tie of the plain version, see ``_mega_tokens_ok``; f32: exactly),
    and the plain version with the last layer skipped outside the limit.
    Times the bf16 kernel per launch and per step beside the port's
    ``mode="xla"`` decode step at the same shape. Returns its record."""
    import dataclasses

    import numpy as np
    import torch

    from triton_distributed_tpu_torch.megakernel import (
        MegaConfig,
        MegaQwen3,
        MegaWeights,
    )
    from triton_distributed_tpu_torch.megakernel.kernels import (
        mega_decode_plain,
    )
    from triton_distributed_tpu_torch.models import AutoLLM
    from triton_distributed_tpu_torch.models.paged_kv_cache import (
        init_paged_cache,
    )

    b = len(MEGA_LENS)
    lens = torch.tensor(MEGA_LENS, dtype=torch.int32, device=dev)
    worst, max_err, times, info, bad, ties = {}, 0.0, {}, {}, [], []
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        model = AutoLLM.from_pretrained(MODEL, device=dev, seed=SEED,
                                        dtype=dtype)
        cfg = model.cfg
        L, V = cfg.num_layers, cfg.vocab_size
        gen = torch.Generator(device=dev).manual_seed(SEED + 2)
        dense = model.new_cache(b, MAX_LENGTH)
        paged, _ = init_paged_cache(cfg, b, dev, max_length=MAX_LENGTH,
                                    page_size=PAGE)
        for t in (dense.k, dense.v, paged.k_pages, paged.v_pages):
            t.normal_(generator=gen)
        tokens = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
            0, V, b).astype(np.int32)).to(dev)
        mega = MegaQwen3(model, cfg=MegaConfig(fuse_norms=True))
        w = MegaWeights.from_params(model.params)
        atol, rtol = MEGA_TOL[tag]
        for kind in ("dense", "paged"):
            if kind == "dense":
                args, page = (dense.k, dense.v, None, lens, tokens), 0
            else:
                args = (paged.k_pages, paged.v_pages, paged.page_table, lens,
                        tokens)
                page = PAGE
            for ns in MEGA_NS:
                dims = dataclasses.replace(mega._dims(b, MAX_LENGTH, page),
                                           nsteps=ns, v_real=V)
                comp = mega._compile(dims)
                got = comp.run(w, *args, info=info)
                again = comp.run(w, *args)
                torch.cuda.synchronize()
                ref = mega_decode_plain(dims, True, comp.table, w, *args)
                if not all(torch.equal(x, y) for x, y in zip(got, again)):
                    raise RuntimeError(f"mega_decode {tag} {kind} NS={ns}: "
                                       "two launches on the same inputs "
                                       "differ")

                def plain_at(s, dims=dims, table=comp.table, args=args):
                    d1 = dataclasses.replace(dims, nsteps=s + 1)
                    return mega_decode_plain(d1, True, table, w, *args)[0]

                if tag == "f32":
                    if not torch.equal(got[3], ref[3]):
                        raise RuntimeError(f"mega_decode f32 {kind} NS={ns}: "
                                           "tokens differ from plain")
                    case_ties = []
                else:
                    case_ties = _mega_tokens_ok(got[3], ref[3], plain_at)
                ties += [dict(kind=kind, ns=ns, **t) for t in case_ties]
                # The last step's logits and new rows read the tokens of
                # the steps before it: a row that left the plain stream
                # there (at a near tie) decodes other inputs; every other
                # row, and every row at NS = 1, is held to the limit.
                keep = (got[3][:-1] == ref[3][:-1]).all(dim=0)
                err = (got[0] - ref[0]).abs()[keep]
                used = (err / (atol + rtol * ref[0].abs()[keep])).max().item()
                kerr = max((got[i].float() - ref[i].float())[:, :, keep]
                           .abs().max().item() for i in (1, 2))
                # Negative control: the plain version without the last
                # layer must break the limit.
                skip = comp.table[comp.table[:, 1] != L - 1]
                bad_ref = mega_decode_plain(dims, True, skip, w, *args)[0]
                bad_used = ((got[0] - bad_ref).abs()
                            / (atol + rtol * bad_ref.abs())).max().item()
                tie_note = (f" up to near ties {case_ties}" if case_ties
                            else "")
                print(f"[mega] {tag} {kind} NS={ns}: tokens == plain"
                      f"{tie_note}, logits max_abs_err {err.max().item():.3e}, "
                      f"{used:.3f} of the limit (atol {atol} + rtol {rtol}"
                      f"*|plain|); knew/vnew max err {kerr:.3e}; last layer "
                      f"skipped: {bad_used:.1f}x the limit (must exceed 1); "
                      f"launch {info}")
                if not used <= 1.0 or not bad_used > 1.0:
                    bad.append(f"{tag} {kind} NS={ns}: limit use {used}, "
                               f"negative control {bad_used}")
                worst[tag] = max(worst.get(tag, 0.0), used)
                if tag != "bf16":
                    continue
                max_err = max(max_err, err.max().item())
                ms = median_ms(lambda: comp.run(w, *args), flush)
                plain_ms = median_ms(lambda: mega_decode_plain(
                    dims, True, comp.table, w, *args), flush, iters=3,
                    warmup=1)
                times[kind, ns] = (ms, plain_ms)
                print(f"[mega] {kind} NS={ns}: {ms:.4f} ms per launch, "
                      f"{ms / ns:.4f} ms per step; plain {plain_ms:.2f} ms "
                      "per launch")
        if tag == "bf16":
            # The mode="xla" decode step at the same shape, the yardstick.
            def xla_step(c):
                c.kv_len = lens.clone()
                model.decode_step(tokens, c)

            xla_ms = {k: median_ms(lambda c=c: xla_step(c), flush)
                      for k, c in (("dense", dense), ("paged", paged))}
            print(f"[mega] mode='xla' decode step at the same shape: "
                  f"{xla_ms} ms")
            bf16 = model
        del model, dense, paged, mega, w
    if bad:
        raise RuntimeError(f"mega_decode disagrees with plain: {bad}")
    # Bound: one step reads every layer weight, the LM head, the norms
    # and the embed rows once, every cached K/V row once, and writes the
    # logits and the new K/V rows.
    cfg, p = bf16.cfg, bf16.params
    L = cfg.num_layers
    weights = sum(t.numel() * t.element_size() for t in (
        p["layers"]["attn"]["wqkv"], p["layers"]["attn"]["wo"],
        p["layers"]["mlp"]["w1"], p["layers"]["mlp"]["w2"],
        p["layers"]["ln1"], p["layers"]["ln2"], p["layers"]["attn"]["q_norm"],
        p["layers"]["attn"]["k_norm"], p["lm_head"], p["norm"]))
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    kv = sum(MEGA_LENS) * L * hkv * hd * 2 * 2
    out = b * p["lm_head"].shape[1] * 4 + 2 * L * b * hkv * hd * 2
    step_bytes = weights + kv + out + b * cfg.hidden_size * 2
    flops = 2 * b * (weights // 2) + 4 * b * cfg.num_q_heads * hd * sum(
        MEGA_LENS)
    ms1, plain1 = times["paged", 1]
    return dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/megakernel.cu",
        replaces="triton_distributed_tpu/megakernel/code_generator.py:473",
        max_abs_err=max_err,
        ms=ms1, plain_ms=plain1,
        bound_ms=max(step_bytes / HBM_BPS, flops / BF16_FLOPS) * 1e3,
        bound_by="bytes" if step_bytes / HBM_BPS > flops / BF16_FLOPS
        else "operations",
        library_ms=None,
        shape=f"Qwen3-0.6B 28 layers, B={b}, paged page={PAGE}, kv_len "
              f"{list(MEGA_LENS)}, NS=1 bf16 (ms = one step)",
        limit_used=worst,
        near_ties=ties,
        ms_per_launch={f"{k}_ns{n}": v[0] for (k, n), v in times.items()},
        ms_per_step={f"{k}_ns{n}": v[0] / n for (k, n), v in times.items()},
        plain_ms_per_launch={f"{k}_ns{n}": v[1]
                             for (k, n), v in times.items()},
        xla_step_ms=xla_ms,
        launch=info,
    )


def verify_tree():
    """A 14-node draft tree (5 branches) for the verify-shape checks."""
    from triton_distributed_tpu_torch.models.speculative import TreeDraft

    tree = TreeDraft(4)
    for path in ([1, 2, 3, 4], [1, 5, 6], [7, 8, 9, 10], [7, 2], [11, 12]):
        tree.add_path(path, budget=16)
    return tree


def check_tiny_serving(dev) -> None:
    """The tiny f32 preset serves the same greedy tokens through the
    kernels on the card as through the plain versions on the CPU."""
    import numpy as np

    from triton_distributed_tpu_torch.models import (
        AutoLLM,
        ContinuousEngine,
        Engine,
    )

    gpu = AutoLLM.from_pretrained("tiny", device=dev, seed=SEED)
    cpu = AutoLLM.from_pretrained("tiny", device="cpu", seed=SEED)
    cpu.set_params(gpu.params)
    rng = np.random.default_rng(SEED)
    prefix = rng.integers(0, 256, 24)
    prompts = [np.concatenate([prefix, rng.integers(0, 256, 8)]).astype(
        np.int32) for _ in range(4)]
    outs = []
    for m, d in ((gpu, dev), (cpu, "cpu")):
        eng = ContinuousEngine(m, max_batch=2, page_size=16, max_length=64,
                               prefix_cache=True, device=d)
        toks = eng.run([(p, 6) for p in prompts])
        dense = Engine(m, device=d).serve(np.stack(prompts[:2]), 6, 64)
        outs.append((np.stack(toks), dense))
    if not all(np.array_equal(a, b) for a, b in zip(*outs)):
        raise RuntimeError("tiny f32 serving on the card differs from CPU")
    print("[tiny] f32 ContinuousEngine + Engine tokens on the card == CPU")

    # Speculative decoding, tree arm included: a warm pass fills the
    # radix tree and the re-ask drafts trees from it. Tokens equal the
    # same engines without speculation, on the card and on the CPU.
    motifs = [rng.integers(1, 50, 7).tolist() for _ in range(2)]
    sprompts = [np.asarray(m * 4 + [3, 5], np.int32) for m in motifs]
    spec_kw = dict(speculative=SPEC_K, spec_width=SPEC_WIDTH)
    got = []
    for m, d in ((gpu, dev), (cpu, "cpu")):
        per = {}
        for name, kw in (("plain", {}), ("spec", spec_kw)):
            eng = ContinuousEngine(m, max_batch=2, page_size=16,
                                   max_length=128, prefix_cache=True,
                                   device=d, **kw)
            fixed = Engine(m, paged=True, page_size=16, prefix_cache=True,
                           device=d, **kw)
            for _ in range(2):
                toks = np.stack(eng.run([(p, 24) for p in sprompts]))
                dense = fixed.serve(sprompts[0][None], 24, 128)
            per[name] = (toks, dense)
            if name == "spec":
                trees = (eng.last_stats["spec_tree_rounds"],
                         fixed.last_stats["spec_tree_rounds"])
                if min(trees) <= 0 or eng.audit() or fixed.audit():
                    raise RuntimeError(f"tiny speculative serving on {d}: "
                                       f"tree rounds {trees}, audits "
                                       f"{eng.audit()} {fixed.audit()}")
        got.append(per)
    ref = got[0]["plain"]
    for per in got:
        for toks in per.values():
            if not all(np.array_equal(a, b) for a, b in zip(toks, ref)):
                raise RuntimeError("tiny speculative serving differs from "
                                   "plain greedy or from the CPU")
    print(f"[tiny] f32 speculative ContinuousEngine + Engine (K={SPEC_K}, "
          f"width {SPEC_WIDTH}, tree rounds {trees} on the CPU) == plain "
          "greedy, on the card == CPU")


def reference_logits(model, tokens):
    """Plain full-sequence forward (plain attention, no cache) of one
    sequence: logits [S, V] f32."""
    import torch
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.layers.tp_attn import _rms_head
    from triton_distributed_tpu_torch.layers.tp_mlp import _silu_mul
    from triton_distributed_tpu_torch.models.qwen import rms_norm
    from triton_distributed_tpu_torch.ops.attention import (
        apply_rope,
        mha_reference,
    )

    cfg, p, dims = model.cfg, model.params, model.dims
    lp = p["layers"]
    s = tokens.shape[0]
    x = F.embedding(tokens, p["embed"])
    pos = torch.arange(s, device=tokens.device)
    for i in range(cfg.num_layers):
        h = rms_norm(x, lp["ln1"][i], cfg.rms_eps)
        q, k, v = dims.split_qkv(h @ lp["attn"]["wqkv"][i])
        q = apply_rope(_rms_head(q, lp["attn"]["q_norm"][i]).transpose(0, 1),
                       pos, cfg.rope_theta)
        k = apply_rope(_rms_head(k, lp["attn"]["k_norm"][i]).transpose(0, 1),
                       pos, cfg.rope_theta)
        o = mha_reference(q[None], k[None], v.transpose(0, 1)[None])[0]
        x = x + o.transpose(0, 1).reshape(s, -1) @ lp["attn"]["wo"][i]
        h = rms_norm(x, lp["ln2"][i], cfg.rms_eps)
        x = x + _silu_mul(h @ lp["mlp"]["w1"][i]) @ lp["mlp"]["w2"][i]
    x = rms_norm(x, p["norm"], cfg.rms_eps)
    return model._logits(x)


def teacher_forced_gaps(model, prompt, generated) -> list[float]:
    """For each generated position: reference max logit minus the
    reference logit of the token the engine emitted."""
    import numpy as np
    import torch

    seq = np.concatenate([prompt, generated[:-1]]).astype(np.int64)
    logits = reference_logits(model, torch.from_numpy(seq).to(model.device))
    rows = logits[len(prompt) - 1:]
    emitted = torch.as_tensor(generated, device=model.device).long()
    gaps = rows.max(dim=-1).values - rows.gather(1, emitted[:, None])[:, 0]
    return gaps.tolist()


class _Timed:
    """Wall time (synchronized) and calls of one model method; calls with
    ``all_logits=True`` (speculative verify chunks) are kept apart."""

    def __init__(self, model, name):
        import torch

        self.calls, self.seconds = 0, 0.0
        self.verify_calls, self.verify_seconds = 0, 0.0
        inner = getattr(model, name)

        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            torch.cuda.synchronize()
            if kw.get("all_logits"):
                self.verify_seconds += time.perf_counter() - t0
                self.verify_calls += 1
            else:
                self.seconds += time.perf_counter() - t0
                self.calls += 1
            return out

        setattr(model, name, wrapped)

    def snapshot(self) -> tuple:
        return (self.seconds, self.calls, self.verify_seconds,
                self.verify_calls)


def serve_main_path(dev):
    """Phase 3: the port's main path, full width and depth."""
    import numpy as np
    import torch

    from triton_distributed_tpu_torch.models import (
        AutoLLM,
        ContinuousEngine,
        Engine,
    )
    from triton_distributed_tpu_torch.ops import cuda_kernels as ck

    t0 = time.perf_counter()
    model = AutoLLM.from_pretrained(MODEL, device=dev, seed=SEED)
    torch.cuda.synchronize()
    print(f"[serve] {MODEL} random init on {dev} in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({model.cfg.num_layers} layers, hidden {model.cfg.hidden_size})")
    rng = np.random.default_rng(SEED + 1)
    vocab = model.cfg.vocab_size
    prefix = rng.integers(0, vocab, PREFIX_LEN)
    prompts = [np.concatenate([prefix, rng.integers(0, vocab, n)]).astype(
        np.int32) for n in rng.integers(SUFFIX_LENS[0], SUFFIX_LENS[1] + 1,
                                     N_REQUESTS)]
    dense_ids = rng.integers(0, vocab, (DENSE_ROWS, DENSE_PROMPT)).astype(
        np.int32)
    # Speculative traffic: the shared prefix, an aperiodic motif of the
    # request's own repeated MOTIF_REPEATS times, then 2 more tokens.
    spec_prompts = [np.concatenate([
        prefix, np.tile(rng.integers(0, vocab, MOTIF_LEN), MOTIF_REPEATS),
        rng.integers(0, vocab, 2)]).astype(np.int32)
        for _ in range(SPEC_REQUESTS)]

    def continuous(kv_dtype):
        return ContinuousEngine(model, max_batch=4, page_size=PAGE,
                                max_length=MAX_LENGTH, prefix_cache=True,
                                kv_dtype=kv_dtype, device=dev)

    eng, eng8 = continuous(None), continuous("int8")
    dense_eng = Engine(model, paged=False, device=dev)
    paged8 = Engine(model, paged=True, page_size=PAGE, kv_dtype="int8",
                    device=dev)
    spec_kw = dict(prefix_cache=True, speculative=SPEC_K,
                   spec_width=SPEC_WIDTH, device=dev)
    spec_eng = ContinuousEngine(model, max_batch=4, page_size=PAGE,
                                max_length=MAX_LENGTH, **spec_kw)
    mega_dense = Engine(model, paged=False, mode="mega", device=dev)
    mega_engs = {}

    def continuous_mega():
        """ContinuousEngine(mode="mega") with an eos_id: the token the
        bf16 continuous run emitted 41st for the first request."""
        eos = int(outs["continuous"][0][40])
        eng = mega_engs["continuous_mega"] = ContinuousEngine(
            model, max_batch=4, page_size=PAGE, max_length=MAX_LENGTH,
            prefix_cache=True, mode="mega", eos_id=eos, device=dev)
        return eng.run(requests)
    spec_fixed = Engine(model, paged=True, page_size=PAGE, **spec_kw)
    chunk_t = _Timed(model, "prefill_paged_chunk")
    decode_t = _Timed(model, "decode_step")
    requests = [(p, GEN_LEN) for p in prompts]
    spec_requests = [(p, SPEC_GEN) for p in spec_prompts]
    passes = {}  # speculative path -> [(pass timings, last_stats)] x 2

    def warm_then_reask(path, serve, stats):
        """A warm pass fills the radix tree; the re-ask drafts from it."""
        passes[path] = []
        got = []
        for _ in range(2):
            before = chunk_t.snapshot()
            t0 = time.perf_counter()
            got.append(serve())
            torch.cuda.synchronize()
            after = chunk_t.snapshot()
            passes[path].append(({
                "wall_s": time.perf_counter() - t0,
                "prefill_chunk_s": after[0] - before[0],
                "verify_s": after[2] - before[2],
                "verifies": after[3] - before[3],
            }, dict(stats())))
        return got

    runs = {  # path -> its serving call, in PATH_KERNELS order
        "continuous": lambda: eng.run(requests),
        "dense_engine": lambda: dense_eng.serve(dense_ids, DENSE_GEN,
                                                MAX_LENGTH),
        "continuous_int8": lambda: eng8.run(requests),
        "paged_engine_int8": lambda: paged8.serve(dense_ids, DENSE_GEN,
                                                  MAX_LENGTH),
        "continuous_spec": lambda: warm_then_reask(
            "continuous_spec", lambda: spec_eng.run(spec_requests),
            lambda: spec_eng.last_stats),
        "paged_engine_spec": lambda: warm_then_reask(
            "paged_engine_spec", lambda: spec_fixed.serve(
                np.stack(spec_prompts), SPEC_ENGINE_GEN, MAX_LENGTH),
            lambda: spec_fixed.last_stats),
        "dense_engine_mega": lambda: mega_dense.serve(
            dense_ids, DENSE_GEN, MAX_LENGTH, ns=8),
        "continuous_mega": continuous_mega,
    }
    launches, outs, times = {}, {}, {}
    for path, run in runs.items():
        before = (chunk_t.seconds, chunk_t.calls, decode_t.seconds)
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        outs[path] = run()
        torch.cuda.synchronize()
        launches[path] = ck.launch_counts()
        times[path] = {
            "wall_s": time.perf_counter() - t0,
            "chunk_s": chunk_t.seconds - before[0],
            "chunks": chunk_t.calls - before[1],
            "decode_s": decode_t.seconds - before[2],
        }

    mega_e2e = check_mega_paths(model, prompts, dense_ids, outs, times,
                                launches, mega_dense,
                                mega_engs["continuous_mega"])
    for path, e in (("continuous", eng), ("continuous_int8", eng8)):
        stats = e.last_stats
        problems = e.audit()
        print(f"[serve] {path}: {N_REQUESTS} requests in "
              f"{times[path]['wall_s']:.2f} s, "
              f"prefill_tokens={stats['prefill_tokens']} "
              f"prefix_hit_tokens={stats['prefix_hit_tokens']} "
              f"decode_steps={stats['decode_steps']} "
              f"kv_dtype={stats['kv_dtype']} audit={problems}")
        if problems:
            raise RuntimeError(f"{path}: pool audit failed: {problems}")
        if stats["prefix_hit_tokens"] <= 0:
            raise RuntimeError(f"{path}: no prefix-cache hits on "
                               "shared-prefix traffic")
    spec_e2e = check_spec_paths(passes, {"continuous_spec": spec_eng,
                                         "paged_engine_spec": spec_fixed})
    for path, counts in launches.items():
        print(f"[serve] launches in the {path} run: {counts}")
    for path, need in PATH_KERNELS.items():
        ran = {k for k, n in launches[path].items() if n > 0}
        if ran != set(need):
            raise RuntimeError(f"the {path} run launched {sorted(ran)}, "
                               f"expected {sorted(need)}")
    kv_bytes = {"bf16": eng.last_stats["kv_bytes_per_token"],
                "int8": eng8.last_stats["kv_bytes_per_token"]}
    print(f"[serve] kv_bytes_per_token {kv_bytes}")
    if not kv_bytes["int8"] < kv_bytes["bf16"] / 1.9:
        raise RuntimeError(f"int8 pool is not ~half the bf16 one: {kv_bytes}")

    for tag, paths, margin, min_exact in (
            ("bf16", ("continuous", "dense_engine"), TF_MARGIN, TF_MIN_EXACT),
            ("int8", ("continuous_int8", "paged_engine_int8"), TF8_MARGIN,
             TF8_MIN_EXACT)):
        cont, fixed = (outs[p] for p in paths)
        gaps = []
        for p, o in zip(prompts, cont):
            if o.shape != (GEN_LEN,):
                raise RuntimeError(f"bad output shape {o.shape}")
            gaps += teacher_forced_gaps(model, p, o)
        for row in range(DENSE_ROWS):
            gaps += teacher_forced_gaps(model, dense_ids[row],
                                        fixed[row, DENSE_PROMPT:])
        worst = max(gaps)
        exact = sum(g == 0 for g in gaps)
        print(f"[check] {tag} KV teacher forcing over {len(gaps)} generated "
              f"tokens: max gap {worst:.4f}, mean {statistics.mean(gaps):.4f}"
              f", exact argmax {exact}/{len(gaps)}, margin {margin}, "
              f"min exact share {min_exact}")
        if not all(np.isfinite(gaps)) or worst > margin:
            raise RuntimeError(f"{tag}: teacher-forced gap {worst} exceeds "
                               f"{margin}")
        if exact < min_exact * len(gaps):
            raise RuntimeError(f"{tag}: only {exact}/{len(gaps)} emitted "
                               f"tokens are the reference argmax "
                               f"(< {min_exact})")

    # The speculative streams (both passes of both paths) against the same
    # plain forward, with the bf16 limits.
    gaps = []
    for got in outs["continuous_spec"]:
        for p, o in zip(spec_prompts, got):
            if o.shape != (SPEC_GEN,):
                raise RuntimeError(f"bad speculative output shape {o.shape}")
            gaps += teacher_forced_gaps(model, p, o)
    for got in outs["paged_engine_spec"]:
        for row, p in enumerate(spec_prompts):
            gaps += teacher_forced_gaps(model, p, got[row, len(p):])
    worst, exact = max(gaps), sum(g == 0 for g in gaps)
    print(f"[check] speculative teacher forcing over {len(gaps)} generated "
          f"tokens: max gap {worst:.4f}, mean {statistics.mean(gaps):.4f}, "
          f"exact argmax {exact}/{len(gaps)}, margin {TF_MARGIN}, min exact "
          f"share {TF_MIN_EXACT}")
    if not all(np.isfinite(gaps)) or worst > TF_MARGIN:
        raise RuntimeError(f"speculative: teacher-forced gap {worst} exceeds "
                           f"{TF_MARGIN}")
    if exact < TF_MIN_EXACT * len(gaps):
        raise RuntimeError(f"speculative: only {exact}/{len(gaps)} emitted "
                           f"tokens are the reference argmax")

    def path_e2e(path, e):
        stats, t = e.last_stats, times[path]
        return {
            "prefill_tokens_per_s": stats["prefill_tokens"] / t["chunk_s"],
            "prefill_chunks": t["chunks"],
            "decode_ms_per_step_batch4": t["decode_s"] / max(
                stats["decode_steps"], 1) * 1e3,
            "decode_steps": stats["decode_steps"],
            "prefix_hit_tokens": stats["prefix_hit_tokens"],
            "continuous_wall_s": t["wall_s"],
        }

    e2e = {
        "model": MODEL,
        **path_e2e("continuous", eng),
        "dense_engine_decode_ms_per_step": dense_eng.last_stats[
            "decode_ms_per_step"],
        "int8": {
            **path_e2e("continuous_int8", eng8),
            "paged_engine_decode_ms_per_step": paged8.last_stats[
                "decode_ms_per_step"],
        },
        "kv_bytes_per_token": kv_bytes,
        "spec": spec_e2e,
        "mega": mega_e2e,
    }
    return launches, e2e


def check_mega_paths(model, prompts, dense_ids, outs, times, launches,
                     dense_eng, cont_eng) -> dict:
    """The megakernel serving paths: audit, launches, teacher forcing
    with the bf16 limits; returns their e2e block (decode ms per step
    and per emitted token, megakernel launches per emitted token)."""
    import numpy as np

    problems = cont_eng.audit()
    st = cont_eng.last_stats
    if problems:
        raise RuntimeError(f"continuous_mega: pool audit failed: {problems}")
    eos = cont_eng.eos_id
    gaps = []
    for p, o in zip(prompts, outs["continuous_mega"]):
        if not (o.shape == (GEN_LEN,) or (0 < len(o) < GEN_LEN
                                           and int(o[-1]) == eos)):
            raise RuntimeError(f"continuous_mega: bad output {o.shape}")
        gaps += teacher_forced_gaps(model, p, o)
    for row in range(DENSE_ROWS):
        gaps += teacher_forced_gaps(model, dense_ids[row],
                                    outs["dense_engine_mega"][row,
                                                              DENSE_PROMPT:])
    worst, exact = max(gaps), sum(g == 0 for g in gaps)
    print(f"[check] megakernel teacher forcing over {len(gaps)} generated "
          f"tokens: max gap {worst:.4f}, mean {statistics.mean(gaps):.4f}, "
          f"exact argmax {exact}/{len(gaps)}, margin {TF_MARGIN}, min exact "
          f"share {TF_MIN_EXACT}")
    if not all(np.isfinite(gaps)) or worst > TF_MARGIN:
        raise RuntimeError(f"megakernel: teacher-forced gap {worst} exceeds "
                           f"{TF_MARGIN}")
    if exact < TF_MIN_EXACT * len(gaps):
        raise RuntimeError(f"megakernel: only {exact}/{len(gaps)} emitted "
                           "tokens are the reference argmax")
    d_st = dense_eng.last_stats
    d_emit = DENSE_ROWS * (DENSE_GEN - 1)
    c_emit = st["generated_tokens"] - st["admitted"]
    c_decode_s = times["continuous_mega"]["wall_s"] - times[
        "continuous_mega"]["chunk_s"]
    for path, n in (("dense_engine_mega", d_st["mega_launches"]),
                    ("continuous_mega", st["mega_launches"])):
        if n <= 0:
            raise RuntimeError(f"{path}: mega_launches {n}")
    out = {
        "dense_engine_mega": {
            "decode_ms_per_step": d_st["decode_ms_per_step"],
            "decode_ms_per_emitted_token": d_st["decode_s"] / d_emit * 1e3,
            "mega_launches_per_emitted_token": launches["dense_engine_mega"][
                "mega_decode"] / d_emit,
            "mega_launches": d_st["mega_launches"],
            "decode_steps": d_st["decode_steps"],
        },
        "continuous_mega": {
            "decode_ms_per_step": c_decode_s / max(st["decode_steps"], 1)
            * 1e3,
            "decode_ms_per_emitted_token": c_decode_s / max(c_emit, 1) * 1e3,
            "mega_launches_per_emitted_token": launches["continuous_mega"][
                "mega_decode"] / max(c_emit, 1),
            "wall_s": times["continuous_mega"]["wall_s"],
            **{k: st[k] for k in (
                "decode_steps", "mega_launches", "mega_fallback_steps",
                "mega_bucket_launches", "mega_device_retires",
                "prefix_hit_tokens", "generated_tokens")},
            "eos_id": eos,
        },
    }
    print(f"[serve] megakernel paths: {json.dumps(out)}")
    return out


def check_spec_paths(passes: dict, engines: dict) -> dict:
    """The re-ask pass of each speculative path must have formed trees
    and accepted drafts, with a balanced ledger and a clean audit.
    Returns each path's ``spec`` block for the e2e line: tokens per
    target step, accept rate, decode-phase wall ms per emitted token and
    ms per verify chunk, for both passes."""
    out = {}
    for path, runs in passes.items():
        eng = engines[path]
        blocks = []
        for name, (t, st) in zip(("warm", "reask"), runs):
            if "admitted" in st:  # ContinuousEngine: one token per admission
                emitted = st["generated_tokens"] - st["admitted"]
                decode_s = t["wall_s"] - t["prefill_chunk_s"]
            else:  # Engine: each row's first token is the prefill's
                emitted = st["generated_tokens"] - SPEC_REQUESTS
                decode_s = st["decode_s"]
            blocks.append({
                "pass": name,
                "tokens_per_target_step": emitted / max(st["target_steps"],
                                                        1),
                "accept_rate": st["spec_accept_rate"],
                "decode_ms_per_emitted_token": decode_s / max(emitted, 1)
                * 1e3,
                "verify_chunk_ms": t["verify_s"] / max(t["verifies"], 1)
                * 1e3,
                **{k: st[k] for k in (
                    "target_steps", "decode_steps", "spec_verify_steps",
                    "spec_draft_tokens", "spec_accepted_tokens",
                    "spec_rollback_tokens", "spec_tree_rounds",
                    "spec_tree_nodes", "spec_tree_branch_accepts")},
            })
            print(f"[serve] {path} {name} pass: {json.dumps(blocks[-1])}")
        st = runs[-1][1]
        problems = eng.audit()
        if problems:
            raise RuntimeError(f"{path}: pool audit failed: {problems}")
        if st["spec_tree_rounds"] <= 0 or st["spec_accepted_tokens"] <= 0:
            raise RuntimeError(f"{path}: the re-ask formed no draft tree or "
                               f"accepted no draft: {blocks[-1]}")
        if st["spec_rollback_tokens"] != (st["spec_draft_tokens"]
                                          - st["spec_accepted_tokens"]):
            raise RuntimeError(f"{path}: rollback ledger unbalanced")
        if st["target_steps"] != st["decode_steps"] + st["spec_verify_steps"]:
            raise RuntimeError(f"{path}: target_steps != decode_steps + "
                               "spec_verify_steps")
        out[path] = blocks
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: the port's kernels need an NVIDIA GPU")
    try:
        from triton_distributed_tpu_torch.ops import cuda_kernels as ck
    except ImportError as e:
        return fail(f"the port is not importable from here ({e})")

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    print(card)
    t0 = time.perf_counter()
    ck.build()
    print(f"[build] {len(ck.SOURCES)} kernel libraries ready in "
          f"{time.perf_counter() - t0:.1f} s ({ck.BUILD_DIR})")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    records = check_kernels(dev, flush)
    records["mega_decode"] = check_mega(dev, flush)
    del flush
    check_tiny_serving(dev)
    launches, e2e = serve_main_path(dev)

    # "launches" counts the first path that must launch the kernel;
    # "launches_by_path" gives every path's own run.
    kernels = []
    for k in ck.KERNELS:
        first = next(p for p, need in PATH_KERNELS.items() if k.name in need)
        kernels.append({
            "name": k.name, "launches": launches[first][k.name],
            "launches_path": first,
            "launches_by_path": {p: c[k.name] for p, c in launches.items()},
            **records[k.name],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"e2e": e2e}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
