#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --only coll      # chosen phases (PHASES), alone

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
shared-prefix requests with an ``eos_id``, the same over an int8 pool
(``kv_dtype="int8"``), and ``Engine(paged=True, kv_dtype="int8",
mode="mega", mega_cfg=MegaConfig(wq8=True))`` serving the 2 rows from
int8 weights; then sampled serving (temperature, top-k, top-p): the 8
shared-prefix requests through ``ContinuousEngine(temperature=0.8,
top_p=0.95, top_k=64)`` with per-request overrides (two greedy, two
unfiltered), in ``mode="xla"`` and ``mode="mega"`` (the megakernel's
in-kernel Gumbel-max and top-k/top-p filter), each three times (seed,
same seed, another seed); the 2 rows through ``Engine(paged=True,
mode="mega", temperature=0.7, top_k=64)``; the speculative traffic at
temperature 0.05; then the device task tracer and the resident pipeline:
``Engine(paged=False, mode="mega", kernel_trace=True)`` serving the 2
rows and ``ContinuousEngine(mode="mega", ns=8, resident=True,
kernel_trace=True)`` the 8 shared-prefix requests (the tokens of the
untraced paths, every ring valid against its scheduled order and its
doorbell); then the prefill megakernel: ``MegaQwen3.prefill`` of a
right-padded 256-row prompt and 32 greedy tokens decoded from its cache,
with the model's weights and with int8 weights (held against the plain
version, the ``xla`` prefill or the dequantized golden, and teacher
forcing); then the tensor-parallel paths (Qwen3-8B and Qwen3-30B-A3B at
tp=2, modes pallas and mega); then expert parallelism: ``ep_moe_ffn`` over
2 and 4 co-located ranks at Qwen3-30B-A3B's MoE widths (one layer, 128
and 1024 tokens a rank; transports ``pallas``, the EP exchange kernel, and
``xla``, which must agree bit for bit; bf16 and fp8 payloads, lossless and
at capacity 1.25, a skewed router), held to a dense f32 golden, with the
count mask's negative control, a lagging rank, back-to-back launches and
the dense ``all_to_all_op``; then sequence parallelism at Qwen3-8B's
geometry over one 32768-token causal sequence: ``sp_ag_attention`` over 2
and 4 ranks (every rank's first and last q tile against the plain
version, the whole output against the single-card ``flash_attention``, a
zeroed-chunk control, f32 at 4096 tokens, back-to-back launches),
``ring_attention``, ``sp_decode_attention`` and ``distributed_flash_decode``
(bf16 and int8, pallas and xla) and the two-level variants over dp x tp =
2 x 2; then the remaining collectives at Qwen3-8B's width over co-located
ranks: ``pp_shift`` of a 2048-token prefill micro-batch and a decode one,
the pull all-gather at windows 1-3, ``all_gather_torus_2d`` over dp x tp =
2 x 4, ``broadcast``, 64 chained ``ll_all_gather`` calls at n = 4 and 8
(the ACK flags checked after) and the two-level ops, every output bitwise
its plain version, NaN-filled outputs and odd row widths. Before the serving paths the decode megakernel is held
against its plain version at Qwen3-0.6B's full width and depth (B=4,
kv_len {700, 2040, 700, 2040}, NS 1 and 8; dense and paged caches, the
int8 pool, int8 weights over the paged pool and over the int8 pool),
each with a negative control that must break the limit (the plain
version with the last layer skipped, with the K and V scale planes
swapped, or with the qkv scales set to 1), and timed beside the
``mode="xla"`` decode steps at the same shape (bf16 and int8 pools).
The megakernel's sampled and filtered launches are held against the
plain version on the same seeded noise (the filter alone: the winner
over the kernel's own logits is an exact filter's, up to the order of
the top-p sums; negative controls: a top-k 1 row, and noise planted on a
filtered row's lowest token) and timed beside the greedy one; its traced
launches against the untraced ones (bit for bit; the ring valid, the
work ring's doorbell stamped, another doorbell refused), with the step
split by task from the ring; the prefill megakernel against its plain
version (the last layer skipped as the negative control), timed beside
the ``xla`` prefill. The generated tokens
are checked by teacher forcing through a plain full-sequence forward
(for the int8-weight path, a forward whose decode weights are the
dequantized int8 weights, over the prompt's K/V from the model's own;
a filtered token must lie in its row's plain keep-set up to the margin,
and the same check at top-k 1 must fail somewhere; an unfiltered token
within a tail limit scaled by T, and at T 0.8 its draws as a whole by a
z statistic that uniform and argmax tokens must break), the pool audit must
be clean, sampled runs must replay under their seed, and each serving path
must have launched its own kernels: the launch counts are set to 0 just
before each path and read just after it.

Output: the card's name and power limit, per-phase lines, one
``{"kernels": [...]}`` JSON line, one ``{"e2e": ...}`` JSON line, and as
the last line ``{"ok": true, "device": {...}}``. Any failure exits
non-zero before that line; so does a machine without CUDA or a
directory without the port.
"""

from __future__ import annotations

import argparse
import importlib
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
    # The same over an int8 pool (prefill through flash_attention_int8,
    # no paged_flash_decode_int8), and the Engine with int8 weights over
    # an int8 pool (dense prefill through flash_attention, quantized on
    # the write into the pages).
    "continuous_mega_int8": ("flash_attention_int8", "mega_decode"),
    "paged_engine_mega_wq8": ("flash_attention", "mega_decode"),
    # The device task tracer and the resident pipeline: every ns-step
    # launch is traced (its single-step remainders, Engine's, are not);
    # the prefill megakernel, then the dense mega decode from its cache.
    "dense_engine_mega_traced": ("flash_attention", "mega_decode",
                                 "mega_decode_traced"),
    "continuous_mega_resident": ("flash_attention", "mega_decode_traced"),
    "mega_prefill": ("mega_prefill", "mega_decode"),
    "mega_prefill_wq8": ("mega_prefill", "mega_decode"),
    # Long context: the sharded slot's prefill chunks merge a resident
    # partial (flash_attention, causal) with a cold partial
    # (flash_attention_cold); its decode steps a resident paged partial
    # with a cold dense one (flash_decode); the short requests beside it
    # prefill through flash_attention and decode batched.
    "continuous_longctx": ("flash_attention", "flash_attention_cold",
                           "paged_flash_decode", "flash_decode"),
    "continuous_longctx_int8": ("flash_attention_int8",
                                "flash_attention_cold_int8",
                                "paged_flash_decode_int8",
                                "flash_decode_int8"),
    # Sampled serving: the xla paths sample the logits on the host; the
    # mega paths sample in the megakernel (the Gumbel noise, and the
    # top-k/top-p filter); sampled speculation verifies chains with
    # flash_attention and trees with flash_attention_bias.
    "continuous_sampled": ("flash_attention", "paged_flash_decode"),
    "continuous_mega_sampled": ("flash_attention", "mega_decode"),
    "paged_engine_mega_sampled": ("flash_attention", "mega_decode"),
    "continuous_spec_sampled": ("flash_attention", "flash_attention_bias",
                                "paged_flash_decode"),
}
# Sampled traffic: the 8 shared-prefix requests under the engine's knobs
# SAMPLED_KNOBS, requests 0-1 overriding temperature 0 (greedy) and 2-3
# top_p 1, top_k 0 (unfiltered sampling), each continuous run made with
# seed SEED twice and SEED + 1 once; the 2 dense rows through a paged mega
# Engine at SAMPLED_ENGINE_KNOBS; the speculative traffic at
# SAMPLED_SPEC_T. Each sampled token is held to the plain full-sequence
# forward's logits q at its position:
# - a filtered token (top-k or top-p narrower than the vocabulary) must
#   lie in its row's keep-set up to the pool's teacher-forcing margin: its
#   plain logit at or above the lowest kept plain logit less TF_MARGIN;
# - an unfiltered token, whose keep-set is the whole vocabulary, must lie
#   within TF_MARGIN + SAMPLED_TAIL·T of the plain maximum: a draw from
#   softmax(q/T) lands further down with probability below
#   V·exp(-SAMPLED_TAIL) < 2e-8 at V = 151936, and TF_MARGIN covers the
#   engine's bf16 logits against the plain ones, as for greedy tokens.
#   At T 0.05 that keeps a few tokens near the top; at T 0.8 it keeps
#   nearly all, so there the draws are held as a whole: with lq the
#   token's log softmax(q/T), z = sum(lq - E lq) / sqrt(sum Var lq) over
#   the positions is a sum of deviations that each have mean 0 given the
#   tokens before them, so |z| <= SAMPLED_Z for a right sampler, while
#   uniform tokens (E lq lower by ~1/T^2 per position with ~N(0, 1)
#   logits, z ~ -sqrt(n)/T) and the argmax tokens must each break it.
SAMPLED_KNOBS = dict(temperature=0.8, top_p=0.95, top_k=64)
SAMPLED_OVERRIDES = ([dict(temperature=0.0)] * 2
                     + [dict(top_p=1.0, top_k=0)] * 2 + [{}] * 4)
SAMPLED_ENGINE_KNOBS = dict(temperature=0.7, top_k=64)
SAMPLED_SPEC_T = 0.05
SAMPLED_TAIL = 30.0
SAMPLED_Z = 5.0
# Long-context traffic: one LONG_PROMPT-token request over a
# LONG_BUDGET-token per-rank page budget (so it admits as a sharded slot
# and demotes its oldest pages to a LONG_TIER_BYTES host tier), served
# with LONG_SHORTS requests that share the PREFIX_LEN prefix, all with
# GEN_LEN tokens. The short requests come first in the queue, so the
# batched decode runs between the long prefill's chunks and beside its
# sharded decode steps.
LONG_PROMPT, LONG_BUDGET, LONG_MAX_LENGTH = 3584, 2048, 4096
LONG_SHORTS, LONG_TIER_BYTES = 3, 512 << 20
# The long request's pages past the budget: 28 prompt pages over a
# 16-page budget demote 12 during the prefill.
LONG_MIN_DEMOTED = (LONG_PROMPT - LONG_BUDGET) // PAGE
# The decode megakernel's check: Qwen3-0.6B, B=4, these cached lengths,
# launch widths NS. Limit on logits |kernel - plain| <= atol + rtol·|plain|.
# bf16: both round every GEMM input to bf16 at the same places, so they
# differ by f32 summation order plus the bf16 roundings it flips; the
# first readings on an H100 were 0.067-0.099 (PERF.md §2), and the limit
# is 1.5x the worst. f32 (TF32 off) differs in summation order only.
# A bf16 greedy token may leave the plain stream only where the plain
# logits put it within MEGA_TIE_GAP of the plain top: the kernel's measured
# logit error (0.099 at worst, PERF.md §2), not the whole limit.
# The long-context cold partials at Qwen3-0.6B: a page-row prefill chunk
# (and one decode row) against a cold window of COLD_PAGES pages, with
# s_cold (valid cold tokens) at each of COLD_S; timed at COLD_TIMED. The
# plain version with s_cold one page off must break the limit.
COLD_PAGES = 16
COLD_S = (0, 1536, 2048)
COLD_TIMED = 1536
MEGA_LENS = (700, 2040, 700, 2040)
MEGA_NS = (1, 8)
MEGA_TOL = {"bf16": (0.15, 2.0**-6), "f32": (2e-3, 0.0)}
MEGA_TIE_GAP = 0.1
# Card peaks (H100 SXM data sheet, dense): HBM bytes/s, bf16/f16 FLOP/s.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12       # outside the tensor cores (f32 with TF32 off)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# A ~5 ms spin kernel (cycles at the H100's ~1.98 GHz boost clock) put
# ahead of each timed call, so the host enqueues the call's launches while
# the card is still busy and the events time device work, not the
# wrapper's Python.
LEAD_CYCLES = 10_000_000


def median_ms(fn, flush, iters: int = 15, warmup: int = 3,
              device_only: bool = True) -> float:
    """Median CUDA-event time of ``fn`` with L2 flushed before each
    launch (a serving step finds each layer's KV cold in L2). With
    ``device_only`` a spin kernel leads each call, so a call whose
    launches take less device time than host time to enqueue is timed by
    its device work; without it the time is a step's, host gaps
    included."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        if device_only:
            torch.cuda._sleep(LEAD_CYCLES)
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


def gather_copy(parts):
    """The all-gathers' library call: one copy_ of the stacked shards into
    every rank's output, as a gather writes n outputs."""
    import torch

    k, src = len(parts), torch.stack(parts)
    dst = torch.empty((k, *src.shape), dtype=src.dtype, device=src.device)
    return lambda: dst.copy_(src.expand(k, *src.shape))


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

    # The long-context cold partials: a 128-row chunk and a decode row
    # against a 16-page cold window, s_cold in COLD_S (0: every column
    # masked, or an empty decode context), model dtype and int8.
    from triton_distributed_tpu_torch.layers.tp_attn import cold_mask

    csk = COLD_PAGES * PAGE
    cold_controls = []  # (name, tag, s_cold, kernel out, plain one page off)
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        qc = rand((1, hq, PAGE, d), dtype)
        qd1 = rand((1, hq, d), dtype)
        kc, vc = rand((1, hkv, csk, d), dtype), rand((1, hkv, csk, d), dtype)
        kb, kbs = int8_pool((hkv, COLD_PAGES, PAGE, d))
        vb, vbs = int8_pool((hkv, COLD_PAGES, PAGE, d))
        k8c, v8c = kb.reshape(1, hkv, csk, d), vb.reshape(1, hkv, csk, d)
        kbs, vbs = kbs[None].contiguous(), vbs[None].contiguous()
        k8d, v8d = (x.float() * sc.repeat_interleave(PAGE, dim=-1)[..., None]
                    for x, sc in ((k8c, kbs), (v8c, vbs)))
        q8 = dict(block_k=PAGE, k_scale=kbs, v_scale=vbs)
        for name in ("flash_attention_cold", "flash_attention_cold_int8",
                     "flash_decode_int8"):
            errs[name, tag] = []
        for s_cold in COLD_S:
            bias = cold_mask(PAGE, csk, s_cold, dev)
            off_bias = cold_mask(PAGE, csk, s_cold - PAGE if s_cold else PAGE,
                                 dev)
            lens = torch.tensor([s_cold], dtype=torch.int32, device=dev)
            off_lens = lens - PAGE if s_cold else lens + PAGE
            for name, o, plain, wrong in (
                ("flash_attention_cold",
                 flash_attention(qc, kc, vc, causal=False, bias=bias),
                 mha_reference(qc, kc, vc, causal=False, bias=bias),
                 mha_reference(qc, kc, vc, causal=False, bias=off_bias)),
                ("flash_attention_cold_int8",
                 flash_attention(qc, k8c, v8c, causal=False, bias=bias, **q8),
                 mha_reference(qc, k8d, v8d, causal=False, bias=bias),
                 mha_reference(qc, k8d, v8d, causal=False, bias=off_bias)),
                ("flash_decode_int8",
                 flash_decode(qd1, k8c, v8c, lens, chunk_k=PAGE,
                              k_scale=kbs, v_scale=vbs),
                 gqa_decode_reference(qd1, k8d, v8d, lens),
                 gqa_decode_reference(qd1, k8d, v8d, off_lens)),
            ):
                errs[name, tag].append(err(o, plain))
                cold_controls.append((name, tag, s_cold, o, wrong))
        if tag == "bf16":
            timed_cold = (qc, qd1, kc, vc, k8c, v8c, kbs, vbs, k8d, v8d)

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
    for name, tag, s_cold, o, wrong in cold_controls:
        atol, rtol = TOL[tag]
        diff, plain = err(o, wrong)
        used = (diff / (atol + rtol * plain)).max().item()
        print(f"[kernels] {name} {tag} s_cold={s_cold} vs the plain version "
              f"with s_cold one page off: {used:.1f}x the limit (must "
              "exceed 1)")
        if not used > 1.0:
            raise RuntimeError(f"s_cold one page off passes the {name} limit "
                               f"({tag}, s_cold {s_cold})")

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
    records.update(cold_records(dev, flush, timed_cold, max_abs))
    return records


def cold_records(dev, flush, timed_cold, max_abs) -> dict:
    """Times, bounds and library calls of the three cold-partial kernels
    at the bf16 serving shape, s_cold = COLD_TIMED. The functions read
    only the cold columns below s_cold (the rest are masked), so the
    bounds count those columns' K/V (codes and scales), the whole bias,
    q, O and the LSE."""
    import torch
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.layers.tp_attn import cold_mask
    from triton_distributed_tpu_torch.ops.attention import (
        flash_attention,
        flash_decode,
        gqa_decode_reference,
        mha_reference,
    )

    qc, qd1, kc, vc, k8c, v8c, kbs, vbs, k8d, v8d = timed_cold
    _, hq, sq, d = qc.shape
    hkv, csk = kc.shape[1], kc.shape[2]
    vis = COLD_TIMED
    bias = cold_mask(sq, csk, vis, dev)
    lens = torch.tensor([vis], dtype=torch.int32, device=dev)
    q8 = dict(block_k=PAGE, k_scale=kbs, v_scale=vbs)
    flops = 4 * hq * d * sq * vis
    io = nbytes(qc) * 2 + hq * sq * 4 + sq * csk * 4  # q, O, LSE, bias
    kv16 = 2 * hkv * vis * d * kc.element_size()
    kv8 = 2 * hkv * vis * d + 2 * hkv * (vis // PAGE) * 4

    def bound(fl, by):
        return dict(bound_ms=max(fl / BF16_FLOPS, by / HBM_BPS) * 1e3,
                    bound_by="operations" if fl / BF16_FLOPS > by / HBM_BPS
                    else "bytes")

    def dequant_attn():
        kd_ = k8c.float() * kbs.repeat_interleave(PAGE, dim=-1)[..., None]
        vd_ = v8c.float() * vbs.repeat_interleave(PAGE, dim=-1)[..., None]
        return mha_reference(qc, kd_, vd_, causal=False, bias=bias,
                             return_lse=True)

    def dequant_decode():
        kd_ = k8c.float() * kbs.repeat_interleave(PAGE, dim=-1)[..., None]
        vd_ = v8c.float() * vbs.repeat_interleave(PAGE, dim=-1)[..., None]
        return gqa_decode_reference(qd1, kd_, vd_, lens, return_lse=True)

    src = "triton_distributed_tpu_torch/csrc/"
    shape = (f"q[1,{hq},{sq},{d}] cold kv[1,{hkv},{csk},{d}] s_cold={vis} "
             f"bias [{sq},{csk}]")
    amask = bias.to(qc.dtype)
    return {
        "flash_attention_cold": dict(
            route="cuda", source=src + "flash_attention.cu",
            replaces="triton_distributed_tpu/ops/attention/"
                     "flash_attention.py:32",
            max_abs_err=max(max_abs["flash_attention_cold", "bf16"],
                            max_abs["flash_attention_cold", "f32"]),
            ms=median_ms(lambda: flash_attention(
                qc, kc, vc, causal=False, bias=bias, return_lse=True),
                flush),
            plain_ms=median_ms(lambda: mha_reference(
                qc, kc, vc, causal=False, bias=bias, return_lse=True),
                flush),
            library_ms=median_ms(lambda: F.scaled_dot_product_attention(
                qc, kc, vc, attn_mask=amask, enable_gqa=True), flush),
            library_note="SDPA with attn_mask=bias returns O, not the LSE "
                         "the combine needs",
            shape=shape + " bf16", **bound(flops, io + kv16)),
        "flash_attention_cold_int8": dict(
            route="cuda", source=src + "flash_attention.cu",
            replaces="triton_distributed_tpu/ops/attention/"
                     "flash_attention.py:32",
            max_abs_err=max(max_abs["flash_attention_cold_int8", "bf16"],
                            max_abs["flash_attention_cold_int8", "f32"]),
            ms=median_ms(lambda: flash_attention(
                qc, k8c, v8c, causal=False, bias=bias, return_lse=True,
                **q8), flush),
            plain_ms=median_ms(dequant_attn, flush),
            library_ms=None,
            shape=shape + f" int8 block_k={PAGE}, bf16 q/o",
            **bound(flops, io + kv8)),
        "flash_decode_int8": dict(
            route="cuda", source=src + "flash_decode.cu",
            replaces="triton_distributed_tpu/ops/attention/"
                     "flash_decode.py:98",
            max_abs_err=max(max_abs["flash_decode_int8", "bf16"],
                            max_abs["flash_decode_int8", "f32"]),
            ms=median_ms(lambda: flash_decode(
                qd1, k8c, v8c, lens, chunk_k=PAGE, return_lse=True,
                k_scale=kbs, v_scale=vbs), flush),
            plain_ms=median_ms(dequant_decode, flush),
            library_ms=None,
            shape=f"q[1,{hq},{d}] cold kv[1,{hkv},{csk},{d}] int8 "
                  f"chunk_k={PAGE} s_cold={vis}, bf16 q/o",
            **bound(4 * hq * d * vis, nbytes(qd1) * 2 + hq * 4 + kv8)),
    }


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


def _mega_bound(cfg, params, q8, kv8) -> dict:
    """The least time of one decode step of the megakernel at MEGA_LENS:
    the larger of its bytes over the HBM rate and its FLOPs over the bf16
    peak. Bytes: every layer weight, the norms, the LM head (int8 codes
    plus their f32 scales under wq8), every cached K/V row (int8 codes
    plus each touched page's two f32 scales over an int8 pool), the
    embed rows, the logits and the new K/V rows out. FLOPs: every GEMM
    for each row, and QK^T plus P·V over each row's cache."""
    lp, L = params["layers"], cfg.num_layers
    b, hkv, hd = len(MEGA_LENS), cfg.num_kv_heads, cfg.head_dim
    item = params["embed"].element_size()
    proj = (lp["attn"]["wqkv"], lp["attn"]["wo"], lp["mlp"]["w1"],
            lp["mlp"]["w2"], params["lm_head"])
    n_weights = sum(t.numel() for t in proj)
    weights = n_weights * (1 if q8 else item)
    if q8:  # one f32 scale per output column
        weights += 4 * sum(t[..., 0, :].numel() for t in proj)
    weights += sum(t.numel() * item for t in (
        lp["ln1"], lp["ln2"], lp["attn"]["q_norm"], lp["attn"]["k_norm"],
        params["norm"]))
    kv = sum(MEGA_LENS) * L * hkv * hd * 2 * (1 if kv8 else item)
    if kv8:
        kv += sum(-(-n // PAGE) for n in MEGA_LENS) * L * hkv * 2 * 4
    out = b * params["lm_head"].shape[1] * 4 + 2 * L * b * hkv * hd * item
    step_bytes = weights + kv + out + b * cfg.hidden_size * item
    flops = 2 * b * n_weights + 4 * (
        cfg.num_q_heads * hd * L * sum(MEGA_LENS))
    t_bytes, t_ops = step_bytes / HBM_BPS, flops / BF16_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "step_bytes": step_bytes}


# The megakernel's sampled and filtered launches (paged bf16, MEGA_LENS,
# MEGA_NS), per row (temperature, top_p, top_k): sampled, rows 0 and 2
# greedy and rows 1 and 3 at T 0.8; filtered, row 0 greedy, row 1 top-k
# 64, row 2 top-k 1 at T 1 (its winner must be the clean argmax: the
# negative control of the noise), row 3 top-p 0.9.
MEGA_SAMPLED_ROWS = {
    "sampled": [(0.0, 1.0, 0), (0.8, 1.0, 0), (0.0, 1.0, 0), (0.8, 1.0, 0)],
    "filtered": [(0.0, 1.0, 0), (0.8, 1.0, 64), (1.0, 1.0, 1),
                 (0.8, 0.9, 0)],
}


# The top-p cut's sandwich: the kernel sums the nucleus weights in f32 in
# its own order, so an exact filter may cut anywhere between the keep-set
# at p·Z·(1 - TOPP_BAND) and the one at p·Z·(1 + TOPP_BAND). Summing
# 151936 f32 weights is off by ~1e-6·Z at most (log2 of the count times
# an f32 ulp); the band is ten times that.
TOPP_BAND = 1e-5
# The noise planted on a filtered row's lowest-logit token in the
# negative control: far above any logit, so an unfiltered argmax takes it.
PLANTED_NOISE = 1e4


def filter_band(logits, noise, sampcfg, v_real, band=TOPP_BAND) -> list:
    """For each row of ``logits [B, Vp]`` f32 under ``sampcfg [B, 4]``
    (rows ``[1/T, k, p, enable]``): the tokens that an exact top-k/top-p
    filter may pick by the argmax of ``logits + noise`` (first column on
    ties), on the host in float64. Top-k counts are exact. The top-p cut
    is sandwiched: each keep-set between the one at p·Z·(1 - band) and the
    one at p·Z·(1 + band), every one a prefix of the top-k survivors by
    scaled logit (ties together), gives its noisy argmax as a candidate.
    A row without top-p, or with ``enable`` 0, has one candidate. Returns
    per row ``{"winners": set, "cuts": candidate keep-sets, "keep_max":
    size of the widest}``."""
    import numpy as np
    import torch

    lg, nz, cfg = (t.detach().to("cpu", torch.float32).numpy()
                   for t in (logits, noise, sampcfg))
    lg, nz = lg[:, :v_real], nz[:, :v_real]
    out = []
    for b in range(lg.shape[0]):
        inv_t, k, p, en = cfg[b]
        score = lg[b] + nz[b]  # f32, as the kernel adds them
        if en <= 0:
            out.append({"winners": {int(np.argmax(score))}, "cuts": 1,
                        "keep_max": v_real})
            continue
        ls = lg[b] * inv_t  # f32, as the kernel scales them
        order = np.argsort(-ls, kind="stable")
        s = ls[order].astype(np.float64)
        m = int(np.count_nonzero(s >= s[min(int(k), v_real) - 1]))
        s, order = s[:m], order[:m]
        ends = np.flatnonzero(np.append(s[1:] != s[:-1], True))
        cum = np.cumsum(np.exp(s - s[0]))[ends]
        g_lo = g_hi = len(ends) - 1
        if p < 1.0:  # the first cut whose weight reaches the target
            g_lo = int(np.searchsorted(cum, p * cum[-1] * (1.0 - band)))
            g_hi = min(int(np.searchsorted(cum, p * cum[-1] * (1.0 + band))),
                       g_hi)
        head = order[: ends[g_lo] + 1]
        best = head[score[head] == score[head].max()].min()
        winners = {int(best)}
        for g in range(g_lo + 1, g_hi + 1):
            for j in order[ends[g - 1] + 1: ends[g] + 1]:
                if score[j] > score[best] or (score[j] == score[best]
                                              and j < best):
                    best = j
            winners.add(int(best))
        out.append({"winners": winners, "cuts": g_hi - g_lo + 1,
                    "keep_max": int(ends[g_hi]) + 1})
    return out


def _planted_control(comp, w, args, noise, cfg, got, bands, v_real) -> dict:
    """The filter's negative control: the launch again with PLANTED_NOISE
    added at the last step on the lowest-logit token of each filtered row
    whose widest band keep-set leaves it out. The noise only picks the
    winner, so the last step's logits and the earlier tokens stay as they
    were; the kernel's winner must still be an exact filter's and not the
    planted token, while the unfiltered noisy argmax is the planted
    token: a kernel that skipped the filter would have taken it."""
    import torch

    logits, toks = got[0], got[3]
    rows = [i for i, bd in enumerate(bands)
            if float(cfg[i, 3]) > 0 and bd["keep_max"] < v_real]
    low = logits[:, :v_real].argmin(dim=1).tolist()
    planted = noise.clone()
    for i in rows:
        planted[-1, i, low[i]] += PLANTED_NOISE
    again = comp.run(w, *args, noise=planted, sampcfg=cfg)
    torch.cuda.synchronize()
    bad = [] if rows else ["no filtered row leaves its lowest token out"]
    if not (torch.equal(again[0], logits)
            and torch.equal(again[3][:-1], toks[:-1])):
        bad.append("the planted noise moved the logits or an earlier token")
    new = filter_band(logits, planted[-1], cfg, v_real)
    for i in rows:
        took = int(again[3][-1, i])
        unfiltered = int((logits[i, :v_real]
                          + planted[-1, i, :v_real]).argmax())
        if took == low[i] or took not in new[i]["winners"] or (
                unfiltered != low[i]):
            bad.append(dict(row=i, took=took, planted=low[i],
                            unfiltered=unfiltered))
    return {"rows": rows, "bad": bad}


def _sampled_tokens_ok(toks, ref_toks, plain_at, noise, cfg, v_real):
    """Kernel vs plain sampled tokens [NS, B] on the same noise. A row may
    leave the plain stream only where the plain logits of the first
    differing step allow the kernel's token: an exact filter over them
    may pick it (``filter_band``: the top-p cut's sandwich), or it is a
    near tie the plain version cannot resolve: its noisy score within
    MEGA_TIE_GAP below the plain winner's and (filtered rows) its logit
    within MEGA_TIE_GAP below the plain keep-set's lowest logit. Returns
    the records of the rows that left; raises otherwise."""
    import torch

    from triton_distributed_tpu_torch.models import sampling

    ties = []
    for b in (toks != ref_toks).any(dim=0).nonzero().flatten().tolist():
        s = int((toks[:, b] != ref_toks[:, b]).nonzero()[0])
        lg = plain_at(s)
        top, got = int(ref_toks[s, b]), int(toks[s, b])
        row = lg[b, :v_real]
        score = row + noise[s, b, :v_real]
        gap = (score[top] - score[got]).item()
        inv_t, k, p, en = cfg[b].tolist()
        edge = float("-inf")
        if en > 0:
            kept = torch.isfinite(sampling.filter_logits(
                row, 1.0 / inv_t, p, int(k) if k < v_real else 0))
            edge = (row[kept].min() - row[got]).item()
        exact = got in filter_band(lg[b: b + 1], noise[s, b: b + 1],
                                   cfg[b: b + 1], v_real)[0]["winners"]
        ties.append(dict(row=b, step=s, gap=gap, edge=edge,
                         in_band=exact))
        if not (exact or (gap <= MEGA_TIE_GAP and edge <= MEGA_TIE_GAP)):
            raise RuntimeError(f"sampled kernel token {got} at row {b} step "
                               f"{s} is not a near tie of plain's {top}: "
                               f"score gap {gap}, keep edge {edge}")
    return ties


def check_mega_sampled(dev, flush, model, mega, w, args, greedy_ms) -> dict:
    """The megakernel's sampled and filtered launches against the plain
    version on the same seeded noise, at Qwen3-0.6B over the paged bf16
    pool, NS 1 and 8: tokens (up to a near tie, ``_sampled_tokens_ok``)
    and logits (the bf16 limit) of the plain version; the greedy rows'
    tokens equal the greedy launch's bit for bit; two launches
    bit-identical; the filter alone (the kernel's last-step winner is one
    that an exact filter picks over the kernel's own last-step logits and
    noise, ``filter_band``: ``filtered_winner_plain``'s, or another cut of
    the top-p sandwich); the top-k 1 row's winner is the clean argmax
    while the unfiltered noisy argmax is not; the planted control
    (``_planted_control``). Times each launch per step beside the greedy
    one. Returns its record."""
    import dataclasses

    import torch

    from triton_distributed_tpu_torch.megakernel.kernels import (
        mega_decode_plain,
    )
    from triton_distributed_tpu_torch.models import sampling

    b, V = len(MEGA_LENS), model.cfg.vocab_size
    atol, rtol = MEGA_TOL["bf16"]
    rec, bad = {"near_ties": [], "topp_band_rows": 0,
                "topp_band_two_winners": 0, "filter_alone_differ": 0}, []
    for kind, rows in MEGA_SAMPLED_ROWS.items():
        filt = kind == "filtered"
        for ns in MEGA_NS:
            base = dataclasses.replace(
                mega._dims(b, MAX_LENGTH, PAGE,
                           num_pages=int(args[0].shape[1])),
                nsteps=ns, v_real=V)
            dims = dataclasses.replace(base, sampled=True, filtered=filt)
            comp, greedy = mega._compile(dims), mega._compile(base)
            gen = torch.Generator(device=dev).manual_seed(SEED + 4)
            temps = torch.tensor([t for t, _, _ in rows], device=dev)
            noise = sampling.gumbel((ns, b, dims.v_loc), gen, dev) \
                * temps[None, :, None]
            cfg = torch.tensor([sampling.sampcfg_row(*r, V) for r in rows],
                               dtype=torch.float32, device=dev)
            samp = {"noise": noise, "sampcfg": cfg if filt else None}
            got = comp.run(w, *args, **samp)
            again = comp.run(w, *args, **samp)
            g_toks = greedy.run(w, *args)[3]
            torch.cuda.synchronize()
            ref = mega_decode_plain(dims, True, comp.table, w, *args, **samp)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise RuntimeError(f"mega_decode {kind} NS={ns}: two "
                                   "launches on the same inputs differ")

            def plain_at(s, dims=dims, table=comp.table, noise=noise,
                         samp=samp):
                d1 = dataclasses.replace(dims, nsteps=s + 1)
                return mega_decode_plain(
                    d1, True, table, w, *args,
                    noise=noise[: s + 1].contiguous(),
                    sampcfg=samp["sampcfg"])[0]

            logits, toks = got[0], got[3]
            ties = _sampled_tokens_ok(toks, ref[3], plain_at, noise, cfg, V)
            rec["near_ties"] += [dict(kind=kind, ns=ns, **t) for t in ties]
            greedy_rows = [i for i, (t, _, _) in enumerate(rows) if t == 0]
            if not torch.equal(toks[:, greedy_rows], g_toks[:, greedy_rows]):
                bad.append(f"{kind} NS={ns}: greedy rows differ from the "
                           "greedy launch")
            keep = (toks[:-1] == ref[3][:-1]).all(dim=0)
            err = (logits - ref[0]).abs()[keep]
            used = (err / (atol + rtol * ref[0].abs()[keep])).max().item()
            if not used <= 1.0:
                bad.append(f"{kind} NS={ns}: logits use {used} of the limit")
            line = (f"[mega] sampled {kind} NS={ns}: tokens == plain up to "
                    f"near ties {ties}, greedy rows == the greedy launch, "
                    f"logits {used:.3f} of the limit")
            if filt:
                want = sampling.filtered_winner_plain(logits, noise[-1], cfg,
                                                      V)
                bands = filter_band(logits, noise[-1], cfg, V)
                last = toks[-1].tolist()
                differ = [i for i in range(b) if last[i] != int(want[i])]
                off = [i for i in range(b)
                       if last[i] not in bands[i]["winners"]]
                banded = [i for i in range(b) if bands[i]["cuts"] > 1]
                torn = [i for i in range(b) if len(bands[i]["winners"]) > 1]
                rec["topp_band_rows"] += len(banded)
                rec["topp_band_two_winners"] += len(torn)
                rec["filter_alone_differ"] += len(differ)
                clean = int(logits[2, :V].argmax())
                noisy = int((logits[2, :V] + noise[-1, 2, :V]).argmax())
                if off:
                    bad.append(f"{kind} NS={ns}: the filter alone picked a "
                               f"token no exact filter picks on rows {off}")
                if last[2] != clean or noisy == clean:
                    bad.append(f"{kind} NS={ns}: top_k=1 row took "
                               f"{last[2]}, clean argmax {clean}, noisy "
                               f"argmax {noisy} (must differ)")
                planted = _planted_control(comp, w, args, noise, cfg, got,
                                           bands, V)
                if planted["bad"]:
                    bad.append(f"{kind} NS={ns}: planted control "
                               f"{planted['bad']}")
                line += (f"; filter alone: the winner is an exact filter's "
                         f"on {b - len(off)}/{b} rows (rows {banded} have a "
                         f"top-p band of {[bands[i]['cuts'] for i in banded]}"
                         f" cuts, rows {torn} more than one winner in it; "
                         f"differs from filtered_winner_plain on rows "
                         f"{differ}); top_k=1 row {clean} == the clean "
                         f"argmax, unfiltered noisy argmax {noisy}; planted "
                         f"control: rows {planted['rows']} kept their "
                         f"filters, the unfiltered argmax took the planted "
                         f"token on each")
            print(line)
            ms = median_ms(lambda: comp.run(w, *args, **samp), flush)
            rec[f"{kind}_ms_per_step_ns{ns}"] = ms / ns
            print(f"[mega] {kind} NS={ns}: {ms:.4f} ms per launch, "
                  f"{ms / ns:.4f} ms per step (greedy "
                  f"{greedy_ms[ns] / ns:.4f})")
    if bad:
        raise RuntimeError(f"sampled mega_decode: {bad}")
    # The noise is read once per step ([B, v_pad] f32) beside the greedy
    # step's bytes.
    rec["noise_bytes_per_step"] = b * dims.v_loc * 4
    return rec


# The megakernel variants the mega phase holds against the plain version:
# (weights, cache). The int8 pool is the paged pool quantized per (page,
# kv head) by the writers' page quantizer, its V side first multiplied by
# 4 (exact in bf16) so that the K and V scale planes differ and the
# negative control that swaps them breaks the limit.
# The device task tracer's check (paged bf16, MEGA_LENS, MEGA_NS): the
# doorbell a ring launch publishes, and the opcodes its per-step split is
# given for.
RING_DOORBELL = 7
SPLIT_OPS = ("EMBED", "QKV_PROJ", "ATTN", "O_PROJ", "ALLREDUCE", "FC1",
             "FC2", "LM_HEAD", "RING_POLL")


def check_mega_traced(dev, flush, mega, w, args, greedy_ms) -> dict:
    """The decode megakernel with the device task tracer on, at Qwen3-0.6B
    over the paged bf16 pool, NS 1 and 8: a traced launch equals the
    untraced one bit for bit (tokens, logits, knew/vnew); its ring decodes
    strictly (no gap) and validates against the scheduled order
    (``validate_ring``: intervals, launch order, every dependency edge);
    every ALLREDUCE record has begin <= mid <= end; a ring launch (a
    leading RING_POLL task) with doorbell RING_DOORBELL stamps it in every
    RING_POLL record and validates with it, while validate_ring with
    another doorbell must report them (the negative control), and its
    outputs equal the untraced launch's. Times the traced launch per step
    beside the untraced one (the tracer's cost) and the plain version,
    and splits the step by opcode from one traced launch's ring: ticks
    (clock64 of block 0's SM) to ms over that launch's CUDA-event time.
    Returns the record of ``mega_decode_traced``."""
    import dataclasses

    import numpy as np
    import torch

    from triton_distributed_tpu_torch.megakernel.kernels import (
        mega_decode_plain,
    )
    from triton_distributed_tpu_torch.megakernel.task import TaskType
    from triton_distributed_tpu_torch.obs import kernel_trace as kt

    b = len(MEGA_LENS)
    cfg = mega.model.cfg
    base = dataclasses.replace(
        mega._dims(b, MAX_LENGTH, PAGE, num_pages=int(args[0].shape[1])),
        v_real=cfg.vocab_size)
    out = {"ms_per_step": {},
           "untraced_ms_per_step": {n: v / n for n, v in greedy_ms.items()},
           "plain_ms_per_launch": {}, "split_ms_per_step": {},
           "max_abs_err": 0.0}
    atol, rtol = MEGA_TOL["bf16"]
    for ns in MEGA_NS:
        dims = dataclasses.replace(base, nsteps=ns)
        plain_out = mega._compile(dims).run(w, *args)
        tdims = dataclasses.replace(dims, trace=True)
        comp = mega._compile(tdims)
        got = comp.run(w, *args)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(plain_out, got[:5])):
            raise RuntimeError(f"traced launch NS={ns} differs from the "
                               "untraced one")
        records = kt.decode_trace(got[5].cpu().numpy())
        problems = kt.validate_ring(records, comp.order)
        ar = [r for r in records if r.opcode == int(TaskType.ALLREDUCE)]
        if problems or not ar or not all(r.begin <= r.mid <= r.end
                                         for r in ar):
            raise RuntimeError(f"traced launch NS={ns}: ring problems "
                               f"{problems[:5]}, {len(ar)} ALLREDUCE records")
        ref = mega_decode_plain(tdims, True, comp.table, w, *args)
        if not np.array_equal(got[5][..., :4].cpu().numpy(),
                              ref[5][..., :4].cpu().numpy()):
            raise RuntimeError("traced ring headers differ from plain's")
        keep = (got[3][:-1] == ref[3][:-1]).all(dim=0)
        err = (got[0] - ref[0]).abs()[keep]
        if (err / (atol + rtol * ref[0].abs()[keep])).max().item() > 1.0:
            raise RuntimeError(f"traced launch NS={ns} leaves the limit")
        out["max_abs_err"] = max(out["max_abs_err"], err.max().item())
        # The work ring's RING_POLL: the published doorbell in every
        # step's record; another doorbell must fail validation.
        rcomp = mega._compile(dataclasses.replace(tdims, ring=True))
        state = torch.tensor([RING_DOORBELL, 0, 0, 0], dtype=torch.int32,
                             device=dev)
        rgot = rcomp.run(w, *args, ring_state=state)
        rrec = kt.decode_trace(rgot[5].cpu().numpy())
        polls = [r.mid for r in rrec if r.opcode == int(TaskType.RING_POLL)]
        good = kt.validate_ring(rrec, rcomp.order, doorbell=RING_DOORBELL)
        control = kt.validate_ring(rrec, rcomp.order,
                                   doorbell=RING_DOORBELL + 1)
        if (good or polls != [RING_DOORBELL] * ns or len(control) != ns
                or not all(torch.equal(x, y)
                           for x, y in zip(plain_out, rgot[:5]))):
            raise RuntimeError(f"ring launch NS={ns}: polls {polls}, "
                               f"problems {good[:3]}, control "
                               f"{len(control)} problems (want {ns})")
        ms = median_ms(lambda: comp.run(w, *args), flush)
        plain_ms = median_ms(lambda: mega_decode_plain(
            tdims, True, comp.table, w, *args), flush, iters=3, warmup=1)
        out["ms_per_step"][ns] = ms / ns
        out["plain_ms_per_launch"][ns] = plain_ms
        # One traced launch, timed by CUDA events, and its ring: ticks per
        # ms, then the device ms of a step by opcode.
        launches = []
        for _ in range(5):
            flush.zero_()
            torch.cuda._sleep(LEAD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            tout = comp.run(w, *args)
            end.record()
            end.synchronize()
            launches.append((start.elapsed_time(end), tout[5].cpu().numpy()))
        event_ms, ring = sorted(launches, key=lambda x: x[0])[2]
        recs = kt.decode_trace(ring)
        span = max(r.end for r in recs) - min(r.begin for r in recs)
        ms_per_tick = event_ms / span
        split = {}
        for r in recs:
            split[r.op] = split.get(r.op, 0.0) + r.dur * ms_per_tick / ns
        out["split_ms_per_step"][ns] = {
            "event_ms_per_launch": event_ms, "ticks_per_ms": span / event_ms,
            **{op: split.get(op, 0.0) for op in SPLIT_OPS
               if op != "RING_POLL"}}
        print(f"[mega] traced NS={ns}: == untraced bit for bit, ring of "
              f"{len(records)} records validates, {len(ar)} ALLREDUCE mids "
              f"inside their records; doorbell {RING_DOORBELL} stamped "
              f"{len(polls)}x, doorbell {RING_DOORBELL + 1} control: "
              f"{len(control)} problems; {ms / ns:.4f} ms per step traced "
              f"(untraced {greedy_ms[ns] / ns:.4f}); split per step "
              f"{json.dumps(out['split_ms_per_step'][ns])}")
    return out


# The prefill megakernel's check: one right-padded prompt of PREFILL_S
# rows with PREFILL_TRUE real ones, at Qwen3-0.6B's full width and depth.
PREFILL_S, PREFILL_TRUE = 256, 250
# Greedy tokens decoded from the prefilled cache (ns=8 dense mega launches).
PREFILL_GEN = 32


def prefill_prompt(vocab: int):
    import numpy as np

    return np.random.default_rng(SEED + 5).integers(
        0, vocab, PREFILL_S).astype(np.int32)


def _prefill_bound(cfg, params) -> dict:
    """The least time of the prefill of PREFILL_S rows: the larger of its
    bytes (every weight once, the LM head, the prompt rows in, K/V rows
    and one row of logits out) over the HBM rate and its FLOPs (every
    layer GEMM for each row, the LM head for one row, causal QK^T and P·V)
    over the bf16 peak."""
    lp, L = params["layers"], cfg.num_layers
    S, item = PREFILL_S, params["embed"].element_size()
    layer = sum(lp[k][n].numel() for k, n in (
        ("attn", "wqkv"), ("attn", "wo"), ("mlp", "w1"), ("mlp", "w2")))
    head = params["lm_head"].numel()
    norms = sum(t.numel() for t in (lp["ln1"], lp["ln2"], params["norm"],
                                    lp["attn"]["q_norm"],
                                    lp["attn"]["k_norm"]))
    kv = 2 * L * cfg.num_kv_heads * S * cfg.head_dim
    nbytes = ((layer + head + norms) * item + S * cfg.hidden_size * item
              + kv * item + params["lm_head"].shape[1] * 4)
    pairs = S * (S + 1) // 2
    flops = (2 * S * layer + 2 * head
             + 4 * pairs * cfg.num_q_heads * cfg.head_dim * L)
    t_bytes, t_ops = nbytes / HBM_BPS, flops / BF16_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def check_mega_prefill(dev, flush, model) -> dict:
    """The prefill megakernel against its plain version at Qwen3-0.6B's
    full width and depth in bf16, on one prompt of PREFILL_S rows with
    PREFILL_TRUE real ones, with the model's weights and with int8 weights
    (wq8): the logits of row PREFILL_TRUE - 1 and the K/V rows [0,
    PREFILL_TRUE) within the megakernel's bf16 limit, two launches
    bit-identical; negative control: the plain version with the last
    layer skipped must break the logit limit. Times the kernel, its plain
    version and the ``xla`` prefill of the same prompt
    (``Qwen3.prefill_batched``). Returns the record of ``mega_prefill``."""
    import dataclasses

    import torch

    from triton_distributed_tpu_torch.megakernel import (
        MegaConfig,
        MegaQwen3,
        MegaWeights,
    )
    from triton_distributed_tpu_torch.megakernel.kernels import (
        mega_prefill_plain,
    )

    cfg = model.cfg
    toks = torch.from_numpy(prefill_prompt(cfg.vocab_size)).to(dev).long()
    tl = torch.tensor([PREFILL_TRUE], dtype=torch.int32, device=dev)
    atol, rtol = MEGA_TOL["bf16"]
    out = {"variants": {}}
    for wq8 in (False, True):
        mega = MegaQwen3(model, cfg=MegaConfig(fuse_norms=True, wq8=wq8))
        dims = dataclasses.replace(mega._dims(PREFILL_S, PREFILL_S),
                                   prefill=True)
        comp = mega._compile(dims)
        w = MegaWeights.from_params(mega._step_params())
        x0 = w.embed.index_select(0, toks)
        info = {}
        got = comp.run.prefill(w, x0, tl, info=info)
        again = comp.run.prefill(w, x0, tl)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise RuntimeError("two prefill launches differ")
        ref = mega_prefill_plain(dims, True, comp.table, w, x0, tl)
        used = ((got[0] - ref[0]).abs()
                / (atol + rtol * ref[0].abs())).max().item()
        kv_used = max(((a[:, :, :PREFILL_TRUE].float()
                        - b[:, :, :PREFILL_TRUE].float()).abs()
                       / (atol + rtol * b[:, :, :PREFILL_TRUE].float().abs())
                       ).max().item() for a, b in zip(got[1:], ref[1:]))
        skip = comp.table[comp.table[:, 1] != cfg.num_layers - 1]
        bad = mega_prefill_plain(dims, True, skip, w, x0, tl)[0]
        bad_used = ((got[0] - bad).abs()
                    / (atol + rtol * bad.abs())).max().item()
        err = (got[0] - ref[0]).abs().max().item()
        tag = "wq8" if wq8 else "bf16"
        print(f"[mega] prefill {tag} S={PREFILL_S} true_len={PREFILL_TRUE}: "
              f"logits max_abs_err {err:.3e}, {used:.3f} of the limit; K/V "
              f"rows {kv_used:.3f} of it; last layer skipped: "
              f"{bad_used:.1f}x the limit (must exceed 1); launch {info}")
        if not (used <= 1.0 and kv_used <= 1.0 and bad_used > 1.0
                and torch.isfinite(got[0]).all()):
            raise RuntimeError(f"mega_prefill {tag}: limit use {used}, K/V "
                               f"{kv_used}, negative control {bad_used}")
        ms = median_ms(lambda: comp.run.prefill(w, x0, tl), flush)
        plain_ms = median_ms(lambda: mega_prefill_plain(
            dims, True, comp.table, w, x0, tl), flush, iters=3, warmup=1)
        out["variants"][tag] = {"ms": ms, "plain_ms": plain_ms,
                                "max_abs_err": err, "limit_used": used,
                                "kv_limit_used": kv_used,
                                "control_x_limit": bad_used, "launch": info}
        print(f"[mega] prefill {tag}: {ms:.4f} ms, plain {plain_ms:.2f} ms")
    dense1 = model.new_cache(1, 512)
    prompt = toks.cpu().numpy()[None]
    xla_ms = median_ms(lambda: model.prefill_batched(
        prompt, dense1, "xla", [PREFILL_TRUE]), flush, iters=5,
        device_only=False)
    main = out["variants"]["bf16"]
    bound = _prefill_bound(cfg, model.params)
    print(f"[mega] prefill xla path: {xla_ms:.3f} ms a call; bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    return dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/megakernel.cu",
        replaces="triton_distributed_tpu/megakernel/kernels.py:907",
        max_abs_err=main["max_abs_err"], ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=bound["bound_ms"],
        bound_by=bound["bound_by"], library_ms=None, xla_prefill_ms=xla_ms,
        shape=f"Qwen3-0.6B 28 layers bf16, S={PREFILL_S}, true_len "
              f"{PREFILL_TRUE}, fused norms; wq8 under 'variants'",
        **out)


MEGA_VARIANTS = {
    "dense": (False, "dense"), "paged": (False, "paged"),
    "int8_pool": (False, "int8"), "wq8": (True, "paged"),
    "wq8_int8_pool": (True, "int8"),
}


def check_mega(dev, flush):
    """The decode megakernel against its plain version at Qwen3-0.6B's
    full width and depth, NS = 1 and 8, in bf16 (the serving dtype,
    timed) and in f32 with TF32 off, for each of ``MEGA_VARIANTS``: dense
    and paged caches in the model dtype, the int8 pool, int8 weights
    (wq8) over the paged pool and over the int8 pool. Logits within the
    limit, two launches bit-identical, tokens equal (bf16: up to a near
    tie of the plain version, see ``_mega_tokens_ok``; f32: exactly), and
    a negative control outside the limit: the plain version with the last
    layer skipped (model-dtype weights and cache), with the K and V scale
    planes swapped (int8 pool), or with the qkv scales set to 1 (wq8 over
    the paged pool). Times the bf16 kernel per launch and per step beside
    the port's ``mode="xla"`` decode steps at the same shape (bf16 and
    int8 pools). Returns its record."""
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
        PagedKVCache,
        init_paged_cache,
        quantize_pages,
    )

    b = len(MEGA_LENS)
    lens = torch.tensor(MEGA_LENS, dtype=torch.int32, device=dev)
    worst, max_err, times, info, bad, ties = {}, {}, {}, {}, [], []
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
        k8, ks = quantize_pages(paged.k_pages)
        v8, vs = quantize_pages(paged.v_pages * 4)
        scales8 = {"k_scale": ks, "v_scale": vs}
        tokens = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
            0, V, b).astype(np.int32)).to(dev)
        megas = {q8: MegaQwen3(model, cfg=MegaConfig(fuse_norms=True,
                                                      wq8=q8))
                 for q8 in (False, True)}
        weights = {q8: MegaWeights.from_params(m._step_params())
                   for q8, m in megas.items()}
        caches = {
            "dense": ((dense.k, dense.v, None, lens, tokens), 0, {}),
            "paged": ((paged.k_pages, paged.v_pages, paged.page_table, lens,
                       tokens), PAGE, {}),
            "int8": ((k8, v8, paged.page_table, lens, tokens), PAGE,
                     scales8),
        }
        atol, rtol = MEGA_TOL[tag]
        for kind, (q8, cache) in MEGA_VARIANTS.items():
            mega, w = megas[q8], weights[q8]
            args, page, sc = caches[cache]
            for ns in MEGA_NS:
                dims = dataclasses.replace(
                    mega._dims(b, MAX_LENGTH, page, kv_quant=bool(sc),
                               num_pages=int(args[0].shape[1]) if page
                               else 0),
                    nsteps=ns, v_real=V)
                comp = mega._compile(dims)
                got = comp.run(w, *args, info=info, **sc)
                again = comp.run(w, *args, **sc)
                torch.cuda.synchronize()
                ref = mega_decode_plain(dims, True, comp.table, w, *args,
                                        **sc)
                if not all(torch.equal(x, y) for x, y in zip(got, again)):
                    raise RuntimeError(f"mega_decode {tag} {kind} NS={ns}: "
                                       "two launches on the same inputs "
                                       "differ")

                def plain_at(s, dims=dims, table=comp.table, args=args,
                             w=w, sc=sc):
                    d1 = dataclasses.replace(dims, nsteps=s + 1)
                    return mega_decode_plain(d1, True, table, w, *args,
                                             **sc)[0]

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
                if cache == "int8":
                    control = "K and V scale planes swapped"
                    bad_ref = mega_decode_plain(
                        dims, True, comp.table, w, *args,
                        k_scale=sc["v_scale"], v_scale=sc["k_scale"])[0]
                elif q8:
                    control = "qkv scales set to 1"
                    bad_ref = mega_decode_plain(
                        dims, True, comp.table, dataclasses.replace(
                            w, sc_qkv=torch.ones_like(w.sc_qkv)), *args)[0]
                else:
                    control = "last layer skipped"
                    skip = comp.table[comp.table[:, 1] != L - 1]
                    bad_ref = mega_decode_plain(dims, True, skip, w,
                                                *args)[0]
                bad_used = ((got[0] - bad_ref).abs()
                            / (atol + rtol * bad_ref.abs())).max().item()
                tie_note = (f" up to near ties {case_ties}" if case_ties
                            else "")
                print(f"[mega] {tag} {kind} NS={ns}: tokens == plain"
                      f"{tie_note}, logits max_abs_err {err.max().item():.3e}, "
                      f"{used:.3f} of the limit (atol {atol} + rtol {rtol}"
                      f"*|plain|); knew/vnew max err {kerr:.3e}; {control}: "
                      f"{bad_used:.1f}x the limit (must exceed 1); launch "
                      f"{info}")
                if not used <= 1.0 or not bad_used > 1.0:
                    bad.append(f"{tag} {kind} NS={ns}: limit use {used}, "
                               f"negative control {bad_used}")
                worst[tag, kind] = max(worst.get((tag, kind), 0.0), used)
                if tag != "bf16":
                    continue
                max_err[kind] = max(max_err.get(kind, 0.0),
                                    err.max().item())
                ms = median_ms(lambda: comp.run(w, *args, **sc), flush)
                plain_ms = median_ms(lambda: mega_decode_plain(
                    dims, True, comp.table, w, *args, **sc), flush, iters=3,
                    warmup=1)
                times[kind, ns] = (ms, plain_ms)
                print(f"[mega] {kind} NS={ns}: {ms:.4f} ms per launch, "
                      f"{ms / ns:.4f} ms per step; plain {plain_ms:.2f} ms "
                      "per launch")
        if tag == "bf16":
            # The mode="xla" decode steps at the same shape, the yardstick
            # (each step appends into its pool: kv_len is reset per call).
            def xla_step(c):
                c.kv_len = lens.clone()
                model.decode_step(tokens, c)

            pool8 = PagedKVCache(k_pages=k8.clone(), v_pages=v8.clone(),
                                 page_table=paged.page_table,
                                 kv_len=lens.clone(), k_scale=ks.clone(),
                                 v_scale=vs.clone())
            xla_ms = {k: median_ms(lambda c=c: xla_step(c), flush,
                                   device_only=False)
                      for k, c in (("dense", dense), ("paged", paged),
                                   ("int8_pool", pool8))}
            print(f"[mega] mode='xla' decode step at the same shape: "
                  f"{xla_ms} ms")
            sampled = check_mega_sampled(
                dev, flush, model, megas[False], weights[False],
                caches["paged"][0], {n: times["paged", n][0]
                                     for n in MEGA_NS})
            traced = check_mega_traced(
                dev, flush, megas[False], weights[False], caches["paged"][0],
                {n: times["paged", n][0] for n in MEGA_NS})
            prefill = check_mega_prefill(dev, flush, model)
            bf16 = model
            del pool8
        del model, dense, paged, megas, weights, caches, k8, v8
    if bad:
        raise RuntimeError(f"mega_decode disagrees with plain: {bad}")
    cfg, p = bf16.cfg, bf16.params
    bounds = {kind: _mega_bound(cfg, p, q8, cache == "int8")
              for kind, (q8, cache) in MEGA_VARIANTS.items()}
    variants = {kind: {
        "ms": times[kind, 1][0], "plain_ms": times[kind, 1][1],
        "ms_per_step_ns8": times[kind, 8][0] / 8,
        "plain_ms_per_launch_ns8": times[kind, 8][1],
        "max_abs_err": max_err[kind],
        "limit_used": {t: worst[t, kind] for t in ("bf16", "f32")},
        "library_ms": None, **bounds[kind],
    } for kind in MEGA_VARIANTS}
    print(f"[mega] variants (bf16, one step at NS=1; bound = step bytes / "
          f"{HBM_BPS:.3g} B/s): {json.dumps(variants)}")
    main = variants["paged"]
    noise_ms = sampled["noise_bytes_per_step"] / HBM_BPS * 1e3
    sampled.update(sampled_bound_ms=main["bound_ms"] + noise_ms,
                   filtered_bound_ms=main["bound_ms"] + noise_ms)
    traced_rec = dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/megakernel.cu",
        replaces="triton_distributed_tpu/megakernel/code_generator.py:628",
        max_abs_err=traced["max_abs_err"], ms=traced["ms_per_step"][1],
        plain_ms=traced["plain_ms_per_launch"][1],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=None,
        shape=f"the mega_decode launch (NS=1, ms = one step) with the "
              "tracer's ring, and with the work ring's RING_POLL "
              f"(kernels.py:46-79, :1581)",
        **{k: v for k, v in traced.items() if k != "max_abs_err"})
    return dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/megakernel.cu",
        replaces="triton_distributed_tpu/megakernel/code_generator.py:473",
        max_abs_err=max(max_err.values()),
        ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=None,
        shape=f"Qwen3-0.6B 28 layers, B={b}, paged page={PAGE}, kv_len "
              f"{list(MEGA_LENS)}, NS=1 bf16 (ms = one step); the int8 "
              "pool and wq8 variants under 'variants'",
        limit_used={f"{t}_{k}": v for (t, k), v in worst.items()},
        near_ties=ties,
        ms_per_launch={f"{k}_ns{n}": v[0] for (k, n), v in times.items()},
        ms_per_step={f"{k}_ns{n}": v[0] / n for (k, n), v in times.items()},
        plain_ms_per_launch={f"{k}_ns{n}": v[1]
                             for (k, n), v in times.items()},
        xla_step_ms=xla_ms,
        variants=variants,
        sampled_ms=sampled["sampled_ms_per_step_ns1"],
        filtered_ms=sampled["filtered_ms_per_step_ns1"],
        sampling=sampled,
        launch=info,
    ), {"mega_decode_traced": traced_rec, "mega_prefill": prefill}


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

    # A sharded long-context slot: a 64-token budget over a 6-page pool
    # serves a 120-token prompt through the cold-window kernels. Tokens
    # on the card == CPU, and (full-width pool) == a big-pool engine.
    long_prompt = rng.integers(1, 200, 120).astype(np.int32)
    for kv_dtype in (None, "int8"):
        got, counts = [], []
        for m, d in ((gpu, dev), (cpu, "cpu")):
            eng = ContinuousEngine(m, max_batch=1, page_size=16,
                                   max_length=256, kv_dtype=kv_dtype,
                                   rank_page_budget=64,
                                   tier_bytes=32 << 20, num_pages=6,
                                   device=d)
            got.append(eng.run([(long_prompt, 6)])[0])
            st = eng.last_stats
            counts.append({k: st[k] for k in (
                "longctx_sharded_slots", "longctx_demoted_pages",
                "longctx_tier_faults", "longctx_decode_steps")})
            if eng.audit() or st["longctx_demoted_pages"] <= 0:
                raise RuntimeError(f"tiny sharded engine on {d}: audit "
                                   f"{eng.audit()}, counters {counts[-1]}")
        big = ContinuousEngine(cpu, max_batch=1, page_size=16,
                               max_length=256, kv_dtype=kv_dtype,
                               device="cpu").run([(long_prompt, 6)])[0]
        if (not np.array_equal(got[0], got[1]) or counts[0] != counts[1]
                or (kv_dtype is None and not np.array_equal(got[0], big))):
            raise RuntimeError(f"tiny sharded engine ({kv_dtype}): card "
                               f"{got[0]}, CPU {got[1]}, big pool {big}; "
                               f"counters {counts}")
        print(f"[tiny] f32 sharded ContinuousEngine kv_dtype={kv_dtype}: "
              f"tokens on the card == CPU{' == big pool' if not kv_dtype else ''}"
              f", counters {counts[0]}")


def _plain_forward(model, params, tokens, past=None, gate=None):
    """Plain forward (plain attention, no cache) of one sequence under
    ``params`` (a parameter dict of the model's layout), continuing after
    ``past``: the per-layer ``(k, v) [hkv, S0, hd]`` of an earlier call
    over the tokens before (rope and the causal mask start at S0). An MoE
    model's ``gate(i, h)``, where given, gives layer i's combine weights
    ``[S, E]`` (the routing a serving run took). Returns ``(logits [S, V]
    f32, per-layer (k, v) through these tokens)``."""
    import torch
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.layers.tp_attn import _rms_head
    from triton_distributed_tpu_torch.layers.tp_mlp import _silu_mul
    from triton_distributed_tpu_torch.models.qwen import rms_norm
    from triton_distributed_tpu_torch.ops.attention import (
        apply_rope,
        mha_reference,
    )

    cfg, p, dims = model.cfg, params, model.dims
    lp = p["layers"]
    s = tokens.shape[0]
    s0 = 0 if past is None else past[0][0].shape[1]
    x = F.embedding(tokens, p["embed"])
    pos = torch.arange(s0, s0 + s, device=tokens.device)
    kvs = []
    for i in range(cfg.num_layers):
        h = rms_norm(x, lp["ln1"][i], cfg.rms_eps)
        q, k, v = dims.split_qkv(h @ lp["attn"]["wqkv"][i])
        q = apply_rope(_rms_head(q, lp["attn"]["q_norm"][i]).transpose(0, 1),
                       pos, cfg.rope_theta)
        k = apply_rope(_rms_head(k, lp["attn"]["k_norm"][i]).transpose(0, 1),
                       pos, cfg.rope_theta)
        v = v.transpose(0, 1)
        if past is not None:
            k = torch.cat([past[i][0], k], dim=1)
            v = torch.cat([past[i][1], v], dim=1)
        kvs.append((k, v))
        o = mha_reference(q[None], k[None], v[None], kv_offset=s0)[0]
        x = x + o.transpose(0, 1).reshape(s, -1) @ lp["attn"]["wo"][i]
        h = rms_norm(x, lp["ln2"][i], cfg.rms_eps)
        if cfg.num_experts:
            x = x + _moe_direct(cfg, lp["mlp"], i, h,
                                cw=None if gate is None else gate(i, h))
        else:
            x = x + _silu_mul(h @ lp["mlp"]["w1"][i]) @ lp["mlp"]["w2"][i]
    x = rms_norm(x, p["norm"], cfg.rms_eps)
    logits = (x @ p["lm_head"]).to(torch.float32)[:, :cfg.vocab_size]
    return logits, kvs


# Experts a dense pass of the plain MoE forward holds at once.
MOE_EXPERT_CHUNK = 16


def _moe_weights(cfg, w_router, h):
    """The plain gate of ``h [S, d]``: (f32 router probabilities [S, E],
    combine weights [S, E]: each row's top k by a stable sort, 0
    elsewhere, renormalized under ``norm_topk_prob``)."""
    import torch

    k = cfg.num_experts_per_tok
    probs = torch.softmax(h.float() @ w_router.float(), dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    top = vals[:, :k]
    if cfg.norm_topk_prob:
        top = top / top.sum(dim=-1, keepdim=True)
    return probs, torch.zeros_like(probs).scatter_(1, ids[:, :k], top)


def _moe_direct(cfg, mlp, i, h, cw=None, drop_rank=None):
    """Layer ``i``'s MoE MLP on the normed rows ``h [S, d]``, computed for
    each token's own top-k experts directly (not through ``moe_sort`` or
    ``grouped_ffn``): f32 router softmax, the top k by a stable sort,
    every expert's SwiGLU FFN on every row (a chunk of experts at a time)
    weighted by that row's combine weight (0 off its top k), summed in
    f32 and rounded to the model dtype. ``mlp`` is a parameter dict, or
    at tp=n the list of the ranks' MLP dicts: each rank's SwiGLU on its
    own column shard, its partial rounded, the partials summed in f32 and
    rounded (``tp_moe_fwd``'s psum), with rank ``drop_rank``'s partial
    left out (a negative control). ``cw [S, E]`` replaces the plain
    gate's combine weights."""
    import torch

    ranks = mlp if isinstance(mlp, list) else [mlp]
    if cw is None:
        cw = _moe_weights(cfg, ranks[0]["w_router"][i], h)[1]
    parts = []
    for m in ranks:
        f = m["w1"].shape[-1] // 2
        out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        for e0 in range(0, cfg.num_experts, MOE_EXPERT_CHUNK):
            sl = slice(e0, e0 + MOE_EXPERT_CHUNK)
            gu = torch.matmul(h, m["w1"][i, sl])  # [Ec, S, 2f]
            act = (torch.nn.functional.silu(gu[..., :f].float())
                   * gu[..., f:].float()).to(h.dtype)
            y = torch.matmul(act, m["w2"][i, sl])  # [Ec, S, d]
            out += (cw[:, sl].T[..., None] * y.float()).sum(dim=0)
        parts.append(out.to(h.dtype))
    if len(parts) == 1:
        return parts[0]
    acc = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for r, part in enumerate(parts):
        if r != drop_rank:
            acc += part.float()
    return acc.to(h.dtype)


def reference_logits(model, tokens):
    """Plain full-sequence forward (plain attention, no cache) of one
    sequence: logits [S, V] f32."""
    return _plain_forward(model, model.params, tokens)[0]


def dequantized_params(model, q8) -> dict:
    """The model's parameters with the five projection weights replaced by
    their int8 codes times their scales, rounded to the model dtype (the
    JAX package's wq8 golden)."""
    def deq(w8, sc):
        return (w8.float() * sc).to(model.cfg.dtype)

    p, lp = model.params, model.params["layers"]
    return {**p, "lm_head": deq(q8.lm_head, q8.sc_lm), "layers": {
        **lp,
        "attn": {**lp["attn"], "wqkv": deq(q8.wqkv, q8.sc_qkv),
                 "wo": deq(q8.wo, q8.sc_o)},
        "mlp": {"w1": deq(q8.w1, q8.sc_w1), "w2": deq(q8.w2, q8.sc_w2)},
    }}


def teacher_forced_gaps(model, prompt, generated, decode_params=None,
                        params=None, gate=None) -> list[float]:
    """For each generated position: reference max logit minus the
    reference logit of the token the engine emitted. With
    ``decode_params`` the engine's own split: the prompt runs under the
    model's parameters (the prefill) and the generated tokens as one
    chunk under ``decode_params`` over the prompt's K/V (the decode);
    with ``params`` the whole sequence runs under ``params``; ``gate``
    routes an MoE model's experts (``_plain_forward``)."""
    import numpy as np
    import torch

    dev = model.device
    if decode_params is None:
        seq = np.concatenate([prompt, generated[:-1]]).astype(np.int64)
        logits = _plain_forward(model, model.params if params is None
                                else params, torch.from_numpy(seq).to(dev),
                                gate=gate)[0]
        rows = logits[len(prompt) - 1:]
    else:
        first, past = _plain_forward(model, model.params, torch.from_numpy(
            np.asarray(prompt, np.int64)).to(dev))
        rest, _ = _plain_forward(model, decode_params, torch.from_numpy(
            np.asarray(generated[:-1], np.int64)).to(dev), past)
        rows = torch.cat([first[-1:], rest])
    emitted = torch.as_tensor(generated, device=dev).long()
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


class _LaunchTimer:
    """CUDA events around every ns-step launch an engine issues: the
    device time of its launches, read without a host sync in the run. A
    resident launch is issued while the one before it runs, so its start
    event completes when that one ends: each pair spans one launch's
    device work."""

    def __init__(self, eng):
        import torch

        self.pairs = []
        inner = eng._launch_mega

        def wrapped(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(*a, **kw)
            end.record()
            self.pairs.append((start, end))
            return out

        eng._launch_mega = wrapped

    def device_ms(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.pairs)


def serve_main_path(dev):
    """Phase 3: the port's main path, full width and depth."""
    import numpy as np
    import torch

    from triton_distributed_tpu_torch.megakernel import MegaConfig, MegaQwen3
    from triton_distributed_tpu_torch.models import (
        AutoLLM,
        ContinuousEngine,
        Engine,
        Request,
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
    long_requests = [(np.concatenate([prefix, rng.integers(0, vocab, n)])
                      .astype(np.int32), GEN_LEN)
                     for n in rng.integers(SUFFIX_LENS[0], SUFFIX_LENS[1] + 1,
                                           LONG_SHORTS)]
    long_requests.append((rng.integers(0, vocab, LONG_PROMPT).astype(
        np.int32), GEN_LEN))

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
    # int8 weights (the engines' default megakernel config, plus wq8)
    # over an int8 pool.
    mega_wq8 = Engine(model, paged=True, page_size=PAGE, kv_dtype="int8",
                      mode="mega", mega_cfg=MegaConfig(
                          fuse_norms=True, cross_prefetch=True,
                          overlap_ar=True, wq8=True), device=dev)
    mega_traced = Engine(model, paged=False, mode="mega", kernel_trace=True,
                         device=dev)
    mega_engs = {"paged_engine_mega_wq8": mega_wq8,
                 "dense_engine_mega_traced": mega_traced}
    # Per mega serving path: CUDA events around its launches, and every
    # traced launch's ring (an engine keeps only its last 8).
    mega_timers, mega_rings = {}, {}

    def keep_rings(path, eng):
        rings, inner = mega_rings.setdefault(path, []), eng._record_kernel_trace

        def record(*a, **kw):
            inner(*a, **kw)
            rings.append(eng._kernel_traces[-1])
        eng._record_kernel_trace = record

    keep_rings("dense_engine_mega_traced", mega_traced)

    def continuous_mega(path, kv_dtype, **kw):
        """ContinuousEngine(mode="mega") with an eos_id: the token the
        bf16 continuous run emitted 41st for the first request."""
        eos = int(outs["continuous"][0][40])
        eng = mega_engs[path] = ContinuousEngine(
            model, max_batch=4, page_size=PAGE, max_length=MAX_LENGTH,
            prefix_cache=True, mode="mega", eos_id=eos, kv_dtype=kv_dtype,
            device=dev, **kw)
        if kv_dtype is None:
            mega_timers[path] = _LaunchTimer(eng)
        if kw.get("kernel_trace"):
            keep_rings(path, eng)
        if kw.get("resident"):
            strict_issue(path, eng)
        return eng.run(requests)

    strict_issues = {}

    def strict_issue(path, eng):
        """Every chained launch issues under torch's sync debug mode
        "error": a host sync between issue and drain raises."""
        inner = eng._issue_resident
        strict_issues[path] = 0

        def issue(chain):
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = inner(chain)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            strict_issues[path] += out is not None
            return out
        eng._issue_resident = issue

    prefill_runs = {}

    def mega_prefill(path, wq8):
        """MegaQwen3.prefill of the right-padded prompt into a dense cache,
        then PREFILL_GEN greedy tokens through ns=8 dense mega launches
        from that cache."""
        mega = MegaQwen3(model, cfg=MegaConfig(
            fuse_norms=True, cross_prefetch=True, overlap_ar=True, wq8=wq8))
        prompt = prefill_prompt(vocab)
        t0 = time.perf_counter()
        logits, cache = mega.prefill(prompt, model.new_cache(1, 512),
                                     true_len=PREFILL_TRUE)
        tok = logits.argmax()[None].to(torch.int32)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        fn = mega.decode_multi_fn(1, 512, 8)
        toks = [int(tok)]
        for _ in range(PREFILL_GEN // 8):
            t, _, cache = fn(mega._step_params(), tok, cache)
            toks += t[:, 0].tolist()
            tok = t[-1]
        prefill_runs[path] = (mega, logits, prefill_s)
        return np.asarray(toks, np.int32)
    spec_fixed = Engine(model, paged=True, page_size=PAGE, **spec_kw)
    # The long-context engines: the budget's pages plus what the short
    # requests need (the engine adds the trash page).
    long_pages = LONG_BUDGET // PAGE + sum(
        -(-(len(p) + g) // PAGE) for p, g in long_requests[:-1])
    long_engs = {path: ContinuousEngine(
        model, max_batch=4, page_size=PAGE, max_length=LONG_MAX_LENGTH,
        prefix_cache=True, rank_page_budget=LONG_BUDGET,
        tier_bytes=LONG_TIER_BYTES, num_pages=long_pages, kv_dtype=kv,
        device=dev) for path, kv in (("continuous_longctx", None),
                                     ("continuous_longctx_int8", "int8"))}
    view_t = {path: _Timed(e, "_cold_view") for path, e in long_engs.items()}
    chunk_t = _Timed(model, "prefill_paged_chunk")
    decode_t = _Timed(model, "decode_step")
    cold_t = _Timed(model, "prefill_paged_chunk_cold")
    sharded_t = _Timed(model, "decode_step_sharded")
    requests = [(p, GEN_LEN) for p in prompts]
    spec_requests = [(p, SPEC_GEN) for p in spec_prompts]
    passes = {}  # speculative path -> [(pass timings, last_stats)] x 2
    # Sampled paths: path -> [last_stats] per run, and their engines.
    sampled_stats, sampled_engs = {}, {}

    def sampled_runs(path, **kw):
        """The sampled traffic through fresh engines seeded SEED, SEED
        and SEED + 1 (a fresh engine so that each run computes the same
        logits)."""
        got, sampled_stats[path] = [], []
        for seed in (SEED, SEED, SEED + 1):
            e = sampled_engs[path] = ContinuousEngine(
                model, max_batch=4, page_size=PAGE, max_length=MAX_LENGTH,
                prefix_cache=True, seed=seed, device=dev, **SAMPLED_KNOBS,
                **kw)
            got.append(e.run([Request(p, GEN_LEN, **o) for p, o in
                              zip(prompts, SAMPLED_OVERRIDES)]))
            if e.audit():
                raise RuntimeError(f"{path}: pool audit failed: "
                                   f"{e.audit()}")
            sampled_stats[path].append(dict(e.last_stats))
        return got

    mega_sampled = Engine(model, paged=True, page_size=PAGE, mode="mega",
                          seed=SEED, device=dev, **SAMPLED_ENGINE_KNOBS)
    spec_sampled = ContinuousEngine(
        model, max_batch=4, page_size=PAGE, max_length=MAX_LENGTH,
        temperature=SAMPLED_SPEC_T, seed=SEED, **spec_kw)

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
        "dense_engine_mega_traced": lambda: mega_traced.serve(
            dense_ids, DENSE_GEN, MAX_LENGTH, ns=8),
        "continuous_mega": lambda: continuous_mega("continuous_mega", None),
        "continuous_mega_resident": lambda: continuous_mega(
            "continuous_mega_resident", None, ns=8, resident=True,
            kernel_trace=True),
        "continuous_mega_int8": lambda: continuous_mega(
            "continuous_mega_int8", "int8"),
        "paged_engine_mega_wq8": lambda: mega_wq8.serve(
            dense_ids, DENSE_GEN, MAX_LENGTH, ns=8),
        "mega_prefill": lambda: mega_prefill("mega_prefill", False),
        "mega_prefill_wq8": lambda: mega_prefill("mega_prefill_wq8", True),
        "continuous_longctx": lambda: long_engs["continuous_longctx"].run(
            long_requests),
        "continuous_longctx_int8": lambda: long_engs[
            "continuous_longctx_int8"].run(long_requests),
        "continuous_sampled": lambda: sampled_runs("continuous_sampled"),
        "continuous_mega_sampled": lambda: sampled_runs(
            "continuous_mega_sampled", mode="mega", ns=8),
        "paged_engine_mega_sampled": lambda: mega_sampled.serve(
            dense_ids, DENSE_GEN, MAX_LENGTH, ns=8),
        # Each request keeps its seed across the two passes (Request.key):
        # the re-ask repeats the warm pass's draws, so it follows the
        # chains the warm pass left in the radix tree, as a greedy re-ask
        # does.
        "continuous_spec_sampled": lambda: warm_then_reask(
            "continuous_spec_sampled", lambda: spec_sampled.run([
                Request(p, SPEC_GEN, key=SEED + 1000 + i)
                for i, p in enumerate(spec_prompts)]),
            lambda: spec_sampled.last_stats),
    }
    launches, outs, times = {}, {}, {}
    timers = {"chunk": chunk_t, "decode": decode_t, "cold_chunk": cold_t,
              "sharded_decode": sharded_t}
    for path, run in runs.items():
        before = {k: (t.seconds, t.calls) for k, t in timers.items()}
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        outs[path] = run()
        torch.cuda.synchronize()
        launches[path] = ck.launch_counts()
        times[path] = {"wall_s": time.perf_counter() - t0}
        for k, t in timers.items():
            times[path][f"{k}_s"] = t.seconds - before[k][0]
            times[path][f"{k}_calls"] = t.calls - before[k][1]
        times[path]["chunks"] = times[path]["chunk_calls"]

    mega_e2e = check_mega_paths(model, prompts, dense_ids, outs, times,
                                launches, mega_dense, mega_engs)
    mega_e2e.update(check_resident_paths(
        model, prompts, dense_ids, outs, times, mega_engs, mega_timers,
        mega_rings))
    mega_e2e["continuous_mega_resident"]["issues_under_sync_error_mode"] = (
        strict_issues["continuous_mega_resident"])
    mega_e2e.update(check_prefill_paths(model, outs, times, prefill_runs))
    long_e2e = check_longctx_paths(model, long_requests, outs, times,
                                   long_engs, view_t)
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
    spec_e2e = check_spec_paths(passes, {
        "continuous_spec": spec_eng, "paged_engine_spec": spec_fixed,
        "continuous_spec_sampled": spec_sampled})
    sampled_e2e = check_sampled_paths(
        model, prompts, dense_ids, spec_prompts, outs, times, launches,
        sampled_stats, mega_sampled)
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

    # The greedy speculative streams (both passes of both paths) against
    # the same plain forward, with the bf16 limits.
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
        "longctx": long_e2e,
        "sampled": sampled_e2e,
    }
    return launches, e2e


def check_mega_paths(model, prompts, dense_ids, outs, times, launches,
                     dense_eng, engs) -> dict:
    """The megakernel serving paths: audit, launches, teacher forcing (the
    bf16 limits over full-width caches, the int8 limits over int8 pools;
    the wq8 Engine against the plain forward whose decode weights are the
    dequantized int8 weights); returns their e2e block (decode ms per
    step and per emitted token, megakernel launches per emitted token)."""
    import numpy as np

    def tf_check(what, gaps, margin, min_exact):
        worst, exact = max(gaps), sum(g == 0 for g in gaps)
        print(f"[check] {what} teacher forcing over {len(gaps)} generated "
              f"tokens: max gap {worst:.4f}, mean {statistics.mean(gaps):.4f}"
              f", exact argmax {exact}/{len(gaps)}, margin {margin}, min "
              f"exact share {min_exact}")
        if not all(np.isfinite(gaps)) or worst > margin:
            raise RuntimeError(f"{what}: teacher-forced gap {worst} exceeds "
                               f"{margin}")
        if exact < min_exact * len(gaps):
            raise RuntimeError(f"{what}: only {exact}/{len(gaps)} emitted "
                               "tokens are the reference argmax")

    def continuous_gaps(path):
        eng = engs[path]
        problems = eng.audit()
        if problems:
            raise RuntimeError(f"{path}: pool audit failed: {problems}")
        gaps = []
        for p, o in zip(prompts, outs[path]):
            if not (o.shape == (GEN_LEN,) or (0 < len(o) < GEN_LEN
                                               and int(o[-1]) == eng.eos_id)):
                raise RuntimeError(f"{path}: bad output {o.shape}")
            gaps += teacher_forced_gaps(model, p, o)
        return gaps

    gaps = continuous_gaps("continuous_mega")
    for row in range(DENSE_ROWS):
        gaps += teacher_forced_gaps(model, dense_ids[row],
                                    outs["dense_engine_mega"][row,
                                                              DENSE_PROMPT:])
    tf_check("megakernel", gaps, TF_MARGIN, TF_MIN_EXACT)
    tf_check("megakernel over the int8 pool",
             continuous_gaps("continuous_mega_int8"), TF8_MARGIN,
             TF8_MIN_EXACT)
    wq8 = engs["paged_engine_mega_wq8"]
    if wq8.audit():
        raise RuntimeError(f"paged_engine_mega_wq8: audit {wq8.audit()}")
    deq = dequantized_params(model, wq8._mega_model().quantized_params())
    gaps = []
    for row in range(DENSE_ROWS):
        gaps += teacher_forced_gaps(
            model, dense_ids[row],
            outs["paged_engine_mega_wq8"][row, DENSE_PROMPT:], deq)
    tf_check("megakernel with int8 weights over the int8 pool", gaps,
             TF8_MARGIN, TF8_MIN_EXACT)
    del deq

    d_emit = DENSE_ROWS * (DENSE_GEN - 1)
    out = {}
    for path, eng in (("dense_engine_mega", dense_eng),
                      ("paged_engine_mega_wq8", wq8)):
        st = eng.last_stats
        if st["mega_launches"] <= 0:
            raise RuntimeError(f"{path}: mega_launches {st['mega_launches']}")
        out[path] = {
            "decode_ms_per_step": st["decode_ms_per_step"],
            "decode_ms_per_emitted_token": st["decode_s"] / d_emit * 1e3,
            "mega_launches_per_emitted_token": launches[path][
                "mega_decode"] / d_emit,
            "mega_launches": st["mega_launches"],
            "decode_steps": st["decode_steps"],
            "kv_dtype": st["kv_dtype"],
        }
    for path in ("continuous_mega", "continuous_mega_int8"):
        st = engs[path].last_stats
        c_emit = st["generated_tokens"] - st["admitted"]
        c_decode_s = times[path]["wall_s"] - times[path]["chunk_s"]
        if st["mega_launches"] <= 0:
            raise RuntimeError(f"{path}: mega_launches {st['mega_launches']}")
        out[path] = {
            "decode_ms_per_step": c_decode_s / max(st["decode_steps"], 1)
            * 1e3,
            "decode_ms_per_emitted_token": c_decode_s / max(c_emit, 1) * 1e3,
            "mega_launches_per_emitted_token": launches[path][
                "mega_decode"] / max(c_emit, 1),
            "wall_s": times[path]["wall_s"],
            **{k: st[k] for k in (
                "decode_steps", "mega_launches", "mega_fallback_steps",
                "mega_bucket_launches", "mega_device_retires",
                "prefix_hit_tokens", "generated_tokens", "kv_dtype")},
            "eos_id": engs[path].eos_id,
        }
    print(f"[serve] megakernel paths: {json.dumps(out)}")
    return out


def _tf_check(what, gaps, margin, min_exact) -> dict:
    import numpy as np

    worst, exact = max(gaps), sum(g == 0 for g in gaps)
    print(f"[check] {what} teacher forcing over {len(gaps)} generated "
          f"tokens: max gap {worst:.4f}, mean {statistics.mean(gaps):.4f}"
          f", exact argmax {exact}/{len(gaps)}, margin {margin}, min "
          f"exact share {min_exact}")
    if not all(np.isfinite(gaps)) or worst > margin:
        raise RuntimeError(f"{what}: teacher-forced gap {worst} exceeds "
                           f"{margin}")
    if exact < min_exact * len(gaps):
        raise RuntimeError(f"{what}: only {exact}/{len(gaps)} emitted "
                           "tokens are the reference argmax")
    return {"max_gap": worst, "exact": exact, "tokens": len(gaps)}


def check_resident_paths(model, prompts, dense_ids, outs, times, engs,
                         timers, rings) -> dict:
    """The tracer and resident paths. ``dense_engine_mega_traced``: the
    tokens of ``dense_engine_mega``, every ring valid against the
    scheduled order. ``continuous_mega_resident``: the tokens of
    ``continuous_mega`` (and the bf16 teacher forcing), resident rounds,
    at least 16 ring items (8 admits, 8 retires) and some doorbells;
    every traced launch's ring valid against the order and the doorbell
    published for it, doorbells rising strictly, the ring empty at rest,
    a clean audit. Returns their e2e block, with each continuous mega
    path's decode ms per step and the idle share of its decode wall (the
    run's wall less its prefill chunks): 1 - the launches' device time
    (CUDA events) over that wall."""
    import numpy as np

    from triton_distributed_tpu_torch.obs import kernel_trace as kt

    out = {}
    traced = engs["dense_engine_mega_traced"]
    if not np.array_equal(outs["dense_engine_mega_traced"],
                          outs["dense_engine_mega"]):
        raise RuntimeError("dense_engine_mega_traced: tokens differ from "
                           "dense_engine_mega's")
    order = traced._mega_model().multi_task_order(
        DENSE_ROWS, MAX_LENGTH, 8, trace=True)
    for ln in rings["dense_engine_mega_traced"]:
        problems = kt.validate_ring(ln.get_records(), order)
        if problems:
            raise RuntimeError(f"dense_engine_mega_traced ring: "
                               f"{problems[:5]}")
    out["dense_engine_mega_traced"] = {
        "rings_validated": len(rings["dense_engine_mega_traced"]),
        "mega_trace_launches": traced.last_stats["mega_trace_launches"],
        "decode_ms_per_step": traced.last_stats["decode_ms_per_step"]}

    eng = engs["continuous_mega_resident"]
    got, want = outs["continuous_mega_resident"], outs["continuous_mega"]
    differ = [i for i, (a, b) in enumerate(zip(got, want))
              if not np.array_equal(a, b)]
    gaps = []
    for p, o in zip(prompts, got):
        gaps += teacher_forced_gaps(model, p, o)
    tf = _tf_check("resident megakernel", gaps, TF_MARGIN, TF_MIN_EXACT)
    if differ:
        raise RuntimeError(f"continuous_mega_resident: requests {differ} "
                           "differ from continuous_mega's tokens")
    st = eng.last_stats
    if not (st["mega_resident_rounds"] > 0 and st["mega_ring_items"] >= 16
            and st["mega_ring_doorbells"] > 0):
        raise RuntimeError(f"continuous_mega_resident counters: {st}")
    order = eng._mega_model().multi_task_order(
        4, MAX_LENGTH, 8, page=PAGE, num_pages=int(eng.cache.k_pages.shape[1]),
        valid_arg=True, trace=True, eos=True, ring=True)
    launches = rings["continuous_mega_resident"]
    for ln in launches:
        problems = kt.validate_ring(ln.get_records(), order,
                                    doorbell=ln.doorbell)
        if problems:
            raise RuntimeError(f"resident ring {ln.launch}: {problems[:5]}")
    bells = [ln.doorbell for ln in launches]
    if not bells or any(b2 <= b1 for b1, b2 in zip(bells, bells[1:])):
        raise RuntimeError(f"resident doorbells do not rise: {bells}")
    if eng._ring.occupancy or eng.audit():
        raise RuntimeError(f"resident: ring occupancy "
                           f"{eng._ring.occupancy}, audit {eng.audit()}")
    for path in ("continuous_mega", "continuous_mega_resident"):
        st_p = engs[path].last_stats
        wall = (times[path]["wall_s"] - times[path]["chunk_s"]) * 1e3
        busy = timers[path].device_ms()
        out.setdefault(path, {}).update({
            "decode_ms_per_step": wall / max(st_p["decode_steps"], 1),
            "launch_device_ms": busy,
            "decode_wall_ms": wall,
            "idle_share": max(0.0, 1.0 - busy / wall),
        })
    out["continuous_mega_resident"].update(
        teacher_forcing=tf, rings_validated=len(launches),
        doorbells=[bells[0], bells[-1]],
        **{k: st[k] for k in ("mega_resident_rounds", "mega_ring_items",
                              "mega_ring_doorbells", "mega_ring_host_drains",
                              "mega_trace_launches", "mega_launches",
                              "decode_steps", "mega_device_retires")})
    print(f"[serve] tracer and resident paths: {json.dumps(out)}")
    return out


def check_prefill_paths(model, outs, times, runs) -> dict:
    """The prefill megakernel's serving paths: ``MegaQwen3.prefill`` of
    the right-padded prompt against the plain version (the bf16 limit)
    and against the ``xla`` prefill of the same prompt (the kernel's top
    token within TF_MARGIN of the xla top, and the other way round; the
    largest logit difference is reported), then the continuation's
    teacher forcing with the bf16 limits; under wq8, against its own
    plain version, and the top token and the continuation against a plain
    forward whose weights are the dequantized int8 ones (the wq8 golden)
    with the int8 limits. Returns their e2e block."""
    import dataclasses

    import numpy as np
    import torch

    from triton_distributed_tpu_torch.megakernel import MegaWeights
    from triton_distributed_tpu_torch.megakernel.kernels import (
        mega_prefill_plain,
    )

    dev = model.device
    prompt = prefill_prompt(model.cfg.vocab_size)
    real = prompt[:PREFILL_TRUE]
    xla_logits, _ = model.prefill_batched(prompt[None], model.new_cache(1, 512),
                                          "xla", [PREFILL_TRUE])
    xla_logits = xla_logits[0]
    atol, rtol = MEGA_TOL["bf16"]
    out = {}
    for path in ("mega_prefill", "mega_prefill_wq8"):
        mega, logits, prefill_s = runs[path]
        wq8 = mega.cfg.wq8
        dims = dataclasses.replace(mega._dims(PREFILL_S, PREFILL_S),
                                   prefill=True)
        comp = mega._compile(dims)
        w = MegaWeights.from_params(mega._step_params())
        toks = torch.from_numpy(prompt).to(dev).long()
        ref = mega_prefill_plain(
            dims, True, comp.table, w, w.embed.index_select(0, toks),
            torch.tensor([PREFILL_TRUE], dtype=torch.int32, device=dev))[0][
                0, :model.cfg.vocab_size]
        used = ((logits - ref).abs() / (atol + rtol * ref.abs())).max().item()
        if not used <= 1.0:
            raise RuntimeError(f"{path}: logits {used} of the limit")
        if wq8:
            deq = dequantized_params(model, mega.quantized_params())
            gold = _plain_forward(model, deq, torch.from_numpy(
                real.astype(np.int64)).to(dev))[0][-1]
            gaps = teacher_forced_gaps(model, real, outs[path], params=deq)
            tf = _tf_check(f"{path} continuation (dequantized golden)", gaps,
                           TF8_MARGIN, TF8_MIN_EXACT)
            margin = TF8_MARGIN
            del deq
        else:
            gold = xla_logits
            gaps = teacher_forced_gaps(model, real, outs[path])
            tf = _tf_check(f"{path} continuation", gaps, TF_MARGIN,
                           TF_MIN_EXACT)
            margin = TF_MARGIN
        top, gtop = int(logits.argmax()), int(gold.argmax())
        gap = (gold[gtop] - gold[top]).item()
        back = (logits[top] - logits[gtop]).item()
        diff = (logits - gold).abs().max().item()
        print(f"[check] {path}: logits {used:.3f} of the plain limit; "
              f"against the {'dequantized golden' if wq8 else 'xla prefill'}"
              f": max |diff| {diff:.4f}, top {top} vs {gtop} (gaps {gap:.4f},"
              f" {back:.4f}, margin {margin}); prefill {prefill_s * 1e3:.2f}"
              f" ms, path {times[path]['wall_s']:.3f} s")
        if gap > margin or back > margin:
            raise RuntimeError(f"{path}: top token {top} against {gtop}: "
                               f"gaps {gap}, {back}")
        out[path] = {"plain_limit_used": used, "golden_max_abs_diff": diff,
                     "top_gap": gap, "continuation": tf,
                     "prefill_ms": prefill_s * 1e3,
                     "wall_s": times[path]["wall_s"]}
    return out


def check_longctx_paths(model, requests, outs, times, engines,
                        view_t) -> dict:
    """The long-context paths: the long request admitted as one sharded
    slot, demoted at least LONG_MIN_DEMOTED pages, faulted cold pages
    back and took
    GEN_LEN - 1 sharded decode steps; clean audits; every request's
    tokens checked by teacher forcing (bf16 and int8 limits). Returns
    each path's e2e block: the long prefill's tokens/s, ms per sharded
    and per batched decode step, the tier counters, and the wall seconds
    spent rebuilding cold windows (tier reads and their decode)."""
    import numpy as np

    out = {}
    for path, margin, min_exact in (
            ("continuous_longctx", TF_MARGIN, TF_MIN_EXACT),
            ("continuous_longctx_int8", TF8_MARGIN, TF8_MIN_EXACT)):
        eng, t, st = engines[path], times[path], engines[path].last_stats
        problems = eng.audit()
        if problems:
            raise RuntimeError(f"{path}: pool/tier audit failed: {problems}")
        keys = ("longctx_sharded_slots", "longctx_demoted_pages",
                "longctx_tier_faults", "longctx_tier_bytes",
                "longctx_decode_steps", "tier_spilled_pages", "tier_hits",
                "tier_faults", "tier_bytes", "decode_steps",
                "prefill_chunks", "prefix_hit_tokens", "generated_tokens")
        counts = {k: st[k] for k in keys}
        if (counts["longctx_sharded_slots"] != 1
                or counts["longctx_demoted_pages"] < LONG_MIN_DEMOTED
                or counts["longctx_tier_faults"] <= 0
                or counts["longctx_decode_steps"] < GEN_LEN - 1):
            raise RuntimeError(f"{path}: the long request did not serve as "
                               f"a sharded slot: {counts}")
        gaps = []
        for (p, g), o in zip(requests, outs[path]):
            if o.shape != (g,):
                raise RuntimeError(f"{path}: bad output shape {o.shape}")
            gaps.append(teacher_forced_gaps(model, p, o))
        flat = [x for row in gaps for x in row]
        worst, exact = max(flat), sum(x == 0 for x in flat)
        long_worst = max(gaps[-1])
        print(f"[check] {path} teacher forcing over {len(flat)} generated "
              f"tokens: max gap {worst:.4f} (long request {long_worst:.4f}),"
              f" exact argmax {exact}/{len(flat)}, margin {margin}, min "
              f"exact share {min_exact}")
        if not all(np.isfinite(flat)) or worst > margin:
            raise RuntimeError(f"{path}: teacher-forced gap {worst} exceeds "
                               f"{margin}")
        if exact < min_exact * len(flat):
            raise RuntimeError(f"{path}: only {exact}/{len(flat)} emitted "
                               "tokens are the reference argmax")
        long_len = len(requests[-1][0])
        out[path] = {
            "long_prefill_tokens_per_s": long_len / t["cold_chunk_s"],
            "long_prefill_chunks": t["cold_chunk_calls"],
            "sharded_decode_ms_per_step": t["sharded_decode_s"] / max(
                t["sharded_decode_calls"], 1) * 1e3,
            "batched_decode_ms_per_step": t["decode_s"] / max(
                t["decode_calls"], 1) * 1e3,
            "cold_view_s": view_t[path].seconds,
            "cold_view_calls": view_t[path].calls,
            "wall_s": t["wall_s"],
            "teacher_forcing": {"max_gap": worst, "long_max_gap": long_worst,
                                "exact": exact, "tokens": len(flat)},
            **counts,
            "tier": st["tier"],
        }
        print(f"[serve] {path}: {json.dumps(out[path])}")
    return out


def plain_rows(model, prompt, generated):
    """The plain full-sequence forward's logits at each generated position
    of a stream, [n, V] f32, and the emitted tokens [n] int64."""
    import numpy as np
    import torch

    dev = model.device
    seq = np.concatenate([prompt, generated[:-1]]).astype(np.int64)
    rows = reference_logits(model, torch.from_numpy(seq).to(dev))[
        len(prompt) - 1:]
    return rows, torch.as_tensor(generated, device=dev).long()


def keep_edges(rows, emitted, temperature, top_p, top_k) -> list[float]:
    """For each position: the lowest plain logit that ``filter_logits``
    keeps there, minus the emitted token's plain logit (<= 0 when the
    token is in the plain keep-set)."""
    import torch

    from triton_distributed_tpu_torch.models import sampling

    kept = torch.isfinite(sampling.filter_logits(rows, temperature, top_p,
                                                 top_k))
    floor = torch.where(kept, rows, float("inf")).min(dim=-1).values
    return (floor - rows.gather(1, emitted[:, None])[:, 0]).tolist()


def draw_terms(rows, emitted, temperature) -> dict:
    """For each position of an unfiltered stream at ``temperature``: the
    plain maximum minus the emitted token's plain logit (``gap``), and,
    with lq = log softmax(rows / T) in float64, the token's lq less its
    mean under softmax(rows / T) (``dev``) and the variance of lq there
    (``var``), the terms of SAMPLED_Z's z."""
    import torch

    lq = torch.log_softmax(rows.double() / temperature, dim=-1)
    q = lq.exp()
    mean = (q * lq).sum(dim=-1)
    tok = lq.gather(1, emitted[:, None])[:, 0]
    gap = rows.max(dim=-1).values - rows.gather(1, emitted[:, None])[:, 0]
    return {"gap": gap.tolist(), "dev": (tok - mean).tolist(),
            "var": ((q * lq * lq).sum(dim=-1) - mean * mean).tolist()}


def check_sampled_paths(model, prompts, dense_ids, spec_prompts, outs, times,
                        launches, stats, mega_engine) -> dict:
    """The sampled serving paths. Greedy requests pass the bf16 teacher
    forcing limits; the sampled tokens are held to the plain forward as
    SAMPLED_KNOBS' comment sets out: filtered tokens to their keep-sets
    (``keep_edges``, with the same check at top_k=1 failing on some
    tokens), unfiltered ones to SAMPLED_TAIL and, at T 0.8, to SAMPLED_Z
    (``draw_terms``), where uniform tokens, and at T 0.8 the argmax
    tokens, must fail (the negative controls); the same seed replays the
    same tokens and SEED + 1 changes a sampled request; the mega paths
    filter in the kernel (``mega_filtered_rounds`` > 0,
    ``mega_fallback_steps`` == 0). Returns their e2e block."""
    import numpy as np
    import torch

    V = model.cfg.vocab_size
    gen = torch.Generator(device=model.device).manual_seed(SEED + 7)
    out, edges, control, greedy_gaps = {}, [], [], []
    # Unfiltered draws by temperature: the tokens' terms, and the uniform
    # and argmax tokens' at the same positions.
    unf = {t: {"draws": [], "uniform": [], "argmax": []}
           for t in (SAMPLED_KNOBS["temperature"], SAMPLED_SPEC_T)}

    def hold(prompt, o, knobs):
        rows, emitted = plain_rows(model, prompt, o)
        t = knobs["temperature"]
        if 0 < knobs["top_k"] < V or knobs["top_p"] < 1.0:
            edges.extend(keep_edges(rows, emitted, t, knobs["top_p"],
                                    knobs["top_k"]))
            control.extend(keep_edges(rows, emitted, t, 1.0, 1))
            return
        uniform = torch.randint(V, emitted.shape, generator=gen,
                                device=emitted.device)
        for name, toks in (("draws", emitted), ("uniform", uniform),
                           ("argmax", rows.argmax(dim=-1))):
            unf[t][name].append(draw_terms(rows, toks, t))

    for path in ("continuous_sampled", "continuous_mega_sampled"):
        runs = outs[path]
        for a, b in zip(runs[0], runs[1]):
            if not np.array_equal(a, b):
                raise RuntimeError(f"{path}: the same seed did not replay "
                                   "the same tokens")
        changed = [i for i, (a, c) in enumerate(zip(runs[0], runs[2]))
                   if SAMPLED_OVERRIDES[i].get("temperature") != 0.0
                   and not np.array_equal(a, c)]
        if not changed:
            raise RuntimeError(f"{path}: seed {SEED + 1} changed no sampled "
                               "request")
        for run in (runs[0], runs[2]):
            for p, o, over in zip(prompts, run, SAMPLED_OVERRIDES):
                if o.shape != (GEN_LEN,):
                    raise RuntimeError(f"{path}: bad output {o.shape}")
                knobs = {**SAMPLED_KNOBS, **over}
                if knobs["temperature"] <= 0.0:
                    greedy_gaps += teacher_forced_gaps(model, p, o)
                else:
                    hold(p, o, knobs)
        st = stats[path]
        block = {
            "wall_s": times[path]["wall_s"],
            "runs": len(runs),
            "requests_changed_by_seed": changed,
            **{k: [s[k] for s in st] for k in (
                "decode_steps", "generated_tokens", "prefix_hit_tokens",
                "mega_launches", "mega_filtered_rounds",
                "mega_fallback_steps")},
        }
        if path == "continuous_mega_sampled" and (
                min(block["mega_filtered_rounds"]) <= 0
                or max(block["mega_fallback_steps"]) != 0):
            raise RuntimeError(f"{path}: filtered rounds must run in the "
                               f"kernel: {block}")
        out[path] = block
    st = mega_engine.last_stats
    if st["mega_filtered_rounds"] <= 0:
        raise RuntimeError(f"paged_engine_mega_sampled: no filtered launch: "
                           f"{st}")
    for row in range(DENSE_ROWS):
        hold(dense_ids[row], outs["paged_engine_mega_sampled"][
            row, DENSE_PROMPT:], {"top_p": 1.0, **SAMPLED_ENGINE_KNOBS})
    out["paged_engine_mega_sampled"] = {
        k: st[k] for k in ("decode_ms_per_step", "decode_steps",
                           "mega_launches", "mega_filtered_rounds")}
    spec_knobs = dict(temperature=SAMPLED_SPEC_T, top_p=1.0, top_k=0)
    for got in outs["continuous_spec_sampled"]:
        for p, o in zip(spec_prompts, got):
            if o.shape != (SPEC_GEN,):
                raise RuntimeError(f"continuous_spec_sampled: bad output "
                                   f"{o.shape}")
            hold(p, o, spec_knobs)

    bad = []
    gworst = max(greedy_gaps)
    gexact = sum(g == 0 for g in greedy_gaps)
    if not np.isfinite(gworst) or gworst > TF_MARGIN or (
            gexact < TF_MIN_EXACT * len(greedy_gaps)):
        bad.append(f"greedy requests fail teacher forcing: worst {gworst}, "
                   f"exact {gexact}")
    worst = max(edges)
    ctl = sum(e > TF_MARGIN for e in control)
    if worst > TF_MARGIN:
        bad.append(f"a filtered token lies {worst} below its plain keep-set")
    if ctl == 0:
        bad.append("the top_k=1 control passed every filtered token")
    filtered = {"positions": len(edges), "keep_edge_worst": worst,
                "margin": TF_MARGIN, "top_k1_control_outside": [
                    ctl, len(control)]}
    unfiltered = {}
    for t, terms in unf.items():
        flat = {name: {k: [x for d in ds for x in d[k]] for k in (
            "gap", "dev", "var")} for name, ds in terms.items()}
        limit = TF_MARGIN + SAMPLED_TAIL * t
        z = {name: sum(f["dev"]) / max(sum(f["var"]), 1e-300) ** 0.5
             for name, f in flat.items()}
        draws = flat["draws"]
        rec = {"positions": len(draws["gap"]), "tail_gap_worst":
               max(draws["gap"]), "tail_limit": limit,
               "not_argmax": sum(g > 0 for g in draws["gap"]),
               "uniform_outside_tail": sum(
                   g > limit for g in flat["uniform"]["gap"]),
               "z": z["draws"], "uniform_z": z["uniform"],
               "argmax_z": z["argmax"]}
        if rec["tail_gap_worst"] > limit:
            bad.append(f"T={t}: a token lies {rec['tail_gap_worst']} below "
                       f"the plain maximum (limit {limit})")
        if t == SAMPLED_SPEC_T and rec["uniform_outside_tail"] == 0:
            bad.append(f"T={t}: uniform tokens passed the tail limit")
        if t != SAMPLED_SPEC_T and not (
                abs(z["draws"]) <= SAMPLED_Z < min(
                    abs(z["uniform"]), abs(z["argmax"]))):
            bad.append(f"T={t}: z {z} (|z| <= {SAMPLED_Z}; uniform and "
                       "argmax tokens must exceed it)")
        unfiltered[f"T{t}"] = rec
    print(f"[check] sampled tokens: filtered {json.dumps(filtered)}; "
          f"unfiltered {json.dumps(unfiltered)}; greedy requests: worst gap "
          f"{gworst:.4f}, exact {gexact}/{len(greedy_gaps)}")
    if bad:
        raise RuntimeError(f"sampled paths: {bad}")
    out["filtered"] = filtered
    out["unfiltered"] = unfiltered
    out["greedy_teacher_forcing"] = {"max_gap": gworst, "exact": gexact,
                                     "tokens": len(greedy_gaps)}
    print(f"[serve] sampled paths: {json.dumps(out)}")
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


# -- Qwen3-MoE ----------------------------------------------------------------
#
# Qwen/Qwen3-30B-A3B at full width and depth (48 layers, 128 experts, top 8,
# 32 q / 4 kv heads: G = 8), bf16, random weights from SEED: 61.1 GB, so
# it runs after the Qwen3-0.6B phases are freed. The kernel phase holds the
# MoE megakernel against its plain version at B=4, kv_len MEGA_LENS over
# a paged bf16 pool (NS 1 and 8, untraced and traced, one int8-pool
# launch, one filtered launch), and at 2 layers in f32; then four serving
# paths run MOE_REQUESTS requests (a MOE_PREFIX-token shared prefix plus
# MOE_SUFFIX-token suffixes, MOE_GEN tokens each) and 2 rows.
MOE_MODEL = "Qwen/Qwen3-30B-A3B"
MOE_REQUESTS, MOE_PREFIX, MOE_SUFFIX, MOE_GEN = 6, 256, (32, 128), 32
MOE_F32_LAYERS = 2
# At this depth a bf16 MoE step is chaotic: the kernel's f32 sums, taken
# in another order than the plain version's, flip a bf16 rounding now and
# then, the difference grows layer by layer (with the routing held equal,
# logits 0.11 of the limit after 2 layers and 1.31 after 48), and where a
# row's k-th and (k+1)-th router probabilities nearly tie it flips a
# routing; one flipped expert moves the residual by a few percent, and by
# layer 16 every row routes otherwise (measured on one H100). So the
# plain version is held to the kernel layer by layer (``_ForcedGate``):
# at each MOE_GATE its residual must lie within MOE_X_TOL of the kernel's
# (one layer's difference: both entered the layer before from the same
# state), and then takes the kernel's (``moe_x``); on that state the plain
# gate must pick the kernel's experts (``moe_route``), up to a near tie of
# at most MOE_TIE between its k-th and (k+1)-th probabilities, with
# combine weights within MOE_WEIGHT_TOL (f32 sums in another order), and
# it routes as the kernel routed. The logits, one layer from the kernel's
# state, are held to MEGA_TOL on every row. The first readings (measured
# on one H100): no routing flip, combine weights within 3.0e-7 (the
# limit is 33x that), residuals within 0.0174 of (0.05, 2^-6), which is
# MOE_X_TOL times 16: MOE_X_TOL is 3.6x the worst reading, and the
# negative control (an expert's weight zeroed at a middle layer) broke
# (0.05, 2^-6) 7.6x.
MOE_TIE = 1e-3
MOE_WEIGHT_TOL = 1e-5
MOE_X_TOL = (0.05 / 16, 2.0**-10)  # (atol, rtol) on the residual
# The token of the bf16 xla run's first request at this index is the
# mega paths' eos_id.
MOE_EOS_AT = 20
MOE_PATH_KERNELS = {
    # xla: the grouped expert FFN is torch.matmul per expert segment (as
    # the JAX package leaves ragged_dot to XLA); attention runs the
    # ported kernels. mega: every decode step is one MoE megakernel
    # launch (NS = 8, its single-step remainders included).
    "continuous_moe": ("flash_attention", "paged_flash_decode"),
    "continuous_moe_mega": ("flash_attention", "mega_decode_moe"),
    "continuous_moe_mega_int8": ("flash_attention_int8", "mega_decode_moe"),
    "engine_moe_mega_sampled": ("flash_attention", "mega_decode_moe"),
}
MOE_SPLIT_OPS = ("EMBED", "QKV_PROJ", "ATTN", "O_PROJ", "ALLREDUCE",
                 "MOE_GATE", "MOE_FFN", "A2A_SEND", "A2A_WAIT", "LM_HEAD")


class _ForcedGate:
    """A plain-version gate hook (``mega_decode_plain(gate_hook=)``) that
    holds the plain version to the kernel layer by layer, from the
    kernel's records ``route [NS, L, E, B]`` (its combine weights: nonzero
    = routed) and ``x_rec [NS, L, B, d]`` (the residual rows each gate
    read). ``enter``: the plain residual against the kernel's (per row,
    its use of MOE_X_TOL), then the kernel's residual in its place.
    ``route``: the plain gate, on that state, against the kernel's experts
    (each flip with its deficit: the plain k-th probability less the
    lowest plain probability among the experts only the kernel took) and
    combine weights; the plain version then routes as the kernel routed,
    with its own probabilities over those experts as combine weights.
    ``fault=(step, layer, row)`` zeroes that row's largest combine weight
    there (the negative control). Counts the distinct experts routed per
    (step, layer)."""

    def __init__(self, route, x_rec, k: int, norm: bool, fault=None):
        import torch

        self.kroute, self.x_rec, self.k, self.norm = route, x_rec, k, norm
        self.fault = fault
        ns, L, b = x_rec.shape[:3]
        self.x_use = torch.zeros((ns, L, b))
        self.flips, self.routed = [], {}
        self.deficit = self.weight_err = 0.0

    def enter(self, st, layer):
        kx = self.x_rec[st.step, layer].to(st.x.device)
        atol, rtol = MOE_X_TOL
        use = ((st.x - kx).abs() / (atol + rtol * kx.abs())).max(dim=1)
        self.x_use[st.step, layer] = use.values.cpu()
        st.x = kx.clone()

    def route(self, step, layer, probs, cw):
        import torch

        kern = self.kroute[step, layer].T.to(probs.device)  # [B, E]
        kset, k = kern != 0, self.k
        top = torch.sort(probs, dim=-1, descending=True, stable=True)
        pset = torch.zeros_like(kset).scatter_(1, top.indices[:, :k], True)
        for r in (kset != pset).any(dim=1).nonzero().flatten().tolist():
            deficit = (top.values[r, k - 1]
                       - probs[r][kset[r] & ~pset[r]].min()).item()
            self.flips.append(dict(step=step, layer=layer, row=r,
                                   deficit=deficit))
            self.deficit = max(self.deficit, deficit)
        forced = torch.where(kset, probs, torch.zeros_like(probs))
        if self.norm:
            forced = forced / forced.sum(dim=-1, keepdim=True)
        self.weight_err = max(self.weight_err,
                              (forced - kern).abs().max().item())
        self.routed[step, layer] = int(kset.any(dim=0).sum())
        if self.fault is not None and (step, layer) == self.fault[:2]:
            r = self.fault[2]
            forced[r, forced[r].argmax()] = 0.0
        return forced


def _moe_rows_ok(got, ref, fg, plain_at, atol, rtol, what) -> dict:
    """Kernel vs plain MoE launch (bf16), the plain version held to the
    kernel layer by layer (``fg``, a ``_ForcedGate``). A row whose tokens
    leave the plain stream must do so at a near tie of the plain logits
    (within MEGA_TIE_GAP of the plain top, as ``_mega_tokens_ok``); until
    then (its later steps embed another token) its residual at every gate
    lies within MOE_X_TOL of the kernel's. The routing, on the kernel's
    state: every flip a near tie (deficit <= MOE_TIE), the combine weights
    within MOE_WEIGHT_TOL. Every row whose tokens agree before the last
    step is held to the logit limit. Raises otherwise; returns the rows'
    record."""
    if fg.deficit > MOE_TIE or fg.weight_err > MOE_WEIGHT_TOL:
        worst = max(fg.flips, key=lambda f: f["deficit"], default=None)
        raise RuntimeError(f"{what}: the kernel's routing is no near tie of "
                           f"the plain gate's on the same state: worst flip "
                           f"{worst}, combine weights off by "
                           f"{fg.weight_err}")
    toks, rtoks = got[3], ref[3]
    ns, b = toks.shape
    ties, last = [], [ns - 1] * b
    for r in (toks != rtoks).any(dim=0).nonzero().flatten().tolist():
        s = int((toks[:, r] != rtoks[:, r]).nonzero()[0])
        last[r] = s
        lg = plain_at(s)[r]
        gap = (lg[rtoks[s, r]] - lg[toks[s, r]]).item()
        ties.append(dict(row=r, step=s, gap=gap))
        if not 0 <= gap <= MEGA_TIE_GAP:
            raise RuntimeError(f"{what}: kernel token {int(toks[s, r])} at "
                               f"row {r} step {s} is no near tie of plain's "
                               f"{int(rtoks[s, r])}: gap {gap}")
    x_use = max(fg.x_use[: last[r] + 1, :, r].max().item() for r in range(b))
    if not x_use <= 1.0:
        raise RuntimeError(f"{what}: a residual leaves MOE_X_TOL one layer "
                           f"from the kernel's state ({x_use} of it)")
    keep = (toks[:-1] == rtoks[:-1]).all(dim=0)
    err = (got[0] - ref[0]).abs()[keep]
    used = (err / (atol + rtol * ref[0].abs()[keep])).max().item()
    if not used <= 1.0:
        raise RuntimeError(f"{what}: logits use {used} of the limit")
    return {"rows": b, "held": int(keep.sum()), "limit_used": used,
            "max_abs_err": err.max().item(), "residual_limit_used": x_use,
            "ties": ties, "routing_flips": len(fg.flips),
            "rows_with_flips": len({f["row"] for f in fg.flips}),
            "worst_flip_deficit": fg.deficit,
            "combine_weight_err": fg.weight_err}


def _moe_bound(cfg, params, routed, kv8: bool) -> dict:
    """The least time of one MoE decode step at MEGA_LENS: the larger of
    its bytes over the HBM rate and its FLOPs over the bf16 peak. Bytes:
    the attention weights, router and norms of every layer, the LM head,
    the weights of the experts ``routed`` names (one count per layer: the
    distinct experts this step's rows route to), every cached K/V row
    (int8 codes plus two f32 scales a page over an int8 pool), the embed
    rows in and the logits and new K/V rows out. FLOPs: every non-expert
    GEMM for each row, each row's k experts, QK^T and P·V over each row's
    cache."""
    lp, L = params["layers"], cfg.num_layers
    b, hkv, hd = len(MEGA_LENS), cfg.num_kv_heads, cfg.head_dim
    d, f = cfg.hidden_size, cfg.moe_intermediate_size
    item = params["embed"].element_size()
    dense = (lp["attn"]["wqkv"], lp["attn"]["wo"], lp["mlp"]["w_router"],
             params["lm_head"])
    n_dense = sum(t.numel() for t in dense)
    norms = sum(t.numel() for t in (lp["ln1"], lp["ln2"],
                                    lp["attn"]["q_norm"],
                                    lp["attn"]["k_norm"], params["norm"]))
    expert = 3 * d * f
    kv = sum(MEGA_LENS) * L * hkv * hd * 2 * (1 if kv8 else item)
    if kv8:
        kv += sum(-(-n // PAGE) for n in MEGA_LENS) * L * hkv * 2 * 4
    out = b * params["lm_head"].shape[1] * 4 + 2 * L * b * hkv * hd * item
    fixed = (n_dense + norms) * item + kv + out + b * d * item
    flops = 2 * b * (n_dense + cfg.num_experts_per_tok * L * expert) + 4 * (
        cfg.num_q_heads * hd * L * sum(MEGA_LENS))

    def bound(n_experts):
        t_bytes = (fixed + n_experts * expert * item) / HBM_BPS
        t_ops = flops / BF16_FLOPS
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")

    ms, by = bound(sum(routed))
    all_ms, _ = bound(cfg.num_experts * L)
    return {"bound_ms": ms, "bound_by": by, "all_expert_bound_ms": all_ms,
            "routed_experts_per_layer": sum(routed) / L}


def _moe_launch_stats(log, ns: int, L: int) -> dict:
    """Per step of a launch, from the kernel's routing: the distinct
    experts routed at each layer, and the grid barriers the kernel runs a
    step (EMBED and LM_HEAD 1 each; a layer's QKV_PROJ 2, ATTN 2, O_PROJ
    1, ALLREDUCE 1, MOE_GATE 1, A2A_WAIT 1, each routed expert 3)."""
    routed = [[log.routed[s, l] for l in range(L)] for s in range(ns)]
    barriers = [2 + 8 * L + 3 * sum(r) for r in routed]
    return {"routed": routed, "barriers_per_step": sum(barriers) / ns}


def check_mega_moe_f32(dev) -> dict:
    """The MoE megakernel at Qwen3-30B-A3B width, MOE_F32_LAYERS layers, in
    f32 with TF32 off (~7.5 GB), over a paged f32 pool, NS 1 and 8:
    tokens equal to the plain version's, logits within MEGA_TOL f32, and
    the plain version with the last layer skipped outside it."""
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

    model = AutoLLM.from_pretrained(MOE_MODEL, device=dev, seed=SEED,
                                    dtype=torch.float32,
                                    num_layers=MOE_F32_LAYERS)
    cfg = model.cfg
    b, L, V = len(MEGA_LENS), cfg.num_layers, cfg.vocab_size
    paged, _ = init_paged_cache(cfg, b, dev, max_length=MAX_LENGTH,
                                page_size=PAGE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    for t in (paged.k_pages, paged.v_pages):
        t.normal_(generator=gen)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 13).integers(
        0, V, b).astype(np.int32)).to(dev)
    args = (paged.k_pages, paged.v_pages, paged.page_table,
            torch.tensor(MEGA_LENS, dtype=torch.int32, device=dev), tokens)
    mega = MegaQwen3(model, cfg=MegaConfig(fuse_norms=True,
                                           cross_prefetch=True,
                                           overlap_ar=True))
    w = MegaWeights.from_params(model.params)
    atol, rtol = MEGA_TOL["f32"]
    out = {}
    for ns in MEGA_NS:
        dims = dataclasses.replace(
            mega._dims(b, MAX_LENGTH, PAGE,
                       num_pages=int(paged.k_pages.shape[1])),
            nsteps=ns, v_real=V)
        comp = mega._compile(dims)
        got = comp.run(w, *args)
        torch.cuda.synchronize()
        ref = mega_decode_plain(dims, True, comp.table, w, *args)
        skip = comp.table[comp.table[:, 1] != L - 1]
        bad = mega_decode_plain(dims, True, skip, w, *args)[0]
        err = (got[0] - ref[0]).abs()
        used = (err / (atol + rtol * ref[0].abs())).max().item()
        bad_used = ((got[0] - bad).abs()
                    / (atol + rtol * bad.abs())).max().item()
        same = torch.equal(got[3], ref[3])
        print(f"[moe] f32 {L} layers NS={ns}: tokens == plain {same}, "
              f"logits max_abs_err {err.max().item():.3e} ({used:.3f} of the "
              f"limit {atol}); last layer skipped: {bad_used:.1f}x the limit")
        if not same or not used <= 1.0 or not bad_used > 1.0:
            raise RuntimeError(f"mega_decode_moe f32 NS={ns}: tokens equal "
                               f"{same}, limit use {used}, control "
                               f"{bad_used}")
        out[f"ns{ns}"] = {"max_abs_err": err.max().item(),
                          "limit_used": used, "control_limit_used": bad_used}
    return out


def check_mega_moe(dev, flush, model) -> dict:
    """The MoE megakernel against its plain version at Qwen3-30B-A3B's full
    width and depth, bf16, B=4, kv_len MEGA_LENS over a paged pool, with
    the engines' serving config (fused norms, the A2A combine): NS 1 and
    8 (rows held by ``_moe_rows_ok``; two launches bit-identical; the plain
    version with one routed expert's combine weight zeroed must leave the
    limit), traced (bit-identical to the untraced launch, the ring valid
    with one A2A window per layer and step, the step split by opcode),
    one NS=8 launch over the int8 pool (the same rows rule) and one
    filtered NS=8 launch (the filter alone picks an exact filter's token,
    the top-k 1 row the clean argmax, and planted noise is refused).
    Times each launch beside its bounds (the distinct routed experts of
    that launch, and every expert) and counts the barriers a step.
    Returns the ``mega_decode_moe`` record."""
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
    from triton_distributed_tpu_torch.megakernel.task import TaskType
    from triton_distributed_tpu_torch.models import sampling
    from triton_distributed_tpu_torch.models.paged_kv_cache import (
        init_paged_cache,
        quantize_pages,
    )
    from triton_distributed_tpu_torch.obs import kernel_trace as kt

    cfg = model.cfg
    b, L, V = len(MEGA_LENS), cfg.num_layers, cfg.vocab_size
    k = cfg.num_experts_per_tok
    paged, _ = init_paged_cache(cfg, b, dev, max_length=MAX_LENGTH,
                                page_size=PAGE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    for t in (paged.k_pages, paged.v_pages):
        t.normal_(generator=gen)
    lens = torch.tensor(MEGA_LENS, dtype=torch.int32, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 13).integers(
        0, V, b).astype(np.int32)).to(dev)
    args = (paged.k_pages, paged.v_pages, paged.page_table, lens, tokens)
    mega = MegaQwen3(model, cfg=MegaConfig(fuse_norms=True,
                                           cross_prefetch=True,
                                           overlap_ar=True))
    w = MegaWeights.from_params(model.params)
    atol, rtol = MEGA_TOL["bf16"]
    rec = {"ms_per_step": {}, "plain_ms_per_launch": {},
           "traced_ms_per_step": {}, "split_ms_per_step": {},
           "barriers_per_step": {}, "bounds": {}, "rows": {},
           "max_abs_err": 0.0}
    flipped = checked = 0
    info = {}
    E, norm = cfg.num_experts, cfg.norm_topk_prob
    base = dataclasses.replace(
        mega._dims(b, MAX_LENGTH, PAGE,
                   num_pages=int(paged.k_pages.shape[1])), v_real=V)
    for ns in MEGA_NS:
        dims = dataclasses.replace(base, nsteps=ns)
        comp = mega._compile(dims)
        route = torch.zeros((ns, L, E, b), dtype=torch.float32, device=dev)
        x_rec = torch.zeros((ns, L, b, cfg.hidden_size), dtype=torch.float32,
                            device=dev)
        got = comp.run(w, *args, info=info, moe_route=route, moe_x=x_rec)
        again = comp.run(w, *args)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise RuntimeError(f"mega_decode_moe NS={ns}: two launches on "
                               "the same inputs differ")
        forced = (route, x_rec, k, norm)
        log = _ForcedGate(*forced)
        ref = mega_decode_plain(dims, True, comp.table, w, *args,
                                gate_hook=log)

        def plain_at(s, dims=dims, table=comp.table, forced=forced):
            d1 = dataclasses.replace(dims, nsteps=s + 1)
            return mega_decode_plain(d1, True, table, w, *args,
                                     gate_hook=_ForcedGate(*forced))[0]

        rows = _moe_rows_ok(got, ref, log, plain_at, atol, rtol,
                            f"mega_decode_moe NS={ns}")
        if ns == 1:
            # For the record: the plain version on its own (its routing
            # and state free), against the kernel.
            free = mega_decode_plain(dims, True, comp.table, w, *args)[0]
            rows["free_plain_limit_used"] = (
                (got[0] - free).abs() / (atol + rtol * free.abs())
            ).max().item()
        flipped += rows["rows_with_flips"]
        checked += rows["rows"]
        rec["rows"][f"ns{ns}"] = rows
        rec["max_abs_err"] = max(rec["max_abs_err"], rows["max_abs_err"])
        stats = _moe_launch_stats(log, ns, L)
        rec["barriers_per_step"][f"ns{ns}"] = stats["barriers_per_step"]
        bnd = [_moe_bound(cfg, model.params, r, False)
               for r in stats["routed"]]
        rec["bounds"][f"ns{ns}"] = {
            key: sum(x[key] for x in bnd) / ns for key in (
                "bound_ms", "all_expert_bound_ms",
                "routed_experts_per_layer")}
        rec["bounds"][f"ns{ns}"]["bound_by"] = bnd[0]["bound_by"]
        # The negative control: one routed expert's combine weight zeroed
        # (row 0's largest, at the last layer of the last step).
        # The negative controls: one routed expert's combine weight zeroed
        # (row 0's largest) at the last layer of the last step must break
        # the logit limit, and at a middle layer of step 0 the residual
        # limit at the next gate.
        bad = mega_decode_plain(dims, True, comp.table, w, *args,
                                gate_hook=_ForcedGate(
                                    *forced, fault=(ns - 1, L - 1, 0)))[0]
        bad_used = ((got[0] - bad).abs()
                    / (atol + rtol * bad.abs())).max().item()
        mid_l = (L - 1) // 2
        mid = _ForcedGate(*forced, fault=(0, mid_l, 0))
        mega_decode_plain(dims, True, comp.table, w, *args, gate_hook=mid)
        bad_x = mid.x_use[0, mid_l + 1, 0].item()
        rows["control_limit_used"] = bad_used
        rows["control_residual_limit_used"] = bad_x
        if not (bad_used > 1.0 and bad_x > 1.0):
            raise RuntimeError(f"mega_decode_moe NS={ns}: a routed expert's "
                               "weight zeroed stays within the limits "
                               f"(logits {bad_used}, residual {bad_x})")
        ms = median_ms(lambda: comp.run(w, *args), flush)
        rec["ms_per_step"][f"ns{ns}"] = ms / ns
        if ns == 1:
            rec["plain_ms_per_launch"]["ns1"] = median_ms(
                lambda: mega_decode_plain(dims, True, comp.table, w, *args),
                flush, iters=3, warmup=1)
        # Traced: the untraced outputs bit for bit, the ring valid, and the
        # step split by opcode (one launch's CUDA-event time spread over
        # its ring's ticks).
        tdims = dataclasses.replace(dims, trace=True)
        tcomp = mega._compile(tdims)
        launches = []
        for _ in range(3):
            flush.zero_()
            torch.cuda._sleep(LEAD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            tout = tcomp.run(w, *args)
            end.record()
            end.synchronize()
            launches.append((start.elapsed_time(end), tout))
        event_ms, tout = sorted(launches, key=lambda x: x[0])[1]
        if not all(torch.equal(x, y) for x, y in zip(got, tout[:5])):
            raise RuntimeError(f"mega_decode_moe traced NS={ns} differs from "
                               "the untraced launch")
        recs = kt.decode_trace(tout[5].cpu().numpy())
        problems = kt.validate_ring(recs, tcomp.order)
        windows = kt.overlap_report(recs)["a2a_windows"]
        a2a = [r for r in recs if r.opcode in (int(TaskType.A2A_SEND),
                                               int(TaskType.A2A_WAIT))]
        if problems or windows != L * ns or not all(
                r.begin <= r.mid <= r.end for r in a2a):
            raise RuntimeError(f"mega_decode_moe traced NS={ns}: ring "
                               f"problems {problems[:5]}, a2a_windows "
                               f"{windows} (want {L * ns})")
        span = max(r.end for r in recs) - min(r.begin for r in recs)
        split = {}
        for r in recs:
            split[r.op] = split.get(r.op, 0.0) + r.dur * event_ms / span / ns
        rec["traced_ms_per_step"][f"ns{ns}"] = event_ms / ns
        rec["split_ms_per_step"][f"ns{ns}"] = {
            op: split.get(op, 0.0) for op in MOE_SPLIT_OPS}
        shown = {key: v for key, v in rows.items() if key != "ties"}
        print(f"[moe] NS={ns}: {ms / ns:.4f} ms per step (bounds "
              f"{json.dumps(rec['bounds'][f'ns{ns}'])}), "
              f"{stats['barriers_per_step']:.0f} barriers a step; rows "
              f"{json.dumps(shown)}, ties {rows['ties']}; traced == "
              f"untraced, ring valid, {windows} A2A windows; split per step "
              f"{json.dumps(rec['split_ms_per_step'][f'ns{ns}'])}; launch "
              f"{info}")
    # One NS=8 launch over the int8 pool.
    k8, ks = quantize_pages(paged.k_pages)
    v8, vs = quantize_pages(paged.v_pages)
    sc = {"k_scale": ks, "v_scale": vs}
    args8 = (k8, v8, paged.page_table, lens, tokens)
    dims = dataclasses.replace(base, nsteps=8, kv_quant=True)
    comp = mega._compile(dims)
    route = torch.zeros((8, L, E, b), dtype=torch.float32, device=dev)
    x_rec = torch.zeros((8, L, b, cfg.hidden_size), dtype=torch.float32,
                        device=dev)
    got = comp.run(w, *args8, **sc, moe_route=route, moe_x=x_rec)
    torch.cuda.synchronize()
    forced = (route, x_rec, k, norm)
    log = _ForcedGate(*forced)
    ref = mega_decode_plain(dims, True, comp.table, w, *args8, **sc,
                            gate_hook=log)
    rows = _moe_rows_ok(
        got, ref, log, lambda s: mega_decode_plain(
            dataclasses.replace(dims, nsteps=s + 1), True, comp.table, w,
            *args8, **sc, gate_hook=_ForcedGate(*forced))[0],
        atol, rtol, "mega_decode_moe int8 pool")
    flipped += rows["rows_with_flips"]
    checked += rows["rows"]
    rec["rows"]["int8_pool_ns8"] = rows
    rec["int8_pool_ms_per_step_ns8"] = median_ms(
        lambda: comp.run(w, *args8, **sc), flush) / 8
    stats = _moe_launch_stats(log, 8, L)
    rec["int8_pool_bound_ms"] = sum(
        _moe_bound(cfg, model.params, r, True)["bound_ms"]
        for r in stats["routed"]) / 8
    del k8, v8
    # One filtered NS=8 launch: the filter alone, the top-k 1 row and the
    # planted control on the kernel's own logits (the dense path's
    # sampled checks).
    frows = MEGA_SAMPLED_ROWS["filtered"]
    dims = dataclasses.replace(base, nsteps=8, sampled=True, filtered=True)
    comp = mega._compile(dims)
    fgen = torch.Generator(device=dev).manual_seed(SEED + 4)
    temps = torch.tensor([t for t, _, _ in frows], device=dev)
    noise = sampling.gumbel((8, b, dims.v_loc), fgen, dev) \
        * temps[None, :, None]
    scfg = torch.tensor([sampling.sampcfg_row(*r, V) for r in frows],
                        dtype=torch.float32, device=dev)
    fgot = comp.run(w, *args, noise=noise, sampcfg=scfg)
    torch.cuda.synchronize()
    logits, last = fgot[0], fgot[3][-1].tolist()
    bands = filter_band(logits, noise[-1], scfg, V)
    off = [i for i in range(b) if last[i] not in bands[i]["winners"]]
    clean = int(logits[2, :V].argmax())
    noisy = int((logits[2, :V] + noise[-1, 2, :V]).argmax())
    planted = _planted_control(comp, w, args, noise, scfg, fgot, bands, V)
    rec["filtered"] = {"off_band_rows": off,
                       "top_k1_took_clean_noisy": [last[2], clean, noisy],
                       "planted": planted}
    if off or last[2] != clean or noisy == clean or planted["bad"]:
        raise RuntimeError(f"mega_decode_moe filtered: {rec['filtered']}")
    rec["filtered_ms_per_step_ns8"] = median_ms(
        lambda: comp.run(w, *args, noise=noise, sampcfg=scfg), flush) / 8
    print(f"[moe] int8 pool NS=8: {rec['int8_pool_ms_per_step_ns8']:.4f} ms "
          f"per step (bound {rec['int8_pool_bound_ms']:.4f}), routing "
          f"flips {rows['routing_flips']}, limit use "
          f"{rows['limit_used']:.3f}; filtered "
          f"NS=8: {rec['filtered_ms_per_step_ns8']:.4f} ms per step, "
          f"{json.dumps(rec['filtered'])}")
    # No row is exempt from the logit limit (the plain version routes as
    # the kernel did); the rows whose routing flipped at a near tie are
    # counted.
    rec["rows_with_routing_flips"] = [flipped, checked]
    print(f"[moe] rows whose kernel routing flipped at a near tie: "
          f"{flipped} of {checked}; rows outside the logit limit: 0")
    main = rec["bounds"]["ns1"]
    return dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/megakernel.cu",
        replaces="triton_distributed_tpu/megakernel/kernels.py:1133",
        max_abs_err=rec.pop("max_abs_err"), ms=rec["ms_per_step"]["ns1"],
        plain_ms=rec["plain_ms_per_launch"]["ns1"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=None,
        shape=f"{MOE_MODEL} 48 layers, 128 experts top-8, B={b}, paged "
              f"page={PAGE}, kv_len {list(MEGA_LENS)}, NS=1 bf16 (ms = one "
              "step; bound_ms counts the distinct routed experts, "
              "all_expert_bound_ms every expert); the MoE bodies "
              "kernels.py:1133 moe_gate_body, :1188 moe_ffn_body, :1253 "
              "a2a_send_body, :1296 a2a_wait_body at tp=1",
        all_expert_bound_ms=main["all_expert_bound_ms"],
        launch=info, **rec)


def serve_moe_paths(dev, model):
    """The MoE serving paths at full width and depth: ``continuous_moe``
    (mode xla, bf16 pool), ``continuous_moe_mega`` (ns 8, an eos_id, the
    tracer on, the serving-default MegaConfig: the A2A combine),
    ``continuous_moe_mega_int8`` (the same over the int8 pool) and
    ``engine_moe_mega_sampled`` (2 rows, T 0.7, top-k 64, mode mega).
    Each path's launch counts are reset just before it and read just
    after. Checks: audits, teacher forcing against the plain MoE forward
    (bf16 and int8 limits), the MoE ledger against the traffic's
    arithmetic, every traced ring valid with one A2A window per layer and
    step, and the sampled rows' keep-sets (the top-k 1 control must
    fail). Returns (launches by path, the e2e block)."""
    import numpy as np
    import torch

    from triton_distributed_tpu_torch.models import ContinuousEngine, Engine
    from triton_distributed_tpu_torch.obs import events as obs_events
    from triton_distributed_tpu_torch.obs import kernel_trace as kt
    from triton_distributed_tpu_torch.ops import cuda_kernels as ck

    gg = sys.modules["triton_distributed_tpu_torch.ops.moe.grouped_gemm"]
    cfg = model.cfg
    L, V, k = cfg.num_layers, cfg.vocab_size, cfg.num_experts_per_tok
    rng = np.random.default_rng(SEED + 11)
    prefix = rng.integers(0, V, MOE_PREFIX)
    prompts = [np.concatenate([prefix, rng.integers(0, V, n)]).astype(
        np.int32) for n in rng.integers(MOE_SUFFIX[0], MOE_SUFFIX[1] + 1,
                                        MOE_REQUESTS)]
    dense_ids = rng.integers(0, V, (DENSE_ROWS, DENSE_PROMPT)).astype(
        np.int32)
    requests = [(p, MOE_GEN) for p in prompts]
    engs, outs, launches, times, rings, single = {}, {}, {}, {}, {}, {}
    decode_t = _Timed(model, "decode_step")

    def continuous(path, **kw):
        eng = engs[path] = ContinuousEngine(
            model, max_batch=4, page_size=PAGE, max_length=MAX_LENGTH,
            prefix_cache=True, device=dev, **kw)
        if kw.get("mode") == "mega":
            kept = rings[path] = []
            inner_rec = eng._record_kernel_trace

            def record(*a, **kw2):
                inner_rec(*a, **kw2)
                kept.append(eng._kernel_traces[-1])
            eng._record_kernel_trace = record
            # The positions the single-step rounds route: the slots live
            # at each such step (the count the engine bumps, read beside
            # it).
            single[path] = 0
            inner_once = eng._decode_once

            def once():
                single[path] += sum(r is not None for r in eng._slots)
                return inner_once()
            eng._decode_once = once
        return eng.run(requests)

    def mega_eos():
        """The mega paths' eos_id: the token of the xla run's first
        request at MOE_EOS_AT if no request emitted it first (every request
        then decodes before it may stop); else the highest vocabulary id
        that no xla request emitted (the random model may repeat one token
        throughout: the stop-token test then runs every step and never
        fires)."""
        streams = outs["continuous_moe"]
        tok = int(streams[0][MOE_EOS_AT])
        if all(int(o[0]) != tok for o in streams):
            return tok
        seen = {int(t) for o in streams for t in o}
        return next(v for v in range(V - 1, -1, -1) if v not in seen)

    runs = {
        "continuous_moe": lambda: continuous("continuous_moe"),
        "continuous_moe_mega": lambda: continuous(
            "continuous_moe_mega", mode="mega", ns=8, eos_id=mega_eos(),
            kernel_trace=True),
        "continuous_moe_mega_int8": lambda: continuous(
            "continuous_moe_mega_int8", mode="mega", ns=8,
            eos_id=mega_eos(), kv_dtype="int8", kernel_trace=True),
        "engine_moe_mega_sampled": lambda: engs.setdefault(
            "engine_moe_mega_sampled", Engine(
                model, mode="mega", device=dev, **SAMPLED_ENGINE_KNOBS)
        ).serve(dense_ids, DENSE_GEN, MAX_LENGTH, ns=8),
    }
    for path, run in runs.items():
        seg0, dec0 = gg.SEGMENTS, decode_t.snapshot()
        ev0 = obs_events.default_ring().next_seq - 1
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        outs[path] = run()
        torch.cuda.synchronize()
        launches[path] = ck.launch_counts()
        events, dropped = obs_events.default_ring().tail(ev0)
        if dropped:
            raise RuntimeError(f"{path}: {dropped} engine events overwritten")
        times[path] = {
            "wall_s": time.perf_counter() - t0,
            "expert_segment_gemms": gg.SEGMENTS - seg0,
            "decode_step_s": decode_t.seconds - dec0[0],
            "decode_step_calls": decode_t.calls - dec0[1],
            "launch_positions": sum(e.fields["ns"] * e.fields["active"]
                                    for e in events
                                    if e.kind == "mega:launch"),
        }
        print(f"[moe] {path}: {json.dumps(times[path])}; launches "
              f"{launches[path]}")
    for path, need in MOE_PATH_KERNELS.items():
        ran = {name for name, n in launches[path].items() if n > 0}
        if ran != set(need):
            raise RuntimeError(f"the {path} run launched {sorted(ran)}, "
                               f"expected {sorted(need)}")

    e2e = {"model": MOE_MODEL}
    for path, margin, min_exact in (
            ("continuous_moe", TF_MARGIN, TF_MIN_EXACT),
            ("continuous_moe_mega", TF_MARGIN, TF_MIN_EXACT),
            ("continuous_moe_mega_int8", TF8_MARGIN, TF8_MIN_EXACT)):
        eng = engs[path]
        st = eng.last_stats
        if eng.audit():
            raise RuntimeError(f"{path}: audit {eng.audit()}")
        gaps = []
        for p, o in zip(prompts, outs[path]):
            if not (o.shape == (MOE_GEN,) or (
                    eng.eos_id is not None and 0 < len(o) < MOE_GEN
                    and int(o[-1]) == eng.eos_id)):
                raise RuntimeError(f"{path}: bad output {o.shape}")
            gaps += teacher_forced_gaps(model, p, o)
        tf = _tf_check(f"MoE {path}", gaps, margin, min_exact)
        # The ledger: every prefilled position and every position a
        # decode step or launch routed, k assignments each.
        if eng.mode == "mega":
            positions = times[path]["launch_positions"] + single[path]
        else:
            positions = st["generated_tokens"] - st["admitted"]
        want = k * (st["prefill_tokens"] + positions)
        if st["moe_routed_tokens"] != want or st["a2a_dropped"] != 0 or (
                st["num_experts"], st["experts_per_tok"]) != (
                cfg.num_experts, k):
            raise RuntimeError(f"{path}: MoE ledger {st['moe_routed_tokens']}"
                               f" routed, want {want}")
        block = {"teacher_forcing": tf, "wall_s": times[path]["wall_s"],
                 "moe_routed_tokens": st["moe_routed_tokens"],
                 **{key: st[key] for key in (
                     "prefill_tokens", "prefix_hit_tokens", "decode_steps",
                     "generated_tokens", "kv_dtype")}}
        if eng.mode == "mega":
            mega = eng._mega_model()
            bad = []
            for ln in rings[path]:
                recs = kt.decode_trace(ln.ring)
                order = [o for key, o in mega._orders.items()
                         if key[9] and key[3] == ln.nsteps
                         and len(o) == ln.ring.shape[-2]]
                problems = kt.validate_ring(recs, order[0]) if order else [
                    "no traced build matches the ring"]
                windows = kt.overlap_report(recs)["a2a_windows"]
                if problems or windows != L * ln.nsteps:
                    bad.append((problems[:3], windows, ln.nsteps))
            if bad or not rings[path]:
                raise RuntimeError(f"{path}: traced launches {bad}")
            block.update(
                traced_launches=len(rings[path]),
                mega_launches=st["mega_launches"],
                mega_fallback_steps=st["mega_fallback_steps"],
                kernel_launches=launches[path]["mega_decode_moe"],
                eos_id=eng.eos_id)
        else:
            block.update(
                decode_ms_per_step=times[path]["decode_step_s"]
                / max(times[path]["decode_step_calls"], 1) * 1e3,
                expert_segment_gemms_per_decode_step=times[path][
                    "expert_segment_gemms"] / max(st["decode_steps"], 1))
        e2e[path] = block
    # The sampled Engine: its filtered tokens in their plain keep-sets, the
    # same check at top-k 1 failing somewhere; its ledger.
    eng = engs["engine_moe_mega_sampled"]
    st = eng.last_stats
    edges, control = [], []
    knobs = {"top_p": 1.0, **SAMPLED_ENGINE_KNOBS}
    for row in range(DENSE_ROWS):
        rows_, emitted = plain_rows(model, dense_ids[row],
                                    outs["engine_moe_mega_sampled"][
                                        row, DENSE_PROMPT:])
        edges += keep_edges(rows_, emitted, knobs["temperature"], 1.0,
                            knobs["top_k"])
        control += keep_edges(rows_, emitted, knobs["temperature"], 1.0, 1)
    want = k * DENSE_ROWS * (DENSE_PROMPT + DENSE_GEN - 1)
    ctl = sum(e > TF_MARGIN for e in control)
    print(f"[check] MoE engine_moe_mega_sampled: keep edge worst "
          f"{max(edges):.4f} over {len(edges)} positions (margin "
          f"{TF_MARGIN}), top_k=1 control outside {ctl}/{len(control)}; "
          f"routed {st['moe_routed_tokens']} (want {want}), filtered "
          f"launches {st['mega_filtered_rounds']}")
    if (max(edges) > TF_MARGIN or ctl == 0 or st["mega_filtered_rounds"] <= 0
            or st["moe_routed_tokens"] != want):
        raise RuntimeError(f"engine_moe_mega_sampled: edges {max(edges)}, "
                           f"control {ctl}, {st}")
    e2e["engine_moe_mega_sampled"] = {
        "keep_edge_worst": max(edges), "positions": len(edges),
        "top_k1_control_outside": [ctl, len(control)],
        **{key: st[key] for key in ("decode_ms_per_step", "decode_steps",
                                    "mega_launches", "mega_filtered_rounds",
                                    "moe_routed_tokens")}}
    print(f"[serve] MoE paths: {json.dumps(e2e)}")
    return launches, e2e


MOE_ALIGN_ROWS = 4      # one decode step's batch
MOE_ALIGN_BLOCK = 16


def check_native_align(dev, model) -> dict:
    """The native MoE align/sort (``ops/moe/native_sort.py``, the port's
    copy of ``csrc/moe_utils.cc`` built by g++ on the card's host): one
    decode step's routing of ``model`` (top-k of its experts, layer 0's
    router over MOE_ALIGN_ROWS random hidden rows) aligned to
    MOE_ALIGN_BLOCK by the host planner and by the custom op equals the
    torch ``moe_align_block_size`` on the card in all four fields."""
    import numpy as np
    import torch

    from triton_distributed_tpu_torch import native
    from triton_distributed_tpu_torch.ops.moe.native_sort import (
        moe_align_block_size_host,
        moe_align_block_size_op,
    )
    from triton_distributed_tpu_torch.ops.moe.routing import (
        moe_align_block_size,
        router_topk,
    )

    cfg = model.cfg
    t0 = time.perf_counter()
    native.build()
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    h = torch.randn((MOE_ALIGN_ROWS, cfg.hidden_size), generator=gen,
                    device=dev).to(cfg.dtype)
    wr = model.params["layers"]["mlp"]["w_router"][0]
    eids = router_topk(h, wr, cfg.num_experts_per_tok,
                       norm_topk_prob=cfg.norm_topk_prob).expert_ids
    E, bs = cfg.num_experts, MOE_ALIGN_BLOCK
    want = moe_align_block_size(eids, E, bs)
    host = moe_align_block_size_host(eids.cpu().numpy(), E, bs)
    op = moe_align_block_size_op(eids.cpu(), E, bs)
    for got, how in ((host, "host planner"), (op, "custom op")):
        for f in ("sorted_ids", "block_expert", "num_blocks", "num_padded"):
            if not np.array_equal(np.asarray(torch.as_tensor(
                    getattr(got, f)).cpu()), getattr(want, f).cpu().numpy()):
                raise RuntimeError(f"native align ({how}): {f} differs from "
                                   "the torch moe_align_block_size")
    flat = eids.cpu().numpy()
    t1 = time.perf_counter()
    for _ in range(100):
        moe_align_block_size_host(flat, E, bs)
    host_us = (time.perf_counter() - t1) / 100 * 1e6
    res = {"build_s": build_s, "rows": MOE_ALIGN_ROWS,
           "top_k": cfg.num_experts_per_tok, "experts": E, "block": bs,
           "num_blocks": int(host.num_blocks),
           "num_padded": int(host.num_padded), "host_us_per_call": host_us}
    print(f"[moe] native align: built in {build_s:.2f} s; a decode step's "
          f"routing ({MOE_ALIGN_ROWS} rows, top-{cfg.num_experts_per_tok} of "
          f"{E}) aligned to {bs}: host planner and custom op == torch "
          f"moe_align_block_size on the card in all four fields "
          f"({res['num_blocks']} blocks); {host_us:.1f} us a host call")
    return res


def check_moe(dev):
    """Phase 4: Qwen3-30B-A3B. The f32 kernel check at MOE_F32_LAYERS
    layers, then the bf16 model at full width and depth: the kernel phase
    and the serving paths. Returns (records by kernel, launches by path,
    the e2e block)."""
    import torch

    from triton_distributed_tpu_torch.models import AutoLLM

    torch.cuda.empty_cache()
    f32 = check_mega_moe_f32(dev)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = AutoLLM.from_pretrained(MOE_MODEL, device=dev, seed=SEED)
    torch.cuda.synchronize()
    print(f"[moe] {MOE_MODEL} random init on {dev} in "
          f"{time.perf_counter() - t0:.1f} s ({model.cfg.num_layers} layers, "
          f"{model.cfg.num_experts} experts; "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated)")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    record = check_mega_moe(dev, flush, model)
    record["f32"] = f32
    del flush
    launches, e2e = serve_moe_paths(dev, model)
    e2e["native_align"] = check_native_align(dev, model)
    return {"mega_decode_moe": record}, launches, e2e


# Tensor parallelism: Qwen3-8B (32 q / 8 kv heads, hidden 4096, d_ff
# 12288, 36 layers, bf16) at tp=2, both ranks co-located on the card:
# 5 requests of TP_PROMPT_LENS tokens (no shared prefix) and TP_GEN new
# tokens through ContinuousEngine(mode="pallas", prefix_cache=True) (one
# chunk a prompt: 48 rows, 384 KB of output, take gemm_ar ONE_SHOT; 384
# rows, 3 MB, and 640 rows, 5.2 MB, past the 4 MB where the JAX AUTO
# takes XLA, TWO_SHOT: gemm_rs then the full-mesh all_gather), the same
# with prefill_chunk=128 (1 MB chunks: TWO_SHOT), and
# Engine(mode="pallas", paged=True) on the two 300-token prompts (the
# sequence-sharded prefill: ag_gemm and gemm_rs; decode gemm_ar
# ONE_SHOT, 2 a layer a step).
TP_MODEL = "Qwen/Qwen3-8B"
TP = 2
TP_PROMPT_LENS = (40, 300, 40, 300, 600)
TP_GEN = 32
TP_MAX_LENGTH = 768
TP_CHUNK = 128
TP_STRESS = 100
TP_PATH_KERNELS = {
    "continuous_tp": ("flash_attention", "paged_flash_decode", "gemm_ar",
                      "gemm_rs", "all_gather"),
    "continuous_tp_chunk128": ("flash_attention", "paged_flash_decode",
                               "gemm_ar", "gemm_rs", "all_gather"),
    "paged_engine_tp": ("flash_attention", "paged_flash_decode",
                        "ag_gemm_adaptive", "gemm_rs", "gemm_ar"),
}
# The options of the overlap kernels (check_tp_options), each path one
# call of a user's entry point with its option: ag_gemm in ring order
# (adaptive=False; the prefill's default on the card is adaptive),
# gemm_rs_op with an e4m3 wire (bf16 inputs) and a bf16 wire (f32
# inputs), gemm_rs_op's one-rank ring (force_kernel at tp=1) and
# gemm_ar_op's device trace ring.
TP_OPTION_PATH_KERNELS = {
    "ag_gemm_ring": ("ag_gemm",),
    "gemm_rs_op_wire": ("gemm_rs_wire_e4m3", "gemm_rs_wire_bf16"),
    "gemm_rs_op_n1": ("gemm_rs_n1",),
    "gemm_ar_op_traced": ("gemm_ar_traced",),
}
TP_LAG_NS = 500_000     # the adaptive ag_gemm's lagging rank's least lag
TP_LAG_RANK = 2
TP_OPTION_STRESS = 100
TP_TRACE_TILE = 512     # gemm_ar's default tile_n at N = 4096 (pick_tile)
TP_SOURCES = {
    "gemm_ar": ("triton_distributed_tpu_torch/csrc/overlap.cu",
                "triton_distributed_tpu/ops/overlap/gemm_ar.py:84"),
    "gemm_rs": ("triton_distributed_tpu_torch/csrc/overlap.cu",
                "triton_distributed_tpu/ops/overlap/gemm_rs.py:116"),
    "ag_gemm": ("triton_distributed_tpu_torch/csrc/overlap.cu",
                "triton_distributed_tpu/ops/overlap/ag_gemm.py:163"),
    "all_gather": ("triton_distributed_tpu_torch/csrc/collectives.cu",
                   "triton_distributed_tpu/ops/collectives/all_gather.py:146"),
    "ag_gemm_adaptive": ("triton_distributed_tpu_torch/csrc/overlap.cu",
                         "triton_distributed_tpu/ops/overlap/ag_gemm.py:128"),
    "gemm_rs_wire_e4m3": ("triton_distributed_tpu_torch/csrc/overlap.cu",
                          "triton_distributed_tpu/ops/overlap/gemm_rs.py:116"),
    "gemm_rs_wire_bf16": ("triton_distributed_tpu_torch/csrc/overlap.cu",
                          "triton_distributed_tpu/ops/overlap/gemm_rs.py:116"),
    "gemm_rs_n1": ("triton_distributed_tpu_torch/csrc/overlap.cu",
                   "triton_distributed_tpu/ops/overlap/gemm_rs.py:116"),
    "gemm_ar_traced": ("triton_distributed_tpu_torch/csrc/overlap.cu",
                       "triton_distributed_tpu/ops/overlap/gemm_ar.py:84"),
}


def _two_shot_chunks(lens, chunk: int, width: int, itemsize: int) -> int:
    """The prefill chunks of ``lens`` whose gemm_ar output passes 512 KB,
    where the card's AUTO takes TWO_SHOT (a chunk width is a multiple of
    16, so m % tp == 0): one chunk of round_chunk(s) rows a prompt, or
    chunks of round_chunk(chunk) rows."""
    from triton_distributed_tpu_torch.models.prefix_cache import round_chunk

    total = 0
    for s in lens:
        c = round_chunk(chunk) if chunk else round_chunk(s)
        if c * width * itemsize > 512 * 1024:
            total += -(-s // c)
    return total


def _tp_limit(dtype, n):
    """Kernel vs plain: f32 (TF32 off) sums in another order, 1e-4 +
    1e-5·|p| on outputs of size ~1; bf16 rounds each rank's partial (and
    each ring hop's sum) to bf16, one ulp a flip: n·(2^-6 + 2^-7·|p|)."""
    import torch

    return (1e-4, 1e-5) if dtype == torch.float32 else (
        2.0**-6 * n, 2.0**-7 * n)


def check_tp_kernels(dev, flush) -> dict:
    """Each cross-rank kernel against its plain version on the same
    per-rank inputs: n=2 and n=4 at tiny f32 widths, Qwen3-8B tp=2 bf16
    serving shapes (decode B=4 o-proj and FC2; prefill rows 384); every
    rank's gemm_ar and all_gather output bitwise the same; TP_STRESS
    back-to-back launches of each with fresh inputs, every output
    checked; then the timing of the serving shapes."""
    import numpy as np
    import torch

    from triton_distributed_tpu_torch.ops.collectives import (
        all_gather_full_mesh,
        all_gather_plain,
    )
    from triton_distributed_tpu_torch.ops.overlap import (
        ag_gemm_plain,
        create_gemm_rs_context,
        gemm_ar_plain,
        gemm_rs_plain,
    )
    from triton_distributed_tpu_torch.ops.overlap.ag_gemm import (
        ag_gemm_kernel,
    )
    from triton_distributed_tpu_torch.ops.overlap.gemm_ar import (
        gemm_ar_one_shot,
    )
    from triton_distributed_tpu_torch.ops.overlap.gemm_rs import (
        gemm_rs_ring,
        ring_split,
    )
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    rng = np.random.default_rng(SEED + 10)
    bf16, f32 = torch.bfloat16, torch.float32

    def rand(shape, dtype, scale=1.0):
        return (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev) * scale).to(dtype)

    def operands(n, dtype, m, k, nout, rows=False):
        ctx = initialize_distributed(n, device=dev, dtype=dtype)
        a, b = rand((m, k), dtype), rand((k, nout), dtype, k**-0.5)
        if rows:
            return ctx, ctx.shard(a, 0), ctx.shard(b, 1)
        return ctx, ctx.shard(a, 1), ctx.shard(b, 0)

    def check(name, got, want, dtype, n, what):
        atol, rtol = _tp_limit(dtype, n)
        worst = 0.0
        for g, w in zip(got, want):
            e = (g.float() - w.float()).abs()
            lim = atol + rtol * w.float().abs()
            if not bool(torch.isfinite(g.float()).all()) or bool(
                    (e > lim).any()):
                raise RuntimeError(
                    f"{name} {what}: |kernel - plain| {float(e.max()):.3g} "
                    f"over the limit ({atol:.3g} + {rtol:.3g}|p|)")
            worst = max(worst, float(e.max()))
        return worst

    def same_on_every_rank(name, got, what):
        if not all(torch.equal(g, got[0]) for g in got[1:]):
            raise RuntimeError(f"{name} {what}: ranks' outputs differ")

    max_abs = {k: 0.0 for k in TP_SOURCES}
    # (n, dtype, gemm shape (M, K, N)) cases: tiny f32 at n=2 and n=4,
    # the Qwen3-8B tp=2 bf16 shapes.
    # The serving paths' shapes: decode B=4 and 48-row chunks (one-shot);
    # TWO_SHOT's gemm_rs and all_gather at 128-, 384- and 640-row chunks;
    # the sequence-sharded prefill's ag_gemm and gemm_rs at 300 rows
    # (m_per 150: a partial last tile, the bidir split at 75 inside one).
    ar_cases = [(2, f32, 4, 128, 64), (4, f32, 4, 128, 64),
                (2, bf16, 4, 4096, 4096), (2, bf16, 4, 12288, 4096),
                (2, bf16, 48, 4096, 4096)]
    rs_cases = [(2, f32, 32, 128, 64), (4, f32, 64, 128, 64),
                (2, bf16, 384, 4096, 4096), (2, bf16, 384, 12288, 4096),
                (2, bf16, 300, 4096, 4096), (2, bf16, 300, 12288, 4096),
                (2, bf16, 128, 4096, 4096), (2, bf16, 640, 12288, 4096),
                (4, bf16, 128, 1024, 512)]
    ag_cases = [(2, f32, 32, 64, 256), (4, f32, 64, 64, 512),
                (2, bf16, 384, 4096, 6144), (2, bf16, 384, 4096, 24576),
                (2, bf16, 300, 4096, 6144), (2, bf16, 300, 4096, 24576)]
    gather_cases = [(2, f32, 16, 64), (4, f32, 16, 64), (2, bf16, 192, 4096),
                    (2, bf16, 150, 4096), (2, bf16, 64, 4096),
                    (2, bf16, 320, 4096), (4, bf16, 40, 4096)]
    for n, dt, m, k, nout in ar_cases:
        ctx, a, b = operands(n, dt, m, k, nout)
        got = gemm_ar_one_shot(a, b, ctx)
        same_on_every_rank("gemm_ar", got, f"n={n} {m}x{k}x{nout}")
        e = check("gemm_ar", got, gemm_ar_plain(a, b), dt, n,
                  f"n={n} {m}x{k}x{nout} {dt}")
        if dt == bf16:
            max_abs["gemm_ar"] = max(max_abs["gemm_ar"], e)
        print(f"[tp] gemm_ar one-shot n={n} M={m} K={k} N={nout} {dt}: "
              f"max |kernel - plain| {e:.3g}, ranks bitwise equal")
    for n, dt, m, k, nout in rs_cases:
        ctx, a, b = operands(n, dt, m, k, nout)
        for bidir in (False, True):
            half = ring_split(m // n, create_gemm_rs_context(
                m, k // n, dt, n_ranks=n, bidir=bidir))
            got = gemm_rs_ring(a, b, ctx, half)
            e = check("gemm_rs", got, gemm_rs_plain(a, b, half), dt, n,
                      f"n={n} {m}x{k}x{nout} half_m={half}")
            if dt == bf16:
                max_abs["gemm_rs"] = max(max_abs["gemm_rs"], e)
            print(f"[tp] gemm_rs n={n} M={m} K={k} N={nout} {dt} "
                  f"{'bidir' if half < m // n else 'single'} ring "
                  f"(half_m {half}): max |kernel - plain| {e:.3g}")
    for n, dt, m, k, nout in ag_cases:
        ctx, a, b = operands(n, dt, m, k, nout, rows=True)
        got, _ = ag_gemm_kernel(a, b, ctx)
        e = check("ag_gemm", got, ag_gemm_plain(a, b), dt, n,
                  f"n={n} {m}x{k}x{nout}")
        if dt == bf16:
            max_abs["ag_gemm"] = max(max_abs["ag_gemm"], e)
        print(f"[tp] ag_gemm n={n} M={m} K={k} n_loc={nout // n} {dt}: "
              f"max |kernel - plain| {e:.3g}")
    for n, dt, m_per, cols in gather_cases:
        ctx = initialize_distributed(n, device=dev, dtype=dt)
        xs = [rand((m_per, cols), dt) for _ in range(n)]
        got = all_gather_full_mesh(xs, ctx)
        same_on_every_rank("all_gather", got, f"n={n}")
        if not torch.equal(got[0], all_gather_plain(xs)[0]):
            raise RuntimeError(f"all_gather n={n}: differs from the shards")
        print(f"[tp] all_gather full mesh n={n} [{m_per}, {cols}] {dt}: "
              "every rank == the shards, bitwise")

    # Stress: back-to-back launches with fresh inputs, every output kept
    # and checked after one sync (a reused flag or epoch would let a rank
    # read another launch's slot).
    n = 4
    ctx, a, b = operands(n, f32, 32, 256, 128)
    ctx2, ar, br = operands(n, f32, 32, 64, 256, rows=True)
    kept = []
    for i in range(TP_STRESS):
        a = [t + 0.01 for t in a]
        ar = [t - 0.01 for t in ar]
        kept.append((a, ar, gemm_ar_one_shot(a, b, ctx),
                     gemm_rs_ring(a, b, ctx, 4),
                     ag_gemm_kernel(ar, br, ctx2)[0],
                     all_gather_full_mesh(ar, ctx2)))
    torch.cuda.synchronize()
    for a, ar, g_ar, g_rs, g_ag, g_all in kept:
        same_on_every_rank("gemm_ar", g_ar, "stress")
        check("gemm_ar", g_ar, gemm_ar_plain(a, b), f32, n, "stress")
        check("gemm_rs", g_rs, gemm_rs_plain(a, b, 4), f32, n, "stress")
        check("ag_gemm", g_ag, ag_gemm_plain(ar, br), f32, n, "stress")
        if not all(torch.equal(g, torch.cat(ar)) for g in g_all):
            raise RuntimeError("all_gather stress: a rank's output differs")
    print(f"[tp] stress: {TP_STRESS} back-to-back launches of each kernel "
          f"at n={n}, fresh inputs, all {4 * TP_STRESS} outputs correct")

    # Timing at the Qwen3-8B tp=2 serving shapes (bf16). Bound: all ranks'
    # bytes (each input read once, each rank's output written once) over
    # one HBM, or the FLOPs, whichever is larger. library_ms: one
    # torch.matmul of the unsharded operands (the same function on one
    # card), for the gather torch.cat of the shards.
    def bound(nbytes_, flops):
        tb, to = nbytes_ / HBM_BPS, flops / BF16_FLOPS
        return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")

    records = {}

    def record(name, shape, fn, plain, lib, nbytes_, flops, extra=None):
        bms, by = bound(nbytes_, flops)
        src, rep = TP_SOURCES[name]
        rec = dict(route="cuda", source=src, replaces=rep,
                   max_abs_err=max_abs[name], ms=median_ms(fn, flush),
                   plain_ms=median_ms(plain, flush), bound_ms=bms,
                   bound_by=by, library_ms=median_ms(lib, flush),
                   shape=shape, **(extra or {}))
        print(f"[tp] {name} {shape}: {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f}, library {rec['library_ms']:.4f}, "
              f"bound {bms:.4f} ms ({by})")
        return rec

    n, d, ff = TP, 4096, 12288
    timed = {}
    for tag, m, k in (("decode_oproj", 4, 4096), ("decode_fc2", 4, ff)):
        ctx, a, b = operands(n, bf16, m, k, d)
        A, B = torch.cat(a, 1), torch.cat(b, 0)
        timed[tag] = record(
            "gemm_ar", f"tp={n} M={m} k_loc={k // n} N={d} bf16 (decode "
            f"{'o-proj' if tag.endswith('oproj') else 'FC2'})",
            lambda: gemm_ar_one_shot(a, b, ctx),
            lambda: gemm_ar_plain(a, b), lambda: torch.matmul(A, B),
            2 * (m * k + k * d) + n * m * d * 2, 2 * m * k * d)
    records["gemm_ar"] = timed["decode_oproj"]
    records["gemm_ar"]["fc2"] = timed["decode_fc2"]
    m = 384
    for k in (4096, ff):
        ctx, a, b = operands(n, bf16, m, k, d)
        half = ring_split(m // n, create_gemm_rs_context(m, k // n, bf16,
                                                         n_ranks=n))
        A, B = torch.cat(a, 1), torch.cat(b, 0)
        rec = record(
            "gemm_rs", f"tp={n} M={m} k_loc={k // n} N={d} bf16 "
            f"(prefill {'o-proj' if k == 4096 else 'FC2'}, "
            f"{'bidir' if half < m // n else 'single'} ring)",
            lambda: gemm_rs_ring(a, b, ctx, half),
            lambda: gemm_rs_plain(a, b, half), lambda: torch.matmul(A, B),
            2 * (m * k + k * d) + m * d * 2, 2 * m * k * d)
        if k == 4096:
            records["gemm_rs"] = rec
        else:
            records["gemm_rs"]["fc2"] = rec
    for nl in (3072, 2 * ff // n):
        ctx, a, b = operands(n, bf16, m, d, nl * n, rows=True)
        A, B = torch.cat(a, 0), torch.cat(b, 1)
        rec = record(
            "ag_gemm", f"tp={n} M={m} K={d} n_loc={nl} bf16 (prefill "
            f"{'QKV' if nl == 3072 else 'FC1'})",
            lambda: ag_gemm_kernel(a, b, ctx),
            lambda: ag_gemm_plain(a, b), lambda: torch.matmul(A, B),
            2 * (m * d + d * nl * n) + n * m * nl * 2, 2 * m * d * nl * n)
        if nl == 3072:
            records["ag_gemm"] = rec
        else:
            records["ag_gemm"]["fc1"] = rec
    ctx = initialize_distributed(n, device=dev, dtype=bf16)
    xs = [rand((192, d), bf16) for _ in range(n)]
    shard = 192 * d * 2
    records["all_gather"] = record(
        "all_gather", f"tp={n} [192, {d}] a rank bf16 (gemm_ar TWO_SHOT's "
        "tail at a 384-row chunk)", lambda: all_gather_full_mesh(xs, ctx),
        lambda: all_gather_plain(xs), gather_copy(xs),
        n * shard + n * n * shard, 0)
    return records


def check_tp_options(dev, flush) -> tuple:
    """The options of the overlap kernels, each against its plain version
    and the base build, then each through its user entry point with the
    counts reset (TP_OPTION_PATH_KERNELS). The adaptive ag_gemm: bitwise
    the ring build at the Qwen3-8B tp=2 QKV and FC1 shapes; at n = 4 (the
    QKV at tp=4) with rank TP_LAG_RANK lagging (at least TP_LAG_NS and
    one whole launch) every other rank computes that chunk last, and the
    ring build's order, realized under the same lag (the control), fails
    the same check; TP_OPTION_STRESS launches of each build with fresh
    inputs at the tp=2 QKV shape and at n = 4 (m_per moving on one
    context, every fourth launch lagged), each checked. gemm_rs's e4m3
    wire at n = 2 and 4: integer-valued inputs bitwise the plain version,
    random ones within (n-1) e4m3 ulps of the row's largest hop sum plus
    the bf16 limit, planted first hops of 448, 460, 464, 465, -1000 give
    NaN where the plain version does,
    and the bf16-wire ring differs from it; the bf16 wire over f32 inputs
    within the f32 limit plus (n-1) bf16 ulps. The one-rank ring: bf16
    bitwise on integer-valued inputs, f32 within 1e-4 + 1e-5|p|. The
    traced gemm_ar at the decode o-proj and FC2: the ring bitwise the
    plain ring, decoded and valid, the outputs bitwise the untraced
    launch's. Returns (records by kernel, launches by path)."""
    import numpy as np
    import torch

    from triton_distributed_tpu_torch.models import get_config
    from triton_distributed_tpu_torch.obs import kernel_trace as kt
    from triton_distributed_tpu_torch.ops import cuda_kernels as ck
    from triton_distributed_tpu_torch.ops.overlap import (
        AGGemmConfig,
        GemmARConfig,
        GemmARMethod,
        GemmRSConfig,
        ag_gemm,
        ag_gemm_plain,
        gemm_ar_op,
        gemm_ar_plain,
        gemm_ar_ring_plain,
        gemm_rs_op,
        gemm_rs_plain,
    )
    from triton_distributed_tpu_torch.ops.overlap.ag_gemm import (
        ag_gemm_kernel,
    )
    from triton_distributed_tpu_torch.ops.overlap.gemm_ar import (
        gemm_ar_one_shot,
        gemm_ar_traced,
    )
    from triton_distributed_tpu_torch.ops.overlap.gemm_rs import (
        gemm_rs_ring,
    )
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 15)
    bf16, f32, e4m3 = torch.bfloat16, torch.float32, torch.float8_e4m3fn
    cfg = get_config(TP_MODEL)
    d, ff = cfg.hidden_size, cfg.intermediate_size
    qkv = (cfg.num_q_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    num_j = d // TP_TRACE_TILE

    def rand(shape, dtype, scale=1.0):
        return (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev) * scale).to(dtype)

    def ints(shape, lo, hi, dtype):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(
            np.float32)).to(dev, dtype)

    def operands(n, dtype, m, k, nout, rows=False, integer=False):
        ctx = initialize_distributed(n, device=dev, dtype=dtype)
        if integer:
            a, b = ints((m, k), -2, 3, dtype), ints((k, nout), -1, 2, dtype)
        else:
            a, b = rand((m, k), dtype), rand((k, nout), dtype, k**-0.5)
        if rows:
            return ctx, ctx.shard(a, 0), ctx.shard(b, 1)
        return ctx, ctx.shard(a, 1), ctx.shard(b, 0)

    def within(name, got, want, dtype, n, what, extra=None):
        """|got - want| <= the base limit (+ extra), NaN where want has
        NaN; returns the largest finite difference."""
        atol, rtol = _tp_limit(dtype, n)
        worst = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = g.float(), w.float()
            if not torch.equal(torch.isnan(g), torch.isnan(w)):
                raise RuntimeError(f"{name} {what}: NaN in other places "
                                   "than the plain version's")
            e = (g - w).abs().nan_to_num(0.0)
            lim = atol + rtol * w.abs().nan_to_num(0.0)
            if extra is not None:
                lim = lim + extra[i]
            if bool((e > lim).any()):
                raise RuntimeError(
                    f"{name} {what}: |kernel - plain| {float(e.max()):.3g} "
                    "over the limit")
            worst = max(worst, float(e.max()))
        return worst

    def hop_ulps(a, b, mantissa):
        """Per rank's chunk: (n-1) ulps, of a wire with ``mantissa`` bits,
        of each row's largest sum of |partial| (a bound on its hop sums):
        an f32 partial summed in another order may flip a hop's rounding
        once a hop."""
        n = len(a)
        mp = a[0].shape[0] // n
        out = []
        for c in range(n):
            parts = sum((a[r][c * mp:(c + 1) * mp].float()
                         @ b[r].float()).abs() for r in range(n))
            top = parts.amax(1, keepdim=True).clamp_min(2.0**-6)
            out.append((n - 1) * torch.exp2(torch.floor(torch.log2(top))
                                            - mantissa))
        return out

    def bits(name, got, want, what):
        if not _bits_equal(got, want):
            raise RuntimeError(f"{name} {what}: not bitwise its reference")

    max_abs = {k: 0.0 for k in ("ag_gemm_adaptive", "gemm_rs_wire_e4m3",
                                "gemm_rs_wire_bf16", "gemm_rs_n1",
                                "gemm_ar_traced")}
    checks = {}

    # -- the adaptive ag_gemm ------------------------------------------------
    def adaptive_vs_ring(a, b, ctx, what, **kw):
        """One launch of each build; the outputs bitwise equal, the adaptive
        order a permutation a rank that starts with the own chunk. Returns
        (outputs, adaptive order, the ring build's realized order)."""
        got, order = ag_gemm_kernel(a, b, ctx, adaptive=True, **kw)
        ring, ring_order = ag_gemm_kernel(a, b, ctx, **kw)
        bits("ag_gemm_adaptive", got, ring, f"{what} vs ring")
        n = len(a)
        for r, row in enumerate(order.tolist()):
            if row[0] != r or sorted(row) != list(range(n)):
                raise RuntimeError(f"ag_gemm_adaptive {what}: order "
                                   f"{order.tolist()}")
        return got, order.tolist(), ring_order.tolist()

    n = TP
    for nl in (qkv // n, 2 * ff // n):
        ctx, a, b = operands(n, bf16, 384, d, nl * n, rows=True)
        got, order, _ = adaptive_vs_ring(a, b, ctx, f"n={n} n_loc={nl}")
        e = within("ag_gemm_adaptive", got, ag_gemm_plain(a, b), bf16, n,
                   f"n={n} n_loc={nl}")
        max_abs["ag_gemm_adaptive"] = max(max_abs["ag_gemm_adaptive"], e)
        print(f"[tp_opt] ag_gemm adaptive n={n} M=384 K={d} n_loc={nl} "
              f"bf16: bitwise the ring build, max |kernel - plain| {e:.3g},"
              f" order {order}")
    # n = 4 at Qwen3-8B's QKV width at tp=4 (n_loc 1536). The lag is at
    # least TP_LAG_NS and at least one whole un-lagged launch, so the late
    # chunk has landed at none of the other ranks' step boundaries (on
    # the FMA tiles a step takes ~0.3 ms: a 500 us lag alone lands before
    # the third boundary and the pick then rightly takes it).
    n4, late = 4, TP_LAG_RANK
    ctx4, a4, b4 = operands(n4, bf16, 384, d, qkv, rows=True)
    ring_ms = median_ms(lambda: ag_gemm_kernel(a4, b4, ctx4), flush)
    lag_ns = max(TP_LAG_NS, int(ring_ms * 1e6))
    lag = dict(straggler_rank=late, straggler_nanos=lag_ns)

    def deferred(order):
        return all(row[-1] == late for r, row in enumerate(order)
                   if r != late)

    _, rows, ring_rows = adaptive_vs_ring(a4, b4, ctx4, "n=4 lag", **lag)
    if not deferred(rows):
        raise RuntimeError(f"ag_gemm_adaptive n=4, rank {late} lagging: "
                           f"order {rows} does not end in {late}")
    # The control: the ring build's order, realized under the same lag.
    if deferred(ring_rows) or ring_rows[1][1] != late:
        raise RuntimeError(f"ag_gemm ring order {ring_rows} under the lag: "
                           "the control passed the check")
    lag_ms = {"adaptive": median_ms(
        lambda: ag_gemm_kernel(a4, b4, ctx4, adaptive=True, **lag), flush),
        "ring": median_ms(lambda: ag_gemm_kernel(a4, b4, ctx4, **lag),
                          flush),
        "adaptive_no_lag": median_ms(
            lambda: ag_gemm_kernel(a4, b4, ctx4, adaptive=True), flush),
        "ring_no_lag": ring_ms}
    checks["ag_gemm_adaptive_lag"] = {"order": rows, "ring_order": ring_rows,
                                      "lag_ns": lag_ns, "ms": lag_ms}
    print(f"[tp_opt] ag_gemm adaptive n=4 M=384 K={d} n_loc={qkv // 4}, rank "
          f"{late} lagging {lag_ns} ns: order "
          f"{rows} (every other rank computes {late} last; the ring build's "
          f"realized order {ring_rows} fails that check on rank 1); ms "
          f"{lag_ms}")
    # Stress, TP_OPTION_STRESS launches of each build back to back, fresh
    # inputs, every output bitwise the ring build's and within the plain
    # limit: at the main path's bf16 QKV shape (n = 2, M 384, n_loc 3072),
    # then at n = 4 with the lag on a quarter of them and m_per moving
    # through 64, 96, 192 and 256 on one context (the site's flag layout
    # moves with m_per; its flags are never reset).
    ctx, a, b = operands(TP, bf16, 384, d, qkv, rows=True)
    kept = []
    for i in range(TP_OPTION_STRESS):
        a = [t - 2.0**-4 for t in a]
        kept.append((a, *ag_gemm_kernel(a, b, ctx, adaptive=True),
                     ag_gemm_kernel(a, b, ctx)[0]))
    torch.cuda.synchronize()
    for a, g, order, ring in kept:
        bits("ag_gemm_adaptive", g, ring, "stress n=2 vs ring")
        within("ag_gemm_adaptive", g, ag_gemm_plain(a, b), bf16, TP,
               "stress n=2")
        if order[:, 0].tolist() != list(range(TP)):
            raise RuntimeError(f"ag_gemm_adaptive stress order {order}")
    del kept
    big = [rand((256, d), bf16) for _ in range(n4)]
    kept = []
    for i in range(TP_OPTION_STRESS):
        mp = (64, 96, 192, 256)[i % 4]
        a = [t[:mp] - 2.0**-4 * i for t in big]
        kw = lag if i % 4 == 1 else {}
        kept.append((a, *ag_gemm_kernel(a, b4, ctx4, adaptive=True, **kw),
                     ag_gemm_kernel(a, b4, ctx4)[0]))
    torch.cuda.synchronize()
    for i, (a, g, order, ring) in enumerate(kept):
        bits("ag_gemm_adaptive", g, ring, f"stress n=4 launch {i} vs ring")
        if any(row[0] != r or sorted(row) != list(range(n4))
               for r, row in enumerate(order.tolist())):
            raise RuntimeError(f"ag_gemm_adaptive stress order {order}")
        if i % 4 == 1 and not deferred(order.tolist()):
            raise RuntimeError(f"ag_gemm_adaptive stress launch {i}: "
                               f"order {order.tolist()} under the lag")
        within("ag_gemm_adaptive", g, ag_gemm_plain(a, b4), bf16, n4,
               f"stress n=4 launch {i}")
    del kept, big, a4, b4
    print(f"[tp_opt] ag_gemm adaptive stress: {TP_OPTION_STRESS} launches "
          f"of each build at n={TP} M=384 n_loc={qkv // TP} and "
          f"{TP_OPTION_STRESS} at n=4 (m_per 64/96/192/256 on one context, "
          "every fourth lagged), fresh inputs, every output bitwise the "
          "ring build's, every order correct")

    # -- gemm_rs's wire dtypes -----------------------------------------------
    planted = (448.0, 460.0, 464.0, 465.0, -1000.0)
    for n in (2, 4):
        m, k, nout = 96 * n, 1024, 512
        ctx, a, b = operands(n, bf16, m, k, nout, integer=True)
        half = m // n // 2
        got = gemm_rs_ring(a, b, ctx, half, wire_dtype=e4m3)
        bits("gemm_rs_wire_e4m3", got, gemm_rs_plain(a, b, half, e4m3),
             f"n={n} integer inputs")
        ctx, a, b = operands(n, bf16, m, k, nout)
        got = gemm_rs_ring(a, b, ctx, half, wire_dtype=e4m3)
        want = gemm_rs_plain(a, b, half, e4m3)
        e = within("gemm_rs_wire_e4m3", got, want, bf16, n,
                   f"n={n} random", hop_ulps(a, b, 3))
        max_abs["gemm_rs_wire_e4m3"] = max(max_abs["gemm_rs_wire_e4m3"], e)
        base = gemm_rs_ring(a, b, ctx, half)
        if _bits_equal(base, got):
            raise RuntimeError("gemm_rs: the bf16 wire equals the e4m3 one")
        # Planted overflow: B = I, chunk c's ring opened by rank c+1.
        w = 64
        pa = torch.zeros((n * 40, n * w), device=dev)
        for c in range(n):
            r = (c + 1) % n
            for i in range(40):
                pa[c * 40 + i, r * w:(r + 1) * w] = planted[i % 5]
        pctx = initialize_distributed(n, device=dev, dtype=f32)
        pa_s = pctx.shard(pa, 1)
        pb_s = pctx.shard(torch.eye(w, device=dev).repeat(n, 1), 0)
        got = gemm_rs_ring(pa_s, pb_s, pctx, 40, wire_dtype=e4m3)
        want = gemm_rs_plain(pa_s, pb_s, 40, e4m3)
        bits("gemm_rs_wire_e4m3", got, want, f"n={n} planted overflow")
        nans = [int(torch.isnan(g[:5, 0]).sum()) for g in got]
        if nans != [2] * n:
            raise RuntimeError(f"gemm_rs e4m3 overflow: NaNs {nans}")
        print(f"[tp_opt] gemm_rs e4m3 wire n={n} M={m} K={k} N={nout} bf16: "
              "integer inputs bitwise, random max |kernel - plain| "
              f"{e:.3g} (within (n-1) e4m3 ulps + the bf16 limit), planted "
              "448/460/464/465/-1000 -> 448/448/448/NaN/NaN as the plain "
              "version, the bf16 wire differs")
        ctx, a, b = operands(n, f32, m, k, nout)
        got = gemm_rs_ring(a, b, ctx, half, wire_dtype=bf16)
        want = gemm_rs_plain(a, b, half, bf16)
        e = within("gemm_rs_wire_bf16", got, want, f32, n, f"n={n}",
                   hop_ulps(a, b, 7))
        max_abs["gemm_rs_wire_bf16"] = max(max_abs["gemm_rs_wire_bf16"], e)
        print(f"[tp_opt] gemm_rs bf16 wire n={n} f32 inputs: max |kernel - "
              f"plain| {e:.3g}")

    # -- the one-rank ring ---------------------------------------------------
    ctx1, a, b = operands(1, bf16, 384, d, d, integer=True)
    got = gemm_rs_ring(a, b, ctx1, 384)
    bits("gemm_rs_n1", got, gemm_rs_plain(a, b), "bf16 integer inputs")
    ctx1f, af, bfl = operands(1, f32, 384, d, d)
    e = within("gemm_rs_n1", gemm_rs_ring(af, bfl, ctx1f, 384),
               gemm_rs_plain(af, bfl), f32, 1, "f32")
    max_abs["gemm_rs_n1"] = e
    print(f"[tp_opt] gemm_rs one-rank ring [384, {d}] @ [{d}, {d}]: bf16 "
          f"bitwise on integer inputs, f32 max |kernel - plain| {e:.3g}")

    # -- the traced gemm_ar --------------------------------------------------
    n = TP
    trace_ops = {}
    for tag, k in (("o-proj", d), ("FC2", ff)):
        ctx, a, b = operands(n, bf16, 4, k, d)
        got, ring = gemm_ar_traced(a, b, ctx, TP_TRACE_TILE)
        base = gemm_ar_one_shot(a, b, ctx)
        bits("gemm_ar_traced", got, base, f"{tag} vs untraced")
        if not torch.equal(ring.cpu(), gemm_ar_ring_plain(n, num_j)):
            raise RuntimeError(f"gemm_ar_traced {tag}: ring differs from "
                               "the plain ring")
        recs = kt.decode_trace(ring.cpu().numpy(), strict=False)
        bad = kt.validate_ring(recs)
        if bad or len(recs) != n * (2 * num_j + 1):
            raise RuntimeError(f"gemm_ar_traced {tag}: ring {bad}")
        e = within("gemm_ar_traced", got, gemm_ar_plain(a, b), bf16, n, tag)
        max_abs["gemm_ar_traced"] = max(max_abs["gemm_ar_traced"], e)
        trace_ops[tag] = (ctx, a, b, k)
        print(f"[tp_opt] gemm_ar traced tp={n} M=4 k_loc={k // n} N={d} "
              f"tile_n {TP_TRACE_TILE}: ring bitwise the plain ring, "
              f"{len(recs)} records valid, outputs bitwise the untraced "
              f"launch's, max |kernel - plain| {e:.3g}")

    # -- the paths: each option through its entry point ----------------------
    launches = {}

    def drive(path, fn):
        ck.reset_launch_counts()
        got = fn()
        torch.cuda.synchronize()
        launches[path] = ck.launch_counts()
        missing = [k for k in TP_OPTION_PATH_KERNELS[path]
                   if not launches[path][k]]
        if missing:
            raise RuntimeError(f"{path} did not launch {missing}")
        return got

    ctx, a, b = operands(TP, bf16, 384, d, qkv, rows=True)
    got = drive("ag_gemm_ring", lambda: ag_gemm(
        a, b, ctx, AGGemmConfig(adaptive=False)))
    within("ag_gemm", got, ag_gemm_plain(a, b), bf16, TP, "ring path")
    A, B = rand((384, d), bf16), rand((d, d), bf16, d**-0.5)
    Af, Bf = rand((384, d), f32), rand((d, d), f32, d**-0.5)
    ctx2 = initialize_distributed(TP, device=dev, dtype=bf16)
    ctx2f = initialize_distributed(TP, device=dev, dtype=f32)
    got = drive("gemm_rs_op_wire", lambda: (
        gemm_rs_op(A, B, ctx2, GemmRSConfig(wire_dtype=e4m3)),
        gemm_rs_op(Af, Bf, ctx2f, GemmRSConfig(wire_dtype=bf16))))
    for g, x, y, dt in ((got[0], A, B, bf16), (got[1], Af, Bf, f32)):
        ref = (x.float() @ y.float())
        if not bool(torch.isfinite(g).all()) or float(
                (g.float() - ref).abs().max()) > 0.25:
            raise RuntimeError(f"gemm_rs_op wire ({dt}): far from A @ B")
    got = drive("gemm_rs_op_n1", lambda: gemm_rs_op(
        A, B, initialize_distributed(1, device=dev, dtype=bf16),
        GemmRSConfig(force_kernel=True)))
    within("gemm_rs_n1", [got], [(A.float() @ B.float()).to(bf16)], bf16, 1,
           "n1 path")
    Ad, Bd = rand((4, d), bf16), rand((d, d), bf16, d**-0.5)
    out, ring = drive("gemm_ar_op_traced", lambda: gemm_ar_op(
        Ad, Bd, ctx2, GemmARMethod.ONE_SHOT,
        GemmARConfig(tile_n=TP_TRACE_TILE), trace=True))
    if not torch.equal(ring.cpu(), gemm_ar_ring_plain(TP, num_j)):
        raise RuntimeError("gemm_ar_op trace path: ring differs")
    within("gemm_ar_traced", [out], [gemm_ar_plain(
        ctx2.shard(Ad, 1), ctx2.shard(Bd, 0))[0]], bf16, TP, "traced path")
    print(f"[tp_opt] option paths {list(TP_OPTION_PATH_KERNELS)}: each "
          "launched its kernel through the entry point")

    # -- timing (bound: ag_gemm and gemm_rs by operations, gemm_ar by bytes,
    # both ranks' weights) ---------------------------------------------------
    def bound(nbytes_, flops, peak=BF16_FLOPS):
        tb, to = nbytes_ / HBM_BPS, flops / peak
        return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")

    records = {}

    def record(name, shape, fn, plain, lib, nbytes_, flops, peak=BF16_FLOPS,
               extra=None):
        bms, by = bound(nbytes_, flops, peak)
        src, rep = TP_SOURCES[name]
        rec = dict(route="cuda", source=src, replaces=rep,
                   max_abs_err=max_abs[name], ms=median_ms(fn, flush),
                   plain_ms=median_ms(plain, flush), bound_ms=bms,
                   bound_by=by, library_ms=median_ms(lib, flush),
                   shape=shape, **(extra or {}))
        print(f"[tp_opt] {name} {shape}: {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f}, library {rec['library_ms']:.4f}, "
              f"bound {bms:.4f} ms ({by})")
        return rec

    n, m = TP, 384
    for nl in (qkv // n, 2 * ff // n):
        ctx, a, b = operands(n, bf16, m, d, nl * n, rows=True)
        A, B = torch.cat(a, 0), torch.cat(b, 1)
        rec = record(
            "ag_gemm_adaptive", f"tp={n} M={m} K={d} n_loc={nl} bf16 "
            f"(prefill {'QKV' if nl == qkv // n else 'FC1'})",
            lambda: ag_gemm_kernel(a, b, ctx, adaptive=True),
            lambda: ag_gemm_plain(a, b), lambda: torch.matmul(A, B),
            2 * (m * d + d * nl * n) + n * m * nl * 2, 2 * m * d * nl * n,
            extra={"ring_ms": median_ms(lambda: ag_gemm_kernel(a, b, ctx),
                                        flush)})
        if nl == qkv // n:
            records["ag_gemm_adaptive"] = rec
            rec["lag_n4"] = checks["ag_gemm_adaptive_lag"]
        else:
            records["ag_gemm_adaptive"]["fc1"] = rec
    k = d
    ctx, a, b = operands(n, bf16, m, k, d)
    half = m // n // 2
    A, B = torch.cat(a, 1), torch.cat(b, 0)
    records["gemm_rs_wire_e4m3"] = record(
        "gemm_rs_wire_e4m3", f"tp={n} M={m} k_loc={k // n} N={d} bf16, "
        "e4m3 wire (prefill o-proj, bidir ring)",
        lambda: gemm_rs_ring(a, b, ctx, half, wire_dtype=e4m3),
        lambda: gemm_rs_plain(a, b, half, e4m3), lambda: torch.matmul(A, B),
        2 * (m * k + k * d) + m * d * 2, 2 * m * k * d,
        extra={"bf16_wire_ms": median_ms(
            lambda: gemm_rs_ring(a, b, ctx, half), flush)})
    ctx, a, b = operands(n, f32, m, k, d)
    A, B = torch.cat(a, 1), torch.cat(b, 0)
    records["gemm_rs_wire_bf16"] = record(
        "gemm_rs_wire_bf16", f"tp={n} M={m} k_loc={k // n} N={d} f32, "
        "bf16 wire (TF32 off)",
        lambda: gemm_rs_ring(a, b, ctx, half, wire_dtype=bf16),
        lambda: gemm_rs_plain(a, b, half, bf16), lambda: torch.matmul(A, B),
        4 * (m * k + k * d) + m * d * 4, 2 * m * k * d, peak=F32_FLOPS,
        extra={"f32_wire_ms": median_ms(
            lambda: gemm_rs_ring(a, b, ctx, half), flush)})
    ctx1, a, b = operands(1, bf16, m, d, d)
    records["gemm_rs_n1"] = record(
        "gemm_rs_n1", f"tp=1 [{m}, {d}] @ [{d}, {d}] bf16 (force_kernel)",
        lambda: gemm_rs_ring(a, b, ctx1, m), lambda: gemm_rs_plain(a, b),
        lambda: torch.matmul(a[0], b[0]), 2 * (m * d + d * d) + m * d * 2,
        2 * m * d * d)
    for tag, (ctx, a, b, k) in trace_ops.items():
        A, B = torch.cat(a, 1), torch.cat(b, 0)
        rec = record(
            "gemm_ar_traced", f"tp={n} M=4 k_loc={k // n} N={d} bf16, "
            f"tile_n {TP_TRACE_TILE} (decode {tag})",
            lambda: gemm_ar_traced(a, b, ctx, TP_TRACE_TILE),
            lambda: (gemm_ar_plain(a, b), gemm_ar_ring_plain(n, num_j)),
            lambda: torch.matmul(A, B),
            2 * (4 * k + k * d) + n * 4 * d * 2, 2 * 4 * k * d,
            extra={"untraced_ms": median_ms(
                lambda: gemm_ar_one_shot(a, b, ctx), flush)})
        if tag == "o-proj":
            records["gemm_ar_traced"] = rec
        else:
            records["gemm_ar_traced"]["fc2"] = rec
    records["ag_gemm_adaptive"]["checks"] = checks
    print(f"[time] tp options: {time.perf_counter() - t0:.1f} s", flush=True)
    return records, launches


def _tp_plain_model(model, params):
    """A stand-in of ``model`` at tp=1 for the plain forward: the tp=1
    geometry over the unsharded ``params``."""
    import types

    from triton_distributed_tpu_torch.layers.tp_attn import TPAttnDims

    cfg = model.cfg
    return types.SimpleNamespace(
        cfg=cfg, device=model.device, params=params,
        dims=TPAttnDims(hq_loc=cfg.num_q_heads, hkv_loc=cfg.num_kv_heads,
                        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta))


def check_tp_tiny(dev) -> None:
    """Tiny f32 at tp=2 and tp=4 in mode='pallas' on the card emits the
    CPU's tokens (the plain versions there), through both engines."""
    import numpy as np

    from triton_distributed_tpu_torch.models import (
        AutoLLM,
        ContinuousEngine,
        Engine,
    )
    from triton_distributed_tpu_torch.models.qwen import Qwen3

    src = AutoLLM.from_pretrained("tiny", device="cpu", seed=SEED)
    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(0, 256, k).astype(np.int32) for k in (20, 41, 9)]
    ids = np.stack([prompts[0], prompts[1][:20]])
    for tp in (2, 4):
        outs = []
        for d in (dev, "cpu"):
            m = Qwen3(src.cfg, device=d, tp=tp)
            m.set_params(src.params)
            res = []
            for pc in (False, True):
                eng = ContinuousEngine(m, max_batch=2, page_size=16,
                                       max_length=64, prefix_cache=pc,
                                       mode="pallas", device=d)
                res.append(np.concatenate(eng.run([(p, 8) for p in prompts])))
                if eng.audit():
                    raise RuntimeError(f"tiny tp={tp} on {d}: audit "
                                       f"{eng.audit()}")
            res.append(Engine(m, mode="pallas", paged=True, page_size=16,
                              device=d).serve(ids, 7, 64))
            outs.append(res)
        if not all(np.array_equal(x, y) for x, y in zip(*outs)):
            raise RuntimeError(f"tiny f32 tp={tp} serving on the card "
                               "differs from the CPU")
        print(f"[tp] tiny f32 tp={tp} mode='pallas' ContinuousEngine (with "
              "and without the prefix cache) + Engine tokens on the card "
              "== CPU")


def profile_tp_steps(model, steps: int = 8, modes=("pallas", "xla"),
                     tag: str = "tp") -> dict:
    """Where a tp step's time goes: a B=4 decode step at kv_len ~340 and
    a 384-row chunk at offset 0 over a paged pool, in mode ``pallas``
    (the kernels), ``xla`` (plain torch collectives) and ``mega`` (the
    decode step as one megakernel launch over every rank, the engines'
    serving config; its prefill is the xla chunk): host wall a step
    (synchronized) and, under ``torch.profiler``, the device's busy time,
    idle share and launches a step."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from triton_distributed_tpu_torch.models.paged_kv_cache import (
        init_paged_cache,
    )

    b, page = 4, PAGE
    cache, _ = init_paged_cache(model.cfg, b, model.device,
                                max_length=TP_MAX_LENGTH, page_size=page,
                                tp=model.tp)
    cache.kv_len[:] = 340
    tok = torch.arange(b, dtype=torch.int32, device=model.device)
    chunk = np.arange(384, dtype=np.int32) % model.cfg.vocab_size
    out = {}
    for mode in modes:
        if mode == "mega":
            from triton_distributed_tpu_torch.megakernel import (
                MegaConfig,
                MegaQwen3,
            )

            mega = MegaQwen3(model, cfg=MegaConfig(
                fuse_norms=True, cross_prefetch=True, overlap_ar=True))
            phases = {"decode": lambda: mega.decode_step(tok, cache)}
        else:
            phases = {
                "decode": lambda: model.decode_step(tok, cache, mode),
                "chunk384": lambda: model.prefill_paged_chunk(
                    chunk, 0, 0, 384, 383, cache, mode),
            }
        for name, step in phases.items():
            for _ in range(2):
                step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    step()
                torch.cuda.synchronize()
            kern = [e for e in prof.key_averages()
                    if e.device_type.name == "CUDA"
                    and e.device_time_total > 0]
            busy = sum(e.device_time_total for e in kern) / steps / 1e3
            top = sorted(kern, key=lambda e: -e.device_time_total)[:5]
            rec = {"wall_ms": wall, "device_busy_ms": busy,
                   "device_idle_share": max(0.0, 1.0 - busy / wall),
                   "launches": sum(e.count for e in kern) / steps,
                   "top": [[e.key[:60], e.device_time_total / steps / 1e3]
                           for e in top]}
            out[f"{name}_{mode}"] = rec
            print(f"[{tag}] step profile {name} mode={mode}: {wall:.2f} ms wall, "
                  f"device busy {busy:.2f} ms (idle "
                  f"{rec['device_idle_share']:.3f}), "
                  f"{rec['launches']:.0f} launches; top "
                  + ", ".join(f"{k} {v:.3f}" for k, v in rec["top"][:3]))
    return out


def tp_prompts(vocab: int) -> tuple:
    """The TP paths' prompts (TP_PROMPT_LENS random tokens) and the dense
    Engine rows."""
    import numpy as np

    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(0, vocab, k).astype(np.int32)
               for k in TP_PROMPT_LENS]
    ids = np.stack([p[:TP_PROMPT_LENS[0]] for p in prompts[:2]])
    return rng, prompts, ids


def serve_tp_paths(dev, model, plain) -> tuple:
    """Qwen3-8B at tp=2, all layers: the three pallas paths, launches per
    path, audits, and teacher forcing of every request against ``plain``,
    a full-sequence forward over the unsharded weights (bf16 limits).
    Returns (launches by path, the e2e block, the paths' tokens)."""
    import numpy as np
    import torch

    from triton_distributed_tpu_torch.models import (
        ContinuousEngine,
        Engine,
    )
    from triton_distributed_tpu_torch.ops import cuda_kernels as ck

    rng, prompts, ids = tp_prompts(model.cfg.vocab_size)
    vocab = model.cfg.vocab_size
    launches, outs, e2e = {}, {}, {}
    runs = {
        "continuous_tp": lambda: ContinuousEngine(
            model, max_batch=4, page_size=PAGE, max_length=TP_MAX_LENGTH,
            prefix_cache=True, mode="pallas", device=dev),
        "continuous_tp_chunk128": lambda: ContinuousEngine(
            model, max_batch=4, page_size=PAGE, max_length=TP_MAX_LENGTH,
            prefix_cache=True, prefill_chunk=TP_CHUNK, mode="pallas",
            device=dev),
        "paged_engine_tp": lambda: Engine(model, mode="pallas", paged=True,
                                          page_size=PAGE, device=dev),
    }
    warm = rng.integers(0, vocab, TP_PROMPT_LENS[0]).astype(np.int32)
    timers = {name: _Timed(model, name) for name in (
        "decode_step", "prefill_paged_chunk", "prefill_batched")}
    for path, make in runs.items():
        eng = make()
        if path == "paged_engine_tp":  # warm-up serve, then the counted one
            eng.serve(ids, 2, TP_MAX_LENGTH)
        else:
            eng.run([(warm, 2)])
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        before = {k: t.snapshot() for k, t in timers.items()}
        t0 = time.perf_counter()
        if path == "paged_engine_tp":
            got = eng.serve(np.stack(prompts[1::2]), TP_GEN, TP_MAX_LENGTH)
            outs[path] = [g[len(p):] for g, p in zip(got, prompts[1::2])]
        else:
            outs[path] = eng.run([(p, TP_GEN) for p in prompts])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[path] = ck.launch_counts()
        if eng.audit():
            raise RuntimeError(f"{path}: pool audit failed: {eng.audit()}")
        need = TP_PATH_KERNELS[path]
        counts = {k: launches[path][k] for k in need}
        print(f"[tp] {path}: {wall:.2f} s wall, launches {counts}")
        missing = [k for k in need if not launches[path][k]]
        if missing:
            raise RuntimeError(f"{path} did not launch {missing}")
        spent = {k: (t.snapshot()[0] - before[k][0],
                     t.snapshot()[1] - before[k][1])
                 for k, t in timers.items()}
        dec_s, dec_n = spent["decode_step"]
        pre_s = spent["prefill_paged_chunk"][0] + spent["prefill_batched"][0]
        e2e[path] = {"wall_s": wall, "launches": counts,
                     "decode_steps": dec_n,
                     "decode_ms_per_step": dec_s / max(dec_n, 1) * 1e3,
                     "prefill_s": pre_s,
                     "prefill_calls": spent["prefill_paged_chunk"][1]
                     + spent["prefill_batched"][1]}
        print(f"[tp] {path}: decode {e2e[path]['decode_ms_per_step']:.2f} "
              f"ms a step (host wall, {dec_n} steps), prefill "
              f"{pre_s:.3f} s in {e2e[path]['prefill_calls']} calls")
    # 3 profiled steps a phase: the profile is a measurement, and the
    # script's 1200 s bound leaves little for a host that runs slow
    # (perf/torch_step_profile.py profiles the 384-row chunk at length).
    e2e["step_profile"] = profile_tp_steps(model, steps=3,
                                           modes=("pallas", "xla", "mega"))
    # Every prefill chunk and decode step of the continuous paths went
    # through a kernel: TWO_SHOT's gemm_rs and all_gather once a layer
    # each for every chunk over 512 KB (the 640-row one included), the
    # one-shot gemm_ar for the rest and for every decode step.
    per = 2 * model.cfg.num_layers
    for path, chunk in (("continuous_tp", 0),
                        ("continuous_tp_chunk128", TP_CHUNK)):
        two = _two_shot_chunks(TP_PROMPT_LENS, chunk, model.cfg.hidden_size,
                               model.cfg.dtype.itemsize)
        one = e2e[path]["prefill_calls"] - two + e2e[path]["decode_steps"]
        got = launches[path]
        if not (got["gemm_rs"] == got["all_gather"] == per * two
                and got["gemm_ar"] == per * one):
            raise RuntimeError(
                f"{path}: launches gemm_ar {got['gemm_ar']}, gemm_rs "
                f"{got['gemm_rs']}, all_gather {got['all_gather']}; "
                f"expected {per * one}, {per * two}, {per * two}")
        print(f"[tp] {path}: {two} TWO_SHOT chunks (gemm_rs + all_gather) "
              f"and {one} one-shot chunks and decode steps, {per} launches "
              "each: no chunk took the plain version")
    steps = TP_GEN - 1
    want = per * steps
    if launches["paged_engine_tp"]["gemm_ar"] != want:
        raise RuntimeError(
            f"paged_engine_tp: {launches['paged_engine_tp']['gemm_ar']} "
            f"gemm_ar launches, {want} expected (2 a layer a decode step)")
    print(f"[tp] paged_engine_tp: {want // steps} one-shot gemm_ar launches "
          "a decode step")
    # Teacher forcing through a plain forward over the unsharded weights.
    for path, got in outs.items():
        gaps = []
        src = prompts[1::2] if path == "paged_engine_tp" else prompts
        for p, o in zip(src, got):
            gaps += teacher_forced_gaps(plain, p, np.asarray(o))
        e2e[path]["teacher_forcing"] = _tf_check(
            f"{path} (tp={TP})", gaps, TF_MARGIN, TF_MIN_EXACT)
    return launches, e2e, outs


def check_tp(dev):
    """Phase 5: tensor parallelism over co-located ranks. The kernel
    checks, the tiny card == CPU serving, then Qwen3-8B at tp=2: the
    pallas paths, then the megakernel at tp=2 on the same model (its
    kernel checks and paths). Returns (records by kernel, launches by
    path, the e2e block)."""
    import gc

    import torch

    # The MoE phase's model (61 GB) lives on in its engines' reference
    # cycles until a collection.
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[tp] {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated "
          "at the start of the phase")
    from triton_distributed_tpu_torch.models import AutoLLM, unshard_params

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    records = check_tp_kernels(dev, flush)
    more, option_launches = check_tp_options(dev, flush)
    records.update(more)
    check_tp_tiny(dev)
    t0 = time.perf_counter()
    model = AutoLLM.from_pretrained(TP_MODEL, device=dev, seed=SEED, tp=TP)
    torch.cuda.synchronize()
    print(f"[tp] {TP_MODEL} random init at tp={TP} on {dev} in "
          f"{time.perf_counter() - t0:.1f} s ({model.cfg.num_layers} layers, "
          f"hq_loc {model.dims.hq_loc}, hkv_loc {model.dims.hkv_loc}; "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated)")
    plain = _tp_plain_model(model, unshard_params(model.params))
    launches, e2e, outs = serve_tp_paths(dev, model, plain)
    launches.update(option_launches)
    # The megakernel at tp=2 on the same model.
    t0 = time.perf_counter()
    records["mega_decode_tp"] = check_tp_mega_kernels(dev, flush, model)
    more, e2e["mega"] = serve_tp_mega_paths(dev, model, plain, outs)
    launches.update(more)
    e2e["mega"]["seconds"] = time.perf_counter() - t0
    print(f"[tp_mega] the tp megakernel's checks and paths: "
          f"{e2e['mega']['seconds']:.1f} s", flush=True)
    # The prefill megakernel at tp=2 on the same model.
    t0 = time.perf_counter()
    records["mega_prefill_tp"], more, e2e["mega_prefill_tp"] = (
        check_mega_prefill_tp(dev, flush, model, plain))
    launches.update(more)
    del flush
    print(f"[time] tp prefill megakernel: {time.perf_counter() - t0:.1f} s",
          flush=True)
    del plain, model
    torch.cuda.empty_cache()
    return records, launches, e2e


# The megakernel at tp > 1 (queue 2 row 6(e), dense): mode="mega" over the
# two co-located ranks of the TP phase's Qwen3-8B in ONE cooperative launch
# (csrc/megakernel.cu, tdt_mega_decode_tp: the entry BARRIER, each
# projection's f32 partial exchanged and folded in rank order by ALLREDUCE
# or AR_SEND/AR_WAIT, the LM head's cross-rank argmax). Kernel vs plain
# (kernels.mega_decode_plain_tp, the ranks walked in lockstep) at B=4 over
# the paged bf16 pool, kv_len TP_MEGA_LENS, NS 1 and 8, overlap_ar on and
# off, under the megakernel's limits (MEGA_TOL; a token may leave the plain
# stream only at a near tie), every rank's tokens and final residual
# bitwise equal; the negative control drops rank 1's partial at layer 18's
# exchanges on the plain side and must break the bf16 limit at NS 1 and,
# at NS=8, TP_MEGA_CONTROL times over; a 500 us lag on rank 1 must leave the outputs bit-identical
# and the launch >= 0.5 ms longer; TP_MEGA_STRESS launches back to back on
# fresh tokens, each checked; f32 at 2 layers: tokens equal, logits within
# 2e-3. Then the serving paths (TP_MEGA_PATH_KERNELS), each held by
# teacher forcing, audit and exact megakernel launch counts.
TP_MEGA_LENS = (300, 700, 300, 700)
TP_MEGA_NS = (1, 8)
TP_MEGA_STRESS = 20
TP_MEGA_LAG_NS = 500_000
TP_MEGA_DROP = (18, 1)  # (layer, rank) of the negative control
TP_MEGA_CONTROL = 10.0
TP_MEGA_EOS_AT = 20     # the eos id: continuous_tp's request 0, this token
TP_MEGA_NSTEP = 8
TP_MEGA_PATH_KERNELS = {
    "continuous_tp_mega": ("flash_attention", "mega_decode_tp"),
    "paged_engine_tp_mega": ("flash_attention", "mega_decode_tp"),
    "continuous_tp_mega_resident": ("flash_attention", "mega_decode_tp"),
}
TP_MEGA_SPLIT_OPS = ("BARRIER", "EMBED", "QKV_PROJ", "ATTN", "O_PROJ",
                     "AR_SEND", "AR_WAIT", "ALLREDUCE", "FC1", "FC2",
                     "LM_HEAD")


def _tp_mega_operands(model, lens, seed, max_length=TP_MAX_LENGTH):
    """A random per-rank paged pool of ``max_length`` positions a row in
    the model dtype (each row's pages from the pool's table) and B tokens:
    ``(kc list, vc list, page_table, kv_len, tokens)``."""
    import numpy as np
    import torch

    from triton_distributed_tpu_torch.models.paged_kv_cache import (
        init_paged_cache,
    )

    dev, b = model.device, len(lens)
    pool, _ = init_paged_cache(model.cfg, b, dev, max_length=max_length,
                               page_size=PAGE, tp=model.tp)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for t in (pool.k_pages, pool.v_pages):
        t.normal_(generator=gen)
    ranks = [pool.rank(r) for r in range(model.tp)]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, model.cfg.vocab_size, b).astype(np.int32)).to(dev)
    return ([c.k_pages for c in ranks], [c.v_pages for c in ranks],
            pool.page_table, kv_len, tokens)


def _tp_mega_bound(model, lens) -> dict:
    """The least time of one tp decode step: both ranks' weight shards,
    norms and LM-head columns, the embed rows, every cached K/V row (each
    rank its kv heads), the logits and the new K/V rows, over the one
    card's HBM (its FLOPs are ~200x below)."""
    from triton_distributed_tpu_torch.models.qwen import pad_vocab

    cfg = model.cfg
    b, L, hd = len(lens), cfg.num_layers, cfg.head_dim
    item = cfg.dtype.itemsize
    weights = 0
    for p in model.rank_params:
        lp = p["layers"]
        weights += sum(t.numel() * t.element_size() for t in (
            lp["attn"]["wqkv"], lp["attn"]["wo"], lp["mlp"]["w1"],
            lp["mlp"]["w2"], lp["ln1"], lp["ln2"], lp["attn"]["q_norm"],
            lp["attn"]["k_norm"], p["norm"], p["lm_head"]))
    kv = 2 * L * sum(lens) * cfg.num_kv_heads * hd * item
    rest = (b * cfg.hidden_size * item + b * 4 * pad_vocab(cfg.vocab_size,
                                                           model.tp)
            + 2 * L * b * cfg.num_kv_heads * hd * item)
    total = weights + kv + rest
    return {"bound_ms": total / HBM_BPS * 1e3, "bound_by": "bytes",
            "bound_bytes": total, "weight_bytes": weights, "kv_bytes": kv}


def _tp_mega_limit_use(got, ref, plain_at, tag, what) -> tuple:
    """Kernel vs plain outputs of one launch: tokens (bf16: near ties
    only), the last step's logits on the rows whose earlier tokens agree;
    returns (share of the limit, max |err|, near ties)."""
    import torch

    atol, rtol = MEGA_TOL[tag]
    if tag == "f32":
        if not torch.equal(got[3], ref[3]):
            raise RuntimeError(f"{what}: f32 tokens differ from plain")
        ties = []
    else:
        ties = _mega_tokens_ok(got[3], ref[3], plain_at)
    keep = (got[3][:-1] == ref[3][:-1]).all(dim=0)
    err = (got[0] - ref[0]).abs()[keep]
    used = (err / (atol + rtol * ref[0].abs()[keep])).max().item()
    if not used <= 1.0:
        raise RuntimeError(f"{what}: logits at {used:.3f} of the limit")
    return used, err.max().item(), ties


def _ranks_equal(info, what) -> None:
    import torch

    for r in range(1, TP):
        for k in ("toks", "x"):
            if not torch.equal(info[k][r], info[k][0]):
                raise RuntimeError(f"{what}: rank {r}'s {k} differs from "
                                   "rank 0's")


def check_tp_mega_kernels(dev, flush, model) -> dict:
    """The tp=2 megakernel against its plain version on ``model`` (see the
    constants above), timed; returns the record of ``mega_decode_tp``."""
    import dataclasses

    import numpy as np
    import torch

    from triton_distributed_tpu_torch.megakernel import (
        MegaConfig,
        MegaQwen3,
    )
    from triton_distributed_tpu_torch.megakernel.kernels import (
        mega_decode_plain_tp,
    )
    from triton_distributed_tpu_torch.megakernel.qwen3 import _weights
    from triton_distributed_tpu_torch.megakernel.task import TaskType
    from triton_distributed_tpu_torch.models import AutoLLM
    from triton_distributed_tpu_torch.obs import kernel_trace as kt
    from triton_distributed_tpu_torch.ops import cuda_kernels as ck

    b, V = len(TP_MEGA_LENS), model.cfg.vocab_size
    args = _tp_mega_operands(model, TP_MEGA_LENS, SEED + 5)
    w = _weights(model.params)
    rec = {"limit_used": {}, "near_ties": [], "ms_per_launch": {},
           "plain_ms_per_launch": {}, "split_ms_per_step": {}}
    max_err, info = 0.0, {}
    comps, megas = {}, {}
    for overlap in (True, False):
        mega = megas[overlap] = MegaQwen3(model, cfg=MegaConfig(
            fuse_norms=True, cross_prefetch=overlap, overlap_ar=overlap))
        for ns in TP_MEGA_NS:
            dims = dataclasses.replace(
                mega._dims(b, TP_MAX_LENGTH, PAGE,
                           num_pages=int(args[0][0].shape[1])),
                nsteps=ns, v_real=V)
            comp = comps[overlap, ns] = mega._compile(dims)
            info = {}
            got = comp.run(w, *args, info=info)
            again = comp.run(w, *args)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise RuntimeError(f"mega_decode_tp NS={ns}: two launches "
                                   "on the same inputs differ")
            _ranks_equal(info, f"mega_decode_tp NS={ns} overlap={overlap}")
            ref = mega_decode_plain_tp(dims, True, comp.table, w, *args)

            def plain_at(s, dims=dims, table=comp.table):
                return mega_decode_plain_tp(dataclasses.replace(
                    dims, nsteps=s + 1), True, table, w, *args)[0]

            what = f"mega_decode_tp bf16 NS={ns} overlap_ar={overlap}"
            used, err, ties = _tp_mega_limit_use(got, ref, plain_at, "bf16",
                                                 what)
            max_err = max(max_err, err)
            rec["limit_used"][f"bf16_ns{ns}_overlap{int(overlap)}"] = used
            rec["near_ties"] += [dict(ns=ns, overlap=overlap, **t)
                                 for t in ties]
            info = {k: info[k] for k in ("blocks", "smem_bytes",
                                         "blocks_per_sm") if k in info}
            ms = median_ms(lambda: comp.run(w, *args), flush)
            rec["ms_per_launch"][f"ns{ns}_overlap{int(overlap)}"] = ms
            if overlap:
                rec["plain_ms_per_launch"][f"ns{ns}"] = median_ms(
                    lambda: mega_decode_plain_tp(dims, True, comp.table, w,
                                                 *args),
                    flush, iters=3, warmup=1)
            print(f"[tp_mega] {what}: tokens == plain"
                  f"{f' up to near ties {ties}' if ties else ''}, ranks "
                  f"bitwise equal, logits max_abs_err {err:.3e}, "
                  f"{used:.3f} of the limit; {ms:.4f} ms per launch "
                  f"({ms / ns:.4f} a step); launch {info}")
    # The negative control: rank 1's partial dropped at layer 18's
    # exchanges, at NS 1 and 8. Each must leave the limit; the serving
    # launch (NS=8: the dropped partial reaches every step's token) by
    # TP_MEGA_CONTROL times.
    atol, rtol = MEGA_TOL["bf16"]
    control = {}
    for ns in TP_MEGA_NS:
        comp = comps[True, ns]
        got = comp.run(w, *args)
        bad = mega_decode_plain_tp(comp.builder.dims, True, comp.table, w,
                                   *args, drop_partial=TP_MEGA_DROP)[0]
        control[ns] = ((got[0] - bad).abs()
                       / (atol + rtol * bad.abs())).max().item()
    print(f"[tp_mega] control (rank {TP_MEGA_DROP[1]}'s partial dropped at "
          f"layer {TP_MEGA_DROP[0]}): "
          + ", ".join(f"NS={k} {v:.1f}x" for k, v in control.items())
          + f" the limit (each > 1, NS=8 >= {TP_MEGA_CONTROL})")
    if (min(control.values()) <= 1.0
            or control[TP_MEGA_NS[-1]] < TP_MEGA_CONTROL):
        raise RuntimeError(f"tp megakernel control at {control}x the limit")
    comp = comps[True, 1]
    dims = comp.builder.dims
    got = comp.run(w, *args)
    # The straggler: bit-identical, the launch >= 0.5 ms longer.
    lag = megas[True]._compile(dataclasses.replace(
        dims, straggler_rank=1, straggler_nanos=TP_MEGA_LAG_NS))
    slow = lag.run(w, *args)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, slow)):
        raise RuntimeError("the lagged launch's outputs differ")
    base_ms = median_ms(lambda: comp.run(w, *args), flush, iters=5)
    lag_ms = median_ms(lambda: lag.run(w, *args), flush, iters=5)
    print(f"[tp_mega] straggler (rank 1 lags {TP_MEGA_LAG_NS} ns): outputs "
          f"bit-identical, {lag_ms:.4f} ms against {base_ms:.4f}")
    if lag_ms < base_ms + TP_MEGA_LAG_NS / 1e6:
        raise RuntimeError("the straggler did not lengthen the launch")
    # Back to back on fresh tokens, every launch checked.
    rng = np.random.default_rng(SEED + 6)
    runs = []
    for _ in range(TP_MEGA_STRESS):
        tok = torch.from_numpy(rng.integers(0, V, b).astype(np.int32)).to(
            dev)
        i = {}
        runs.append((tok, comp.run(w, *args[:4], tok, info=i), i))
    torch.cuda.synchronize()
    for tok, out, i in runs:
        _ranks_equal(i, "stress")
        ref = mega_decode_plain_tp(dims, True, comp.table, w, *args[:4], tok)
        _tp_mega_limit_use(out, ref, lambda s, ref=ref: ref[0], "bf16",
                           "stress launch")
    print(f"[tp_mega] {TP_MEGA_STRESS} launches back to back on fresh "
          "tokens: each within the limit, ranks bitwise equal")
    # Traced: == untraced, each rank's ring valid; the step split by opcode.
    for ns in TP_MEGA_NS:
        comp = comps[True, ns]
        tcomp = megas[True]._compile(dataclasses.replace(
            comp.builder.dims, trace=True))
        base = comp.run(w, *args)
        launches = []
        for _ in range(5):
            flush.zero_()
            torch.cuda._sleep(LEAD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            tout = tcomp.run(w, *args)
            end.record()
            end.synchronize()
            launches.append((start.elapsed_time(end), tout))
        if not all(torch.equal(x, y) for x, y in zip(base, launches[0][1])):
            raise RuntimeError(f"traced tp launch NS={ns} differs from the "
                               "untraced one")
        event_ms, tout = sorted(launches, key=lambda x: x[0])[2]
        ring = tout[5].cpu().numpy()
        records = kt.decode_trace(ring)
        problems = kt.validate_ring(records, tcomp.order)
        mids = [r for r in records if r.opcode in (
            int(TaskType.AR_SEND), int(TaskType.AR_WAIT))]
        if (ring.shape[0] != TP or problems or not mids
                or not all(r.begin <= r.mid <= r.end for r in mids)):
            raise RuntimeError(f"traced tp launch NS={ns}: rings "
                               f"{ring.shape}, problems {problems[:5]}")
        mine = [r for r in records if r.rank == 0]
        span = max(r.end for r in mine) - min(r.begin for r in mine)
        split = {}
        for r in mine:
            split[r.op] = split.get(r.op, 0.0) + r.dur * event_ms / span / ns
        rec["split_ms_per_step"][ns] = {
            "event_ms_per_launch": event_ms,
            **{op: split.get(op, 0.0) for op in TP_MEGA_SPLIT_OPS}}
        print(f"[tp_mega] traced NS={ns}: == untraced bit for bit, {TP} "
              f"rings of {len(records) // TP} records validate; rank 0's "
              f"split per step {json.dumps(rec['split_ms_per_step'][ns])}")
    # f32 at 2 layers: tokens equal, logits within 2e-3.
    m32 = AutoLLM.from_pretrained(TP_MODEL, device=dev, seed=SEED, tp=TP,
                                  dtype=torch.float32, num_layers=2)
    a32 = _tp_mega_operands(m32, TP_MEGA_LENS, SEED + 5)
    w32 = _weights(m32.params)
    for ns in TP_MEGA_NS:
        mega = MegaQwen3(m32, cfg=MegaConfig(
            fuse_norms=True, cross_prefetch=True, overlap_ar=True))
        dims = dataclasses.replace(
            mega._dims(b, TP_MAX_LENGTH, PAGE,
                       num_pages=int(a32[0][0].shape[1])),
            nsteps=ns, v_real=V)
        comp = mega._compile(dims)
        i = {}
        got = comp.run(w32, *a32, info=i)
        torch.cuda.synchronize()
        _ranks_equal(i, f"f32 NS={ns}")
        ref = mega_decode_plain_tp(dims, True, comp.table, w32, *a32)
        used, err, _ = _tp_mega_limit_use(got, ref, None, "f32",
                                          f"mega_decode_tp f32 NS={ns}")
        rec["limit_used"][f"f32_ns{ns}"] = used
        print(f"[tp_mega] f32 2 layers NS={ns}: tokens == plain, logits "
              f"max_abs_err {err:.3e}, {used:.3f} of the limit")
    del m32, a32, w32
    torch.cuda.empty_cache()
    bound = _tp_mega_bound(model, TP_MEGA_LENS)
    ms1 = rec["ms_per_launch"]["ns1_overlap1"]
    print(f"[tp_mega] {ms1:.4f} ms a step at NS=1, "
          f"{rec['ms_per_launch']['ns8_overlap1'] / 8:.4f} in an NS=8 "
          f"launch; bound {bound['bound_ms']:.4f} ms ({bound['bound_bytes']}"
          f" B over {HBM_BPS:.3g} B/s); plain "
          f"{rec['plain_ms_per_launch']['ns1']:.2f} ms")
    return dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/megakernel.cu",
        replaces="triton_distributed_tpu/megakernel/kernels.py:1047",
        max_abs_err=max_err, ms=ms1,
        plain_ms=rec["plain_ms_per_launch"]["ns1"], library_ms=None,
        **bound,
        shape=f"{TP_MODEL} tp={TP}, 36 layers, B={b}, paged page={PAGE}, "
              f"kv_len {list(TP_MEGA_LENS)}, NS=1 bf16 (ms = one step), "
              "the serving config (fused norms, overlap_ar); the tp>1 "
              "bodies kernels.py:1047 allreduce, :1076 ar_send, :1102 "
              "ar_wait, :1574 barrier, :1529-1557 the LM head's argmax, "
              "in code_generator.py:473's pallas_call",
        ms_per_step_ns8=rec["ms_per_launch"]["ns8_overlap1"] / 8,
        control_x=control, straggler_ms=[base_ms, lag_ms],
        launch=info, **rec)


def serve_tp_mega_paths(dev, model, plain, tp_outs) -> tuple:
    """The megakernel's paths at tp=2 on ``model`` (TP_MEGA_PATH_KERNELS):
    ``ContinuousEngine(mode="mega", ns=8, prefix_cache=True, eos_id=...)``
    over the TP prompts (the eos id: continuous_tp's token TP_MEGA_EOS_AT
    of request 0), ``Engine(mode="mega", paged=True)`` on the two
    300-token prompts, and the continuous path resident and traced (the
    same engine otherwise: its tokens the untraced path's; every rank's ring validated against the
    scheduled order and its doorbell). Each path: audit, teacher forcing
    against ``plain``, and the megakernel's launches exactly one per
    ns-step launch and per single step. Returns (launches by path, e2e)."""
    import numpy as np
    import torch

    from triton_distributed_tpu_torch.models import ContinuousEngine, Engine
    from triton_distributed_tpu_torch.obs import kernel_trace as kt
    from triton_distributed_tpu_torch.ops import cuda_kernels as ck

    rng, prompts, _ids = tp_prompts(model.cfg.vocab_size)
    eos = int(tp_outs["continuous_tp"][0][TP_MEGA_EOS_AT])
    warm = rng.integers(0, model.cfg.vocab_size,
                        TP_PROMPT_LENS[0]).astype(np.int32)
    kw = dict(max_batch=4, page_size=PAGE, max_length=TP_MAX_LENGTH,
              mode="mega", ns=TP_MEGA_NSTEP, eos_id=eos, device=dev)
    runs = {
        "continuous_tp_mega": lambda: ContinuousEngine(
            model, prefix_cache=True, **kw),
        "paged_engine_tp_mega": lambda: Engine(model, mode="mega",
                                               paged=True, page_size=PAGE,
                                               device=dev),
        "continuous_tp_mega_resident": lambda: ContinuousEngine(
            model, prefix_cache=True, resident=True, kernel_trace=True,
            **kw),
    }
    launches, outs, e2e = {}, {}, {}
    for path, make in runs.items():
        eng = make()
        timer = None
        if path == "paged_engine_tp_mega":
            eng.serve(np.stack(prompts[1::2]), 2, TP_MAX_LENGTH)
        else:
            eng.run([(warm, 2)])
            timer = _LaunchTimer(eng)
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        if path == "paged_engine_tp_mega":
            got = eng.serve(np.stack(prompts[1::2]), TP_GEN, TP_MAX_LENGTH,
                            ns=TP_MEGA_NSTEP)
            outs[path] = [g[len(p):] for g, p in zip(got, prompts[1::2])]
        else:
            outs[path] = eng.run([(p, TP_GEN) for p in prompts])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[path] = ck.launch_counts()
        if eng.audit():
            raise RuntimeError(f"{path}: pool audit failed: {eng.audit()}")
        st = eng.last_stats
        n_launch = st.get("mega_launches", 0)
        if path == "paged_engine_tp_mega":
            singles = TP_GEN - 1 - n_launch * TP_MEGA_NSTEP
        else:
            singles = st.get("mega_fallback_steps", 0)
        want = n_launch + singles
        counts = {k: launches[path][k] for k in TP_MEGA_PATH_KERNELS[path]}
        print(f"[tp_mega] {path}: {wall:.2f} s wall, launches {counts} "
              f"({n_launch} ns={TP_MEGA_NSTEP} launches + {singles} single "
              "steps)")
        missing = [k for k, c in counts.items() if not c]
        if missing or counts["mega_decode_tp"] != want:
            raise RuntimeError(f"{path}: launches {counts}, "
                               f"{want} megakernel launches expected")
        e2e[path] = {"wall_s": wall, "launches": counts,
                     "mega_launches": n_launch, "single_steps": singles}
        if timer is not None:
            steps = n_launch * TP_MEGA_NSTEP
            e2e[path]["launch_device_ms_per_step"] = (
                timer.device_ms() / max(steps, 1))
        if path == "continuous_tp_mega_resident":
            if [list(o) for o in outs[path]] != [
                    list(o) for o in outs["continuous_tp_mega"]]:
                raise RuntimeError("the resident path's tokens differ from "
                                   "continuous_tp_mega's")
            order = eng._mega_model().multi_task_order(
                4, TP_MAX_LENGTH, TP_MEGA_NSTEP, page=PAGE,
                num_pages=eng.cache.num_pages, valid_arg=True, trace=True,
                eos=True, ring=True)
            rings = eng.kernel_trace_launches()
            for ln in rings:
                problems = kt.validate_ring(ln.get_records(), order,
                                            doorbell=ln.doorbell)
                if ln.ring.shape[0] != TP or problems:
                    raise RuntimeError(f"{path}: ring {ln.ring.shape}, "
                                       f"problems {problems[:5]}")
            print(f"[tp_mega] {path}: tokens == continuous_tp_mega's, "
                  f"{len(rings)} recent launches' {TP} rings validate "
                  f"against the order and their doorbells; "
                  f"{st['mega_resident_rounds']} resident rounds")
            e2e[path]["resident_rounds"] = st["mega_resident_rounds"]
            continue
        gaps = []
        src = prompts[1::2] if path == "paged_engine_tp_mega" else prompts
        for p, o in zip(src, outs[path]):
            gaps += teacher_forced_gaps(plain, p, np.asarray(o))
        e2e[path]["teacher_forcing"] = _tf_check(
            f"{path} (tp={TP})", gaps, TF_MARGIN, TF_MIN_EXACT)
    e2e["eos_id"] = eos
    return launches, e2e


# The prefill megakernel at tp > 1 (MegaQwen3.prefill over the two
# co-located ranks of the TP phase's Qwen3-8B, all 36 layers: the kTp
# build of mega_prefill_kernel, its entry BARRIER and the ALLREDUCE of
# every projection's [S, d] f32 partials in rank order). One prompt of
# PREFILL_S rows with PREFILL_TRUE real ones: row PREFILL_TRUE - 1's logits
# and every rank's K/V rows [0, PREFILL_TRUE) within the megakernel's bf16
# limit against the plain lockstep walk, two launches bit-identical, the
# ranks' final residuals bitwise equal; negative control: rank 1's partial
# dropped at layer 18 must break the logit limit. The kernel's top token
# must lie within TF_MARGIN of the top of the pallas prefill
# (prefill_batched, mode pallas) of the same prompt, and PREFILL_GEN tokens
# decoded by the tp megakernel (ns=8 launches) from the cache the prefill
# wrote pass bf16 teacher forcing against the plain forward; that run, from
# a launch count of 0, is the path "mega_prefill_tp".
TP_PREFILL_DROP = (18, 1)
TP_PREFILL_PATH_KERNELS = {
    "mega_prefill_tp": ("mega_prefill_tp", "mega_decode_tp"),
}


def _prefill_tp_bound(model) -> dict:
    """``_prefill_bound`` over both ranks: each rank's weight shards and
    LM-head columns, its kv heads' K/V rows, the prompt rows it reads and
    its logits, and each rank's FLOPs on its heads and columns."""
    import dataclasses

    cfg, n = model.cfg, model.tp
    loc = dataclasses.replace(cfg, num_q_heads=cfg.num_q_heads // n,
                              num_kv_heads=cfg.num_kv_heads // n)
    parts = [_prefill_bound(loc, p) for p in model.rank_params]
    nbytes = sum(p["bytes"] for p in parts)
    flops = sum(p["flops"] for p in parts)
    t_bytes, t_ops = nbytes / HBM_BPS, flops / BF16_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def check_mega_prefill_tp(dev, flush, model, plain) -> tuple:
    """The prefill megakernel at tp=2 on ``model`` (see the constants
    above), timed against its plain version and its bound. Returns (the
    record of ``mega_prefill_tp``, launches by path, the e2e block)."""
    import dataclasses

    import numpy as np
    import torch

    from triton_distributed_tpu_torch.megakernel import (
        MegaConfig,
        MegaQwen3,
    )
    from triton_distributed_tpu_torch.megakernel.kernels import (
        mega_prefill_plain_tp,
    )
    from triton_distributed_tpu_torch.megakernel.qwen3 import _weights
    from triton_distributed_tpu_torch.ops import cuda_kernels as ck

    cfg = model.cfg
    prompt = prefill_prompt(cfg.vocab_size)
    toks = torch.from_numpy(prompt).to(dev).long()
    tl = torch.tensor([PREFILL_TRUE], dtype=torch.int32, device=dev)
    mega = MegaQwen3(model, cfg=MegaConfig(fuse_norms=True))
    dims = dataclasses.replace(mega._dims(PREFILL_S, PREFILL_S),
                               prefill=True)
    comp = mega._compile(dims)
    w = _weights(model.params)
    x0 = w[0].embed.index_select(0, toks)
    info = {}
    got = comp.run.prefill(w, x0, tl, info=info)
    again = comp.run.prefill(w, x0, tl)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise RuntimeError("two tp prefill launches differ")
    for r in range(1, TP):
        if not torch.equal(info["x"][r], info["x"][0]):
            raise RuntimeError(f"tp prefill: rank {r}'s residual differs "
                               "from rank 0's")
    ref = mega_prefill_plain_tp(dims, True, comp.table, w, x0, tl)
    atol, rtol = MEGA_TOL["bf16"]

    def use(a, b):
        return ((a.float() - b.float()).abs()
                / (atol + rtol * b.float().abs())).max().item()

    used = use(got[0], ref[0])
    kv_used = max(use(a[..., :PREFILL_TRUE, :], b[..., :PREFILL_TRUE, :])
                  for a, b in zip(got[1:], ref[1:]))
    bad = mega_prefill_plain_tp(dims, True, comp.table, w, x0, tl,
                                drop_partial=TP_PREFILL_DROP)[0]
    bad_used = use(got[0], bad)
    err = (got[0] - ref[0]).abs().max().item()
    info = {k: info[k] for k in ("blocks", "smem_bytes", "blocks_per_sm")
            if k in info}
    print(f"[tp_prefill] bf16 S={PREFILL_S} true_len={PREFILL_TRUE} tp={TP}: "
          f"ranks bitwise equal, logits max_abs_err {err:.3e}, {used:.3f} "
          f"of the limit; K/V rows {kv_used:.3f} of it; control (rank "
          f"{TP_PREFILL_DROP[1]}'s partial dropped at layer "
          f"{TP_PREFILL_DROP[0]}): {bad_used:.1f}x the limit; launch {info}")
    if not (used <= 1.0 and kv_used <= 1.0 and bad_used > 1.0
            and torch.isfinite(got[0]).all()):
        raise RuntimeError(f"mega_prefill_tp: limit use {used}, K/V "
                           f"{kv_used}, control {bad_used}")
    # The pallas prefill of the same prompt: the kernel's top token near
    # its top.
    dense = model.new_cache(1, 512)
    p_logits, _ = model.prefill_batched(prompt[None], dense, "pallas",
                                        [PREFILL_TRUE])
    p_row = p_logits[0].float()
    top = int(got[0][0, :cfg.vocab_size].argmax())
    top_gap = (p_row.max() - p_row[top]).item()
    print(f"[tp_prefill] kernel top token {top}: {top_gap:.4f} below the "
          f"pallas prefill's top (limit {TF_MARGIN})")
    if not top_gap <= TF_MARGIN:
        raise RuntimeError(f"tp prefill top token {top_gap} below pallas")
    del dense
    # The path: the prefill, then PREFILL_GEN tokens decoded from its
    # cache, from launch counts of 0.
    cache = model.new_cache(1, 512)
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = mega.prefill(prompt, cache, true_len=PREFILL_TRUE)
    tok = logits.argmax().view(1).to(torch.int32)
    gen = [int(tok)]
    step = mega.decode_multi_fn(1, 512, 8)
    while len(gen) < PREFILL_GEN:
        out, _, cache = step(model.params, tok, cache)
        gen += [int(t) for t in out[:, 0].tolist()]
        tok = out[-1].clone()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"mega_prefill_tp": ck.launch_counts()}
    counts = {k: launches["mega_prefill_tp"][k]
              for k in TP_PREFILL_PATH_KERNELS["mega_prefill_tp"]}
    ran = {k for k, c in launches["mega_prefill_tp"].items() if c}
    want = {"mega_prefill_tp": 1,
            "mega_decode_tp": -(-(PREFILL_GEN - 1) // 8)}
    if ran != set(counts) or counts != want:
        raise RuntimeError(f"mega_prefill_tp path: launches {counts} "
                           f"(ran {sorted(ran)}), want {want}")
    gen = np.asarray(gen[:PREFILL_GEN])
    gaps = teacher_forced_gaps(plain, prompt[:PREFILL_TRUE], gen)
    tf = _tf_check(f"mega_prefill_tp then tp mega decode (tp={TP})", gaps,
                   TF_MARGIN, TF_MIN_EXACT)
    ms = median_ms(lambda: comp.run.prefill(w, x0, tl), flush, iters=7)
    plain_ms = median_ms(lambda: mega_prefill_plain_tp(
        dims, True, comp.table, w, x0, tl), flush, iters=3, warmup=1)
    bound = _prefill_tp_bound(model)
    print(f"[tp_prefill] {ms:.4f} ms a launch, plain {plain_ms:.2f} ms; "
          f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}); path "
          f"wall {wall:.2f} s, launches {counts}")
    record = dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/megakernel.cu",
        replaces="triton_distributed_tpu/megakernel/kernels.py:1047",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
        bound_bytes=bound["bytes"], bound_flops=bound["flops"],
        limit_used=used, kv_limit_used=kv_used, control_x_limit=bad_used,
        pallas_top_gap=top_gap, launch=info,
        shape=f"{TP_MODEL} tp={TP}, {cfg.num_layers} layers bf16, S="
              f"{PREFILL_S}, true_len {PREFILL_TRUE}, fused norms; the "
              "prefill graph's bodies at n>1: kernels.py:1047 allreduce "
              "over S rows, :896 load_x, :908 attn_prefill, :1574 barrier")
    e2e = {"wall_s": wall, "launches": counts, "teacher_forcing": tf,
           "pallas_top_gap": top_gap}
    return record, launches, e2e


# Tensor-parallel Qwen3-MoE: Qwen/Qwen3-30B-A3B at tp=2 (hq_loc 16,
# hkv_loc 2: G = 8; f_loc 384 columns of every expert a rank), both ranks
# co-located on the card. The expert layers' partials cross ranks through
# the collectives of csrc/collectives.cu, picked by the JAX AUTO:
# ContinuousEngine(mode="pallas", prefix_cache=True) prefills one chunk a
# prompt of MOE_TP_PROMPT_LENS tokens, 48, 112, 384 and 1152 rows: the
# all-reduce takes ONE_SHOT (<= 256 KB), DOUBLING (<= 1 MB), TWO_SHOT
# (a ring reduce-scatter, which the HBM-tiled ring replaces above 4 MB,
# then a ring all-gather); its B <= 4 decode takes ONE_SHOT. Engine(mode=
# "pallas", paged=True) prefills sequence-sharded: the tokens gathered by
# the full mesh, the partials reduce-scattered by the ring (2 rows of 300
# tokens) or the one-shot (2 rows of 40). The n = 4 branches (the
# bidirectional rings) run in the kernel checks and in tiny-moe at tp=4,
# whose 1104-token Engine prompt passes their size thresholds.
MOE_TP = 2
MOE_TP_PROMPT_LENS = (40, 100, 300, 1100, 40)
MOE_TP_GEN = 16
MOE_TP_MAX_LENGTH = 1280
MOE_TP_ENGINE_LENS = (300, 40)
MOE_TP_STRESS = 100
MOE_TP_LAG_NS = 500_000
# The layer-by-layer hold: one chunk of each width the continuous path
# prefills, and MOE_TP_DECODE_STEPS decode steps of a B=4 batch.
MOE_TP_CHUNKS = (48, 112, 384, 1152)
MOE_TP_DECODE_STEPS = 4
# Its limit on the residual each expert layer moves, (atol, rtol on the
# path's residual after the layer): PR 9's MOE_X_TOL did not carry over.
# The plain expert layer rounds gate, up and down to bf16 where the
# path's per-expert GEMMs do, but sums in another order (and the path's
# combine adds with atomics, in no fixed order), so bf16 roundings flip:
# the first readings (my chip runs on one H100) used 1.07-1.20 of
# MOE_X_TOL on the layer's output alone and 1.72 of it on the residual
# scale. At 4x MOE_X_TOL they use 0.13-0.43, and the negative control
# (rank 1's partial dropped at layer 24) breaks it 49x.
MOE_TP_X_TOL = (MOE_X_TOL[0] * 4, MOE_X_TOL[1] * 4)
# Teacher forcing of the MoE-TP paths routes the plain forward's experts
# as the run routed each position (``_RouteLog``): this random 48-layer
# bf16 MoE has flat logits (top-2 margins of 0-2 bf16 ulps at |logit|
# ~4.5), and free routing lets two right bf16 implementations diverge
# (PR 9: by layer 16 every row routes otherwise). The first readings with
# the plain gate's own routing reached gaps of 0.1875 (this path) and
# 0.2188 (mode xla, no collective kernel) against the 0.125 margin;
# routed as the run, 0.0312. The routing itself is held by the hold.
# tiny-moe at tp=4 (f32, d = 64): a 1104-token row's prefill gathers
# 276-row shards (70.6 KB, over the full mesh's 64 KB) and reduce-scatters
# 282 KB of partials in even 276-row chunks: both bidirectional rings.
MOE_TP_TINY_LONG = 1104
MOE_TP_PATH_KERNELS = {
    "tiny_moe_tp4_engine": ("all_gather_bidir_ring",
                            "reduce_scatter_bidir_ring"),
    "continuous_moe_tp": ("flash_attention", "paged_flash_decode", "gemm_ar",
                          "gemm_rs", "all_gather", "all_reduce_one_shot",
                          "all_reduce_doubling", "reduce_scatter_ring",
                          "reduce_scatter_ring_hbm", "all_gather_ring"),
    "paged_engine_moe_tp": ("flash_attention", "paged_flash_decode",
                            "ag_gemm_adaptive", "gemm_rs", "gemm_ar",
                            "all_gather", "reduce_scatter_one_shot",
                            "reduce_scatter_ring", "all_reduce_one_shot"),
}
_COLL_SRC = "triton_distributed_tpu_torch/csrc/collectives.cu"
_COLL_REF = "triton_distributed_tpu/ops/collectives/"
MOE_TP_SOURCES = {
    "all_reduce_one_shot": _COLL_REF + "all_reduce.py:78",
    "all_reduce_doubling": _COLL_REF + "all_reduce.py:113",
    "reduce_scatter_one_shot": _COLL_REF + "reduce_scatter.py:150",
    "reduce_scatter_ring": _COLL_REF + "reduce_scatter.py:59",
    "reduce_scatter_bidir_ring": _COLL_REF + "reduce_scatter.py:89",
    "reduce_scatter_ring_hbm": _COLL_REF + "reduce_scatter.py:191",
    "all_gather_ring": _COLL_REF + "all_gather.py:49",
    "all_gather_bidir_ring": _COLL_REF + "all_gather.py:93",
}


def _coll_ops():
    """Each new collective kernel: (launcher(xs, ctx, **kw), plain
    version(xs), family)."""
    from triton_distributed_tpu_torch.ops import collectives as col
    from triton_distributed_tpu_torch.ops.collectives import (
        AllReduceMethod as AR,
    )
    from triton_distributed_tpu_torch.ops.collectives import (
        ReduceScatterMethod as RS,
    )

    def ar(m):
        return lambda xs, ctx, **kw: col.all_reduce_kernel(m, xs, ctx, **kw)

    def rs(m):
        return lambda xs, ctx, **kw: col.reduce_scatter_kernel(m, xs, ctx,
                                                               **kw)

    def ring_plain(half):
        def plain(xs):
            m_per = xs[0].shape[0] // len(xs)
            return col.reduce_scatter_ring_plain(
                xs, m_per // 2 if half else None)
        return plain

    return {
        "all_reduce_one_shot": (ar(AR.ONE_SHOT), col.all_reduce_plain, "ar"),
        "all_reduce_doubling": (ar(AR.DOUBLING),
                                col.all_reduce_doubling_plain, "ar"),
        "reduce_scatter_one_shot": (rs(RS.ONE_SHOT),
                                    col.reduce_scatter_one_shot_plain, "rs"),
        "reduce_scatter_ring": (rs(RS.PALLAS_RING), ring_plain(False), "rs"),
        "reduce_scatter_bidir_ring": (rs(RS.PALLAS_BIDIR_RING),
                                      ring_plain(True), "rs"),
        "reduce_scatter_ring_hbm": (rs(RS.PALLAS_RING_HBM),
                                    ring_plain(False), "rs"),
        "all_gather_ring": (col.all_gather_ring, col.all_gather_plain, "ag"),
        "all_gather_bidir_ring": (col.all_gather_bidir_ring,
                                  col.all_gather_plain, "ag"),
    }


# Rows a rank at d = 2048 for each family's checks: the all-reduce's
# decode batch and chunks (ONE_SHOT, DOUBLING, TWO_SHOT), the
# reduce-scatter's prefill widths (one-shot, ring, HBM ring; a row count
# a multiple of 2n), the all-gather's 384-row chunk shard.
MOE_TP_CHECK_ROWS = {"ar": (4, 112, 384), "rs": (48, 304, 1152),
                     "ag": (192,)}
# The timed shape of each kernel: (n, rows a rank at d = 2048) where the
# path (or, for the bidirectional rings, the n = 4 TWO_SHOT of a 384-row
# chunk) gives it.
MOE_TP_TIMED = {
    "all_reduce_one_shot": (2, 4), "all_reduce_doubling": (2, 112),
    "reduce_scatter_one_shot": (2, 48), "reduce_scatter_ring": (2, 300),
    "reduce_scatter_ring_hbm": (2, 1152),
    "reduce_scatter_bidir_ring": (4, 384), "all_gather_ring": (2, 192),
    "all_gather_bidir_ring": (4, 96),
}


def check_moe_tp_kernels(dev, flush) -> dict:
    """Each collective kernel against its plain version on the same
    per-rank inputs at n = 2 and 4, f32 (TF32 off) and bf16, at
    MOE_TP_CHECK_ROWS: the limits of ``_tp_limit``; ONE_SHOT's ranks
    bitwise equal and the all-gathers equal to the shards; the planted
    ring order of the three rings at n = 4; MOE_TP_STRESS back-to-back
    launches of each; a MOE_TP_LAG_NS straggler through ONE_SHOT,
    DOUBLING and TWO_SHOT; then each kernel's timing at MOE_TP_TIMED.
    Returns the records by kernel."""
    import numpy as np
    import torch

    from triton_distributed_tpu_torch.ops import collectives as col
    from triton_distributed_tpu_torch.ops import cuda_kernels as ck
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    ops = _coll_ops()
    rng = np.random.default_rng(SEED + 20)
    bf16, f32 = torch.bfloat16, torch.float32

    def inputs(n, rows, dtype, fam):
        ctx = initialize_distributed(n, device=dev, dtype=dtype)
        if fam == "rs":
            rows = -(-rows // (2 * n)) * 2 * n
        return ctx, [torch.from_numpy(rng.standard_normal((rows, 2048)).astype(
            np.float32)).to(dev, dtype) for _ in range(n)]

    def within(name, got, want, dtype, n, what):
        atol, rtol = _tp_limit(dtype, n)
        worst = 0.0
        for g, w in zip(got, want):
            e = (g.float() - w.float()).abs()
            if not bool(torch.isfinite(g.float()).all()) or bool(
                    (e > atol + rtol * w.float().abs()).any()):
                raise RuntimeError(
                    f"{name} {what}: |kernel - plain| {float(e.max()):.3g} "
                    f"over the limit ({atol:.3g} + {rtol:.3g}|p|)")
            worst = max(worst, float(e.max()))
        return worst

    def check(name, got, want, dtype, n, what):
        if ops[name][2] == "ag":
            if not all(torch.equal(g, want[0]) for g in got):
                raise RuntimeError(f"{name} {what}: a rank's output is not "
                                   "the shards")
            return 0.0
        worst = within(name, got, want, dtype, n, what)
        if name == "all_reduce_one_shot" and not all(
                torch.equal(g, got[0]) for g in got[1:]):
            raise RuntimeError(f"{name} {what}: ranks' outputs differ")
        return worst

    max_abs = {name: 0.0 for name in ops}
    for name, (fn, plain, fam) in ops.items():
        for n in (2, 4):
            for dt in (f32, bf16):
                for rows in MOE_TP_CHECK_ROWS[fam]:
                    ctx, xs = inputs(n, rows, dt, fam)
                    e = check(name, fn(xs, ctx), plain(xs), dt, n,
                              f"n={n} [{rows}, 2048] {dt}")
                    if dt == bf16:
                        max_abs[name] = max(max_abs[name], e)
        print(f"[moe_tp] {name}: n=2 and 4, f32 and bf16, rows "
              f"{MOE_TP_CHECK_ROWS[fam]}: max |kernel - plain| bf16 "
              f"{max_abs[name]:.3g}"
              + (", ranks bitwise equal" if name == "all_reduce_one_shot"
                 else ", == the shards bitwise" if fam == "ag" else ""))

    # The ring order: planted bf16 partials, 256, 1, -256, 0 by a rank's
    # position on the chunk's ring: the ring ends at 0, rank order at 1.
    n, m_per = 4, 8
    for name in ("reduce_scatter_ring", "reduce_scatter_bidir_ring",
                 "reduce_scatter_ring_hbm"):
        half = m_per // 2 if "bidir" in name else m_per
        xs = np.zeros((n, n * m_per, 2048), np.float32)
        for r in range(n):
            for c in range(n):
                for i in range(m_per):
                    pos = (r - c - 1) % n if i < half else (c - 1 - r) % n
                    xs[r, c * m_per + i, 0] = (256.0, 1.0, -256.0, 0.0)[pos]
        ctx = initialize_distributed(n, device=dev, dtype=bf16)
        ts = [torch.from_numpy(x).to(dev, bf16) for x in xs]
        got = torch.cat(ops[name][0](ts, ctx))
        one = torch.cat(col.reduce_scatter_one_shot_plain(ts))
        if not (got[:, 0] == 0).all() or not (one[:, 0] == 1).all():
            raise RuntimeError(f"{name}: planted partials give "
                               f"{got[:, 0].tolist()}, not the ring's 0")
    print("[moe_tp] ring order: planted bf16 partials at n=4 give 0 "
          "through the ring, the bidir ring and the HBM ring (a sum in "
          "rank order gives 1)")

    # Stress: back-to-back launches with fresh inputs, all checked after
    # one sync.
    kept = []
    for name, (fn, plain, fam) in ops.items():
        ctx, xs = inputs(4, 32, f32, fam)
        for i in range(MOE_TP_STRESS):
            xs = [t + 0.01 for t in xs]
            kept.append((name, xs, fn(xs, ctx)))
    torch.cuda.synchronize()
    for name, xs, got in kept:
        check(name, got, ops[name][1](xs), f32, 4, "stress")
    print(f"[moe_tp] stress: {MOE_TP_STRESS} back-to-back launches of each "
          f"kernel at n=4, fresh inputs, all {len(kept)} outputs correct")

    # The straggler: rank 1 lags MOE_TP_LAG_NS before its first put.
    lag = {}
    for method, rows in (("ONE_SHOT", 4), ("DOUBLING", 112),
                         ("TWO_SHOT", 384)):
        ctx, xs = inputs(2, rows, bf16, "ar")
        m = col.AllReduceMethod[method]
        ms = []
        for nanos in (0, MOE_TP_LAG_NS):
            col.all_reduce(xs, ctx, m)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            got = col.all_reduce(xs, ctx, m, straggler_rank=1 if nanos
                                 else None, straggler_nanos=nanos)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            within(method, got, col.all_reduce_plain(xs), bf16, 2,
                   f"straggler {nanos} ns")
        if ms[1] < MOE_TP_LAG_NS / 1e6:
            raise RuntimeError(f"{method}: a {MOE_TP_LAG_NS} ns straggler "
                               f"took {ms[1]} ms")
        lag[method] = {"ms": ms[0], "lagged_ms": ms[1]}
    print(f"[moe_tp] straggler {MOE_TP_LAG_NS} ns on rank 1: "
          f"{json.dumps(lag)} (each lagged launch >= the lag, sums right)")

    # Timing at the path's shapes. Bound: every rank's bytes (inputs read
    # once, outputs written once) over one HBM. library_ms: one PyTorch
    # call of the same function on one card (torch.stack(xs).sum(0) for
    # the reductions; for the gathers one copy_ of the stacked shards
    # into every rank's output, the n outputs the kernel writes).
    records = {}
    for name, (fn, plain, fam) in ops.items():
        n, rows = MOE_TP_TIMED[name]
        ctx, xs = inputs(n, rows, bf16, fam)
        shard = xs[0].numel() * 2
        moved = {"ar": 2 * n * shard, "rs": n * shard + n * shard // n,
                 "ag": n * shard + n * n * shard}[fam]
        lib = (gather_copy(xs) if fam == "ag"
               else (lambda xs=xs: torch.stack(xs).sum(0)))
        bms = moved / HBM_BPS * 1e3
        rec = dict(route="cuda", source=_COLL_SRC,
                   replaces=MOE_TP_SOURCES[name], max_abs_err=max_abs[name],
                   ms=median_ms(lambda: fn(xs, ctx), flush),
                   plain_ms=median_ms(lambda: plain(xs), flush),
                   bound_ms=bms, bound_by="bytes",
                   library_ms=median_ms(lib, flush),
                   shape=f"tp={n} [{xs[0].shape[0]}, 2048] a rank bf16",
                   straggler=lag if name.startswith("all_reduce") else None)
        records[name] = rec
        print(f"[moe_tp] {name} {rec['shape']}: {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f}, library {rec['library_ms']:.4f}, "
              f"bound {bms:.4f} ms (bytes)")
    return records


def check_moe_tp_tiny(dev) -> dict:
    """tiny-moe f32 at tp=2 and tp=4 on the card emits the CPU's tokens
    (the plain versions there) through both engines, modes pallas and
    xla; then at tp=4 one MOE_TP_TINY_LONG-token row through
    Engine(mode="pallas"), whose launches (counted from 0 around the card
    run) are path ``tiny_moe_tp4_engine``. Returns the launches by
    path."""
    import numpy as np

    from triton_distributed_tpu_torch.models import (
        AutoLLM,
        ContinuousEngine,
        Engine,
        Qwen3MoE,
    )
    from triton_distributed_tpu_torch.ops import cuda_kernels as ck

    src = AutoLLM.from_pretrained("tiny-moe", device="cpu", seed=SEED)
    rng = np.random.default_rng(SEED + 21)
    prompts = [rng.integers(0, 256, k).astype(np.int32) for k in (20, 41, 9)]
    ids = np.stack([prompts[0], prompts[1][:20]])
    long_ids = rng.integers(0, 256, (1, MOE_TP_TINY_LONG)).astype(np.int32)
    launches = {}
    for tp in (2, 4):
        models = {}
        for d in (dev, "cpu"):
            models[d] = Qwen3MoE(src.cfg, device=d, tp=tp)
            models[d].set_params(src.params)
        for mode in ("pallas", "xla"):
            outs = []
            for d, m in models.items():
                res = []
                for pc in (False, True):
                    eng = ContinuousEngine(m, max_batch=2, page_size=16,
                                           max_length=64, prefix_cache=pc,
                                           mode=mode, device=d)
                    res.append(np.concatenate(
                        eng.run([(p, 8) for p in prompts])))
                    if eng.audit():
                        raise RuntimeError(f"tiny-moe tp={tp} on {d}: audit "
                                           f"{eng.audit()}")
                res.append(Engine(m, mode=mode, paged=True, page_size=16,
                                  device=d).serve(ids, 7, 64))
                outs.append(res)
            if not all(np.array_equal(x, y) for x, y in zip(*outs)):
                raise RuntimeError(f"tiny-moe f32 tp={tp} mode={mode} on the "
                                   "card differs from the CPU")
        print(f"[moe_tp] tiny-moe f32 tp={tp} ContinuousEngine (with and "
              "without the prefix cache) + Engine, modes pallas and xla: "
              "tokens on the card == CPU")
    outs = []
    for d, m in models.items():
        if d == dev:
            ck.reset_launch_counts()
        outs.append(Engine(m, mode="pallas", paged=True, page_size=16,
                           device=d).serve(long_ids, 4,
                                           MOE_TP_TINY_LONG + 16))
        if d == dev:
            launches["tiny_moe_tp4_engine"] = ck.launch_counts()
    if not np.array_equal(*outs):
        raise RuntimeError("tiny-moe tp=4 long row: card != CPU")
    got = launches["tiny_moe_tp4_engine"]
    missing = [k for k in MOE_TP_PATH_KERNELS["tiny_moe_tp4_engine"]
               if not got[k]]
    if missing:
        raise RuntimeError(f"tiny_moe_tp4_engine did not launch {missing}")
    print(f"[moe_tp] tiny_moe_tp4_engine ({MOE_TP_TINY_LONG} tokens, tp=4): "
          f"card == CPU, launches "
          f"{ {k: v for k, v in got.items() if v} }")
    return launches


class _RouteLog:
    """The routing a serving run took: rank 0's gate (``router_topk`` of
    ``layers/tp_moe.py``) at every layer, per (request, position), from
    wrappers of the model's forwards: a prefill chunk (its slot and
    offset), a batched prefill (the i-th of a serve fills row i) and a
    decode step (row b at position ``kv_len[b]``). A prefill finds its
    request by the prompt's tokens; a row whose input token is not the
    request's at that position (an empty slot) is not used."""

    NAMES = ("prefill_paged_chunk", "prefill_batched", "decode_step")

    def __init__(self, model, prompts):
        import importlib

        import numpy as np

        self.model, self.n, self.L = model, model.tp, model.cfg.num_layers
        self.prompts = [np.asarray(p) for p in prompts]
        self.rows, self.slot_req, self._calls, self._batched = {}, {}, None, 0
        self._tm = importlib.import_module(
            "triton_distributed_tpu_torch.layers.tp_moe")
        self._gate = self._tm.router_topk
        self._inner = {k: getattr(model, k) for k in self.NAMES}

        def gate(*a, **kw):
            out = self._gate(*a, **kw)
            if self._calls is not None:
                self._calls.append(out)
            return out

        def wrap(name):
            def wrapped(*a, **kw):
                meta = getattr(self, "_meta_" + name)(*a, **kw)
                self._calls = []
                out = self._inner[name](*a, **kw)
                calls, self._calls = self._calls, None
                self._keep(calls, meta)
                return out
            return wrapped

        self._tm.router_topk = gate
        for name in self.NAMES:
            setattr(model, name, wrap(name))

    def close(self):
        self._tm.router_topk = self._gate
        for name in self.NAMES:
            delattr(self.model, name)

    def _find(self, toks, off, n) -> int:
        import numpy as np

        for r, p in enumerate(self.prompts):
            if len(p) >= off + n and np.array_equal(p[off:off + n], toks[:n]):
                return r
        return -1

    def _meta_prefill_paged_chunk(self, tokens, slot, q_offset, new_len,
                                  *a, **kw):
        import numpy as np

        n = int(new_len) - int(q_offset)
        req = self._find(np.asarray(tokens), int(q_offset), n)
        self.slot_req[int(slot)] = req
        return [(r, req, int(q_offset) + r, None) for r in range(n)]

    def _meta_prefill_batched(self, tokens, cache, *a, **kw):
        import numpy as np

        toks = np.asarray(tokens.cpu() if hasattr(tokens, "cpu") else tokens)
        out = []
        for b in range(toks.shape[0]):
            req = self._find(toks[b], 0, len(self.prompts[0]))
            self.slot_req[self._batched] = req
            self._batched += 1
            out += [(r, req, r, None) for r in range(toks.shape[1])]
        return out

    def _meta_decode_step(self, tokens, cache, *a, **kw):
        toks = [int(t) for t in tokens.tolist()]
        lens = [int(v) for v in cache.kv_len.tolist()]
        return [(b, self.slot_req.get(b, -1), lens[b], toks[b])
                for b in range(len(toks))]

    def _keep(self, calls, meta):
        import torch

        ids = torch.stack([c.expert_ids for c in calls[::self.n]]).cpu()
        ws = torch.stack([c.weights for c in calls[::self.n]]).cpu()
        for r, req, pos, tok in meta:
            # First record wins: an empty slot's later rows never replace
            # what its last request's forwards routed.
            if req >= 0:
                self.rows.setdefault((req, pos), (tok, ids[:, r], ws[:, r]))

    def _kept(self, req, seq) -> tuple:
        """(ids [L, S, k], weights [L, S, k], kept [S]) of ``seq``'s
        positions: kept where the run routed that position with that
        input token."""
        import torch

        k = self.model.cfg.num_experts_per_tok
        S = len(seq)
        ids = torch.zeros((self.L, S, k), dtype=torch.long)
        ws = torch.zeros((self.L, S, k))
        kept = torch.zeros(S, dtype=torch.bool)
        for pos in range(S):
            rec = self.rows.get((req, pos))
            if rec is not None and (rec[0] is None or rec[0] == int(seq[pos])):
                kept[pos] = True
                ids[:, pos], ws[:, pos] = rec[1], rec[2]
        return ids, ws, kept

    def gate(self, req, seq):
        """``_plain_forward``'s gate for request ``req``'s sequence
        ``seq``: the run's experts and combine weights where it kept the
        position, the plain gate's elsewhere."""
        import torch

        dev = self.model.device
        ids, ws, kept = (t.to(dev) for t in self._kept(req, seq))
        router = [p["layers"]["mlp"]["w_router"]
                  for p in self.model.rank_params][0]

        def at(i, h):
            cw = _moe_weights(self.model.cfg, router[i], h)[1]
            forced = torch.zeros_like(cw).scatter_(1, ids[i], ws[i])
            return torch.where(kept[:, None], forced, cw)
        return at

    def coverage(self, req, seq) -> float:
        """The share of ``seq``'s positions whose routing was kept."""
        return float(self._kept(req, seq)[2].float().mean())


class _LayerRecorder:
    """Records what the model's expert layers saw and gave in a forward:
    per call of ``_mlp_fwd`` (one a layer) the ranks' normed inputs and
    outputs, the routing of the ranks' gates (``router_topk`` of
    ``layers/tp_moe.py``) and rank 0's residual after the layer (the
    ``_block`` output)."""

    def __init__(self, model):
        import importlib

        self.model, self.calls, self._routes = model, [], None
        self._tm = importlib.import_module(
            "triton_distributed_tpu_torch.layers.tp_moe")
        self._inner_mlp, self._inner_gate = model._mlp_fwd, self._tm.router_topk
        self._inner_block = model._block

        def gate(*a, **kw):
            out = self._inner_gate(*a, **kw)
            if self._routes is not None:
                self._routes.append(out)
            return out

        def mlp(params, h, mode):
            self._routes = []
            out = self._inner_mlp(params, h, mode)
            self.calls.append({"h": [t.clone() for t in h],
                               "out": [t.clone() for t in out],
                               "routes": self._routes})
            self._routes = None
            return out

        def block(*a, **kw):
            out = self._inner_block(*a, **kw)
            self.calls[-1]["x_out"] = out[0].clone()
            return out

        model._mlp_fwd, self._tm.router_topk = mlp, gate
        model._block = block

    def close(self):
        self.model._mlp_fwd = self._inner_mlp
        self.model._block = self._inner_block
        self._tm.router_topk = self._inner_gate


def hold_moe_tp_layers(model, what, calls, shards, drop=None) -> dict:
    """The plain version held to the ``pallas`` forward layer by layer
    (PR 9's ``_ForcedGate`` method): for each recorded layer, on the
    kernel path's own normed input (every rank's bitwise the same), the
    plain gate must pick the experts the path's gate picked, up to a near
    tie (deficit <= MOE_TIE), with combine weights within MOE_WEIGHT_TOL;
    then the plain expert layer from the rank shards (each rank's SwiGLU
    on its own columns, the partials summed in f32) with the path's
    routing must move the residual to within MOE_TP_X_TOL of the path's
    residual after the layer (rtol on that residual), and every rank's
    output must be bitwise the same.
    ``drop=layer`` leaves rank 1's partial out at that layer (the negative
    control): its limit use is returned as ``control_use``."""
    import torch

    cfg = model.cfg
    k, atol, rtol = cfg.num_experts_per_tok, *MOE_TP_X_TOL
    L = cfg.num_layers
    use = deficit = w_err = 0.0
    flips, control = 0, None
    for j, c in enumerate(calls):
        i = j % L
        h = c["h"][0]
        if not all(torch.equal(t, h) for t in c["h"][1:]) or not all(
                torch.equal(t, c["out"][0]) for t in c["out"][1:]):
            raise RuntimeError(f"{what} layer {i}: the ranks' inputs or "
                               "outputs differ")
        route = c["routes"][0]
        kern = torch.zeros((h.shape[0], cfg.num_experts), device=h.device)
        kern.scatter_(1, route.expert_ids.long(), route.weights.float())
        probs, cw = _moe_weights(cfg, shards[0]["w_router"][i], h)
        kset, pset = kern != 0, cw != 0
        top = torch.sort(probs, dim=-1, descending=True, stable=True).values
        for r in (kset != pset).any(dim=1).nonzero().flatten().tolist():
            flips += 1
            deficit = max(deficit, (top[r, k - 1] - probs[r][
                kset[r] & ~pset[r]].min()).item())
        forced = torch.where(kset, probs, torch.zeros_like(probs))
        if cfg.norm_topk_prob:
            forced = forced / forced.sum(dim=-1, keepdim=True)
        w_err = max(w_err, (forced - kern).abs().max().item())
        ref = _moe_direct(cfg, shards, i, h, cw=kern)
        got = c["out"][0]
        lim = atol + rtol * c["x_out"].float().abs()
        use = max(use, ((got.float() - ref.float()).abs() / lim).max().item())
        if drop is not None and i == drop and control is None:
            bad = _moe_direct(cfg, shards, i, h, cw=kern, drop_rank=1)
            control = ((got.float() - bad.float()).abs() / lim).max().item()
    if deficit > MOE_TIE or w_err > MOE_WEIGHT_TOL or not use <= 1.0:
        raise RuntimeError(f"{what}: layer-by-layer hold broken: output "
                           f"limit use {use}, worst routing flip deficit "
                           f"{deficit}, combine weights off by {w_err}")
    rec = {"layers": len(calls), "limit_used": use, "routing_flips": flips,
           "worst_flip_deficit": deficit, "combine_weight_err": w_err}
    if control is not None:
        rec["control_use"] = control
    return rec


def check_moe_tp_layers(model) -> dict:
    """The layer-by-layer hold on one ``prefill_paged_chunk`` of each
    MOE_TP_CHUNKS width (random tokens, offset 0, a fresh pool) and on
    MOE_TP_DECODE_STEPS B=4 decode steps, mode ``pallas``; the negative
    control (rank 1's partial dropped at the middle layer of the 384-row
    chunk) must break the limit."""
    import numpy as np
    import torch

    from triton_distributed_tpu_torch.models.paged_kv_cache import (
        init_paged_cache,
    )

    cfg, dev = model.cfg, model.device
    shards = [p["layers"]["mlp"] for p in model.rank_params]
    rng = np.random.default_rng(SEED + 22)
    out = {}
    for c in MOE_TP_CHUNKS:
        cache, _ = init_paged_cache(cfg, 1, dev, max_length=MOE_TP_MAX_LENGTH,
                                    page_size=PAGE, tp=model.tp)
        toks = rng.integers(0, cfg.vocab_size, c).astype(np.int32)
        rec = _LayerRecorder(model)
        try:
            model.prefill_paged_chunk(toks, 0, 0, c, c - 1, cache, "pallas")
        finally:
            rec.close()
        drop = cfg.num_layers // 2 if c == 384 else None
        out[f"chunk{c}"] = hold_moe_tp_layers(model, f"chunk {c}", rec.calls,
                                              shards, drop)
        del cache
    cache, _ = init_paged_cache(cfg, 4, dev, max_length=MOE_TP_MAX_LENGTH,
                                page_size=PAGE, tp=model.tp)
    cache.kv_len[:] = 300
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, 4), device=dev,
                          dtype=torch.int32)
    rec = _LayerRecorder(model)
    try:
        for _ in range(MOE_TP_DECODE_STEPS):
            logits, cache = model.decode_step(tok, cache, "pallas")
            tok = logits.argmax(-1).to(torch.int32)
    finally:
        rec.close()
    out["decode"] = hold_moe_tp_layers(model, "decode", rec.calls, shards)
    control = out["chunk384"]["control_use"]
    print(f"[moe_tp] layer-by-layer hold: {json.dumps(out)}")
    if not control > 1.0:
        raise RuntimeError(f"the negative control (rank 1's partial dropped "
                           f"at layer {cfg.num_layers // 2}) kept the limit: "
                           f"{control}")
    return out


def serve_moe_tp_paths(dev, model) -> tuple:
    """Qwen3-30B-A3B at tp=2 (``model``: MOE_TP_LAYERS layers):
    ``continuous_moe_tp`` and ``paged_engine_moe_tp`` (two passes:
    MOE_TP_ENGINE_LENS rows), launches per path (each counted from 0 just
    before it), audits, the MoE ledger, teacher forcing against a plain
    full-sequence forward computed from the rank shards (bf16 limits), the
    layer-by-layer hold, and the step profile. Returns (launches by path,
    the e2e block, the paths' tokens)."""
    import numpy as np
    import torch

    from triton_distributed_tpu_torch.models import (
        ContinuousEngine,
        Engine,
        unshard_params,
    )
    from triton_distributed_tpu_torch.ops import cuda_kernels as ck

    t_start = time.perf_counter()
    cfg = model.cfg
    k, V = cfg.num_experts_per_tok, cfg.vocab_size
    rng = np.random.default_rng(SEED + 23)
    prompts = [rng.integers(0, V, n).astype(np.int32)
               for n in MOE_TP_PROMPT_LENS]
    engine_ids = [rng.integers(0, V, (2, n)).astype(np.int32)
                  for n in MOE_TP_ENGINE_LENS]
    warm = rng.integers(0, V, 24).astype(np.int32)
    launches, outs, e2e, engs, route_of = {}, {}, {}, {}, {}
    for path in ("continuous_moe_tp", "paged_engine_moe_tp"):
        if path == "continuous_moe_tp":
            eng = ContinuousEngine(model, max_batch=4, page_size=PAGE,
                                   max_length=MOE_TP_MAX_LENGTH,
                                   prefix_cache=True, mode="pallas",
                                   device=dev)
            eng.run([(warm, 2)])
        else:
            eng = Engine(model, mode="pallas", paged=True, page_size=PAGE,
                         device=dev)
            eng.serve(engine_ids[1][:, :24], 2, MOE_TP_MAX_LENGTH)
        engs[path] = eng
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        if path == "continuous_moe_tp":
            log = _RouteLog(model, prompts)
            try:
                outs[path] = eng.run([(p, MOE_TP_GEN) for p in prompts])
            finally:
                log.close()
            routed = [eng.last_stats]
            route_of[path] = [(log, r) for r in range(len(prompts))]
        else:
            outs[path], routed, route_of[path] = [], [], []
            for ids in engine_ids:
                log = _RouteLog(model, list(ids))
                try:
                    got = eng.serve(ids, MOE_TP_GEN, MOE_TP_MAX_LENGTH)
                finally:
                    log.close()
                outs[path] += [g[ids.shape[1]:] for g in got]
                routed.append(dict(eng.last_stats))
                route_of[path] += [(log, r) for r in range(len(ids))]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[path] = ck.launch_counts()
        if eng.audit():
            raise RuntimeError(f"{path}: pool audit failed: {eng.audit()}")
        ran = {name for name, c in launches[path].items() if c}
        if ran != set(MOE_TP_PATH_KERNELS[path]):
            raise RuntimeError(f"the {path} run launched {sorted(ran)}, "
                               f"expected {sorted(MOE_TP_PATH_KERNELS[path])}")
        # The ledger: every prefilled position and every decode position,
        # k assignments each (the traffic's arithmetic).
        if path == "continuous_moe_tp":
            st = routed[0]
            want = k * (sum(MOE_TP_PROMPT_LENS)
                        + len(prompts) * (MOE_TP_GEN - 1))
            got_r = st["moe_routed_tokens"]
            hits = st["prefix_hit_tokens"]
        else:
            want = k * sum(2 * (n + MOE_TP_GEN - 1)
                           for n in MOE_TP_ENGINE_LENS)
            got_r = sum(st["moe_routed_tokens"] for st in routed)
            hits = 0
        if got_r + k * hits != want or any(
                st["a2a_dropped"] for st in routed):
            raise RuntimeError(f"{path}: moe_routed_tokens {got_r} (prefix "
                               f"hits {hits}), want {want}")
        counts = {name: launches[path][name]
                  for name in MOE_TP_PATH_KERNELS[path]}
        e2e[path] = {"wall_s": wall, "launches": counts,
                     "moe_routed_tokens": got_r}
        print(f"[moe_tp] {path}: {wall:.2f} s wall, moe_routed_tokens "
              f"{got_r} (= {want} from the traffic), launches {counts}")
    marks = {"paths": time.perf_counter()}
    # Teacher forcing through a plain forward from the rank shards, its
    # experts routed as the run routed each position (MOE_TP_TF): the
    # routing itself is held by the layer-by-layer hold below.
    params = unshard_params(model.params, mlp=False)
    plain = _tp_plain_model(model, params)
    srcs = {"continuous_moe_tp": prompts,
            "paged_engine_moe_tp": [r for ids in engine_ids for r in ids]}
    for path, got in outs.items():
        gaps, free, cover = [], [], []
        for (log, req), p, o in zip(route_of[path], srcs[path], got):
            o = np.asarray(o)
            if o.shape != (MOE_TP_GEN,):
                raise RuntimeError(f"{path}: bad output {o.shape}")
            seq = np.concatenate([p, o[:-1]])
            cover.append(log.coverage(req, seq))
            gaps += teacher_forced_gaps(plain, p, o, gate=log.gate(req, seq))
            free += teacher_forced_gaps(plain, p, o)
        if min(cover) < 1.0:
            raise RuntimeError(f"{path}: the run's routing was kept for only "
                               f"{cover} of each request's positions")
        e2e[path]["teacher_forcing"] = _tf_check(
            f"{path} (tp={MOE_TP}, routed as the run)", gaps, TF_MARGIN,
            TF_MIN_EXACT)
        e2e[path]["teacher_forcing_free_routing"] = {
            "max_gap": max(free), "exact": sum(g == 0 for g in free),
            "tokens": len(free)}
        print(f"[moe_tp] {path}: teacher forcing with the plain gate's own "
              f"routing (a reading, PERF.md §2): max gap {max(free):.4f}, "
              f"exact {sum(g == 0 for g in free)}/{len(free)}")
    del params, plain, engs
    marks["teacher_forcing"] = time.perf_counter()
    e2e["layer_hold"] = check_moe_tp_layers(model)
    marks["layer_hold"] = time.perf_counter()
    e2e["step_profile"] = profile_tp_steps(model, steps=1, modes=("pallas",),
                                           tag="moe_tp")
    marks["step_profile"] = time.perf_counter()
    e2e["serve_marks_s"] = {k: v - t_start for k, v in marks.items()}
    return launches, e2e, outs


# The MoE megakernel at tp > 1 (queue 2 row 6(e), MoE half): mode="mega"
# over the two co-located ranks of the MoE-TP phase's Qwen3-30B-A3B in ONE
# cooperative launch of the MoE library's kTp build (tdt_mega_decode_tp),
# its experts expert-parallel (MegaQwen3.moe_params: 64 of the 128 experts a
# rank at full width, resharded from the model's TP layout, which the xla
# prefill keeps reading), the combine's A2A_SEND/A2A_WAIT puts and waits
# (or the last expert's handoff to ALLREDUCE without overlap_ar). The EP
# layout is a second copy of the experts beside the TP one, so the model
# runs MOE_TP_LAYERS of its 48 layers: 2 x 29.0 GB of experts at 24 layers
# (60.8 GB in all) where 48 would need 116 GB; the phase's pallas paths
# above share the same 24-layer model. Kernel vs plain (the EP lockstep
# walk, kernels.mega_decode_plain_tp) at B=4 over the paged bf16 pool,
# kv_len MOE_TP_MEGA_LENS, NS 1 and 8, overlap_ar on and off: the plain
# version held to the kernel layer by layer (_ForcedGate on rank 0's
# moe_route and moe_x records, _moe_rows_ok under the MoE phase's limits:
# routing flips only at a near tie <= MOE_TIE, combine weights within
# MOE_WEIGHT_TOL, residuals within MOE_X_TOL, logits within MEGA_TOL),
# every rank's records, tokens
# and final residual bitwise equal; the negative control drops rank 1's
# phase-0 combine partial at layer 12 on the plain side and must break the
# residual hold; a 500 us lag on rank 1 must leave the outputs bit-identical
# and the launch >= 0.5 ms longer; MOE_TP_MEGA_STRESS launches back to back
# on fresh tokens, each held; f32 at MOE_TP_MEGA_F32_LAYERS layers: tokens
# equal, logits within 2e-3. Then the serving paths
# (MOE_TP_MEGA_PATH_KERNELS) on the pallas paths' prompts, each held by
# teacher forcing against the plain forward routed as the run routed (the
# prefill from the xla path's gates, the decode from the kernel's own
# records), the MoE ledger and audit.
MOE_TP_LAYERS = 24
MOE_TP_MEGA_LENS = (300, 700, 300, 700)
MOE_TP_MEGA_NS = (1, 8)
MOE_TP_MEGA_DROP = (12, 1, 0)  # (layer, rank, A2A phase) of the control
MOE_TP_MEGA_STRESS = 20
MOE_TP_MEGA_LAG_NS = 500_000
MOE_TP_MEGA_NSTEP = 8
MOE_TP_MEGA_EOS_AT = 8
MOE_TP_MEGA_F32_LAYERS = 2
MOE_TP_MEGA_PATH_KERNELS = {
    # Prefill runs xla (attention through flash_attention, the experts and
    # collectives plain torch); every decode step is one launch of the
    # MoE tp megakernel (ns=8, its single-step remainders included).
    "continuous_moe_tp_mega": ("flash_attention", "mega_decode_moe_tp"),
    "continuous_moe_tp_mega_resident": ("flash_attention",
                                        "mega_decode_moe_tp"),
    "paged_engine_moe_tp_mega": ("flash_attention", "mega_decode_moe_tp"),
}
MOE_TP_MEGA_SPLIT_OPS = ("BARRIER", "EMBED", "QKV_PROJ", "ATTN", "O_PROJ",
                         "AR_SEND", "AR_WAIT", "ALLREDUCE", "MOE_GATE",
                         "MOE_FFN", "A2A_SEND", "A2A_WAIT", "LM_HEAD")


def _moe_tp_bound(model, ep, routed, lens) -> dict:
    """The least time of one MoE decode step at tp=n over ``lens``: the
    larger of its bytes over the HBM rate and its FLOPs over the bf16 peak.
    Bytes: every rank's attention shards, router, norms and LM-head columns
    and the embed rows it reads, the weights of the experts ``routed``
    names (the distinct experts the step's rows route to at each layer,
    each held by one rank), every cached K/V row (each rank its kv heads),
    the logits and the new K/V rows. FLOPs: each rank's attention GEMMs,
    router and LM head for every row, each row's k experts, QK^T and P·V
    over each row's cache."""
    cfg = model.cfg
    b, L, hd = len(lens), cfg.num_layers, cfg.head_dim
    d, f = cfg.hidden_size, cfg.moe_intermediate_size
    item = cfg.dtype.itemsize
    per_rank = 0
    for p in ep:
        lp = p["layers"]
        per_rank += sum(t.numel() for t in (
            lp["attn"]["wqkv"], lp["attn"]["wo"], lp["mlp"]["w_router"],
            p["lm_head"], lp["ln1"], lp["ln2"], lp["attn"]["q_norm"],
            lp["attn"]["k_norm"], p["norm"])) * item + b * d * item
    gemm = sum(ep[0]["layers"][k1][k2].numel() for k1, k2 in (
        ("attn", "wqkv"), ("attn", "wo"), ("mlp", "w_router")))
    expert = 3 * d * f
    kv = 2 * L * sum(lens) * cfg.num_kv_heads * hd * item
    out = (b * ep[0]["lm_head"].shape[1] * 4 * model.tp
           + 2 * L * b * cfg.num_kv_heads * hd * item)
    flops = 2 * b * (model.tp * gemm + model.tp * ep[0]["lm_head"].numel()
                     + cfg.num_experts_per_tok * L * expert) + 4 * (
        cfg.num_q_heads * hd * L * sum(lens))

    def bound(n_experts):
        nbytes = per_rank + kv + out + n_experts * expert * item
        t_bytes, t_ops = nbytes / HBM_BPS, flops / BF16_FLOPS
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations", nbytes)

    ms, by, nbytes = bound(sum(routed))
    all_ms, _, _ = bound(cfg.num_experts * L)
    return {"bound_ms": ms, "bound_by": by, "bound_bytes": nbytes,
            "all_expert_bound_ms": all_ms,
            "routed_experts_per_layer": sum(routed) / L}


def _moe_tp_records(model, dims, dev):
    """Zeroed per-rank routing records of a launch: moe_route [n, NS, L, E,
    B] and moe_x [n, NS, L, B, d] f32."""
    import torch

    cfg, n = model.cfg, model.tp
    lead = (n, dims.nsteps, cfg.num_layers)
    return (torch.zeros(lead + (cfg.num_experts, dims.batch),
                        dtype=torch.float32, device=dev),
            torch.zeros(lead + (dims.batch, dims.d), dtype=torch.float32,
                        device=dev))


def _moe_tp_ranks_equal(info, route, x_rec, what) -> None:
    import torch

    for r in range(1, MOE_TP):
        for name, t in (("toks", info["toks"]), ("x", info["x"]),
                        ("moe_route", route), ("moe_x", x_rec)):
            if not torch.equal(t[r], t[0]):
                raise RuntimeError(f"{what}: rank {r}'s {name} differs from "
                                   "rank 0's")


def _moe_tp_hold(comp, w, args, got, route, x_rec, what, **plain_kw):
    """The plain EP walk held to one kernel launch layer by layer
    (``_ForcedGate`` on rank 0's records, ``_moe_rows_ok``): returns (the
    rows' record, the gate log)."""
    import dataclasses

    from triton_distributed_tpu_torch.megakernel.kernels import (
        mega_decode_plain_tp,
    )

    dims = comp.builder.dims
    forced = (route[0], x_rec[0], dims.moe_top_k, dims.norm_topk)
    fg = _ForcedGate(*forced)
    ref = mega_decode_plain_tp(dims, True, comp.table, w, *args,
                               gate_hook=fg, **plain_kw)

    def plain_at(s):
        return mega_decode_plain_tp(dataclasses.replace(dims, nsteps=s + 1),
                                    True, comp.table, w, *args,
                                    gate_hook=_ForcedGate(*forced),
                                    **plain_kw)[0]

    atol, rtol = MEGA_TOL["bf16"]
    return _moe_rows_ok(got, ref, fg, plain_at, atol, rtol, what), fg


def check_moe_tp_mega_f32(dev) -> dict:
    """The MoE megakernel at tp=2 at Qwen3-30B-A3B width,
    MOE_TP_MEGA_F32_LAYERS layers, in f32 with TF32 off, over a paged f32
    pool, NS 1 and 8: tokens equal to the plain EP walk's, logits within
    MEGA_TOL f32, ranks bitwise equal; rank 1's phase-0 partial dropped at
    layer 0 must break the limit."""
    import dataclasses

    import torch

    from triton_distributed_tpu_torch.megakernel import (
        MegaConfig,
        MegaQwen3,
    )
    from triton_distributed_tpu_torch.megakernel.kernels import (
        mega_decode_plain_tp,
    )
    from triton_distributed_tpu_torch.megakernel.qwen3 import _weights
    from triton_distributed_tpu_torch.models import AutoLLM

    model = AutoLLM.from_pretrained(MOE_MODEL, device=dev, seed=SEED,
                                    tp=MOE_TP, dtype=torch.float32,
                                    num_layers=MOE_TP_MEGA_F32_LAYERS)
    V, b = model.cfg.vocab_size, len(MOE_TP_MEGA_LENS)
    args = _tp_mega_operands(model, MOE_TP_MEGA_LENS, SEED + 31,
                             MOE_TP_MAX_LENGTH)
    mega = MegaQwen3(model, cfg=MegaConfig(
        fuse_norms=True, cross_prefetch=True, overlap_ar=True))
    w = _weights(mega._step_params())
    atol, _ = MEGA_TOL["f32"]
    out = {}
    for ns in MOE_TP_MEGA_NS:
        dims = dataclasses.replace(
            mega._dims(b, MOE_TP_MAX_LENGTH, PAGE,
                       num_pages=int(args[0][0].shape[1])),
            nsteps=ns, v_real=V)
        comp = mega._compile(dims)
        info = {}
        route, x_rec = _moe_tp_records(model, dims, dev)
        got = comp.run(w, *args, info=info, moe_route=route, moe_x=x_rec)
        torch.cuda.synchronize()
        _moe_tp_ranks_equal(info, route, x_rec, f"moe tp f32 NS={ns}")
        ref = mega_decode_plain_tp(dims, True, comp.table, w, *args)
        bad = mega_decode_plain_tp(dims, True, comp.table, w, *args,
                                   drop_partial=(0, 1, 0))[0]
        err = (got[0] - ref[0]).abs()
        used = (err / atol).max().item()
        bad_used = ((got[0] - bad).abs() / atol).max().item()
        same = torch.equal(got[3], ref[3])
        print(f"[moe_tp_mega] f32 {MOE_TP_MEGA_F32_LAYERS} layers NS={ns}: "
              f"tokens == plain {same}, ranks bitwise equal, logits "
              f"max_abs_err {err.max().item():.3e} ({used:.3f} of the limit "
              f"{atol}); rank 1's phase-0 partial dropped at layer 0: "
              f"{bad_used:.1f}x the limit")
        if not same or not used <= 1.0 or not bad_used > 1.0:
            raise RuntimeError(f"mega_decode_moe_tp f32 NS={ns}: tokens "
                               f"equal {same}, limit use {used}, control "
                               f"{bad_used}")
        out[f"ns{ns}"] = {"max_abs_err": err.max().item(),
                          "limit_used": used, "control_limit_used": bad_used}
    del model, mega, w, args
    return out


def check_moe_tp_mega_kernels(dev, flush, model, f32) -> dict:
    """The MoE tp megakernel against its plain version on ``model`` (see the
    constants above), timed; returns the record of ``mega_decode_moe_tp``
    (``f32``: check_moe_tp_mega_f32's readings)."""
    import dataclasses

    import numpy as np
    import torch

    from triton_distributed_tpu_torch.megakernel import (
        MegaConfig,
        MegaQwen3,
    )
    from triton_distributed_tpu_torch.megakernel.kernels import (
        mega_decode_plain_tp,
    )
    from triton_distributed_tpu_torch.megakernel.qwen3 import _weights
    from triton_distributed_tpu_torch.megakernel.task import TaskType
    from triton_distributed_tpu_torch.obs import kernel_trace as kt

    cfg = model.cfg
    b, V, L = len(MOE_TP_MEGA_LENS), cfg.vocab_size, cfg.num_layers
    args = _tp_mega_operands(model, MOE_TP_MEGA_LENS, SEED + 32,
                             MOE_TP_MAX_LENGTH)
    t0 = time.perf_counter()
    megas = {ov: MegaQwen3(model, cfg=MegaConfig(
        fuse_norms=True, cross_prefetch=ov, overlap_ar=ov))
        for ov in (True, False)}
    ep = megas[True].moe_params()
    torch.cuda.synchronize()
    print(f"[moe_tp_mega] TP -> EP reshard in {time.perf_counter() - t0:.1f}"
          f" s; {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
    w = _weights(ep)
    rec = {"rows": {}, "ms_per_launch": {}, "plain_ms_per_launch": {},
           "split_ms_per_step": {}, "launch_stats": {}}
    comps, logs, max_err, info = {}, {}, 0.0, {}
    for overlap in (True, False):
        for ns in MOE_TP_MEGA_NS:
            dims = dataclasses.replace(
                megas[overlap]._dims(b, MOE_TP_MAX_LENGTH, PAGE,
                                     num_pages=int(args[0][0].shape[1])),
                nsteps=ns, v_real=V)
            comp = comps[overlap, ns] = megas[overlap]._compile(dims)
            route, x_rec = _moe_tp_records(model, dims, dev)
            info = {}
            got = comp.run(w, *args, info=info, moe_route=route, moe_x=x_rec)
            again = comp.run(w, *args)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise RuntimeError(f"mega_decode_moe_tp NS={ns}: two "
                                   "launches on the same inputs differ")
            what = f"mega_decode_moe_tp bf16 NS={ns} overlap_ar={overlap}"
            _moe_tp_ranks_equal(info, route, x_rec, what)
            rows, fg = _moe_tp_hold(comp, w, args, got, route, x_rec, what)
            max_err = max(max_err, rows["max_abs_err"])
            key = f"ns{ns}_overlap{int(overlap)}"
            rec["rows"][key] = rows
            logs[overlap, ns] = (route, x_rec, fg)
            rec["launch_stats"][key] = _moe_launch_stats(fg, ns, L)
            info = {k: info[k] for k in ("blocks", "smem_bytes",
                                         "blocks_per_sm") if k in info}
            ms = median_ms(lambda: comp.run(w, *args), flush, iters=7)
            rec["ms_per_launch"][key] = ms
            if overlap and ns == 1:
                rec["plain_ms_per_launch"][f"ns{ns}"] = median_ms(
                    lambda: mega_decode_plain_tp(dims, True, comp.table, w,
                                                 *args),
                    flush, iters=3, warmup=1)
            print(f"[moe_tp_mega] {what}: ranks bitwise equal (records, "
                  f"tokens, residual); held layer by layer: "
                  f"{json.dumps({k: v for k, v in rows.items() if k != 'ties'})}"
                  f"; {ms:.4f} ms per launch ({ms / ns:.4f} a step); launch "
                  f"{info}")
    # The negative control: rank 1's phase-0 combine partial dropped at
    # layer 12 on the plain side must break the residual hold.
    control = {}
    for ns in MOE_TP_MEGA_NS:
        comp = comps[True, ns]
        route, x_rec, _ = logs[True, ns]
        fg = _ForcedGate(route[0], x_rec[0], cfg.num_experts_per_tok,
                         cfg.norm_topk_prob)
        mega_decode_plain_tp(comp.builder.dims, True, comp.table, w, *args,
                             gate_hook=fg, drop_partial=MOE_TP_MEGA_DROP)
        control[ns] = fg.x_use[:, MOE_TP_MEGA_DROP[0] + 1:].max().item()
    print(f"[moe_tp_mega] control (rank {MOE_TP_MEGA_DROP[1]}'s phase-"
          f"{MOE_TP_MEGA_DROP[2]} partial dropped at layer "
          f"{MOE_TP_MEGA_DROP[0]}): the next gate's residual at "
          + ", ".join(f"NS={k} {v:.1f}x" for k, v in control.items())
          + " MOE_X_TOL (each must exceed 1)")
    if min(control.values()) <= 1.0:
        raise RuntimeError(f"moe tp megakernel control at {control}")
    comp = comps[True, 1]
    dims = comp.builder.dims
    got = comp.run(w, *args)
    # The straggler: bit-identical, the launch >= 0.5 ms longer.
    lag = megas[True]._compile(dataclasses.replace(
        dims, straggler_rank=1, straggler_nanos=MOE_TP_MEGA_LAG_NS))
    slow = lag.run(w, *args)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, slow)):
        raise RuntimeError("the lagged MoE tp launch's outputs differ")
    base_ms = median_ms(lambda: comp.run(w, *args), flush, iters=5)
    lag_ms = median_ms(lambda: lag.run(w, *args), flush, iters=5)
    print(f"[moe_tp_mega] straggler (rank 1 lags {MOE_TP_MEGA_LAG_NS} ns): "
          f"outputs bit-identical, {lag_ms:.4f} ms against {base_ms:.4f}")
    if lag_ms < base_ms + MOE_TP_MEGA_LAG_NS / 1e6:
        raise RuntimeError("the straggler did not lengthen the launch")
    # Back to back on fresh tokens, every launch held.
    rng = np.random.default_rng(SEED + 33)
    runs = []
    for _ in range(MOE_TP_MEGA_STRESS):
        tok = torch.from_numpy(rng.integers(0, V, b).astype(np.int32)).to(
            dev)
        route, x_rec = _moe_tp_records(model, dims, dev)
        i = {}
        runs.append((tok, comp.run(w, *args[:4], tok, info=i,
                                   moe_route=route, moe_x=x_rec),
                     i, route, x_rec))
    torch.cuda.synchronize()
    stress_used = 0.0
    for tok, out, i, route, x_rec in runs:
        _moe_tp_ranks_equal(i, route, x_rec, "stress")
        rows, _ = _moe_tp_hold(comp, w, (*args[:4], tok), out, route,
                               x_rec, "stress launch")
        stress_used = max(stress_used, rows["limit_used"])
    print(f"[moe_tp_mega] {MOE_TP_MEGA_STRESS} launches back to back on "
          f"fresh tokens: each held layer by layer (logits at most "
          f"{stress_used:.3f} of the limit), ranks bitwise equal")
    # Traced: == untraced, each rank's ring valid with one A2A window per
    # layer and step; the step split by opcode.
    for ns in MOE_TP_MEGA_NS:
        comp = comps[True, ns]
        tcomp = megas[True]._compile(dataclasses.replace(
            comp.builder.dims, trace=True))
        base = comp.run(w, *args)
        launches = []
        for _ in range(5):
            flush.zero_()
            torch.cuda._sleep(LEAD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            tout = tcomp.run(w, *args)
            end.record()
            end.synchronize()
            launches.append((start.elapsed_time(end), tout))
        if not all(torch.equal(x, y) for x, y in zip(base, launches[0][1])):
            raise RuntimeError(f"traced MoE tp launch NS={ns} differs from "
                               "the untraced one")
        event_ms, tout = sorted(launches, key=lambda x: x[0])[2]
        ring = tout[5].cpu().numpy()
        records = kt.decode_trace(ring)
        problems = kt.validate_ring(records, tcomp.order)
        windows = kt.overlap_report(records)["a2a_windows"]
        mids = [r for r in records if r.opcode in (
            int(TaskType.A2A_SEND), int(TaskType.A2A_WAIT))]
        if (ring.shape[0] != MOE_TP or problems
                or windows != L * ns * MOE_TP
                or not all(r.begin <= r.mid <= r.end for r in mids)):
            raise RuntimeError(f"traced MoE tp launch NS={ns}: rings "
                               f"{ring.shape}, problems {problems[:5]}, "
                               f"a2a windows {windows}")
        mine = [r for r in records if r.rank == 0]
        span = max(r.end for r in mine) - min(r.begin for r in mine)
        split = {}
        for r in mine:
            split[r.op] = split.get(r.op, 0.0) + r.dur * event_ms / span / ns
        rec["split_ms_per_step"][ns] = {
            "event_ms_per_launch": event_ms,
            **{op: split.get(op, 0.0) for op in MOE_TP_MEGA_SPLIT_OPS}}
        print(f"[moe_tp_mega] traced NS={ns}: == untraced bit for bit, "
              f"{MOE_TP} rings of {len(records) // MOE_TP} records validate, "
              f"{windows // MOE_TP} A2A windows a rank; rank 0's split per "
              f"step {json.dumps(rec['split_ms_per_step'][ns])}")
    # The bound of the NS=1 launch timed above: its distinct routed experts.
    routed = [logs[True, 1][2].routed[0, l] for l in range(L)]
    bound = _moe_tp_bound(model, ep, routed, MOE_TP_MEGA_LENS)
    ms1 = rec["ms_per_launch"]["ns1_overlap1"]
    print(f"[moe_tp_mega] {ms1:.4f} ms a step at NS=1, "
          f"{rec['ms_per_launch']['ns8_overlap1'] / 8:.4f} in an NS=8 "
          f"launch; bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}, "
          f"{bound['routed_experts_per_layer']:.1f} routed experts a layer; "
          f"every expert: {bound['all_expert_bound_ms']:.4f} ms); plain "
          f"{rec['plain_ms_per_launch']['ns1']:.2f} ms")
    del megas, ep, w, comps, logs, runs
    return dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/megakernel_moe.cu",
        replaces="triton_distributed_tpu/megakernel/kernels.py:1254",
        max_abs_err=max_err, ms=ms1,
        plain_ms=rec["plain_ms_per_launch"]["ns1"], library_ms=None,
        **bound,
        shape=f"{MOE_MODEL} tp={MOE_TP}, {L} of 48 layers, B={b}, paged "
              f"page={PAGE}, kv_len {list(MOE_TP_MEGA_LENS)}, NS=1 bf16 (ms "
              "= one step), the serving config (fused norms, overlap_ar); "
              "the EP bodies kernels.py:1254 a2a_send, :1297 a2a_wait with "
              ":442 _a2a_put_dmas, :469 _a2a_wait_recvs",
        ms_per_step_ns8=rec["ms_per_launch"]["ns8_overlap1"] / 8,
        control_x_use=control, straggler_ms=[base_ms, lag_ms],
        stress_limit_used=stress_used, f32=f32, launch=info, **rec)


class _MegaRouteLog(_RouteLog):
    """``_RouteLog`` over a ``mode="mega"`` run: the prefill's routing from
    the xla path's gates, as there, and each MoE megakernel launch's from
    the kernel's own records (``moe_route``, rank 0's: every rank's is
    bitwise the same), with the slots' requests as the launch was issued.
    Row b of a launch is slot b; its step s routes position ``kv_len[b] +
    s`` with input token ``tokens[b]`` (s = 0) or the launch's own step
    s - 1 winner. A launch of another graph passes through."""

    def __init__(self, model, prompts):
        from triton_distributed_tpu_torch.megakernel import (
            code_generator as cg,
        )

        super().__init__(model, prompts)
        self._cg, self._call, self.launches = cg, cg.MegaCall.__call__, []
        log = self

        def call(mc, w, kc, vc, page_table, kv_len, tokens, *a, **kw):
            if not mc.dims.moe:
                return log._call(mc, w, kc, vc, page_table, kv_len, tokens,
                                 *a, **kw)
            route, x_rec = _moe_tp_records(model, mc.dims, kv_len.device)
            out = log._call(mc, w, kc, vc, page_table, kv_len, tokens, *a,
                            moe_route=route, moe_x=x_rec, **kw)
            # Device copies in stream order: no host sync on the issue path.
            log.launches.append((kv_len.clone(), tokens.clone(), out[3],
                                 route[0], dict(log.slot_req)))
            return out

        cg.MegaCall.__call__ = call

    def close(self):
        self._cg.MegaCall.__call__ = self._call
        super().close()
        k = self.model.cfg.num_experts_per_tok
        for kv_len, tokens, toks, route, slots in self.launches:
            kv_len, tokens, toks = kv_len.tolist(), tokens.tolist(), toks.cpu()
            top = route.topk(k, dim=2)  # route [NS, L, E, B] -> [NS, L, k, B]
            ids, ws = top.indices.cpu(), top.values.cpu()
            for s in range(route.shape[0]):
                for b, req in slots.items():
                    if req < 0 or b >= len(kv_len):
                        continue
                    tok = tokens[b] if s == 0 else int(toks[s - 1, b])
                    self.rows.setdefault((req, kv_len[b] + s),
                                         (tok, ids[s, :, :, b],
                                          ws[s, :, :, b]))
        self.launches = []


def serve_moe_tp_mega_paths(dev, model, pallas_outs) -> tuple:
    """The MoE megakernel's paths at tp=2 on ``model``
    (MOE_TP_MEGA_PATH_KERNELS) over the pallas paths' prompts:
    ContinuousEngine(mode="mega", ns=8, prefix_cache=True, eos_id=...), the
    same resident and traced (every rank's ring validated against the
    scheduled order and its doorbell, with one A2A window per layer and
    step; how many of its requests emit the untraced path's tokens is a
    reading: the xla prefill's combine sums in no fixed order), and
    Engine(mode="mega", paged=True) on the two 300-token rows. Each path,
    from launch counts of 0: audit, the MoE ledger against the traffic's
    arithmetic, the megakernel's launches one per ns-step launch and single
    step, teacher forcing against the plain forward routed as the run
    routed. Returns (launches by path, e2e)."""
    import numpy as np
    import torch

    from triton_distributed_tpu_torch.models import (
        ContinuousEngine,
        Engine,
        unshard_params,
    )
    from triton_distributed_tpu_torch.obs import events as obs_events
    from triton_distributed_tpu_torch.obs import kernel_trace as kt
    from triton_distributed_tpu_torch.ops import cuda_kernels as ck

    cfg = model.cfg
    k, V, L = cfg.num_experts_per_tok, cfg.vocab_size, cfg.num_layers
    rng = np.random.default_rng(SEED + 23)
    prompts = [rng.integers(0, V, n).astype(np.int32)
               for n in MOE_TP_PROMPT_LENS]
    engine_ids = [rng.integers(0, V, (2, n)).astype(np.int32)
                  for n in MOE_TP_ENGINE_LENS]
    ids = engine_ids[0]
    streams = pallas_outs["continuous_moe_tp"]
    eos = int(streams[0][MOE_TP_MEGA_EOS_AT])
    if any(int(o[0]) == eos for o in streams):
        # The random model may emit one token throughout: then the stop
        # test runs every step on an id no request emits, and never fires.
        seen = {int(t) for o in streams for t in o}
        eos = next(v for v in range(V - 1, -1, -1) if v not in seen)
    kw = dict(max_batch=4, page_size=PAGE, max_length=MOE_TP_MAX_LENGTH,
              mode="mega", ns=MOE_TP_MEGA_NSTEP, eos_id=eos, device=dev)
    runs = {
        "continuous_moe_tp_mega": lambda: ContinuousEngine(
            model, prefix_cache=True, **kw),
        "continuous_moe_tp_mega_resident": lambda: ContinuousEngine(
            model, prefix_cache=True, resident=True, kernel_trace=True,
            **kw),
        "paged_engine_moe_tp_mega": lambda: Engine(
            model, mode="mega", paged=True, page_size=PAGE, device=dev),
    }
    warm = rng.integers(0, V, 24).astype(np.int32)
    launches, outs, e2e, logs = {}, {}, {}, {}
    for path, make in runs.items():
        eng = make()
        timer, single = None, [0]
        if path == "paged_engine_moe_tp_mega":
            eng.serve(ids[:, :24], 2, MOE_TP_MAX_LENGTH)
            src = list(ids)
        else:
            eng.run([(warm, 2)])
            timer = _LaunchTimer(eng)
            inner_once = eng._decode_once

            def once(eng=eng, inner_once=inner_once):
                single[0] += sum(r is not None for r in eng._slots)
                return inner_once()
            eng._decode_once = once
            src = prompts
        torch.cuda.synchronize()
        ev0 = obs_events.default_ring().next_seq - 1
        log = logs[path] = _MegaRouteLog(model, src)
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            if path == "paged_engine_moe_tp_mega":
                got = eng.serve(ids, MOE_TP_GEN, MOE_TP_MAX_LENGTH,
                                ns=MOE_TP_MEGA_NSTEP)
                outs[path] = [g[ids.shape[1]:] for g in got]
            else:
                outs[path] = eng.run([(p, MOE_TP_GEN) for p in prompts])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[path] = ck.launch_counts()
        finally:
            log.close()
        if eng.audit():
            raise RuntimeError(f"{path}: pool audit failed: {eng.audit()}")
        st = eng.last_stats
        n_launch = st.get("mega_launches", 0)
        if path == "paged_engine_moe_tp_mega":
            singles = MOE_TP_GEN - 1 - n_launch * MOE_TP_MEGA_NSTEP
            want_r = k * 2 * (ids.shape[1] + MOE_TP_GEN - 1)
        else:
            singles = st.get("mega_fallback_steps", 0)
            events, dropped = obs_events.default_ring().tail(ev0)
            if dropped:
                raise RuntimeError(f"{path}: {dropped} engine events lost")
            positions = single[0] + sum(
                e.fields["ns"] * e.fields["active"] for e in events
                if e.kind == "mega:launch")
            want_r = k * (st["prefill_tokens"] + positions)
        counts = {c: launches[path][c] for c in MOE_TP_MEGA_PATH_KERNELS[path]}
        ran = {c for c, n in launches[path].items() if n}
        print(f"[moe_tp_mega] {path}: {wall:.2f} s wall, launches {counts} "
              f"({n_launch} ns={MOE_TP_MEGA_NSTEP} launches + {singles} "
              f"single steps), moe_routed_tokens {st['moe_routed_tokens']} "
              f"(want {want_r}), a2a_dropped {st['a2a_dropped']}")
        if ran != set(counts) or counts["mega_decode_moe_tp"] != (
                n_launch + singles):
            raise RuntimeError(f"{path}: launched {sorted(ran)}, {counts}; "
                               f"{n_launch + singles} megakernel launches "
                               "expected")
        if st["moe_routed_tokens"] != want_r or st["a2a_dropped"] != 0:
            raise RuntimeError(f"{path}: MoE ledger {st['moe_routed_tokens']}"
                               f" routed, want {want_r}")
        e2e[path] = {"wall_s": wall, "launches": counts,
                     "mega_launches": n_launch, "single_steps": singles,
                     "moe_routed_tokens": st["moe_routed_tokens"]}
        if timer is not None:
            e2e[path]["launch_device_ms_per_step"] = (
                timer.device_ms() / max(n_launch * MOE_TP_MEGA_NSTEP, 1))
        if path == "continuous_moe_tp_mega_resident":
            # A reading, not a check: both paths prefill through the xla
            # MoE layer, whose combine (index_add_, atomic on the card)
            # sums in no fixed order, so the two runs' caches may differ
            # in the last bits and this flat-logit random model may then
            # pick another token. Each path is held by teacher forcing.
            same = sum(list(a) == list(b) for a, b in zip(
                outs[path], outs["continuous_moe_tp_mega"]))
            e2e[path]["requests_equal_to_continuous"] = same
            order = eng._mega_model().multi_task_order(
                4, MOE_TP_MAX_LENGTH, MOE_TP_MEGA_NSTEP, page=PAGE,
                num_pages=eng.cache.num_pages, valid_arg=True, trace=True,
                eos=True, ring=True)
            rings = eng.kernel_trace_launches()
            windows = []
            for ln in rings:
                recs = ln.get_records()
                problems = kt.validate_ring(recs, order, doorbell=ln.doorbell)
                windows.append(kt.overlap_report(recs)["a2a_windows"])
                if (ln.ring.shape[0] != MOE_TP or problems
                        or windows[-1] != L * ln.nsteps * MOE_TP):
                    raise RuntimeError(f"{path}: ring {ln.ring.shape}, "
                                       f"problems {problems[:5]}, a2a "
                                       f"windows {windows[-1]}")
            print(f"[moe_tp_mega] {path}: {same} of {len(prompts)} requests'"
                  f" tokens == continuous_moe_tp_mega's (a reading: the xla "
                  f"prefill's combine is atomic), {len(rings)} recent "
                  f"launches' {MOE_TP} rings validate "
                  f"against the order and their doorbells, A2A windows "
                  f"{windows} (L·NS = {L * MOE_TP_MEGA_NSTEP} a rank); "
                  f"{st['mega_resident_rounds']} resident rounds")
            e2e[path].update(resident_rounds=st["mega_resident_rounds"],
                             a2a_windows=windows)
    # Teacher forcing through the plain forward from the rank shards, its
    # experts routed as each run routed each position.
    params = unshard_params(model.params, mlp=False)
    plain = _tp_plain_model(model, params)
    for path, got in outs.items():
        log = logs[path]
        src = list(ids) if path == "paged_engine_moe_tp_mega" else prompts
        gaps, cover, eos_hits = [], [], 0
        for req, (p, o) in enumerate(zip(src, got)):
            o = np.asarray(o)
            eos_hits += int(len(o) < MOE_TP_GEN)
            if not (o.shape == (MOE_TP_GEN,) or (
                    path != "paged_engine_moe_tp_mega" and 0 < len(o)
                    < MOE_TP_GEN and int(o[-1]) == eos)):
                raise RuntimeError(f"{path}: bad output {o.shape}")
            seq = np.concatenate([p, o[:-1]])
            cover.append(log.coverage(req, seq))
            gaps += teacher_forced_gaps(plain, p, o, gate=log.gate(req, seq))
        if min(cover) < 1.0:
            raise RuntimeError(f"{path}: the run's routing was kept for only "
                               f"{cover} of each request's positions")
        e2e[path]["teacher_forcing"] = _tf_check(
            f"{path} (tp={MOE_TP}, routed as the run)", gaps, TF_MARGIN,
            TF_MIN_EXACT)
        e2e[path]["eos_stops"] = eos_hits
    e2e["eos_id"] = eos
    e2e["eos_vacuous"] = all(
        int(t) != eos for o in outs["continuous_moe_tp_mega"] for t in o)
    print(f"[moe_tp_mega] eos_id {eos}: "
          + ("never emitted (the random model repeats one token): the "
             "stop test ran every step and the eos check is vacuous"
             if e2e["eos_vacuous"] else "emitted, the stop test fired"))
    del params, plain, logs
    return launches, e2e


def check_moe_tp(dev):
    """Phase 6: tensor-parallel Qwen3-MoE. The collective kernels' checks
    and timings, tiny-moe card == CPU, the MoE tp megakernel in f32 at 2
    layers, then Qwen3-30B-A3B at tp=2 and MOE_TP_LAYERS layers: the
    pallas paths, then the MoE megakernel at tp=2 on the same model (its
    kernel checks and paths). Returns (records by kernel, launches by
    path, the e2e block)."""
    import gc

    import torch

    from triton_distributed_tpu_torch.models import AutoLLM

    # The TP phase's model lives on in its engines' reference cycles until
    # a collection.
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[moe_tp] {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
          "allocated at the start of the phase")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    t0 = time.perf_counter()
    records = check_moe_tp_kernels(dev, flush)
    del flush
    t1 = time.perf_counter()
    launches = check_moe_tp_tiny(dev)
    t2 = time.perf_counter()
    f32 = check_moe_tp_mega_f32(dev)
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    model = AutoLLM.from_pretrained(MOE_MODEL, device=dev, seed=SEED,
                                    tp=MOE_TP, num_layers=MOE_TP_LAYERS)
    torch.cuda.synchronize()
    print(f"[moe_tp] {MOE_MODEL} random init at tp={MOE_TP} on {dev} in "
          f"{time.perf_counter() - t3:.1f} s ({model.cfg.num_layers} of 48 "
          f"layers, hq_loc {model.dims.hq_loc}, hkv_loc {model.dims.hkv_loc},"
          f" f_loc {model.cfg.moe_intermediate_size // MOE_TP}; "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated)")
    more, e2e, outs = serve_moe_tp_paths(dev, model)
    launches.update(more)
    t4 = time.perf_counter()
    print(f"[time] moe_tp pallas paths: {t4 - t3:.1f} s", flush=True)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    records["mega_decode_moe_tp"] = check_moe_tp_mega_kernels(dev, flush,
                                                              model, f32)
    del flush
    t5 = time.perf_counter()
    print(f"[time] moe_tp megakernel checks: {t5 - t4:.1f} s", flush=True)
    more, e2e["mega"] = serve_moe_tp_mega_paths(dev, model, outs)
    launches.update(more)
    del model, outs
    e2e["seconds"] = {"kernels": t1 - t0, "tiny": t2 - t1, "mega_f32": t3 - t2,
                      "serve": t4 - t3, "mega_kernels": t5 - t4,
                      "mega_paths": time.perf_counter() - t5}
    print(f"[moe_tp] seconds: {json.dumps(e2e['seconds'])}")
    gc.collect()
    torch.cuda.empty_cache()
    return records, launches, e2e


# -- Phase 7: expert-parallel dispatch/combine and the dense all-to-all ------

EP_MODEL = MOE_MODEL
EP_RANKS = (2, 4)
# Tokens a rank: the reference's low-latency headline (ep_exchange.py:14-17)
# and a prefill chunk.
EP_TOKENS = (128, 1024)
EP_CAPACITY = 1.25
EP_STRESS = 20
EP_A2A_STRESS = 100
EP_LAG_NS = 500_000
# The limit of ep_moe_ffn against the dense f32 golden, (atol, rtol): the
# path rounds the expert GEMMs' outputs, the SiLU product and the combined
# token to bf16, a few ulps of |out| <= ~1. At the preset's widths on the
# CPU (32 tokens, the plain exchange) it read 0.28-0.29 of this limit.
# Under the fp8 payload the golden's experts see the payload the path
# dispatches (each row's e4m3 codes times its scale, in bf16): against
# the unquantized golden fp8 reads ~4x this limit (e4m3 rounds an element
# by up to 2^-4 of it), which the e2e line reports as `fp8_raw_use`.
EP_TOL = (1e-2, 2.0**-5)
EP_PATH_KERNELS = {
    "ep_moe_ffn": ("ep_exchange",),
    "ep_all_to_all": ("all_to_all",),
}
_A2A_SRC = "triton_distributed_tpu_torch/csrc/all_to_all.cu"


def _paths_launched(launches, paths) -> None:
    """Every kernel each path needs launched in that path's own run."""
    for path, need in paths.items():
        missing = [k for k in need if not launches[path][k]]
        if missing:
            raise RuntimeError(f"{path} did not launch {missing}")


def _ep_weights(dev, cfg):
    """One MoE layer's router and experts at the preset's widths, bf16,
    from SEED with an explicit generator: ``w_router [d, E]``, ``w1 [E, d,
    2f]`` (gate | up), ``w2 [E, f, d]``, scaled by 1/sqrt(fan-in)."""
    import torch

    d, e, f = cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)

    def draw(shape, fan_in):
        t = torch.empty(shape, dtype=torch.bfloat16, device=dev)
        return t.normal_(0.0, fan_in**-0.5, generator=gen)

    return draw((d, e), d), draw((e, d, 2 * f), d), draw((e, f, d), f)


def _ep_tokens(dev, n, t, d, seed, skew):
    """``[n * t, d]`` bf16 tokens; ``skew`` makes them positive, which
    with the skewed router sends every top-k to rank 0's experts."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n * t, d), generator=gen, device=dev)
    return (x.abs() if skew else x).to(torch.bfloat16)


def _skewed_router(wr, n):
    """The adversarial router of tests/test_moe.py:101 in bf16: +1 on the
    columns of rank 0's experts, -1 on the rest. With positive tokens
    every top-k lands on rank 0 (a +-sum|x| ~ 1600 shift), and unlike +-100
    (whose bf16 ulp of 0.5 would flatten the ~0.02-wide router columns to
    one value) the router still tells rank 0's experts apart."""
    w = wr.clone()
    epr = w.shape[1] // n
    w[:, :epr] += 1.0
    w[:, epr:] -= 1.0
    return w


def _ep_golden(x, wr, w1, w2, k, n, cap, norm, x_ffn=None):
    """The dense f32 golden: each rank's tokens routed as ``router_topk``
    routes them (the same f32 product on the same per-rank rows), each
    (token, expert) assignment past a destination's capacity dropped (its
    occurrence order, as the dispatch counts), every token's kept experts'
    SwiGLU FFN in f32 weighted by its gate weights (on ``x_ffn``, the
    dispatched payload, where given). Returns ``(out [n*T, d] f32, dropped
    a rank)``."""
    import torch

    from triton_distributed_tpu_torch.ops.moe.routing import router_topk

    e = w1.shape[0]
    epr, t = e // n, x.shape[0] // n
    ids, ws, dropped = [], [], []
    for r in range(n):
        route = router_topk(x[r * t:(r + 1) * t], wr, k, norm_topk_prob=norm)
        dest = route.expert_ids.long() // epr
        onehot = torch.nn.functional.one_hot(dest.reshape(-1), n)
        slot = (torch.cumsum(onehot, 0) - onehot).gather(
            1, dest.reshape(-1, 1))[:, 0].reshape(dest.shape)
        limit = t * k if cap is None else cap
        dropped.append(int(torch.clamp(onehot.sum(0) - limit, min=0).sum()))
        ids.append(route.expert_ids.long())
        ws.append(torch.where(slot < limit, route.weights,
                              torch.zeros_like(route.weights)))
    ids, ws = torch.cat(ids), torch.cat(ws)
    xf = (x if x_ffn is None else x_ffn).float()
    out = torch.zeros_like(xf)
    f = w2.shape[1]
    for ex in range(e):
        rows, j = (ids == ex).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        h = xf[rows] @ w1[ex].float()
        act = torch.nn.functional.silu(h[:, :f]) * h[:, f:]
        out.index_add_(0, rows, ws[rows, j][:, None] * (act @ w2[ex].float()))
    return out, dropped


def _ep_limit_use(got, want):
    """The largest |got - want| / (atol + rtol |want|) over the rows."""
    import torch

    atol, rtol = EP_TOL
    g = torch.cat(got).float()
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    return float(((g - want).abs() / (atol + rtol * want.abs())).max())


def check_ep(dev):
    """Phase 7: expert-parallel MoE dispatch/combine (``ep_moe_ffn``) at
    Qwen3-30B-A3B's MoE widths over n = 2 and 4 co-located ranks, 128 and
    1024 tokens a rank, transports ``pallas`` (the EP exchange kernel) and
    ``xla``, bf16 and fp8 payloads, lossless and at capacity 1.25, and the
    skewed router; the exchange's rows against the plain exchange, the
    count mask's negative control, the lag, back-to-back launches, and the
    dense all-to-all. Returns (records by kernel, launches by path, e2e)."""
    import gc

    import torch

    from triton_distributed_tpu_torch.models import get_config
    from triton_distributed_tpu_torch.ops import cuda_kernels as ck
    from triton_distributed_tpu_torch.ops.collectives import (
        all_to_all_op,
        all_to_all_plain,
    )
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    # The modules (the package exports functions of the same names).
    ep_a2a = importlib.import_module("triton_distributed_tpu_torch.ops.moe."
                                     "ep_a2a")
    ex = importlib.import_module("triton_distributed_tpu_torch.ops.moe."
                                 "ep_exchange")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = get_config(EP_MODEL)
    d, e, k = cfg.hidden_size, cfg.num_experts, cfg.num_experts_per_tok
    norm = cfg.norm_topk_prob
    wr, w1, w2 = _ep_weights(dev, cfg)
    print(f"[ep] {EP_MODEL} MoE layer: d {d}, {e} experts top-{k}, f "
          f"{cfg.moe_intermediate_size}, norm_topk_prob {norm}, bf16, seed "
          f"{SEED + 30}")

    def shards(n):
        epr = e // n
        return ([w1[r * epr:(r + 1) * epr] for r in range(n)],
                [w2[r * epr:(r + 1) * epr] for r in range(n)])

    # Every EP exchange of the runs below is held to the plain exchange as
    # it launches: its rows bitwise the plain one's within every count.
    # The first n = 4 lossless bf16 dispatch at EP_TOKENS[0] (the
    # reference's headline) is kept for the timing and the lag.
    real = ep_a2a.ep_exchange
    held = {"checked": 0, "head": None, "err": 0}

    def check_rows(rows, splits, out):
        want = ex.ep_exchange_plain(rows, splits)
        sp = torch.stack(splits)
        keep = (torch.arange(rows[0].shape[1], device=dev)[None, None, :]
                < sp.t()[:, :, None])  # [dest, src, row]
        for p in range(len(rows)):
            # max |got - plain| over the bytes within the counts
            diff = (out[p][keep[p]].int() - want[p][keep[p]].int()).abs()
            held["err"] = max(held["err"], int(diff.max()) if diff.numel()
                              else 0)
            if not torch.equal(out[p][keep[p]], want[p][keep[p]]):
                raise RuntimeError("ep_exchange rows differ from the plain "
                                   "exchange within the counts")

    def capture(rows, splits, recv_counts, ctx, **kw):
        out = real(rows, splits, recv_counts, ctx, **kw)
        check_rows(rows, splits, out)
        held["checked"] += 1
        if (held["head"] is None and len(rows) == 4
                and rows[0].shape[1] == EP_TOKENS[0] * k
                and rows[0].shape[2] >= 2 * d):
            held["head"] = (rows, splits, recv_counts, ctx)
        return out

    results, worst = {}, {"bf16": 0.0, "fp8": 0.0}
    launches = {}
    for n in EP_RANKS:
        ctx = initialize_distributed(n, device=dev, dtype=torch.bfloat16)
        w1s, w2s = shards(n)
        for t in EP_TOKENS:
            for skew in (False, True):
                x = _ep_tokens(dev, n, t, d, SEED + 31 + t + n, skew)
                router = _skewed_router(wr, n) if skew else wr
                xs = list(torch.chunk(x, n))
                for cf in (None, EP_CAPACITY):
                    cap = None if cf is None else int(
                        -(-(t * k * cf / n) // 8) * 8)
                    gold, dropped = _ep_golden(x, router, w1, w2, k, n, cap,
                                               norm)
                    q8, sc8 = ep_a2a._fp8_encode(x)
                    gold8, _ = _ep_golden(
                        x, router, w1, w2, k, n, cap, norm,
                        x_ffn=(q8.float() * sc8).to(x.dtype))
                    for payload in (None, "fp8"):
                        tag = payload or "bf16"
                        outs = {}
                        for method in ("pallas", "xla"):
                            main = (n, t, skew, cf, payload, method) == (
                                EP_RANKS[0], EP_TOKENS[-1], False, None,
                                None, "pallas")
                            if main:
                                ck.reset_launch_counts()
                            ep_a2a.ep_exchange = capture
                            try:
                                outs[method], st = ep_a2a.ep_moe_ffn(
                                    xs, router, w1s, w2s, k, ctx=ctx,
                                    method=method, capacity_factor=cf,
                                    norm_topk_prob=norm,
                                    payload_dtype=payload, return_state=True)
                            finally:
                                ep_a2a.ep_exchange = real
                            torch.cuda.synchronize()
                            if main:
                                launches["ep_moe_ffn"] = ck.launch_counts()
                            got_drop = [int(s.num_dropped) for s in st]
                            if got_drop != dropped:
                                raise RuntimeError(
                                    f"ep n={n} T={t} skew={skew} cf={cf} "
                                    f"{tag} {method}: num_dropped {got_drop},"
                                    f" the golden's overflow {dropped}")
                        if not all(torch.equal(a, b) for a, b in zip(
                                outs["pallas"], outs["xla"])):
                            raise RuntimeError(
                                f"ep n={n} T={t} skew={skew} cf={cf} {tag}: "
                                "pallas != xla bitwise")
                        use = _ep_limit_use(outs["pallas"],
                                            gold8 if payload else gold)
                        worst[tag] = max(worst[tag], use)
                        if not use <= 1.0:
                            raise RuntimeError(
                                f"ep n={n} T={t} skew={skew} cf={cf} {tag}: "
                                f"{use:.3g}x the golden limit {EP_TOL}")
                        key = (f"n{n}_t{t}_{'skew' if skew else 'rand'}_"
                               f"{'cap' if cf else 'lossless'}_{tag}")
                        results[key] = {"limit_use": use, "dropped": dropped}
                        if payload:
                            results[key]["fp8_raw_use"] = _ep_limit_use(
                                outs["pallas"], gold)
        print(f"[ep] n={n}: T {EP_TOKENS}, random and skewed routers, "
              f"lossless and capacity {EP_CAPACITY}, bf16 and fp8: pallas == "
              "xla bitwise, num_dropped == the golden's overflow, worst "
              f"golden limit use {json.dumps(worst)}")
    _paths_launched(launches, {"ep_moe_ffn": EP_PATH_KERNELS["ep_moe_ffn"]})
    got = launches["ep_moe_ffn"]
    if got["ep_exchange"] != 2:
        raise RuntimeError(f"ep_moe_ffn launched ep_exchange "
                           f"{got['ep_exchange']} times, not 2")
    skew_drop = [v["dropped"] for key, v in results.items()
                 if "skew_cap" in key]
    if not any(sum(dr) for dr in skew_drop):
        raise RuntimeError("the skewed router at capacity dropped nothing")
    if any(sum(v["dropped"]) for key, v in results.items()
           if "lossless" in key):
        raise RuntimeError("a lossless run dropped assignments")

    print(f"[ep] ep_exchange: {held['checked']} launches' rows bitwise the "
          "plain exchange's within every count")

    # Negative control: the combine direction into a NaN-filled buffer;
    # the kernel leaves every row past a count NaN, the count mask zeroes
    # them, and a weight-0 assignment whose slot lands on one makes its
    # token NaN without the mask.
    n, t = 4, EP_TOKENS[0]
    ctx = initialize_distributed(n, device=dev, dtype=torch.bfloat16)
    w1s, w2s = shards(n)
    xs = list(torch.chunk(_ep_tokens(dev, n, t, d, SEED + 40, False), n))
    routes = [ep_a2a.router_topk(x_, wr, k, norm_topk_prob=norm) for x_ in xs]
    cap = int(-(-(t * k * EP_CAPACITY / n) // 8) * 8)
    rx, _, _, states = ep_a2a.ep_dispatch(xs, routes, e, cap, ctx=ctx,
                                          method="pallas")
    rows = [ex.pack_rows([r.reshape(n, cap, d)])[0] for r in rx]
    nan_out = [torch.full_like(rows[0], ex.POISON) for _ in range(n)]
    back = ex.ep_exchange_kernel(rows, [s.recv_counts for s in states],
                                 [s.splits for s in states], ctx,
                                 out=nan_out)
    raw = ex.unpack_row(back[0], 0, torch.bfloat16, d)
    st = states[0]
    sent = torch.arange(cap, device=dev)[None, :] < st.splits[:, None]
    p = int(torch.argmin(st.splits))
    dest, slot, valid = st.dest.clone(), st.slot.clone(), st.valid.clone()
    dest[0], slot[0], valid[0] = p, int(st.splits[p]), False
    bad = st._replace(dest=dest, slot=slot, valid=valid)
    unmasked = ep_a2a.combine_rows(raw, bad, t)
    masked = ep_a2a.combine_rows(
        torch.where(sent[..., None], raw, torch.zeros_like(raw)), bad, t)
    if not (bool((~sent).any()) and bool(torch.isnan(raw[~sent]).all())
            and bool(torch.isnan(unmasked[0]).all())
            and bool(torch.isfinite(masked).all())):
        raise RuntimeError("the count-mask control did not show NaN rows "
                           "without the mask and finite rows with it")
    print(f"[ep] control: {int((~sent).sum())} unsent rows of rank 0 stay "
          "NaN after the kernel; without the count mask token 0 is NaN, "
          "with it every token is finite")

    # The lag: rank 1 announces at the entry barrier EP_LAG_NS after the
    # grid's last block started, so the lagged launch is >= the lag
    # longer; each time the median of 5 device-timed launches.
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows, splits, recv, ctx = held["head"]
    lag = []
    for nanos in (0, EP_LAG_NS):
        def launch(nanos=nanos):
            return ex.ep_exchange_kernel(
                rows, splits, recv, ctx,
                straggler_rank=1 if nanos else None, straggle_nanos=nanos)
        check_rows(rows, splits, launch())
        lag.append(median_ms(launch, flush, iters=5, warmup=1))
    if lag[1] - lag[0] < EP_LAG_NS / 1e6:
        raise RuntimeError(f"a {EP_LAG_NS} ns lag made ep_exchange {lag[1]} "
                           f"ms against {lag[0]}")
    print(f"[ep] lag {EP_LAG_NS} ns on rank 1: {lag[0]:.4f} -> "
          f"{lag[1]:.4f} ms, rows bit-identical")

    # Back to back: EP_STRESS runs with fresh routing at n = 4, T = 128.
    ctx = initialize_distributed(4, device=dev, dtype=torch.bfloat16)
    w1s, w2s = shards(4)
    kept = []
    for i in range(EP_STRESS):
        xs = list(torch.chunk(_ep_tokens(dev, 4, EP_TOKENS[0], d,
                                         SEED + 50 + i, False), 4))
        kept.append((xs, ep_a2a.ep_moe_ffn(xs, wr, w1s, w2s, k, ctx=ctx,
                                           method="pallas",
                                           norm_topk_prob=norm)))
    torch.cuda.synchronize()
    for xs, got in kept:
        want = ep_a2a.ep_moe_ffn(xs, wr, w1s, w2s, k, ctx=ctx, method="xla",
                                 norm_topk_prob=norm)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError("a back-to-back ep_moe_ffn differs from xla")
    print(f"[ep] stress: {EP_STRESS} back-to-back ep_moe_ffn runs with "
          "fresh routing at n=4, each bitwise the xla transport")

    # The dense all-to-all: [n * 128, 2048] bf16 a rank, through
    # all_to_all_op, EP_A2A_STRESS launches back to back each bitwise.
    a2a, a2a_err = {}, 0.0
    for n in EP_RANKS:
        ctx = initialize_distributed(n, device=dev, dtype=torch.bfloat16)
        gen = torch.Generator(device=dev).manual_seed(SEED + 60 + n)
        xin = [torch.randn((n, n * 128, d), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(EP_A2A_STRESS)]
        if n == EP_RANKS[-1]:
            ck.reset_launch_counts()
        got = [all_to_all_op(x_, ctx) for x_ in xin]
        torch.cuda.synchronize()
        if n == EP_RANKS[-1]:
            launches["ep_all_to_all"] = ck.launch_counts()
        for x_, g in zip(xin, got):
            want = torch.stack(all_to_all_plain(list(x_)))
            a2a_err = max(a2a_err, float((g.float() - want.float()).abs()
                                         .max()))
            if not torch.equal(g, want):
                raise RuntimeError(f"all_to_all n={n} differs from plain")
        a2a[n] = xin[0]
    _paths_launched(launches, EP_PATH_KERNELS)
    if launches["ep_all_to_all"]["all_to_all"] != EP_A2A_STRESS:
        raise RuntimeError("all_to_all_op did not launch its kernel")
    print(f"[ep] all_to_all [n*128, {d}] bf16 at n={EP_RANKS}: "
          f"{EP_A2A_STRESS} back-to-back launches each bitwise the plain "
          "version")

    # Records at the main shapes: the exchange of the n = 4, T = 128
    # lossless bf16 dispatch (the reference's headline), the all-to-all at
    # n = 4. Bound: the rows that move, read once and written once.
    rows, splits, recv, ctx = held["head"]
    moved = int(torch.stack(splits).sum()) * rows[0].shape[2]
    stacked = torch.stack(rows)
    records = {"ep_exchange": dict(
        route="cuda", source=_A2A_SRC,
        replaces="triton_distributed_tpu/ops/moe/ep_exchange.py:81",
        max_abs_err=float(held["err"]),
        ms=median_ms(lambda: ex.ep_exchange_kernel(rows, splits, recv, ctx),
                     flush),
        plain_ms=median_ms(lambda: ex.ep_exchange_plain(rows, splits), flush),
        bound_ms=2 * moved / HBM_BPS * 1e3, bound_by="bytes",
        library_ms=median_ms(
            lambda: stacked.transpose(0, 1).contiguous(), flush),
        shape=f"n=4, {EP_TOKENS[0]} tokens a rank, top-{k}, lossless: rows "
              f"{list(rows[0].shape)} uint8 a rank, {moved} bytes filled",
        lag_ms=lag, limit_use=worst)}
    n = EP_RANKS[-1]
    ctx = initialize_distributed(n, device=dev, dtype=torch.bfloat16)
    xs = [a2a[n][r].contiguous() for r in range(n)]
    from triton_distributed_tpu_torch.ops.collectives import (
        all_to_all_kernel,
    )
    stacked = torch.stack(xs)
    records["all_to_all"] = dict(
        route="cuda", source=_A2A_SRC,
        replaces="triton_distributed_tpu/ops/collectives/all_to_all.py:35",
        max_abs_err=a2a_err,
        ms=median_ms(lambda: all_to_all_kernel(xs, ctx), flush),
        plain_ms=median_ms(lambda: all_to_all_plain(xs), flush),
        bound_ms=2 * nbytes(*xs) / HBM_BPS * 1e3, bound_by="bytes",
        library_ms=median_ms(lambda: stacked.unflatten(1, (n, -1)).transpose(
            0, 1).contiguous(), flush),
        shape=f"n={n}, [{n * 128}, {d}] bf16 a rank")
    for name, rec in records.items():
        print(f"[ep] {name} {rec['shape']}: {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f}, library {rec['library_ms']:.4f}, "
              f"bound {rec['bound_ms']:.4f} ms (bytes)")
    del flush, held, kept, w1, w2
    gc.collect()
    torch.cuda.empty_cache()
    return records, launches, {"cases": results, "worst": worst,
                               "seconds": time.perf_counter() - t0}


# -- Phase 8: sequence-parallel attention --------------------------------------

SP_MODEL = TP_MODEL
SP_SEQ = 32768          # Qwen3-8B's native context, one sequence
SP_RANKS = (2, 4)
SP_TILE = 64            # rows of each rank's first and last q tile checked
SP_F32_SEQ = 4096
SP_STRESS = 20
SP_DECODE_LENS = (32000, 20000, 9000, 300)
SP_DECODE_CHUNK = 256
# The bf16 O of the SP kernel, of ring attention and of flash_attention is
# held at SP_O_SCALE x TOL["bf16"] (the LSE at TOL): each rounds P to bf16
# before P.V, as the TPU kernels do, and on the first rows of a sequence
# (few keys, P entries near 1) that rounding alone moves O by up to
# ~2^-9 |V|, 1.19x TOL on an H100. The zeroed-chunk control reads >= 7x
# this limit.
SP_O_SCALE = 2.0
SP_PATH_KERNELS = {
    "sp_prefill": ("sp_ag_attention",),
    "sp_ring": ("flash_attention", "flash_attention_cold"),
    "sp_decode": ("flash_decode", "all_gather_bidir_ring"),
    "sp_decode_int8": ("flash_decode_int8", "all_gather_bidir_ring"),
}
_SP_SRC = "triton_distributed_tpu_torch/csrc/sp_attention.cu"


def _sp_limit_use(got, want, tag, scale: float = 1.0):
    """The largest |got - want| / (atol + rtol |want|) under ``scale`` x
    TOL[tag]."""
    import torch

    atol, rtol = (scale * t for t in TOL[tag])
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    return float(((g - w).abs() / (atol + rtol * w.abs())).max())


def _sp_tiles(s_loc, tile=SP_TILE):
    """Local row ranges checked on every rank: the first and last tile."""
    return ((0, min(tile, s_loc)), (max(0, s_loc - tile), s_loc))


def _sp_plain_rows(q, k, v, me, s_loc, lo, hi, causal=True, sm_scale=None):
    """Plain O and LSE of rank ``me``'s local rows [lo, hi) against the
    whole sequence's K/V (``k``/``v [hkv, S, hd]``): causal over the
    prefix, or every key."""
    from triton_distributed_tpu_torch.ops.attention import mha_reference

    g0 = me * s_loc
    end = g0 + hi if causal else k.shape[1]
    o, lse = mha_reference(q[None, :, g0 + lo:g0 + hi], k[None, :, :end],
                           v[None, :, :end], causal=causal,
                           kv_offset=g0 + lo, sm_scale=sm_scale,
                           return_lse=True)
    return o[0], lse[0]


def _sp_hold(outs, lses, q, k, v, n, tag, causal=True, what="",
             scale: float = 1.0):
    """Every rank's first and last q tile of every head held to the plain
    version over their full (causal) prefix: O under ``scale`` x TOL[tag],
    the LSE under TOL[tag]; returns the worst use of those limits and max
    |kernel - plain| of O."""
    s_loc = q.shape[1] // n
    use, err = 0.0, 0.0
    for me in range(n):
        for lo, hi in _sp_tiles(s_loc):
            po, plse = _sp_plain_rows(q, k, v, me, s_loc, lo, hi, causal)
            use = max(use, _sp_limit_use(outs[me][:, lo:hi], po, tag, scale))
            if lses is not None:
                use = max(use, _sp_limit_use(lses[me][:, lo:hi], plse, tag))
            err = max(err, float((outs[me][:, lo:hi].float() - po.float())
                                 .abs().max()))
    if not use <= 1.0:
        raise RuntimeError(f"sp {what} {tag} n={n}: {use:.3g}x {scale} x "
                           f"the limit {TOL[tag]} on the checked tiles")
    return use, err


def check_sp(dev):
    """Phase 8: sequence-parallel attention at Qwen3-8B's geometry over one
    SP_SEQ-token causal sequence sharded over n = 2 and 4 ranks: the SP
    all-gather attention kernel (O and LSE) against its plain version on
    every rank's first and last q tile and against the single-card
    ``flash_attention`` over the gathered sequence; f32 at SP_F32_SEQ in
    full; the zeroed-chunk control; SP_STRESS back-to-back launches; the
    even grid bitwise the grid split by work; ring attention; the SP decode layer and the distributed decode (bf16 and
    int8, pallas and xla); the two-level variants over dp x tp = 2 x 2.
    Returns (records by kernel, launches by path, e2e)."""
    import gc

    import torch
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.layers.sp_flash_decode import (
        sp_decode_attention,
    )
    from triton_distributed_tpu_torch.models import get_config
    from triton_distributed_tpu_torch.ops import cuda_kernels as ck
    from triton_distributed_tpu_torch.ops.attention import (
        distributed_flash_decode,
        distributed_flash_decode_2level,
        flash_attention,
        gqa_decode_reference,
        ring_attention,
        sp_ag_attention,
        sp_ag_attention_2level,
    )
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    spmod = importlib.import_module(
        "triton_distributed_tpu_torch.ops.attention.sp_ag_attention")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = get_config(SP_MODEL)
    hq, hkv, hd = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
    S = SP_SEQ
    gen = torch.Generator(device=dev).manual_seed(SEED + 70)

    def draw(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q, k, v = draw((hq, S, hd)), draw((hkv, S, hd)), draw((hkv, S, hd))
    print(f"[sp] {SP_MODEL} geometry: hq {hq}, hkv {hkv}, hd {hd}, one "
          f"{S}-token causal sequence, bf16, seed {SEED + 70}")

    def shards(t, n):
        return [c.contiguous() for c in torch.chunk(t, n, dim=1)]

    # The single-card flash_attention over the gathered sequence (the
    # ported kernel), compared in full with each SP run (O at SP_O_SCALE x
    # the bf16 limit, the LSE at the limit).
    t1 = time.perf_counter()
    fa_o, fa_lse = flash_attention(q[None], k[None], v[None], causal=True,
                                   return_lse=True)
    torch.cuda.synchronize()
    fa_s = time.perf_counter() - t1
    fa_o, fa_lse = fa_o[0], fa_lse[0]
    launches, res = {}, {}
    outs_by_n = {}
    for n in SP_RANKS:
        ctx = initialize_distributed(n, device=dev, dtype=torch.bfloat16)
        qs, ks, vs = shards(q, n), shards(k, n), shards(v, n)
        if n == SP_RANKS[0]:
            ck.reset_launch_counts()
        o, lse = sp_ag_attention(qs, ks, vs, ctx, return_lse=True)
        torch.cuda.synchronize()
        if n == SP_RANKS[0]:
            launches["sp_prefill"] = ck.launch_counts()
        use, err = _sp_hold(o, lse, q, k, v, n, "bf16", what="tiles",
                            scale=SP_O_SCALE)
        full_use = max(_sp_limit_use(torch.cat(o, 1), fa_o, "bf16",
                                     SP_O_SCALE),
                       _sp_limit_use(torch.cat(lse, 1), fa_lse, "bf16"))
        if not full_use <= 1.0:
            raise RuntimeError(f"sp n={n}: {full_use:.3g}x the limit against "
                               "flash_attention over the gathered sequence")
        # Control: the plain version with chunk 0 of K/V zeroed must break
        # the limit on the rows of ranks > 0.
        k0, v0 = k.clone(), v.clone()
        s_loc = S // n
        k0[:, :s_loc] = 0
        v0[:, :s_loc] = 0
        ctl = min(max(_sp_limit_use(o[me][:, lo:hi], _sp_plain_rows(
            q, k0, v0, me, s_loc, lo, hi)[0], "bf16", SP_O_SCALE)
            for lo, hi in _sp_tiles(s_loc)) for me in range(1, n))
        if not ctl > 1.0:
            raise RuntimeError(f"sp n={n}: chunk 0 zeroed passes the limit")
        del k0, v0
        res[n] = {"tiles_use": use, "max_abs_err": err,
                  "vs_flash_attention_use": full_use, "control": ctl}
        outs_by_n[n] = (qs, ks, vs, ctx)
        print(f"[sp] n={n} (s_loc {s_loc}): every rank's first/last "
              f"{SP_TILE}-row tile of every head {use:.3f} of the limit "
              f"(max |err| {err:.3g}), O and LSE against flash_attention "
              f"over the gathered sequence {full_use:.3f} of the limit;"
              " chunk 0 zeroed: "
              f"ranks > 0 at >= {ctl:.1f}x")

    # f32 at SP_F32_SEQ, n = 4, against the full plain version (TF32 off).
    n = 4
    qf, kf, vf = (draw((hq, SP_F32_SEQ, hd), torch.float32),
                  draw((hkv, SP_F32_SEQ, hd), torch.float32),
                  draw((hkv, SP_F32_SEQ, hd), torch.float32))
    ctx = initialize_distributed(n, device=dev, dtype=torch.float32)
    o, lse = sp_ag_attention(shards(qf, n), shards(kf, n), shards(vf, n), ctx,
                             return_lse=True)
    po, plse = spmod.sp_ag_attention_plain(shards(qf, n), shards(kf, n),
                                           shards(vf, n))
    f32_use = max(max(_sp_limit_use(a, b, "f32") for a, b in zip(o, po)),
                  max(_sp_limit_use(a, b, "f32") for a, b in zip(lse, plse)))
    if not f32_use <= 1.0:
        raise RuntimeError(f"sp f32 S={SP_F32_SEQ}: {f32_use:.3g}x the limit")
    del qf, kf, vf, o, lse, po, plse
    print(f"[sp] f32 S={SP_F32_SEQ} n={n}: O and LSE in full {f32_use:.3f} "
          "of the f32 limit (TF32 off)")

    # SP_STRESS launches back to back at n = 4, fresh K/V each, checked
    # after one sync on the tiles.
    qs, _, _, ctx = outs_by_n[4]
    kept = []
    for i in range(SP_STRESS):
        ki, vi = draw((hkv, S, hd)), draw((hkv, S, hd))
        kept.append((ki, vi, sp_ag_attention(qs, shards(ki, 4), shards(vi, 4),
                                             ctx, return_lse=True)))
    torch.cuda.synchronize()
    stress_use = 0.0
    for ki, vi, (o, lse) in kept:
        stress_use = max(stress_use, _sp_hold(o, lse, q, ki, vi, 4, "bf16",
                                              what="stress",
                                              scale=SP_O_SCALE)[0])
    del kept
    print(f"[sp] stress: {SP_STRESS} back-to-back launches at n=4 with fresh "
          f"K/V, every one's tiles within the limit ({stress_use:.3f})")

    # Ring attention, causal and not, on the same shards at n = 4: its
    # chunks run the ported flash_attention kernels.
    qs, ks, vs, ctx = outs_by_n[4]
    ring = {}
    for causal in (True, False):
        if causal:
            ck.reset_launch_counts()
        o = ring_attention(qs, ks, vs, causal=causal)
        torch.cuda.synchronize()
        if causal:
            launches["sp_ring"] = ck.launch_counts()
        ring[causal] = _sp_hold(o, None, q, k, v, 4, "bf16", causal=causal,
                                what=f"ring causal={causal}",
                                scale=SP_O_SCALE)[0]
    print(f"[sp] ring_attention n=4: causal {ring[True]:.3f}, non-causal "
          f"{ring[False]:.3f} of the limit on the tiles")

    # Decode: B = 4, q [4, hq, hd], a SP_SEQ-slot cache sharded as above,
    # global lengths SP_DECODE_LENS (rows ending on rank 0; ranks with no
    # key for a row).
    b = len(SP_DECODE_LENS)
    qd = draw((b, hq, hd))
    kc, vc = draw((b, hkv, S, hd)), draw((b, hkv, S, hd))
    kn, vn = draw((b, hkv, hd)), draw((b, hkv, hd))
    lens = torch.tensor(SP_DECODE_LENS, dtype=torch.int32, device=dev)
    gk, gv = kc.clone(), vc.clone()
    rows = torch.arange(b, device=dev)
    gk[rows, :, lens.long()] = kn
    gv[rows, :, lens.long()] = vn
    want = gqa_decode_reference(qd, gk, gv, lens + 1)
    dec = {}
    for n in SP_RANKS:
        ctx = initialize_distributed(n, device=dev, dtype=torch.bfloat16)
        for method in ("pallas", "xla"):
            kcs, vcs = (list(torch.chunk(kc.clone(), n, dim=2)),
                        list(torch.chunk(vc.clone(), n, dim=2)))
            kcs = [c.contiguous() for c in kcs]
            vcs = [c.contiguous() for c in vcs]
            main = (n, method) == (4, "pallas")
            if main:
                ck.reset_launch_counts()
            o, k2, v2 = sp_decode_attention([qd] * n, kn, vn, kcs, vcs, lens,
                                            ctx, chunk_k=SP_DECODE_CHUNK,
                                            method=method)
            torch.cuda.synchronize()
            if main:
                launches["sp_decode"] = ck.launch_counts()
            if not (torch.equal(torch.cat(k2, 2), gk)
                    and torch.equal(torch.cat(v2, 2), gv)):
                raise RuntimeError(f"sp decode n={n}: the appended K/V is not "
                                   "the new token at the owner's position")
            dec[f"n{n}_{method}"] = max(_sp_limit_use(x_, want, "bf16")
                                        for x_ in o)
    # int8: codes with one scale per chunk per kv head.
    codes = torch.randint(-127, 128, kc.shape, generator=gen, device=dev,
                          dtype=torch.int8)
    scales = torch.rand((b, hkv, S // SP_DECODE_CHUNK), generator=gen,
                        device=dev) * 0.02 + 0.001
    deq = codes.float() * scales.repeat_interleave(SP_DECODE_CHUNK,
                                                   -1)[..., None]
    want8 = gqa_decode_reference(qd, deq, deq, lens)
    for n in SP_RANKS:
        ctx = initialize_distributed(n, device=dev, dtype=torch.bfloat16)
        cs = [c.contiguous() for c in torch.chunk(codes, n, dim=2)]
        ss = [c.contiguous() for c in torch.chunk(scales, n, dim=2)]
        for method in ("pallas", "xla"):
            main = (n, method) == (4, "pallas")
            if main:
                ck.reset_launch_counts()
            o = distributed_flash_decode([qd] * n, cs, cs, lens, ctx,
                                         chunk_k=SP_DECODE_CHUNK,
                                         method=method, k_scale=ss,
                                         v_scale=ss)
            torch.cuda.synchronize()
            if main:
                launches["sp_decode_int8"] = ck.launch_counts()
            dec[f"int8_n{n}_{method}"] = max(_sp_limit_use(x_, want8, "bf16")
                                             for x_ in o)
    if not max(dec.values()) <= 1.0:
        raise RuntimeError(f"sp decode over the limit: {json.dumps(dec)}")
    print(f"[sp] decode B={b}, kv_len {SP_DECODE_LENS} (+1 appended): "
          f"limit use {json.dumps({a: round(c, 4) for a, c in dec.items()})};"
          " appended K/V bitwise at the owner")

    # The two-level variants over dp x tp = 2 x 2.
    ctx = initialize_distributed(2, dp=2, device=dev, dtype=torch.bfloat16)
    o = sp_ag_attention_2level(shards(q, 4), shards(k, 4), shards(v, 4), ctx)
    two = {"sp": _sp_hold(o, None, q, k, v, 4, "bf16", what="2level",
                          scale=SP_O_SCALE)[0]}
    for method in ("pallas", "xla"):
        o = distributed_flash_decode_2level(
            [qd] * 4, [c.contiguous() for c in torch.chunk(gk, 4, dim=2)],
            [c.contiguous() for c in torch.chunk(gv, 4, dim=2)], lens + 1,
            ctx, chunk_k=SP_DECODE_CHUNK, method=method)
        two[f"decode_{method}"] = max(_sp_limit_use(x_, want, "bf16")
                                      for x_ in o)
    if not max(two.values()) <= 1.0:
        raise RuntimeError(f"sp 2-level over the limit: {json.dumps(two)}")
    print(f"[sp] two-level dp x tp = 2 x 2: {json.dumps(two)} of the bf16 "
          "limit")
    del kc, vc, gk, gv, codes, deq

    # Records at n = 2 (main path) and n = 4: the default grid (split by
    # each rank's causal work) and the even grid of the same co-resident
    # blocks, whose outputs must be bitwise the default's. Bound: the
    # causal products of the whole sequence (every rank shares the card),
    # 4 hq hd S^2 / 2 FLOP, against the bytes (q, K, V read, O and LSE
    # written).
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flops = 4 * hq * hd * S * (S + 1) / 2
    by = nbytes(q, k, v) + nbytes(q) + hq * S * 4
    g = hq // hkv
    cap = spmod._capacity[(ck.DTYPE_CODES[torch.bfloat16], g)]
    timed, even, grids = {}, {}, {}
    for n in SP_RANKS:
        qs, ks, vs, ctx = outs_by_n[n]
        split = spmod.sp_ag_attention_kernel(qs, ks, vs, ctx,
                                             sm_scale=hd**-0.5)
        flat = spmod.sp_ag_attention_kernel(qs, ks, vs, ctx,
                                            sm_scale=hd**-0.5,
                                            blocks_per_rank=cap // n)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(split[0] + split[1],
                                                      flat[0] + flat[1])):
            raise RuntimeError(f"sp n={n}: the even grid's outputs are not "
                               "bitwise the split grid's")
        del split, flat
        grids[n] = spmod.plan(n, cap, hkv * -(-(S // n) // spmod.q_tile(
            torch.bfloat16, g)))[0]
        timed[n] = median_ms(
            lambda: spmod.sp_ag_attention_kernel(qs, ks, vs, ctx,
                                                 sm_scale=hd**-0.5), flush)
        even[n] = median_ms(
            lambda: spmod.sp_ag_attention_kernel(
                qs, ks, vs, ctx, sm_scale=hd**-0.5, blocks_per_rank=cap // n),
            flush)
    fa_ms = median_ms(lambda: flash_attention(q[None], k[None], v[None],
                                              causal=True), flush)
    print(f"[sp] grids: blocks a rank {json.dumps(grids)} (split by work) "
          f"and {cap} // n (even), outputs bitwise equal; ms "
          f"{json.dumps(timed)} and {json.dumps(even)}")
    qs, ks, vs, ctx = outs_by_n[SP_RANKS[0]]

    def plain_by_head():
        # The plain version one q head at a time (its [hq, s_loc, S] f32
        # scores at once would need 68 GB).
        for h in range(hq):
            spmod.sp_ag_attention_plain(
                [x_[h:h + 1] for x_ in qs],
                [x_[h // g:h // g + 1] for x_ in ks],
                [x_[h // g:h // g + 1] for x_ in vs])

    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q[None], k[None], v[None], is_causal=True, enable_gqa=True)
    rec = dict(
        route="cuda", source=_SP_SRC,
        replaces="triton_distributed_tpu/ops/attention/sp_ag_attention.py:39",
        max_abs_err=max(r["max_abs_err"] for r in res.values()),
        ms=timed[SP_RANKS[0]],
        plain_ms=median_ms(plain_by_head, flush, iters=3, warmup=1),
        bound_ms=max(flops / BF16_FLOPS, by / HBM_BPS) * 1e3,
        bound_by="operations" if flops / BF16_FLOPS > by / HBM_BPS
        else "bytes",
        library_ms=median_ms(lib, flush),
        shape=f"{SP_MODEL} geometry, S={S} causal bf16 over n={SP_RANKS[0]} "
              f"ranks (s_loc {S // SP_RANKS[0]}); ms_by_n "
              f"{json.dumps(timed)}, even grid {json.dumps(even)}; "
              f"flash_attention over the gathered sequence {fa_ms:.4f} ms "
              f"(first call {fa_s * 1e3:.1f} ms of host wall)",
        ms_by_n=timed, even_ms_by_n=even, blocks_by_n=grids,
        flash_attention_ms=fa_ms, checks=res, f32_use=f32_use,
        stress_use=stress_use, ring_use=ring, decode_use=dec,
        two_level_use=two)
    print(f"[sp] sp_ag_attention {rec['shape']}: {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f}, SDPA {rec['library_ms']:.4f}, "
          f"flash_attention {fa_ms:.4f}, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})")
    _paths_launched(launches, SP_PATH_KERNELS)
    del flush, outs_by_n, q, k, v, fa_o, fa_lse
    gc.collect()
    torch.cuda.empty_cache()
    return {"sp_ag_attention": rec}, launches, {
        "checks": res, "ms_by_n": timed, "seconds": time.perf_counter() - t0}


# -- Phase 9: the remaining collectives ---------------------------------------

COLL_MODEL = TP_MODEL   # Qwen3-8B: hidden 4096, bf16
COLL_N = 4
# Rows a rank: a 2048-token prefill micro-batch between pipeline stages
# (16 MiB at hidden 4096 bf16) and a decode one.
COLL_SHIFT_ROWS = (2048, 32)
COLL_GATHER_ROWS = 192      # the full-mesh row of PERF.md's kernel table
COLL_WINDOWS = (1, 2, 3)
COLL_BCAST_ROWS = (2048, 4)
COLL_LL_ROWS = 8            # decode size: 64 KiB a rank
COLL_LL_RANKS = (4, 8)
COLL_LL_CALLS = 64
COLL_HIER = (2, 4)          # (dp, tp)
COLL_HIER_ROWS = (192, 384)  # all_gather_2d; reduce_scatter_2d, all_reduce
# Odd row widths at n = 2, f32: 400-byte and 20-byte rows.
COLL_ODD = ((3, 100), (3, 5))
COLL_PATH_KERNELS = {
    "pp_shift": ("pp_shift",),
    "all_gather_pull": ("all_gather_pull",),
    "all_gather_torus_2d": ("all_gather_torus_2d",),
    "broadcast": ("broadcast",),
    "ll_all_gather": ("ll_all_gather",),
    "hier_2level": ("all_gather_bidir_ring", "reduce_scatter_bidir_ring"),
}
_COLL_SRC = "triton_distributed_tpu_torch/csrc/collectives.cu"


def _bits_equal(got, want) -> bool:
    """Bytes equal, rank by rank (a NaN left in an output never matches)."""
    import torch

    return len(got) == len(want) and all(
        g.shape == w.shape and g.dtype == w.dtype and torch.equal(
            g.contiguous().view(torch.uint8), w.contiguous().view(torch.uint8))
        for g, w in zip(got, want))


def check_collectives(dev):
    """Phase 9: the pipeline shift, the pull and 2-D torus all-gathers, the
    one-shot broadcast, the low-latency all-gather and the two-level
    collectives at Qwen3-8B's width (hidden 4096, bf16) over ranks
    co-located on the card. Each path through its public entry point with
    the launch counts reset just before it; every output bitwise its plain
    version; each kernel again into NaN-filled outputs at the main shapes
    and at odd row widths (f32, n = 2); the LL ACK flags after 64 calls;
    the two-level sums against an f32 fold. Returns (records by kernel,
    launches by path, e2e)."""
    import gc
    import itertools

    import torch
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.models import get_config
    from triton_distributed_tpu_torch.ops import cuda_kernels as ck
    from triton_distributed_tpu_torch.ops.collectives import (
        AllGatherMethod,
        all_gather,
        all_gather_2d,
        all_gather_full_mesh,
        all_gather_plain,
        all_gather_torus_2d,
        all_reduce_2level,
        broadcast,
        ll_all_gather,
        ll_all_gather_workspace,
        ll_expected_flags,
        ll_flags,
        reduce_scatter_2d,
    )
    from triton_distributed_tpu_torch.parallel import pp_shift
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    # The modules (the packages export functions of the same names).
    p2p = importlib.import_module("triton_distributed_tpu_torch.parallel.p2p")
    agm = importlib.import_module(
        "triton_distributed_tpu_torch.ops.collectives.all_gather")
    bcm = importlib.import_module(
        "triton_distributed_tpu_torch.ops.collectives.broadcast")
    llm = importlib.import_module(
        "triton_distributed_tpu_torch.ops.collectives.low_latency")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    d = get_config(COLL_MODEL).hidden_size
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 80)
    n = COLL_N
    ctx = initialize_distributed(n, device=dev, dtype=bf)
    dp, tp = COLL_HIER
    ctx2 = initialize_distributed(tp, dp=dp, device=dev, dtype=bf)

    def shards(k, rows, cols=d, dtype=bf):
        return [torch.randn((rows, cols), generator=gen, device=dev).to(dtype)
                for _ in range(k)]

    def nan(k, shape, dtype=bf):
        return [torch.full(shape, float("nan"), dtype=dtype, device=dev)
                for _ in range(k)]

    launches, bitwise, errs = {}, {}, {}

    def drive(path, fn):
        """One path through its entry points, its own launch counts."""
        ck.reset_launch_counts()
        got = fn()
        torch.cuda.synchronize()
        launches[path] = ck.launch_counts()
        return got

    def hold(tag, got, want):
        """got bitwise want; max |got - want| kept by kernel (the tag's
        first word)."""
        name = tag.split()[0]
        errs[name] = max([errs.get(name, 0.0)] + [
            float((g.float() - w.float()).abs().max()) for g, w in
            zip(got, want)])
        if not _bits_equal(got, want):
            raise RuntimeError(f"coll {tag}: the kernel's output differs "
                               "from its plain version")
        bitwise[tag] = True

    # The main paths, through the public entry points.
    sh = {r: shards(n, r) for r in COLL_SHIFT_ROWS}
    runs = drive("pp_shift", lambda: [
        (pp_shift(sh[r], ctx, wrap=w), p2p.pp_shift_plain(sh[r], w))
        for r, w in ((COLL_SHIFT_ROWS[0], False), (COLL_SHIFT_ROWS[0], True),
                     (COLL_SHIFT_ROWS[1], False))])
    for i, (got, want) in enumerate(runs):
        hold(f"pp_shift run {i}", got, want)
    ag_in = shards(n, COLL_GATHER_ROWS)
    runs = drive("all_gather_pull", lambda: [
        all_gather(ag_in, ctx, AllGatherMethod.PALLAS_PULL, pull_window=w)
        for w in COLL_WINDOWS])
    for w, got in zip(COLL_WINDOWS, runs):
        hold(f"all_gather_pull w={w}", got, all_gather_plain(ag_in))
    tor_in = shards(dp * tp, COLL_GATHER_ROWS)
    got = drive("all_gather_torus_2d",
                lambda: all_gather_torus_2d(tor_in, ctx2))
    hold("all_gather_torus_2d", got, all_gather_plain(tor_in))
    bc_in = {r: shards(n, r) for r in COLL_BCAST_ROWS}
    cases = [(r, root) for r in COLL_BCAST_ROWS for root in (0, n - 1)]
    runs = drive("broadcast", lambda: [broadcast(bc_in[r], ctx, root)
                                       for r, root in cases])
    for (r, root), got in zip(cases, runs):
        hold(f"broadcast [{r}] root {root}", got,
             bcm.broadcast_plain(bc_in[r], root))

    def ll_calls():
        kept, wss = [], {}
        for k in COLL_LL_RANKS:
            c = initialize_distributed(k, device=dev, dtype=bf)
            ws = ll_all_gather_workspace(c, COLL_LL_ROWS, d, bf)
            for phase in range(COLL_LL_CALLS):
                xs = shards(k, COLL_LL_ROWS)
                out, ws = ll_all_gather(xs, ws, phase, c)
                kept.append((k, phase, xs, out))
            wss[k] = (c, ws)
        return kept, wss
    kept, ll_ws = drive("ll_all_gather", ll_calls)
    for k, phase, xs, out in kept:
        hold(f"ll_all_gather n={k} call {phase}", out, all_gather_plain(xs))
    acks = {}
    for k, (c, ws) in ll_ws.items():
        flags = ll_flags(ws)
        want = ll_expected_flags(ws)
        for kind in ("acks", "arrivals"):
            if not torch.equal(flags[kind].cpu(), want):
                raise RuntimeError(f"ll_all_gather n={k}: the {kind} flags "
                                   "are not the discipline's")
        acks[k] = sorted({int(v) for v in flags["acks"].flatten().tolist()})
    print(f"[coll] ll_all_gather [{COLL_LL_ROWS}, {d}] bf16 a rank at n="
          f"{COLL_LL_RANKS}: {COLL_LL_CALLS} back-to-back calls on one "
          f"workspace each bitwise the plain gather; every rank's ACK and "
          f"arrival flags the predicted values {json.dumps(acks)}")

    # The two-level collectives: dp x tp = 2 x 4, inner kernels by AUTO.
    h_ag = shards(dp * tp, COLL_HIER_ROWS[0])
    h_x = shards(dp * tp, COLL_HIER_ROWS[1])
    ag2, rs2, ar2 = drive("hier_2level", lambda: (
        all_gather_2d(h_ag, ctx2), reduce_scatter_2d(h_x, ctx2),
        all_reduce_2level(h_x, ctx2)))
    hold("all_gather_2d", ag2, all_gather_plain(h_ag))
    gold = h_x[0].float()
    for x_ in h_x[1:]:
        gold = gold + x_.float()   # the f32 fold in global rank order
    pieces = torch.chunk(gold, dp * tp)
    atol, rtol = _tp_limit(bf, dp * tp)

    def use(got, want):
        return float(((got.float() - want).abs()
                      / (atol + rtol * want.abs())).max())
    hier_use = {
        "reduce_scatter_2d": max(use(rs2[di * tp + t], pieces[t * dp + di])
                                 for di in range(dp) for t in range(tp)),
        "all_reduce_2level": max(use(o, gold) for o in ar2)}
    if not max(hier_use.values()) <= 1.0:
        raise RuntimeError(f"coll two-level sums over the limit: "
                           f"{json.dumps(hier_use)}")
    print(f"[coll] two-level dp x tp = {dp} x {tp}: all_gather_2d "
          f"[{COLL_HIER_ROWS[0]}, {d}] bitwise; reduce_scatter_2d and "
          f"all_reduce_2level [{COLL_HIER_ROWS[1]}, {d}] against the f32 "
          f"fold, of the limit ({atol}, {rtol}): {json.dumps(hier_use)}")
    _paths_launched(launches, COLL_PATH_KERNELS)
    want_counts = {"pp_shift": 3, "all_gather_pull": len(COLL_WINDOWS),
                   "all_gather_torus_2d": 1, "broadcast": len(cases),
                   "ll_all_gather": COLL_LL_CALLS * len(COLL_LL_RANKS)}
    for path, count in want_counts.items():
        if launches[path][path] != count:
            raise RuntimeError(f"{path} launched its kernel "
                               f"{launches[path][path]} times, not {count}")

    # Every kernel again into NaN-filled outputs (the negative control: an
    # unwritten byte stays NaN), at the main shapes and at odd row widths.
    def nan_checks(k_ctx, xs, tor_ctx, tor_xs, tag):
        k = len(xs)
        shape = tuple(xs[0].shape)
        full = (k * shape[0], *shape[1:])
        dt = xs[0].dtype
        for w in (False, True):
            hold(f"pp_shift NaN {tag} wrap {w}", p2p.pp_shift_kernel(
                xs, k_ctx, w, out=nan(k, shape, dt)),
                p2p.pp_shift_plain(xs, w))
        for w in range(1, k):
            hold(f"all_gather_pull NaN {tag} w={w}", agm.all_gather_pull(
                xs, k_ctx, w, out=nan(k, full, dt)), all_gather_plain(xs))
        for root in (0, k - 1):
            hold(f"broadcast NaN {tag} root {root}", bcm.broadcast_kernel(
                xs, k_ctx, root, out=nan(k, shape, dt)),
                bcm.broadcast_plain(xs, root))
        ws = ll_all_gather_workspace(k_ctx, shape[0], shape[1], dt)
        for phase in range(3):
            hold(f"ll_all_gather NaN {tag} call {phase}",
                 llm.ll_all_gather_kernel(xs, ws, phase, k_ctx,
                                          out=nan(k, full, dt)),
                 all_gather_plain(xs))
        m = len(tor_xs)
        tshape = (m * tor_xs[0].shape[0], *tor_xs[0].shape[1:])
        hold(f"all_gather_torus_2d NaN {tag}", agm.all_gather_torus_2d_kernel(
            tor_xs, tor_ctx, out=nan(m, tshape, dt)), all_gather_plain(tor_xs))
    nan_checks(ctx, sh[COLL_SHIFT_ROWS[1]], ctx2, tor_in, "main")
    nan_checks(ctx, ag_in, ctx2, tor_in, "gather rows")
    for rows, cols in COLL_ODD:
        c2 = initialize_distributed(2, device=dev, dtype=torch.float32)
        odd = shards(2, rows, cols, torch.float32)
        for t_dp, t_tp in ((2, 1), (1, 2)):
            tc = initialize_distributed(t_tp, dp=t_dp, device=dev,
                                        dtype=torch.float32)
            nan_checks(c2, odd, tc, shards(2, rows, cols, torch.float32),
                       f"[{rows}, {cols}] f32 torus {t_dp}x{t_tp}")
    torch.cuda.synchronize()
    print(f"[coll] {len(bitwise)} kernel outputs bitwise their plain "
          "versions (the NaN-filled ones included; odd widths "
          f"{[list(s) for s in COLL_ODD]} f32 at n=2)")

    # Records. Bound: the bytes the function must move over one HBM (the
    # ranks share the card): each input it needs read once, each output
    # written once. Library: one PyTorch call that writes every rank's
    # output from the stacked shards.
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    shard = nbytes(sh[COLL_SHIFT_ROWS[0]][0])
    g_shard = nbytes(ag_in[0])
    xs = sh[COLL_SHIFT_ROWS[0]]
    stacked = torch.stack(xs)
    rec = {}

    rec["pp_shift"] = dict(
        replaces="triton_distributed_tpu/parallel/p2p.py:43",
        ms=median_ms(lambda: p2p.pp_shift_kernel(xs, ctx, False), flush),
        plain_ms=median_ms(lambda: p2p.pp_shift_plain(xs, False), flush),
        library_ms=median_ms(lambda: F.pad(stacked[:-1], (0, 0, 0, 0, 1, 0)),
                             flush),
        bound_ms=((n - 1) + n) * shard / HBM_BPS * 1e3,
        ms_wrap=median_ms(lambda: p2p.pp_shift_kernel(xs, ctx, True), flush),
        ms_decode=median_ms(lambda: p2p.pp_shift_kernel(
            sh[COLL_SHIFT_ROWS[1]], ctx, False), flush),
        shape=f"n={n}, [{COLL_SHIFT_ROWS[0]}, {d}] bf16 a rank, wrap off "
              f"(library: one F.pad of the stacked shards)")
    pull_ms = {w: median_ms(lambda w=w: agm.all_gather_pull(ag_in, ctx, w),
                            flush) for w in COLL_WINDOWS}
    rec["all_gather_pull"] = dict(
        replaces="triton_distributed_tpu/ops/collectives/all_gather.py:182",
        ms=pull_ms[2], ms_by_window=pull_ms,
        plain_ms=median_ms(lambda: all_gather_plain(ag_in), flush),
        library_ms=median_ms(gather_copy(ag_in), flush),
        bound_ms=(n + n * n) * g_shard / HBM_BPS * 1e3,
        full_mesh_ms=median_ms(lambda: all_gather_full_mesh(ag_in, ctx),
                               flush),
        shape=f"n={n}, [{COLL_GATHER_ROWS}, {d}] bf16 a rank, window 2 "
              f"(the JAX default; by window {json.dumps(pull_ms)}; library: "
              f"one copy_ of the stacked shards into every rank's output)")
    m = dp * tp
    rec["all_gather_torus_2d"] = dict(
        replaces="triton_distributed_tpu/ops/collectives/all_gather.py:328",
        ms=median_ms(lambda: agm.all_gather_torus_2d_kernel(tor_in, ctx2),
                     flush),
        plain_ms=median_ms(lambda: all_gather_plain(tor_in), flush),
        library_ms=median_ms(gather_copy(tor_in), flush),
        bound_ms=(m + m * m) * g_shard / HBM_BPS * 1e3,
        shape=f"dp x tp = {dp} x {tp}, [{COLL_GATHER_ROWS}, {d}] bf16 a rank "
              f"(library as the pull's)")
    bx = bc_in[COLL_BCAST_ROWS[0]]
    dst = torch.empty((n, *bx[0].shape), dtype=bf, device=dev)
    rec["broadcast"] = dict(
        replaces="triton_distributed_tpu/ops/collectives/broadcast.py:41",
        ms=median_ms(lambda: bcm.broadcast_kernel(bx, ctx, 0), flush),
        plain_ms=median_ms(lambda: bcm.broadcast_plain(bx, 0), flush),
        library_ms=median_ms(lambda: dst.copy_(bx[0].expand(n, -1, -1)),
                             flush),
        bound_ms=(1 + n) * nbytes(bx[0]) / HBM_BPS * 1e3,
        ms_small=median_ms(lambda: bcm.broadcast_kernel(
            bc_in[COLL_BCAST_ROWS[1]], ctx, n - 1), flush),
        shape=f"n={n}, [{COLL_BCAST_ROWS[0]}, {d}] bf16 from root 0 "
              f"(library: one copy_ into the stacked outputs)")
    # The LL gather beside the full mesh at the same shape: the full mesh
    # at its own grid and at the LL's (what the entry barrier costs).
    ll_ms, fm_ms, fm_same, ll_lib, ll_bound = {}, {}, {}, {}, {}
    for k, (c, ws) in ll_ws.items():
        xs_k = shards(k, COLL_LL_ROWS)
        phases = itertools.count(ws.phase + 1)
        ll_ms[k] = median_ms(lambda xs_k=xs_k, c=c, ws=ws, phases=phases:
                             llm.ll_all_gather_kernel(xs_k, ws, next(phases),
                                                      c), flush)
        ll_lib[k] = median_ms(gather_copy(xs_k), flush)
        ll_bound[k] = (k + k * k) * nbytes(xs_k[0]) / HBM_BPS * 1e3
        fm_ms[k] = median_ms(lambda xs_k=xs_k, c=c:
                             all_gather_full_mesh(xs_k, c), flush)
        fm_same[k] = median_ms(lambda xs_k=xs_k, c=c, g=ws.blocks:
                               all_gather_full_mesh(xs_k, c, g), flush)
    xs_ll = shards(n, COLL_LL_ROWS)
    rec["ll_all_gather"] = dict(
        replaces="triton_distributed_tpu/ops/collectives/low_latency.py:62",
        ms=ll_ms[n], ms_by_n=ll_ms, full_mesh_ms_by_n=fm_ms,
        full_mesh_ll_grid_ms_by_n=fm_same, library_ms_by_n=ll_lib,
        bound_ms_by_n=ll_bound,
        blocks_by_n={k: ws.blocks for k, (_, ws) in ll_ws.items()},
        plain_ms=median_ms(lambda: all_gather_plain(xs_ll), flush),
        library_ms=median_ms(gather_copy(xs_ll), flush),
        bound_ms=(n + n * n) * nbytes(xs_ll[0]) / HBM_BPS * 1e3,
        shape=f"n={n}, [{COLL_LL_ROWS}, {d}] bf16 a rank, barrier-free; "
              f"beside all_gather_full_mesh at the same shape "
              f"{json.dumps(fm_ms)} (by n; library as the pull's)")
    for name, r in rec.items():
        r.update(route="cuda", source=_COLL_SRC, bound_by="bytes",
                 max_abs_err=errs[name])
        print(f"[coll] {name} {r['shape']}: {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} ms (bytes)")
    print(f"[coll] pp_shift wrap {rec['pp_shift']['ms_wrap']:.4f} ms, decode "
          f"[{COLL_SHIFT_ROWS[1]}, {d}] {rec['pp_shift']['ms_decode']:.4f}; "
          f"broadcast [{COLL_BCAST_ROWS[1]}, {d}] "
          f"{rec['broadcast']['ms_small']:.4f}; ll_all_gather by n "
          f"{json.dumps(ll_ms)} against the full mesh {json.dumps(fm_ms)}, "
          f"at the LL's grid {json.dumps(fm_same)}, library "
          f"{json.dumps(ll_lib)}, bound {json.dumps(ll_bound)}")
    del flush, sh, bc_in, stacked, dst
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches, {"bitwise_checks": len(bitwise),
                           "hier_limit_use": hier_use, "ll_acks": acks,
                           "seconds": time.perf_counter() - t0}


def _flushed(check):
    """A phase that takes the L2-flush buffer, given a fresh one."""
    def run(dev):
        import torch

        return check(dev, torch.empty(64 << 20, dtype=torch.uint8,
                                      device=dev))
    return run


def _mega_phase(dev):
    rec, more = _flushed(check_mega)(dev)
    return {"mega_decode": rec, **more}, {}, None


def _tiny_phase(dev):
    check_tiny_serving(dev)
    return {}, {}, None


# The phases in the order of a whole run: name -> (fn(dev) -> (records,
# launches by path, e2e), the path tables whose kernels it launches; None:
# every library).
PHASES = {
    "kernels": (lambda dev: (_flushed(check_kernels)(dev), {}, None), None),
    "mega": (_mega_phase, None),
    "tiny": (_tiny_phase, None),
    "serve": (lambda dev: ({}, *serve_main_path(dev)), (PATH_KERNELS,)),
    "moe": (check_moe, (MOE_PATH_KERNELS,)),
    "tp": (check_tp, (TP_PATH_KERNELS, TP_OPTION_PATH_KERNELS,
                      TP_MEGA_PATH_KERNELS, TP_PREFILL_PATH_KERNELS)),
    "moe_tp": (check_moe_tp, (MOE_TP_PATH_KERNELS, MOE_TP_MEGA_PATH_KERNELS)),
    "ep": (check_ep, (EP_PATH_KERNELS,)),
    "sp": (check_sp, (SP_PATH_KERNELS,)),
    "coll": (check_collectives, (COLL_PATH_KERNELS,)),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Chip smoke run of the port.")
    ap.add_argument("--only", default="", metavar="PHASE[,PHASE]",
                    help="run only these phases (to measure one again; "
                         f"of {', '.join(PHASES)}); the default runs all")
    args = ap.parse_args(argv)
    only = [p for p in args.only.split(",") if p]
    unknown = sorted(set(only) - set(PHASES))
    if unknown:
        return fail(f"unknown phases {unknown}; of {list(PHASES)}")
    names = [p for p in PHASES if p in only] or list(PHASES)
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
    tables = [PHASES[p][1] for p in names]
    need = {k for tabs in tables for tab in tabs or () for ks in tab.values()
            for k in ks}
    libs = (ck.SOURCES if None in tables else tuple(sorted(
        {k.library_name for k in ck.KERNELS if k.name in need})))
    t0 = time.perf_counter()
    ck.build(libs)
    print(f"[build] {len(libs)} kernel libraries ready in "
          f"{time.perf_counter() - t0:.1f} s ({ck.BUILD_DIR})")

    phase_s = {"build": time.perf_counter() - t0}
    records, launches, e2e = {}, {}, {}
    for name in names:
        t0 = time.perf_counter()
        more_records, more_launches, more_e2e = PHASES[name][0](dev)
        records.update(more_records)
        launches.update(more_launches)
        if name == "serve":
            e2e.update(more_e2e)
        elif more_e2e is not None:
            e2e[name] = more_e2e
        phase_s[name] = time.perf_counter() - t0
        print(f"[time] {name}: {phase_s[name]:.1f} s", flush=True)
    print(f"[time] seconds per phase: {json.dumps(phase_s)}; total "
          f"{sum(phase_s.values()):.1f}")

    # "launches" counts the first path that must launch the kernel;
    # "launches_by_path" gives every path's own run.
    kernels = []
    paths = {**PATH_KERNELS, **MOE_PATH_KERNELS, **TP_PATH_KERNELS,
             **TP_OPTION_PATH_KERNELS, **TP_MEGA_PATH_KERNELS,
             **TP_PREFILL_PATH_KERNELS,
             **MOE_TP_PATH_KERNELS, **MOE_TP_MEGA_PATH_KERNELS,
             **EP_PATH_KERNELS, **SP_PATH_KERNELS, **COLL_PATH_KERNELS}
    for k in ck.KERNELS:
        first = next((p for p, need in paths.items()
                      if k.name in need and p in launches), None)
        if first is None or k.name not in records:
            if only:   # its phase was left out
                continue
            return fail(f"{k.name}: no record, or no path launched it")
        kernels.append({
            "name": k.name, "launches": launches[first][k.name],
            "launches_path": first,
            "launches_by_path": {p: c[k.name] for p, c in launches.items()},
            **records[k.name],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"e2e": e2e}))
    print(card)
    ok = {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}
    if only:
        ok["phases"] = names
    print(json.dumps(ok))
    return 0


if __name__ == "__main__":
    sys.exit(main())
