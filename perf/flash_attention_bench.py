#!/usr/bin/env python3
"""Time the prefill flash attention kernels on one NVIDIA GPU.

    python3 perf/flash_attention_bench.py [--root DIR] [--iters 15]
        [--dump FILE]

Imports ``triton_distributed_tpu_torch`` from ``--root`` (default: this
checkout; point it at an unpacked older commit to time that tree in the
same call), builds ``csrc/flash_attention.cu`` and times, in bf16:

- ``flash_attention`` (causal): the smoke's chunk (q [1, 16, 256, 128]
  against 768 keys at kv_offset 512, 8 kv heads), the Qwen3-8B tp=2
  chunk of a rank (q [1, 16, 384, 128], 4 kv heads, 384 keys at offset
  0) and Qwen3-30B-A3B's G = 8 (q [1, 32, 256, 128], 4 kv heads, 768
  keys at offset 512);
- ``flash_attention_cold`` (non-causal): the smoke's cold partial (q [1,
  16, 128, 128] against a 2048-key window, s_cold 1536, with the
  [128, 2048] f32 bias, and the LSE) and the same call without the bias
  (every column visible, as ring attention calls it);
- ``flash_attention_bias`` (causal, the draft-tree bias): the tree
  verify chunk (q [1, 16, 16, 128] against the 2048-key gathered view at
  kv_offset 700, 8 kv heads, the 14-node tree's ancestor mask expanded
  as the model expands it), beside SDPA with the bias and the causal
  limit as one bf16 ``attn_mask``; its bound counts the (row, key) pairs
  the mask and causality leave visible, and the K/V, bias rows read up
  to the causal limit.

Each time is the median over ``--iters`` launches of CUDA-event time with
the L2 cache flushed and a spin kernel ahead of each launch (the method
of ``chip_smoke.py``'s ``median_ms``). Beside it: the plain version's
time, one ``scaled_dot_product_attention`` call (``library_ms``: with
``is_causal`` where the chunk starts at 0, else with the boolean causal
mask or the bias as ``attn_mask``; it returns no LSE), the bound (the
larger of the bytes each operand is read or written once over 3.35 TB/s
and the FLOPs of the visible (row, key) pairs over 989 TFLOP/s) and the
largest difference from the plain version. One JSON line a launch, the
card's name and power limit first, then the ptxas lines of the
tensor-core builds (registers, stack, spills, and the count of C7510
warnings: wgmma serialized); the whole ptxas report goes to ``--ptxas``
(default ``build/ptxas_flash_attention_<tag>.txt`` under the root).

``--dump FILE`` also saves, with ``torch.save``, the outputs of every
build at fixed seeded inputs, the FMA builds included (f32, head_dim 32,
int8 K/V causal and cold, the causal call with a bias):
``perf/compare_dumps.py`` holds two trees' dumps bit for bit. Needs CUDA;
exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
LEAD_CYCLES = 2_000_000


def median_ms(fn, flush, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(LEAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ptxas_report(ck) -> str:
    """The ptxas report of flash_attention.cu (built again if this
    checkout had built it before)."""
    report = ck.build(("flash_attention",)).get("flash_attention", "")
    if report:
        return report
    with tempfile.TemporaryDirectory() as d:
        return subprocess.run(
            [ck._nvcc(), *ck.NVCC_FLAGS, "-o", os.path.join(d, "f.so"),
             str(ck.CSRC / "flash_attention.cu")], capture_output=True,
            text=True).stderr


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--tag", default="")
    ap.add_argument("--ptxas", default="",
                    help="path of the ptxas report of flash_attention.cu")
    ap.add_argument("--dump", default="",
                    help="torch.save every build's outputs here")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_attention_bench: no CUDA device", file=sys.stderr)
        return 1
    from triton_distributed_tpu_torch.ops import cuda_kernels as ck
    from triton_distributed_tpu_torch.ops.attention import (
        flash_attention,
        mha_reference,
    )

    tag = args.tag or os.path.basename(root)
    card = torch.cuda.get_device_name(0)
    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"root": root, "tag": tag, "device": card,
                      "nvidia_smi": limit.strip()}))
    report = ptxas_report(ck)
    path = args.ptxas or os.path.join(root, "build",
                                      f"ptxas_flash_attention_{tag}.txt")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(report)
    lines = report.splitlines()
    tc = [" ".join((line.split()[-1][:90], lines[i + 1].strip(),
                    lines[i + 2].strip()))
          for i, line in enumerate(lines[:-2])
          if "Function properties" in line
          and "flash_attention_tc_kernel" in line]
    print(json.dumps({"ptxas": path, "c7510": report.count("C7510"),
                      "tc_builds": tc}))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    bf16 = torch.bfloat16

    def rand(rng, shape, dtype=bf16):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def emit(name, shape, fn, plain, lib, lib_call, nbytes_, flops):
        out = fn()
        want = plain()
        if isinstance(out, tuple):
            e = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(out, want))
        else:
            e = float((out.float() - want.float()).abs().max())
        tb, to = nbytes_ / HBM_BPS, flops / BF16_FLOPS
        rec = {"tag": tag, "name": name, "shape": shape,
               "ms": median_ms(fn, flush, args.iters),
               "plain_ms": median_ms(plain, flush, args.iters),
               "library_ms": median_ms(lib, flush, args.iters),
               "library_call": lib_call,
               "bound_ms": max(tb, to) * 1e3,
               "bound_by": "bytes" if tb >= to else "operations",
               "max_abs_err": e, "device": card}
        print(json.dumps(rec), flush=True)

    # Causal chunks: (name, q heads, kv heads, rows, kv_offset).
    for name, hq, hkv, sq, off in (("flash_attention", 16, 8, 256, 512),
                                   ("flash_attention_tp2_chunk384", 16, 4,
                                    384, 0),
                                   ("flash_attention_g8", 32, 4, 256, 512)):
        rng = np.random.default_rng(18)
        sk = off + sq
        q, k, v = (rand(rng, (1, hq, sq, 128)), rand(rng, (1, hkv, sk, 128)),
                   rand(rng, (1, hkv, sk, 128)))
        if off == 0:
            def lib(q=q, k=k, v=v):
                return F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=True,
                                                      enable_gqa=True)
            call = "sdpa is_causal"
        else:
            mask = (torch.arange(sk, device=dev)[None, :]
                    <= off + torch.arange(sq, device=dev)[:, None])

            def lib(q=q, k=k, v=v, mask=mask):
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                      enable_gqa=True)
            call = "sdpa attn_mask=causal bool"
        flops = 4 * hq * 128 * sum(min(sk, off + r + 1) for r in range(sq))
        emit(name, f"q[1,{hq},{sq},128] kv[1,{hkv},{sk},128] off={off} bf16",
             lambda q=q, k=k, v=v, off=off: flash_attention(
                 q, k, v, kv_offset=off),
             lambda q=q, k=k, v=v, off=off: mha_reference(
                 q, k, v, kv_offset=off),
             lib, call, nbytes(q, k, v) + nbytes(q), flops)

    # The cold partial: a 128-row chunk against a 16-page window.
    rng = np.random.default_rng(19)
    hq, hkv, sq, sk, vis = 16, 8, 128, 2048, 1536
    qc, kc, vc = (rand(rng, (1, hq, sq, 128)), rand(rng, (1, hkv, sk, 128)),
                  rand(rng, (1, hkv, sk, 128)))
    bias = torch.where(torch.arange(sk, device=dev) < vis, 0.0,
                       -1e30)[None].expand(sq, sk).contiguous()
    amask = bias.to(bf16)
    io = nbytes(qc) * 2 + hq * sq * 4  # q, O, LSE
    emit("flash_attention_cold",
         f"q[1,{hq},{sq},128] cold kv[1,{hkv},{sk},128] s_cold={vis} "
         f"bias [{sq},{sk}] bf16",
         lambda: flash_attention(qc, kc, vc, causal=False, bias=bias,
                                 return_lse=True),
         lambda: mha_reference(qc, kc, vc, causal=False, bias=bias,
                               return_lse=True),
         lambda: F.scaled_dot_product_attention(qc, kc, vc, attn_mask=amask,
                                                enable_gqa=True),
         "sdpa attn_mask=bias (O only)",
         io + sq * sk * 4 + 2 * hkv * vis * 128 * 2,
         4 * hq * 128 * sq * vis)
    emit("flash_attention_cold_nobias",
         f"q[1,{hq},{sq},128] kv[1,{hkv},{sk},128] non-causal bf16",
         lambda: flash_attention(qc, kc, vc, causal=False, return_lse=True),
         lambda: mha_reference(qc, kc, vc, causal=False, return_lse=True),
         lambda: F.scaled_dot_product_attention(qc, kc, vc, enable_gqa=True),
         "sdpa (O only)", io + 2 * hkv * sk * 128 * 2,
         4 * hq * 128 * sq * sk)

    # Tree verify: 16 rows at kv_offset 700 of a 2048-key view.
    from triton_distributed_tpu_torch.models.qwen import expand_tree_mask
    from triton_distributed_tpu_torch.models.speculative import TreeDraft

    rng = np.random.default_rng(22)
    hq, hkv, sq, sk, off = 16, 8, 16, 2048, 700
    qv, kv, vv = (rand(rng, (1, hq, sq, 128)), rand(rng, (1, hkv, sk, 128)),
                  rand(rng, (1, hkv, sk, 128)))
    tree = TreeDraft(4)
    for path in ([1, 2, 3, 4], [1, 5, 6], [7, 8, 9, 10], [7, 2], [11, 12]):
        tree.add_path(path, budget=sq)
    tbias = expand_tree_mask(tree.mask(sq), off, sk, dev)
    causal = (torch.arange(sk, device=dev)[None, :]
              <= off + torch.arange(sq, device=dev)[:, None])
    visible = int(((tbias == 0) & causal).sum().item())
    tmask = torch.where(causal, tbias, torch.full_like(tbias, -1e30)).to(bf16)
    kv_end = off + sq
    emit("flash_attention_bias",
         f"q[1,{hq},{sq},128] kv[1,{hkv},{sk},128] off={off} tree bias "
         f"[{sq},{sk}] bf16",
         lambda: flash_attention(qv, kv, vv, kv_offset=off, bias=tbias),
         lambda: mha_reference(qv, kv, vv, kv_offset=off, bias=tbias),
         lambda: F.scaled_dot_product_attention(qv, kv, vv, attn_mask=tmask,
                                                enable_gqa=True),
         "sdpa attn_mask=bias+causal bf16",
         nbytes(qv) * 2 + 2 * hkv * kv_end * 128 * 2 + sq * kv_end * 4,
         4 * hq * 128 * visible)

    if args.dump:
        torch.save(dump_outputs(dev, flash_attention), args.dump)
        print(json.dumps({"dump": args.dump}))
    return 0


def dump_outputs(dev, flash_attention) -> dict:
    """Every build's (O, LSE) at fixed seeded inputs, on the CPU."""
    import numpy as np
    import torch

    from triton_distributed_tpu_torch.models.paged_kv_cache import (
        quantize_pages,
    )

    rng = np.random.default_rng(20)
    bf16, f32 = torch.bfloat16, torch.float32

    def rand(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    out = {}

    def put(name, res):
        torch.cuda.synchronize()
        out[name] = [t.cpu() for t in res]

    for dtype, tag in ((bf16, "bf16"), (f32, "f32")):
        q = rand((1, 16, 256, 128), dtype)
        k, v = rand((1, 8, 768, 128), dtype), rand((1, 8, 768, 128), dtype)
        put(f"causal {tag}", flash_attention(q, k, v, kv_offset=512,
                                             return_lse=True))
        qt = rand((1, 8, 48, 32), dtype)
        kt, vt = rand((1, 4, 80, 32), dtype), rand((1, 4, 80, 32), dtype)
        put(f"d32 {tag}", flash_attention(qt, kt, vt, kv_offset=32,
                                          return_lse=True))
        kq, ks = quantize_pages(rand((8, 6, 128, 128), f32))
        vq, vs = quantize_pages(rand((8, 6, 128, 128), f32))
        k8, v8 = kq.reshape(1, 8, 768, 128), vq.reshape(1, 8, 768, 128)
        q8 = dict(k_scale=ks[None].contiguous(), v_scale=vs[None].contiguous(),
                  block_k=128)
        put(f"int8 causal {tag}", flash_attention(
            q, k8, v8, kv_offset=512, return_lse=True, **q8))
        qc = rand((1, 16, 128, 128), dtype)
        bias = torch.where(torch.arange(768, device=dev) < 640, 0.0,
                           -1e30)[None].expand(128, 768).contiguous()
        put(f"int8 cold {tag}", flash_attention(
            qc, k8, v8, causal=False, bias=bias, return_lse=True, **q8))
        put(f"cold {tag}", flash_attention(qc, k, v, causal=False, bias=bias,
                                           return_lse=True))
        qv = rand((1, 16, 16, 128), dtype)
        tree = torch.from_numpy(np.where(rng.random((16, 768)) < 0.7, 0.0,
                                         -1e30).astype(np.float32)).to(dev)
        put(f"causal bias {tag}", flash_attention(
            qv, k, v, kv_offset=700, bias=tree, return_lse=True))
    return out


if __name__ == "__main__":
    sys.exit(main())
