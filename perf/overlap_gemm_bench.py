#!/usr/bin/env python3
"""Time the launches of ag_gemm, gemm_rs and gemm_ar on one NVIDIA GPU.

    python3 perf/overlap_gemm_bench.py [--root DIR] [--iters 15]

Imports ``triton_distributed_tpu_torch`` from ``--root`` (default: this
checkout; point it at an unpacked older commit to time that tree in the
same call), builds ``csrc/overlap.cu`` and times, at Qwen3-8B tp=2 with
both ranks co-located on the card (bf16, M = 384 rows, m_per 192), the
launches of the sequence-sharded prefill:

- ``ag_gemm`` QKV (K 4096, n_loc 3072) and FC1 (n_loc 12288), the ring
  build and the arrival-adaptive one;
- ``gemm_rs`` o-proj (k_loc 2048, N 4096) and FC2 (k_loc 6144), the bf16
  ring (bidirectional, the default split), the o-proj with an e4m3 wire,
  and the one-rank ring (``force_kernel`` at tp=1: [384, 4096] @
  [4096, 4096]);
- ``gemm_ar`` (the one-shot) at the decode o-proj (M = 4, k_loc 2048, N
  4096) and FC2 (k_loc 6144) and at the 48-row prefill chunk (o-proj and
  FC2), each untraced and traced (tile_n 512, the default at N 4096); its
  lines add ``floor_ms``, the time of one launch at [1, 64] @ [64, 64] a
  rank (the launch, the entry barrier and the flag round trips alone),
  and ``host_us``, the host's wall time to issue one call of the wrapper
  (the mean over 200 calls back to back, no synchronization between
  them: planning, tensor maps and the launch itself).

Each time is the median over ``--iters`` launches of CUDA-event time
with the L2 cache flushed and a spin kernel ahead of each launch (the
method of ``chip_smoke.py``'s ``median_ms``). Beside it: the plain
version's time, one ``torch.matmul`` of the unsharded operands (the
library call), the bound (the larger of all ranks' bytes over 3.35 TB/s
and the FLOPs over 989 TFLOP/s), the largest difference from the plain
version, and the co-resident blocks an SM of the build. One JSON line a
launch, the card's name and power limit first, then the ptxas lines of
the wgmma builds (registers, stack, spills, and the count of C7510
warnings: wgmma serialized); the whole ptxas report of ``overlap.cu``
goes to ``--ptxas`` (default ``build/ptxas_overlap_<tag>.txt`` under the
root). ``--dump FILE`` saves every timed launch's outputs (the same
seeded inputs in every tree; bf16 gemm_ar's rows differ from a tree
before its split-K kernel by design, f32 gemm_ar's at the decode shapes
are added) for ``perf/compare_dumps.py``. Needs CUDA; exits non-zero
without it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

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


def host_us(fn, calls: int = 200) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--tag", default="")
    ap.add_argument("--ptxas", default="",
                    help="path of the ptxas report of overlap.cu")
    ap.add_argument("--dump", default="",
                    help="torch.save every launch's outputs here")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("overlap_gemm_bench: no CUDA device", file=sys.stderr)
        return 1
    from triton_distributed_tpu_torch.ops import cuda_kernels as ck
    from triton_distributed_tpu_torch.ops.overlap import (
        _launch,
        ag_gemm_plain,
        create_gemm_rs_context,
        gemm_rs_plain,
    )
    from triton_distributed_tpu_torch.ops.overlap.ag_gemm import (
        ag_gemm_kernel,
    )
    from triton_distributed_tpu_torch.ops.overlap import (
        gemm_ar_plain,
        gemm_ar_ring_plain,
    )
    from triton_distributed_tpu_torch.ops.overlap.gemm_ar import (
        gemm_ar_one_shot,
        gemm_ar_traced,
    )
    from triton_distributed_tpu_torch.ops.overlap.gemm_rs import (
        gemm_rs_ring,
        ring_split,
    )
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    tag = args.tag or os.path.basename(root)
    card = torch.cuda.get_device_name(0)
    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"root": root, "tag": tag, "device": card,
                      "nvidia_smi": limit.strip()}))
    report = ck.build(("overlap",)).get("overlap", "")
    if not report:  # built before in this checkout: compile again for it
        with tempfile.TemporaryDirectory() as d:
            report = subprocess.run(
                [ck._nvcc(), *ck.NVCC_FLAGS, "-o", os.path.join(d, "o.so"),
                 str(ck.CSRC / "overlap.cu")], capture_output=True,
                text=True).stderr
    path = args.ptxas or os.path.join(root, "build",
                                      f"ptxas_overlap_{tag}.txt")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(report)
    lines = report.splitlines()
    wgmma = [" ".join((line.split()[-1][40:100], lines[i + 1].strip(),
                       lines[i + 2].strip()))
             for i, line in enumerate(lines[:-2])
             if "Function properties" in line
             and ("WgTile" in line or "gemm_ar" in line)]
    print(json.dumps({"ptxas": path, "c7510": report.count("C7510"),
                      "wgmma_builds": wgmma}))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(17)
    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def rand(shape, scale=1.0):
        return (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev) * scale).to(bf16)

    def operands(n, m, k, nout, rows):
        ctx = initialize_distributed(n, device=dev, dtype=bf16)
        a, b = rand((m, k)), rand((k, nout), k**-0.5)
        if rows:
            return ctx, ctx.shard(a, 0), ctx.shard(b, 1), a, b
        return ctx, ctx.shard(a, 1), ctx.shard(b, 0), a, b

    def err(got, want):
        return max(float((g.float() - w.float()).abs().max())
                   for g, w in zip(got, want))

    dumps = {}

    def emit(name, shape, kind, fn, plain, lib, nbytes, flops, e, small,
             wire=None, extra=None):
        if args.dump:
            flat, todo = [], [fn()]
            while todo:  # the launch's tensors, nested lists unrolled
                x = todo.pop(0)
                if torch.is_tensor(x):
                    flat.append(x)
                elif isinstance(x, (list, tuple)):
                    todo[:0] = list(x)
            torch.cuda.synchronize()
            dumps[name] = [t.cpu() for t in flat]
        tb, to = nbytes / HBM_BPS, flops / BF16_FLOPS
        rec = {"tag": tag, "name": name, "shape": shape,
               "ms": median_ms(fn, flush, args.iters),
               "plain_ms": median_ms(plain, flush, args.iters),
               "library_ms": median_ms(lib, flush, args.iters),
               "bound_ms": max(tb, to) * 1e3,
               "bound_by": "bytes" if tb >= to else "operations",
               "max_abs_err": e,
               "blocks_per_sm": _launch.capacity(kind, bf16, small, wire)
               / sms,
               "device": card, **(extra or {})}
        print(json.dumps(rec), flush=True)

    n, d, ff = 2, 4096, 12288
    # gemm_ar: the bound is all ranks' bytes (each rank's A and B read
    # once, each rank's output written once) or the FLOPs; the library
    # call one torch.matmul of the unsharded operands.
    ctx, a, b, A, B = operands(n, 1, 64 * n, 64, rows=False)
    floor = median_ms(lambda: gemm_ar_one_shot(a, b, ctx), flush, args.iters)
    for m, k, what in ((4, d, "decode o-proj"), (4, ff, "decode FC2"),
                       (48, d, "chunk o-proj"), (48, ff, "chunk FC2")):
        ctx, a, b, A, B = operands(n, m, k, d, rows=False)
        tag_ = "gemm_ar_" + what.replace(" ", "_").replace("-", "")
        nbytes, flops = 2 * (m * k + k * d) + n * m * d * 2, 2 * m * k * d
        num_j = d // 512
        e = err(gemm_ar_one_shot(a, b, ctx), gemm_ar_plain(a, b))
        emit(tag_, f"tp={n} M={m} k_loc={k // n} N={d} ({what})", "gemm_ar",
             lambda: gemm_ar_one_shot(a, b, ctx),
             lambda: gemm_ar_plain(a, b), lambda: torch.matmul(A, B),
             nbytes, flops, e, m <= _launch.SMALL_M,
             extra={"floor_ms": floor,
                    "host_us": host_us(lambda: gemm_ar_one_shot(a, b, ctx))})
        e = err(gemm_ar_traced(a, b, ctx, 512)[0], gemm_ar_plain(a, b))
        emit(tag_ + "_traced", f"tp={n} M={m} k_loc={k // n} N={d} "
             f"tile_n 512 ({what})", "gemm_ar_traced",
             lambda: gemm_ar_traced(a, b, ctx, 512),
             lambda: (gemm_ar_plain(a, b), gemm_ar_ring_plain(n, num_j)),
             lambda: torch.matmul(A, B), nbytes, flops, e,
             m <= _launch.SMALL_M,
             extra={"floor_ms": floor, "host_us": host_us(
                 lambda: gemm_ar_traced(a, b, ctx, 512))})
        del a, b, A, B
    if args.dump:  # f32 gemm_ar (the FMA tile) at the decode shapes
        f32_rng = np.random.default_rng(21)
        for m, k in ((4, d), (48, ff)):
            ctx32 = initialize_distributed(n, device=dev, dtype=torch.float32)
            a = torch.from_numpy(f32_rng.standard_normal((m, k)).astype(
                np.float32)).to(dev)
            b = torch.from_numpy((f32_rng.standard_normal((k, d)) * k**-0.5
                                  ).astype(np.float32)).to(dev)
            a, b = ctx32.shard(a, 1), ctx32.shard(b, 0)
            outs = [gemm_ar_one_shot(a, b, ctx32),
                    gemm_ar_traced(a, b, ctx32, 512)]
            torch.cuda.synchronize()
            dumps[f"gemm_ar f32 M={m} K={k}"] = [
                t.cpu() for o in outs for t in (o if isinstance(o, list)
                                               else o[0])]
    m = 384
    for name, nl in (("ag_gemm_qkv", 3072), ("ag_gemm_fc1", 2 * ff // n)):
        ctx, a, b, A, B = operands(n, m, d, nl * n, rows=True)
        want = ag_gemm_plain(a, b)
        for adaptive in (False, True):
            e = err(ag_gemm_kernel(a, b, ctx, adaptive=adaptive)[0], want)
            emit(name + ("_adaptive" if adaptive else "_ring"),
                 f"tp={n} M={m} K={d} n_loc={nl}",
                 "ag_gemm_adaptive" if adaptive else "ag_gemm",
                 lambda: ag_gemm_kernel(a, b, ctx, adaptive=adaptive),
                 lambda: ag_gemm_plain(a, b), lambda: torch.matmul(A, B),
                 2 * (m * d + d * nl * n) + n * m * nl * 2,
                 2 * m * d * nl * n, e, False)
        del a, b, A, B
    for name, k in (("gemm_rs_oproj", d), ("gemm_rs_fc2", ff)):
        ctx, a, b, A, B = operands(n, m, k, d, rows=False)
        half = ring_split(m // n, create_gemm_rs_context(m, k // n, bf16,
                                                         n_ranks=n))
        wires = (None, torch.float8_e4m3fn) if k == d else (None,)
        for wire in wires:
            e = err(gemm_rs_ring(a, b, ctx, half, wire_dtype=wire),
                    gemm_rs_plain(a, b, half, wire))
            emit(name + ("_e4m3" if wire else ""),
                 f"tp={n} M={m} k_loc={k // n} N={d} half_m={half}",
                 "gemm_rs",
                 lambda: gemm_rs_ring(a, b, ctx, half, wire_dtype=wire),
                 lambda: gemm_rs_plain(a, b, half, wire),
                 lambda: torch.matmul(A, B),
                 2 * (m * k + k * d) + m * d * 2, 2 * m * k * d, e, False,
                 wire)
        del a, b, A, B
    ctx, a, b, A, B = operands(1, m, d, d, rows=False)
    e = err(gemm_rs_ring(a, b, ctx, m), gemm_rs_plain(a, b))
    emit("gemm_rs_n1", f"tp=1 M={m} K={d} N={d}", "gemm_rs",
         lambda: gemm_rs_ring(a, b, ctx, m), lambda: gemm_rs_plain(a, b),
         lambda: torch.matmul(A, B), 2 * (m * d + d * d + m * d),
         2 * m * d * d, e, False)
    if args.dump:
        torch.save(dumps, args.dump)
        print(json.dumps({"dump": args.dump}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
