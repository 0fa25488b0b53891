#!/usr/bin/env python3
"""Time the SP all-gather attention and the ring all-gathers on one GPU.

    python3 perf/sp_attention_bench.py [--root DIR] [--iters 15] [--plain]
        [--dump FILE] [--ptxas FILE]

Imports ``triton_distributed_tpu_torch`` from ``--root`` (default: this
checkout; point it at an unpacked older commit to time that tree in the
same call: parent, change, change, parent), builds ``csrc/sp_attention.cu``
and ``csrc/collectives.cu`` and times, in bf16:

- ``sp_ag_attention`` at Qwen3-8B's geometry (32 q / 8 kv heads, head dim
  128) over one 32768-token causal sequence sharded over n = 2 and 4
  co-located ranks: the default grid (split by each rank's causal work
  where the tree has it) and the even grid (the co-resident blocks split
  evenly, ``blocks_per_rank``); beside them the port's single-card
  ``flash_attention`` over the gathered sequence, one
  ``scaled_dot_product_attention`` call over it (``library_ms``, O only)
  and the bound (the causal FLOPs over 989 TFLOP/s, every rank on one
  card); ``--plain`` adds the plain version (one q head at a time, ~1 s a
  call);
- ``all_gather_ring`` at [192, 2048] a rank, n = 2, and
  ``all_gather_bidir_ring`` at [96, 2048], n = 4 (the shapes of PERF.md's
  rows), with the like-for-like library call (one ``copy_`` of the stacked
  shards into every rank's output) and the bound (every rank's shard read
  once and n outputs written, over 3.35 TB/s); each ring also at a few
  explicit ``blocks_per_rank``.

Each time is the median over ``--iters`` launches of CUDA-event time with
the L2 cache flushed and a spin kernel ahead of each launch (the method
of ``chip_smoke.py``'s ``median_ms``). One JSON line a measurement, the
card's name and power limit first, then the ptxas lines of the SP builds
(registers, stack, spills, the count of C7510 warnings: wgmma
serialized) and of the ring builds; the whole ptxas report of
``sp_attention.cu`` goes to ``--ptxas`` (default
``build/ptxas_sp_attention_<tag>.txt`` under the root). ``--dump FILE``
saves the outputs of every SP build (f32 and bf16, G 1 to 8, n 2 to 4)
and of both rings at fixed seeded inputs, for ``perf/compare_dumps.py``
(f32 SP and the rings must stay bitwise across trees; bf16 SP changes its
summation order with its tile). Needs CUDA; exits non-zero without it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import tempfile

HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
LEAD_CYCLES = 2_000_000
SEQ, HQ, HKV, HD = 32768, 32, 8, 128


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


def ptxas_report(ck, name: str) -> str:
    """The ptxas report of ``name``.cu (built again if this checkout had
    built it before)."""
    report = ck.build((name,)).get(name, "")
    if report:
        return report
    with tempfile.TemporaryDirectory() as d:
        return subprocess.run(
            [ck._nvcc(), *ck.NVCC_FLAGS, "-o", os.path.join(d, "f.so"),
             str(ck.CSRC / f"{name}.cu")], capture_output=True,
            text=True).stderr


def kernel_lines(report: str, pattern: str) -> list[str]:
    """Each matching kernel's name, registers/stack line and spills line."""
    lines = report.splitlines()
    return [" ".join((line.split()[-1][:90], lines[i + 1].strip(),
                      lines[i + 2].strip()))
            for i, line in enumerate(lines[:-2])
            if "Function properties" in line and pattern in line]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--tag", default="")
    ap.add_argument("--plain", action="store_true",
                    help="also time the plain SP version")
    ap.add_argument("--ptxas", default="",
                    help="path of the ptxas report of sp_attention.cu")
    ap.add_argument("--dump", default="",
                    help="torch.save every build's outputs here")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("sp_attention_bench: no CUDA device", file=sys.stderr)
        return 1
    from triton_distributed_tpu_torch.ops import cuda_kernels as ck
    from triton_distributed_tpu_torch.ops.attention import flash_attention
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    spmod = importlib.import_module(
        "triton_distributed_tpu_torch.ops.attention.sp_ag_attention")
    ag = importlib.import_module(
        "triton_distributed_tpu_torch.ops.collectives.all_gather")
    tag = args.tag or os.path.basename(root)
    card = torch.cuda.get_device_name(0)
    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"root": root, "tag": tag, "device": card,
                      "nvidia_smi": limit.strip()}), flush=True)
    ck.build(("sp_attention", "collectives", "flash_attention"))
    report = ptxas_report(ck, "sp_attention")
    path = args.ptxas or os.path.join(root, "build",
                                      f"ptxas_sp_attention_{tag}.txt")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(report)
    print(json.dumps({"ptxas": path, "c7510": report.count("C7510"),
                      "sp_builds": kernel_lines(report, "sp_ag_attn"),
                      "ring_builds": kernel_lines(
                          ptxas_report(ck, "collectives"), "ag_ring_kernel")}),
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    bf16 = torch.bfloat16

    def emit(rec):
        print(json.dumps({"tag": tag, "device": card, **rec}), flush=True)

    gen = torch.Generator(device=dev).manual_seed(70)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(bf16)
               for shape in ((HQ, SEQ, HD), (HKV, SEQ, HD),
                             (HKV, SEQ, HD)))
    flops = 4 * HQ * HD * SEQ * (SEQ + 1) / 2
    io = (q.numel() * 2 + k.numel() * 4 + q.numel() * 2 + HQ * SEQ * 4)
    bound = max(flops / BF16_FLOPS, io / HBM_BPS) * 1e3
    fa_o = flash_attention(q[None], k[None], v[None], causal=True)[0]
    for n in (2, 4):
        ctx = initialize_distributed(n, device=dev, dtype=bf16)
        qs, ks, vs = ([c.contiguous() for c in torch.chunk(t, n, dim=1)]
                      for t in (q, k, v))

        def run(bpr=None, qs=qs, ks=ks, vs=vs, ctx=ctx):
            return spmod.sp_ag_attention_kernel(
                qs, ks, vs, ctx, sm_scale=HD**-0.5, blocks_per_rank=bpr)

        o, _ = run()
        torch.cuda.synchronize()
        err = float((torch.cat(o, 1).float() - fa_o.float()).abs().max())
        cap = spmod._capacity[(ck.DTYPE_CODES[bf16], HQ // HKV)]
        split = getattr(spmod, "split_by_work", None)
        counts = (split(n, cap, HKV * -(-(SEQ // n) // spmod.q_tile(
            bf16, HQ // HKV))) if split else [cap // n] * n)
        rec = {"name": "sp_ag_attention", "n": n,
               "shape": f"Qwen3-8B geometry S={SEQ} bf16 n={n}",
               "ms": median_ms(run, flush, args.iters),
               "blocks": counts,
               "even_ms": median_ms(lambda: run(cap // n), flush,
                                    args.iters),
               "even_blocks": cap // n, "bound_ms": bound,
               "max_abs_vs_flash_attention": err}
        if n == 2:
            rec["flash_attention_ms"] = median_ms(
                lambda: flash_attention(q[None], k[None], v[None],
                                        causal=True), flush, args.iters)
            rec["library_ms"] = median_ms(
                lambda: F.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=True,
                    enable_gqa=True), flush, args.iters)
            if args.plain:
                g = HQ // HKV

                def plain():
                    for h in range(HQ):
                        spmod.sp_ag_attention_plain(
                            [x[h:h + 1] for x in qs],
                            [x[h // g:h // g + 1] for x in ks],
                            [x[h // g:h // g + 1] for x in vs])
                rec["plain_ms"] = median_ms(plain, flush, 3, warmup=1)
        emit(rec)
        del o, qs, ks, vs
    del q, k, v, fa_o
    torch.cuda.empty_cache()

    rng = np.random.default_rng(20)
    for name, n, rows, sweep in (("all_gather_ring", 2, 192, (12, 24, 96)),
                                 ("all_gather_bidir_ring", 4, 96,
                                  (6, 12, 48))):
        ctx = initialize_distributed(n, device=dev, dtype=bf16)
        xs = [torch.from_numpy(rng.standard_normal((rows, 2048)).astype(
            np.float32)).to(dev, bf16) for _ in range(n)]
        fn = getattr(ag, name)
        got = fn(xs, ctx)
        torch.cuda.synchronize()
        want = ag.all_gather_plain(xs)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        k_, src = n, torch.stack(xs)
        dst = torch.empty((k_, *src.shape), dtype=bf16, device=dev)
        shard = xs[0].numel() * 2
        rec = {"name": name, "n": n, "shape": f"[{rows}, 2048] bf16 a rank",
               "ms": median_ms(lambda: fn(xs, ctx), flush, args.iters),
               "library_ms": median_ms(
                   lambda: dst.copy_(src.expand(k_, *src.shape)), flush,
                   args.iters),
               "plain_ms": median_ms(lambda: ag.all_gather_plain(xs), flush,
                                     args.iters),
               "bound_ms": (n * shard + n * n * shard) / HBM_BPS * 1e3,
               "bitwise": same,
               "by_blocks": {b: median_ms(lambda b=b: fn(xs, ctx, b), flush,
                                          args.iters) for b in sweep}}
        emit(rec)

    if args.dump:
        torch.save(dump_outputs(dev, spmod, ag, initialize_distributed),
                   args.dump)
        print(json.dumps({"dump": args.dump}))
    return 0


def dump_outputs(dev, spmod, ag, initialize_distributed) -> dict:
    """Every SP build's (O, LSE) and both rings' outputs at fixed seeded
    inputs, on the CPU."""
    import numpy as np
    import torch

    rng = np.random.default_rng(21)
    out = {}

    def rand(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for n, hq, hkv, s_loc in ((2, 8, 8, 200), (3, 16, 8, 100),
                                  (4, 16, 4, 96), (2, 16, 2, 130)):
            ctx = initialize_distributed(n, device=dev, dtype=dtype)
            qs = [rand((hq, s_loc, 128), dtype) for _ in range(n)]
            ks = [rand((hkv, s_loc, 128), dtype) for _ in range(n)]
            vs = [rand((hkv, s_loc, 128), dtype) for _ in range(n)]
            o, lse = spmod.sp_ag_attention_kernel(qs, ks, vs, ctx,
                                                  sm_scale=0.1)
            torch.cuda.synchronize()
            out[f"sp {tag} n={n} G={hq // hkv} s_loc={s_loc}"] = [
                t.cpu() for t in (*o, *lse)]
    for name in ("all_gather_ring", "all_gather_bidir_ring"):
        for n, shape, dtype in ((2, (192, 2048), torch.bfloat16),
                                (3, (37, 2048), torch.bfloat16),
                                (4, (7, 129), torch.float32)):
            ctx = initialize_distributed(n, device=dev, dtype=dtype)
            xs = [rand(shape, dtype) for _ in range(n)]
            got = getattr(ag, name)(xs, ctx)
            torch.cuda.synchronize()
            out[f"{name} n={n} {list(shape)}"] = [t.cpu() for t in got]
    return out


if __name__ == "__main__":
    sys.exit(main())
