#!/usr/bin/env python3
"""Time the reduce-scatters, the doubling all-reduce and the low-latency
all-gather on one GPU.

    python3 perf/collectives_bench.py [--root DIR] [--iters 15] [--tag T]
        [--dump FILE] [--no-sweep]

Imports ``triton_distributed_tpu_torch`` from ``--root`` (default: this
checkout; point it at an unpacked older commit to time that tree in the
same call: parent, change, change, parent), builds
``csrc/collectives.cu`` and times, in bf16 over ranks co-located on the
card:

- the three ring reduce-scatters at ``chip_smoke.py``'s timed shapes
  (``MOE_TP_TIMED``): ``reduce_scatter_bidir_ring`` n = 4, [384, 2048] a
  rank; ``reduce_scatter_ring`` n = 2, [300, 2048];
  ``reduce_scatter_ring_hbm`` n = 2, [1152, 2048]; each beside its plain
  version (the ring's order and roundings), the PyTorch call
  (``torch.stack(xs).sum(0)``) and the bound (every rank's input read
  once and its chunk written once, over 3.35 TB/s);
- ``reduce_scatter_one_shot`` at [48, 2048] a rank and
  ``all_reduce_doubling`` at [112, 2048] (``MOE_TP_TIMED``), each at n = 2
  and 4, beside its plain version (the one-shot's source order, the
  doubling's rounded partner sums), ``torch.stack(xs).sum(0)`` and the
  bound (the one-shot as the rings; the all-reduce n inputs read and n
  outputs written), with the grid the tree's launcher takes;
- ``ll_all_gather`` at [8, 4096] a rank, n = 4 and 8, chained calls on
  one workspace, beside the full-mesh gather at its own grid and at the
  LL's, the plain gather (``torch.cat``), the PyTorch call (one ``copy_``
  of the stacked shards into every rank's output) and the bound (n shards
  read, n * n written);
- unless ``--no-sweep``, each kernel again at a range of blocks a rank
  (the LL where the tree's ``ll_all_gather_workspace`` takes a grid).

Each time is ``chip_smoke.median_ms``'s reading: the median of
``--iters`` CUDA-event timings, the L2 cache flushed and a spin kernel
ahead of each launch, after 3 warm-up calls. One JSON line a
measurement; first the card's name and power limit, then the ptxas
lines (registers, stack, spills) of every build of the four kernels.
``--dump FILE`` saves the outputs at ``chip_smoke.py``'s check shapes
(the three rings and the one-shot at n = 2 and 4, f32 and bf16, rows 48,
304 and 1152 a rank at d = 2048, and the timed shapes; the doubling at
rows 4, 112 and 384) and of chained LL calls at n = 4 and 8, for
``perf/compare_dumps.py``: the reductions must stay bitwise across trees,
and the LL gathers are the shards. Needs CUDA; exits non-zero without it.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import itertools
import json
import os
import subprocess
import sys

from sp_attention_bench import kernel_lines, ptxas_report

HBM_BPS = 3.35e12
D = 2048
# (name, method, n, rows a rank at d = 2048, blocks a rank to sweep)
RS_TIMED = (
    ("reduce_scatter_bidir_ring", "PALLAS_BIDIR_RING", 4, 384,
     (6, 12, 24, 48, 96)),
    ("reduce_scatter_ring", "PALLAS_RING", 2, 300, (10, 19, 38, 76, 132)),
    ("reduce_scatter_ring_hbm", "PALLAS_RING_HBM", 2, 1152,
     (18, 36, 72, 132, 264)),
)
RS_CHECK_ROWS = (48, 304, 1152)
# (name, method, n, rows a rank at d = 2048, blocks a rank to sweep)
REDUCE_TIMED = (
    ("reduce_scatter_one_shot", "ONE_SHOT", 2, 48,
     (2, 6, 12, 18, 24, 30, 36, 48)),
    ("reduce_scatter_one_shot", "ONE_SHOT", 4, 48, (5, 10, 21, 24, 30, 42)),
    ("all_reduce_doubling", "DOUBLING", 2, 112, (7, 14, 28, 42, 56, 84,
                                                 112)),
    ("all_reduce_doubling", "DOUBLING", 4, 112, (7, 14, 28, 42, 56)),
    ("all_reduce_doubling", "DOUBLING", 8, 112, (7, 14, 28, 33)),
)
AR_CHECK_ROWS = (4, 112, 384)
LL_ROWS, LL_COLS, LL_RANKS = 8, 4096, (4, 8)
LL_SWEEP = (1, 2, 4, 7, 14, 28, 56)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--tag", default="")
    ap.add_argument("--dump", default="",
                    help="torch.save the outputs at the check shapes here")
    ap.add_argument("--no-sweep", action="store_true",
                    help="skip the sweep of blocks a rank")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from chip_smoke import median_ms

    if not torch.cuda.is_available():
        print("collectives_bench: no CUDA device", file=sys.stderr)
        return 1
    from triton_distributed_tpu_torch.ops import cuda_kernels as ck
    from triton_distributed_tpu_torch.ops import collectives as col
    from triton_distributed_tpu_torch.ops.collectives import _launch
    from triton_distributed_tpu_torch.runtime import initialize_distributed

    llm = importlib.import_module(
        "triton_distributed_tpu_torch.ops.collectives.low_latency")
    tag = args.tag or os.path.basename(root)
    card = torch.cuda.get_device_name(0)
    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"root": root, "tag": tag, "device": card,
                      "nvidia_smi": limit.strip()}), flush=True)
    report = ptxas_report(ck, "collectives")
    print(json.dumps({"tag": tag, "rs_ring_builds": kernel_lines(
        report, "rs_ring_kernel"), "rs_one_shot_builds": kernel_lines(
            report, "rs_one_shot_kernel"), "ar_doubling_builds": kernel_lines(
            report, "ar_doubling_kernel"), "ll_builds": kernel_lines(
            report, "ll_ag_kernel")}), flush=True)
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    bf16 = torch.bfloat16
    rng = np.random.default_rng(90)

    def emit(rec):
        print(json.dumps({"tag": tag, "device": card, **rec}), flush=True)

    def shards(n, rows, cols, dtype=bf16):
        return [torch.from_numpy(rng.standard_normal((rows, cols)).astype(
            np.float32)).to(dev, dtype) for _ in range(n)]

    def rs_plain(method, xs):
        m_per = xs[0].shape[0] // len(xs)
        half = m_per // 2 if method == "PALLAS_BIDIR_RING" else None
        return col.reduce_scatter_ring_plain(xs, half)

    for name, method, n, rows, sweep in RS_TIMED:
        ctx = initialize_distributed(n, device=dev, dtype=bf16)
        xs = shards(n, rows, D)
        m = col.ReduceScatterMethod[method]

        def run(bpr=None, m=m, xs=xs, ctx=ctx):
            return col.reduce_scatter_kernel(m, xs, ctx,
                                             blocks_per_rank=bpr)

        got = run()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, rs_plain(method,
                                                                   xs)))
        shard = xs[0].numel() * 2
        rec = {"name": name, "n": n, "shape": f"[{rows}, {D}] bf16 a rank",
               "ms": median_ms(run, flush, args.iters),
               "plain_ms": median_ms(lambda xs=xs, method=method: rs_plain(
                   method, xs), flush, args.iters),
               "library_ms": median_ms(
                   lambda xs=xs: torch.stack(xs).sum(0), flush, args.iters),
               "bound_ms": (n * shard + shard) / HBM_BPS * 1e3,
               "bitwise_plain": same}
        if not args.no_sweep:
            most = _launch.capacity(_launch.REDUCE_SCATTER,
                                    {"PALLAS_RING": 1,
                                     "PALLAS_BIDIR_RING": 2,
                                     "PALLAS_RING_HBM": 3}[method], bf16) // n
            rec["by_blocks"] = {b: median_ms(lambda b=b: run(b), flush,
                                             args.iters)
                                for b in sweep if b <= most}
        emit(rec)

    rsm = importlib.import_module(
        "triton_distributed_tpu_torch.ops.collectives.reduce_scatter")
    arm = importlib.import_module(
        "triton_distributed_tpu_torch.ops.collectives.all_reduce")
    for name, method, n, rows, sweep in REDUCE_TIMED:
        ctx = initialize_distributed(n, device=dev, dtype=bf16)
        xs = shards(n, rows, D)
        shard = xs[0].numel() * 2
        if name.startswith("reduce_scatter"):
            m, plain = (col.ReduceScatterMethod[method],
                        col.reduce_scatter_one_shot_plain)
            launch, fam, kind = (col.reduce_scatter_kernel,
                                 _launch.REDUCE_SCATTER, 0)
            grid = rsm.scatter_grid(0, bf16, n, shard // n)
            moved = n * shard + shard
        else:
            m, plain = (col.AllReduceMethod[method],
                        col.all_reduce_doubling_plain)
            launch, fam, kind = col.all_reduce_kernel, _launch.ALL_REDUCE, 1
            grid = (arm.reduce_grid(1, bf16, n, shard)
                    if hasattr(arm, "reduce_grid")
                    else _launch.blocks(fam, kind, bf16, n, shard))
            moved = 2 * n * shard

        def run(bpr=None, m=m, xs=xs, ctx=ctx, launch=launch):
            return launch(m, xs, ctx, blocks_per_rank=bpr)

        got = run()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, plain(xs)))
        rec = {"name": name, "n": n, "shape": f"[{rows}, {D}] bf16 a rank",
               "blocks": grid, "ms": median_ms(run, flush, args.iters),
               "plain_ms": median_ms(lambda xs=xs, plain=plain: plain(xs),
                                     flush, args.iters),
               "library_ms": median_ms(
                   lambda xs=xs: torch.stack(xs).sum(0), flush, args.iters),
               "bound_ms": moved / HBM_BPS * 1e3, "bitwise_plain": same}
        if not args.no_sweep:
            most = _launch.capacity(fam, kind, bf16) // n
            rec["by_blocks"] = {b: median_ms(lambda b=b, run=run: run(b),
                                             flush, args.iters)
                                for b in sweep if b <= most}
        emit(rec)

    takes_grid = "blocks_per_rank" in inspect.signature(
        llm.ll_all_gather_workspace).parameters
    for n in LL_RANKS:
        ctx = initialize_distributed(n, device=dev, dtype=bf16)
        xs = shards(n, LL_ROWS, LL_COLS)

        def ll(ws, xs=xs, ctx=ctx):
            phases = itertools.count(ws.phase + 1)
            return lambda: llm.ll_all_gather_kernel(xs, ws, next(phases),
                                                    ctx)

        ws = llm.ll_all_gather_workspace(ctx, LL_ROWS, LL_COLS, bf16)
        got = ll(ws)()
        torch.cuda.synchronize()
        same = all(torch.equal(g, torch.cat(xs)) for g in got)
        src = torch.stack(xs)
        dst = torch.empty((n, *src.shape), dtype=bf16, device=dev)
        shard = xs[0].numel() * 2
        rec = {"name": "ll_all_gather", "n": n,
               "shape": f"[{LL_ROWS}, {LL_COLS}] bf16 a rank",
               "blocks": ws.blocks, "ms": median_ms(ll(ws), flush,
                                                    args.iters),
               "full_mesh_ms": median_ms(
                   lambda xs=xs, ctx=ctx: col.all_gather_full_mesh(xs, ctx),
                   flush, args.iters),
               "full_mesh_ll_grid_ms": median_ms(
                   lambda xs=xs, ctx=ctx, g=ws.blocks:
                   col.all_gather_full_mesh(xs, ctx, g), flush, args.iters),
               "plain_ms": median_ms(lambda xs=xs: col.all_gather_plain(xs),
                                     flush, args.iters),
               "library_ms": median_ms(
                   lambda dst=dst, src=src: dst.copy_(
                       src.expand(n, *src.shape)), flush, args.iters),
               "bound_ms": (n + n * n) * shard / HBM_BPS * 1e3,
               "bitwise_shards": same}
        if takes_grid and not args.no_sweep:
            rec["by_blocks"] = {}
            most = _launch.capacity(_launch.LOW_LATENCY, 0, bf16) // n
            for b in (b for b in LL_SWEEP if b <= most):
                ws_b = llm.ll_all_gather_workspace(ctx, LL_ROWS, LL_COLS,
                                                   bf16, blocks_per_rank=b)
                rec["by_blocks"][b] = median_ms(ll(ws_b), flush, args.iters)
        emit(rec)

    if args.dump:
        torch.save(dump_outputs(dev, col, llm, initialize_distributed),
                   args.dump)
        print(json.dumps({"dump": args.dump}))
    return 0


def dump_outputs(dev, col, llm, initialize_distributed) -> dict:
    """The three rings', the one-shot's and the doubling's outputs at the
    check and timed shapes (f32 and bf16) and chained LL gathers at n = 4
    and 8, at fixed seeded inputs, copied to the host."""
    import numpy as np
    import torch

    rng = np.random.default_rng(91)
    out = {}

    def rand(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    for name, method, n_timed, rows_timed, _ in RS_TIMED:
        m = col.ReduceScatterMethod[method]
        cases = [(n, rows) for n in (2, 4) for rows in RS_CHECK_ROWS]
        for dtype, dt in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            for n, rows in cases + [(n_timed, rows_timed)]:
                rows = -(-rows // (2 * n)) * 2 * n
                ctx = initialize_distributed(n, device=dev, dtype=dtype)
                xs = [rand((rows, D), dtype) for _ in range(n)]
                got = col.reduce_scatter_kernel(m, xs, ctx)
                torch.cuda.synchronize()
                out[f"{name} {dt} n={n} [{rows}, {D}]"] = [
                    t.cpu() for t in got]
    ones = [("reduce_scatter_one_shot", col.ReduceScatterMethod.ONE_SHOT,
             col.reduce_scatter_kernel, RS_CHECK_ROWS, 48),
            ("all_reduce_doubling", col.AllReduceMethod.DOUBLING,
             col.all_reduce_kernel, AR_CHECK_ROWS, 112)]
    for name, m, launch, check_rows, timed_rows in ones:
        for dtype, dt in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            for n in (2, 4):
                for rows in (*check_rows, timed_rows):
                    if name.startswith("reduce_scatter"):
                        rows = -(-rows // (2 * n)) * 2 * n
                    ctx = initialize_distributed(n, device=dev, dtype=dtype)
                    xs = [rand((rows, D), dtype) for _ in range(n)]
                    got = launch(m, xs, ctx)
                    torch.cuda.synchronize()
                    out[f"{name} {dt} n={n} [{rows}, {D}]"] = [
                        t.cpu() for t in got]
    for n in LL_RANKS:
        ctx = initialize_distributed(n, device=dev, dtype=torch.bfloat16)
        ws = llm.ll_all_gather_workspace(ctx, LL_ROWS, LL_COLS,
                                         torch.bfloat16)
        for phase in range(4):
            xs = [rand((LL_ROWS, LL_COLS), torch.bfloat16) for _ in range(n)]
            got = llm.ll_all_gather_kernel(xs, ws, phase, ctx)
            torch.cuda.synchronize()
            out[f"ll_all_gather n={n} call {phase}"] = [
                t.cpu() for t in got]
    return out


if __name__ == "__main__":
    sys.exit(main())
