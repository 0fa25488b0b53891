#!/usr/bin/env python3
"""Decode-megakernel time against batch width, on one NVIDIA GPU.

    python3 perf/mega_batch_sweep.py [--batches 4,8,16] [--ns 1,8]
                                     [--rounds 5] [--label NAME]

Builds Qwen/Qwen3-0.6B at full width and depth in bf16 with random
weights from a seed, fills a paged bf16 pool (page 128, max_length 2048)
with random K/V, and times one ``mega_decode`` launch
(``csrc/megakernel.cu`` through ``MegaQwen3``'s compiled call) per batch
width B and launch width NS, with kv_len cycling {700, 2040}. Each time
is the median of 15 CUDA-event timings with L2 flushed before each
launch; ``--rounds`` repeats that median so the line shows the spread
between rounds. One JSON line per (B, NS), with the card's name and power
limit; ``--label`` tags the lines (two builds of the kernel compared in
one call). Needs CUDA; exits non-zero without it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LENS = (700, 2040)
PAGE, MAX_LENGTH = 128, 2048


def median_ms(fn, flush, iters: int = 15, warmup: int = 3) -> float:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", default="4,8,16")
    ap.add_argument("--ns", default="1,8")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mega_batch_sweep: no CUDA device", file=sys.stderr)
        return 1
    from triton_distributed_tpu_torch.megakernel import (
        MegaConfig,
        MegaQwen3,
        MegaWeights,
    )
    from triton_distributed_tpu_torch.models import AutoLLM
    from triton_distributed_tpu_torch.models.paged_kv_cache import (
        init_paged_cache,
    )

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    model = AutoLLM.from_pretrained("Qwen/Qwen3-0.6B", device=dev, seed=0)
    cfg = model.cfg
    mega = MegaQwen3(model, cfg=MegaConfig(fuse_norms=True))
    w = MegaWeights.from_params(model.params)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for b in [int(x) for x in args.batches.split(",")]:
        cache, _ = init_paged_cache(cfg, b, dev, max_length=MAX_LENGTH,
                                    page_size=PAGE)
        cache.k_pages.normal_(generator=gen)
        cache.v_pages.normal_(generator=gen)
        lens = [LENS[i % len(LENS)] for i in range(b)]
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        tokens = torch.from_numpy(np.random.default_rng(b).integers(
            0, cfg.vocab_size, b).astype(np.int32)).to(dev)
        for ns in [int(x) for x in args.ns.split(",")]:
            dims = dataclasses.replace(mega._dims(b, MAX_LENGTH, PAGE),
                                       nsteps=ns, v_real=cfg.vocab_size)
            comp = mega._compile(dims)
            info = {}
            comp.run(w, cache.k_pages, cache.v_pages, cache.page_table,
                     kv_len, tokens, info=info)
            ms = [median_ms(lambda: comp.run(
                w, cache.k_pages, cache.v_pages, cache.page_table, kv_len,
                tokens), flush) for _ in range(args.rounds)]
            med = statistics.median(ms)
            print(json.dumps({
                "label": args.label, "batch": b, "ns": ns, "kv_len": lens,
                "ms_per_launch_rounds": ms, "ms_per_launch": med,
                "ms_per_step": med / ns, "ms_per_step_per_row": med / ns / b,
                "launch": info, "device": card,
            }))
        del cache
    return 0


if __name__ == "__main__":
    sys.exit(main())
