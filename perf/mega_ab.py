#!/usr/bin/env python3
"""A/B timing of the decode megakernel's launches between two trees, on one
NVIDIA GPU.

    python3 perf/mega_ab.py [--root DIR] [--phases a,b] [--iters 15]

Imports ``triton_distributed_tpu_torch`` from ``--root`` (default: this
checkout; give an unpacked ``git archive`` of another commit to time its
kernels, which build into that tree's own ``build/torch_kernels``). Builds
each model with random weights from seed 0 and times the megakernel's
launch (CUDA events, median of ``--iters`` after 3 warm-ups, the 50 MB L2
flushed before each launch) at NS = 1 and in an NS = 8 launch, B = 4 over a
random paged bf16 pool (page 128), with the engines' serving config
(fused norms, overlap_ar):

- ``moe_tp1``: Qwen/Qwen3-30B-A3B at full width and 16 of its 48 layers,
  tp=1 (the MoE library's kMoE instantiation), kv_len {700, 2040, 700,
  2040};
- ``dense_tp2``: Qwen/Qwen3-8B at full width and depth, tp=2 over two ranks
  co-located on the card (the dense library's kTp instantiation), kv_len
  {300, 700, 300, 700}.

Prints one JSON line: the card's name and power limit, the root, and per
phase ``ms`` (a launch at NS=1) and ``ns8_ms`` (an NS=8 launch). Run
parent, change, change, parent in one call and compare within it.
"""

import argparse
import json
import os
import subprocess
import sys

PHASES = {
    # model, tp, layers (None = all), kv_len per row, s_max
    "moe_tp1": ("Qwen/Qwen3-30B-A3B", 1, 16, (700, 2040, 700, 2040), 2048),
    "dense_tp2": ("Qwen/Qwen3-8B", 2, None, (300, 700, 300, 700), 768),
}
PAGE = 128


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def median_ms(fn, flush, iters: int) -> float:
    import torch

    times = []
    for i in range(iters + 3):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= 3:
            times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def time_phase(name: str, iters: int, dev) -> dict:
    import dataclasses

    import numpy as np
    import torch

    from triton_distributed_tpu_torch.megakernel import MegaConfig, MegaQwen3
    from triton_distributed_tpu_torch.megakernel.code_generator import (
        MegaWeights,
    )
    from triton_distributed_tpu_torch.models import AutoLLM
    from triton_distributed_tpu_torch.models.paged_kv_cache import (
        init_paged_cache,
    )

    model_name, tp, layers, lens, s_max = PHASES[name]
    over = {} if layers is None else {"num_layers": layers}
    kw = {} if tp == 1 else {"tp": tp}
    model = AutoLLM.from_pretrained(model_name, device=dev, seed=0, **kw,
                                    **over)
    pool, _ = init_paged_cache(model.cfg, len(lens), dev, max_length=s_max,
                               page_size=PAGE, **kw)
    gen = torch.Generator(device=dev).manual_seed(1)
    for t in (pool.k_pages, pool.v_pages):
        t.normal_(generator=gen)
    ranks = [pool.rank(r) for r in range(tp)] if tp > 1 else [pool]
    kc = [c.k_pages for c in ranks]
    vc = [c.v_pages for c in ranks]
    if tp == 1:
        kc, vc = kc[0], vc[0]
        w = MegaWeights.from_params(model.params)
    else:
        w = [MegaWeights.from_params(p) for p in model.params]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, len(lens)).astype(np.int32)).to(dev)
    mega = MegaQwen3(model, cfg=MegaConfig(fuse_norms=True,
                                           cross_prefetch=True,
                                           overlap_ar=True))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    out = {}
    for ns, key in ((1, "ms"), (8, "ns8_ms")):
        dims = dataclasses.replace(
            mega._dims(len(lens), s_max, PAGE,
                       num_pages=int(pool.k_pages.shape[-4])),
            nsteps=ns, v_real=model.cfg.vocab_size)
        run = mega._compile(dims).run
        out[key] = median_ms(
            lambda: run(w, kc, vc, pool.page_table, kv_len, tokens), flush,
            iters)
    out["layers"] = model.cfg.num_layers
    del model, pool, w, kc, vc, flush
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--iters", type=int, default=15)
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the megakernel runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    rec = {"card": card(), "root": os.path.abspath(a.root)}
    for name in a.phases.split(","):
        rec[name] = time_phase(name, a.iters, dev)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
