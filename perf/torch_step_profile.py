#!/usr/bin/env python3
"""Where the port's serving steps spend their time, on one NVIDIA GPU.

    python3 perf/torch_step_profile.py [--steps 20] [--phases a,b,...]

Builds Qwen/Qwen3-0.6B at full width and depth with random weights from a
seed, fills a paged bf16 KV pool (page 128) for 4 sequences at kv_len
{700, 2047, 700, 2047} and an int8 pool quantized from the same values,
and profiles (``torch.profiler``, CPU + CUDA activities) four phases of
the serving path after warm-up:

- ``decode``: ``Qwen3.decode_step`` over the bf16 pool, batch 4;
- ``decode_int8``: the same step over the int8 pool (the quantized
  append, ``quantized_row_scatter``, runs in every layer);
- ``prefill`` and ``prefill_int8``: one 256-token
  ``prefill_paged_chunk`` at offset 512 over each pool;
- ``verify_tree``: one speculative tree verify
  (``speculative.spec_verify_tree``: a 14-node draft tree in a 16-row
  chunk at offset 700 over the bf16 pool, the ancestor mask on the
  ``flash_attention_bias`` kernel, per-position logits, the argmax
  fetched to the host);
- ``decode_mega``: the ``decode`` step through the decode megakernel
  (``MegaQwen3.decode_step``, ``mode="mega"``'s single-step launch: one
  kernel for the whole step, then the K/V append), same pool and shape;
- ``decode_mega_ns8``: one 8-step launch (``decode_multi_fn``, the
  serving loop's launch) at kv_len {700, 2040, 700, 2040}, so the 8 new
  rows fit the pool; its line also gives the numbers per decode step;
- ``decode_mega_short``: ``decode_mega`` at kv_len {1, 1, 1, 1}, where
  attention costs almost nothing: the weight streams and the barriers;
- ``mega_barriers``: one launch of a table of 282 ALLREDUCE tasks (the
  barriers of one Qwen3-0.6B step, each behind a [4, 1024] add): what
  the kernel's grid barriers cost alone.

For each phase it prints one JSON line: host wall ms per step (clock
around synchronized steps), device busy ms per step (sum of kernel time),
the device idle share, kernel launches per step, and the kernels taking
the most device time. Needs CUDA; exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profile_phase(name, step, steps: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.device_time_total > 0]
    busy_us = sum(e.device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
    busy_ms = busy_us / steps / 1e3
    return {
        "phase": name,
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "kernel_launches_per_step": launches / steps,
        "top_kernels": [
            {"name": e.key[:80], "ms_per_step": e.device_time_total / steps
             / 1e3, "calls_per_step": e.count / steps}
            for e in top
        ],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--phases", default="",
                    help="comma-separated phase names (default: all)")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device", file=sys.stderr)
        return 1
    from triton_distributed_tpu_torch.megakernel import MegaConfig, MegaQwen3
    from triton_distributed_tpu_torch.models import AutoLLM
    from triton_distributed_tpu_torch.models.paged_kv_cache import (
        init_paged_cache,
        quantize_pages,
    )
    from triton_distributed_tpu_torch.models.speculative import (
        TreeDraft,
        spec_verify_tree,
    )

    dev = torch.device("cuda", 0)
    model = AutoLLM.from_pretrained("Qwen/Qwen3-0.6B", device=dev, seed=0)
    cfg = model.cfg
    cache, _ = init_paged_cache(cfg, 4, dev, max_length=2048, page_size=128)
    gen = torch.Generator(device=dev).manual_seed(1)
    cache.k_pages.normal_(generator=gen)
    cache.v_pages.normal_(generator=gen)
    cache8, _ = init_paged_cache(cfg, 4, dev, max_length=2048, page_size=128,
                                 kv_dtype="int8")
    for pool, scale, src in ((cache8.k_pages, cache8.k_scale, cache.k_pages),
                             (cache8.v_pages, cache8.v_scale, cache.v_pages)):
        codes, sc = quantize_pages(src)
        pool.copy_(codes)
        scale.copy_(sc)
    lens = torch.tensor([700, 2047, 700, 2047], dtype=torch.int32,
                        device=dev)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, 4)).to(dev)

    def decode_over(c):
        def step():
            # Same kv_len every step: a steady-state step at these lengths.
            c.kv_len = lens.clone()
            model.decode_step(tokens, c)
        return step

    chunk = np.random.default_rng(1).integers(0, cfg.vocab_size, 256)

    def prefill_over(c):
        def step():
            model.prefill_paged_chunk(chunk, 1, 512, 768, 255, c,
                                      kv_pages=8)
        return step

    tree = TreeDraft(int(tokens[0]))  # 14 nodes on 5 branches
    for path in ([1, 2, 3, 4], [1, 5, 6], [7, 8, 9, 10], [7, 2], [11, 12]):
        tree.add_path(path, budget=16)

    def verify_tree():
        spec_verify_tree(model, cache, 1, tree, 700, "xla")

    mega = MegaQwen3(model, cfg=MegaConfig(fuse_norms=True))

    def decode_mega():
        cache.kv_len = lens.clone()
        mega.decode_step(tokens, cache)

    lens8 = torch.tensor([700, 2040, 700, 2040], dtype=torch.int32,
                         device=dev)
    ns8 = mega.decode_multi_fn(4, 2048, 8, page=128,
                               num_pages=int(cache.k_pages.shape[1]))

    def decode_mega_ns8():
        cache.kv_len = lens8.clone()
        ns8(model.params, tokens, cache)

    lens1 = torch.ones(4, dtype=torch.int32, device=dev)

    def decode_mega_short():
        cache.kv_len = lens1.clone()
        mega.decode_step(tokens, cache)

    from triton_distributed_tpu_torch.megakernel import (
        MegaWeights,
        TaskType,
        mega_decode,
    )

    bar_table = torch.zeros((282, 8), dtype=torch.int32, device=dev)
    bar_table[:, 0] = int(TaskType.ALLREDUCE)
    bar_dims = mega._dims(4, 2048, 128)
    weights = MegaWeights.from_params(model.params)
    tok32 = tokens.to(torch.int32)
    bar = torch.zeros(4, dtype=torch.int32, device=dev)

    def mega_barriers():
        mega_decode(bar_dims, mega.cfg, bar_table, weights, cache.k_pages,
                    cache.v_pages, cache.page_table, lens, tok32, bar=bar)

    card = torch.cuda.get_device_name(0)
    for name, fn in (("decode", decode_over(cache)),
                     ("decode_int8", decode_over(cache8)),
                     ("prefill", prefill_over(cache)),
                     ("prefill_int8", prefill_over(cache8)),
                     ("verify_tree", verify_tree),
                     ("decode_mega", decode_mega),
                     ("decode_mega_ns8", decode_mega_ns8),
                     ("decode_mega_short", decode_mega_short),
                     ("mega_barriers", mega_barriers)):
        if args.phases and name not in args.phases.split(","):
            continue
        rec = profile_phase(name, fn, args.steps)
        if name == "decode_mega_ns8":
            rec["per_decode_step"] = {
                k: rec[k] / 8 for k in ("wall_ms_per_step",
                                        "device_busy_ms_per_step",
                                        "kernel_launches_per_step")}
        rec["device"] = card
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
