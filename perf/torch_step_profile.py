#!/usr/bin/env python3
"""Where the port's serving steps spend their time, on one NVIDIA GPU.

    python3 perf/torch_step_profile.py [--steps 20] [--phases a,b,...]

Builds Qwen/Qwen3-0.6B at full width and depth with random weights from a
seed, fills a paged bf16 KV pool (page 128) for 4 sequences at kv_len
{700, 2047, 700, 2047} and an int8 pool quantized from the same values,
and profiles (``torch.profiler``, CPU + CUDA activities) phases of the
serving path after warm-up:

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
- ``decode_mega_ns8_traced``: the same launch with the device task
  tracer on (the trace ring operand), beside the untraced one;
- ``mega_prefill``: ``MegaQwen3.prefill`` of a 256-token prompt
  (``true_len`` 250) into a dense cache, the prefill megakernel, beside
  ``prefill_xla``: ``Qwen3.prefill_batched`` of the same prompt;
- ``decode_mega_short``: ``decode_mega`` at kv_len {1, 1, 1, 1}, where
  attention costs almost nothing: the weight streams and the barriers;
- ``decode_mega_int8``: ``decode_mega`` over the int8 pool (the kernel
  reads the codes through the per-page scales; the quantized append
  follows the launch), beside ``decode_int8``;
- ``decode_mega_wq8`` and ``decode_mega_wq8_int8``: ``decode_mega`` with
  int8 weights (``MegaConfig(wq8=True)``, quantized once before the
  timed steps) over the bf16 pool and over the int8 pool;
- ``decode_mega_sampled_ns8``: ``decode_mega_ns8`` sampled as the
  serving loop samples: the launch's Gumbel noise ``[8, 4, V_pad]`` drawn
  and scaled per row (rows 0 and 2 greedy, 1 and 3 at T 0.8), then the
  launch with the argmax over logits + noise;
- ``decode_mega_filtered_ns8``: the same with the in-kernel filter, rows
  greedy / top-k 64 / top-k 1 / top-p 0.9 (``chip_smoke.py``'s rows);
  ``decode_mega_filtered_off``, ``_topk`` and ``_topp``: the filtered
  build with every row's filter off (the extra barrier and the winner
  pass alone), every row top-k 64, every row top-p 0.9 (at T 0.8): what
  each bisection costs;
- ``mega_barriers``: one launch of a table of 282 ALLREDUCE tasks (the
  barriers of one Qwen3-0.6B step, each behind a [4, 1024] add): what
  the kernel's grid barriers cost alone;
- ``prefill_chunk_cold`` and ``prefill_chunk_cold_int8``: one 128-token
  chunk of a sharded long-context slot (``Qwen3.prefill_paged_chunk_cold``)
  at local offset 1920 of a 16-page resident row, with 12 cold pages
  (s_cold 1536) in a 16-page bucket: the last prefill chunk of a
  3584-token prompt over a 2048-token budget, over each pool;
- ``decode_sharded`` and ``decode_sharded_int8``: one decode step of that
  slot (``Qwen3.decode_step_sharded``) at local length 1900 with 13 cold
  pages (s_cold 1664), over each pool;
- ``cold_view``: one rebuild of a 12-page bf16 cold window from the KV
  tier (``ContinuousEngine._cold_view``: 12 tier reads, their CRC, JSON
  and base64 decode, the stitch and the copy to the card), the host work
  a sharded slot pays after every demote;
- ``tp_chunk384_pallas`` and ``tp_chunk384_xla``: Qwen/Qwen3-8B at tp=2
  (both ranks co-located on the card, all 36 layers, random weights
  from a seed), one 384-row ``prefill_paged_chunk`` at offset 0 over a
  paged pool (page 128) in ``mode="pallas"`` (the kernels: its 3 MB
  row-parallel outputs take gemm_ar TWO_SHOT, the ``gemm_rs`` ring then
  the all-gather) and ``mode="xla"`` (plain torch collectives); only
  built when one of them is asked for. Their lines add the device time
  of the ``gemm_rs`` kernel a step;
- ``tp_decode_pallas`` and ``tp_decode_xla``: the same model, one B=4
  decode step (``Qwen3.decode_step``) at kv_len {300, 700, 300, 700} over
  that pool, each layer's o-proj and FC2 summed over the ranks by
  ``gemm_ar`` ONE_SHOT (``pallas``) or plain torch (``xla``). Their lines
  add the device time of the ``gemm_ar`` kernel a step.

For each phase it prints one JSON line: host wall ms per step (clock
around synchronized steps), device busy ms per step (sum of kernel time),
the device idle share, kernel launches per step, the device time a step
of the flash attention kernels (every build), and the kernels taking the
most device time. Needs CUDA; exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profile_phase(name, step, steps: int,
                  match: tuple = ("flash_attention",)) -> dict:
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
    extra = {f"{m}_ms_per_step": sum(
        e.device_time_total for e in kernels if m in e.key) / steps / 1e3
        for m in match}
    return {
        **extra,
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


def profile_tp(asked, steps: int) -> None:
    """The tp=2 Qwen3-8B phases of ``asked`` (tp_chunk384_<mode>,
    tp_decode_<mode>)."""
    import numpy as np
    import torch

    from triton_distributed_tpu_torch.models import AutoLLM
    from triton_distributed_tpu_torch.models.paged_kv_cache import (
        init_paged_cache,
    )

    dev = torch.device("cuda", 0)
    model = AutoLLM.from_pretrained("Qwen/Qwen3-8B", device=dev, seed=0,
                                    tp=2)
    cache, _ = init_paged_cache(model.cfg, 4, dev, max_length=768,
                                page_size=128, tp=model.tp)
    chunk = np.arange(384, dtype=np.int32) % model.cfg.vocab_size
    card = torch.cuda.get_device_name(0)
    for mode in ("pallas", "xla"):
        name = f"tp_chunk384_{mode}"
        if name not in asked:
            continue

        def step(mode=mode):
            model.prefill_paged_chunk(chunk, 0, 0, 384, 383, cache, mode)

        rec = profile_phase(name, step, steps,
                            match=("gemm_rs", "flash_attention"))
        rec["device"] = card
        print(json.dumps(rec), flush=True)
    lens = torch.tensor([300, 700, 300, 700], dtype=torch.int32, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, 4)).to(dev)
    for mode in ("pallas", "xla"):
        name = f"tp_decode_{mode}"
        if name not in asked:
            continue

        def step(mode=mode):
            # Same kv_len every step: a steady-state step at these lengths.
            cache.kv_len = lens.clone()
            model.decode_step(tokens, cache, mode)

        rec = profile_phase(name, step, steps, match=("gemm_ar",))
        rec["device"] = card
        print(json.dumps(rec), flush=True)
    del model, cache
    torch.cuda.empty_cache()


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
    asked = [p for p in args.phases.split(",") if p]
    if any(p.startswith("tp_") for p in asked):
        profile_tp(asked, args.steps)
        if all(p.startswith("tp_") for p in asked):
            return 0
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

    ns8_traced = mega.decode_multi_fn(4, 2048, 8, page=128, trace=True,
                                      num_pages=int(cache.k_pages.shape[1]))

    def decode_mega_ns8_traced():
        cache.kv_len = lens8.clone()
        ns8_traced(model.params, tokens, cache)

    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, 256)
    dense1 = model.new_cache(1, 512)

    def mega_prefill():
        mega.prefill(prompt, dense1, true_len=250)

    def prefill_xla():
        model.prefill_batched(prompt[None], dense1, "xla", [250])

    def decode_mega_int8():
        cache8.kv_len = lens.clone()
        mega.decode_step(tokens, cache8)

    from triton_distributed_tpu_torch.models import sampling

    v_pad = mega._dims(4, 2048).v_loc
    noise_gen = torch.Generator(device=dev).manual_seed(2)

    def mega_sampled(rows, filtered=True):
        """An 8-step launch sampled under per-row (T, top_p, top_k) rows,
        the noise drawn per launch as the serving loop draws it;
        ``filtered`` builds the launch with the in-kernel filter."""
        temps = torch.tensor([r[0] for r in rows], device=dev)
        cfg_rows = [sampling.sampcfg_row(*r, cfg.vocab_size) for r in rows]
        fn = mega.decode_multi_fn(4, 2048, 8, sampled=True, page=128,
                                  num_pages=int(cache.k_pages.shape[1]),
                                  filtered=filtered)
        tail = [torch.tensor(cfg_rows, device=dev)] if filtered else []

        def step():
            cache.kv_len = lens8.clone()
            noise = sampling.gumbel((8, 4, v_pad), noise_gen, dev)
            fn(model.params, tokens, cache, noise * temps[None, :, None],
               *tail)
        return step

    mega8 = MegaQwen3(model, cfg=MegaConfig(fuse_norms=True, wq8=True))
    mega8.quantized_params()  # quantized once, outside the timed steps

    def decode_mega_wq8_over(c):
        def step():
            c.kv_len = lens.clone()
            mega8.decode_step(tokens, c)
        return step

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

    from triton_distributed_tpu_torch.models import ContinuousEngine
    from triton_distributed_tpu_torch.models import kv_tier
    from triton_distributed_tpu_torch.models.continuous import _LongSlot
    from triton_distributed_tpu_torch.models.paged_kv_cache import (
        gather_pages,
    )

    # A sharded slot: resident row = pool pages 1..16, cold windows cut
    # from pool pages 17.. (random values, the pool's dtype and scales).
    row = np.arange(1, 17, dtype=np.int32)
    cold_chunk = np.random.default_rng(2).integers(0, cfg.vocab_size, 128)

    def cold_window(c, n_cold):
        ids = torch.arange(17, 17 + n_cold, device=dev)

        def stitch(t):  # [L, n, Hkv, page, hd] -> [L, Hkv, 16 * page, hd]
            t = t.index_select(1, ids).transpose(1, 2)
            t = t.reshape(t.shape[0], t.shape[1], -1, t.shape[-1])
            out = torch.zeros((t.shape[0], t.shape[1], 16 * 128,
                               t.shape[-1]), dtype=t.dtype, device=dev)
            out[:, :, : t.shape[2]] = t
            return out

        def scales(t):  # [L, P, Hkv] -> [L, Hkv, 16]
            if t is None:
                return None
            out = torch.zeros((t.shape[0], t.shape[2], 16), device=dev)
            out[:, :, :n_cold] = t.index_select(1, ids).transpose(1, 2)
            return out

        return (stitch(c.k_pages), stitch(c.v_pages), scales(c.k_scale),
                scales(c.v_scale))

    def chunk_cold_over(c):
        kc, vc, ksc, vsc = cold_window(c, 12)

        def step():
            model.prefill_paged_chunk_cold(
                cold_chunk, row, 1536 + 1920, 1536 + 2048, 127, c, kc, vc,
                ksc, vsc, s_cold=1536)
        return step

    def decode_sharded_over(c):
        kc, vc, ksc, vsc = cold_window(c, 13)
        tok = tokens[:1].cpu().numpy()

        def step():
            model.decode_step_sharded(tok, c, row, 1900, kc, vc, ksc, vsc,
                                      s_cold=1664)
        return step

    eng = ContinuousEngine(model, max_batch=1, page_size=128,
                           max_length=4096, rank_page_budget=2048,
                           tier_bytes=512 << 20, num_pages=17, device=dev)
    eng.cache.k_pages.normal_(generator=gen)
    eng.cache.v_pages.normal_(generator=gen)
    slot = _LongSlot(uid=0, cold=12)
    for i in range(slot.cold):
        k, v, _, _ = gather_pages(eng.cache, [1 + i])
        payload = kv_tier.prefix_payload(range(128), 128, None, k[:, 0],
                                         v[:, 0])
        payload["model_fp"] = eng._tier_fp
        eng.tier.put(kv_tier.LONGCTX_KIND, f"0:{i}", payload)

    def cold_view():
        slot.view = None
        eng._cold_view(slot)

    card = torch.cuda.get_device_name(0)
    for name, fn in (("decode", decode_over(cache)),
                     ("decode_int8", decode_over(cache8)),
                     ("prefill", prefill_over(cache)),
                     ("prefill_int8", prefill_over(cache8)),
                     ("verify_tree", verify_tree),
                     ("decode_mega", decode_mega),
                     ("decode_mega_ns8", decode_mega_ns8),
                     ("decode_mega_ns8_traced", decode_mega_ns8_traced),
                     ("mega_prefill", mega_prefill),
                     ("prefill_xla", prefill_xla),
                     ("decode_mega_short", decode_mega_short),
                     ("decode_mega_int8", decode_mega_int8),
                     ("decode_mega_wq8", decode_mega_wq8_over(cache)),
                     ("decode_mega_wq8_int8", decode_mega_wq8_over(cache8)),
                     ("decode_mega_sampled_ns8", mega_sampled(
                         [(0.0, 1.0, 0), (0.8, 1.0, 0), (0.0, 1.0, 0),
                          (0.8, 1.0, 0)], filtered=False)),
                     ("decode_mega_filtered_ns8", mega_sampled(
                         [(0.0, 1.0, 0), (0.8, 1.0, 64), (1.0, 1.0, 1),
                          (0.8, 0.9, 0)])),
                     ("decode_mega_filtered_off", mega_sampled(
                         [(0.8, 1.0, 0)] * 4)),
                     ("decode_mega_filtered_topk", mega_sampled(
                         [(0.8, 1.0, 64)] * 4)),
                     ("decode_mega_filtered_topp", mega_sampled(
                         [(0.8, 0.9, 0)] * 4)),
                     ("mega_barriers", mega_barriers),
                     ("prefill_chunk_cold", chunk_cold_over(cache)),
                     ("prefill_chunk_cold_int8", chunk_cold_over(cache8)),
                     ("decode_sharded", decode_sharded_over(cache)),
                     ("decode_sharded_int8", decode_sharded_over(cache8)),
                     ("cold_view", cold_view)):
        if args.phases and name not in args.phases.split(","):
            continue
        rec = profile_phase(name, fn, args.steps)
        if name.startswith("decode_mega") and ("ns8" in name
                                               or "filtered" in name):
            rec["per_decode_step"] = {
                k: rec[k] / 8 for k in ("wall_ms_per_step",
                                        "device_busy_ms_per_step",
                                        "kernel_launches_per_step")}
        rec["device"] = card
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
