"""Shared serving-stats schema.

Counterpart of ``triton_distributed_tpu/models/stats.py``, cut to the
counters the ported engines keep. ``CORE_STATS_KEYS`` is the contract
both engines expose in ``last_stats``; ``STAT_METRICS`` names the
registry metric each counter is mirrored into (the JAX package's names,
so one dashboard reads either).

``kv_bytes_per_token`` is the device bytes one cached token costs (K+V,
plus the per-page scales of an int8 pool); ``kv_dtype`` is the KV
storage dtype as the JAX engines write it: ``"int8"`` for an int8 pool,
else the dtype's numpy name (``"bfloat16"``, ``"float32"``).
"""

from __future__ import annotations

import torch

CORE_STATS_KEYS = (
    "decode_steps",
    "prefill_tokens",
    "generated_tokens",
    "kv_bytes_per_token",
    "kv_dtype",
)


def kv_dtype_name(kv_dtype: str | None, dtype: torch.dtype) -> str:
    """``stats["kv_dtype"]``: the knob's value if set, else the pool's
    dtype by its numpy name (``torch.bfloat16`` → ``"bfloat16"``)."""
    return kv_dtype or str(dtype).removeprefix("torch.")


def missing_core_stats(stats: dict) -> list[str]:
    """Core keys absent from ``stats`` (empty == conforming)."""
    return [k for k in CORE_STATS_KEYS if k not in stats]


STAT_METRICS = {
    "admitted": ("tdt_engine_admitted_total",
                 "Requests admitted to a decode slot."),
    "decode_steps": ("tdt_engine_decode_steps_total",
                     "Batched decode device programs run."),
    "prefill_tokens": ("tdt_engine_prefill_tokens_total",
                       "Prompt tokens prefilled (prefix hits excluded)."),
    "prefill_chunks": ("tdt_engine_prefill_chunks_total",
                       "Chunked-prefill programs run."),
    "prefix_hit_tokens": ("tdt_engine_prefix_hit_tokens_total",
                          "Prompt tokens served from the radix tree."),
    "pages_cow_copied": ("tdt_engine_pages_cow_total",
                         "Pages COW-cloned at admission."),
    "admission_stalls": ("tdt_engine_admission_stalls_total",
                         "Admission scans stalled for pool pages."),
    "generated_tokens": ("tdt_engine_generated_tokens_total",
                         "Tokens emitted (partials included)."),
    "failed_requests": ("tdt_engine_failed_requests_total",
                        "Requests finished with a non-ok status."),
    "shed_requests": ("tdt_engine_shed_requests_total",
                      "Requests shed by the bounded admission queue."),
    "deadline_expired": ("tdt_engine_deadline_expired_total",
                         "Requests failed on a wall-clock deadline."),
    "nonfinite_logits": ("tdt_engine_nonfinite_logits_total",
                         "Steps guarded for non-finite logits."),
    "decode_faults": ("tdt_engine_decode_faults_total",
                      "Exceptions isolated by the decode-phase step "
                      "guard."),
}
