"""Shared serving-stats schema.

Counterpart of ``triton_distributed_tpu/models/stats.py``, cut to the
counters the ported engines keep. ``CORE_STATS_KEYS`` is the contract
both engines expose in ``last_stats``; ``STAT_METRICS`` names the
registry metric each counter is mirrored into (the JAX package's names,
so one dashboard reads either), and ``STAT_METRIC_ALIASES`` the second
names of two speculation counters. With speculation on, both engines
also report ``target_steps = decode_steps + spec_verify_steps``.

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
    "spec_verify_steps": ("tdt_engine_spec_verify_steps_total",
                          "Speculative verify chunk programs run."),
    "spec_draft_tokens": ("tdt_engine_spec_draft_tokens_total",
                          "Draft tokens proposed."),
    "spec_accepted_tokens": ("tdt_engine_spec_accepted_tokens_total",
                             "Draft tokens accepted by verify."),
    "spec_rollback_tokens": ("tdt_engine_spec_rollback_tokens_total",
                             "Draft tokens rolled back after verify."),
    # Tree speculation: ``nodes`` counts drafted trie nodes (root
    # excluded: they are the spec_draft_tokens of tree rounds), ``depth``
    # sums each tree's deepest drafted path, ``branch_accepts`` counts
    # rounds whose accepted path left the primary branch (a KV row-move).
    "spec_tree_rounds": ("tdt_spec_tree_rounds_total",
                         "Tree-speculation verify rounds (multi-branch "
                         "draft chunks)."),
    "spec_tree_nodes": ("tdt_spec_tree_nodes_total",
                        "Draft tree nodes verified (root excluded)."),
    "spec_tree_depth": ("tdt_spec_tree_depth_total",
                        "Cumulative deepest-drafted-path depth across "
                        "tree rounds."),
    "spec_tree_branch_accepts": ("tdt_spec_tree_branch_accepts_total",
                                 "Tree rounds whose accepted path left "
                                 "the primary branch (commit needed a "
                                 "KV row-move)."),
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
    # Megakernel serving (mode="mega"): NS-step launches, the rounds
    # served by a single-step launch instead, launches over a batch
    # bucket narrower than max_batch, slots retired by the in-kernel
    # stop-token test, and launches sampled through the in-kernel
    # top-k/top-p filter.
    "mega_launches": ("tdt_mega_launches_total",
                      "Megakernel NS-step decode launches."),
    "mega_fallback_steps": ("tdt_mega_single_step_fallbacks_total",
                            "Mega-mode rounds served by the single-step "
                            "fallback (capacity gate: a slot within ns of "
                            "max_length; or a top-k/top-p slot at "
                            "ns = 1)."),
    "mega_device_retires": ("tdt_mega_device_retires_total",
                            "Slots retired by the in-kernel stop-token "
                            "test (no host round trip)."),
    "mega_bucket_launches": ("tdt_mega_bucket_launches_total",
                             "Mega launches served by a batch-bucket "
                             "program narrower than max_batch."),
    "mega_filtered_rounds": ("tdt_mega_filtered_rounds_total",
                             "Mega rounds sampled in-kernel through "
                             "the top-k/top-p bisection filter."),
    # MoE serving: token positions routed through the expert FFN × top_k,
    # and EP all-to-all drops (0 on these lossless tp=1 paths; the key is
    # kept so that a capacity-mode exchange can never hide overflow).
    "moe_routed_tokens": ("tdt_moe_routed_tokens_total",
                          "Expert assignments routed (token positions "
                          "through the MoE FFN × top_k)."),
    "a2a_dropped": ("tdt_moe_a2a_dropped_total",
                    "EP all-to-all assignments dropped (capacity-mode "
                    "overflow; 0 on the lossless serving paths)."),
    # The device task tracer and resident decode: traced launches whose
    # ring was decoded; the host work ring's items, doorbells (one per
    # resident launch) and host-side drains; launches issued before the
    # previous launch drained.
    "mega_trace_launches": ("tdt_mega_trace_launches_total",
                            "Megakernel launches whose device trace "
                            "ring was decoded."),
    "mega_ring_items": ("tdt_mega_ring_items_total",
                        "Admit/retire/cancel work items pushed into "
                        "the host work ring."),
    "mega_ring_doorbells": ("tdt_mega_ring_doorbells_total",
                            "Work-ring doorbell publishes (one per "
                            "resident round)."),
    "mega_ring_host_drains": ("tdt_mega_ring_host_drains_total",
                              "Work-ring items drained host-side "
                              "(single-step fallback rounds, batch "
                              "teardown): no device loop observed "
                              "them."),
    "mega_resident_rounds": ("tdt_mega_resident_rounds_total",
                             "Resident-session rounds issued before "
                             "the previous round's drain (pipelined "
                             "dispatch)."),
    # KV tier: radix evictions spilled to host RAM/disk instead of
    # dropped, and admissions whose prefix coverage was extended by
    # faulting those pages back instead of re-prefilling them.
    "tier_spilled_pages": ("tdt_tier_spilled_pages_total",
                           "Evicted radix pages exported to the KV "
                           "tier instead of dropped."),
    "tier_hits": ("tdt_tier_hits_total",
                  "Admissions whose prefix coverage was extended by "
                  "the KV tier (≥1 page faulted back)."),
    "tier_faults": ("tdt_tier_faulted_pages_total",
                    "Pages faulted back from the KV tier into HBM "
                    "(written via write_page, mapped as tree pages)."),
    "tier_bytes": ("tdt_tier_bytes_faulted_total",
                   "Payload bytes faulted back from the KV tier."),
    # Long-context sharded slots: a slot whose KV exceeds the per-rank
    # page budget keeps a resident paged window plus tier-backed cold
    # pages, merged by a log-sum-exp partial combine each step.
    "longctx_sharded_slots": ("tdt_longctx_sharded_slots_total",
                              "Slots admitted in sharded (over-budget) "
                              "long-context mode."),
    "longctx_demoted_pages": ("tdt_longctx_demoted_pages_total",
                              "Cold KV pages of live long slots "
                              "demoted to the KV tier."),
    "longctx_tier_faults": ("tdt_longctx_tier_faults_total",
                            "Cold pages faulted back from the KV tier "
                            "to rebuild a long slot's attention "
                            "window."),
    "longctx_tier_bytes": ("tdt_longctx_tier_bytes_total",
                           "Payload bytes faulted back for long-slot "
                           "cold windows."),
    "longctx_decode_steps": ("tdt_longctx_decode_steps_total",
                             "Per-slot sharded decode programs run "
                             "(cold + resident partial merge)."),
}

# Extra registry names of the SAME counter as a STAT_METRICS entry (the
# short ``tdt_spec_*`` family fleet dashboards key on); the engines bump
# every name of a key together.
STAT_METRIC_ALIASES = {
    "spec_draft_tokens": (
        ("tdt_spec_draft_tokens_total",
         "Draft tokens proposed (alias of "
         "tdt_engine_spec_draft_tokens_total for fleet spec-health "
         "dashboards)."),
    ),
    "spec_rollback_tokens": (
        ("tdt_spec_rollback_tokens_total",
         "Draft tokens rolled back after verify (alias of "
         "tdt_engine_spec_rollback_tokens_total for fleet spec-health "
         "dashboards)."),
    ),
}

SPEC_STATS_KEYS = tuple(k for k in STAT_METRICS if k.startswith("spec_"))


def spec_summary(stats: dict) -> dict:
    """The derived speculation stats both engines add to ``last_stats``:
    the accept rate and ``target_steps = decode_steps +
    spec_verify_steps`` (the target forwards a throughput model counts)."""
    return {
        "spec_accept_rate": stats["spec_accepted_tokens"]
        / max(stats["spec_draft_tokens"], 1),
        "target_steps": stats["decode_steps"] + stats["spec_verify_steps"],
    }
