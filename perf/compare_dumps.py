#!/usr/bin/env python3
"""Hold two trees' kernel outputs to each other, bit for bit.

    python3 perf/compare_dumps.py A.pt B.pt

Reads two files that a bench's ``--dump`` wrote
(``perf/flash_attention_bench.py``, ``perf/overlap_gemm_bench.py``,
``perf/sp_attention_bench.py``, ``perf/collectives_bench.py``) (a dict of name -> list of
tensors, the same seeded inputs in both trees) and prints one JSON line a
name: whether every tensor is bitwise equal, and the largest difference
where it is not. Exits 1 if a name present in both differs.
"""

from __future__ import annotations

import json
import sys


def main() -> int:
    import torch

    a, b = (torch.load(p) for p in sys.argv[1:3])
    bad = 0
    for name in sorted(set(a) | set(b)):
        if name not in a or name not in b:
            print(json.dumps({"name": name, "only_in": 0 if name in a
                              else 1}))
            continue
        same = all(x.dtype == y.dtype and x.shape == y.shape
                   and torch.equal(x.view(torch.uint8), y.view(torch.uint8))
                   for x, y in zip(a[name], b[name]))
        diff = max(float((x.float() - y.float()).abs().max())
                   for x, y in zip(a[name], b[name]))
        bad += not same
        print(json.dumps({"name": name, "bitwise": same, "max_abs": diff}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
