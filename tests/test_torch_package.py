"""Rules of the PyTorch port package, enforced.

- It imports no JAX and nothing of the JAX package (checked in a fresh
  interpreter and by a source scan).
- Its entry points run on CUDA unless the caller passes
  ``device="cpu"``, and raise when CUDA is absent: nothing falls back.
- Knobs of the JAX engines that the port does not take yet are refused.
- ``chip_smoke.py`` fails without a GPU, and alone in a directory.
"""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from triton_distributed_tpu_torch.megakernel import MegaConfig
from triton_distributed_tpu_torch.models import (
    AutoLLM,
    ContinuousEngine,
    Engine,
    Qwen3,
    get_config,
)

torch.set_num_threads(1)  # leave the CPU to the JAX test workers

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "triton_distributed_tpu_torch"
SLICE_MODULES = [
    "triton_distributed_tpu_torch",
    "triton_distributed_tpu_torch.runtime.context",
    "triton_distributed_tpu_torch.runtime.mesh",
    "triton_distributed_tpu_torch.language",
    "triton_distributed_tpu_torch.ops.collectives",
    "triton_distributed_tpu_torch.ops.overlap",
    "triton_distributed_tpu_torch.parallel",
    "triton_distributed_tpu_torch.ops.cuda_kernels",
    "triton_distributed_tpu_torch.ops.attention",
    "triton_distributed_tpu_torch.layers.tp_attn",
    "triton_distributed_tpu_torch.layers.tp_mlp",
    "triton_distributed_tpu_torch.megakernel",
    "triton_distributed_tpu_torch.models",
    "triton_distributed_tpu_torch.models.sampling",
    "triton_distributed_tpu_torch.models.stats",
    "triton_distributed_tpu_torch.obs.events",
    "triton_distributed_tpu_torch.obs.metrics",
]


def test_import_pulls_in_no_jax():
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'triton_distributed_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'jax' in before or 'jax' not in sys.modules\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_sources_import_no_jax():
    bad = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+triton_distributed_tpu\b"
        r"(?!_torch)|from\s+triton_distributed_tpu\b(?!_torch))", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if bad.search(f.read_text())]
    assert offenders == []


def test_every_kernel_source_names_what_it_replaces():
    for src in sorted((PKG / "csrc").glob("*.cu")):
        text = src.read_text()
        assert "Replaces" in text and "triton_distributed_tpu/ops" in text
        assert "bounds it on the H100" in text


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_cuda_unless_told_cpu(no_cuda):
    cfg = get_config("tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Qwen3(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AutoLLM.from_pretrained("tiny")
    model = AutoLLM.from_pretrained("tiny", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousEngine(model, page_size=16)
    ids = np.arange(16, dtype=np.int32).reshape(2, 8)
    assert Engine(model, device="cpu").serve(ids, 3).shape == (2, 11)
    eng = ContinuousEngine(model, page_size=16, device="cpu")
    assert [len(o) for o in eng.run([(ids[0], 3)])] == [3]
    assert eng.audit() == []


def _refusal(knobs) -> type:
    """Unported knobs raise NotImplementedError; a kv_dtype the engine
    cannot take (not int8, or int8 on a dense cache), speculation on a
    dense cache, a ``rank_page_budget`` without a KV tier or on the
    megakernel path, and ``resident`` or ``kernel_trace`` outside
    ``mode='mega'`` are ValueErrors, as in the JAX engines."""
    if {"kv_dtype", "speculative", "rank_page_budget", "resident",
            "kernel_trace"} & set(knobs):
        return ValueError
    return NotImplementedError


@pytest.mark.parametrize("knobs", [
    dict(mode="mega", tp=2, mega_cfg=MegaConfig(wq8=True)),
    dict(speculative=2),
    dict(kv_dtype="int8", paged=False),
    dict(kv_dtype="fp8", paged=True),
])
def test_engine_refuses_unported_knobs(knobs):
    """``mode="pallas"`` is served since tensor parallelism was ported
    (tests/test_torch_tp.py); its case became the megakernel at tp=2, which
    serves a dense model since row 6(e)'s dense half was ported
    (tests/test_torch_mega_tp.py): what stays refused there is int8
    weights (ROADMAP queue 1 position 4)."""
    knobs = dict(knobs)
    model = AutoLLM.from_pretrained("tiny", device="cpu",
                                    tp=knobs.pop("tp", 1))
    with pytest.raises(_refusal(knobs)):
        Engine(model, device="cpu", **knobs)


@pytest.mark.parametrize("knobs", [
    dict(kernel_trace=True), dict(resident=True),
    dict(fabric=object()),
    dict(kv_dtype="fp8"),
    dict(rank_page_budget=256, tier_bytes=1 << 20, mode="mega"),
    dict(cp=2), dict(rank_page_budget=256), dict(snapshot_every=2),
])
def test_continuous_refuses_unported_knobs(knobs):
    model = AutoLLM.from_pretrained("tiny", device="cpu")
    with pytest.raises(_refusal(knobs)):
        ContinuousEngine(model, page_size=16, device="cpu", **knobs)


def test_sampled_requests_and_local_checkpoints_are_refused(tmp_path):
    """Local checkpoints (safetensors) and unknown engine knobs are
    refused. Sampled requests are served since sampled serving was
    ported (tests/test_torch_sampled.py); the name is kept."""
    model = AutoLLM.from_pretrained("tiny", device="cpu")
    with pytest.raises(NotImplementedError, match="safetensors"):
        AutoLLM.from_pretrained(str(tmp_path), device="cpu")
    with pytest.raises(TypeError):
        ContinuousEngine(model, page_size=16, device="cpu", bogus=1)


def test_chip_smoke_fails_without_gpu_and_alone(tmp_path):
    """Without CUDA (this host) and without the port beside it, the smoke
    exits non-zero and prints no result line."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for cwd in (ROOT, alone):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
