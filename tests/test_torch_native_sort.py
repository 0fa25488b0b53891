"""The MoE block-aligned sort of the port against the JAX package, on the
CPU: ``routing.moe_align_block_size`` (torch ops) and the native C++
routine (``ops/moe/native_sort.py`` over the port's copy of
``csrc/moe_utils.cc``) through ctypes and as a torch custom op. Every
output is integer: all four fields must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.native import native_available as jax_native
from triton_distributed_tpu.ops.moe import routing as jrouting
from triton_distributed_tpu_torch.native import (
    native_available,
    toolchain_available,
)
from triton_distributed_tpu_torch.ops.moe import routing
from triton_distributed_tpu_torch.ops.moe.native_sort import (
    moe_align_block_size_host,
    moe_align_block_size_op,
)

# (T, k, E, block size): the routings of tests/test_native.py, a decode
# step of Qwen3-30B-A3B (top-8 of 128) and a ragged one.
CASES = [(64, 4, 16, 8), (128, 8, 32, 16), (4, 8, 128, 16), (37, 3, 5, 7),
         (1, 1, 1, 1)]


def _eids(T, k, E, seed=0, skew=False):
    rng = np.random.default_rng(seed)
    if skew:   # most rows to a few experts: empty and full segments
        return rng.integers(0, max(1, E // 4), (T, k)).astype(np.int32)
    return rng.integers(0, E, (T, k)).astype(np.int32)


@pytest.fixture
def native():
    """The native library, built at first use (in the test, never while
    the module is collected); skips only without a C++ toolchain, and a
    failed build fails the test."""
    if not toolchain_available():
        pytest.skip("no C++ toolchain")
    assert native_available()


def _equal(got, want):
    for f in ("sorted_ids", "block_expert", "num_blocks", "num_padded"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("T,k,E,bs", CASES)
def test_align_matches_jax(T, k, E, bs, skew):
    eids = _eids(T, k, E, seed=T + E, skew=skew)
    want = jrouting.moe_align_block_size(jnp.asarray(eids), E, bs)
    got = routing.moe_align_block_size(torch.from_numpy(eids), E, bs)
    assert routing.align_capacities(T * k, E, bs) == \
        jrouting.align_capacities(T * k, E, bs)
    assert got.sorted_ids.dtype == got.block_expert.dtype == torch.int32
    _equal(got, want)
    # The flat [N] form too.
    _equal(routing.moe_align_block_size(torch.from_numpy(eids.reshape(-1)),
                                        E, bs), want)


@pytest.mark.parametrize("T,k,E,bs", CASES)
def test_host_planner_matches_jax(native, T, k, E, bs):
    eids = _eids(T, k, E, seed=3 * T + E, skew=T % 2 == 1)
    got = moe_align_block_size_host(eids, E, bs)
    _equal(got, jrouting.moe_align_block_size(jnp.asarray(eids), E, bs))
    if jax_native():
        from triton_distributed_tpu.ops.moe.native_sort import (
            moe_align_block_size_host as jax_host,
        )
        _equal(got, jax_host(eids, E, bs))


def test_custom_op_traces_under_compile(native):
    """The custom op (CPU int32 tensors) called eagerly and inside a
    fullgraph torch.compile (its fake implementation gives the shapes)
    gives the torch composition's fields."""
    eids = torch.from_numpy(_eids(64, 4, 16, seed=1))
    want = routing.moe_align_block_size(eids, 16, 8)
    _equal(moe_align_block_size_op(eids, 16, 8), want)
    fn = torch.compile(lambda x: moe_align_block_size_op(x, 16, 8),
                       backend="eager", fullgraph=True)
    _equal(fn(eids), want)
    torch.library.opcheck(torch.ops.tdt_torch.moe_align_block_size.default,
                          (eids, 16, 8))


def test_native_error_codes_raise(native):
    """rc 1 (block size 0, or no experts) and rc 2 (an expert out of
    range) raise ValueError naming the code, through both entries."""
    for experts, bs in ((4, 0), (0, 8)):
        with pytest.raises(ValueError, match="rc=1"):
            moe_align_block_size_host(np.zeros((2, 2), np.int32), experts,
                                      bs)
    with pytest.raises(ValueError, match="rc=2"):
        moe_align_block_size_host(np.asarray([[99]], np.int32), 4, 8)
    with pytest.raises(ValueError, match="rc=2"):
        moe_align_block_size_op(torch.tensor([[0, -1]], dtype=torch.int32),
                                4, 8)


def test_no_build_raises_runtime_error(monkeypatch):
    from triton_distributed_tpu_torch.ops.moe import native_sort

    monkeypatch.setattr(native_sort, "get_native", lambda: None)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        native_sort.moe_align_block_size_host(np.zeros((1, 1), np.int32),
                                              2, 4)


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    """A source that does not compile raises with g++'s error output,
    through ``build`` and ``get_native``: it never reads as a missing
    toolchain."""
    from triton_distributed_tpu_torch import native as nat

    if not toolchain_available():
        pytest.skip("no C++ toolchain")
    bad = tmp_path / "broken.cc"
    bad.write_text("int tdt_broken( {\n")
    monkeypatch.setattr(nat, "_SOURCES", (bad,))
    monkeypatch.setattr(nat, "BUILD_DIR", tmp_path / "build")
    nat.get_native.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="broken.cc"):
            nat.build()
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            nat.get_native()
    finally:
        nat.get_native.cache_clear()
