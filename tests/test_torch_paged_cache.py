"""The port's paged-pool bookkeeping against the JAX package's, on the CPU.

The same pool contents, tables and page lists go through both packages'
``write_prefill``, ``copy_page``, ``gather_pages``/``write_page``,
``gather_bucket``, ``truncate_pages`` and ``audit_pool``; pool writes
must agree exactly (they are copies), and the host-side bookkeeping
must return the same answers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.models import paged_kv_cache as jpk
from triton_distributed_tpu.runtime import mesh as mesh_mod
from triton_distributed_tpu_torch.models import get_config
from triton_distributed_tpu_torch.models import paged_kv_cache as tpk

torch.set_num_threads(1)  # leave the CPU to the JAX test workers

PAGE, MAXLEN = 16, 64


@pytest.fixture(scope="module")
def caches():
    from triton_distributed_tpu.models.config import get_config as jax_config

    ctx = mesh_mod.initialize_distributed(tp=1, devices=jax.devices()[:1])
    jcache, _ = jpk.init_paged_cache(jax_config("tiny"), 2, ctx,
                                     max_length=MAXLEN, page_size=PAGE,
                                     num_pages=9, assign_pages=False)
    tcache, _ = tpk.init_paged_cache(get_config("tiny"), 2, "cpu",
                                     max_length=MAXLEN, page_size=PAGE,
                                     num_pages=9, assign_pages=False)
    yield jcache, tcache
    mesh_mod.finalize_distributed()


def _same(tcache, jcache):
    np.testing.assert_array_equal(tcache.k_pages.numpy(),
                                  np.asarray(jcache.k_pages))
    np.testing.assert_array_equal(tcache.v_pages.numpy(),
                                  np.asarray(jcache.v_pages))
    np.testing.assert_array_equal(tcache.kv_len.numpy(),
                                  np.asarray(jcache.kv_len))


def test_write_prefill_copy_page_and_page_round_trip(caches):
    jcache, tcache = caches
    rng = np.random.default_rng(0)
    table = np.array([[3, 7, 1, 0], [2, 8, 0, 0]], np.int32)
    jcache.page_table = jnp.asarray(table)
    tcache.page_table = torch.from_numpy(table)
    kd = rng.standard_normal((2, 1, 4, MAXLEN, 32)).astype(np.float32)
    vd = rng.standard_normal((2, 1, 4, MAXLEN, 32)).astype(np.float32)
    jcache = jpk.write_prefill(jcache, 0, jnp.asarray(kd), jnp.asarray(vd),
                               37)
    tcache = tpk.write_prefill(tcache, 0, torch.from_numpy(kd),
                               torch.from_numpy(vd), 37)
    _same(tcache, jcache)
    # COW clone: a copy, not an alias — writing the source afterwards
    # must leave the clone as it was.
    jcache = jpk.copy_page(jcache, 7, 5)
    tcache = tpk.copy_page(tcache, 7, 5)
    _same(tcache, jcache)
    before = tcache.k_pages[:, 5].clone()
    tcache.k_pages[:, 7] = 0.0
    assert torch.equal(tcache.k_pages[:, 5], before)
    jcache = jpk.copy_page(jcache, 5, 7)  # restore the source on both
    tcache = tpk.copy_page(tcache, 5, 7)
    _same(tcache, jcache)
    # Export/import of pages (the migration payload, verbatim).
    jk, jv, _, _ = jpk.gather_pages(jcache, [3, 1])
    tk, tv, _, _ = tpk.gather_pages(tcache, [3, 1])
    np.testing.assert_array_equal(tk.numpy(), jk)
    jcache = jpk.write_page(jcache, 6, jk[:, 0], jv[:, 0])
    tcache = tpk.write_page(tcache, 6, tk[:, 0], tv[:, 0])
    _same(tcache, jcache)
    jd, _ = jpk.as_dense(jcache)
    td, _ = tpk.as_dense(tcache)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("end", [1, 15, 16, 17, 40, 64, 200])
def test_gather_bucket_matches(end):
    assert tpk.gather_bucket(end, PAGE, 8) == jpk.gather_bucket(end, PAGE, 8)


def test_truncate_and_audit_match():
    for pkg in (jpk, tpk):
        pool = pkg.PagePool(10)
        pool.free = [p for p in pool.free if p != 0]
        pages = pool.allocate(5)
        kept = pkg.truncate_pages(pool, list(pages), 33, PAGE, shared=1)
        assert kept == pages[:3]
        kept = pkg.truncate_pages(pool, kept, 0, PAGE, shared=1)
        assert kept == pages[:1]
        clean = pkg.audit_pool(pool, 10, {"tree": kept}, reserved=(0,))
        assert clean == []
    bad = {"slot0": [1, 2, 2], "slot1": [2], "tree": [0]}
    shared = {"slot0": [9]}
    for owners in (bad, {"slot0": [1]}):
        pools = []
        for pkg in (jpk, tpk):
            pool = pkg.PagePool(10)
            pool.free = [p for p in pool.free if p not in (0, 1, 2)] + [3]
            pools.append(pkg.audit_pool(pool, 10, owners, shared=shared,
                                        reserved=(0,)))
        assert pools[0] == pools[1] and pools[0]
