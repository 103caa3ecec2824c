"""The port's kernel layer against the reference on the CPU.

Each plain PyTorch version in ``repro_torch.kernels.ref`` is held against
``repro.kernels.ref`` and against the Pallas kernel in interpret mode, on
the same numpy inputs. Integer outputs must match bitwise, copied rows
exactly, and summed floats to 1e-5 (float32, different summation order).
The CUDA kernels themselves run only on the card (``chip_smoke.py``); here
the dispatch rules around them are pinned.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.embedding_bag import embedding_bag_pallas
from repro.kernels.fm_interaction import fm_interaction_pallas
from repro.kernels.fused_embedding import gather_pool_pallas, tier_probe_pallas
from repro_torch.kernels import build, ops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _pool_args(rng, n, d, n_bags, n_uniq, empty_bag=None):
    rows_u = rng.normal(size=(n, d)).astype(np.float32)
    inv = np.concatenate([np.arange(n_uniq), rng.integers(0, n_uniq, n - n_uniq)])
    inv = inv[rng.permutation(n)].astype(np.int32)
    w = rng.normal(size=n).astype(np.float32)
    seg = np.sort(np.concatenate([np.arange(n_bags), rng.integers(0, n_bags, n - n_bags)]))
    if empty_bag is not None:
        seg = np.where(seg == empty_bag, empty_bag - 1, seg)
    return rows_u, inv, w, seg.astype(np.int32)


@pytest.mark.parametrize("n,d,n_bags,n_uniq,empty_bag", [
    (24, 8, 6, 24, None), (40, 16, 10, 17, None), (64, 10, 64, 30, None),
    (39, 10, 13, 20, 3)])
def test_gather_pool_plain_matches_reference_and_pallas(n, d, n_bags, n_uniq, empty_bag):
    rows_u, inv, w, seg = _pool_args(np.random.default_rng(n), n, d, n_bags, n_uniq,
                                     empty_bag)
    got = ops.gather_pool(_t(rows_u), _t(inv), _t(w), _t(seg), n_bags).numpy()
    exp = np.asarray(jref.gather_pool_ref(jnp.asarray(rows_u), jnp.asarray(inv),
                                          jnp.asarray(w), jnp.asarray(seg), n_bags))
    pal = np.asarray(gather_pool_pallas(jnp.asarray(rows_u), jnp.asarray(inv),
                                        jnp.asarray(w), jnp.asarray(seg), n_bags,
                                        interpret=True))
    np.testing.assert_allclose(got, exp, **TOL)
    np.testing.assert_allclose(got, pal, **TOL)
    if empty_bag is not None:
        assert (got[empty_bag] == 0.0).all() and (pal[empty_bag] == 0.0).all()


def test_embedding_bag_plain_matches_reference_and_pallas():
    rng = np.random.default_rng(5)
    v, d, n, nb = 64, 10, 40, 8
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.integers(0, v, n).astype(np.int32)
    seg = np.sort(np.concatenate([np.arange(nb), rng.integers(0, nb, n - nb)])).astype(np.int32)
    w = rng.normal(size=n).astype(np.float32)
    got = tref.embedding_bag_ref(_t(table), _t(ids), _t(seg), nb, _t(w)).numpy()
    args = (jnp.asarray(table), jnp.asarray(ids), jnp.asarray(seg))
    exp = np.asarray(jref.embedding_bag_ref(*args, nb, jnp.asarray(w)))
    pal = np.asarray(embedding_bag_pallas(*args, jnp.asarray(w), nb, interpret=True))
    np.testing.assert_allclose(got, exp, **TOL)
    np.testing.assert_allclose(got, pal, **TOL)


def _probe_case(kind, rng):
    h, d, n = 16, 8, 40
    keys = np.sort(rng.choice(200, h, replace=False)).astype(np.int32)
    rows = rng.normal(size=(h, d)).astype(np.float32)
    uniq = np.sort(np.concatenate([keys[:6], rng.integers(0, 200, n - 6)])).astype(np.int32)
    uvalid = np.arange(n) < n - 4
    if kind == "all_miss":
        uniq = np.sort(rng.integers(300, 400, n)).astype(np.int32)
    elif kind == "clamped":   # queries past every key clamp to slot H-1
        uniq = np.concatenate([uniq[:-8], keys[-1] + 1 + np.arange(8)]).astype(np.int32)
    elif kind == "invalid":   # planted hits masked by uvalid
        uvalid = np.zeros(n, bool)
    return uniq, uvalid, keys, rows


@pytest.mark.parametrize("kind", ["mixed", "all_miss", "clamped", "invalid"])
def test_tier_probe_plain_matches_reference_and_pallas(kind):
    uniq, uvalid, keys, rows = _probe_case(kind, np.random.default_rng(3))
    hit, slot, prow = ops.tier_probe(_t(uniq), _t(uvalid), _t(keys), _t(rows))
    jargs = (jnp.asarray(uniq), jnp.asarray(uvalid), jnp.asarray(keys), jnp.asarray(rows))
    for jhit, jslot, jrow in (jref.tier_probe_ref(*jargs),
                              tier_probe_pallas(*jargs, interpret=True)):
        np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
        np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
        np.testing.assert_array_equal(prow.numpy(), np.asarray(jrow))
    assert slot.dtype == torch.int32 and hit.dtype == torch.bool
    assert (prow.numpy()[~hit.numpy()] == 0.0).all()
    if kind == "mixed":
        assert hit.sum() > 0
    if kind in ("all_miss", "invalid"):
        assert not hit.any()
    if kind == "clamped":
        assert (slot.numpy()[-8:] == len(keys) - 1).all()


@pytest.mark.parametrize("b,f,d", [(8, 4, 8), (33, 7, 12), (65, 39, 10)])
def test_fm_plain_matches_reference_and_pallas(b, f, d):
    x = np.random.default_rng(b).normal(size=(b, f, d)).astype(np.float32)
    got = ops.fm_interaction(_t(x)).numpy()
    exp = np.asarray(jref.fm_interaction_ref(jnp.asarray(x)))
    pal = np.asarray(fm_interaction_pallas(jnp.asarray(x), block_b=16, interpret=True))
    assert got.shape == (b, 1)
    scale = np.abs(exp).max()
    np.testing.assert_allclose(got, exp, atol=1e-5 * scale, rtol=1e-5)
    np.testing.assert_allclose(got, pal, atol=1e-5 * scale, rtol=1e-5)


@pytest.mark.parametrize("spec,want", [("auto", None), (None, None), ("on", True),
                                       (True, True), ("off", False), (False, False)])
def test_resolve_fused_spellings(spec, want):
    assert ops.resolve_fused(spec) is want


def test_resolve_fused_rejects_typos():
    with pytest.raises(ValueError, match="use_fused_kernels"):
        ops.resolve_fused("yes")


def test_kernels_forced_on_cpu_tensors_raise():
    x = torch.zeros((4, 3, 2))
    with pytest.raises(ValueError, match="CUDA"):
        ops.fm_interaction(x, fused=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.gather_pool(torch.zeros((2, 2)), torch.zeros(2, dtype=torch.int32),
                        torch.ones(2), torch.zeros(2, dtype=torch.int32), 1, fused=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.tier_probe(torch.zeros(2, dtype=torch.int32), torch.ones(2, dtype=torch.bool),
                       torch.zeros(2, dtype=torch.int32), torch.zeros((2, 2)), fused=True)


def test_cpu_dispatch_counts_no_launch_and_builds_nothing():
    ops.reset_launches()
    rows_u, inv, w, seg = _pool_args(np.random.default_rng(1), 12, 4, 3, 6)
    ops.gather_pool(_t(rows_u), _t(inv), _t(w), _t(seg), 3)
    ops.fm_interaction(torch.ones((2, 3, 4)))
    assert ops.launches == {"tier_probe": 0, "gather_pool": 0, "fm_interaction": 0}
    assert not build._LAUNCHERS


def test_gather_pool_backward_is_next_slice():
    rows_u = torch.ones((3, 2), requires_grad=True)
    out = ops.gather_pool(rows_u, torch.tensor([0, 1, 2], dtype=torch.int32),
                          torch.ones(3), torch.tensor([0, 0, 1], dtype=torch.int32), 2)
    with pytest.raises(NotImplementedError, match="segment_grad: next slice"):
        out.sum().backward()


def test_every_kernel_has_a_c_entry_point_for_sm90a():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    for name, argtypes in build.SIGNATURES.items():
        src = (build.CSRC / f"{name}.cu").read_text()
        m = re.search(rf'extern "C" int {name}_launch\(([^)]*)\)', src)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes), name
        assert "cudaGetLastError()" in src and "Replaces" in src
