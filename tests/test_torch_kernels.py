"""The port's kernel layer against the reference on the CPU.

Each plain PyTorch version in ``repro_torch.kernels.ref`` is held against
``repro.kernels.ref`` and against the Pallas kernel in interpret mode, on
the same numpy inputs. Integer outputs must match bitwise, copied rows
exactly, and summed floats to 1e-5 (float32, different summation order).
The CUDA kernels themselves run only on the card (``chip_smoke.py``); here
the dispatch rules around them are pinned, and the autograd wiring of the
kernel path is checked with each CUDA wrapper stood in for by its plain
version.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.embedding_bag import embedding_bag_pallas
from repro.kernels.fm_interaction import fm_interaction_pallas
from repro.kernels.fused_embedding import (dedup_adagrad_pallas, gather_pool_pallas,
                                           segment_grad_pallas, tier_probe_pallas)
from repro.kernels.interaction_bwd import fm_interaction_bwd_pallas
from repro_torch.core import packed_embedding as pe
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


def _pool_layout(rng, kind, d):
    """Multi-position layouts of the pool (``chip_smoke.POOL_LAYOUTS`` at
    CPU size): runs of 1 to 200 positions with empty bags among them and
    at the tail; one long run among single positions; a single position."""
    if kind == "runs":
        runs = np.array([1, 200, 3, 17, 1, 64, 2])
        bags = np.array([0, 2, 3, 7, 8, 9, 12])  # 1, 4-6, 10-11 and 13-15 empty
        seg, n_bags = np.repeat(bags, runs), 16
    elif kind == "long run":
        seg = np.arange(300)
        seg[40:260] = 40
        n_bags = 300
    else:
        seg, n_bags = np.array([1]), 3
    n = seg.size
    rows_u = rng.normal(size=(n, d)).astype(np.float32)
    inv = rng.integers(0, n, n).astype(np.int32)
    w = rng.normal(size=n).astype(np.float32)
    return rows_u, inv, w, seg.astype(np.int32), n_bags


@pytest.mark.parametrize("kind,d", [("runs", 10), ("runs", 3), ("long run", 16), ("one", 1)])
def test_gather_pool_plain_matches_pallas_on_multi_position_layouts(kind, d):
    rows_u, inv, w, seg, n_bags = _pool_layout(np.random.default_rng(d), kind, d)
    got = ops.gather_pool(_t(rows_u), _t(inv), _t(w), _t(seg), n_bags).numpy()
    pal = np.asarray(gather_pool_pallas(jnp.asarray(rows_u), jnp.asarray(inv),
                                        jnp.asarray(w), jnp.asarray(seg), n_bags,
                                        interpret=True))
    exp = np.asarray(jref.gather_pool_ref(jnp.asarray(rows_u), jnp.asarray(inv),
                                          jnp.asarray(w), jnp.asarray(seg), n_bags))
    scale = max(float(np.abs(exp).max()), 1.0)
    np.testing.assert_allclose(got, pal, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-5 * scale)
    empty = np.setdiff1d(np.arange(n_bags), seg)
    assert (got[empty] == 0.0).all() and (pal[empty] == 0.0).all()


@pytest.mark.parametrize("d", [1, 3, 10, 16, 128, 129, 1024])
def test_gather_pool_wrapper_launches_once_without_scratch(monkeypatch, d):
    """The CUDA wrapper's one launch (checked with the device test
    bypassed): the rows, inv, w, seg and the output it allocates, then n,
    n_bags and D; no scratch tensor beside the output, any width."""
    seen, empties = [], []
    real_empty = torch.empty

    def empty(*a, **k):
        out = real_empty(*a, **k)
        empties.append(out)
        return out

    monkeypatch.setattr(ops, "_launch", lambda name, *a: seen.append((name, a)))
    monkeypatch.setattr(torch, "empty", empty)
    rows_u, inv, w, seg, n_bags = _pool_layout(np.random.default_rng(d), "runs", d)
    args = tuple(map(_t, (rows_u, inv, w, seg)))
    out = ops._gather_pool_cuda(*args, n_bags)
    assert tuple(out.shape) == (n_bags, d) and len(empties) == 1 and empties[0] is out
    ((name, launch),) = seen
    assert name == "gather_pool"
    assert launch == (*(t.data_ptr() for t in args), out.data_ptr(), seg.size, n_bags, d)


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


# the last two: D past a warp's 32 lanes (a lane sums columns c, c + 32, ...)
@pytest.mark.parametrize("b,f,d", [(8, 4, 8), (33, 7, 12), (65, 39, 10), (9, 5, 33),
                                   (5, 3, 129)])
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
    r = _t(rows_u).requires_grad_(True)
    ops.gather_pool(r, _t(inv), _t(w), _t(seg), 3).sum().backward()
    x = torch.ones((2, 3, 4), requires_grad=True)
    ops.fm_interaction(x).sum().backward()
    ops.segment_grad(torch.ones((3, 4)), _t(seg), _t(w), _t(inv), 12)
    ops.dedup_adagrad(torch.zeros((5, 4)), torch.zeros((5, 1)),
                      torch.tensor([1, 1, 3], dtype=torch.int32), torch.ones((3, 4)),
                      torch.ones(3, dtype=torch.bool), 0.05, 1e-8)
    ops.fm_interaction_bwd(torch.ones((2, 3, 4)), torch.ones((2, 1)))
    xc = torch.ones((3, 5), requires_grad=True)
    ops.cross_layer(xc, xc, torch.ones((5, 5)), torch.ones(5)).sum().backward()
    ops.cross_layer_bwd(xc, xc, torch.ones((5, 5)), torch.ones(5), torch.ones((3, 5)))
    back = torch.ones((4, 2), requires_grad=True)
    idx, kept = torch.tensor([0, 3, 3], dtype=torch.int32), torch.ones(3, dtype=torch.bool)
    wide, _ = ops.gather_project(back, idx, kept, torch.ones((2, 5)))
    wide.sum().backward()
    ops.gather_project_grad(torch.ones((3, 5)), torch.ones((3, 2)), idx, kept,
                            torch.ones((2, 5)), 4)
    ops.decompress_fp16(*ops.compress_fp16(torch.ones((3, 8))))
    vals, top = ops.compress_topk(torch.ones((3, 8)), 2)
    ops.decompress_topk(vals, top, 8)
    xd = torch.ones((2, 4, 3), requires_grad=True)
    ops.dot_interaction(xd).sum().backward()
    ops.dot_interaction_bwd(torch.ones((2, 4, 3)), torch.ones((2, 6)))
    table = torch.ones((5, 4))
    ops.put_rows(table, torch.tensor([1, 3]), ops.take_rows(table, torch.tensor([0, 2])))
    assert ops.launches == {"tier_probe": 0, "gather_pool": 0, "fm_interaction": 0,
                            "segment_grad": 0, "dedup_adagrad": 0,
                            "fm_interaction_bwd": 0, "cross_layer": 0,
                            "cross_layer_bwd": 0, "gather_project": 0,
                            "gather_project_grad": 0, "fp16_compress": 0,
                            "fp16_decompress": 0, "topk_compress": 0,
                            "topk_decompress": 0, "dot_interaction": 0,
                            "dot_interaction_bwd": 0, "host_rows": 0}
    assert not build._LAUNCHERS


def test_gather_pool_backward_is_next_slice():
    """The backward that the serving slice left raising is the segment-grad
    transpose now: the gradient onto ``rows_u`` is ``segment_grad`` of the
    output's cotangent, and the pooling weights get none."""
    rows_u = torch.ones((3, 2), requires_grad=True)
    w = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    out = ops.gather_pool(rows_u, torch.tensor([0, 1, 2], dtype=torch.int32), w,
                          torch.tensor([0, 0, 1], dtype=torch.int32), 2)
    out.sum().backward()
    np.testing.assert_array_equal(rows_u.grad.numpy(), [[1, 1], [2, 2], [3, 3]])
    assert w.grad is None


# ------------------------------------------------------- training kernels


@pytest.mark.parametrize("n,d,n_bags,n_uniq", [(48, 8, 12, 19), (24, 8, 6, 24),
                                               (64, 10, 64, 30), (39, 16, 13, 5)])
def test_segment_grad_plain_matches_reference_and_pallas(n, d, n_bags, n_uniq):
    rng = np.random.default_rng(n * d)
    _, inv, w, seg = _pool_args(rng, n, d, n_bags, n_uniq)
    g_bags = rng.normal(size=(n_bags, d)).astype(np.float32)
    got = ops.segment_grad(_t(g_bags), _t(seg), _t(w), _t(inv), n).numpy()
    jargs = (jnp.asarray(g_bags), jnp.asarray(seg), jnp.asarray(w), jnp.asarray(inv))
    exp = np.asarray(jref.segment_grad_ref(*jargs, n))
    pal = np.asarray(segment_grad_pallas(*jargs, n, interpret=True))
    assert got.shape == (n, d)
    np.testing.assert_allclose(got, exp, **TOL)
    np.testing.assert_allclose(got, pal, **TOL)
    # slots no position maps to are exactly zero
    assert (got[n_uniq:] == 0.0).all() and (pal[n_uniq:] == 0.0).all()


def _dedup_case(rows, d, m, hot, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(rows, d)).astype(np.float32)
    acc = np.abs(rng.normal(size=(rows, 1))).astype(np.float32)
    idx = rng.integers(0, hot, m).astype(np.int32)
    g = rng.normal(size=(m, d)).astype(np.float32)
    valid = rng.random(m) < 0.8
    idx[-3:] = rows  # a sentinel run, valid or not, is dropped
    return w, acc, idx, g, valid


@pytest.mark.parametrize("rows,d,m,hot", [(37, 8, 50, 37), (64, 16, 96, 5),
                                          (16, 4, 64, 2), (40, 10, 30, 40)])
def test_dedup_adagrad_plain_matches_reference_and_pallas(rows, d, m, hot):
    """Duplicates, invalid entries and a sentinel run: untouched rows stay
    bitwise, touched rows agree to 1e-6 (the adagrad arithmetic is fused
    differently by XLA; duplicate sums are in the same order)."""
    w, acc, idx, g, valid = _dedup_case(rows, d, m, hot, rows * m)
    tw, tacc = torch.tensor(w), torch.tensor(acc)
    w2, acc2 = ops.dedup_adagrad(tw, tacc, _t(idx), _t(g), _t(valid), 0.05, 1e-8)
    assert w2 is tw and acc2 is tacc  # in place on the tensors given
    jargs = tuple(map(jnp.asarray, (w, acc, idx, g, valid)))
    untouched = np.ones(rows, bool)
    touched = idx[valid]
    untouched[touched[touched < rows]] = False
    assert untouched.any() and (~untouched).any()
    for jw, jacc in (jref.dedup_adagrad_ref(*jargs, 0.05, 1e-8),
                     dedup_adagrad_pallas(*jargs, 0.05, 1e-8, interpret=True)):
        np.testing.assert_allclose(w2.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(acc2.numpy(), np.asarray(jacc), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(w2.numpy()[untouched], w[untouched])
    np.testing.assert_array_equal(acc2.numpy()[untouched], acc[untouched])


def _skewed_idx(rng, rows, m):
    """Row 3 at 33 positions and row 5 at m - 73 (both past the 32 a list
    sorts, so scanned), the other 40 positions on random rows."""
    idx = rng.integers(0, rows, m).astype(np.int32)
    perm = rng.permutation(m)
    idx[perm[:33]] = 3
    idx[perm[33:m - 40]] = 5
    return idx


# name -> (rows, d, m, hash table slots or None for the kernel's)
HASHED_CASES = {
    "distinct rows (k = 1)": (64, 4, 40, None),
    "k = 1, tiny table": (64, 10, 40, 64),
    "k = 33 and a long run": (48, 16, 120, None),
    "k = 33, tiny table": (48, 16, 120, 64),
    "all m positions on one row": (16, 10, 50, 2),
    "invalid, sentinel and outside [0, rows)": (30, 8, 64, 32),
}


@pytest.mark.parametrize("case", list(HASHED_CASES))
def test_dedup_hashed_grouping_matches_reference_and_pallas(case):
    """The CUDA kernels' grouping, emulated (``ref.dedup_adagrad_hashed``:
    hash insertion with probe collisions in a table forced tiny, lists in a
    shuffled arrival order, a per-row ascending sort or scan, ordered sums)
    is bitwise the plain version on the CPU, and within 1e-6 of the
    reference and of the Pallas kernel; untouched rows stay bitwise."""
    rows, d, m, cap = HASHED_CASES[case]
    rng = np.random.default_rng(len(case))
    w = rng.normal(size=(rows, d)).astype(np.float32)
    acc = np.abs(rng.normal(size=(rows, 1))).astype(np.float32)
    g = rng.normal(size=(m, d)).astype(np.float32)
    valid = np.ones(m, bool)
    if case.startswith("distinct") or case.startswith("k = 1,"):
        idx = rng.permutation(rows)[:m].astype(np.int32)
    elif case.startswith("k = 33"):
        idx = _skewed_idx(rng, rows, m)
    elif case.startswith("all"):
        idx = np.full(m, 9, np.int32)
    else:
        idx = rng.integers(0, 8, m).astype(np.int32)
        valid = rng.random(m) < 0.7
        idx[:6] = [rows, rows, -1, rows + 5, -7, 2**31 - 1]  # sentinel, outside
        valid[:6] = True
    args = (_t(idx), _t(g), _t(valid), 0.05, 1e-8)
    exp_w, exp_acc = tref.dedup_adagrad_ref(torch.tensor(w), torch.tensor(acc), *args)
    for seed in range(3):  # three arrival orders of the atomics
        got_w, got_acc = tref.dedup_adagrad_hashed(torch.tensor(w), torch.tensor(acc),
                                                   *args, cap=cap, seed=seed)
        assert torch.equal(got_w, exp_w) and torch.equal(got_acc, exp_acc)
    # the reference wraps a negative index as numpy does and drops only those
    # past the table; the port drops both, so it gets the negatives invalid
    jargs = tuple(map(jnp.asarray, (w, acc, idx, g, valid & (idx >= 0))))
    for jw, jacc in (jref.dedup_adagrad_ref(*jargs, 0.05, 1e-8),
                     dedup_adagrad_pallas(*jargs, 0.05, 1e-8, interpret=True)):
        np.testing.assert_allclose(got_w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_acc.numpy(), np.asarray(jacc), rtol=1e-6, atol=1e-6)
    kept = valid & (idx >= 0) & (idx < rows)
    untouched = np.ones(rows, bool)
    untouched[idx[kept]] = False
    assert untouched.any() and (~untouched).any()
    np.testing.assert_array_equal(got_w.numpy()[untouched], w[untouched])
    np.testing.assert_array_equal(got_acc.numpy()[untouched], acc[untouched])


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8, 9, 15_976, 16_384, 16_385])
def test_dedup_wrapper_hands_the_launcher_its_scratch(monkeypatch, m):
    """The hash table covers cap >= 2m slots, cap a power of two (so linear
    probing finds a free slot at load <= 1/2), and the scratch the launcher
    is handed holds it and the two per-position lists."""
    seen = []
    monkeypatch.setattr(ops, "_launch", lambda name, *a: seen.append((name, a)))
    rows, d = 7, 4
    w, acc = torch.zeros((rows, d)), torch.zeros((rows, 1))
    idx = torch.zeros(m, dtype=torch.int32)
    ops._dedup_adagrad_cuda(w, acc, idx, torch.zeros((m, d)), torch.ones(m, dtype=torch.bool),
                            0.05, 1e-8)
    ((name, args),) = seen
    assert name == "dedup_adagrad"
    ints, m_, rows_, d_, cap = args[6:11]
    assert (m_, rows_, d_) == (m, rows, d)
    assert cap >= 2 * m and cap & (cap - 1) == 0 and cap < 4 * m
    assert ints >= 2 * cap + 2 * m and (cap, ints) == ops.dedup_scratch(m)


def test_dedup_adagrad_all_invalid_is_identity():
    w, acc, idx, g, _ = _dedup_case(8, 4, 12, 8, 9)
    tw, tacc = torch.tensor(w), torch.tensor(acc)
    ops.dedup_adagrad(tw, tacc, _t(idx), _t(g), torch.zeros(12, dtype=torch.bool),
                      0.05, 1e-8)
    np.testing.assert_array_equal(tw.numpy(), w)
    np.testing.assert_array_equal(tacc.numpy(), acc)


@pytest.mark.parametrize("b,f,d", [(8, 4, 8), (33, 7, 12), (65, 39, 10)])
def test_fm_bwd_plain_matches_reference_pallas_and_vjp(b, f, d):
    rng = np.random.default_rng(b + f)
    x = rng.normal(size=(b, f, d)).astype(np.float32)
    g = rng.normal(size=(b, 1)).astype(np.float32)
    got = ops.fm_interaction_bwd(_t(x), _t(g)).numpy()
    jx, jg = jnp.asarray(x), jnp.asarray(g)
    _, vjp = jax.vjp(jref.fm_interaction_ref, jx)
    for exp in (jref.fm_interaction_bwd_ref(jx, jg),
                fm_interaction_bwd_pallas(jx, jg, block_b=16, interpret=True), vjp(jg)[0]):
        exp = np.asarray(exp)
        np.testing.assert_allclose(got, exp, atol=1e-5 * np.abs(exp).max(), rtol=1e-5)


def _plain_kernels(monkeypatch):
    """Take the kernel path on CPU tensors with each CUDA wrapper stood in
    for by its plain version, so autograd runs the kernel path's wiring."""
    monkeypatch.setattr(ops, "_use_kernel", lambda fused, t, op: True)
    monkeypatch.setattr(ops, "_fm_interaction_cuda", tref.fm_interaction_ref)
    monkeypatch.setattr(ops, "_fm_interaction_bwd_cuda", tref.fm_interaction_bwd_ref)
    monkeypatch.setattr(ops, "_gather_pool_cuda", tref.gather_pool_ref)
    monkeypatch.setattr(ops, "_segment_grad_cuda", tref.segment_grad_ref)


def test_fm_kernel_path_is_differentiable(monkeypatch):
    _plain_kernels(monkeypatch)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(9, 6, 10)).astype(np.float32)
    g = rng.normal(size=(9, 1)).astype(np.float32)
    tx = _t(x).requires_grad_(True)
    out = ops.fm_interaction(tx)
    assert out.grad_fn is not None
    (gx,) = torch.autograd.grad(out, tx, _t(g))
    _, vjp = jax.vjp(jref.fm_interaction_ref, jnp.asarray(x))
    np.testing.assert_allclose(gx.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               atol=1e-5, rtol=1e-5)


def test_gather_pool_kernel_path_is_differentiable(monkeypatch):
    _plain_kernels(monkeypatch)
    rng = np.random.default_rng(13)
    n, d, n_bags, n_uniq = 40, 10, 10, 17
    rows_u, inv, w, seg = _pool_args(rng, n, d, n_bags, n_uniq)
    g = rng.normal(size=(n_bags, d)).astype(np.float32)
    tr = _t(rows_u).requires_grad_(True)
    out = ops.gather_pool(tr, _t(inv), _t(w), _t(seg), n_bags)
    assert out.grad_fn is not None
    # a non-contiguous cotangent: the backward makes it contiguous
    gt = _t(np.ascontiguousarray(g.T)).T
    assert not gt.is_contiguous()
    (gr,) = torch.autograd.grad(out, tr, gt)
    _, vjp = jax.vjp(lambda r: jops.gather_pool(r, jnp.asarray(inv), jnp.asarray(w),
                                                jnp.asarray(seg), n_bags, fused=False),
                     jnp.asarray(rows_u))
    exp = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(gr.numpy(), exp, atol=1e-5, rtol=1e-5)
    assert (gr.numpy()[n_uniq:] == 0.0).all()


def test_training_kernels_forced_on_cpu_tensors_raise():
    with pytest.raises(ValueError, match="CUDA"):
        ops.segment_grad(torch.zeros((2, 2)), torch.zeros(2, dtype=torch.int32),
                         torch.ones(2), torch.zeros(2, dtype=torch.int32), 2, fused=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.dedup_adagrad(torch.zeros((2, 2)), torch.zeros((2, 1)),
                          torch.zeros(2, dtype=torch.int32), torch.zeros((2, 2)),
                          torch.ones(2, dtype=torch.bool), 0.05, 1e-8, fused=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.fm_interaction_bwd(torch.zeros((2, 3, 2)), torch.zeros((2, 1)), fused=True)


def test_training_wrappers_check_shapes_before_launch(monkeypatch):
    """The CUDA wrappers reject what their kernels do not take before any
    launch (checked here with the device test bypassed)."""
    monkeypatch.setattr(ops, "_launch", lambda *a: pytest.fail("launched"))
    with pytest.raises(ValueError, match="must match"):
        ops._segment_grad_cuda(torch.zeros((2, 2)), torch.zeros(3, dtype=torch.int32),
                               torch.ones(2), torch.zeros(2, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="dedup_adagrad"):
        ops._dedup_adagrad_cuda(torch.zeros((4, 2)), torch.zeros((3, 1)),
                                torch.zeros(2, dtype=torch.int32), torch.zeros((2, 2)),
                                torch.ones(2, dtype=torch.bool), 0.05, 1e-8)
    with pytest.raises(ValueError, match="D <= 128"):
        ops._dedup_adagrad_cuda(torch.zeros((4, 129)), torch.zeros((4, 1)),
                                torch.zeros(2, dtype=torch.int32), torch.zeros((2, 129)),
                                torch.ones(2, dtype=torch.bool), 0.05, 1e-8)
    with pytest.raises(ValueError, match="want"):
        ops._fm_interaction_bwd_cuda(torch.zeros((2, 3, 2)), torch.zeros((3, 1)))
    with pytest.raises(ValueError, match="contiguous"):
        ops._fm_interaction_bwd_cuda(torch.zeros((2, 3, 2)), torch.zeros((2, 2))[:, :1])


def test_every_kernel_has_a_c_entry_point_for_sm90a():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    for name, argtypes in build.SIGNATURES.items():
        src = (build.CSRC / f"{name}.cu").read_text()
        m = re.search(rf'extern "C" int {name}_launch\(([^)]*)\)', src)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes), name
        assert "cudaGetLastError()" in src and "Replaces" in src


# ------------------------------------------- the carried sort and the plans


@pytest.mark.parametrize("n,d,hi", [(48, 8, 12), (64, 10, 64), (39, 16, 1), (300, 4, 40)])
def test_segment_grad_along_carried_sort_matches_pallas(n, d, hi):
    """The plain ``segment_grad`` along the forward unique's stable sort
    (as the engine calls it) within 1e-6 of scale of the Pallas kernel in
    interpret mode; slots no position maps to are exactly 0 on both."""
    rng = np.random.default_rng(n + hi)
    ids = rng.integers(0, hi, n).astype(np.int32)
    u = pe.fixed_unique(_t(ids), sentinel=hi)
    seg = np.sort(rng.integers(0, n // 2, n)).astype(np.int32)
    w = rng.normal(size=n).astype(np.float32)
    g_bags = rng.normal(size=(n // 2, d)).astype(np.float32)
    got = ops.segment_grad(_t(g_bags), _t(seg), _t(w), u.inv, n, order=u.order,
                           sorted_inv=u.slot_sorted).numpy()
    pal = np.asarray(segment_grad_pallas(jnp.asarray(g_bags), jnp.asarray(seg),
                                         jnp.asarray(w), jnp.asarray(u.inv.numpy()), n,
                                         interpret=True))
    np.testing.assert_allclose(got, pal, atol=1e-6 * max(np.abs(pal).max(), 1.0), rtol=0)
    n_uniq = int(u.n_uniq)
    assert n_uniq < n and (got[n_uniq:] == 0.0).all() and (pal[n_uniq:] == 0.0).all()


def _recorded_launch(monkeypatch):
    seen = []
    monkeypatch.setattr(ops, "_launch", lambda name, *a: seen.append((name, a)))
    monkeypatch.setattr(ops, "sm_count", lambda device: 132)  # an H100's, off the card
    return seen


def test_segment_grad_wrapper_sorts_only_without_the_carried_sort(monkeypatch):
    """Along the carried sort the wrapper hands the launcher the forward's
    permutation and sorts nothing; standalone it sorts (stable) once and
    counts it; half a permutation is refused."""
    seen = _recorded_launch(monkeypatch)
    rng = np.random.default_rng(7)
    n, d = 40, 10
    ids = rng.integers(0, 9, n).astype(np.int32)
    u = pe.fixed_unique(_t(ids), sentinel=9)
    g_bags, seg, w = torch.ones((n, d)), torch.arange(n, dtype=torch.int32), torch.ones(n)
    ops.reset_launches()
    ops._segment_grad_cuda(g_bags, seg, w, u.inv, n, u.order, u.slot_sorted)
    assert ops.sorts["segment_grad"] == 0
    ops._segment_grad_cuda(g_bags, seg, w, u.inv, n)
    assert ops.sorts["segment_grad"] == 1
    (_, carried), (_, alone) = seen
    sorted_inv, order = torch.sort(u.inv, stable=True)
    assert carried[3] == u.order.data_ptr() and carried[4] == u.slot_sorted.data_ptr()
    assert carried[6:] == (n, n, d, *ops.segment_grad_plan(n, d, 132)) == alone[6:]
    with pytest.raises(ValueError, match="both"):
        ops._segment_grad_cuda(g_bags, seg, w, u.inv, n, u.order, None)
    with pytest.raises(ValueError, match="order"):
        ops._segment_grad_cuda(g_bags, seg, w, u.inv, n, u.order.to(torch.int32),
                               u.slot_sorted)
    ops.reset_launches()
    assert ops.sorts["segment_grad"] == 0


@pytest.mark.parametrize("n,d,plan", [
    (9_984, 10, (64, 512)),       # deepfm
    (6_656, 16, (32, 512)),       # dcn-v2
    (6_656, 128, (32, 64)),       # DLRM
    (2_555_904, 10, (256, 512)),  # bulk
    (100, 1024, (8, 8)),          # widest
    (5, 1, (16, 512))])           # D = 1
def test_segment_grad_plan_by_hand(n, d, plan):
    """Tiles: the largest power of two <= 256 with ceil(n / tile) >= 132
    blocks (one an SM of an H100), at least 16; 9,984 / 64 = 156 blocks
    (/ 128 = 78), 6,656 / 32 = 208. Chunks: 8,192 products, at most 512
    positions. The shared memory the launcher sizes from them (products
    over the int64 order, so at least two floats a position; weights, bag
    ids, chunk + 2 slots, tile + 1 run starts) stays under the 48 KB a
    block gets unasked."""
    assert ops.segment_grad_plan(n, d, 132) == plan
    tile, chunk = plan
    assert tile <= chunk
    assert chunk * max(d, 2) * 4 + chunk * 8 + (chunk + 2) * 4 + (tile + 1) * 4 <= 48 * 1024


@pytest.mark.parametrize("n,lanes", [(19_968, 8), (9_984, 16), (13_312, 8), (6_656, 16),
                                     (1_037, 32), (40_000, 4), (70_001, 2), (150_001, 1),
                                     (2_555_904, 1), (1, 32)])
def test_tier_probe_plan_by_hand(n, lanes):
    """Lanes: the most (a power of two up to 32) with n * lanes <= 132 SMs x
    1,280 threads = 168,960 on an H100, e.g. 19,968 x 8 = 159,744 while x 16
    = 319,488; 1 is the ranged search."""
    assert ops.tier_probe_plan(n, 132) == lanes
    assert lanes == 1 or n * lanes <= 168_960 < n * lanes * 2 or lanes == 32


def test_tier_probe_wrapper_hands_the_launcher_its_lanes(monkeypatch):
    seen = _recorded_launch(monkeypatch)
    n, h, d = 19_968, 64, 10
    ops._tier_probe_cuda(torch.zeros(n, dtype=torch.int32), torch.ones(n, dtype=torch.bool),
                         torch.arange(h, dtype=torch.int32), torch.zeros((h, d)))
    ((name, args),) = seen
    assert name == "tier_probe" and args[7:] == (n, h, d, 8)


# ------------------------------------------------------------- the FM plan


@pytest.mark.parametrize("b,f,d,plan", [
    (512, 39, 10, (3, 96, 1)),       # deepfm serving: 171 blocks
    (256, 39, 10, (1, 32, 1)),       # deepfm training: 256 blocks
    (65_536, 39, 10, (8, 256, 1)),   # bulk: eight warps, 12,480 bytes
    (1, 39, 10, (1, 32, 1)),         # B = 1
    (512, 1, 1, (3, 96, 1)),         # F = D = 1
    (65_536, 1, 1, (8, 256, 1)),     # tiny samples: eight warps
    (512, 39, 33, (3, 96, 1)),       # D = 33: 5,148 bytes a sample
    (512, 39, 129, (1, 32, 1)),      # D = 129: 20,124 bytes, one a block
    (4, 100, 200, (1, 32, 0)),       # 80,000 bytes: read unstaged
    (2_000, 100, 200, (8, 256, 0))])  # unstaged, eight warps a block
def test_fm_plan_by_hand(b, f, d, plan):
    """Samples a block, a warp each: B // 132 (one block an SM of an H100
    where the batch allows), no more than 16 KB of them nor eight, at least
    one; staged unless one sample passes 48 KB."""
    assert ops.fm_plan(b, f, d, 132) == plan
    spb, threads, staged = plan
    assert threads % 32 == 0 and 32 <= threads <= 256
    assert -(-b // spb) >= min(b, 132) or spb == 1
    assert not staged or 4 * (spb * f * d + 3) <= 48 * 1024


def _fm_blocks(b, f, d, spb, base):
    """What each block of the forward kernel copies into shared memory, as
    its index arithmetic does, for ``x`` at byte address ``base``: per
    block (head floats, 16-byte copies, tail floats, shift, floats)."""
    fd = f * d
    for blk in range(-(-b // spb)):
        s0 = blk * spb
        total = min(spb, b - s0) * fd
        addr = base + 4 * s0 * fd
        head = min(((16 - addr % 16) % 16) // 4, total)
        n4 = (total - head) // 4
        yield head, n4, total - head - 4 * n4, (4 - head) & 3, total, addr


@pytest.mark.parametrize("b,f,d", [(512, 39, 10), (256, 39, 10), (37, 39, 10), (9, 5, 33),
                                   (7, 3, 129), (65, 1, 1), (33, 7, 3)])
@pytest.mark.parametrize("base", [0, 4, 8, 12])
def test_fm_staging_copies_each_float_once(b, f, d, base):
    """Each block's head, 16-byte and tail copies cover its samples' floats
    exactly once, every 16-byte copy is aligned on both sides, and the
    shifted range stays inside the (spb * F * D + 3)-float buffer, whatever
    the alignment of ``x`` (a 1,560-byte deepfm sample puts every other
    block off a 16-byte boundary)."""
    spb, threads, staged = ops.fm_plan(b, f, d, 132)
    assert staged
    covered = 0
    for head, n4, tail, shift, total, addr in _fm_blocks(b, f, d, spb, base):
        assert head < 4 and tail < 4 and head <= threads and tail <= threads
        assert head + 4 * n4 + tail == total
        assert (addr + 4 * head) % 16 == 0 or n4 == 0
        assert (shift + head) % 4 == 0
        assert shift + total <= spb * f * d + 3
        covered += total
    assert covered == b * f * d


def test_fm_wrapper_hands_the_launcher_its_plan(monkeypatch):
    seen = _recorded_launch(monkeypatch)
    for b, f, d in ((512, 39, 10), (256, 39, 10), (3, 100, 200)):
        ops._fm_interaction_cuda(torch.zeros((b, f, d)))
        name, args = seen[-1]
        assert name == "fm_interaction" and args[2:] == (b, f, d, *ops.fm_plan(b, f, d, 132))
    ops._fm_interaction_cuda(torch.zeros((0, 39, 10)))
    assert len(seen) == 3  # an empty batch launches nothing


# ---------------------------------------------------------- the FM backward


@pytest.mark.parametrize("b,f,d,plan", [
    (256, 39, 10, (1, 128, 1)),       # deepfm training: 256 blocks, 390 floats each
    (512, 39, 10, (2, 224, 1)),       # B = 512: 3 a block would not be whole float4s
    (65_536, 39, 10, (8, 256, 1)),    # bulk: eight samples, 12,480 bytes
    (1, 39, 10, (1, 128, 1)),         # B = 1
    (37, 39, 10, (1, 128, 1)),        # fewer samples than SMs
    (333, 7, 3, (4, 32, 1)),          # D = 3: 21-float samples, at least 64 floats a block
    (512, 2, 3, (10, 32, 1)),         # 11 samples for 64 floats; 10 for whole float4s
    (512, 39, 33, (1, 256, 1)),       # D = 33: no count of 5,148-byte samples but 1 fits
    (512, 39, 129, (1, 256, 1)),      # D = 129: 20,124 bytes, one a block
    (512, 1, 1, (64, 64, 0)),         # 4-byte samples: direct, 64 a block
    (64, 100, 200, (1, 224, 0)),      # 80,000 bytes: direct, a thread a column
    (2_000, 100, 200, (8, 256, 0)),   # direct, eight samples a block
    (512, 1, 12_000, (3, 256, 0))])   # the column sums alone pass 48 KB
def test_fm_bwd_plan_by_hand(b, f, d, plan):
    """Samples a block: B // 132 (one block an SM of an H100 where the batch
    allows), no more than 16 KB of them nor eight, at least 64 floats'
    worth; then the most no more than that whose outputs are whole 16-byte
    stores, else one. Staged, threads for at most one 16-byte store each
    (390 floats: 98 -> 128), 32 to 256; direct (one sample with its sums
    past 48 KB, or under 16 bytes), a thread a (sample, column). Staged
    blocks fit their samples (+ 3 floats of shift), column sums and
    cotangents in the 48 KB a block gets unasked."""
    assert ops.fm_bwd_plan(b, f, d, 132) == plan
    spb, threads, staged = plan
    fd = f * d
    assert threads % 32 == 0 and 32 <= threads <= 256
    assert spb <= max(b // 132, -(-64 // fd), 1)
    assert not staged or spb == 1 or spb * fd % 4 == 0
    assert not staged or spb <= threads  # a thread a cotangent
    assert not staged or 4 * (spb * (fd + d + 1) + 3) <= 48 * 1024
    assert staged or fd < 4 or 4 * (fd + d + 1 + 3) > 48 * 1024


def _fm_bwd_writes(b, f, d, spb, threads, base):
    """The outputs the staged backward kernel writes, as its index
    arithmetic computes them, for ``out`` at byte address ``base``: each
    block's column sums, a (sample, column) pair a thread stepped by the
    block's threads; its scalar head and tail; then its 16-byte stores with
    (sample, float in sample, column) advanced by 32-bit steps. Asserts
    that each pair is summed once, each store's alignment and each
    element's (sample, column); returns how often each output was
    written."""
    fd = f * d
    hits = np.zeros(b * fd, np.int64)
    for blk in range(-(-b // spb)):
        s0 = blk * spb
        total = min(spb, b - s0) * fd
        addr = base + 4 * s0 * fd
        summed = np.zeros(spb * d, np.int64)  # the column sums' pairs, stepped
        pds, pdc = divmod(threads, d)
        for t in range(threads):
            ps, pc = divmod(t, d)
            for p in range(t, min(spb, b - s0) * d, threads):
                assert (ps, pc) == divmod(p, d)
                summed[p] += 1
                ps, pc = ps + pds, pc + pdc
                if pc >= d:
                    ps, pc = ps + 1, pc - d
        assert (summed[: min(spb, b - s0) * d] == 1).all()
        head = min(((16 - addr % 16) % 16) // 4, total)
        n4 = (total - head) // 4
        tail = head + 4 * n4
        for t in range(min(threads, head + total - tail)):
            e = t if t < head else tail + t - head
            hits[s0 * fd + e] += 1
        step = 4 * threads
        ds, dr = divmod(step, fd)
        dc = dr % d
        for t in range(min(threads, n4)):
            e = head + 4 * t
            s, r = divmod(e, fd)
            c = r % d
            for _ in range(t, n4, threads):
                assert (addr + 4 * e) % 16 == 0
                ss, rr, cc = s, r, c
                for i in range(4):
                    assert (ss, cc) == ((e + i) // fd, (e + i) % fd % d)
                    hits[s0 * fd + e + i] += 1
                    cc = 0 if cc + 1 == d else cc + 1
                    rr += 1
                    if rr == fd:
                        rr, ss = 0, ss + 1
                e, s, r, c = e + step, s + ds, r + dr, c + dc
                if c >= d:
                    c -= d
                if r >= fd:
                    r, s = r - fd, s + 1
    return hits


@pytest.mark.parametrize("b,f,d", [(256, 39, 10), (512, 39, 10), (37, 39, 10), (9, 5, 33),
                                   (7, 3, 129), (65, 1, 4), (333, 7, 3), (512, 2, 3)])
@pytest.mark.parametrize("base", [0, 4, 8, 12])
def test_fm_bwd_writes_each_float_once(b, f, d, base):
    """The staged backward's copies cover each input float once with every
    16-byte copy aligned on both sides, its shared memory holds the shifted
    samples, the column sums and the cotangents within the launcher's size,
    and its writes cover each output float once with every 16-byte store
    aligned and each element given its own (sample, column), whatever the
    alignment of ``x`` and of ``out`` (0, 4, 8, 12 bytes off 16): the two
    ranges are aligned independently."""
    spb, threads, staged = ops.fm_bwd_plan(b, f, d, 132)
    assert staged
    smem = spb * (f * d + d + 1) + 3
    for x_base in (0, 4, 8, 12):
        covered = 0
        for head, n4, tail, shift, total, addr in _fm_blocks(b, f, d, spb, x_base):
            assert head + 4 * n4 + tail == total and head <= threads and tail <= threads
            assert (addr + 4 * head) % 16 == 0 or n4 == 0
            assert (shift + head) % 4 == 0 and shift + total <= spb * f * d + 3
            covered += total
        assert covered == b * f * d
    assert (spb * f * d + 3) + spb * d + spb == smem <= 12 * 1024
    hits = _fm_bwd_writes(b, f, d, spb, threads, base)
    assert (hits == 1).all()


@pytest.mark.parametrize("b,f,d", [(64, 100, 200), (5, 1, 12_000), (9, 120, 110),
                                   (512, 1, 1), (100, 3, 1)])
def test_fm_bwd_direct_writes_each_float_once(b, f, d):
    """The direct backward (a sample with its sums past 48 KB, or under 16
    bytes): a thread a (sample, column) of the block's ``spb * D``, stepped
    by the block's threads, writing its F outputs at k * D + c, covers each
    output once."""
    spb, threads, staged = ops.fm_bwd_plan(b, f, d, 132)
    assert not staged
    hits = np.zeros(b * f * d, np.int64)
    for blk in range(-(-b // spb)):
        s0 = blk * spb
        for t in range(threads):
            for p in range(t, min(spb, b - s0) * d, threads):
                s, c = divmod(p, d)
                hits[(s0 + s) * f * d + np.arange(f) * d + c] += 1
    assert (hits == 1).all()


def test_fm_bwd_wrapper_hands_the_launcher_its_plan(monkeypatch):
    seen = _recorded_launch(monkeypatch)
    for b, f, d in ((256, 39, 10), (512, 39, 10), (3, 100, 200)):
        x, g = torch.zeros((b, f, d)), torch.zeros((b, 1))
        out = ops._fm_interaction_bwd_cuda(x, g)
        name, args = seen[-1]
        assert name == "fm_interaction_bwd" and args[:3] == (x.data_ptr(), g.data_ptr(),
                                                             out.data_ptr())
        assert args[3:] == (b, f, d, *ops.fm_bwd_plan(b, f, d, 132))
        assert out.shape == (b, f, d)
    ops._fm_interaction_bwd_cuda(torch.zeros((0, 39, 10)), torch.zeros((0, 1)))
    ops._fm_interaction_bwd_cuda(torch.zeros((4, 0, 10)), torch.zeros((4, 1)))
    assert len(seen) == 3  # an empty input launches nothing
