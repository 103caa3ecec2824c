"""The port's training path against the reference on the CPU.

Trajectory: deepfm-smoke (and dcn-v2-smoke, from ``test_torch_dcn.py``) at
GB = 64 with a tiny hot tier that is flushed at step 3, so later steps take
the hit-gradient path. The reference's
``init_state`` on ``mesh1`` is carried over by ``train_state_from_jax``,
both sides get the same batches, and the reference's
``make_train_step(use_fused_kernels='off')`` is held against the port's
step. Losses must agree to rtol 1e-4 / atol 1e-5 (float32 sums in another
order, compounding over 8 steps; the reference's own fused-vs-plain bar),
hits and overflow exactly, integer state (FCounter, tier keys) bitwise,
float state to atol 1e-4.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.core import packed_embedding as jpe
from repro.core.packing import make_plan as jmake_plan
from repro.data.synthetic import batch_stream as jbatch_stream
from repro.data.synthetic import make_batch as jmake_batch
from repro.dist.compat import shard_map
from repro.layers import interactions as jinter
from repro.layers import mlp as jmlp
from repro.models import wdl as jwdl
from repro.dist.sharding import batch_specs, to_named
from repro.models.wdl import WDLModel as JWDLModel
from repro.optim import optimizers as jopt
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import init_state as jinit_state
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_jax
from repro_torch.core import packed_embedding as pe
from repro_torch.core.packing import make_plan
from repro_torch.data.pipeline import Prefetcher, ReplayableStream
from repro_torch.data.synthetic import batch_stream, make_batch
from repro_torch.engine import EmbeddingEngine
from repro_torch.kernels import ops
from repro_torch.launch import train as train_launcher
from repro_torch.layers import interactions as tinter
from repro_torch.models import wdl as twdl
from repro_torch.models.wdl import WDLModel
from repro_torch.optim import optimizers as topt
from repro_torch.train.train_step import (TrainConfig, init_state, make_flush_fn,
                                          make_train_step)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
AXES = ("data", "model")
GB = 64
STEPS = 8


def _t(x):
    return torch.as_tensor(np.array(x))


def _plans(n_micro, arch="deepfm", **plan_kw):
    kw = dict(hot_bytes=1 << 14, flush_iters=3, warmup_iters=2, n_micro=n_micro, **plan_kw)
    jplan = jmake_plan(jget_config(arch, smoke=True), 1, GB, **kw)
    plan = make_plan(get_config(arch, smoke=True), 1, GB, **kw)
    return jplan, plan


@pytest.mark.parametrize("cache_update,n_micro", [("psum", 1), ("stale", 1), ("psum", 2)])
def test_train_trajectory_matches_reference(mesh1, cache_update, n_micro):
    check_train_trajectory(mesh1, "deepfm", cache_update, n_micro)


# ReLU units a shared-state run may hand over (``_KinkAware``); the sweep
# over PYTHONHASHSEED 0-47 met at most one a run
MAX_KINKS = 4


class _RecordingTorch:
    """``torch`` for ``repro_torch.layers.interactions`` under
    ``_KinkAware``: ``relu`` (sasrec's feed-forward, its one call there)
    records its input first; every other name is torch's own."""

    def __init__(self, record):
        self._record = record

    def relu(self, z):
        self._record(z)
        return torch.relu(z)

    def __getattr__(self, name):
        return getattr(torch, name)


class _KinkAware:
    """Hands the port's side of an undetermined ReLU kink to the reference.

    A hidden unit whose pre-activation, evaluated in float64 from the
    reference's float32 inputs, lies within the float32 summation bound of
    zero (``n_in`` x 2^-24 x the sum of its terms' magnitudes) has no sign
    that float32 determines: the two sides sum it in different orders, and
    one can pass its gradient while the other blocks it (deepfm smoke under
    ``ps`` and ``--grad-compress fp16``, ``PYTHONHASHSEED=3``, step 3:
    sample 8's first-layer unit at 1.6e-7, its pooled gradient 3.5e-4
    apart, amplified to 1.1e-3 in the master through the fp16 rows and
    Adagrad). No rule on the reference's side alone can pick the port's
    rounding, so the port's MLP records each layer's pre-activations as its
    step runs (first, ``new_step`` clearing the record), and the
    reference's MLP computes its ReLU mask through a host callback that
    takes the port's mask for such units only, from the port's call of the
    same step and layer (among a step's micro-batches, the nearest).
    Every other unit, and every other quantity, stays the reference's own.
    The caller asserts that no unit differs outside the bound
    (``unexplained``), that every reference call found its port call
    (``unmatched``), and that at most ``MAX_KINKS`` units were handed over.

    SASRec's feed-forward (``sasrec_block``: ``relu(ff1(ln2(x)))``) is
    such a ReLU too, outside any ``mlp``: the port's block runs as it is,
    its ``torch.relu`` recording the pre-activations
    (``_RecordingTorch``), and the reference's block takes its mask the
    same way (sasrec smoke under ``PYTHONHASHSEED=87``, step 7: sample
    33's position 3, unit 10, at 1.4e-7 with a bound above it; without the
    hand-over one table row of 16 values parted by up to 4.3e-3)."""

    def __init__(self):
        self.port_calls: dict = {}
        self.kinks = self.unexplained = self.unmatched = 0

    def new_step(self):
        self.port_calls = {}

    def _record(self, key, z):
        self.port_calls.setdefault((key, tuple(z.shape)), []).append(
            z.detach().numpy().copy())

    def _ref_relu(self, key, z, x, w, b):
        mask = jax.pure_callback(
            lambda zz, xx, ww, bb: self._reconcile(key, zz, xx, ww, bb),
            jax.ShapeDtypeStruct(z.shape, jnp.bool_),
            *(jax.lax.stop_gradient(v) for v in (z, x, w, b)))
        return jnp.where(mask, z, jnp.zeros_like(z))

    def __enter__(self):
        self._orig = (twdl.mlp, jwdl.mlp, tinter.torch, jinter.sasrec_block)
        port_orig = twdl.mlp

        def port_mlp(p, x, act=torch.relu, final_act=True):
            layer = iter(range(jmlp.n_layers(p)))

            def rec(z):
                key = (next(layer), tuple(z.shape))
                self.port_calls.setdefault(key, []).append(z.detach().numpy().copy())
                return act(z)
            return port_orig(p, x, act=rec, final_act=final_act)

        def ref_mlp(p, x, act=jax.nn.relu, final_act=True):
            n = jmlp.n_layers(p)
            for i in range(n):
                lp = p[f"l{i}"]
                z = jmlp.linear(lp, x)
                if i < n - 1 or final_act:
                    x = self._ref_relu(i, z, x, lp["w"], lp["b"])
                else:
                    x = z
            return x

        def ref_sasrec_block(p, x, mask, n_heads):
            # repro.layers.interactions.sasrec_block, its ReLU reconciled
            h = jinter.mha(p["attn"], jinter.layernorm(p["ln1"], x), mask, n_heads,
                           causal=True)
            x = x + h
            u = jinter.layernorm(p["ln2"], x)
            z = jinter.linear(p["ff1"], u)
            f = jinter.linear(p["ff2"], self._ref_relu("ff1", z, u, p["ff1"]["w"],
                                                       p["ff1"]["b"]))
            return (x + f) * mask[..., None].astype(x.dtype)

        twdl.mlp, jwdl.mlp = port_mlp, ref_mlp
        tinter.torch = _RecordingTorch(lambda z: self._record("ff1", z))
        jinter.sasrec_block = ref_sasrec_block
        return self

    def __exit__(self, *exc):
        twdl.mlp, jwdl.mlp, tinter.torch, jinter.sasrec_block = self._orig

    def _reconcile(self, layer, z, x, w, b):
        z = np.asarray(z)
        x64, w64, b64 = (np.asarray(v, np.float64) for v in (x, w, b))
        z64 = x64 @ w64 + b64
        bound = w64.shape[0] * 2.0 ** -24 * (np.abs(x64) @ np.abs(w64) + np.abs(b64))
        mask = z > 0
        same = self.port_calls.get((layer, z.shape), [])
        if not same:
            self.unmatched += 1
            return mask
        zp = min(same, key=lambda c: float(np.abs(c - z).max()))
        if float(np.abs(zp - z).max()) > 1e-3 * (1.0 + float(np.abs(z).max())):
            self.unmatched += 1
            return mask
        differ = mask != (zp > 0)
        undetermined = np.abs(z64) <= bound
        self.kinks += int((differ & undetermined).sum())
        self.unexplained += int((differ & ~undetermined).sum())
        return np.where(differ & undetermined, zp > 0, mask)


def check_train_trajectory(mesh1, arch, cache_update, n_micro, shared_state=False,
                           plan_kw=None, **tkw):
    if not shared_state:
        return _check_train_trajectory(mesh1, arch, cache_update, n_micro, plan_kw=plan_kw,
                                       **tkw)
    with _KinkAware() as kinks:
        out = _check_train_trajectory(mesh1, arch, cache_update, n_micro, kinks, plan_kw,
                                      **tkw)
    assert (kinks.unexplained, kinks.unmatched) == (0, 0), vars(kinks)
    assert kinks.kinks <= MAX_KINKS, vars(kinks)
    return out


def _check_train_trajectory(mesh1, arch, cache_update, n_micro, kinks=None,
                            plan_kw=None, **tkw):
    """The trajectory check for one smoke arch (``tests/test_torch_dcn.py``
    runs it for dcn-v2); ``tkw`` are further ``TrainConfig`` fields for both
    sides (``tests/test_torch_compress.py`` passes the compression modes,
    ``tests/test_torch_strategies.py`` the strategies) and ``plan_kw``
    further ``make_plan`` arguments. An engine with a tier takes hits
    exactly from the step after the step-3 flush; one without takes none.

    With ``shared_state`` the port's state is rebuilt from the reference's
    (``train_state_from_jax``) before every step and held to it after every
    step, at the same bars: each step starts from one state, so a last-bit
    difference cannot compound across steps (fp16 rounding puts the two
    sides' rows 5e-5 apart, and a ReLU kink can amplify that past 1e-4);
    ``kinks`` (a ``_KinkAware``, given exactly for such a run) is told of
    every port step before it runs."""
    shared_state = kinks is not None
    jcfg = jget_config(arch, smoke=True)
    jplan, plan = _plans(n_micro, arch, **(plan_kw or {}))
    jmodel = JWDLModel(jcfg, jplan)
    jstate = jinit_state(jmodel, jplan, jax.random.PRNGKey(0), mesh=mesh1, axes=AXES)
    state = train_state_from_jax(jax.device_get(jstate), plan, "cpu")
    jstep, _ = jmake_train_step(
        jmodel, jplan, mesh1, AXES, GB,
        JTrainConfig(use_fused_kernels="off", cache_update=cache_update, **tkw), donate=False)
    step = make_train_step(WDLModel(get_config(arch, smoke=True), plan), plan, GB,
                           TrainConfig(use_fused_kernels="off", cache_update=cache_update,
                                       **tkw), "cpu")
    assert step.n_micro == n_micro and step.use_overlap == (n_micro > 1)
    rng = np.random.default_rng(0)
    jl, tl, jm, tm = [], [], [], []
    for _ in range(STEPS):
        b = jmake_batch(jcfg, GB, rng)
        if shared_state:
            state = train_state_from_jax(jax.device_get(jstate), plan, "cpu")
        # the port's step first: a tie-aware topk check
        # (tests/test_torch_compress.py) hands its selection to the reference
        if shared_state:
            kinks.new_step()
        state, met = step(state, b)
        jstate, jmet = jstep(jstate, jax.device_put(b, to_named(mesh1, batch_specs(b, AXES))))
        jl.append(float(jmet["loss"]))
        tl.append(float(met["loss"]))
        jm.append((int(jmet["cache_hits"]), int(jmet["overflow"]), int(jmet["step"])))
        tm.append((int(met["cache_hits"]), int(met["overflow"]), met["step"]))
        if shared_state:
            np.testing.assert_allclose(tl[-1], jl[-1], rtol=1e-4, atol=1e-5)
            assert tm[-1] == jm[-1]
            _check_state(state, jax.device_get(jstate))
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-5)
    assert tm == jm
    if step.engine.any_cache:
        assert all(h > 0 for h, _, _ in tm[3:]) and all(h == 0 for h, _, _ in tm[:3])
    else:
        assert all(h == 0 for h, _, _ in tm)
    _check_state(state, jax.device_get(jstate))
    assert int(state["opt"]["t"]) == STEPS


def _check_state(state, jfin):
    """The port's train state against the reference's (host numpy), every
    group: integer state bitwise, float state to atol 1e-4."""
    assert sorted(state["emb"]) == sorted(jfin["emb"])
    for key, st in state["emb"].items():
        jst = jfin["emb"][key]
        np.testing.assert_array_equal(st.counts.numpy(), np.asarray(jst.counts))
        np.testing.assert_array_equal(st.cache.keys.numpy(), np.asarray(jst.cache.keys))
        for got, exp in ((st.w, jst.w), (st.acc, jst.acc), (st.cache.rows, jst.cache.rows),
                         (st.cache.acc, jst.cache.acc)):
            np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-4, rtol=0)
    for tree, jtree in ((state["dense"], jfin["dense"]), (state["opt"]["m"], jfin["opt"]["m"]),
                        (state["opt"]["v"], jfin["opt"]["v"])):
        leaves = topt.tree_leaves(tree)
        jleaves = jax.tree.leaves(jtree)
        assert len(leaves) == len(jleaves)
        for a, b in zip(leaves, jleaves):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)
    assert int(state["opt"]["t"]) == int(jfin["opt"]["t"])


def test_kink_takes_the_port_side_only_within_the_summation_bound():
    """Two units whose ReLU masks differ between the sides: the one whose
    float64 pre-activation lies within the float32 summation bound takes
    the port's mask; the one outside it keeps the reference's, so a real
    difference still parts the trajectories. A port call of another layer,
    or one recorded before ``new_step``, is never matched."""
    kinks = _KinkAware()
    x = np.ones((1, 2), np.float32)
    # units: 0.5; 1 - 1 = 0 exactly (bound 2 x 2^-24 x 2); 0.2; 1e-4
    w = np.array([[0.5, 1.0, 0.1, 1e-4], [0.0, -1.0, 0.1, 0.0]], np.float32)
    b = np.zeros(4, np.float32)
    z = x @ w + b
    kinks.port_calls[(0, (1, 4))] = [np.array([[0.5, 1e-7, 0.2, -1e-4]], np.float32)]
    mask = kinks._reconcile(0, z, x, w, b)
    np.testing.assert_array_equal(mask, [[True, True, True, True]])
    assert (kinks.kinks, kinks.unexplained, kinks.unmatched) == (1, 1, 0)
    own = [[True, False, True, True]]  # the reference's mask, unmatched
    np.testing.assert_array_equal(kinks._reconcile(1, z, x, w, b), own)  # no layer-1 call
    kinks.new_step()
    np.testing.assert_array_equal(kinks._reconcile(0, z, x, w, b), own)
    assert (kinks.kinks, kinks.unexplained, kinks.unmatched) == (1, 1, 2)


def test_host_scheduled_flush_matches_in_step_flush():
    """``flush_in_step=False`` plus ``make_flush_fn`` after the flush steps
    trains bit for bit like the in-step flush."""
    _, plan = _plans(1)
    cfg = get_config("deepfm", smoke=True)
    model = WDLModel(cfg, plan)
    runs = []
    for in_step in (True, False):
        state = init_state(model, plan, torch.Generator().manual_seed(0), "cpu")
        step = make_train_step(model, plan, GB, TrainConfig(flush_in_step=in_step), "cpu")
        flush = make_flush_fn(plan)
        rng = np.random.default_rng(1)
        losses = []
        for _ in range(5):
            state, m = step(state, make_batch(cfg, GB, rng))
            if not in_step and m["step"] % plan.flush_iters == 0:
                state = flush(state)
            losses.append(float(m["loss"]))
        runs.append((losses, state["emb"]["0"]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1].cache, runs[1][1].cache):
        assert torch.equal(a, b)
    assert (runs[0][1].cache.keys < plan.groups[0].rows).any()


@pytest.mark.parametrize("n_micro", [1, 2])
def test_engine_backward_runs_segment_grad_along_the_forward_sort(monkeypatch, n_micro):
    """Every ``segment_grad`` of a training step, through the flush at step
    3, gets the forward unique's permutation: ``inv``'s stable sort and
    ``inv`` in its order, so the kernel path needs no sort of its own."""
    calls, real = [], ops.segment_grad

    def spy(g_bags, seg, weights, inv, n_rows, fused=None, order=None, sorted_inv=None):
        calls.append((inv, order, sorted_inv))
        return real(g_bags, seg, weights, inv, n_rows, fused, order, sorted_inv)

    monkeypatch.setattr(ops, "segment_grad", spy)
    _, plan = _plans(n_micro)
    cfg = get_config("deepfm", smoke=True)
    model = WDLModel(cfg, plan)
    state = init_state(model, plan, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(model, plan, GB, TrainConfig(), "cpu")
    rng = np.random.default_rng(2)
    for _ in range(4):
        state, _ = step(state, make_batch(cfg, GB, rng))
    assert len(calls) == 4 * n_micro * len(plan.groups)
    for inv, order, sorted_inv in calls:
        expect_sorted, expect_order = torch.sort(inv, stable=True)
        assert torch.equal(order, expect_order) and torch.equal(sorted_inv, expect_sorted)


def test_engine_training_flags():
    _, plan = _plans(1)
    on = EmbeddingEngine(plan, 1)
    off = EmbeddingEngine(plan, 1, use_cache=False, use_interleave=False,
                          cache_update="stale", lr_emb=0.1, eps=1e-6)
    assert on.any_cache and not off.any_cache and not any(off.cache_on.values())
    assert off.waves == [[g.gid for g in plan.groups]]
    st = off.strategies[0]
    assert (st.lr, st.eps, st.cache_update) == (0.1, 1e-6, "stale")
    assert on.metric_keys == ("overflow", "cache_hits")
    with pytest.raises(ValueError, match="cache_update"):
        EmbeddingEngine(plan, 1, cache_update="eager")


def _sparse_case():
    rng = np.random.default_rng(21)
    rows, d, n, h = 300, 10, 96, 32
    w = rng.normal(size=(rows, d)).astype(np.float32)
    acc = np.abs(rng.normal(size=(rows, 1))).astype(np.float32)
    ids = rng.integers(0, rows, n).astype(np.int32)
    keys = np.sort(np.concatenate([rng.choice(np.unique(ids), h // 2, replace=False),
                                   np.full(h // 2, rows)])).astype(np.int32)
    hot = rng.normal(size=(h, d)).astype(np.float32)
    hot_acc = np.abs(rng.normal(size=(h, 1))).astype(np.float32)
    g_u = rng.normal(size=(n, d)).astype(np.float32)
    return w, acc, ids, keys, hot, hot_acc, g_u


@pytest.mark.parametrize("cache_update", ["psum", "stale"])
def test_apply_sparse_grads_matches_reference(mesh1, cache_update):
    """One lookup + one ``apply_sparse_grads`` call, with tier hits and a
    bucket capacity small enough to overflow."""
    w, acc, ids, keys, hot, hot_acc, g_u = _sparse_case()
    cap = 40

    def f(w, acc, ids, keys, hot, hot_acc, g_u):
        _, ctx = jpe.mp_lookup(w, ids, axes=AXES, world=1, capacity=cap,
                               hot_keys=keys, hot_rows=hot)
        cache = jpe.CacheState(keys, hot, hot_acc)
        w2, acc2, c2 = jpe.apply_sparse_grads(w, acc, cache, ctx, g_u, axes=AXES, world=1,
                                              lr=0.05, cache_update=cache_update)
        return w2, acc2, c2.rows, c2.acc, ctx.routing.overflow, jnp.sum(ctx.hit)

    g = jax.jit(shard_map(f, mesh=mesh1, in_specs=(P(AXES, None), P(AXES, None)) + (P(),) * 5,
                          out_specs=(P(AXES, None), P(AXES, None)) + (P(),) * 4,
                          check_vma=False))
    exp = [np.asarray(x) for x in g(*map(jnp.asarray, (w, acc, ids, keys, hot, hot_acc, g_u)))]

    tw, tacc, thot, thot_acc = _t(w), _t(acc), _t(hot), _t(hot_acc)
    _, ctx = pe.mp_lookup(tw, _t(ids), world=1, capacity=cap, hot_keys=_t(keys),
                          hot_rows=thot)
    w2, acc2, c2 = pe.apply_sparse_grads(tw, tacc, pe.CacheState(_t(keys), thot, thot_acc),
                                         ctx, _t(g_u), world=1, lr=0.05,
                                         cache_update=cache_update)
    assert w2 is tw and acc2 is tacc and c2.rows is thot  # updated in place
    for got, e in zip((w2, acc2, c2.rows, c2.acc), exp[:4]):
        np.testing.assert_allclose(got.numpy(), e, atol=1e-6, rtol=1e-6)
    assert int(ctx.routing.overflow) == int(exp[4]) > 0
    assert int(ctx.hit.sum()) == int(exp[5]) > 0
    touched = np.unique(ids)
    untouched = np.setdiff1d(np.arange(w.shape[0]), touched)
    np.testing.assert_array_equal(w2.numpy()[untouched], w[untouched])
    if cache_update == "stale":  # the tier is read-only between flushes
        np.testing.assert_array_equal(c2.rows.numpy(), hot)


def test_apply_sparse_grads_rejects_unported_options():
    """World > 1 without a ``dist.Group`` raises ``ValueError``; an unknown
    routed compression mode raises ``ValueError`` and the ported ones are
    taken (``'none'`` bitwise as the default)."""
    w, acc, ids, keys, hot, hot_acc, g_u = _sparse_case()
    _, ctx = pe.mp_lookup(_t(w), _t(ids), world=1, capacity=96)
    with pytest.raises(ValueError, match="grad_compress"):
        pe.apply_sparse_grads(_t(w), _t(acc), None, ctx, _t(g_u), world=1, lr=0.05,
                              compress="bf16")
    with pytest.raises(ValueError, match="world=2 needs a repro_torch.dist.Group"):
        pe.apply_sparse_grads(_t(w), _t(acc), None, ctx, _t(g_u), world=2, lr=0.05)
    ws = {}
    for mode in ("none", "fp16", "topk"):
        ws[mode] = _t(w)
        pe.apply_sparse_grads(ws[mode], _t(acc), None, ctx, _t(g_u), world=1, lr=0.05,
                              compress=mode)
    default = _t(w)
    pe.apply_sparse_grads(default, _t(acc), None, ctx, _t(g_u), world=1, lr=0.05)
    assert torch.equal(ws["none"], default)
    assert not torch.equal(ws["fp16"], default) and not torch.equal(ws["topk"], default)


@pytest.mark.parametrize("name", ["adam", "lamb", "sgd"])
def test_optimizers_match_reference(name):
    rng = np.random.default_rng(4)
    params = {"a": {"w": rng.normal(size=(5, 3)).astype(np.float32)},
              "b": rng.normal(size=(3,)).astype(np.float32)}
    tp, jp = topt.tree_map(_t, params), jax.tree.map(jnp.asarray, params)
    topt_state, jopt_state = topt.adam_init(tp), jopt.adam_init(jp)
    tupd, jupd = topt.OPTIMIZERS[name], getattr(jopt, f"{name}_update")
    for _ in range(3):
        grads = {"a": {"w": rng.normal(size=(5, 3)).astype(np.float32)},
                 "b": rng.normal(size=(3,)).astype(np.float32)}
        tp, topt_state = tupd(tp, topt.tree_map(_t, grads), topt_state, 1e-2)
        jp, jopt_state = jupd(jp, jax.tree.map(jnp.asarray, grads), jopt_state, 1e-2)
    for a, b in zip(topt.tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)
    if name != "sgd":
        assert topt_state["t"].dtype == torch.int32 and int(topt_state["t"]) == 3


def test_loss_matches_reference():
    jcfg, cfg = jget_config("deepfm", smoke=True), get_config("deepfm", smoke=True)
    jplan, plan = jmake_plan(jcfg, 1, 16), make_plan(cfg, 1, 16)
    jmodel, model = JWDLModel(jcfg, jplan), WDLModel(cfg, plan)
    dense = jax.device_get(jmodel.init_dense(jax.random.PRNGKey(1)))
    g = plan.groups[0]
    rng = np.random.default_rng(2)
    pooled = {g.gid: (rng.normal(size=(16, g.n_bags, g.dim)) * 3).astype(np.float32)}
    labels = rng.integers(0, 2, 16).astype(np.float32)
    jl, jlog = jmodel.loss(dense, {k: jnp.asarray(v) for k, v in pooled.items()},
                           {"labels": jnp.asarray(labels)})
    tl, tlog = model.loss(topt.tree_map(_t, dense), {k: _t(v) for k, v in pooled.items()},
                          {"labels": _t(labels)})
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_loss_gradient_at_zero_logits_matches_reference():
    """Every logit exactly 0 (zero dense parameters and pooled vectors, as
    a sample whose every hidden unit is dead gets): the loss and every
    dense gradient equal the reference's, whose ``jnp.maximum`` splits the
    gradient at 0 and whose ``jnp.abs`` takes its positive branch there.
    The port's ``clamp`` and ``abs`` gave the output bias 1 - y a sample
    where the reference gives -y (found under ``PYTHONHASHSEED=28``)."""
    jcfg, cfg = jget_config("deepfm", smoke=True), get_config("deepfm", smoke=True)
    jplan, plan = jmake_plan(jcfg, 1, 16), make_plan(cfg, 1, 16)
    jmodel, model = JWDLModel(jcfg, jplan), WDLModel(cfg, plan)
    dense = jax.tree.map(np.zeros_like,
                         jax.device_get(jmodel.init_dense(jax.random.PRNGKey(1))))
    g = plan.groups[0]
    pooled = {g.gid: np.zeros((16, g.n_bags, g.dim), np.float32)}
    labels = (np.arange(16) % 3 == 0).astype(np.float32)
    (jl, jlog), jgrad = jax.value_and_grad(
        lambda d: jmodel.loss(d, {k: jnp.asarray(v) for k, v in pooled.items()},
                              {"labels": jnp.asarray(labels)}), has_aux=True)(
        jax.tree.map(jnp.asarray, dense))
    leaves = [_t(x).requires_grad_(True) for x in jax.tree.leaves(dense)]
    params = topt.tree_unflatten(topt.tree_map(_t, dense), leaves)
    tl, tlog = model.loss(params, {k: _t(v) for k, v in pooled.items()},
                          {"labels": _t(labels)})
    assert not tlog.detach().abs().max() and not np.abs(np.asarray(jlog)).max()
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for a, b in zip(grads, jax.tree.leaves(jgrad)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)
    bias = jgrad["top"][f"l{len(jgrad['top']) - 1}"]["b"]
    np.testing.assert_allclose(np.asarray(bias), [-labels.sum()], rtol=1e-6)


def test_batch_stream_seeks_like_reference():
    jcfg, cfg = jget_config("deepfm", smoke=True), get_config("deepfm", smoke=True)
    jit_, it = jbatch_stream(jcfg, 8, seed=3, start=5), batch_stream(cfg, 8, seed=3, start=5)
    for _ in range(2):
        jb, b = next(jit_), next(it)
        np.testing.assert_array_equal(b["labels"], jb["labels"])
        for f in cfg.fields:
            np.testing.assert_array_equal(b["fields"][f.name]["ids"],
                                          jb["fields"][f.name]["ids"])
    # a replayable prefetched stream rewinds to the exact batch
    s = ReplayableStream(lambda start: Prefetcher(batch_stream(cfg, 8, seed=3, start=start),
                                                  depth=2))
    first = [next(s)["labels"] for _ in range(3)]
    s.seek(1)
    np.testing.assert_array_equal(next(s)["labels"], first[1])
    assert s.pos == 2
    s.close()


@pytest.mark.parametrize("field,value", [("grad_compression", "bf16"),
                                         ("grad_compress", "fp16"), ("pin_l2", True)])
def test_train_config_raises_on_unported_fields(field, value, mesh1):
    """Every field is ported now (the test keeps its name). ``pin_l2`` is
    accepted, and the leaves it places are the reference's
    ``emb_shardings(pin_l2=True)``'s; the compression fields take each of
    their modes and raise ``ValueError`` on an unknown one."""
    if field == "pin_l2":
        from repro_torch.embedding.state import pinned_leaves
        from test_torch_pin import _plan_pair, reference_pinned_leaves

        assert TrainConfig(**{field: value}).pin_l2 is True
        for case in ("picasso_l2", "picasso_narrow"):
            jplan, plan = _plan_pair(case)
            assert pinned_leaves(plan) == reference_pinned_leaves(jplan, mesh1) != {}
        return
    modes = {"grad_compression": ("none", "bf16", "fp16", "f8"),
             "grad_compress": ("none", "fp16", "topk")}[field]
    assert value in modes
    for mode in modes:
        assert getattr(TrainConfig(**{field: mode}), field) == mode
    for bad in ("int4", "topk" if field == "grad_compression" else "bf16"):
        with pytest.raises(ValueError, match=field):
            TrainConfig(**{field: bad})


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_train_launcher_runs_smoke_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "deepfm", "--smoke",
         "--device", "cpu", "--steps", "3", "--global-batch", "32", "--log-every", "1"],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    steps = re.findall(r"^  step +(\d+) loss=([\d.]+) hits=(\d+) ovf=(\d+)$", out.stdout,
                       re.M)
    assert [int(s[0]) for s in steps] == [1, 2, 3], out.stdout
    assert all(np.isfinite(float(s[1])) for s in steps)
    assert out.stdout.rstrip().endswith("[train] done")


def test_train_launcher_help_lists_flags(capsys):
    with pytest.raises(SystemExit) as exc:
        train_launcher.main(["--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--arch", "--smoke", "--steps", "--global-batch", "--strategy",
                 "--fused-kernels", "--no-cache", "--no-interleave", "--n-micro",
                 "--learnable", "--log-every", "--lr-emb", "--lr-dense", "--seed",
                 "--device", "--grad-compress", "--no-packing", "--overlap"):
        assert flag in out


def test_train_launcher_without_cuda_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_launcher.main(["--smoke", "--steps", "1"])
    out = capsys.readouterr().out
    assert "step" not in out and "[train] done" not in out
