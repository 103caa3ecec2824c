"""The port's fault-tolerance runtime against the reference on the CPU:
``runtime.guard``, ``runtime.chaos``, ``runtime.stream`` and
``train.fault_tolerance``, case by case after ``tests/test_faults.py``.

- the guard: events (step, kind, consecutive count, threshold) equal the
  reference's on the same NaN and spike inputs; a guarded clean run is
  bitwise the unguarded run; a rejected step leaves every leaf of the state
  bitwise as it was, over every strategy name and ``mixed``, ``n_micro`` 1-3,
  ``cache_update`` ``psum``/``stale`` and ``grad_compress`` ``fp16``/``topk``
  (deepfm-smoke, a tier flushed before the poisoned step so its rows take
  hit gradients);
- the supervisor, checkpoint corruption, publish/serve and streaming cases
  of the reference, on toy steps and on deepfm-smoke: a guarded chaos run
  ends bitwise at the clean run's state, and rejects and restores at the
  same steps as the reference's same chaos run, its state within the PR 12
  bars;
- a restore or reload under other packing salts raises, shown by writing
  under one ``PYTHONHASHSEED`` and loading under another in subprocesses.
"""
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.packing import make_plan as jmake_plan
from repro.data.pipeline import ReplayableStream as JReplayableStream
from repro.data.synthetic import batch_stream as jbatch_stream
from repro.dist.sharding import batch_specs, to_named
from repro.models.wdl import WDLModel as JWDLModel
from repro.runtime.chaos import ChaosController as JChaosController
from repro.runtime.chaos import FaultPlan as JFaultPlan
from repro.runtime.guard import AnomalyGuard as JAnomalyGuard
from repro.runtime.guard import GuardConfig as JGuardConfig
from repro.train.fault_tolerance import Supervisor as JSupervisor
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import init_state as jinit_state
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_jax
from repro_torch.core.assign import apply_assignment
from repro_torch.core.packing import make_plan
from repro_torch.data.pipeline import ReplayableStream
from repro_torch.data.synthetic import batch_stream, make_batch
from repro_torch.engine import resolve_assignment
from repro_torch.models.wdl import WDLModel
from repro_torch.runtime.chaos import (ChaosController, ChaosFailure, ChaosStream,
                                       FaultPlan, corrupt_checkpoint_file, parse_fault_plan,
                                       poison_batch, tear_published)
from repro_torch.runtime.guard import AnomalyGuard, AnomalyRollback, GuardConfig
from repro_torch.runtime.stream import (PublishPoller, load_published, poll_published,
                                        publish_state, run_stream)
from repro_torch.train import checkpoint as ck
from repro_torch.train.checkpoint import (AsyncCheckpointer, CheckpointCorrupt,
                                          available_steps, latest_step, restore_checkpoint,
                                          restore_verified, save_checkpoint)
from repro_torch.train.fault_tolerance import Supervisor, classify_failure
from repro_torch.train.train_step import TrainConfig, init_state, make_train_step
from test_torch_serve import ROOT, _env
from test_torch_train import _check_state

torch.set_num_threads(1)

AXES = ("data", "model")
GB = 48  # divisible by every n_micro of the guard matrix


def _leaves(state):
    return sorted(ck._flatten(state).items())


def _snapshot(state):
    return [(k, v.clone() if isinstance(v, torch.Tensor) else v) for k, v in _leaves(state)]


def _assert_bitwise(a, b):
    la, lb = (x if isinstance(x, list) else _leaves(x) for x in (a, b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert x == y, k


# ------------------------------------------------------- toy guarded loop
# a step with a controllable gradient norm, functional like the reference's


def _toy_step():
    def raw(state, batch):
        x = torch.as_tensor(batch["x"])
        g = x.mean() * torch.ones_like(state["w"])
        new = {"w": state["w"] - 0.1 * g, "step": state["step"] + 1}
        return new, {"loss": x.mean() ** 2, "grad_norm": torch.sqrt(torch.vdot(g, g))}
    return raw


def _jtoy_step():
    def raw(state, batch):
        g = jnp.mean(batch["x"]) * jnp.ones_like(state["w"])
        new = {"w": state["w"] - 0.1 * g, "step": state["step"] + 1}
        return new, {"loss": jnp.mean(batch["x"]) ** 2,
                     "grad_norm": jnp.sqrt(jnp.vdot(g, g))}
    return jax.jit(raw)


def _toy_state():
    return {"w": torch.ones((3,), dtype=torch.float32), "step": 0}


def _toy_x(i, poison=False):
    v = float("nan") if poison else 0.1 + 0.01 * (i % 7)
    return np.full((4,), v, np.float32)


def _toy_batch(i, poison=False):
    return {"x": _toy_x(i, poison)}


def _toy_stream(n=10_000, poison_at=()):
    def make(start):
        def gen():
            i = start
            while i < n:
                yield _toy_batch(i, poison=i in poison_at)
                i += 1
        return gen()
    return ReplayableStream(make)


# ------------------------------------------------------------ anomaly guard


def test_guard_events_match_reference():
    """The same loss/grad-norm sequence (warm-up, NaN, a spike, a rollback
    streak) through both guards: the same events, counters, threshold and
    EMA, and a rollback at the same call."""
    xs = ([_toy_x(i) for i in range(6)] + [_toy_x(0, poison=True)]
          + [np.full((4,), 1e6, np.float32)] + [_toy_x(7), _toy_x(8)]
          + [_toy_x(0, poison=True)] * 3 + [_toy_x(9)])
    cfg = dict(warmup_steps=3, spike_factor=10.0, k_rollback=3)
    sides = []
    for guard, step, state, batch in (
            (AnomalyGuard(_toy_step(), GuardConfig(**cfg)), None, _toy_state(),
             lambda x: {"x": x}),
            (JAnomalyGuard(_jtoy_step(), JGuardConfig(**cfg)), None,
             {"w": jnp.ones((3,), jnp.float32), "step": jnp.int32(0)},
             lambda x: {"x": jnp.asarray(x)})):
        flags, rollbacks = [], []
        for i, x in enumerate(xs):
            try:
                state, m = guard(state, batch(x))
                flags.append(int(m["anomalous"]))
            except Exception as e:  # noqa: BLE001 — the rollback is the case
                rollbacks.append((i, type(e).__name__, e.rejects))
                flags.append(-1)
        ev = [(e.step, e.kind, e.consecutive) for e in guard.events]
        thr = [e.threshold for e in guard.events]
        sides.append((flags, rollbacks, ev, thr, guard.accepted, guard.rejected, guard.ema,
                      np.asarray(state["w"])))
    (pf, pr, pe, pt, pa, prj, pema, pw), (jf, jr, je, jt, ja, jrj, jema, jw) = sides
    assert pf == jf and pe == je and (pa, prj) == (ja, jrj)
    assert pr == jr and pr and pr[0][1] == "AnomalyRollback"
    assert {k for _, k, _ in pe} == {"nonfinite", "spike"}
    np.testing.assert_allclose(pt, jt, rtol=1e-6)
    np.testing.assert_allclose(pema, jema, rtol=1e-6)
    np.testing.assert_allclose(pw, jw, rtol=1e-6)


def test_guard_spike_rejection_and_threshold():
    guard = AnomalyGuard(_toy_step(), GuardConfig(warmup_steps=3, spike_factor=10.0,
                                                  k_rollback=99))
    s = _toy_state()
    for i in range(5):
        s, m = guard(s, _toy_batch(i))
    assert guard.threshold > 0
    before = s["w"].clone()
    s, m = guard(s, {"x": np.full((4,), 1e6, np.float32)})
    assert bool(m["anomalous"])
    assert torch.equal(s["w"], before)
    assert guard.events[-1].kind == "spike"
    s, m = guard(s, _toy_batch(9))
    assert not bool(m["anomalous"]) and guard.consecutive == 0


def test_guard_rollback_after_k_carries_state():
    guard = AnomalyGuard(_toy_step(), GuardConfig(k_rollback=3))
    s = _toy_state()
    for i in range(4):
        s, _ = guard(s, _toy_batch(i))
    w_ok = s["w"].clone()
    with pytest.raises(AnomalyRollback) as ei:
        for _ in range(3):
            s, _ = guard(s, _toy_batch(0, poison=True))
    assert torch.equal(ei.value.state["w"], w_ok)
    assert ei.value.rejects == 3
    assert classify_failure(ei.value) == "transient"


def test_guard_rebind_keeps_history_and_judges_any_train_step():
    guard = AnomalyGuard(_toy_step(), GuardConfig(warmup_steps=2))
    s = _toy_state()
    for i in range(4):
        s, _ = guard(s, _toy_batch(i))
    ema = guard.ema
    guard.rebind(_toy_step())  # e.g. after a replan rebuild
    assert guard.ema == ema and guard.accepted == 4
    s, m = guard(s, _toy_batch(4))
    assert not bool(m["anomalous"])
    cfg, plan, model = _smoke("picasso", 1, "psum", "none")
    # donate is the reference's signature: either way the port's step
    # journals exactly while a judge is bound
    for donate in (True, False):
        step = make_train_step(model, plan, GB, TrainConfig(), "cpu", donate=donate)
        assert step.judge is None
        assert guard.rebind(step) is guard and step.judge is not None


def test_guard_rollback_on_a_journaled_step_carries_the_restored_state():
    """Three poisoned deepfm-smoke batches through a guarded train step: the
    third raises ``AnomalyRollback`` carrying the state, which is bitwise
    the state before the first of them."""
    cfg, plan, model = _smoke("picasso", 1, "psum", "none")
    state = init_state(model, plan, torch.Generator().manual_seed(0), "cpu")
    guard = AnomalyGuard(make_train_step(model, plan, GB, TrainConfig(), "cpu"), GuardConfig(k_rollback=3))
    rng = np.random.default_rng(4)
    for _ in range(3):
        state, _ = guard(state, make_batch(cfg, GB, rng))
    before = _snapshot(state)
    with pytest.raises(AnomalyRollback) as ei:
        for _ in range(3):
            state, _ = guard(state, poison_batch(make_batch(cfg, GB, rng)))
    _assert_bitwise(before, ei.value.state)
    assert [e.consecutive for e in guard.events] == [1, 2, 3]


# ---------------------------------------------------- the rejection matrix

STRATEGIES = ("picasso", "hybrid", "ps", "picasso_l2", "picasso_narrow", "mp_nodedup",
              "allgather_rows", "mixed")
_MIX = ("picasso", "ps", "picasso_l2", "allgather_rows", "hybrid", "mp_nodedup")


def _smoke(strategy, n_micro, cache_update, grad_compress):
    cfg = get_config("deepfm", smoke=True)
    kw = dict(hot_bytes=1 << 12, l2_bytes=1 << 16, flush_iters=2, warmup_iters=1,
              n_micro=n_micro)
    if strategy == "picasso_narrow":
        kw["narrow_dim"] = 4
    if strategy in ("mp_nodedup", "mixed"):
        kw["exact_capacity"] = True
    if strategy == "mixed":
        kw["enable_packing"] = False
    plan = make_plan(cfg, 1, GB, **kw)
    if strategy == "mixed":  # one group a table, six strategy classes in turn
        apply_assignment(plan, {g.gid: _MIX[i % len(_MIX)]
                                for i, g in enumerate(plan.groups)})
    else:
        resolve_assignment(plan, strategy)
    return cfg, plan, WDLModel(cfg, plan)


@pytest.mark.parametrize("grad_compress", ["fp16", "topk"])
@pytest.mark.parametrize("cache_update", ["psum", "stale"])
@pytest.mark.parametrize("n_micro", [1, 2, 3])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_rejected_step_leaves_every_leaf_bitwise(strategy, n_micro, cache_update,
                                                 grad_compress):
    """Two clean steps (the step-2 flush fills the tiers), a poisoned step,
    a clean step: the poisoned step is rejected with every leaf bitwise as
    before it, and the guarded run ends bitwise at the unguarded run over
    the clean batches."""
    cfg, plan, model = _smoke(strategy, n_micro, cache_update, grad_compress)
    tcfg = TrainConfig(strategy="mixed" if plan.strategy else strategy,
                       cache_update=cache_update, grad_compress=grad_compress)
    plain = make_train_step(model, plan, GB, tcfg, "cpu")
    guard = AnomalyGuard(make_train_step(model, plan, GB, tcfg, "cpu"))
    assert plain.n_micro == n_micro
    rng = np.random.default_rng(5)
    batches = [make_batch(cfg, GB, rng) for _ in range(3)]
    sa = init_state(model, plan, torch.Generator().manual_seed(0), "cpu")
    sb = init_state(model, plan, torch.Generator().manual_seed(0), "cpu")
    for b in batches:
        sa, _ = plain(sa, b)
    hits = []
    for i, b in enumerate(batches[:2]):
        sb, m = guard(sb, b)
        assert m["anomalous"] == 0
    before = _snapshot(sb)
    sb, m = guard(sb, poison_batch(batches[2]))
    assert m["anomalous"] == 1 and m["rejected"] and not np.isfinite(float(m["loss"]))
    hits.append(int(m["cache_hits"]))
    _assert_bitwise(before, sb)
    sb, m = guard(sb, batches[2])
    assert m["anomalous"] == 0 and guard.rejected == 1 and guard.accepted == 3
    _assert_bitwise(sa, sb)
    if plain.engine.any_cache and cache_update == "psum":
        assert hits[0] > 0  # the rejected step wrote tier rows and restored them


def test_guarded_clean_run_is_bitwise_the_unguarded_run():
    cfg, plan, model = _smoke("picasso_l2", 2, "psum", "none")
    tcfg = TrainConfig(strategy="picasso_l2")
    plain = make_train_step(model, plan, GB, tcfg, "cpu")
    guard = AnomalyGuard(make_train_step(model, plan, GB, tcfg, "cpu"))
    sa = init_state(model, plan, torch.Generator().manual_seed(0), "cpu")
    sb = init_state(model, plan, torch.Generator().manual_seed(0), "cpu")
    for b in [b for _, b in zip(range(6), batch_stream(cfg, GB, seed=3))]:
        sa, ma = plain(sa, b)
        sb, mb = guard(sb, b)
        assert mb["anomalous"] == 0 and float(ma["loss"]) == float(mb["loss"])
    _assert_bitwise(sa, sb)
    assert guard.accepted == 6 and guard.rejected == 0


# ------------------------------------------- supervisor rollback exactness


def test_supervisor_rollback_replay_exact(tmp_path):
    def run(poison):
        guard = AnomalyGuard(_toy_step(), GuardConfig(k_rollback=3))
        stream = _toy_stream()
        if poison:
            stream = ChaosStream(stream, frozenset({5, 6, 7}))
        d = tmp_path / ("faulty" if poison else "clean")
        sup = Supervisor(str(d), ckpt_every=5, max_retries=3, backoff_s=0.0)
        out = sup.run(_toy_state(), guard, stream, n_steps=12)
        sup.ckpt.wait()
        return out, sup, guard

    clean, _, _ = run(poison=False)
    faulty, sup, guard = run(poison=True)
    _assert_bitwise(clean, faulty)
    assert guard.rejected == 3
    assert sup.total_failures == 1


def test_supervisor_restores_through_corrupt_checkpoint(tmp_path):
    def run(chaos):
        stream = _toy_stream()
        d = tmp_path / ("faulty" if chaos else "clean")
        sup = Supervisor(str(d), ckpt_every=2, max_retries=3, backoff_s=0.0)
        fired = set()

        def inject(i):
            if chaos and i == 7 and "crash" not in fired:
                fired.add("crash")
                sup.ckpt.wait()
                corrupt_checkpoint_file(str(d))
                raise ChaosFailure("injected crash at step 7")

        out = sup.run(_toy_state(), _toy_step(), stream, n_steps=12, fail_injector=inject)
        sup.ckpt.wait()
        return out, sup, d

    clean, _, _ = run(chaos=False)
    faulty, sup, d = run(chaos=True)
    _assert_bitwise(clean, faulty)
    assert list(d.glob("step_*.corrupt"))
    assert sup.total_failures == 1


def test_supervisor_failure_counter_resets_on_progress(tmp_path):
    sup = Supervisor(str(tmp_path), ckpt_every=2, max_retries=2, reset_after=4,
                     backoff_s=0.0)
    fired = set()

    def inject(i):
        if i in (3, 9, 15) and i not in fired:
            fired.add(i)
            raise ChaosFailure(f"fault at {i}")

    out = sup.run(_toy_state(), _toy_step(), _toy_stream(), n_steps=20,
                  fail_injector=inject)
    assert out["step"] == 20
    assert sup.total_failures == 3
    assert sup.failures <= 1


@pytest.mark.parametrize("exc,kind", [
    (TypeError("deterministic bug"), "fatal"),
    (ChaosFailure("node loss"), "transient"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), "fatal"),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), "transient"),
    (OSError("disk hiccup"), "transient"),
])
def test_failure_classification(exc, kind):
    """The reference's classes, plus the card's: a sticky CUDA error is
    fatal, an out-of-memory transient."""
    assert classify_failure(exc) == kind
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None:
        assert classify_failure(accel.__new__(accel)) == "fatal"


def test_supervisor_fatal_classification_short_circuits(tmp_path):
    sup = Supervisor(str(tmp_path), ckpt_every=2, max_retries=3, backoff_s=0.0)

    def inject(i):
        if i == 3:
            raise TypeError("deterministic bug")

    with pytest.raises(TypeError):
        sup.run(_toy_state(), _toy_step(), _toy_stream(), n_steps=10, fail_injector=inject)
    assert sup.total_failures == 0


# --------------------------------------------------- checkpoint corruption


def test_corrupt_checkpoint_quarantine_and_fallback(tmp_path):
    d = str(tmp_path)
    s4 = {"w": torch.arange(4, dtype=torch.float32)}
    s8 = {"w": torch.arange(4, dtype=torch.float32) * 2}
    save_checkpoint(d, 4, s4)
    save_checkpoint(d, 8, s8)
    corrupt_checkpoint_file(d)  # tears the newest (step 8)
    with pytest.raises(CheckpointCorrupt):
        restore_checkpoint(d, {"w": torch.zeros(4)}, step=8)
    tmpl = {"w": torch.full((4,), -1.0)}
    state, step = restore_verified(d, tmpl)
    assert step == 4 and torch.equal(state["w"], s4["w"])
    assert (tmp_path / "step_00000008.corrupt").exists()
    assert latest_step(d) == 4
    assert available_steps(d) == [4]


def test_corrupt_checkpoint_never_touches_the_template(tmp_path):
    """Every leaf is verified before any is read: a checkpoint whose second
    leaf is torn leaves the template's first leaf as it was."""
    d = str(tmp_path)
    save_checkpoint(d, 2, {"a": torch.ones(4), "b": torch.ones(4)})
    f = tmp_path / "step_00000002" / sorted(
        p.name for p in (tmp_path / "step_00000002").iterdir() if p.name.startswith("b"))[0]
    f.write_bytes(f.read_bytes()[:10])
    tmpl = {"a": torch.zeros(4), "b": torch.zeros(4)}
    with pytest.raises(CheckpointCorrupt):
        restore_checkpoint(d, tmpl)
    assert torch.equal(tmpl["a"], torch.zeros(4))


def test_short_leaf_refused_before_any_write_unverified(tmp_path, monkeypatch):
    """Without the crc pass, a plain leaf whose file is shorter than its
    header says is still refused before the template's first leaf is
    written."""
    monkeypatch.setattr(ck, "zstandard", None)
    d = str(tmp_path)
    save_checkpoint(d, 2, {"a": torch.ones(4), "b": torch.ones(4)})
    f = tmp_path / "step_00000002" / "b.npy"
    f.write_bytes(f.read_bytes()[:-4])
    tmpl = {"a": torch.zeros(4), "b": torch.zeros(4)}
    with pytest.raises(CheckpointCorrupt, match="header says"):
        restore_checkpoint(d, tmpl, verify=False)
    assert torch.equal(tmpl["a"], torch.zeros(4))


def test_restore_verified_exhausted_raises(tmp_path):
    d = str(tmp_path)
    s = {"w": torch.ones(3)}
    save_checkpoint(d, 2, s)
    corrupt_checkpoint_file(d)
    with pytest.raises(FileNotFoundError):
        restore_verified(d, s)
    assert (tmp_path / "step_00000002.corrupt").exists()


# ------------------------------------------------------ publish/serve side


def _pub_state(k=1.0):
    return {"emb": {"t": torch.full((4, 2), k)}, "dense": {"w": torch.full((3,), k)}}


def test_poll_published_pruned_latest_falls_back(tmp_path):
    d = str(tmp_path)
    publish_state(d, 10, _pub_state(1.0), keep=2)
    publish_state(d, 20, _pub_state(2.0), keep=2)
    (tmp_path / "LATEST").write_text("99\n")
    assert poll_published(d) == 20
    (tmp_path / "LATEST").write_text("not-a-step\n")
    assert poll_published(d) == 20
    assert poll_published(d, last_step=20) is None


def test_publish_poller_survives_torn_delta(tmp_path):
    d = str(tmp_path)
    template = _pub_state(0.0)
    poller = PublishPoller(d, max_backoff=4)
    assert poller.poll(template) is None

    publish_state(d, 10, _pub_state(1.0), keep=3)
    out = poller.poll(template)
    assert out is not None and out[1] == 10

    publish_state(d, 20, _pub_state(2.0), keep=3)
    tear_published(d)
    assert poller.poll(template) is None
    assert poller.last_step == 10 and poller.failures == 1
    assert poller.skips_left > 0
    # the torn delta never reached the served tensors
    assert torch.equal(template["dense"]["w"], torch.full((3,), 1.0))

    publish_state(d, 30, _pub_state(3.0), keep=3)
    got = None
    for _ in range(6):
        got = poller.poll(template)
        if got is not None:
            break
    assert got is not None and got[1] == 30
    assert torch.equal(got[0]["dense"]["w"], torch.full((3,), 3.0))
    assert poller.failures == 0


def test_load_published_survives_pruning_mid_load(tmp_path, monkeypatch):
    """The publisher's keep= GC removing the step directory while a load is
    under way (after the checks, before the leaves are copied) does not
    leave the served state a mix of two deltas: the files are held open
    from the checks to the copies, so the delta loads whole."""
    import shutil

    d = str(tmp_path)
    publish_state(d, 10, _pub_state(1.0), keep=2)
    template = _pub_state(0.0)
    pub = _pub_state(1.0)
    real = ck._read_into
    pruned = []

    def prune_then_read(*a, **k):
        if not pruned:
            shutil.rmtree(tmp_path / "step_00000010")
            pruned.append(True)
        return real(*a, **k)

    monkeypatch.setattr(ck, "_read_into", prune_then_read)
    state, s = load_published(d, template)
    assert pruned and not (tmp_path / "step_00000010").exists()
    assert s == 10
    for (k, got), (_, want) in zip(_leaves(state), _leaves(pub)):
        assert torch.equal(got, want), k
    for (k, got), (_, want) in zip(_leaves(template), _leaves(pub)):
        assert torch.equal(got, want), k


def test_mis_shaped_delta_leaves_served_state_unchanged(tmp_path):
    """A delta whose rows differ from the server's only in a row-sharded
    leaf (another world) is recut onto the server's plan; one whose other
    leaves differ too (another plan revision) raises before any leaf is
    written, though leaves ahead of it match, and without a plan any row
    mismatch raises: the poller keeps serving its last good state bitwise."""
    from repro_torch.core.packed_embedding import CacheState
    from repro_torch.core.packing import make_plan, reshard_plan
    from repro_torch.embedding.state import EmbeddingState

    d = str(tmp_path)
    plan = make_plan(get_config("deepfm", smoke=True), world=1, per_device_batch=8,
                     hot_bytes=1 << 12)
    rows, dim = plan.groups[0].rows, plan.groups[0].dim
    h = plan.cache_rows[0]

    def served(r, fill, keys=h):
        return {"emb": {"0": EmbeddingState(
            w=torch.full((r, dim), fill), acc=torch.full((r, 1), fill),
            counts=torch.zeros((r,), dtype=torch.int32),
            cache=CacheState(torch.full((keys,), r, dtype=torch.int32),
                             torch.full((keys, dim), fill), torch.full((keys, 1), fill)))},
                "dense": {"w": torch.full((3,), fill)}}

    template = served(rows, 0.5)
    before = _snapshot(template)
    four = reshard_plan(plan, 4, 2)
    publish_state(d, 10, served(four.groups[0].rows, 2.0))      # another world
    got, s = load_published(d, template, plan=plan)
    assert s == 10 and got["emb"]["0"].w.shape == (rows, dim)
    assert bool((got["emb"]["0"].w == 2.0).all()) and bool((got["dense"]["w"] == 2.0).all())
    assert bool((got["emb"]["0"].cache.keys == rows).all())    # the sentinel remapped
    with pytest.raises(ValueError, match="different world size"):
        load_published(d, served(rows, 0.5))
    template = served(rows, 0.5)
    publish_state(d, 20, served(four.groups[0].rows, 3.0, keys=h + 8))  # another revision
    for p in (plan, None):
        with pytest.raises(ValueError, match="another plan revision|different world size"):
            load_published(d, template, plan=p)
    poller = PublishPoller(d, plan=plan)
    assert poller.poll(template) is None and poller.failures == 1
    for (k, got_), (_, want) in zip(_leaves(template), before):
        assert torch.equal(got_, want), k


def test_publish_poller_raises_on_other_salts(tmp_path):
    """A delta packed under other salts is no transient fault: the poller
    raises instead of skipping it."""
    d = str(tmp_path)
    publish_state(d, 10, _pub_state(1.0), salts={"cat_0": -1})
    with pytest.raises(ck.SaltMismatch, match="PYTHONHASHSEED"):
        PublishPoller(d).poll(_pub_state(0.0))
    with pytest.raises(ck.SaltMismatch, match="PYTHONHASHSEED"):
        load_published(d, _pub_state(0.0))


# ------------------------------------------------------------- stream mode


def test_stream_crash_mid_segment_resumes_exact(tmp_path):
    step = _toy_step()
    want, want_last = run_stream(_toy_state(), step, _toy_stream(), segment_steps=5,
                                 n_segments=4, log=lambda s: None)
    assert want_last == 20
    d = str(tmp_path / "ckpt")
    ckpt = AsyncCheckpointer(d)
    chaos = ChaosController(FaultPlan(crash=frozenset({12})))
    stream = _toy_stream()
    with pytest.raises(ChaosFailure):
        run_stream(_toy_state(), step, stream, segment_steps=5, n_segments=4,
                   checkpointer=ckpt, on_metrics=lambda i, m: chaos.injector(i),
                   log=lambda s: None)
    ckpt.wait()
    assert latest_step(d) == 10
    state, start = restore_verified(d, _toy_state())
    stream.seek(start)
    got, last = run_stream(state, step, stream, segment_steps=5, n_segments=2,
                           start_step=start, checkpointer=ckpt, log=lambda s: None)
    ckpt.wait()
    assert last == want_last
    _assert_bitwise(want, got)


# -------------------------------------------------------- chaos primitives


def test_parse_fault_plan():
    p = parse_fault_plan("nan@7,nan@8,crash@13,ckpt@20,torn@45")
    assert p.nan_batch == frozenset({7, 8})
    assert p.crash == frozenset({13})
    assert p.corrupt_ckpt == frozenset({20})
    assert p.torn_publish == frozenset({45})
    assert bool(p) and not bool(FaultPlan())
    with pytest.raises(ValueError):
        parse_fault_plan("explode@3")
    with pytest.raises(ValueError):
        parse_fault_plan("nan@x")


def test_chaos_stream_one_shot_across_seek():
    stream = ChaosStream(_toy_stream(), frozenset({2}))
    got = [next(stream) for _ in range(4)]
    assert np.isnan(got[2]["x"]).all()
    stream.seek(0)
    replay = [next(stream) for _ in range(4)]
    assert not any(np.isnan(b["x"]).any() for b in replay)


def test_poison_batch_nans_labels_and_tensors():
    cfg = get_config("deepfm", smoke=True)
    b = make_batch(cfg, 8, np.random.default_rng(0))
    p = poison_batch(b)
    assert np.isnan(p["labels"]).all() and not np.isnan(b["labels"]).any()
    assert p["fields"] is b["fields"]
    t = poison_batch({"x": torch.ones(3), "i": torch.ones(3, dtype=torch.int32)})
    assert torch.isnan(t["x"]).all() and torch.equal(t["i"], torch.ones(3, dtype=torch.int32))


# ------------------------------------- deepfm-smoke chaos against repro

CHAOS_STEPS = 10
# batches 3 and 4 are rejected (the step-4 checkpoint pins the first skip),
# the step-5 hook tears that checkpoint, and the step-6 crash restores
# through it: the walk quarantines step 4 and falls back to step 2, whose
# replay sees batches 3 and 4 clean (each fault fires once), so the run
# trains on every batch, as the clean run does
CHAOS = dict(nan_batch=frozenset({3, 4}), corrupt_ckpt=frozenset({5}), crash=frozenset({6}))


def _chaos_plans():
    kw = dict(hot_bytes=1 << 14, flush_iters=3, warmup_iters=2)
    return (jmake_plan(jget_config("deepfm", smoke=True), 1, GB, **kw),
            make_plan(get_config("deepfm", smoke=True), 1, GB, **kw))


def _port_chaos_run(d, chaos, jstate0, plan):
    cfg = get_config("deepfm", smoke=True)
    model = WDLModel(cfg, plan)
    guard = AnomalyGuard(make_train_step(model, plan, GB, TrainConfig(), "cpu"))
    state = train_state_from_jax(jstate0, plan, "cpu")
    stream = ReplayableStream(lambda s: batch_stream(cfg, GB, seed=3, start=s))
    sup = Supervisor(str(d), ckpt_every=2, max_retries=3, backoff_s=0.0)
    ctl = ChaosController(FaultPlan(**CHAOS) if chaos else FaultPlan())
    stream = ctl.wrap_stream(stream)

    def on_metrics(i, m):
        ctl.after_checkpoint(i, str(d), sup.ckpt)
        ctl.injector(i)

    out = sup.run(state, guard, stream, CHAOS_STEPS, on_metrics=on_metrics)
    return out, sup, guard


def _jax_chaos_run(d, mesh1, jplan):
    cfg = jget_config("deepfm", smoke=True)
    model = JWDLModel(cfg, jplan)
    step, _ = jmake_train_step(model, jplan, mesh1, AXES, GB,
                               JTrainConfig(use_fused_kernels="off"), donate=False)
    guard = JAnomalyGuard(step)
    state = jinit_state(model, jplan, jax.random.PRNGKey(0), mesh=mesh1, axes=AXES)

    def make(s):
        for b in jbatch_stream(cfg, GB, seed=3, start=s):
            yield jax.device_put(b, to_named(mesh1, batch_specs(b, AXES)))

    sup = JSupervisor(str(d), ckpt_every=2, max_retries=3, backoff_s=0.0)
    ctl = JChaosController(JFaultPlan(**CHAOS))
    stream = ctl.wrap_stream(JReplayableStream(make))

    def on_metrics(i, m):
        ctl.after_checkpoint(i, str(d), sup.ckpt)
        ctl.injector(i)

    out = sup.run(state, guard, stream, CHAOS_STEPS, on_metrics=on_metrics)
    return out, sup, guard


def test_guarded_chaos_run_matches_clean_run_and_reference(mesh1, tmp_path):
    """deepfm-smoke through nan@3,nan@4,ckpt@5,crash@6 under the Supervisor
    (checkpoints every 2 steps) with the guard: the port's run ends bitwise
    at its clean run's state; against the reference's same chaos run it
    rejects the same steps, rolls back as often and quarantines the same
    checkpoints, and its state meets the PR 12 bars."""
    jplan, plan = _chaos_plans()
    jmodel = JWDLModel(jget_config("deepfm", smoke=True), jplan)
    jstate0 = jax.device_get(jinit_state(jmodel, jplan, jax.random.PRNGKey(0), mesh=mesh1,
                                         axes=AXES))
    clean, _, cg = _port_chaos_run(tmp_path / "clean", False, jstate0, plan)
    faulty, sup, guard = _port_chaos_run(tmp_path / "faulty", True, jstate0, plan)
    _assert_bitwise(clean, faulty)
    assert cg.rejected == 0 and faulty["step"] == CHAOS_STEPS
    jout, jsup, jguard = _jax_chaos_run(tmp_path / "ref", mesh1, jplan)
    assert ([(e.step, e.kind, e.consecutive) for e in guard.events]
            == [(e.step, e.kind, e.consecutive) for e in jguard.events])
    assert [e.kind for e in guard.events] == ["nonfinite", "nonfinite"]
    assert (sup.total_failures, guard.accepted) == (jsup.total_failures, jguard.accepted)
    assert (sorted(p.name for p in (tmp_path / "faulty").glob("step_*.corrupt"))
            == sorted(p.name for p in (tmp_path / "ref").glob("step_*.corrupt")))
    assert list((tmp_path / "faulty").glob("step_*.corrupt"))
    _check_state(faulty, jax.device_get(jout))


# ------------------------------------------------- salts across processes


def _launch(args, seed, tmp):
    env = _env(PYTHONHASHSEED=str(seed))
    return subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          timeout=600, env=env, cwd=str(ROOT))


def test_salt_mismatch_raises_across_processes(tmp_path):
    """A trainer under PYTHONHASHSEED=1 checkpoints and publishes; a resume
    and a reload under PYTHONHASHSEED=2 raise the salt error naming
    PYTHONHASHSEED, and under PYTHONHASHSEED=1 both work."""
    ckd, pub = str(tmp_path / "ck"), str(tmp_path / "pub")
    common = ["--arch", "deepfm", "--smoke", "--device", "cpu", "--global-batch", "16",
              "--log-every", "1"]
    out = _launch(["repro_torch.launch.train", *common, "--stream", "--segment-steps", "2",
                   "--stream-segments", "1", "--ckpt-dir", ckd, "--publish-dir", pub],
                  1, tmp_path)
    assert out.returncode == 0, out.stderr
    assert "[stream] published step 2" in out.stdout
    doc = ck._read_manifest(ckd, 2)
    assert len(doc["salts"]) == 39 and "meta" in doc
    serve = ["repro_torch.launch.serve", "--arch", "deepfm", "--smoke", "--device", "cpu",
             "--batch", "16", "--n-requests", "2", "--reload-dir", pub]
    resume = ["repro_torch.launch.train", *common, "--steps", "3", "--ckpt-dir", ckd]
    for args in (serve, resume):
        bad = _launch(args, 2, tmp_path)
        assert bad.returncode != 0
        assert "SaltMismatch" in bad.stderr and "PYTHONHASHSEED" in bad.stderr
    good = _launch(serve + ["--chaos", "torn@1"], 1, tmp_path)
    assert good.returncode == 0, good.stderr
    assert "[serve] reloaded published step 2" in good.stdout
    assert "[serve] chaos: tearing published delta before request 1" in good.stdout
    assert re.findall(r"^\[serve\] request (\d): step (\d+) ", good.stdout, re.M) == [
        ("0", "2"), ("1", "2")]
    good = _launch(resume, 1, tmp_path)
    assert good.returncode == 0, good.stderr
    assert "  step     3 loss=" in good.stdout and "  step     2 " not in good.stdout


def test_train_launcher_supervises_a_chaos_run_on_cpu(tmp_path):
    """``--ckpt-dir --ckpt-every 5 --guard --chaos nan@7,nan@8,crash@13,ckpt@20``
    at smoke width: two rejections, one rollback to step 10, the step-15
    checkpoint torn, and the run finishes."""
    out = _launch(["repro_torch.launch.train", "--arch", "deepfm", "--smoke", "--device",
                   "cpu", "--steps", "22", "--global-batch", "16", "--log-every", "1",
                   "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "5", "--guard",
                   "--chaos", "nan@7,nan@8,crash@13,ckpt@20"], 0, tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("[train] guard: rejected step (nonfinite") == 2
    assert "rolled back to step 10" in out.stderr
    assert "corrupted checkpoint leaf" in out.stderr and "step_00000015" in out.stderr
    assert "[train] guard: 23 accepted, 2 rejected" in out.stdout
    assert out.stdout.rstrip().endswith("[train] done")
    assert latest_step(str(tmp_path / "ck")) == 20


@pytest.mark.parametrize("launcher,flags", [
    ("train", ("--ckpt-dir", "--ckpt-every", "--guard", "--chaos", "--stream",
               "--segment-steps", "--stream-segments", "--publish-dir", "--replan-iters",
               "--replan-hot-bytes", "--replan-l2-bytes")),
    ("serve", ("--reload-dir", "--chaos"))])
def test_launchers_list_the_runtime_flags(launcher, flags, capsys):
    from repro_torch.launch import serve, train
    with pytest.raises(SystemExit) as exc:
        {"train": train, "serve": serve}[launcher].main(["--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert all(f in out for f in flags)
    if launcher == "serve":
        with pytest.raises(SystemExit):
            serve.main(["--chaos", "torn@1"])  # needs --reload-dir
