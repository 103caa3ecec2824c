"""The replanning loop past world 1: 4 gloo ranks against the reference on 4
forced host devices (mesh 2x2), deepfm-smoke.

The reference trains 8 steps at world 4 (global batch 64, a tiny hot tier
flushed at step 3) under a ``Replanner(strategy='auto')`` whose hot envelope
is cut, so its recompile at step 4 migrates the state; it replans again at
step 6. It also runs the cost model's feedback over a few windows of step
times. The port's 4 ranks (one spawn for the module) start every step from
the reference's state before it (each rank its rows):

- ``export_stats`` on every rank is bitwise the reference's harvest on the
  mesh;
- the replan events (revisions, what changed, the window's sums) and the
  final ``plan_meta`` equal the reference's; the migrated state meets the
  training bars of ``tests/test_torch_train.py``, and so does every step,
  the steps at the new revision included; a no-op replan leaves a run
  bitwise the run without it;
- the feedback: with the reference's step times on every rank the measured,
  predicted and correction values are bitwise the reference's; with other
  times on each rank every rank applies one correction, from the median of
  each step's slowest rank;
- a revision that one rank compiles differently, or a window that one rank
  timed differently, raises ``ReplanMismatch`` on every rank (no hang);
- ``migrate_state`` over ``tests/test_torch_replan.py``'s transitions, on a
  seeded world-4 state cut over the ranks: the FCounter and tier keys
  bitwise the reference's, floats within 1e-6 of scale (1e-5 through the
  narrow pseudo-inverse), the replicas bitwise alike across ranks, and every
  rank's cut equal to the port's world-1 migration of the same state.
"""
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.assign import apply_assignment as japply_assignment
from repro.core.assign import resolve_assignment as jresolve_assignment
from repro.core.packed_embedding import CacheState as JCacheState
from repro.core.packed_embedding import ProjState as JProjState
from repro.core.packing import make_plan as jmake_plan
from repro.core.packing import revise_plan as jrevise_plan
from repro.data.synthetic import make_batch as jmake_batch
from repro.embedding.state import EmbeddingState as JEmbeddingState
from repro.embedding.state import migrate_state as jmigrate_state
from repro.runtime import plan_delta as jplan_delta
from test_torch_dist import W, run_port, run_reference
from test_torch_dist_train import _leaves, _ns_state, _rank_state
from test_torch_replan import MIGRATIONS

torch.set_num_threads(1)

GB = 64
STEPS = 8
REPLAN_AT = (4, 6)
PLAN_KW = dict(hot_bytes=1 << 16, flush_iters=3, warmup_iters=2)
HOT_CUT = 1 << 12  # the replanner's hot envelope: the step-4 recompile shrinks L1
MIG_GB = 32        # the migration cases' plans (tests/test_torch_replan.py's batch)
MIG_KW = dict(hot_bytes=1 << 14, l2_bytes=1 << 16, flush_iters=5, warmup_iters=2)
SLOPES = {"wire_a2a": 2e-3, "gather_pool": 5e-4}
WINDOWS = ((900.0, 1400.0, 1100.0), (), (5.0e4, 700.0))

REF_BODY = """
from repro.configs import get_config
from repro.core.packing import make_plan
from repro.dist.sharding import batch_specs, to_named
from repro.engine.engine import export_stats
from repro.models.wdl import WDLModel
from repro.perf import synthetic_cost_model
from repro.runtime import Replanner, plan_meta
from repro.train.train_step import TrainConfig, init_state, make_train_step
GB = inp["GB"]


def np_emb(emb):
    def tier(t):
        return None if t is None else tuple(np.asarray(x) for x in t)
    return {k: {"w": np.asarray(s.w), "acc": np.asarray(s.acc),
                "counts": np.asarray(s.counts), "cache": tier(s.cache), "l2": tier(s.l2),
                "proj": tier(s.proj)} for k, s in emb.items()}


def np_train(st):
    st = jax.device_get(st)
    return {"emb": np_emb(st["emb"]), "dense": st["dense"], "opt": st["opt"],
            "step": np.asarray(st["step"])}


cfg = get_config("deepfm", smoke=True)
put = lambda b: jax.device_put(b, to_named(mesh, batch_specs(b, AXES)))


def new_plan():
    return make_plan(cfg, W, GB // W, mesh_shape=(2, 2), **inp["plan_kw"])


def step_for(p):
    return make_train_step(WDLModel(cfg, p), p, mesh, AXES, GB,
                           TrainConfig(strategy="mixed", use_fused_kernels="off"),
                           donate=False)[0]


plan = new_plan()
rp = Replanner(plan, mesh, AXES, strategy="auto", hot_bytes=inp["hot_cut"])
out["strategy0"] = dict(plan.strategy)
state = init_state(WDLModel(cfg, plan), plan, jax.random.PRNGKey(0), mesh=mesh, axes=AXES)
step = step_for(plan)
out["states"], out["mets"], out["stats"], out["migrated"] = [np_train(state)], [], {}, {}
for i, b in enumerate(inp["batches"], 1):
    state, m = step(state, put(b))
    out["mets"].append({k: np.asarray(v) for k, v in m.items()})
    out["states"].append(np_train(state))
    rp.observe(m)
    if i in inp["replan_at"]:
        out["stats"][i] = {g: np.asarray(c) for g, c in export_stats(plan, state["emb"]).items()}
        res = rp.maybe_replan(state, step=i)
        if res is not None:
            plan, state = res
            step = step_for(plan)
            out["migrated"][i] = np_train(state)
out["events"] = [(e.step, e.old_rev, e.new_rev, e.changed, e.window) for e in rp.events]
out["meta"] = plan_meta(plan)

fplan = new_plan()
jm = synthetic_cost_model(inp["slopes"], fixed_us=3.0)
frp = Replanner(fplan, mesh, AXES, strategy="auto", cost_model=jm, rebudget=False)
out["feedback"] = []
for window in inp["windows"]:
    for t in window:
        frp.observe_timing(t)
    out["feedback"].append(frp._feedback(inp["fstats"]))
out["correction"] = jm.correction
"""


# ---------------------------------------------------------------- helpers
def _plan4(cfg_fn, make, **kw):
    return make(cfg_fn("deepfm", smoke=True), W, GB // W, mesh_shape=(2, 2), **kw)


def _fstats(plan):
    rng = np.random.default_rng(4)
    return {g.gid: rng.integers(0, 9, g.rows).astype(np.int64) for g in plan.groups}


def _synth_state(plan, seed):
    """A seeded world-4 state in numpy (``{gid: dict of leaves}``): a master
    at the plan's width, adagrad slots, an FCounter with ties and zeros over
    the live rows (the padding rows 0), and replicated tiers holding
    distinct live rows (L1 and L2 disjoint) at rows other than the
    master's, so a write-back shows."""
    from repro_torch.embedding.state import _np_proj_kernel

    rng = np.random.default_rng(seed)
    out = {}
    for g in plan.groups:
        nd = plan.narrow_width(g.gid)
        width = nd if nd < g.dim else g.dim
        live = sum(t.vocab for t in g.tables)
        counts = np.zeros(g.rows, np.int32)
        counts[:live] = (np.minimum(rng.zipf(1.3, live), 40)
                         * (rng.random(live) < 0.6)).astype(np.int32)
        picked = rng.permutation(live)

        def tier(h, off):
            keys = np.full(h, g.rows, np.int32)
            n = (3 * h) // 4
            keys[:n] = np.sort(picked[off:off + n])
            rows = np.zeros((h, g.dim), np.float32)
            acc = np.zeros((h, 1), np.float32)
            rows[:n] = rng.normal(size=(n, g.dim)).astype(np.float32)
            acc[:n] = np.abs(rng.normal(size=(n, 1))).astype(np.float32)
            return keys, rows, acc, n

        h1, h2 = plan.cache_rows.get(g.gid, 0), plan.l2_rows.get(g.gid, 0)
        k1, r1, a1, n1 = tier(h1, 0)
        st = {"w": (rng.normal(size=(g.rows, width)) * 0.3).astype(np.float32),
              "acc": np.abs(rng.normal(size=(g.rows, 1))).astype(np.float32),
              "counts": counts, "cache": (k1, r1, a1), "l2": None, "proj": None}
        if h2 > 0:
            st["l2"] = tier(h2, n1)[:3]
        if width < g.dim:
            st["proj"] = (_np_proj_kernel(g.gid, width, g.dim),
                          np.abs(rng.normal(size=(width, 1))).astype(np.float32))
        out[str(g.gid)] = st
    return out


def _port_emb(st, lo=0, hi=None):
    """The port's emb state of a numpy state: master rows ``[lo, hi)``,
    every tier and the projection whole."""
    from repro_torch.core.packed_embedding import CacheState, ProjState
    from repro_torch.embedding.state import EmbeddingState

    def t(x):
        return torch.from_numpy(np.array(x))

    return {k: EmbeddingState(
        w=t(s["w"][lo:hi]), acc=t(s["acc"][lo:hi]), counts=t(s["counts"][lo:hi]),
        cache=CacheState(*map(t, s["cache"])),
        l2=None if s["l2"] is None else CacheState(*map(t, s["l2"])),
        proj=None if s["proj"] is None else ProjState(*map(t, s["proj"])))
        for k, s in st.items()}


def _np_emb(emb):
    def tier(x):
        return None if x is None else tuple(v.numpy().copy() for v in x)

    return {k: {"w": s.w.numpy().copy(), "acc": s.acc.numpy().copy(),
                "counts": s.counts.numpy().copy(), "cache": tier(s.cache), "l2": tier(s.l2),
                "proj": tier(s.proj)} for k, s in emb.items()}


def _mig_plans(case):
    """The case's old plan at world 4 on both sides, its assignment recorded."""
    from repro_torch.configs import get_config
    from repro_torch.core.assign import apply_assignment, resolve_assignment
    from repro_torch.core.packing import make_plan

    old_s, _, plan_kw, _, _ = MIGRATIONS[case]
    k = {**MIG_KW, **plan_kw}
    plan = make_plan(get_config("deepfm", smoke=True), W, MIG_GB // W, mesh_shape=(2, 2), **k)
    jplan = jmake_plan(jget_config("deepfm", smoke=True), W, MIG_GB // W, mesh_shape=(2, 2),
                       **k)
    apply_assignment(plan, resolve_assignment(plan, old_s, world=W))
    japply_assignment(jplan, jresolve_assignment(jplan, old_s))
    return plan, jplan


def _revised(plan, stats, case, apply, resolve, revise, **kw):
    _, new_s, _, rev_kw, _ = MIGRATIONS[case]
    new = revise(plan, stats, **rev_kw)
    apply(new, resolve(new, new_s, **kw))
    return new


# ---------------------------------------------------------------- the ranks
def _port_replan(group, ref, batches, synth):
    from repro_torch.configs import get_config
    from repro_torch.convert import train_state_from_jax
    from repro_torch.core.assign import apply_assignment, resolve_assignment
    from repro_torch.core.packing import make_plan, revise_plan
    from repro_torch.embedding.state import migrate_state
    from repro_torch.engine import export_stats
    from repro_torch.models.wdl import WDLModel
    from repro_torch.perf import synthetic_cost_model
    from repro_torch.runtime import Replanner, ReplanMismatch, plan_delta, plan_meta
    from repro_torch.train.train_step import TrainConfig, make_train_step

    cfg = get_config("deepfm", smoke=True)
    out = {}

    def new_plan():
        return _plan4(get_config, make_plan, **PLAN_KW)

    def step_for(p):
        return make_train_step(WDLModel(cfg, p), p, GB,
                               TrainConfig(strategy="mixed", use_fused_kernels="off"), "cpu",
                               group=group)

    def shared(st, p):
        return train_state_from_jax(_ns_state(st), p, "cpu", group=group)

    # -- the replanned run, each step from the reference's state before it
    plan = new_plan()
    rp = Replanner(plan, strategy="auto", hot_bytes=HOT_CUT, group=group)
    out["strategy0"] = dict(plan.strategy)
    step = step_for(plan)
    out["steps"], out["stats"], out["migrated"] = [], {}, {}
    for i, b in enumerate(batches, 1):
        start = ref["migrated"].get(i - 1, ref["states"][i - 1])
        st, m = step(shared(start, plan), b)
        out["steps"].append({"state": _rank_state(st),
                             "met": {k: (v if isinstance(v, int) else v.numpy().copy())
                                     for k, v in m.items()}})
        rp.observe(m)
        if i in REPLAN_AT:
            st = shared(ref["states"][i], plan)
            out["stats"][i] = export_stats(plan, st["emb"], group)
            res = rp.maybe_replan(st, step=i)
            if res is not None:
                plan, st = res
                out["migrated"][i] = _rank_state(st)
                step = step_for(plan)
    out["events"] = [(e.step, e.old_rev, e.new_rev, e.changed, e.window) for e in rp.events]
    out["seconds"] = [e.seconds for e in rp.events]
    out["meta"] = plan_meta(plan)

    # -- a no-op replan (the same budgets and strategy) leaves the run bitwise
    plan_a, plan_b = new_plan(), new_plan()
    runs = []
    for p, replan in ((plan_a, False), (plan_b, True)):
        nrp = Replanner(p, strategy="picasso", rebudget=False, group=group)
        step = step_for(p)
        st = shared(ref["states"][0], p)
        for i, b in enumerate(batches[:3], 1):
            st, m = step(st, b)
            nrp.observe(m)
            if replan and i == 2:
                out["noop"] = nrp.maybe_replan(st, step=i)
        runs.append(_rank_state(st))
    out["noop_runs"] = runs

    # -- the feedback: the reference's times on every rank, then other times
    fplan = new_plan()
    m = synthetic_cost_model(SLOPES, fixed_us=3.0)
    frp = Replanner(fplan, strategy="auto", cost_model=m, rebudget=False, group=group)
    fstats = _fstats(fplan)
    out["feedback"] = []
    for window in WINDOWS:
        for t in window:
            frp.observe_timing(t)
        out["feedback"].append(frp._feedback(fstats))
    out["correction"] = m.correction
    m2 = synthetic_cost_model(SLOPES, fixed_us=3.0)
    frp2 = Replanner(new_plan(), strategy="auto", cost_model=m2, rebudget=False, group=group)
    mine = [t * (1.0 + 0.25 * ((group.rank + j) % W)) for j, t in enumerate(WINDOWS[0])]
    for t in mine:
        frp2.observe_timing(t)
    out["skewed"] = (mine, frp2._feedback(fstats), m2.correction)

    # -- disagreements raise on every rank
    st = shared(ref["states"][REPLAN_AT[0]], new_plan())
    bad = Replanner(new_plan(), strategy="auto",
                    hot_bytes=HOT_CUT // (2 if group.rank == 2 else 1), group=group)
    try:
        bad.maybe_replan(st, step=REPLAN_AT[0])
        out["mismatch"] = None
    except ReplanMismatch as e:
        out["mismatch"] = str(e)
    m3 = synthetic_cost_model(SLOPES, fixed_us=3.0)
    odd = Replanner(new_plan(), strategy="auto", cost_model=m3, rebudget=False, group=group)
    for t in WINDOWS[0][: 2 if group.rank == 1 else 3]:
        odd.observe_timing(t)
    try:
        odd.maybe_replan(st, step=REPLAN_AT[0])
        out["timing_mismatch"] = None
    except ReplanMismatch as e:
        out["timing_mismatch"] = str(e)

    # -- migrate_state on each rank's cut of a seeded state
    out["mig"] = {}
    for case, full in synth.items():
        _, _, _, _, cu = MIGRATIONS[case]
        plan, _ = _mig_plans(case)
        rps = plan.groups[0].rows // W
        emb = _port_emb(full, group.rank * rps, (group.rank + 1) * rps)
        stats = export_stats(plan, emb, group)
        new = _revised(plan, stats, case, apply_assignment, resolve_assignment, revise_plan,
                       world=W)
        got = migrate_state(plan, new, emb, cache_update=cu, group=group)
        out["mig"][case] = {"delta": plan_delta(plan, new), "emb": _np_emb(got),
                            "stats": stats}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_replan")
    cfg = jget_config("deepfm", smoke=True)
    rng = np.random.default_rng(3)
    batches = [jmake_batch(cfg, GB, rng) for _ in range(STEPS)]
    fstats = _fstats(_plan4(jget_config, jmake_plan, **PLAN_KW))
    ref = run_reference(REF_BODY, {"GB": GB, "plan_kw": PLAN_KW, "hot_cut": HOT_CUT,
                                   "batches": batches, "replan_at": REPLAN_AT,
                                   "slopes": SLOPES, "windows": WINDOWS, "fstats": fstats},
                        tmp, timeout=900)
    synth = {case: _synth_state(_mig_plans(case)[0], seed) for seed, case in
             enumerate(sorted(MIGRATIONS))}
    port = run_port(_port_replan, ref, batches, synth, tmp=tmp, deadline_s=600)
    return ref, port, synth


# ---------------------------------------------------------------- the tests
def test_export_stats_is_the_references_harvest_on_every_rank(runs):
    ref, port, _ = runs
    assert sorted(ref["stats"]) == list(REPLAN_AT)
    for i, exp in ref["stats"].items():
        for p in port:
            assert sorted(p["stats"][i]) == sorted(exp)
            for gid, c in exp.items():
                got = p["stats"][i][gid]
                assert got.dtype == c.dtype and got.tobytes() == c.tobytes(), (i, gid)


def test_replan_events_and_plan_meta_are_the_references(runs):
    ref, port, _ = runs
    assert ref["events"][0][3], "the step-4 recompile must migrate"
    for p in port:
        assert p["strategy0"] == ref["strategy0"]
        assert p["events"] == ref["events"]
        assert p["meta"] == ref["meta"]
    assert sorted(port[0]["migrated"]) == sorted(ref["migrated"])
    # an event's seconds are the slowest rank's: every rank reports the same
    for p in port[1:]:
        assert p["seconds"] == port[0]["seconds"]
    assert set(port[0]["seconds"][0]) == {"harvest", "compile", "migrate"}


def _bars(got_ranks, exp, what):
    """The training bars on a gathered state: FCounter and tier keys
    bitwise, floats to atol 1e-4, the tiers and dense leaves of every rank."""
    for key, est in exp["emb"].items():
        for leaf in ("w", "acc", "counts"):
            got = np.concatenate([g["emb"][key][leaf] for g in got_ranks])
            if leaf == "counts":
                np.testing.assert_array_equal(got, est[leaf], err_msg=what)
            else:
                np.testing.assert_allclose(got, est[leaf], atol=1e-4, rtol=0, err_msg=what)
        for g in got_ranks:
            keys, rows, acc = g["emb"][key]["cache"]
            np.testing.assert_array_equal(keys, est["cache"][0], err_msg=what)
            np.testing.assert_allclose(rows, est["cache"][1], atol=1e-4, rtol=0, err_msg=what)
            np.testing.assert_allclose(acc, est["cache"][2], atol=1e-4, rtol=0, err_msg=what)
    for part, jtree in (("dense", exp["dense"]), ("m", exp["opt"]["m"]),
                        ("v", exp["opt"]["v"])):
        jl = _leaves(jtree)
        for g in got_ranks:
            assert len(g[part]) == len(jl)
            for a, b in zip(g[part], jl):
                np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=what)


def test_the_migrated_state_meets_the_bars(runs):
    ref, port, _ = runs
    for i, exp in ref["migrated"].items():
        _bars([p["migrated"][i] for p in port], exp, f"migrated at {i}")


@pytest.mark.parametrize("i", range(STEPS))
def test_each_step_from_a_shared_state_meets_the_bars(runs, i):
    """Steps 1-4 at revision 0, steps 5-8 at the replanned revision."""
    ref, port, _ = runs
    jm = ref["mets"][i]
    for p in port:
        m = p["steps"][i]["met"]
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4,
                                   atol=1e-5)
        assert (int(m["cache_hits"]), int(m["overflow"])) == (int(jm["cache_hits"]),
                                                              int(jm["overflow"]))
    _bars([p["steps"][i]["state"] for p in port], ref["states"][i + 1], f"step {i + 1}")


def test_a_noop_replan_leaves_the_run_bitwise(runs):
    _, port, _ = runs
    for p in port:
        assert p["noop"] is None
        a, b = p["noop_runs"]
        for key in a["emb"]:
            for leaf in ("w", "acc", "counts"):
                assert a["emb"][key][leaf].tobytes() == b["emb"][key][leaf].tobytes()
            for x, y in zip(a["emb"][key]["cache"], b["emb"][key]["cache"]):
                assert x.tobytes() == y.tobytes()
        for part in ("dense", "m", "v"):
            assert all(x.tobytes() == y.tobytes() for x, y in zip(a[part], b[part]))


def test_feedback_is_the_references_and_one_correction_on_every_rank(runs):
    ref, port, _ = runs
    for p in port:
        assert p["feedback"] == ref["feedback"]
        assert p["correction"] == ref["correction"] != 1.0
    # other times on each rank: one measurement, the median of each step's max
    times = np.array([p["skewed"][0] for p in port])
    fb, corr = port[0]["skewed"][1:]
    assert fb[0] == float(np.median(times.max(axis=0)))
    assert len({tuple(t) for t in times}) == W  # the ranks did time differently
    for p in port[1:]:
        assert p["skewed"][1:] == (fb, corr)


def test_a_disagreement_raises_on_every_rank(runs):
    _, port, _ = runs
    for p in port:
        assert p["mismatch"] is not None and "rank(s) [2]" in p["mismatch"], p["mismatch"]
        assert p["timing_mismatch"] is not None and "timed" in p["timing_mismatch"]


def _jemb(st):
    """The reference's emb state of a numpy state."""
    return {k: JEmbeddingState(
        w=s["w"], acc=s["acc"], counts=s["counts"], cache=JCacheState(*s["cache"]),
        l2=None if s["l2"] is None else JCacheState(*s["l2"]),
        proj=None if s["proj"] is None else JProjState(*s["proj"])) for k, s in st.items()}


def _close(got, exp, tol, what):
    exp = np.asarray(exp)
    assert got.shape == exp.shape and got.dtype == exp.dtype, what
    assert np.abs(got - exp).max(initial=0.0) <= tol * max(1.0, float(np.abs(exp).max())), what


@pytest.mark.parametrize("case", sorted(MIGRATIONS))
def test_migrate_state_past_world_1(runs, case):
    """Gathered over the ranks the migration is the reference's (integers
    bitwise, floats within 1e-6 of scale, 1e-5 through the pseudo-inverse);
    the replicas are bitwise alike; and each rank's cut is the port's world-1
    migration of the same state, row for row."""
    from repro_torch.core.assign import apply_assignment, resolve_assignment
    from repro_torch.core.packing import revise_plan
    from repro_torch.embedding.state import migrate_state

    _, port, synth = runs
    full = synth[case]
    cu = MIGRATIONS[case][4]
    plan, jplan = _mig_plans(case)
    stats = {g.gid: full[str(g.gid)]["counts"] for g in plan.groups}
    for p in port:
        for gid, c in stats.items():
            np.testing.assert_array_equal(p["mig"][case]["stats"][gid], c)
    jnew = _revised(jplan, stats, case, japply_assignment, jresolve_assignment, jrevise_plan)
    new = _revised(plan, stats, case, apply_assignment, resolve_assignment, revise_plan,
                   world=W)
    assert all(p["mig"][case]["delta"] == jplan_delta(jplan, jnew) != {} for p in port)
    jout = {k: {"w": np.asarray(s.w), "acc": np.asarray(s.acc),
                "counts": np.asarray(s.counts),
                "tiers": [t for t in (s.cache, s.l2) if t is not None], "proj": s.proj}
            for k, s in jmigrate_state(jplan, jnew, _jemb(full), cache_update=cu).items()}
    one = _np_emb(migrate_state(plan, new, _port_emb(full), cache_update=cu))
    narrow_wb = cu == "psum" and plan.narrow_width(0) < plan.group(0).dim
    for key, exp in jout.items():
        ranks = [p["mig"][case]["emb"][key] for p in port]
        rps = ranks[0]["w"].shape[0]
        for r, got in enumerate(ranks):  # the world-1 migration, row for row
            for leaf in ("w", "acc", "counts"):
                assert torch.equal(torch.from_numpy(got[leaf]),
                                   torch.from_numpy(one[key][leaf][r * rps:(r + 1) * rps]))
            for part in ("cache", "l2", "proj"):
                assert (got[part] is None) == (one[key][part] is None)
                if got[part] is not None:
                    for x, y, z in zip(got[part], one[key][part], ranks[0][part]):
                        assert torch.equal(torch.from_numpy(x), torch.from_numpy(y))
                        assert x.tobytes() == z.tobytes()  # replicas alike
        np.testing.assert_array_equal(np.concatenate([g["counts"] for g in ranks]),
                                      exp["counts"])
        _close(np.concatenate([g["w"] for g in ranks]), exp["w"],
               1e-5 if narrow_wb or case == "wide-to-narrow" else 1e-6, f"{case} w")
        _close(np.concatenate([g["acc"] for g in ranks]), exp["acc"], 1e-6, f"{case} acc")
        tiers = [ranks[0][t] for t in ("cache", "l2") if ranks[0][t] is not None]
        assert len(tiers) == len(exp["tiers"])
        for got, jt in zip(tiers, exp["tiers"]):
            np.testing.assert_array_equal(got[0], np.asarray(jt.keys), f"{case} keys")
            _close(got[1], jt.rows, 1e-5 if narrow_wb else 1e-6, f"{case} tier rows")
            _close(got[2], jt.acc, 1e-6, f"{case} tier acc")
        assert (ranks[0]["proj"] is None) == (exp["proj"] is None)
        if exp["proj"] is not None:
            _close(ranks[0]["proj"][0], exp["proj"].kernel, 1e-6, f"{case} proj")
            _close(ranks[0]["proj"][1], exp["proj"].acc, 1e-6, f"{case} proj acc")
