"""The port's strategy-assignment compiler (``repro_torch.core.assign``)
against the reference's ``repro.core.assign`` on the same plans: the cost
model's picks, scores and reasons, measured stats, overrides, spec
resolution, and the launchers' ``--strategy`` spellings.

Each case of ``tests/test_assign.py`` runs here on both packages; the
full-width unpacked deepfm and dcn-v2 plans (pure planning, no state) must
mix as the reference mixes them: 26 ``ps`` + 13 ``picasso`` and 13 + 13.
"""
import re
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs.base import FeatureField as JFeatureField
from repro.configs.base import InteractionSpec as JInteractionSpec
from repro.configs.base import WDLConfig as JWDLConfig
from repro.core import assign as jassign
from repro.core.packing import make_plan as jmake_plan
from repro_torch.configs import get_config
from repro_torch.configs.base import FeatureField, InteractionSpec, WDLConfig
from repro_torch.core import assign
from repro_torch.core.packing import make_plan
from repro_torch.engine import (AUTO_NAMES, StrategyAssignment, apply_assignment,
                                compile_assignment, estimate_l2_gain, estimate_narrow_gain,
                                estimate_skew, maybe_compile, resolve_assignment)
from test_torch_serve import ROOT, _env

SIDES = ((JFeatureField, JInteractionSpec, JWDLConfig, jmake_plan, jassign),
         (FeatureField, InteractionSpec, WDLConfig, make_plan, assign))


def _plans(fields, world=1, per_device_batch=16, **kw):
    """(reference plan, port plan) of a WDL config of ``fields``, each a
    ``(name, vocab, dim)``."""
    out = []
    for ff, isp, wc, mk, _ in SIDES:
        cfg = wc(name="t", fields=tuple(ff(n, v, d, max_len=1, pooling="sum")
                                        for n, v, d in fields),
                 n_dense=0, interactions=(isp("fm"),), mlp_dims=(8,))
        out.append(mk(cfg, world=world, per_device_batch=per_device_batch, **kw))
    return out


MIXED = (("tiny", 64, 8), ("big", 50_000, 16))


def _mixed_plans(**kw):
    """The reference's ``_mixed_plan``: one tiny group (dim 8) + one large
    budgeted group (dim 16)."""
    kw.setdefault("hot_bytes", 1 << 14)
    return _plans(MIXED, **kw)


def _same(asg, jasg):
    """Assignments, scores and reasons equal, field for field."""
    assert asg.strategy == jasg.strategy
    assert sorted(asg.scores) == sorted(jasg.scores)
    for gid, s in asg.scores.items():
        js = jasg.scores[gid]
        for f in ("gid", "vparam", "ids_per_shard", "rows", "skew", "costs", "choice",
                  "reason", "units"):
            assert getattr(s, f) == getattr(js, f), (gid, f)
    assert asg.describe() == jasg.describe()


def _by_name(plan, asg):
    return {plan.group(g).tables[0].name: s for g, s in asg.strategy.items()}


# ------------------------------------------------------------- cost model
def test_constants_are_the_references():
    for name in ("ROUTE_OVERHEAD_ELEMS", "DEFAULT_HIT_RATIO", "PS_MAX_ROWS", "SKEW_MIN",
                 "L2_HOST_FACTOR", "NARROW_MIN_ROWS", "NARROW_COLD_MIN", "AUTO_NAMES"):
        assert getattr(assign, name) == getattr(jassign, name), name


@pytest.mark.parametrize("enable_cache", [True, False])
def test_cost_model_mixes_ps_picasso_hybrid(enable_cache):
    jplan, plan = _mixed_plans(enable_cache=enable_cache)
    asg, jasg = compile_assignment(plan), jassign.compile_assignment(jplan)
    _same(asg, jasg)
    # no cache budget: the big group takes the plain routed path
    assert _by_name(plan, asg) == {"tiny": "ps",
                                   "big": "picasso" if enable_cache else "hybrid"}
    for gid, s in asg.scores.items():
        assert s.choice == asg.strategy[gid] and s.reason
        assert {"ps", "hybrid", "picasso"} == set(s.costs)
    assert "ps" in asg.describe() and ("picasso" in asg.describe()) == enable_cache


def test_calibrated_cost_model_is_not_ported():
    """The calibrated model is ported now (the test keeps its name): given
    the same synthetic curves, every function that takes ``cost_model=``
    answers as the reference's does, a measured ``hit_prior`` and a slow
    all_gather included, and its scores are in microseconds."""
    from repro.perf import synthetic_cost_model as jsynthetic
    from repro_torch.perf import synthetic_cost_model

    jplan, plan = _mixed_plans(l2_bytes=1 << 15)
    for per in (None, {"wire_ag": 1e3}):
        m, jm = synthetic_cost_model(per, hit_prior=0.37), jsynthetic(per, hit_prior=0.37)
        asg = compile_assignment(plan, cost_model=m)
        _same(asg, jassign.compile_assignment(jplan, cost_model=jm))
        assert {s.units for s in asg.scores.values()} == {"us"}
        for g, jg in zip(plan.groups, jplan.groups):
            for fn, jfn, args in ((estimate_skew, jassign.estimate_skew, (8,)),
                                  (estimate_l2_gain, jassign.estimate_l2_gain, (8, 8)),
                                  (estimate_narrow_gain, jassign.estimate_narrow_gain,
                                   (8, 8))):
                assert fn(g, *args, cost_model=m) == jfn(jg, *args, cost_model=jm)
        assert maybe_compile(plan, "mixed", cost_model=m) == "mixed"
        jassign.maybe_compile(jplan, "mixed", cost_model=jm)
        assert plan.strategy == jplan.strategy == asg.strategy


@pytest.mark.parametrize("world,batch", [(1, 16), (4, 64), (8, 512)])
def test_compile_matches_reference_across_worlds_and_batches(world, batch):
    """The PS term scales with the world and the id volume with the batch;
    the picks follow the reference's across both, micro-batched plans
    included (``per_device_batch`` given and left to ``plan.microbatch``)."""
    fields = MIXED + (("mid", 9000, 16), ("huge", 400_000, 32))
    jplan, plan = _plans(fields, world=world, per_device_batch=batch, hot_bytes=1 << 16)
    for pdb in (None, batch):
        _same(compile_assignment(plan, per_device_batch=pdb),
              jassign.compile_assignment(jplan, per_device_batch=pdb))
    _same(compile_assignment(plan, world=2 * world), jassign.compile_assignment(
        jplan, world=2 * world))


def test_measured_stats_override_the_prior():
    jplan, plan = _mixed_plans()
    gid_big = next(g.gid for g in plan.groups if g.tables[0].name == "big")
    hot = np.zeros(plan.group(gid_big).rows)
    hot[3] = 100.0
    asg = compile_assignment(plan, stats={gid_big: hot})
    _same(asg, jassign.compile_assignment(jplan, stats={gid_big: hot}))
    assert asg.scores[gid_big].skew == pytest.approx(1.0)
    assert asg.strategy[gid_big] == "picasso"
    # flat measured counts on a small tier: skew under SKEW_MIN, routed uncached
    flat = np.ones(plan.group(gid_big).rows)
    asg = compile_assignment(plan, stats={gid_big: flat})
    _same(asg, jassign.compile_assignment(jplan, stats={gid_big: flat}))
    assert asg.strategy[gid_big] == "hybrid"


def test_estimate_skew():
    jplan, plan = _mixed_plans()
    g, jg = plan.groups[0], jplan.groups[0]
    counts = np.r_[np.full(8, 10.0), np.zeros(56)]
    cases = [(0, None), (8, None), (8, counts), (4, counts), (10_000, None)]
    for rows, c in cases:
        assert estimate_skew(g, rows, c) == jassign.estimate_skew(jg, rows, c)
    assert estimate_skew(g, 0) == 0.0 and estimate_skew(g, 8) > 0.0
    assert estimate_skew(g, 8, counts) == pytest.approx(1.0)
    assert estimate_skew(g, 4, counts) == pytest.approx(0.5)
    ranked = np.sort(counts)[::-1]
    for l1, l2 in ((4, 2), (4, 100), (0, 8), (60, 10)):
        for c, r in ((None, False), (counts, False), (ranked, True)):
            assert estimate_l2_gain(g, l1, l2, c, ranked=r) == jassign.estimate_l2_gain(
                jg, l1, l2, c, ranked=r)
            assert estimate_narrow_gain(g, l1, l2, c, ranked=r) == \
                jassign.estimate_narrow_gain(jg, l1, l2, c, ranked=r)


# -------------------------------------------------------------- overrides
@pytest.mark.parametrize("overrides", [{"big": "hybrid", 0: "ps"}, {"*i*": "hybrid"},
                                       {"1": "allgather_rows"}, {"tiny": "mp_nodedup"}])
def test_overrides_by_gid_and_table_glob(overrides):
    jplan, plan = _mixed_plans()
    asg = compile_assignment(plan, overrides=overrides)
    _same(asg, jassign.compile_assignment(jplan, overrides=overrides))
    if "*i*" in overrides:  # both tables match
        assert set(asg.strategy.values()) == {"hybrid"}
    if "big" in overrides:
        assert _by_name(plan, asg)["big"] == "hybrid"


@pytest.mark.parametrize("overrides,exc,match", [
    ({"nope*": "ps"}, ValueError, "matches no table"),
    ({"big": "not-a-strategy"}, ValueError, "unknown lookup strategy"),
    ({99: "ps"}, KeyError, "gid=99")])
def test_overrides_fail_fast(overrides, exc, match):
    jplan, plan = _mixed_plans()
    with pytest.raises(exc, match=match):
        compile_assignment(plan, overrides=overrides)
    with pytest.raises(exc):
        jassign.compile_assignment(jplan, overrides=overrides)


def test_cost_model_routes_cold_heavy_group_to_narrow():
    """A big group with a skewed head but a dominant cold tail goes to
    picasso_narrow when the plan records a narrow budget, and only then."""
    fields = (("big", 200_000, 16),)
    kw = dict(world=1, per_device_batch=64, hot_bytes=1 << 13, l2_bytes=1 << 14)
    jplan, plan = _plans(fields, narrow_dim=4, **kw)
    gid = plan.groups[0].gid
    g = plan.group(gid)
    counts = np.maximum((1e5 / np.arange(1, g.rows + 1) ** 0.7).astype(np.int32), 1)
    gain = estimate_narrow_gain(g, plan.cache_rows[gid], plan.l2_rows[gid], counts=counts,
                                ranked=True)
    assert gain > 0.5 and gain == jassign.estimate_narrow_gain(
        jplan.group(gid), jplan.cache_rows[gid], jplan.l2_rows[gid], counts=counts,
        ranked=True)
    asg = compile_assignment(plan, stats={gid: counts})
    _same(asg, jassign.compile_assignment(jplan, stats={gid: counts}))
    assert asg.strategy[gid] == "picasso_narrow"
    jbase, base = _plans(fields, **kw)
    basg = compile_assignment(base, stats={gid: counts})
    _same(basg, jassign.compile_assignment(jbase, stats={gid: counts}))
    assert basg.strategy[gid] != "picasso_narrow"
    # an L2 budget without the narrow one: the host tier candidate
    assert "picasso_l2" in basg.scores[gid].costs


# ---------------------------------------------------------- normalization
def test_resolve_broadcast_and_auto():
    jplan, plan = _mixed_plans()
    gids = {g.gid for g in plan.groups}
    assert resolve_assignment(plan, "ps") == {g: "ps" for g in gids}
    assert plan.strategy == {}  # a broadcast records nothing
    for name in AUTO_NAMES:
        auto = resolve_assignment(plan, name)
        assert auto == jassign.resolve_assignment(jplan, name)
        assert set(auto) == gids and plan.strategy == auto  # compiled and recorded
    apply_assignment(plan, {g: "hybrid" for g in gids})
    assert resolve_assignment(plan, "mixed") == {g: "hybrid" for g in gids}
    # a picasso_narrow broadcast is recorded: the master widths gate on it
    _, plan2 = _mixed_plans()
    resolve_assignment(plan2, "picasso_narrow")
    assert plan2.strategy == {g: "picasso_narrow" for g in gids}


def test_resolve_auto_honours_use_cache_and_world():
    jplan, plan = _mixed_plans()
    auto = resolve_assignment(plan, "mixed", use_cache=False)
    assert "picasso" not in set(auto.values())
    assert auto == jassign.resolve_assignment(jplan, "mixed", use_cache=False)
    assert compile_assignment(_mixed_plans()[1], enable_cache=False).strategy == auto
    jplan, plan = _mixed_plans()
    assert resolve_assignment(plan, "auto", world=8) == jassign.resolve_assignment(
        jplan, "auto", world=8)


@pytest.mark.parametrize("spec,match", [
    ("typo", "unknown lookup strategy"), ({0: "ps"}, "missing gids"),
    ({0: "ps", 1: "ps", 99: "ps"}, "unknown gids"),
    ({0: "typo", 1: "typo"}, "unknown lookup strategy")])
def test_resolve_validates_coverage_and_names(spec, match):
    jplan, plan = _mixed_plans()
    assert sorted(g.gid for g in plan.groups) == [0, 1]
    with pytest.raises(ValueError, match=match):
        resolve_assignment(plan, spec)
    with pytest.raises(ValueError, match=match):
        jassign.resolve_assignment(jplan, spec)


def test_resolve_takes_a_strategy_assignment_and_string_gids():
    _, plan = _mixed_plans()
    asg = StrategyAssignment(strategy={0: "ps", 1: "ps"})
    assert resolve_assignment(plan, asg) == {0: "ps", 1: "ps"}
    assert resolve_assignment(plan, {"0": "ps", "1": "hybrid"}) == {0: "ps", 1: "hybrid"}


def test_apply_assignment_records_on_plan():
    _, plan = _mixed_plans()
    asg = compile_assignment(plan)
    assert apply_assignment(plan, asg) is plan
    assert plan.strategy == asg.strategy
    with pytest.raises(ValueError, match="unknown lookup strategy"):
        apply_assignment(plan, {0: "typo"})


@pytest.mark.parametrize("spec", ["mixed", "auto", "picasso", "ps"])
def test_maybe_compile_records_and_logs_only_the_auto_names(spec):
    jplan, plan = _mixed_plans()
    logs = []
    assert maybe_compile(plan, spec, per_device_batch=64, use_cache=True,
                         log=logs.append) == spec
    jassign.maybe_compile(jplan, spec, per_device_batch=64, use_cache=True)
    assert plan.strategy == dict(jplan.strategy)
    assert bool(plan.strategy) == bool(logs) == (spec in AUTO_NAMES)
    if logs:
        assert logs[0].startswith("strategy assignment (cost model, plan rev 0):")


# -------------------------------------------------------- full-width plans
@pytest.mark.parametrize("arch,b,mix", [("deepfm", 256, {"ps": 26, "picasso": 13}),
                                        ("deepfm", 512, {"ps": 26, "picasso": 13}),
                                        ("dcn-v2", 256, {"ps": 13, "picasso": 13}),
                                        ("dcn-v2", 512, {"ps": 13, "picasso": 13})])
def test_full_width_unpacked_plans_mix_as_the_reference(arch, b, mix):
    """The launchers' full-width plans with ``--no-packing`` (training at
    B = 256 with its 1 GiB tier, serving at B = 512), compiled as the
    launchers compile them: the tables of at most 8,192 rows go to ``ps``,
    the rest to ``picasso``, each with a hot-tier budget. Packed, the one
    group stays on ``picasso``."""
    kw = dict(hot_bytes=1 << 30, flush_iters=20, warmup_iters=10) if b == 256 else {}
    pdb = None if b == 256 else b
    plan = make_plan(get_config(arch), 1, b, enable_packing=False, **kw)
    jplan = jmake_plan(jget_config(arch), 1, b, enable_packing=False, **kw)
    asg = compile_assignment(plan, per_device_batch=pdb)
    _same(asg, jassign.compile_assignment(jplan, per_device_batch=pdb))
    assert dict(Counter(asg.strategy.values())) == mix
    for gid, name in asg.strategy.items():
        assert (plan.group(gid).rows <= assign.PS_MAX_ROWS) == (name == "ps")
        assert plan.cache_rows[gid] > 0
    packed = make_plan(get_config(arch), 1, b, **kw)
    assert compile_assignment(packed, per_device_batch=pdb).strategy == {0: "picasso"}


# ------------------------------------------------------------- launchers
def _run(module, *args):
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                          text=True, timeout=300, env=_env(), cwd=str(ROOT))


@pytest.mark.parametrize("module", ["repro_torch.launch.train", "repro_torch.launch.serve"])
def test_launchers_reject_unknown_strategy(module):
    out = _run(module, "--strategy", "nope", "--device", "cpu")
    assert out.returncode == 2
    assert "invalid choice" in out.stderr and "mixed" in out.stderr
    for name in ("allgather_rows", "hybrid", "mp_nodedup", "ps", "auto"):
        assert name in out.stderr


def test_train_launcher_mixed_no_packing_on_cpu():
    """``--no-packing --strategy mixed`` on the smoke config: the
    assignment is printed (every smoke table is tiny, so ``ps``), and
    training runs with the software-pipelined step forced on."""
    out = _run("repro_torch.launch.train", "--arch", "deepfm", "--smoke", "--device", "cpu",
               "--steps", "3", "--global-batch", "32", "--log-every", "1", "--no-packing",
               "--strategy", "mixed", "--overlap", "on", "--n-micro", "2")
    assert out.returncode == 0, out.stderr
    assert "[train] strategy assignment (cost model, plan rev 0):" in out.stdout
    assert len(re.findall(r"^  g\d+: ps ", out.stdout, re.M)) == 39
    assert "39 packed groups, micro=16" in out.stdout
    steps = re.findall(r"^  step +(\d+) loss=([\d.]+) hits=0 ovf=0$", out.stdout, re.M)
    assert [int(s[0]) for s in steps] == [1, 2, 3], out.stdout
    assert out.stdout.rstrip().endswith("[train] done")


@pytest.mark.parametrize("strategy,packing", [("mixed", False), ("ps", True),
                                              ("allgather_rows", False)])
def test_serve_launcher_strategies_on_cpu(strategy, packing):
    out = _run("repro_torch.launch.serve", "--arch", "dcn-v2", "--smoke", "--device", "cpu",
               "--n-requests", "2", "--batch", "32", "--strategy", strategy,
               *(() if packing else ("--no-packing",)))
    assert out.returncode == 0, out.stderr
    assert ("strategy assignment" in out.stdout) == (strategy == "mixed")
    assert re.search(r"\[serve\] dcn-v2 B=32: p50=[\d.]+ms p99=[\d.]+ms mean_prob=[\d.]+",
                     out.stdout), out.stdout
