"""The port's measured cost model (``repro_torch.perf``) against the
reference's ``repro.perf`` on the same inputs: curve fits, candidate scores,
step predictions, the feedback blend and the JSON round trip bitwise; the
calibration file's stamp; ``compile_assignment(cost_model=)``; the
``get_cost_model`` lifecycle and a real tiny calibration on the port's plain
ops; the replanner's measured/predicted/correction feedback; and both
launchers' ``--calibrate auto`` mix.

The synthetic models are built from the same numbers on each side, so every
float must agree bit for bit (both sides run the same float64 numpy).
"""
import json
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import assign as jassign
from repro.core.packing import make_plan as jmake_plan
from repro.data.synthetic import make_batch as jmake_batch
from repro.dist.sharding import batch_specs, to_named
from repro.models.wdl import WDLModel as JWDLModel
from repro.perf import calibration as jcal
from repro.perf import cost_model as jcm
from repro.runtime import Replanner as JReplanner
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import init_state as jinit_state
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.core import assign
from repro_torch.core.packing import make_plan
from repro_torch.data.synthetic import make_batch
from repro_torch.models.wdl import WDLModel
from repro_torch.perf import calibration as cal
from repro_torch.perf import cost_model as cm
from repro_torch.runtime import Replanner
from repro_torch.train.train_step import TrainConfig, init_state, make_train_step
from test_torch_assign import _mixed_plans, _same
from test_torch_serve import ROOT, _env

AXES = ("data", "model")


def _models(per=None, **kw):
    """(reference, port) synthetic models of the same slopes."""
    return (jcm.synthetic_cost_model(per, **kw), cm.synthetic_cost_model(per, **kw))


def _same_model(m, jm):
    assert sorted(m.curves) == sorted(jm.curves)
    for op, c in m.curves.items():
        assert np.array_equal(c.xs, jm.curves[op].xs) and c.xs.dtype == np.float64, op
        assert np.array_equal(c.ys, jm.curves[op].ys) and c.ys.dtype == np.float64, op
    for f in ("backend", "interpret", "hit_prior", "correction", "meta"):
        assert getattr(m, f) == getattr(jm, f), f


def test_constants_are_the_references():
    assert cm.PRICED_OPS == jcm.PRICED_OPS
    assert cm.CORRECTION_ALPHA == jcm.CORRECTION_ALPHA
    assert cm.CORRECTION_BOUNDS == jcm.CORRECTION_BOUNDS
    assert cal.GRIDS == jcal.GRIDS and cal.CALIB_VERSION == jcal.CALIB_VERSION


@pytest.mark.parametrize("case", ["noisy", "duplicates", "single", "decreasing"])
def test_curve_fit_and_eval_bitwise(case):
    rng = np.random.default_rng(len(case))
    xs = {"noisy": rng.integers(1, 10_000, 40), "duplicates": np.repeat([3, 50, 900], 7),
          "single": np.array([64]), "decreasing": np.arange(1, 30)}[case]
    ys = (rng.normal(size=xs.shape) * 50 + 100 if case != "decreasing"
          else 1000.0 / np.arange(1, 30))
    samples = [(float(x), float(y)) for x, y in zip(xs, ys)]
    c, jc = cm.CostCurve.fit(samples), jcm.CostCurve.fit(samples)
    assert np.array_equal(c.xs, jc.xs) and np.array_equal(c.ys, jc.ys)
    assert np.all(np.diff(c.ys) >= 0)
    for x in (-5.0, 0.0, 1.0, float(xs.min()), 123.4, float(xs.max()), 1e7):
        assert c(x) == jc(x), x
    assert c.to_json() == jc.to_json()
    assert cm.CostCurve.from_json(jc.to_json()).to_json() == jc.to_json()


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_score_candidates_bitwise_over_a_grid(world):
    jm, m = _models({"wire_ag": 3e-3, "tier_probe": 2e-4, "gather_project": 7e-4},
                    fixed_us=2.5)
    m.correction = jm.correction = 1.37
    for n in (1, 64, 4096):
        for d in (8, 16, 128):
            for skew in (0.0, 0.3, 0.9):
                for l2_rows, l2_gain in ((0, 0.0), (5000, 0.2)):
                    for nd, ng in ((0, 0.0), (4, 0.4), (d, 0.4)):
                        kw = dict(world=world, n=n, d=d, skew=skew, l2_rows=l2_rows,
                                  l2_gain=l2_gain, narrow_dim=nd, narrow_gain=ng)
                        assert m.score_candidates(**kw) == jm.score_candidates(**kw), kw


@pytest.mark.parametrize("kind", ["picasso", "picasso_l2", "picasso_narrow"])
def test_predict_step_us_with_stats_bitwise(kind):
    kw = dict(hot_bytes=1 << 14)
    if kind != "picasso":
        kw["l2_bytes"] = 1 << 16
    if kind == "picasso_narrow":
        kw["narrow_dim"] = 4
    jplan = jmake_plan(jget_config("deepfm", smoke=True), 1, 32, **kw)
    plan = make_plan(get_config("deepfm", smoke=True), 1, 32, **kw)
    jassign.resolve_assignment(jplan, kind)
    assign.resolve_assignment(plan, kind)
    rng = np.random.default_rng(7)
    stats = {g.gid: rng.integers(0, 50, g.rows).astype(np.int64) for g in plan.groups}
    jm, m = _models({"dedup_adagrad": 2e-3}, hit_prior=0.31)
    for st in (None, stats):
        for pdb in (None, 16):
            assert (m.predict_step_us(plan, st, per_device_batch=pdb)
                    == jm.predict_step_us(jplan, st, per_device_batch=pdb))


def test_observe_measured_sequence_bitwise():
    jm, m = _models()
    rng = np.random.default_rng(3)
    for measured, predicted in zip(rng.uniform(-10, 1e5, 40), rng.uniform(-10, 1e5, 40)):
        for alpha in (cm.CORRECTION_ALPHA, 0.9):
            assert m.observe_measured(measured, predicted, alpha) == \
                jm.observe_measured(measured, predicted, alpha)
    assert m.correction == jm.correction
    for big in (1e9, 1e-9):  # the clamp
        assert m.observe_measured(big, 1.0) == jm.observe_measured(big, 1.0)


def test_json_round_trip_and_reference_file_refused_by_the_port_stamp(tmp_path):
    """The model's JSON round-trips as the reference's does; a calibration
    file the reference saved carries its stamp (``backend`` = JAX's), which
    the port refuses, while ``CostModel.from_json`` of its payload equals the
    reference's model."""
    samples = {op: [(1.0, 2.0 + i), (1e4, 9.0 + 2 * i), (1e4, 7.0 + i)]
               for i, op in enumerate(cm.PRICED_OPS)}
    jmodel = jcal.fit_cost_model(samples, hit_prior=0.25)
    model = cal.fit_cost_model(samples, hit_prior=0.25, device="cpu")
    assert model.to_json()["ops"] == jmodel.to_json()["ops"]
    assert model.backend == "torch-cpu" and jmodel.backend == "cpu"
    assert cm.CostModel.from_json(model.to_json()).to_json() == model.to_json()
    jpath = tmp_path / "repro.json"
    jcal.save_calibration(jpath, samples, jmodel)
    logs = []
    assert cal.load_calibration(jpath, log=logs.append, device="cpu") is None
    assert "stamp mismatch" in logs[0]
    assert cal.load_calibration(jpath, device="cuda") is None
    payload = json.loads(jpath.read_text())
    _same_model(cm.CostModel.from_json(payload), jcm.CostModel.from_json(payload))
    # the port's own file is the port's, and is refused by the reference
    path = tmp_path / "port.json"
    cal.save_calibration(path, samples, model, device="cpu")
    assert cal.load_calibration(path, device="cpu").to_json() == model.to_json()
    assert cal.load_calibration(path, device="cuda") is None
    assert jcal.load_calibration(path) is None
    assert cal.load_samples(path) == jcal.load_samples(jpath)
    assert cal.backend_stamp("cpu") == {"version": 1, "backend": "torch-cpu",
                                        "interpret": False}


@pytest.mark.parametrize("slopes", [None, {"wire_ag": 1e3}, {"wire_a2a": 1e3},
                                    {"tier_probe": 1e-1, "gather_pool": 1e-5}])
@pytest.mark.parametrize("l2_bytes,narrow_dim", [(0, None), (1 << 15, None), (1 << 15, 4)])
def test_compile_assignment_with_synthetic_model_matches_reference(slopes, l2_bytes,
                                                                   narrow_dim):
    """Assignment, scores (in us), costs, reasons and ``describe()`` equal
    the reference's, the distorted slopes of the reference's
    ``test_synthetic_calibration_flips_a_known_groups_strategy`` among them
    (a slow all_gather flips the tiny group off ``ps``)."""
    jplan, plan = _mixed_plans(l2_bytes=l2_bytes, narrow_dim=narrow_dim)
    jm, m = _models(slopes, hit_prior=0.27)
    asg = assign.compile_assignment(plan, cost_model=m)
    jasg = jassign.compile_assignment(jplan, cost_model=jm)
    _same(asg, jasg)
    assert all(s.units == "us" for s in asg.scores.values())
    if slopes == {"wire_ag": 1e3}:
        tiny = next(g.gid for g in plan.groups if g.tables[0].name == "tiny")
        assert assign.compile_assignment(plan).strategy[tiny] == "ps"
        assert asg.strategy[tiny] != "ps"
    logs, jlogs = [], []
    assign.maybe_compile(plan, "auto", cost_model=m, log=logs.append)
    jassign.maybe_compile(jplan, "auto", cost_model=jm, log=jlogs.append)
    assert plan.strategy == jplan.strategy == asg.strategy
    assert logs == jlogs and "calibrated curves (synthetic)" in logs[0]


def test_get_cost_model_lifecycle(tmp_path, monkeypatch):
    calls = []
    samples = {op: [(1.0, 3.0), (100.0, 5.0)] for op in cm.PRICED_OPS}

    def fake(grid, log=None, device="cuda", group=None):
        calls.append((grid, str(device)))
        return samples

    monkeypatch.setattr(cal, "run_calibration", fake)
    path = tmp_path / "c.json"
    assert cal.get_cost_model("off", path, device="cpu") is None and not calls
    m1 = cal.get_cost_model("auto", path, grid="tiny", device="cpu")
    assert calls == [("tiny", "cpu")] and path.exists()
    m2 = cal.get_cost_model("auto", path, grid="tiny", device="cpu")
    assert calls == [("tiny", "cpu")] and m2.to_json() == m1.to_json()
    cal.get_cost_model("force", path, grid="tiny", device="cpu")
    assert len(calls) == 2
    with pytest.raises(ValueError, match="auto/force/off"):
        cal.get_cost_model("sometimes", path, device="cpu")
    monkeypatch.setattr(cal, "DEFAULT_CALIB_PATH", str(tmp_path / "default.json"))
    cal.get_cost_model("auto", None, device="cpu")
    assert (tmp_path / "default.json").exists()
    assert cal.DEFAULT_CALIB_PATH.endswith("default.json")


def test_default_path_names_the_port():
    assert cal.DEFAULT_CALIB_PATH.endswith(".cache/repro_torch/calibration.json")
    assert cal.DEFAULT_CALIB_PATH != jcal.DEFAULT_CALIB_PATH


def test_real_tiny_calibration_on_the_plain_ops(tmp_path):
    """The port's dispatchers on the CPU (their plain versions): a sample for
    every priced op at every grid point, a monotone fit, a loadable file."""
    logs = []
    samples = cal.run_calibration("tiny", log=logs.append, device="cpu")
    g = cal.GRIDS["tiny"]
    sparse = len(g["ns"]) * len(g["ds"])
    want = {"gather_pool": sparse, "dedup_adagrad": sparse, "tier_probe": sparse,
            "gather_project": sparse, "wire_a2a": len(g["wire_kb"]),
            "wire_ag": len(g["wire_kb"]), "dense_matmul": len(g["mm"])}
    assert {op: len(v) for op, v in samples.items()} == want
    assert all(y > 0 for v in samples.values() for _, y in v)
    model = cal.fit_cost_model(samples, device="cpu")
    for c in model.curves.values():
        assert np.all(np.diff(c.ys) >= 0) and np.all(np.diff(c.xs) > 0)
    cal.save_calibration(tmp_path / "c.json", samples, model, device="cpu")
    assert cal.load_calibration(tmp_path / "c.json", device="cpu").to_json() == model.to_json()
    assert "calibrated 7 ops" in logs[0]
    with pytest.raises(ValueError, match="unknown calibration grid"):
        cal.run_calibration("huge", device="cpu")


def test_replanner_feedback_matches_reference(mesh1):
    """A synthetic model and injected step times over 8 deepfm-smoke steps
    with a replan every 4 (``--strategy auto``): each ``ReplanEvent``'s
    measured, predicted and correction values, the model's correction and
    the mix equal the reference's."""
    gb = 32
    kw = dict(hot_bytes=1 << 14, flush_iters=5, warmup_iters=2)
    jcfg, cfg = jget_config("deepfm", smoke=True), get_config("deepfm", smoke=True)
    jplan, plan = jmake_plan(jcfg, 1, gb, **kw), make_plan(cfg, 1, gb, **kw)
    jm, m = _models({"wire_a2a": 2e-3, "gather_pool": 5e-4}, fixed_us=3.0)
    jassign.maybe_compile(jplan, "auto", cost_model=jm)
    assign.maybe_compile(plan, "auto", cost_model=m)
    assert plan.strategy == jplan.strategy
    jmodel, model = JWDLModel(jcfg, jplan), WDLModel(cfg, plan)
    jstate = jinit_state(jmodel, jplan, jax.random.PRNGKey(0), mesh=mesh1, axes=AXES)
    state = init_state(model, plan, torch.Generator().manual_seed(0), "cpu")
    jstep, _ = jmake_train_step(jmodel, jplan, mesh1, AXES, gb, JTrainConfig(strategy="mixed"))
    step = make_train_step(model, plan, gb, TrainConfig(strategy="mixed"), "cpu")
    jrp = JReplanner(jplan, mesh1, AXES, strategy="auto", cost_model=jm, rebudget=False)
    rp = Replanner(plan, strategy="auto", cost_model=m, rebudget=False)
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    for i in range(1, 9):
        raw, jraw = make_batch(cfg, gb, rng), jmake_batch(jcfg, gb, jrng)
        jb = jax.device_put(jraw, to_named(mesh1, batch_specs(jraw, AXES)))
        jstate, jmet = jstep(jstate, jb)
        state, met = step(state, raw)
        jrp.observe(jmet)
        rp.observe(met)
        t = 1000.0 + 37.5 * i * i
        jrp.observe_timing(t)
        rp.observe_timing(t)
        if i % 4 == 0:
            jout, out = jrp.maybe_replan(jstate, step=i), rp.maybe_replan(state, step=i)
            assert (jout is None) == (out is None)
            if out is not None:
                jplan, jstate = jout
                plan, state = out
                jstep, _ = jmake_train_step(JWDLModel(jcfg, jplan), jplan, mesh1, AXES, gb,
                                            JTrainConfig(strategy="mixed"))
                step = make_train_step(WDLModel(cfg, plan), plan, gb,
                                       TrainConfig(strategy="mixed"), "cpu")
    assert len(rp.events) == len(jrp.events) == 2
    for ev, jev in zip(rp.events, jrp.events):
        assert (ev.measured_us, ev.predicted_us, ev.correction) == \
            (jev.measured_us, jev.predicted_us, jev.correction)
        assert ev.correction is not None and ev.new_rev == jev.new_rev
        assert rp.plan.strategy == jrp.plan.strategy
    assert m.correction == jm.correction != 1.0
    assert "corr=" in rp.events[-1].describe()
    # without timings the window's feedback is empty, as in the reference
    assert rp._feedback({}) == (None, None, None)


_MIX = re.compile(r"^  g(\d+): (\w+) +rows=(\d+) +ids/shard=(\d+) +skew=([\d.]+)", re.M)


@pytest.mark.parametrize("launcher", ["train", "serve"])
def test_launchers_calibrate_auto_print_the_reference_mix(tmp_path, launcher):
    """The same synthetic curves saved under each package's stamp:
    ``--strategy auto --calibrate auto --calib-file`` loads them (no bench)
    and prints the reference launcher's mix."""
    jmodel, model = _models({"wire_ag": 1e3, "tier_probe": 3e-3}, fixed_us=2.0)
    # a model's own backend and interpret keys are the file's stamp
    jstamp, stamp = jcal.backend_stamp(), cal.backend_stamp("cpu")
    jmodel.backend, jmodel.interpret = jstamp["backend"], jstamp["interpret"]
    model.backend, model.interpret = stamp["backend"], stamp["interpret"]
    samples = {op: [(1.0, 1.0)] for op in cm.PRICED_OPS}
    jpath, path = tmp_path / "j.json", tmp_path / "p.json"
    jcal.save_calibration(jpath, samples, jmodel)
    cal.save_calibration(path, samples, model, device="cpu")
    common = ["--arch", "deepfm", "--smoke", "--strategy", "auto", "--calibrate", "auto"]
    # the reference's serve launcher has no --no-packing: it serves packed
    extra = (["--no-packing", "--steps", "1", "--global-batch", "32", "--log-every", "1"]
             if launcher == "train" else ["--n-requests", "2", "--batch", "32"])
    outs = []
    for pkg, p, dev in (("repro", jpath, []), ("repro_torch", path, ["--device", "cpu"])):
        r = subprocess.run([sys.executable, "-m", f"{pkg}.launch.{launcher}", *common,
                            "--calib-file", str(p), *extra, *dev],
                           capture_output=True, text=True, timeout=600,
                           env=_env(PYTHONHASHSEED="0"), cwd=str(ROOT))
        assert r.returncode == 0, r.stderr[-3000:]
        assert "loaded calibration" in r.stdout and "calibrated curves" in r.stdout, r.stdout
        outs.append(_MIX.findall(r.stdout))
    assert outs[0] and outs[0] == outs[1]
    if launcher == "train":  # the slow all_gather moves the unpacked tables off ps
        assert {s for _, s, *_ in outs[1]} != {"ps"}
