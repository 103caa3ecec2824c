"""The calibrated cost model past world 1: ``perf.get_cost_model`` and
``run_calibration`` on 4 gloo ranks (and on a 2-rank sub-group of them),
against the reference on 4 forced host devices.

- A real ``tiny`` calibration on the port's plain ops at worlds 2 and 4:
  every rank returns the same samples and fits the same model bitwise; the
  wire samples' byte counts are the reference's ``_bench_wire``'s on a
  2- and a 4-device mesh; the fitted model records the world.
- The lifecycle at world 4: a file stamped at world 1 is re-benched (rank 0
  logs the stamp mismatch, the file comes back stamped ``world: 4``) and an
  ``auto`` after it loads that file on every rank without benching.
- The launchers: ``--strategy auto --calibrate auto`` at ``--devices 4
  --mesh 2x2`` print the reference launcher's mix from one shared
  calibration file each (the same synthetic curves under each package's
  stamp), as ``tests/test_torch_perf.py`` holds them at world 1.
"""
import json
import re

import pytest
import torch

from repro.perf import calibration as jcal
from repro.perf import cost_model as jcm
from repro_torch.perf import calibration as cal
from repro_torch.perf import cost_model as cm
from test_torch_dist import W, run_port, run_reference
from test_torch_dist_stream import _run_all

torch.set_num_threads(1)

W2 = 2
GRID = "tiny"

REF_BODY = """
from repro.dist.compat import make_submesh_compat
from repro.perf import calibration as cal
g = cal.GRIDS[inp["grid"]]
it = {"iters": g["iters"], "warmup": g["warmup"]}
out["bytes"] = {}
for w in (2, 4):
    m = make_submesh_compat((w,), ("wire",))
    for kind in ("wire_a2a", "wire_ag"):
        out["bytes"][w, kind] = [cal._bench_wire(kind, kb, m, it)[0] for kb in g["wire_kb"]]
"""


def _port_calib(root, path):
    from repro_torch.runtime import make_submesh

    out = {}
    s4 = cal.run_calibration(GRID, device="cpu", group=root)
    out[4] = (s4, cal.fit_cost_model(s4, device="cpu", world=root.world).to_json())
    g2 = make_submesh((W2, 1), group=root)
    if g2 is not None:
        s2 = cal.run_calibration(GRID, device="cpu", group=g2)
        out[2] = (s2, cal.fit_cost_model(s2, device="cpu", world=g2.world).to_json())
    logs = []
    m = cal.get_cost_model("auto", path, grid=GRID, device="cpu", group=root,
                           log=logs.append)
    again = cal.get_cost_model("auto", path, grid=GRID, device="cpu", group=root,
                               log=logs.append)
    out["lifecycle"] = (m.to_json(), again.to_json(), logs)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_calib")
    path = tmp / "calib.json"
    samples = {op: [(1.0, 2.0), (100.0, 5.0)] for op in cm.PRICED_OPS}
    cal.save_calibration(path, samples, cal.fit_cost_model(samples, device="cpu"),
                         device="cpu")  # a world-1 file
    ref = run_reference(REF_BODY, {"grid": GRID}, tmp, timeout=600)
    port = run_port(_port_calib, str(path), tmp=tmp, deadline_s=300)
    return ref, port, path


@pytest.mark.parametrize("world", (W2, W))
def test_every_rank_holds_rank_0s_samples_and_one_model(runs, world):
    _, port, _ = runs
    ranks = port[:world]
    samples, model = ranks[0][world]
    g = cal.GRIDS[GRID]
    assert {op: len(v) for op, v in samples.items()} == {
        **{op: len(g["ns"]) * len(g["ds"]) for op in ("gather_pool", "dedup_adagrad",
                                                       "tier_probe", "gather_project")},
        "wire_a2a": len(g["wire_kb"]), "wire_ag": len(g["wire_kb"]),
        "dense_matmul": len(g["mm"])}
    assert all(y > 0 for v in samples.values() for _, y in v)
    assert model["meta"] == {"version": cal.CALIB_VERSION, "world": world}
    for p in ranks[1:]:
        assert p[world][0] == samples
        assert json.dumps(p[world][1], sort_keys=True) == json.dumps(model, sort_keys=True)


@pytest.mark.parametrize("world", (W2, W))
def test_wire_byte_counts_are_the_references(runs, world):
    ref, port, _ = runs
    for kind in ("wire_a2a", "wire_ag"):
        got = [x for x, _ in port[0][world][0][kind]]
        assert got == ref["bytes"][world, kind], kind


def test_a_world_1_file_is_rebenched_at_world_4_and_then_loaded(runs):
    _, port, path = runs
    m, again, logs = port[0]["lifecycle"]
    assert any("stamp mismatch" in s for s in logs), logs
    assert any(s.startswith("calibrated 7 ops") for s in logs)
    assert any(s.startswith("loaded calibration") for s in logs)
    assert all(not p["lifecycle"][2] for p in port[1:])  # rank 0 alone logs
    data = json.loads(path.read_text())
    assert (data["world"], data["backend"], data["meta"]["world"]) == (W, "torch-cpu", W)
    assert cal.load_calibration(path, device="cpu") is None  # not a world-1 file
    assert cal.load_calibration(path, device="cpu", world=W).to_json() == m
    for p in port:
        assert p["lifecycle"][0] == m and p["lifecycle"][1] == m
    assert [x for x, _ in data["samples"]["wire_ag"]] == [
        float(W * (kb * 1024 // 4 // W) * 4) for kb in cal.GRIDS[GRID]["wire_kb"]]


_MIX = re.compile(r"^  g(\d+): (\w+) +rows=(\d+) +ids/shard=(\d+) +skew=([\d.]+)", re.M)


@pytest.mark.parametrize("launcher", ["train", "serve"])
def test_launchers_calibrate_auto_at_world_4_print_the_reference_mix(tmp_path, launcher):
    per = {"wire_ag": 1e3, "tier_probe": 3e-3}
    jmodel, model = (jcm.synthetic_cost_model(per, fixed_us=2.0),
                     cm.synthetic_cost_model(per, fixed_us=2.0))
    jstamp, stamp = jcal.backend_stamp(), cal.backend_stamp("cpu", W)
    jmodel.backend, jmodel.interpret = jstamp["backend"], jstamp["interpret"]
    model.backend, model.interpret = stamp["backend"], stamp["interpret"]
    samples = {op: [(1.0, 1.0)] for op in cm.PRICED_OPS}
    jpath, path = tmp_path / "j.json", tmp_path / "p.json"
    jcal.save_calibration(jpath, samples, jmodel)
    cal.save_calibration(path, samples, model, device="cpu", world=W)
    common = ["--strategy", "auto", "--calibrate", "auto", "--devices", "4", "--mesh", "2x2"]
    # packed: the reference compiles an unpacked world-4 step for a minute
    extra = (["--steps", "1", "--global-batch", "64", "--log-every", "1"]
             if launcher == "train" else ["--n-requests", "2", "--batch", "64"])
    outs = _run_all(*[(pkg, launcher, *common, "--calib-file", str(p), *extra)
                      for pkg, p in (("repro", jpath), ("repro_torch", path))])
    mixes = []
    for _, so, _ in outs:
        assert so.count("loaded calibration") == 1 and "calibrated curves" in so, so
        mixes.append(_MIX.findall(so))
    assert mixes[0] and mixes[0] == mixes[1]
    assert json.loads(path.read_text())["world"] == W  # loaded, not rewritten
