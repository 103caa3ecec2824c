"""Training, serving, retrieval and the launchers at world 4 against the
reference on 4 forced host devices (mesh 2x2).

Training: deepfm-smoke, global batch 64 (16 a rank), a tiny hot tier
flushed at step 3, 8 steps under ``cache_update='psum'`` and ``'stale'``.
The reference's 8 states are carried to the port's 4 ranks (each takes its
rows, ``train_state_from_jax(..., group=)``) and every port step starts
from the reference's state before that step, held to its state after it at
the training bars of ``tests/test_torch_train.py``: losses to rtol 1e-4 /
atol 1e-5, hits and overflow exactly, the FCounter and tier keys bitwise,
the floats (masters, tiers, dense parameters, Adam moments) to atol 1e-4. Serving: one request on the
trained state, probabilities within 1e-5. Retrieval: sasrec-smoke, 4,096
candidates in chunks of 300 a rank, ids equal and scores within 1e-5.
Launchers: both at ``--devices 4 --mesh 2x2`` print ``world=4`` and the
backend and agree with themselves at world 1; ``--replan-iters``,
``--calibrate`` and ``--pin-l2`` run past world 1 and print the reference
launcher's lines from its world-4 checkpoint or delta.
"""
import os
import re
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data.synthetic import make_batch as jmake_batch
from test_torch_dist import HASH_SEED, ROOT, W, run_port, run_reference
from test_torch_dist_stream import LOSS, TRAIN, _run, _run_all, flag_checks, ref_ckpt  # noqa: F401

torch.set_num_threads(1)

GB = 64
STEPS = 8
MODES = ("psum", "stale")
N_CAND = 4096
CHUNK = 300

REF_BODY = """
from repro.configs import get_config
from repro.core.packing import make_plan
from repro.dist.sharding import batch_specs, to_named
from repro.models.wdl import WDLModel
from repro.serve.serve_step import ServeConfig, make_retrieval_step, make_serve_step
from repro.train.train_step import TrainConfig, init_state, make_train_step
from jax.sharding import NamedSharding
GB, STEPS = inp["GB"], inp["STEPS"]


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
plan = make_plan(cfg, W, GB // W, hot_bytes=1 << 14, flush_iters=3, warmup_iters=2,
                 mesh_shape=(2, 2))
model = WDLModel(cfg, plan)
put = lambda b: jax.device_put(b, to_named(mesh, batch_specs(b, AXES)))
for mode in ("psum", "stale"):
    state = init_state(model, plan, jax.random.PRNGKey(0), mesh=mesh, axes=AXES)
    step, _ = make_train_step(model, plan, mesh, AXES, GB,
                              TrainConfig(use_fused_kernels="off", cache_update=mode),
                              donate=False)
    states, mets = [np_train(state)], []
    for b in inp["batches"]:
        state, m = step(state, put(b))
        states.append(np_train(state))
        mets.append({k: np.asarray(v) for k, v in m.items()})
    out[mode] = {"states": states, "mets": mets}
    if mode == "psum":
        serve = make_serve_step(model, plan, mesh, AXES, GB,
                                scfg=ServeConfig(use_fused_kernels="off"))
        out["probs"] = np.asarray(serve({"emb": state["emb"], "dense": state["dense"]},
                                        put(inp["request"])))

scfg = get_config("sasrec", smoke=True)
splan = make_plan(scfg, world=W, per_device_batch=1, enable_cache=False,
                  exact_capacity=True)
smodel = WDLModel(scfg, splan)
sstate = init_state(smodel, splan, jax.random.PRNGKey(0), mesh=mesh, axes=AXES)
rstep = make_retrieval_step(smodel, splan, mesh, AXES, inp["n_cand"], top_k=10,
                            scfg=ServeConfig(use_cache=False, use_fused_kernels="off"),
                            score_chunk=inp["chunk"])
cand = jax.device_put(jnp.arange(inp["n_cand"], dtype=jnp.int32), NamedSharding(mesh, P(AXES)))
sc, ids = rstep(sstate, inp["user"], cand)
out["retrieval"] = {"scores": np.asarray(sc), "ids": np.asarray(ids),
                    "state": np_train({**sstate, "opt": {}, "step": 0})}
"""


def _ns_state(st):
    """A reference train state (plain numpy) as ``train_state_from_jax``
    reads it."""
    return {**st, "emb": {k: types.SimpleNamespace(**v) for k, v in st["emb"].items()}}


def _rank_state(state):
    """A rank's train state as numpy: its master rows, its replicas."""
    def tier(t):
        return None if t is None else tuple(x.numpy().copy() for x in t)
    from repro_torch.optim.optimizers import tree_leaves

    return {"emb": {k: {"w": s.w.numpy().copy(), "acc": s.acc.numpy().copy(),
                        "counts": s.counts.numpy().copy(), "cache": tier(s.cache)}
                    for k, s in state["emb"].items()},
            "dense": [x.numpy().copy() for x in tree_leaves(state["dense"])],
            "m": [x.numpy().copy() for x in tree_leaves(state["opt"]["m"])],
            "v": [x.numpy().copy() for x in tree_leaves(state["opt"]["v"])],
            "t": int(state["opt"]["t"]), "step": state["step"]}


def _port_train(group, ref, batches, request, user):
    from repro_torch.configs import get_config
    from repro_torch.convert import state_from_jax, train_state_from_jax
    from repro_torch.core.packing import make_plan
    from repro_torch.models.wdl import WDLModel
    from repro_torch.serve.serve_step import (ServeConfig, make_retrieval_step,
                                              make_serve_step)
    from repro_torch.train.train_step import TrainConfig, make_train_step

    cfg = get_config("deepfm", smoke=True)
    plan = make_plan(cfg, W, GB // W, hot_bytes=1 << 14, flush_iters=3, warmup_iters=2,
                     mesh_shape=(2, 2))
    model = WDLModel(cfg, plan)
    out = {}
    for mode in MODES:
        step = make_train_step(model, plan, GB,
                               TrainConfig(use_fused_kernels="off", cache_update=mode),
                               "cpu", group=group)
        steps = []
        for i, b in enumerate(batches):
            state = train_state_from_jax(_ns_state(ref[mode]["states"][i]), plan, "cpu",
                                         group=group)
            state, m = step(state, b)
            steps.append({"state": _rank_state(state),
                          "met": {k: (v if isinstance(v, int) else v.numpy().copy())
                                  for k, v in m.items()}})
        out[mode] = steps
    final = ref["psum"]["states"][-1]
    emb, dense = state_from_jax(_ns_state(final)["emb"], final["dense"], plan, "cpu",
                                group=group)
    serve = make_serve_step(model, plan, GB, ServeConfig(use_fused_kernels="off"), "cpu",
                            group=group)
    out["probs"] = serve({"emb": emb, "dense": dense}, request).numpy()

    scfg = get_config("sasrec", smoke=True)
    splan = make_plan(scfg, world=W, per_device_batch=1, enable_cache=False,
                      exact_capacity=True)
    smodel = WDLModel(scfg, splan)
    rs = ref["retrieval"]["state"]
    semb, sdense = state_from_jax(_ns_state(rs)["emb"], rs["dense"], splan, "cpu",
                                  group=group)
    rstep = make_retrieval_step(smodel, splan, N_CAND, top_k=10,
                                scfg=ServeConfig(use_cache=False, use_fused_kernels="off"),
                                score_chunk=CHUNK, device="cpu", group=group)
    sc, ids = rstep({"emb": semb, "dense": sdense}, user,
                    torch.arange(N_CAND, dtype=torch.int32))
    out["retrieval"] = {"scores": sc.numpy(), "ids": ids.numpy()}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_train")
    cfg = jget_config("deepfm", smoke=True)
    rng = np.random.default_rng(0)
    batches = [jmake_batch(cfg, GB, rng) for _ in range(STEPS)]
    request = jmake_batch(cfg, GB, np.random.default_rng(11))
    user = jmake_batch(jget_config("sasrec", smoke=True), 1, np.random.default_rng(1))
    ref = run_reference(REF_BODY, {"GB": GB, "STEPS": STEPS, "batches": batches,
                                   "request": request, "user": user, "n_cand": N_CAND,
                                   "chunk": CHUNK}, tmp, timeout=900)
    port = run_port(_port_train, {m: ref[m] for m in MODES + ("retrieval",)}, batches,
                    request, user, tmp=tmp)
    return ref, port


def _leaves(tree):
    import jax

    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("i", range(STEPS))
def test_train_step_from_a_shared_state_meets_the_bars(runs, mode, i):
    ref, port = runs
    exp = ref[mode]["states"][i + 1]
    jm = ref[mode]["mets"][i]
    for r, p in enumerate(port):
        m = p[mode][i]["met"]
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-5)
        assert (int(m["cache_hits"]), int(m["overflow"]), m["step"]) == (
            int(jm["cache_hits"]), int(jm["overflow"]), int(jm["step"])), r
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4, atol=1e-5)
    for key, est in exp["emb"].items():
        for leaf in ("w", "acc", "counts"):
            got = np.concatenate([p[mode][i]["state"]["emb"][key][leaf] for p in port])
            if leaf == "counts":
                np.testing.assert_array_equal(got, est[leaf])
            else:
                np.testing.assert_allclose(got, est[leaf], atol=1e-4, rtol=0)
        for p in port:
            keys, rows, acc = p[mode][i]["state"]["emb"][key]["cache"]
            np.testing.assert_array_equal(keys, est["cache"][0])
            np.testing.assert_allclose(rows, est["cache"][1], atol=1e-4, rtol=0)
            np.testing.assert_allclose(acc, est["cache"][2], atol=1e-4, rtol=0)
    for part, jtree in (("dense", exp["dense"]), ("m", exp["opt"]["m"]),
                        ("v", exp["opt"]["v"])):
        jl = _leaves(jtree)
        for p in port:
            got = p[mode][i]["state"][part]
            assert len(got) == len(jl)
            for a, b in zip(got, jl):
                np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    assert all(p[mode][i]["state"]["t"] == int(exp["opt"]["t"]) for p in port)


def test_training_took_hits_after_the_flush_and_replicas_agree(runs):
    ref, port = runs
    for mode in MODES:
        hits = [int(m["cache_hits"]) for m in ref[mode]["mets"]]
        assert all(h == 0 for h in hits[:3]) and all(h > 0 for h in hits[3:]), hits
        for i in range(STEPS):
            st0 = port[0][mode][i]["state"]
            for p in port[1:]:
                st = p[mode][i]["state"]
                for a, b in zip(st["dense"] + st["m"] + st["v"],
                                st0["dense"] + st0["m"] + st0["v"]):
                    assert a.tobytes() == b.tobytes()
                for key in st["emb"]:
                    for a, b in zip(st["emb"][key]["cache"], st0["emb"][key]["cache"]):
                        assert a.tobytes() == b.tobytes()


def test_serving_probabilities_match_reference(runs):
    ref, port = runs
    got = np.concatenate([p["probs"] for p in port])
    np.testing.assert_allclose(got, ref["probs"], atol=1e-5, rtol=0)


def test_retrieval_ids_match_reference(runs):
    """Each rank's local top-k of its 1,024 candidates (chunks of 300, the
    last ragged), all_gathered and merged: the reference's ids, every rank
    the same."""
    ref, port = runs
    for p in port:
        np.testing.assert_array_equal(p["retrieval"]["ids"], ref["retrieval"]["ids"])
        np.testing.assert_allclose(p["retrieval"]["scores"], ref["retrieval"]["scores"],
                                   atol=1e-5, rtol=0)


# ---------------------------------------------------------------- launchers
def _launch(module, *flags):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PYTHONHASHSEED=HASH_SEED,
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", f"repro_torch.launch.{module}",
                           "--arch", "deepfm", "--smoke", "--device", "cpu", *flags],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_train_launcher_at_world_4_matches_world_1():
    """``--devices 4 --mesh 2x2`` prints ``world=4`` and its backend first;
    its losses are the world-1 run's to the 4 printed decimals (the ranks'
    tables and dense parameters are the world-1 draw, the padding rows
    zero; what differs is float summation order), within 2e-4."""
    flags = ("--steps", "2", "--global-batch", "64", "--log-every", "1")
    w4 = _launch("train", *flags, "--devices", "4", "--mesh", "2x2")
    w1 = _launch("train", *flags)
    first = w4.splitlines()[0]
    assert "world=4" in first and "mesh=2x2" in first and "backend=gloo" in first, w4
    assert "world=4" in w4.splitlines()[1] and "[train] done" in w4
    l4 = [float(x) for x in re.findall(r"loss=([\d.]+)", w4)]
    l1 = [float(x) for x in re.findall(r"loss=([\d.]+)", w1)]
    assert len(l4) == len(l1) == 2
    np.testing.assert_allclose(l4, l1, atol=2e-4, rtol=0)


def test_serve_launcher_at_world_4_matches_world_1():
    flags = ("--batch", "64", "--n-requests", "2")
    w4 = _launch("serve", *flags, "--devices", "4", "--mesh", "2x2")
    w1 = _launch("serve", *flags)
    assert "world=4" in w4.splitlines()[0] and "backend=gloo" in w4.splitlines()[0], w4
    p4 = re.findall(r"mean_prob=([\d.]+)", w4)
    assert p4 and p4 == re.findall(r"mean_prob=([\d.]+)", w1)


@pytest.mark.parametrize("module,flag", [("train", "--replan-iters=5"),
                                         ("train", "--calibrate=auto"),
                                         ("train", "--pin-l2"), ("serve", "--pin-l2"),
                                         ("serve", "--calibrate=auto"),
                                         ("train", "--reshard-to=2 --replan-iters=5")])
def test_launchers_refuse_waiting_flags_past_world_1(ref_ckpt, tmp_path, module, flag):
    """(The name is kept from when these flags refused past world 1.) Each
    runtime flag runs past world 1 and prints the reference launcher's
    lines: the trainers resume the reference's world-4 checkpoint of step 2
    (at ``--devices 4 --mesh 2x2``, or at world 1 with ``--reshard-to 2``
    taking the run to world 2 at the step-5 boundary) and print the same
    losses and replan, reshard and elastic lines; the servers load the
    reference's step-2 delta at ``--devices 4`` and print its mean_prob.
    ``--replan-iters`` shrinks the hot tier at step 5 (rev 0 -> 1) and a
    resume of the run's directory at world 4 follows revision 1.
    ``--pin-l2`` is held to the reference unpinned (its own ``--pin-l2``
    fails on this CPU)."""
    mine = flag.split()
    replan = ["--replan-hot-bytes", "16384"] if "--replan-iters=5" in mine else []
    world = (["--devices", "2", "--mesh", "1x1"] if "--reshard-to=2" in mine
             else ["--devices", "4", "--mesh", "2x2"])
    tags = (("repro_torch", "port"), ("repro", "ref"))

    def flags(pkg, tag):
        calib = (["--calib-file", str(tmp_path / f"{tag}.json")]
                 if "--calibrate=auto" in mine else [])
        return [*world, *replan, *calib,
                *(f for f in mine if pkg == "repro_torch" or f != "--pin-l2")]

    if module == "train":
        for _, tag in tags:
            shutil.copytree(ref_ckpt / "ck", tmp_path / f"{tag}_ck")
        runs = _run_all(*[(pkg, "train", *TRAIN, "--steps", "8" if replan else "4",
                           "--ckpt-dir", str(tmp_path / f"{tag}_ck"), *flags(pkg, tag))
                          for pkg, tag in tags])
        port, ref = (r[1] for r in runs)
        losses = re.findall(LOSS, port, re.M)
        assert losses and losses == re.findall(LOSS, ref, re.M)
        heads = ("[train] replan", "[train] reshard", "[train] elastic", "[train] done")
        lines = [[ln for ln in text.splitlines() if ln.startswith(heads)]
                 for text in (port, ref)]
        assert lines[0] == lines[1] and lines[1][-1] == "[train] done"
        if replan:
            assert ("[train] replan step 5: plan rev 0 -> 1, migrated 1 group(s) "
                    "[g0: L1 4808->416]  [cache_hits=0 overflow=0]") in lines[1]
            assert "[train] replans: 1 attempted, 1 migrated, final plan rev=1" in lines[1]
        if "--reshard-to=2" in mine:
            assert "[train] reshard world 1 -> 2 (mesh 2x1) at step 5" in lines[1]
        elif replan:
            again = _run("repro_torch", "train", *TRAIN, "--steps", "10", "--ckpt-dir",
                         str(tmp_path / "port_ck"), *flags("repro_torch", "port"))
            assert "[train] resumed plan rev 1 from checkpoint meta" in again
    else:
        runs = _run_all(*[(pkg, "serve", "--batch", "64", "--n-requests", "2",
                           "--reload-dir", str(ref_ckpt / "pub"), *flags(pkg, tag))
                          for pkg, tag in tags])
        port, ref = (r[1] for r in runs)
        mean = r"mean_prob=(\d\.\d{3})$"
        assert re.findall(mean, port, re.M) == re.findall(mean, ref, re.M) != []
        for text in (port, ref):
            assert re.findall(r"reloaded published step (\d+)", text) == ["2"]
    flag_checks(port, mine, tmp_path / "port.json")


def test_reshard_flags_refuse():
    """``--reshard-to``/``--reshard-at`` run (they refused before
    ``runtime/elastic.py``): world 1 -> 2 -> ... here 1 -> 2 on two ranks,
    the second a spare until step 2, and the losses of steps 1-2 the world-1
    run's; ``--reshard-at`` alone and a ``--devices`` count the two meshes
    do not need are refused as usage errors."""
    from repro_torch.launch import train

    up = _launch("train", "--steps", "4", "--global-batch", "64", "--log-every", "1",
                 "--reshard-to", "2", "--reshard-at", "2")
    w1 = _launch("train", "--steps", "2", "--global-batch", "64", "--log-every", "1")
    assert "world=1" in up.splitlines()[0] and "processes=2" in up.splitlines()[0], up
    assert "[train] reshard world 1 -> 2 (mesh 2x1) at step 2" in up
    pat = r"^  step +(\d+) loss=(\S+) .*$"
    got = re.findall(pat, up, re.M)
    assert [s for s, _ in got] == ["1", "2", "3", "4"] and got[:2] == re.findall(pat, w1, re.M)
    assert up.rstrip().endswith("[train] done")
    for argv in (["--reshard-at", "3"], ["--devices", "3", "--mesh", "2x1", "--reshard-to",
                                         "2x2"]):
        with pytest.raises(SystemExit):
            train.main(["--smoke", "--device", "cpu", *argv])
