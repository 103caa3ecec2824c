"""The elastic reshard past world 1: 4 gloo ranks against the reference on 4
forced host devices (``tests/test_distributed.py``'s elastic parity case,
at 4 and 2 devices).

The config is ``tests/test_elastic.py``'s three packed groups (dims 4, 8
and 16) under one mixed plan (``picasso``, ``picasso_l2``,
``picasso_narrow``), global batch 32. The reference trains 2 steps at world
4 (mesh 2x2; the flush at step 2 fills both tiers), reshards live to world
2 (mesh 2x1), trains 3 steps, reshards back to world 4 and trains 3 more;
it also checkpoints the world-4 state and restores it at worlds 2 and 1.
The port starts from the reference's world-4 state (each rank its rows):

- its live 4 -> 2 (ranks 2 and 3 leave and wait) gathers bitwise to the
  reference's world-2 state, and its 2 -> 4 from the reference's world-2
  state (ranks 2 and 3 join as spares) bitwise to its world-4 state; the
  dim-8 group's padding shrinks from 1,004 rows to 1,002 and grows back;
- 3 steps after each reshard, each from the reference's state before it,
  meet the training bars of ``tests/test_torch_train.py``;
- world-4 checkpoints written by either package restore at world 2 (two
  ranks) and at world 1 (this process) bitwise the reference's recut;
- FCounter mass in a padding row that 4 -> 2 drops raises on every rank,
  live and from a checkpoint, before anything is written or moved;
- the launcher at ``--devices 4 --mesh 2x2 --reshard-to 2x1 --reshard-at 3``
  prints the reference's reshard line and losses, and a resume of its
  directory at another world goes through ``restore_elastic``.
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

from repro.configs.base import FeatureField as JFeatureField
from repro.configs.base import InteractionSpec as JInteractionSpec
from repro.configs.base import WDLConfig as JWDLConfig
from repro.data.synthetic import make_batch as jmake_batch
from test_torch_dist import HASH_SEED, ROOT, W, ref_env, run_port, run_reference

torch.set_num_threads(1)

GB = 32
W2 = 2
PRE_STEPS = 2   # at world 4 before the first reshard (the flush at step 2)
STEPS = 3       # after each reshard
MIX = {0: "picasso", 1: "picasso_l2", 2: "picasso_narrow"}
PLAN_KW = dict(hot_bytes=1 << 12, l2_bytes=1 << 13, narrow_dim=4, flush_iters=2,
               warmup_iters=1)
TAIL_GID_DIM = 8   # the 1,001-row group: padded to 1,004 at world 4, 1,002 at 2

REF_BODY = """
from repro.configs.base import FeatureField, InteractionSpec, WDLConfig
from repro.core.assign import apply_assignment
from repro.core.packing import make_plan, reshard_plan
from repro.dist.sharding import batch_specs, to_named
from repro.models.wdl import WDLModel
from repro.runtime import make_submesh, plan_meta, reshard_live, restore_elastic
from repro.train import checkpoint as ck
from repro.train.train_step import TrainConfig, init_state, make_train_step
GB = inp["GB"]
fields = (FeatureField("a", 1001, 8, max_len=2), FeatureField("b", 515, 16, max_len=1),
          FeatureField("c", 259, 4, max_len=3))
cfg = WDLConfig(name="elastic3", fields=fields, n_dense=0,
                interactions=(InteractionSpec("fm"),), mlp_dims=(16, 8))


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


def seg(plan, m, state, batches):
    step, _ = make_train_step(WDLModel(cfg, plan), plan, m, AXES, GB,
                              TrainConfig(strategy="mixed", use_fused_kernels="off"),
                              donate=False)
    states, mets = [np_train(state)], []
    for b in batches:
        state, met = step(state, jax.device_put(b, to_named(m, batch_specs(b, AXES))))
        states.append(np_train(state))
        mets.append({k: np.asarray(v) for k, v in met.items()})
    return state, states, mets


plan4 = make_plan(cfg, world=4, per_device_batch=GB // 4, mesh_shape=(2, 2), **inp["plan_kw"])
apply_assignment(plan4, dict(inp["mix"]))
state = init_state(WDLModel(cfg, plan4), plan4, jax.random.PRNGKey(0), mesh=mesh, axes=AXES)
state, _, _ = seg(plan4, mesh, state, inp["pre"])
out["A"] = np_train(state)
host = jax.device_get(state)
ck.save_checkpoint(inp["ref_dir"], PRE, host, meta=plan_meta(plan4))

mesh2 = make_submesh((2, 1), AXES)
plan2, state = reshard_live(plan4, state, 2, GB // 2, mesh=mesh2, axes=AXES,
                            mesh_shape=(2, 1))
out["plan2_rows"] = [g.rows for g in plan2.groups]
state, out["B"], out["B_mets"] = seg(plan2, mesh2, state, inp["b2"])
plan4b, state = reshard_live(plan2, state, 4, GB // 4, mesh=mesh, axes=AXES,
                             mesh_shape=(2, 2))
state, out["D"], out["D_mets"] = seg(plan4b, mesh, state, inp["b4"])

# the world-4 checkpoint restored at worlds 2 and 1 by the reference
tmpl2 = init_state(WDLModel(cfg, plan2), plan2, jax.random.PRNGKey(7), mesh=mesh2, axes=AXES)
out["R2"] = np_train(restore_elastic(inp["ref_dir"], plan2, tmpl2, mesh=mesh2, axes=AXES)[0])
plan1 = reshard_plan(plan4, 1, GB, mesh_shape=(1, 1))
tmpl1 = jax.device_get(init_state(WDLModel(cfg, plan1), plan1, jax.random.PRNGKey(7)))
out["R1"] = np_train(restore_elastic(inp["ref_dir"], plan1, tmpl1)[0])
""".replace("PRE", str(PRE_STEPS))


def _cfg():
    from repro_torch.configs.base import FeatureField, InteractionSpec, WDLConfig

    fields = (FeatureField("a", 1001, 8, max_len=2), FeatureField("b", 515, 16, max_len=1),
              FeatureField("c", 259, 4, max_len=3))
    return WDLConfig(name="elastic3", fields=fields, n_dense=0,
                     interactions=(InteractionSpec("fm"),), mlp_dims=(16, 8))


def _plan4():
    from repro_torch.core.assign import apply_assignment
    from repro_torch.core.packing import make_plan

    plan = make_plan(_cfg(), world=W, per_device_batch=GB // W, mesh_shape=(2, 2), **PLAN_KW)
    apply_assignment(plan, dict(MIX))
    return plan


def _ns(st):
    """A reference train state (plain numpy) as ``train_state_from_jax``
    reads it."""
    return {**st, "emb": {k: types.SimpleNamespace(**v) for k, v in st["emb"].items()}}


def _np(state):
    """A rank's state as ``{leaf name: numpy}`` (host ints as they are)."""
    from repro_torch.train.checkpoint import _flatten

    return {k: (v.numpy().copy() if isinstance(v, torch.Tensor) else v)
            for k, v in _flatten(state).items()}


def _tail_gid(plan):
    return next(g.gid for g in plan.groups if g.dim == TAIL_GID_DIM)


def _steps(group, plan, ref_states, batches):
    """One step from each of the reference's states before it: this rank's
    metrics and state after it."""
    from repro_torch.convert import train_state_from_jax
    from repro_torch.models.wdl import WDLModel
    from repro_torch.train.train_step import TrainConfig, make_train_step

    step = make_train_step(WDLModel(_cfg(), plan), plan, GB,
                           TrainConfig(strategy="mixed", use_fused_kernels="off"), "cpu",
                           group=group)
    out = []
    for i, b in enumerate(batches):
        state = train_state_from_jax(_ns(ref_states[i]), plan, "cpu", group=group)
        state, m = step(state, b)
        out.append({"state": _np(state),
                    "met": {k: (v if isinstance(v, int) else float(v)) for k, v in m.items()
                            if k in ("loss", "cache_hits", "overflow", "grad_norm")}})
    return out


def _port_elastic(group, ref, b2, b4, root):
    from repro_torch.convert import train_state_from_jax
    from repro_torch.core.packing import reshard_plan
    from repro_torch.models.wdl import WDLModel
    from repro_torch.runtime import plan_meta, reshard_live, restore_elastic
    from repro_torch.runtime.elastic import wait_for_reshard
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.train_step import init_state

    plan4 = _plan4()
    out = {}
    a = train_state_from_jax(_ns(ref["A"]), plan4, "cpu", group=group)
    port_dir = os.path.join(root, "port_ckpt")
    ck.save_checkpoint(port_dir, PRE_STEPS, a, meta=plan_meta(plan4), group=group)

    # FCounter mass in a padding row that 4 -> 2 drops (rank 3 holds it)
    gid = _tail_gid(plan4)
    bad = dict(a["emb"])
    st = bad[str(gid)]
    counts = st.counts.clone()
    if group.rank == W - 1:
        counts[-1] = 3
    bad[str(gid)] = st._replace(counts=counts)
    try:
        reshard_live(plan4, {**a, "emb": bad}, W2, GB // W2, group=group, mesh_shape=(2, 1))
        out["tail_live"] = None
    except ValueError as e:
        out["tail_live"] = str(e)
    bad_dir = os.path.join(root, "bad_ckpt")
    ck.save_checkpoint(bad_dir, 1, {**a, "emb": bad}, meta=plan_meta(plan4), group=group)

    # live 4 -> 2: ranks 2 and 3 leave
    plan2, s2, g2 = reshard_live(plan4, a, W2, GB // W2, group=group, mesh_shape=(2, 1))
    out["plan2_rows"] = [g.rows for g in plan2.groups]
    out["B0"] = _np(s2) if s2 is not None else None
    if g2 is not None:
        out["steps2"] = _steps(g2, plan2, ref["B"], b2)
        model2 = WDLModel(_cfg(), plan2)
        out["R2"] = {}
        for name, d in (("port", port_dir), ("ref", ref["ref_dir"])):
            tmpl = init_state(model2, plan2, torch.Generator().manual_seed(7), "cpu",
                              group=g2)
            st2, s = restore_elastic(d, plan2, tmpl, group=g2)
            out["R2"][name] = (_np(st2), s)
        for mode in ("keep", "repad"):
            tmpl = init_state(model2, plan2, torch.Generator().manual_seed(7), "cpu",
                              group=g2)
            got, _ = ck.restore_checkpoint(port_dir, tmpl, on_row_mismatch=mode, group=g2)
            out[mode] = _np(got)
        tmpl = init_state(model2, plan2, torch.Generator().manual_seed(7), "cpu", group=g2)
        try:
            restore_elastic(bad_dir, plan2, tmpl, group=g2)
            out["tail_ckpt"] = None
        except ValueError as e:
            out["tail_ckpt"] = str(e)
            out["tail_ckpt_untouched"] = all(
                np.array_equal(v, _np(init_state(model2, plan2,
                                                 torch.Generator().manual_seed(7), "cpu",
                                                 group=g2))[k])
                for k, v in _np(tmpl).items() if not isinstance(v, int))
        # 2 -> 4 from the reference's world-2 state: ranks 2 and 3 join
        c = train_state_from_jax(_ns(ref["B"][-1]), plan2, "cpu", group=g2)
        plan4b, s4, g4 = reshard_live(plan2, c, W, GB // W, group=g2, mesh_shape=(2, 2))
    else:
        ev = wait_for_reshard()
        out["event"] = {k: ev[k] for k in ("world", "mesh_shape")}
        plan4b, s4, g4 = reshard_live(plan2, None, ev["world"], GB // ev["world"],
                                      mesh_shape=ev["mesh_shape"], device="cpu")
    out["D0"] = _np(s4)
    out["world4"] = (g4.rank, g4.world)
    out["steps4"] = _steps(g4, plan4b, ref["D"], b4)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_elastic")
    jcfg = JWDLConfig(name="elastic3", fields=(JFeatureField("a", 1001, 8, max_len=2),
                                               JFeatureField("b", 515, 16, max_len=1),
                                               JFeatureField("c", 259, 4, max_len=3)),
                      n_dense=0, interactions=(JInteractionSpec("fm"),), mlp_dims=(16, 8))
    rng = np.random.default_rng(10)
    pre = [jmake_batch(jcfg, GB, rng) for _ in range(PRE_STEPS)]
    b2 = [jmake_batch(jcfg, GB, rng) for _ in range(STEPS)]
    b4 = [jmake_batch(jcfg, GB, rng) for _ in range(STEPS)]
    ref_dir = str(tmp / "ref_ckpt")
    ref = run_reference(REF_BODY, {"GB": GB, "plan_kw": PLAN_KW, "mix": MIX, "pre": pre,
                                   "b2": b2, "b4": b4, "ref_dir": ref_dir}, tmp, timeout=900)
    ref["ref_dir"] = ref_dir
    port = run_port(_port_elastic, ref, b2, b4, str(tmp), tmp=tmp, deadline_s=600)
    return ref, port, tmp


def _gathered(ranks, key):
    """The logical state of the ranks' ``key`` states: row-sharded leaves
    concatenated in rank order, the replicas rank 0's (and all alike)."""
    out = {}
    for name in ranks[0][key]:
        vals = [r[key][name] for r in ranks]
        if re.fullmatch(r"emb/\d+/(w|acc|counts)", name):
            out[name] = np.concatenate(vals)
        else:
            for v in vals[1:]:
                assert _same(v, vals[0]), (name, "replicas differ")
            out[name] = vals[0]
    return out


def _same(a, b):
    if isinstance(a, int) or isinstance(b, int) or np.ndim(a) == 0:
        return int(a) == int(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _ref_leaves(st):
    """A reference state (np_train's dicts) as ``{leaf name: numpy}`` in the
    port's leaf names."""
    out = {}
    for gid, e in st["emb"].items():
        for leaf in ("w", "acc", "counts"):
            out[f"emb/{gid}/{leaf}"] = e[leaf]
        for tier, fields in (("cache", ("keys", "rows", "acc")), ("l2", ("keys", "rows", "acc")),
                             ("proj", ("kernel", "acc"))):
            if e[tier] is not None:
                for f, v in zip(fields, e[tier]):
                    out[f"emb/{gid}/{tier}/{f}"] = v

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}", v)
        else:
            out[prefix] = np.asarray(node)

    walk("dense", st["dense"])
    walk("opt", st["opt"])
    out["step"] = int(np.asarray(st["step"]))
    return out


def _bitwise(got, exp):
    assert sorted(got) == sorted(exp), (sorted(set(got) ^ set(exp)))
    for k in exp:
        assert _same(got[k], exp[k]), k


def test_live_scale_down_is_bitwise_the_reference(runs):
    ref, port, _ = runs
    assert port[0]["plan2_rows"] == ref["plan2_rows"]
    assert [p["B0"] is None for p in port] == [False, False, True, True]
    _bitwise(_gathered(port[:W2], "B0"), _ref_leaves(ref["B"][0]))


def test_live_scale_up_with_spares_is_bitwise_the_reference(runs):
    ref, port, _ = runs
    assert [p["world4"] for p in port] == [(r, W) for r in range(W)]
    assert all(p["event"] == {"world": W, "mesh_shape": [2, 2]} for p in port[W2:])
    _bitwise(_gathered(port, "D0"), _ref_leaves(ref["D"][0]))


def test_the_padding_changes_across_the_reshards(runs):
    ref, _, _ = runs
    a, b = _ref_leaves(ref["A"]), _ref_leaves(ref["B"][0])
    gid = _tail_gid(_plan4())
    assert a[f"emb/{gid}/w"].shape[0] == 1004 and b[f"emb/{gid}/w"].shape[0] == 1002
    k4, k2 = a[f"emb/{gid}/l2/keys"], b[f"emb/{gid}/l2/keys"]
    live = k4 < 1001  # the L2 tier holds rows and sentinels
    assert live.any() and (~live).any()
    assert (k4[~live] == 1004).all() and (k2[~live] == 1002).all()
    assert (k2[live] == k4[live]).all()


def _check_step(got, jstate, jmet):
    """The training bars of ``tests/test_torch_train.py``: loss and grad norm
    rtol 1e-4 / atol 1e-5, hits and overflow exactly, FCounter and tier keys
    bitwise, floats atol 1e-4."""
    m = got["met"]
    np.testing.assert_allclose(m["loss"], float(jmet["loss"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(m["grad_norm"], float(jmet["grad_norm"]), rtol=1e-4, atol=1e-5)
    assert (int(m["cache_hits"]), int(m["overflow"])) == (int(jmet["cache_hits"]),
                                                          int(jmet["overflow"]))
    exp = _ref_leaves(jstate)
    for k, v in got["state"].items():
        e = exp[k]
        if isinstance(v, int) or np.ndim(v) == 0:
            assert int(v) == int(e), k
        elif k.endswith(("counts", "keys")):
            np.testing.assert_array_equal(v, e, err_msg=k)
        else:
            np.testing.assert_allclose(v, e, atol=1e-4, rtol=0, err_msg=k)


@pytest.mark.parametrize("world", (W2, W))
@pytest.mark.parametrize("i", range(STEPS))
def test_steps_after_each_reshard_meet_the_bars(runs, world, i):
    ref, port, _ = runs
    key, states, mets = ("steps2", ref["B"], ref["B_mets"]) if world == W2 else (
        "steps4", ref["D"], ref["D_mets"])
    ranks = port[:world]
    got = {"met": ranks[0][key][i]["met"],
           "state": _gathered([{"s": r[key][i]["state"]} for r in ranks], "s")}
    assert all(r[key][i]["met"] == ranks[0][key][i]["met"] for r in ranks)
    _check_step(got, states[i + 1], mets[i])


@pytest.mark.parametrize("writer", ("port", "ref"))
def test_world_4_checkpoint_restores_at_world_2_bitwise(runs, writer):
    ref, port, _ = runs
    got = _gathered([{"s": p["R2"][writer][0]} for p in port[:W2]], "s")
    assert all(p["R2"][writer][1] == PRE_STEPS for p in port[:W2])
    _bitwise(got, _ref_leaves(ref["R2"]))
    _bitwise(got, _ref_leaves(ref["B"][0]))


@pytest.mark.parametrize("writer", ("port", "ref"))
def test_world_4_checkpoint_restores_at_world_1_bitwise(runs, writer):
    import dataclasses

    from repro_torch.convert import train_state_from_jax
    from repro_torch.core.packing import reshard_plan
    from repro_torch.runtime import restore_elastic

    ref, _, tmp = runs
    d = str(tmp / "port_ckpt") if writer == "port" else ref["ref_dir"]
    plan1 = reshard_plan(_plan4(), 1, GB, mesh_shape=(1, 1))
    tmpl = train_state_from_jax(_ns(ref["A"]), dataclasses.replace(_plan4(), world=1), "cpu")
    tmpl = {**tmpl, "emb": {k: st._replace(w=torch.zeros((plan1.group(int(k)).rows,)
                                                         + tuple(st.w.shape[1:])),
                                           acc=torch.zeros((plan1.group(int(k)).rows, 1)),
                                           counts=torch.zeros(plan1.group(int(k)).rows,
                                                              dtype=torch.int32))
                            for k, st in tmpl["emb"].items()}}
    logs = []
    got, s = restore_elastic(d, plan1, tmpl, log=logs.append)
    assert s == PRE_STEPS and logs == [f"restored world={W} checkpoint at world=1 "
                                       f"(resharded step {PRE_STEPS})"]
    _bitwise(_np(got), _ref_leaves(ref["R1"]))


@pytest.mark.parametrize("mode", ("keep", "repad"))
def test_keep_and_repad_past_world_1_mean_what_they_mean_at_world_1(runs, mode):
    """The world-4 checkpoint at world 2 without the elastic restore:
    ``'keep'`` gives each rank half of the stored rows, ``'repad'`` each
    rank its cut of the template's rows (truncated, zero past the stored
    ones); neither remaps a sentinel."""
    ref, port, _ = runs
    got = _gathered([{"s": p[mode]} for p in port[:W2]], "s")
    stored = _ref_leaves(ref["A"])
    for name, exp in stored.items():
        if mode == "repad" and re.fullmatch(r"emb/\d+/(w|acc|counts)", name):
            gid = int(name.split("/")[1])
            rows = port[0]["plan2_rows"][[g.gid for g in _plan4().groups].index(gid)]
            want = np.zeros((rows,) + exp.shape[1:], exp.dtype)
            n = min(rows, exp.shape[0])
            want[:n] = exp[:n]
            exp = want
        assert _same(got[name], exp), (mode, name)


def test_fcounter_mass_in_a_dropped_row_raises_on_every_rank(runs):
    _, port, _ = runs
    for r, p in enumerate(port):
        assert p["tail_live"] is not None and "nonzero FCounter" in p["tail_live"], r
    for r, p in enumerate(port[:W2]):
        assert p["tail_ckpt"] is not None and "nonzero FCounter" in p["tail_ckpt"], r
        assert p["tail_ckpt_untouched"], r


# ------------------------------------------------------------- the launcher


# the reference's launcher leaves its batch prefetcher's daemon thread in
# XLA's code at exit, and the interpreter's teardown then aborts it at times
# ("FATAL: exception not rethrown"): once main has returned, exit at once
_REF_MAIN = ("import os, sys; from repro.launch.train import main; main(); "
             "sys.stdout.flush(); sys.stderr.flush(); os._exit(0)")


def _launch(module, d, *extra, env=None, steps=6):
    flags = ["--arch", "deepfm", "--smoke", "--global-batch", "64", "--log-every", "1",
             "--ckpt-dir", str(d), "--steps", str(steps)]
    entry = ["-c", _REF_MAIN] if module == "repro" else ["-m", f"{module}.launch.train"]
    proc = subprocess.run([sys.executable, *entry, *flags, *extra],
                          capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def _port_env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), PYTHONHASHSEED=HASH_SEED,
                OMP_NUM_THREADS="1")


def test_train_launcher_reshards_as_the_reference(tmp_path):
    """Both launchers resume the reference's world-4 step-2 checkpoint and
    reshard to 2x1 at step 3: the reshard line and every loss to the printed
    decimals are the reference's, the step-3 checkpoint records world 2, and
    a resume of the port's directory at world 4 restores it elastically and
    prints the reference's resumed loss."""
    mesh = ("--devices", "4", "--mesh", "2x2")
    _launch("repro", tmp_path / "a", *mesh, "--ckpt-every", "2", steps=2, env=ref_env())
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    flags = (*mesh, "--ckpt-every", "10", "--reshard-to", "2x1", "--reshard-at", "3")
    port = _launch("repro_torch", tmp_path / "a", *flags, "--device", "cpu", env=_port_env())
    ref = _launch("repro", tmp_path / "b", *flags, env=ref_env())
    line = "[train] reshard world 4 -> 2 (mesh 2x1) at step 3"
    assert line in port.stdout and line in ref.stdout
    pat = r"^  step +(\d+) loss=(\S+) .*$"
    assert re.findall(pat, port.stdout, re.M) == re.findall(pat, ref.stdout, re.M)
    assert [s for s, _ in re.findall(pat, port.stdout, re.M)] == ["3", "4", "5", "6"]
    from repro_torch.train.checkpoint import load_checkpoint_meta

    assert load_checkpoint_meta(str(tmp_path / "a"))["world"] == 2
    assert "[train] done" in port.stdout
    # the port's world-2 directory resumed at world 4 (and the reference's alike)
    again = _launch("repro_torch", tmp_path / "a", *mesh, "--device", "cpu", env=_port_env(),
                    steps=7)
    ref_again = _launch("repro", tmp_path / "b", *mesh, env=ref_env(), steps=7)
    assert "[train] elastic restored world=2 checkpoint at world=4 (resharded step 3)" \
        in again.stdout
    pat7 = r"^  step +7 loss=(\S+) .*$"
    assert re.findall(pat7, again.stdout, re.M) == re.findall(pat7, ref_again.stdout, re.M)
    assert len(re.findall(pat, again.stdout, re.M)) == 4  # steps 4-7 replayed from step 3


def test_train_launcher_scales_up_with_spares_and_resumes_at_world_1(tmp_path):
    """``--mesh 2x1 --reshard-to 2x2``: 4 processes, two spares until step 3;
    the run's losses equal the world-2 run's through step 3, and its
    world-4 directory resumes at world 1."""
    base = ("--device", "cpu", "--ckpt-every", "10")
    up = _launch("repro_torch", tmp_path / "up", *base, "--devices", "4", "--mesh", "2x1",
                 "--reshard-to", "2x2", "--reshard-at", "3", env=_port_env())
    first = up.stdout.splitlines()[0]
    assert "world=2" in first and "processes=4" in first, up.stdout
    assert "[train] reshard world 2 -> 4 (mesh 2x2) at step 3" in up.stdout
    two = _launch("repro_torch", tmp_path / "two", *base, "--mesh", "2x1", env=_port_env(),
                  steps=3)
    pat = r"^  step +(\d+) loss=(\S+) .*$"
    assert re.findall(pat, up.stdout, re.M)[:3] == re.findall(pat, two.stdout, re.M)
    one = _launch("repro_torch", tmp_path / "up", *base, env=_port_env(), steps=7)
    assert "[train] elastic restored world=4 checkpoint at world=1 (resharded step 3)" \
        in one.stdout
    assert [s for s, _ in re.findall(pat, one.stdout, re.M)] == ["4", "5", "6", "7"]
