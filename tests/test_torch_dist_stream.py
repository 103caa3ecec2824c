"""Streaming, publishing and ``--reload-dir`` past world 1: 4 gloo ranks
against the reference on 4 forced host devices.

The config is ``tests/test_torch_dist_elastic.py``'s three packed groups
(dims 4, 8 and 16) under one mixed plan (``picasso``, ``picasso_l2``,
``picasso_narrow``), global batch 32. The reference trains 2 steps at world
4 (the flush at step 2 fills both tiers: state ``A``), publishes ``A`` at
worlds 4, 2 and 1 and loads each delta at worlds 4, 2 and 1; it runs a
stream of three 2-step segments from ``A`` with a live reshard 4 -> 2 at
the first boundary and 2 -> 4 at the second, and a ``PublishPoller`` over a
scripted sequence of good, torn and corrupt deltas. The port's 4 ranks
(one spawn for the module) start from the reference's states:

- the port's world-4 delta of ``A`` is the reference's, leaf for leaf, and
  the reference loads it;
- ``load_published`` at worlds 4 and 2 of the deltas of either package from
  worlds 4, 2 and 1 is bitwise the reference's recut, sentinels remapped;
- a delta of another plan revision raises ``ValueError`` and one of other
  salts ``SaltMismatch`` on every rank, with the template untouched;
- the poller skips a torn delta and one whose fault lies only in rank 2's
  rows of a ``.npy`` leaf on every rank together, keeps the last good state
  bitwise, and backs off as the reference's poller does over the script;
- ``run_stream`` across the 4 -> 2 and 2 -> 4 boundary reshards (ranks 2
  and 3 leave, then join as spares for the last segment): each delta is
  bitwise the ranks' live state at its step, and each segment's steps, from
  the reference's state at the segment's start, meet the training bars;
- the launchers: the port's ``--stream`` at ``--devices 4`` with a reshard at
  a boundary and ``torn@``, its crash mid-segment resumed at worlds 4 and 2,
  and ``--reload-dir`` at ``--devices 4`` print the reference's lines.
"""
import inspect
import io
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs.base import FeatureField as JFeatureField
from repro.configs.base import InteractionSpec as JInteractionSpec
from repro.configs.base import WDLConfig as JWDLConfig
from repro.data.synthetic import make_batch as jmake_batch
from test_torch_dist import HASH_SEED, ROOT, W, ref_env, run_port, run_reference
from test_torch_dist_elastic import (GB, MIX, PLAN_KW, _cfg, _check_step, _gathered, _np,
                                     _ns, _plan4, _ref_leaves, _same, _tail_gid)

torch.set_num_threads(1)

W2 = 2
PRE = 2         # steps at world 4 before the deltas and the stream (the flush at 2)
SEG = 2         # steps a segment; three segments: world 4, 2, 4
# the poller's script: publishes (step, kind) and polls; the backoff skips
# 2, 4 and 8 polls after the 1st, 2nd and 3rd consecutive failure
SCRIPT = ([("publish", 10, "good"), ("poll",), ("publish", 12, "torn")] + [("poll",)] * 4
          + [("publish", 14, "rank2")] + [("poll",)] * 5 + [("publish", 16, "good")]
          + [("poll",)] * 9)
POLL_SOURCES = {10: ("A", 0), 12: ("A", 0), 14: ("S3", 1), 16: ("S3", 2)}

REF_BODY = """
from repro.configs.base import FeatureField, InteractionSpec, WDLConfig
from repro.core.assign import apply_assignment
from repro.core.packing import make_plan, reshard_plan
from repro.dist.sharding import batch_specs, to_named
from repro.models.wdl import WDLModel
from repro.runtime import (PublishPoller, load_published, make_submesh, plan_meta,
                           publish_state, reshard_live)
from repro.runtime.chaos import tear_published
from repro.train import checkpoint as ck
from repro.train.train_step import TrainConfig, init_state, make_train_step
GB, PRE = inp["GB"], inp["PRE"]
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


def serving(st):
    return {"emb": st["emb"], "dense": st["dense"]}


def flat(tree):
    return {k: np.asarray(v) for k, v in ck._flatten(jax.device_get(tree)).items()}


def seg(plan, m, state, batches):
    step, _ = make_train_step(WDLModel(cfg, plan), plan, m, AXES, GB,
                              TrainConfig(strategy="mixed", use_fused_kernels="off"),
                              donate=False)
    raw, states, mets = [state], [np_train(state)], []
    for b in batches:
        state, met = step(state, jax.device_put(b, to_named(m, batch_specs(b, AXES))))
        raw.append(state)
        states.append(np_train(state))
        mets.append({k: np.asarray(v) for k, v in met.items()})
    return state, states, mets, raw


plan4 = make_plan(cfg, world=4, per_device_batch=GB // 4, mesh_shape=(2, 2), **inp["plan_kw"])
apply_assignment(plan4, dict(inp["mix"]))
state = init_state(WDLModel(cfg, plan4), plan4, jax.random.PRNGKey(0), mesh=mesh, axes=AXES)
state_a, _, _, _ = seg(plan4, mesh, state, inp["pre"])
out["A"] = np_train(state_a)

# the deltas of A at worlds 4, 2 and 1, each loaded at worlds 4, 2 and 1
mesh2 = make_submesh((2, 1), AXES)
plan2, a2 = reshard_live(plan4, state_a, 2, GB // 2, mesh=mesh2, axes=AXES,
                         mesh_shape=(2, 1))
out["A2"] = np_train(a2)
plan1, a1 = reshard_live(plan4, state_a, 1, GB, mesh_shape=(1, 1))
plans = {4: plan4, 2: plan2, 1: plan1}
for w, st in ((4, state_a), (2, a2), (1, a1)):
    publish_state(inp["pub"][w], PRE, serving(st), meta=plan_meta(plans[w]))
out["loaded"] = {}
for src in (4, 2, 1):
    for to in (4, 2, 1):
        tmpl = jax.device_get(init_state(WDLModel(cfg, plans[to]), plans[to],
                                         jax.random.PRNGKey(7)))
        got, _ = load_published(inp["pub"][src], serving(tmpl), plan=plans[to])
        out["loaded"][src, to] = flat(got)

# the stream: three segments, 4 -> 2 at the first boundary, 2 -> 4 at the second
b1, b2, b3 = inp["b1"], inp["b2"], inp["b3"]
st, out["S1"], out["M1"], _ = seg(plan4, mesh, state_a, b1)
plan2s, st = reshard_live(plan4, st, 2, GB // 2, mesh=mesh2, axes=AXES, mesh_shape=(2, 1))
st, out["S2"], out["M2"], _ = seg(plan2s, mesh2, st, b2)
plan4b, st = reshard_live(plan2s, st, 4, GB // 4, mesh=mesh, axes=AXES, mesh_shape=(2, 2))
st, out["S3"], out["M3"], raw3 = seg(plan4b, mesh, st, b3)

# the poller over the script, on deltas of this world
raws = {"A": [state_a], "S3": raw3}
poll_dir = inp["poll"]
tmpl = serving(jax.device_get(init_state(WDLModel(cfg, plan4), plan4, jax.random.PRNGKey(9))))
poller = PublishPoller(poll_dir, plan=plan4)
rec, zstd = [], ck.zstandard
for act in inp["script"]:
    if act[0] == "publish":
        step, kind = act[1], act[2]
        key, i = inp["sources"][step]
        if kind == "rank2":
            ck.zstandard = None  # a .npy delta, so the fault sits in rank 2's rows
        try:
            publish_state(poll_dir, step, serving(raws[key][i]), meta=plan_meta(plan4), keep=5)
        finally:
            ck.zstandard = zstd
        if kind == "torn":
            tear_published(poll_dir)
        elif kind == "rank2":
            flip_rank2_rows(poll_dir, step)
    else:
        got = poller.poll(tmpl)
        if got is not None:
            tmpl = got[0]
        rec.append((None if got is None else got[1], poller.failures, poller.skips_left,
                    poller.last_step))
out["poll"] = rec
out["poll_final"] = flat(tmpl)
"""


def flip_rank2_rows(d: str, step: int) -> None:
    """Flip one byte in the middle of rank 2's rows (of 4) of group 0's
    ``w``, a ``.npy`` leaf of the delta at ``step`` (the reference's side runs
    this function's source too)."""
    path = os.path.join(d, f"step_{step:08d}", "emb__0__w.npy")
    with open(path, "r+b") as f:
        np.lib.format.read_magic(f)
        shape, _, dtype = np.lib.format.read_array_header_1_0(f)
        head = f.tell()
        rps = shape[0] // 4
        row_bytes = int(np.prod(shape[1:])) * np.dtype(dtype).itemsize
        off = head + (2 * rps + rps // 2) * row_bytes
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


def read_delta(d: str, step: int):
    """A delta's manifest and its leaves as whole numpy arrays."""
    import zstandard

    base = Path(d) / f"step_{step:08d}"
    man = json.loads((base / "manifest.json").read_text())
    leaves = {}
    for name, info in man["leaves"].items():
        raw = (base / info["file"]).read_bytes()
        if info["file"].endswith(".zst"):
            raw = zstandard.ZstdDecompressor().stream_reader(io.BytesIO(raw)).read()
        leaves[name] = np.load(io.BytesIO(raw))
    return man, leaves


def _serving(st):
    return {"emb": st["emb"], "dense": st["dense"]}


def _port_stream(root, ref, bs, d):
    """One rank of the module's spawn (the module docstring, in order)."""
    from repro_torch.convert import train_state_from_jax
    from repro_torch.core.assign import apply_assignment
    from repro_torch.core.features import SaltMismatch, agree_salts
    from repro_torch.core.packing import reshard_plan, revise_plan
    from repro_torch.models.wdl import WDLModel
    from repro_torch.runtime import (PublishPoller, apply_plan_meta, load_published,
                                     make_submesh, plan_meta, publish_state, reshard_live,
                                     run_stream, wait_for_reshard)
    from repro_torch.runtime.chaos import tear_published
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.train_step import TrainConfig, init_state, make_train_step

    out = {}
    plan4 = _plan4()
    salts = agree_salts(plan4, root)
    g2 = make_submesh((W2, 1), group=root)
    plan2 = reshard_plan(plan4, W2, GB // W2, mesh_shape=(W2, 1))
    a = train_state_from_jax(_ns(ref["A"]), plan4, "cpu", group=root)

    def template(plan, group, seed=7):
        st = init_state(WDLModel(_cfg(), plan), plan, torch.Generator().manual_seed(seed),
                        "cpu", group=group)
        return _serving(st)

    # -- the port's deltas of A at worlds 4 and 2
    publish_state(d["port"][4], PRE, _serving(a), meta=plan_meta(plan4), salts=salts,
                  group=root)
    if g2 is not None:
        a2 = train_state_from_jax(_ns(ref["A2"]), plan2, "cpu", group=g2)
        publish_state(d["port"][2], PRE, _serving(a2), meta=plan_meta(plan2), salts=salts,
                      group=g2)

    # -- load_published at worlds 4 and 2 of every delta
    sources = {("ref", w): d["ref"][w] for w in (4, 2, 1)}
    sources.update({("port", w): d["port"][w] for w in (4, 2)})
    out["loaded4"] = {k: _np(load_published(v, template(plan4, root), plan=plan4,
                                            group=root)[0]) for k, v in sources.items()}
    if g2 is not None:
        out["loaded2"] = {k: _np(load_published(v, template(plan2, g2), plan=plan2,
                                                group=g2)[0]) for k, v in sources.items()}

    # -- another plan revision; other salts
    rev = revise_plan(plan4, hot_bytes=1 << 11, l2_bytes=1 << 12)
    apply_assignment(rev, dict(MIX))
    tmpl = template(rev, root)
    before = _np(tmpl)
    try:
        load_published(d["port"][4], tmpl, plan=rev, group=root)
        out["revision"] = None
    except ValueError as e:
        out["revision"] = (type(e).__name__, str(e))
    out["revision_untouched"] = all(_same(v, before[k]) for k, v in _np(tmpl).items())
    publish_state(d["salted"], PRE, _serving(a), meta=plan_meta(plan4),
                  salts={k: v + 1 for k, v in salts.items()}, group=root)
    tmpl = template(plan4, root)
    before = _np(tmpl)
    try:
        PublishPoller(d["salted"], plan=plan4, group=root).poll(tmpl)
        out["salts"] = None
    except SaltMismatch as e:
        out["salts"] = str(e)
    out["salts_untouched"] = all(_same(v, before[k]) for k, v in _np(tmpl).items())

    # -- the poller over the script
    states = {"A": [ref["A"]], "S3": ref["S3"]}
    tmpl = template(plan4, root, seed=9)
    poller = PublishPoller(d["poll"], plan=plan4, group=root)
    rec, seen, zstd = [], [], ck.zstandard
    for act in SCRIPT:
        if act[0] == "publish":
            step, kind = act[1], act[2]
            key, i = POLL_SOURCES[step]
            st = train_state_from_jax(_ns(states[key][i]), plan4, "cpu", group=root)
            if kind == "rank2":
                ck.zstandard = None
            try:
                publish_state(d["poll"], step, _serving(st), meta=plan_meta(plan4),
                              salts=salts, group=root, keep=5)
            finally:
                ck.zstandard = zstd
            if kind == "torn" and root.rank == 0:
                tear_published(d["poll"])
            elif kind == "rank2" and root.rank == 0:
                flip_rank2_rows(d["poll"], step)
        else:
            got = poller.poll(tmpl)
            if got is not None:
                tmpl = got[0]
            rec.append((None if got is None else got[1], poller.failures, poller.skips_left,
                        poller.last_step))
            seen.append(_np(tmpl))
    out["poll"], out["poll_states"] = rec, seen

    # -- run_stream: 4 -> 2 at the first boundary, 2 -> 4 (spares) at the second
    tcfg = TrainConfig(strategy="mixed", use_fused_kernels="off")
    steps, published = [], {}
    cur = {"plan": plan4, "group": root,
           "ckpt": ck.AsyncCheckpointer(d["stream_ck"], salts=salts, group=root)}

    def make_step(plan, group):
        step = make_train_step(WDLModel(_cfg(), plan), plan, GB, tcfg, "cpu", group=group)

        def call(st, b):
            st, m = step(st, b)
            steps.append({"step": st["step"], "world": group.world, "state": _np(st),
                          "met": {k: (v if isinstance(v, int) else float(v))
                                  for k, v in m.items()
                                  if k in ("loss", "cache_hits", "overflow", "grad_norm")}})
            return st, m
        return call

    def publisher(step, st):
        published[step] = (cur["group"].world, _np(_serving(st)))
        publish_state(d["stream_pub"], step, st, meta=plan_meta(cur["plan"]), salts=salts,
                      group=cur["group"], keep=5)

    def adopt(plan, group, st, key):
        """The new world's state: the reference's at the segment's start
        (shared state a segment), with a checkpointer on the new group."""
        cur.update(plan=plan, group=group,
                   ckpt=ck.AsyncCheckpointer(d["stream_ck"], salts=salts, group=group))
        return train_state_from_jax(_ns(ref[key][0]), plan, "cpu", group=group)

    def on_segment(seg, step, st):
        if seg > 2:
            return None
        cur["ckpt"].wait()  # the rows move on the root's ckpt_pg
        w, shape = (W2, (W2, 1)) if seg == 1 else (W, (2, 2))
        plan, st, g = reshard_live(cur["plan"], st, w, GB // w, group=cur["group"],
                                   mesh_shape=shape, note={"step": step, "seg": seg})
        cur["plan"] = plan
        if g is None:
            return None, None, None, None
        st = adopt(plan, g, st, "S2" if seg == 1 else "S3")
        return st, make_step(plan, g), iter(bs[step - PRE:]), cur["ckpt"]

    kw = dict(segment_steps=SEG, n_segments=3, meta_fn=lambda: plan_meta(cur["plan"]),
              publisher=publisher, on_segment=on_segment, log=lambda s: None)
    st, last = run_stream(a, make_step(plan4, root), iter(bs), start_step=PRE,
                          checkpointer=cur["ckpt"], **kw)
    out["left_at"] = None
    if st is None:  # ranks 2 and 3: left at the first boundary, spares for the last
        out["left_at"] = last
        ev = wait_for_reshard()
        out["event"] = {k: ev[k] for k in ("world", "mesh_shape", "step", "seg")}
        plan, st, g = reshard_live(apply_plan_meta(cur["plan"], ev["meta"]), None,
                                   ev["world"], GB // ev["world"],
                                   mesh_shape=ev["mesh_shape"], device="cpu")
        st = adopt(plan, g, st, "S3")
        st, last = run_stream(st, make_step(plan, g), iter(bs[ev["step"] - PRE:]),
                              start_step=ev["step"], first_segment=ev["seg"] + 1,
                              checkpointer=cur["ckpt"], **kw)
    cur["ckpt"].wait()
    out.update(last=last, steps=steps, published=published, world=cur["group"].world)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_stream")
    jcfg = JWDLConfig(name="elastic3", fields=(JFeatureField("a", 1001, 8, max_len=2),
                                               JFeatureField("b", 515, 16, max_len=1),
                                               JFeatureField("c", 259, 4, max_len=3)),
                      n_dense=0, interactions=(JInteractionSpec("fm"),), mlp_dims=(16, 8))
    rng = np.random.default_rng(11)
    pre = [jmake_batch(jcfg, GB, rng) for _ in range(PRE)]
    bs = [jmake_batch(jcfg, GB, rng) for _ in range(3 * SEG)]
    d = {"ref": {w: str(tmp / f"ref_pub{w}") for w in (4, 2, 1)},
         "port": {w: str(tmp / f"port_pub{w}") for w in (4, 2)},
         "salted": str(tmp / "salted"), "poll": str(tmp / "port_poll"),
         "stream_pub": str(tmp / "stream_pub"), "stream_ck": str(tmp / "stream_ck")}
    ref = run_reference(
        inspect.getsource(flip_rank2_rows) + REF_BODY,
        {"GB": GB, "PRE": PRE, "plan_kw": PLAN_KW, "mix": MIX, "pre": pre,
         "b1": bs[:SEG], "b2": bs[SEG:2 * SEG], "b3": bs[2 * SEG:], "pub": d["ref"],
         "poll": str(tmp / "ref_poll"), "script": SCRIPT, "sources": POLL_SOURCES}, tmp,
        timeout=900)
    port = run_port(_port_stream, ref, bs, d, tmp=tmp, deadline_s=600)
    return ref, port, d


def _serve_leaves(st):
    return {k: v for k, v in _ref_leaves(st).items() if k.startswith(("emb/", "dense/"))}


def test_world_4_delta_is_the_references_leaf_for_leaf(runs):
    """The port's world-4 delta of A against the reference's: the same
    files, shapes, dtypes and meta, every leaf decoded bitwise; the port's
    manifest adds the salts."""
    _, _, d = runs
    pm, pl = read_delta(d["port"][4], PRE)
    rm, rl = read_delta(d["ref"][4], PRE)
    assert pm["meta"] == rm["meta"] and pm["meta"]["world"] == W
    assert "salts" in pm and "salts" not in rm
    assert {k: (v["file"], v["shape"], v["dtype"]) for k, v in pm["leaves"].items()} == \
        {k: (v["file"], v["shape"], v["dtype"]) for k, v in rm["leaves"].items()}
    for name in rl:
        assert _same(pl[name], rl[name]), name


def test_the_reference_loads_the_ports_world_4_delta(runs):
    """The reference's world-1 ``load_published`` of the port's world-4 delta
    is bitwise its load of its own."""
    import jax

    from repro.core.assign import apply_assignment as japply
    from repro.core.packing import make_plan as jmake_plan
    from repro.core.packing import reshard_plan as jreshard_plan
    from repro.models.wdl import WDLModel as JWDLModel
    from repro.runtime import load_published as jload
    from repro.train import checkpoint as jck
    from repro.train.train_step import init_state as jinit

    ref, _, d = runs
    jcfg = JWDLConfig(name="elastic3", fields=(JFeatureField("a", 1001, 8, max_len=2),
                                               JFeatureField("b", 515, 16, max_len=1),
                                               JFeatureField("c", 259, 4, max_len=3)),
                      n_dense=0, interactions=(JInteractionSpec("fm"),), mlp_dims=(16, 8))
    plan4 = jmake_plan(jcfg, world=W, per_device_batch=GB // W, mesh_shape=(2, 2), **PLAN_KW)
    japply(plan4, dict(MIX))
    plan1 = jreshard_plan(plan4, 1, GB, mesh_shape=(1, 1))
    tmpl = jax.device_get(jinit(JWDLModel(jcfg, plan1), plan1, jax.random.PRNGKey(7)))
    got, step = jload(d["port"][4], {"emb": tmpl["emb"], "dense": tmpl["dense"]}, plan=plan1)
    assert step == PRE
    got = {k: np.asarray(v) for k, v in jck._flatten(jax.device_get(got)).items()}
    exp = ref["loaded"][4, 1]
    assert sorted(got) == sorted(exp)
    for k in exp:
        assert _same(got[k], exp[k]), k


@pytest.mark.parametrize("world", (W, W2))
@pytest.mark.parametrize("src", [("ref", 4), ("ref", 2), ("ref", 1), ("port", 4),
                                 ("port", 2)])
def test_load_published_recuts_every_delta_as_the_reference(runs, world, src):
    """Each rank's load at worlds 4 and 2 gathers bitwise to the reference's
    load of the same logical delta at that world (its world-1 consumer's
    recut at the world's padding), tier sentinels included."""
    ref, port, _ = runs
    key = "loaded4" if world == W else "loaded2"
    got = _gathered([{"s": p[key][src]} for p in port[:world]], "s")
    exp = ref["loaded"][src[1], world]
    assert sorted(got) == sorted(exp)
    for k in exp:
        assert _same(got[k], exp[k]), (k, src, world)
    gid = _tail_gid(_plan4())
    rows = got[f"emb/{gid}/w"].shape[0]
    keys = got[f"emb/{gid}/l2/keys"]
    assert rows == (1004 if world == W else 1002)
    assert (keys[keys >= 1001] == rows).all() and (keys >= 1001).any() and (keys < 1001).any()


def test_another_revision_and_other_salts_raise_on_every_rank(runs):
    _, port, _ = runs
    for r, p in enumerate(port):
        assert p["revision"] is not None and p["revision"][0] == "ValueError", r
        assert "another plan revision" in p["revision"][1], r
        assert p["revision_untouched"], r
        assert p["salts"] is not None and "PYTHONHASHSEED" in p["salts"], r
        assert p["salts_untouched"], r


def test_the_poller_backs_off_as_the_reference_on_every_rank_together(runs):
    """Over the script every rank records the reference poller's (loaded
    step, consecutive failures, polls left to skip, last good step) at
    every poll; after each failed load the state is bitwise the last good
    delta (step 10 through the torn delta and the fault in rank 2's rows),
    and step 16 loads whole at the end."""
    ref, port, _ = runs
    for r, p in enumerate(port):
        assert p["poll"] == ref["poll"], r
    loaded = [rec[0] for rec in ref["poll"] if rec[0] is not None]
    assert loaded == [10, 16]
    assert max(rec[1] for rec in ref["poll"]) == 3  # torn twice, then rank 2's rows
    good = _serve_leaves(ref["A"])  # step 10's delta
    for i, rec in enumerate(ref["poll"]):
        if rec[3] == 10:
            now = _gathered([{"s": p["poll_states"][i]} for p in port], "s")
            assert sorted(now) == sorted(good), i
            for k, v in good.items():
                assert _same(now[k], v), (i, k)
    final = _gathered([{"s": p["poll_states"][-1]} for p in port], "s")
    assert sorted(final) == sorted(ref["poll_final"])
    for k, v in ref["poll_final"].items():
        assert _same(final[k], v), k


def test_stream_ranks_leave_and_join_at_the_boundaries(runs):
    _, port, _ = runs
    assert [p["left_at"] for p in port] == [None, None, PRE + SEG, PRE + SEG]
    for p in port[W2:]:
        assert p["event"] == {"world": W, "mesh_shape": [2, 2], "step": PRE + 2 * SEG,
                              "seg": 2}
    assert all(p["last"] == PRE + 3 * SEG and p["world"] == W for p in port)
    worlds = [(s["step"], s["world"]) for s in port[0]["steps"]]
    assert worlds == [(3, 4), (4, 4), (5, 2), (6, 2), (7, 4), (8, 4)]
    assert [s["step"] for s in port[W2]["steps"]] == [3, 4, 7, 8]


@pytest.mark.parametrize("step", (PRE + SEG, PRE + 2 * SEG, PRE + 3 * SEG))
def test_each_delta_is_the_live_state_at_its_step(runs, step):
    _, port, d = runs
    world = port[0]["published"][step][0]
    live = _gathered([{"s": p["published"][step][1]} for p in port[:world]], "s")
    man, leaves = read_delta(d["stream_pub"], step)
    assert man["meta"]["world"] == world and sorted(leaves) == sorted(live)
    for k, v in leaves.items():
        assert _same(v, live[k]), (step, k)


@pytest.mark.parametrize("step", range(PRE + 1, PRE + 3 * SEG + 1))
def test_each_segments_steps_meet_the_bars(runs, step):
    """Each segment starts from the reference's state at its start (after
    the reshard for the second and third); its steps meet the training bars
    of ``tests/test_torch_train.py`` against the reference's."""
    ref, port, _ = runs
    seg = (step - PRE - 1) // SEG
    i = (step - PRE - 1) % SEG
    states, mets = (ref["S1"], ref["M1"]) if seg == 0 else (
        (ref["S2"], ref["M2"]) if seg == 1 else (ref["S3"], ref["M3"]))
    world = W2 if seg == 1 else W
    recs = [next(s for s in p["steps"] if s["step"] == step) for p in port[:world]]
    assert all(r["met"] == recs[0]["met"] for r in recs)
    got = {"met": recs[0]["met"], "state": _gathered([{"s": r["state"]} for r in recs], "s")}
    _check_step(got, states[i + 1], mets[i])


# ------------------------------------------------------------- the launchers


# the reference's launchers can abort in their teardown (a prefetcher's
# daemon thread inside XLA): once main has returned, exit at once
def _ref_main(module):
    return ["-c", f"import os, sys; from repro.launch.{module} import main; main(); "
                  "sys.stdout.flush(); sys.stderr.flush(); os._exit(0)"]


def _start(pkg, module, *flags):
    env = (ref_env() if pkg == "repro" else
           dict(os.environ, PYTHONPATH=str(ROOT / "src"), PYTHONHASHSEED=HASH_SEED,
                OMP_NUM_THREADS="1"))
    entry = _ref_main(module) if pkg == "repro" else ["-m", f"repro_torch.launch.{module}"]
    extra = ["--device", "cpu"] if pkg == "repro_torch" else []
    return subprocess.Popen([sys.executable, *entry, "--arch", "deepfm", "--smoke", *flags,
                             *extra], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _run_all(*runs, ok=True):
    """The launcher runs ``(pkg, module, *flags)`` side by side; each one's
    ``(returncode, stdout, stderr)``, in order."""
    procs = [_start(*r) for r in runs]
    out = []
    try:
        for proc in procs:
            so, se = proc.communicate(timeout=600)
            if ok:
                assert proc.returncode == 0, se[-3000:]
            out.append((proc.returncode, so, se))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


def _run(pkg, module, *flags):
    return _run_all((pkg, module, *flags))[0][1]


TRAIN = ("--global-batch", "64", "--log-every", "1")
LOSS = r"^  step +(\d+) loss=(\S+) .*$"


def test_stream_launchers_reshard_tear_and_serve_as_the_reference(tmp_path):
    """From the reference's world-4 step-2 checkpoint both train launchers
    stream three 2-step segments at ``--devices 4 --mesh 2x2``, reshard to
    2x1 at the step-4 boundary and tear the step-6 delta: the same losses to
    the printed decimals and the same published, segment, reshard and done
    lines. The step-8 delta (world 2) of either package serves in either
    launcher at ``--devices 4`` with the same reloaded step and mean_prob."""
    mesh = ("--devices", "4", "--mesh", "2x2")
    _run("repro", "train", *TRAIN, *mesh, "--steps", "2", "--ckpt-every", "2",
         "--ckpt-dir", str(tmp_path / "port_ck"))
    shutil.copytree(tmp_path / "port_ck", tmp_path / "ref_ck")
    tags = (("repro_torch", "port"), ("repro", "ref"))
    runs = _run_all(*[(pkg, "train", *TRAIN, *mesh, "--stream", "--segment-steps", "2",
                       "--stream-segments", "3", "--ckpt-dir", str(tmp_path / f"{tag}_ck"),
                       "--publish-dir", str(tmp_path / f"{tag}_pub"), "--reshard-to", "2x1",
                       "--reshard-at", "2", "--chaos", "torn@6") for pkg, tag in tags])
    out = {tag: r[1] for (_, tag), r in zip(tags, runs)}
    lines = [ln for ln in out["ref"].splitlines()
             if ln.startswith(("[stream]", "[train] reshard", "[train] stream"))]
    port_lines = [ln.replace(str(tmp_path / "port_pub"), "PUB") for ln in
                  out["port"].splitlines()
                  if ln.startswith(("[stream]", "[train] reshard", "[train] stream"))]
    assert port_lines == [ln.replace(str(tmp_path / "ref_pub"), "PUB") for ln in lines]
    assert "[train] reshard world 4 -> 2 (mesh 2x1) at step 4" in lines
    assert lines[-1] == "[train] stream done at step 8 (world=2)"
    assert "[train] stream resumed at step 2" in out["port"]
    losses = re.findall(LOSS, out["port"], re.M)
    assert [s for s, _ in losses] == [str(i) for i in range(3, 9)]
    assert losses == re.findall(LOSS, out["ref"], re.M)
    serve = ("--batch", "64", "--n-requests", "3", *mesh)
    shutil.copytree(tmp_path / "port_pub", tmp_path / "torn_pub")  # torn by one server
    keys = [(pkg, tag) for pkg in ("repro_torch", "repro") for tag in ("port", "ref")]
    torn = ("repro_torch", "port")
    runs = _run_all(*[(pkg, "serve", *serve, "--reload-dir",
                       str(tmp_path / ("torn_pub" if (pkg, tag) == torn else f"{tag}_pub")),
                       *(("--chaos", "torn@2") if (pkg, tag) == torn else ()))
                      for pkg, tag in keys])
    got = {k: r[1] for k, r in zip(keys, runs)}
    mean = r"mean_prob=(\d\.\d{3})$"
    exp = re.findall(mean, got["repro", "ref"], re.M)
    assert len(exp) == 1
    for key, text in got.items():
        assert re.findall(r"reloaded published step (\d+)", text) == ["8"], key
        assert re.findall(mean, text, re.M) == exp, key
    port = got["repro_torch", "port"]
    assert "[serve] chaos: tearing published delta before request 2" in port
    assert re.findall(r"request (\d): step (\d+)", port) == [("0", "8"), ("1", "8"),
                                                             ("2", "8")]


def test_stream_crash_mid_segment_resumes_at_worlds_4_and_2(tmp_path):
    """``crash@5`` at world 4 ends the run after the step-4 checkpoint; the
    relaunch at world 4 replays step 5 to the crashed run's printed loss, and
    the relaunch at world 2 restores elastically and trains steps 5 and 6 to
    the reference launcher's losses from the same checkpoint."""
    mesh4 = ("--devices", "4", "--mesh", "2x2")
    stream = ("--stream", "--segment-steps", "2")
    rc, so, se = _run_all(("repro_torch", "train", *TRAIN, *mesh4, *stream,
                           "--stream-segments", "3", "--ckpt-dir", str(tmp_path / "a"),
                           "--chaos", "crash@5"), ok=False)[0]
    assert rc != 0 and "injected crash at step 5" in se
    before = re.findall(LOSS, so, re.M)
    assert [s for s, _ in before] == ["1", "2", "3", "4", "5"]
    for tag in ("b", "c"):
        shutil.copytree(tmp_path / "a", tmp_path / tag)
    mesh2 = ("--devices", "2", "--mesh", "2x1")
    again = (*TRAIN, *stream, "--stream-segments", "1", "--ckpt-dir")
    four, two, ref = (r[1] for r in _run_all(
        ("repro_torch", "train", *mesh4, *again, str(tmp_path / "a")),
        ("repro_torch", "train", *mesh2, *again, str(tmp_path / "b")),
        ("repro", "train", *mesh2, *again, str(tmp_path / "c"))))
    assert "[train] stream resumed at step 4" in four
    assert re.findall(LOSS, four, re.M)[0] == before[4]
    line = "[train] elastic restored world=4 checkpoint at world=2 (resharded step 4)"
    assert line in two and line in ref
    got = re.findall(LOSS, two, re.M)
    assert [s for s, _ in got] == ["5", "6"] and got == re.findall(LOSS, ref, re.M)
    assert "[train] stream done at step 6 (world=2)" in two


@pytest.fixture(scope="module")
def ref_ckpt(tmp_path_factory):
    """The reference launcher's world-4 stream of one 2-step segment: its
    checkpoint (``ck``) and its published delta (``pub``) of step 2."""
    tmp = tmp_path_factory.mktemp("ref_ckpt")
    _run("repro", "train", *TRAIN, "--devices", "4", "--mesh", "2x2", "--stream",
         "--segment-steps", "2", "--stream-segments", "1", "--ckpt-dir", str(tmp / "ck"),
         "--publish-dir", str(tmp / "pub"))
    return tmp


def flag_checks(port, flag, calib=None, world=W):
    """What a runtime flag prints past world 1 beside the reference's lines:
    ``--pin-l2`` on the CPU warns once and pins nothing; ``--calibrate``
    benches once (rank 0's lines) and stamps its file with the world."""
    if "--pin-l2" in flag:
        assert port.count("[pin-l2] warning") == 1, port
        assert re.search(r"^\[(train|serve)\] pin-l2: 0 bytes pinned$", port, re.M), port
    if "--calibrate" in flag:
        assert port.count("calibrated 7 ops") == 1 and port.count("wrote calibration") == 1
        assert json.loads(Path(calib).read_text())["world"] == world


@pytest.mark.parametrize("flag", (("--replan-iters", "2"), ("--pin-l2",),
                                  ("--calibrate", "auto")))
def test_the_rest_of_item_6_3_still_refuses_past_world_1(ref_ckpt, tmp_path, flag):
    """(The name is kept from when these flags refused past world 1.) Each
    flag runs with ``--stream`` at ``--devices 4 --mesh 2x2``: from the
    reference's step-2 checkpoint both launchers stream a 2-step segment to
    the same losses and the same published and done lines. The stream
    loop never replans, in either package; ``--pin-l2`` is held to the
    reference unpinned, whose own ``--pin-l2`` fails on this CPU."""
    mesh = ("--devices", "4", "--mesh", "2x2")
    tags = (("repro_torch", "port"), ("repro", "ref"))
    for _, tag in tags:
        shutil.copytree(ref_ckpt / "ck", tmp_path / f"{tag}_ck")
    runs = _run_all(*[(pkg, "train", *TRAIN, *mesh, "--stream", "--segment-steps", "2",
                       "--stream-segments", "1", "--ckpt-dir", str(tmp_path / f"{tag}_ck"),
                       "--publish-dir", str(tmp_path / f"{tag}_pub"),
                       *(f for f in flag if pkg == "repro_torch" or f != "--pin-l2"),
                       *(("--calib-file", str(tmp_path / f"{tag}.json"))
                         if "--calibrate" in flag else ()))
                      for pkg, tag in tags])
    out = {tag: r[1] for (_, tag), r in zip(tags, runs)}

    def lines(tag):
        return [ln.replace(str(tmp_path / f"{tag}_pub"), "PUB") for ln in
                out[tag].splitlines() if ln.startswith(("[stream]", "[train] stream"))]

    assert lines("port") == lines("ref") and lines("ref")[-1] == (
        "[train] stream done at step 4 (world=4)")
    losses = re.findall(LOSS, out["port"], re.M)
    assert [s for s, _ in losses] == ["3", "4"] and losses == re.findall(LOSS, out["ref"], re.M)
    flag_checks(out["port"], flag, tmp_path / "port.json")
    assert "replan" not in out["port"]
