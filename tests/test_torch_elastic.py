"""The elastic reshard at world 1 in one process, against the reference's
``repro.runtime.elastic`` (``tests/test_elastic.py``'s cases): the plan
recut field by field, the state recut and ``migrate_state`` across a row
change bitwise (integers, tier keys and floats), the refusal to drop live
rows, random chains of plan revisions run side by side, checkpoints carried
between worlds and packages both ways, and published deltas recut onto the
consumer's plan, one that the reference published at world 4 on forced host
devices among them.

Everything holds the whole table in one process (the reference's states
without a mesh); the moves between processes are
``tests/test_torch_dist_elastic.py``'s.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:
    from hypothesis_fallback import given, settings, st

from repro.configs.base import FeatureField as JFeatureField
from repro.configs.base import InteractionSpec as JInteractionSpec
from repro.configs.base import WDLConfig as JWDLConfig
from repro.core.assign import apply_assignment as japply_assignment
from repro.core.packing import make_plan as jmake_plan
from repro.core.packing import reshard_plan as jreshard_plan
from repro.core.packing import revise_plan as jrevise_plan
from repro.embedding.state import migrate_state as jmigrate_state
from repro.embedding.state import reshard_state as jreshard_state
from repro.models.wdl import WDLModel as JWDLModel
from repro.runtime import load_published as jload_published
from repro.runtime import plan_meta as jplan_meta
from repro.runtime import restore_elastic as jrestore_elastic
from repro.train.checkpoint import save_checkpoint as jsave_checkpoint
from repro.train.train_step import init_state as jinit_state
from repro_torch.configs.base import FeatureField, InteractionSpec, WDLConfig
from repro_torch.convert import train_state_from_jax
from repro_torch.core.assign import apply_assignment
from repro_torch.core.packing import make_plan, reshard_plan, revise_plan
from repro_torch.embedding.state import migrate_state, reshard_state
from repro_torch.runtime import (apply_plan_meta, load_published, parse_mesh_shape,
                                 place_state, plan_meta, publish_state, reshard_live,
                                 restore_elastic)
from repro_torch.train import checkpoint as ck
from test_torch_replan import _same_plan

torch.set_num_threads(1)

PDB = 8
PLAN_KW = dict(hot_bytes=1 << 12, l2_bytes=1 << 13, narrow_dim=4, flush_iters=5,
               warmup_iters=2)
MIXES = (
    {0: "picasso", 1: "picasso", 2: "picasso"},
    {0: "picasso_l2", 1: "picasso_l2", 2: "picasso_l2"},
    {0: "picasso", 1: "picasso_l2", 2: "picasso_narrow"},
    {0: "picasso_narrow", 1: "picasso", 2: "picasso_l2"},
    {0: "picasso_l2", 1: "picasso_narrow", 2: "picasso"},
    {0: "picasso_narrow", 1: "picasso_narrow", 2: "picasso_narrow"},
)
WORLDS = (1, 2, 3, 4, 8)
BUDGETS = ((1 << 11, 1 << 12), (1 << 12, 1 << 13), (1 << 13, 0), (1 << 10, 1 << 14),
           (0, 0), (1 << 12, 0))


def _fields(mod):
    return (mod.FeatureField("a", 1001, 8, max_len=2), mod.FeatureField("b", 515, 16, max_len=1),
            mod.FeatureField("c", 259, 4, max_len=3))


class _J:
    FeatureField = JFeatureField


class _P:
    FeatureField = FeatureField


def _cfgs():
    """``tests/test_elastic.py``'s three packed groups of dims 4 / 8 / 16."""
    return (JWDLConfig(name="elastic3", fields=_fields(_J), n_dense=0,
                       interactions=(JInteractionSpec("fm"),), mlp_dims=(16, 8)),
            WDLConfig(name="elastic3", fields=_fields(_P), n_dense=0,
                      interactions=(InteractionSpec("fm"),), mlp_dims=(16, 8)))


def _plans(world, mix=None, **kw):
    jcfg, cfg = _cfgs()
    k = {**PLAN_KW, **kw}
    jp, p = jmake_plan(jcfg, world=world, per_device_batch=PDB, **k), make_plan(
        cfg, world=world, per_device_batch=PDB, **k)
    if mix is not None:
        japply_assignment(jp, dict(mix))
        apply_assignment(p, dict(mix))
    return jp, p


def _logical(g):
    return max(g.table_offsets[t.name] + t.vocab for t in g.tables)


def _seeded(jplan, seed=0):
    """The reference's host state with the FCounter seeded on logical rows
    (``tests/test_elastic.py``'s ``_host_state``), as numpy."""
    state = jax.device_get(jinit_state(JWDLModel(_cfgs()[0], jplan), jplan,
                                       jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(123 + seed)
    emb = {}
    for g in jplan.groups:
        counts = np.zeros(g.rows, np.int32)
        counts[:_logical(g)] = rng.integers(0, 50, size=_logical(g)).astype(np.int32)
        emb[str(g.gid)] = state["emb"][str(g.gid)]._replace(counts=counts)
    return {**state, "emb": emb}


def _port(jstate, plan):
    """The reference's whole host state as the port's (the whole table in
    this process, whatever the plan's world)."""
    return train_state_from_jax(jstate, dataclasses.replace(plan, world=1), "cpu")


def _leaves(tree):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in ck._flatten(tree).items()}


def _jleaves(tree):
    out = {}
    for k, v in ck._flatten(jax.device_get(tree)).items():
        out[k] = np.asarray(v)
    return out


def _bitwise(port, ref, names=None):
    got, exp = _leaves(port), _jleaves(ref)
    names = sorted(exp) if names is None else names
    assert sorted(got) == sorted(exp)
    for k in names:
        a, b = got[k], exp[k]
        if k == "step" or k.endswith("/t"):
            assert int(a) == int(b), k
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, (k, a.shape, b.shape, a.dtype, b.dtype)
        assert a.tobytes() == b.tobytes(), k


def _budgeted(jplan, plan, jstate, state, mix):
    """Both sides revised to smaller tier budgets and migrated there, so the
    tiers hold seeded rows."""
    jb, b = (jrevise_plan(jplan, hot_bytes=1 << 11, l2_bytes=1 << 12),
             revise_plan(plan, hot_bytes=1 << 11, l2_bytes=1 << 12))
    japply_assignment(jb, dict(mix))
    apply_assignment(b, dict(mix))
    return jb, b, jmigrate_state(jplan, jb, jstate), migrate_state(plan, b, state)


# ---------------------------------------------------------------- reshard_plan


@pytest.mark.parametrize("w_from,w_to,exact", [(4, 3, False), (4, 8, False), (2, 1, False),
                                               (1, 4, True), (8, 2, True)])
def test_reshard_plan_equals_the_reference(w_from, w_to, exact):
    jp, p = _plans(w_from, MIXES[2])
    shape = (w_to, 1)
    jn = jreshard_plan(jp, w_to, PDB, mesh_shape=shape, exact_capacity=exact)
    n = reshard_plan(p, w_to, PDB, mesh_shape=shape, exact_capacity=exact)
    _same_plan(n, jn)
    assert n.world == w_to and n.mesh_shape == shape
    assert (n.rev, n.cache_rows, n.l2_rows, n.strategy, n.narrow_dim) == (
        p.rev, p.cache_rows, p.l2_rows, p.strategy, p.narrow_dim)
    for g in n.groups:
        assert g.rows % w_to == 0 and 0 <= g.rows - _logical(g) < w_to
    back = reshard_plan(n, w_from, PDB)
    assert [g.rows for g in back.groups] == [g.rows for g in p.groups]


@pytest.mark.parametrize("world,shape,match", [(0, None, "positive"), (-2, None, "positive"),
                                               (4, (3, 1), "devices")])
def test_reshard_plan_validates(world, shape, match):
    jp, p = _plans(2)
    for fn, plan in ((jreshard_plan, jp), (reshard_plan, p)):
        with pytest.raises(ValueError, match=match):
            fn(plan, world, PDB, mesh_shape=shape)


def test_parse_mesh_shape():
    assert parse_mesh_shape("4x2") == (4, 2) and parse_mesh_shape("4") == (4, 1)
    assert parse_mesh_shape([2, 2]) == (2, 2)
    with pytest.raises(ValueError, match="positive"):
        parse_mesh_shape("0x2")


# ------------------------------------------------------------ reshard_state


def test_reshard_state_roundtrip_bitwise_the_reference():
    """4 -> 3 -> 4 with both tiers: every leaf bitwise the reference's
    after each recut (the sentinels remapped both ways), and the round trip
    every logical row of the start."""
    mix = MIXES[1]
    jp4, p4 = _plans(4, mix)
    js = _seeded(jp4)
    jp4, p4, js, s = _budgeted(jp4, p4, js, _port(js, p4), mix)
    _bitwise(s, js)
    jp3, p3 = jreshard_plan(jp4, 3, PDB), reshard_plan(p4, 3, PDB)
    js3, s3 = jreshard_state(jp3, js), reshard_state(p3, s)
    _bitwise(s3, js3)
    for g in p3.groups:
        k = s3["emb"][str(g.gid)].cache.keys
        assert bool(((k == g.rows) | (k < _logical(g))).all())
    jp4b, p4b = jreshard_plan(jp3, 4, PDB), reshard_plan(p3, 4, PDB)
    js4, s4 = jreshard_state(jp4b, js3), reshard_state(p4b, s3)
    _bitwise(s4, js4)
    for g in p4.groups:  # padding rows the recut to 3 dropped come back zero
        a, b = s4["emb"][str(g.gid)], s["emb"][str(g.gid)]
        n = _logical(g)
        for x, y in ((a.w, b.w), (a.acc, b.acc), (a.counts, b.counts)):
            assert torch.equal(x[:n], y[:n])
        for x, y in zip(a.cache + a.l2, b.cache + b.l2):
            assert torch.equal(x, y)


@pytest.mark.parametrize("mix", range(len(MIXES)))
@pytest.mark.parametrize("w_to", (1, 3, 8))
def test_migrate_state_across_a_row_change_bitwise_the_reference(mix, w_to):
    """``migrate_state`` from a world-4 plan to its recut (rows only) and to
    a recut with a re-mixed assignment: bitwise the reference's, narrow
    groups included."""
    jp, p = _plans(4, MIXES[0])
    js = _seeded(jp, seed=mix)
    jp, p, js, s = _budgeted(jp, p, js, _port(js, p), MIXES[0])
    jn, n = jreshard_plan(jp, w_to, PDB), reshard_plan(p, w_to, PDB)
    _bitwise(migrate_state(p, n, s), jmigrate_state(jp, jn, js))
    japply_assignment(jn, dict(MIXES[mix]))
    apply_assignment(n, dict(MIXES[mix]))
    _bitwise(migrate_state(p, n, s), jmigrate_state(jp, jn, js))


def test_reshard_live_in_one_process_is_the_reference_without_a_mesh():
    jp, p = _plans(8, MIXES[2])
    js = _seeded(jp)
    jp, p, js, s = _budgeted(jp, p, js, _port(js, p), MIXES[2])
    from repro.runtime import reshard_live as jreshard_live

    jn, jst = jreshard_live(jp, js, 3, PDB, mesh_shape=(3, 1))
    n, st, grp = reshard_live(p, s, 3, PDB, mesh_shape=(3, 1))
    _same_plan(n, jn)
    _bitwise(st, jst)
    assert grp is None
    n1, st1, grp1 = reshard_live(n, st, 1, PDB)
    assert grp1 is not None and grp1.world == 1 and n1.world == 1
    _bitwise(st1, jreshard_live(jn, jst, 1, PDB)[1])


def test_reshard_state_refuses_to_drop_live_rows():
    """A nonzero FCounter in a truncated padding row raises, as the
    reference's does."""
    jp2, p2 = _plans(2)
    js = _seeded(jp2)
    gid = max(g.gid for g in p2.groups)
    g = p2.group(gid)
    target, jtarget = reshard_plan(p2, 3, PDB), jreshard_plan(jp2, 3, PDB)
    if target.group(gid).rows >= g.rows:
        target, jtarget = reshard_plan(p2, 1, PDB), jreshard_plan(jp2, 1, PDB)
    assert target.group(gid).rows < g.rows
    counts = js["emb"][str(gid)].counts.copy()
    counts[-1] = 7
    js["emb"][str(gid)] = js["emb"][str(gid)]._replace(counts=counts)
    s = _port(js, p2)
    with pytest.raises(ValueError, match="nonzero FCounter"):
        jreshard_state(jtarget, js)
    with pytest.raises(ValueError, match="nonzero FCounter"):
        reshard_state(target, s)
    with pytest.raises(ValueError, match="nonzero FCounter"):
        migrate_state(p2, target, s)


def test_place_state_gives_each_rank_its_rows():
    from repro_torch.dist.compat import Group

    jp, p = _plans(4, MIXES[1])
    s = _port(_seeded(jp), p)
    for r in range(4):
        mine = place_state(s, p, Group(r, 4))
        for g in p.groups:
            rps = g.rows // 4
            a, b = mine["emb"][str(g.gid)], s["emb"][str(g.gid)]
            assert torch.equal(a.w, b.w[r * rps:(r + 1) * rps])
            assert torch.equal(a.counts, b.counts[r * rps:(r + 1) * rps])
            assert a.cache.keys is b.cache.keys
        assert mine["dense"] is s["dense"]
    wrong = reshard_plan(p, 3, PDB)
    with pytest.raises(ValueError, match="recut it first"):
        place_state(s, wrong, Group(0, 3))


# ---------------------------------------- property chains, side by side


OPS = st.lists(st.tuples(st.sampled_from(["rebudget", "strategy", "world"]),
                         st.integers(0, 5)), min_size=1, max_size=4)


@settings(max_examples=6, deadline=None)
@given(OPS)
def test_random_revision_chains_bitwise_the_reference(ops):
    """Any chain of tier resizes, strategy re-mixes (narrow <-> wide) and
    world resizes: after every revision the port's state is bitwise the
    reference's, leaf for leaf."""
    jp, p = _plans(4, MIXES[0])
    js = _seeded(jp)
    s = _port(js, p)
    for kind, pick in ops:
        if kind == "rebudget":
            hot, l2b = BUDGETS[pick % len(BUDGETS)]
            jn, n = (jrevise_plan(jp, hot_bytes=hot, l2_bytes=l2b),
                     revise_plan(p, hot_bytes=hot, l2_bytes=l2b))
            japply_assignment(jn, dict(jp.strategy))
            apply_assignment(n, dict(p.strategy))
        elif kind == "strategy":
            jn, n = jrevise_plan(jp), revise_plan(p)
            for a, b in ((jn, jp), (n, p)):
                a.cache_rows, a.l2_rows = dict(b.cache_rows), dict(b.l2_rows)
            japply_assignment(jn, dict(MIXES[pick % len(MIXES)]))
            apply_assignment(n, dict(MIXES[pick % len(MIXES)]))
        else:
            w = WORLDS[pick % len(WORLDS)]
            jn, n = jreshard_plan(jp, w, PDB), reshard_plan(p, w, PDB)
        js, s = jmigrate_state(jp, jn, js), migrate_state(p, n, s)
        jp, p = jn, n
        _same_plan(p, jp)
        _bitwise(s, js)


# ------------------------------------------------- checkpoint portability


def _written(w_from, writer, d):
    """A world-``w_from`` state with seeded, budgeted tiers, saved at step 5
    by ``writer`` ('repro' or 'port'); both packages' states and plans."""
    jp, p = _plans(w_from, MIXES[2], mesh_shape=(w_from, 1))
    js = _seeded(jp)
    jp, p, js, s = _budgeted(jp, p, js, _port(js, p), MIXES[2])
    if writer == "repro":
        jsave_checkpoint(str(d), 5, js, meta=jplan_meta(jp))
    else:
        ck.save_checkpoint(str(d), 5, s, meta=plan_meta(p))
    return jp, p, js, s


@pytest.mark.parametrize("writer", ("repro", "port"))
@pytest.mark.parametrize("w_from,w_to", [(8, 3), (2, 8)])
def test_checkpoint_restores_at_another_world_bitwise_in_both_packages(tmp_path, writer,
                                                                       w_from, w_to):
    """A checkpoint written at one world by either package restores at
    another through ``restore_elastic`` in both: every leaf bitwise alike,
    every logical row the written state's, the sentinels remapped."""
    jp, p, js, s = _written(w_from, writer, tmp_path)
    jdst = jmake_plan(_cfgs()[0], world=w_to, per_device_batch=PDB, **PLAN_KW,
                      mesh_shape=(w_to, 1))
    from repro.runtime import apply_plan_meta as japply_plan_meta

    jdst = japply_plan_meta(jdst, jplan_meta(jp))
    dst = apply_plan_meta(_plans(w_to, mesh_shape=(w_to, 1))[1], plan_meta(p))
    _same_plan(dst, jdst)
    jtemplate = jax.device_get(jinit_state(JWDLModel(_cfgs()[0], jdst), jdst,
                                           jax.random.PRNGKey(9)))
    logs = []
    got, step = restore_elastic(str(tmp_path), dst, _port(jtemplate, dst), log=logs.append)
    exp, jstep = jrestore_elastic(str(tmp_path), jdst, jtemplate)
    assert step == jstep == 5
    assert logs == [f"restored world={w_from} checkpoint at world={w_to} (resharded step 5)"]
    _bitwise(got, exp)
    for g in dst.groups:
        a, b = got["emb"][str(g.gid)], s["emb"][str(g.gid)]
        n = _logical(g)
        assert a.w.shape[0] == g.rows
        for x, y in ((a.w, b.w), (a.acc, b.acc), (a.counts, b.counts)):
            assert torch.equal(x[:n], y[:n])
        k = a.cache.keys
        assert bool(((k == g.rows) | (k < n)).all())


def test_stale_meta_checkpoint(tmp_path):
    """A checkpoint whose meta records no world restores at the matching
    world and fails with the elastic diagnosis at another, a ValueError in
    both packages."""
    jp2, p2 = _plans(2)
    js = _seeded(jp2)
    s = _port(js, p2)
    meta = plan_meta(p2)
    del meta["world"], meta["mesh_shape"]
    ck.save_checkpoint(str(tmp_path), 3, s, meta=meta)
    same = apply_plan_meta(_plans(2)[1], meta)
    restored, _ = restore_elastic(str(tmp_path), same, _port(_seeded(jp2, 1), same))
    assert torch.equal(restored["emb"]["1"].w, s["emb"]["1"].w)
    jp3, p3 = _plans(3)
    other = apply_plan_meta(p3, meta)
    with pytest.raises(ValueError, match="different world size"):
        restore_elastic(str(tmp_path), other, _port(_seeded(jp3, 1), other))
    with pytest.raises(ValueError, match="different world size"):
        jrestore_elastic(str(tmp_path), jp3, _seeded(jp3, 1))


# ------------------------------------------------ publish / pickup handoff


def _serving(state):
    return {"emb": state["emb"], "dense": state["dense"]}


def test_published_delta_is_recut_onto_the_consumers_plan(tmp_path):
    """A delta published at world 2 loads at world 3 recut, bitwise the
    reference's cross-world pickup; without a plan it raises, and a delta of
    another plan revision raises before anything is written."""
    jp, p = _plans(2, MIXES[1], mesh_shape=(2, 1))
    js = _seeded(jp)
    jp, p, js, s = _budgeted(jp, p, js, _port(js, p), MIXES[1])
    pub = str(tmp_path / "pub")
    publish_state(pub, 10, _serving(s), meta=plan_meta(p))
    jp3, p3 = jreshard_plan(jp, 3, PDB), reshard_plan(p, 3, PDB)
    jt = _seeded(jp3, 4)
    got, step = load_published(pub, _serving(_port(jt, p3)), plan=p3)
    exp, _ = jload_published(pub, {"emb": jt["emb"], "dense": jt["dense"]}, plan=jp3)
    assert step == 10
    _bitwise(got, exp)
    with pytest.raises(ValueError, match="different world size"):
        load_published(pub, _serving(_port(jt, p3)))
    # another revision: the tiers differ as well as the rows
    jb, b = (jrevise_plan(jp3, hot_bytes=1 << 12, l2_bytes=1 << 13),
             revise_plan(p3, hot_bytes=1 << 12, l2_bytes=1 << 13))
    apply_assignment(b, dict(MIXES[1]))
    japply_assignment(jb, dict(MIXES[1]))
    template = _serving(_port(_seeded(jb, 5), b))
    before = {k: v.clone() for k, v in ck._flatten(template).items()}
    with pytest.raises(ValueError, match="another plan revision"):
        load_published(pub, template, plan=b)
    for k, v in ck._flatten(template).items():
        assert torch.equal(v, before[k]), k


REF_PUBLISH = """
from repro.configs.base import FeatureField, InteractionSpec, WDLConfig
from repro.core.assign import apply_assignment
from repro.core.packing import make_plan, reshard_plan, revise_plan
from repro.embedding.state import migrate_state
from repro.models.wdl import WDLModel
from repro.runtime import load_published, place_state, plan_meta, publish_state
from repro.train import checkpoint as ck
from repro.train.train_step import init_state
fields = (FeatureField("a", 1001, 8, max_len=2), FeatureField("b", 515, 16, max_len=1),
          FeatureField("c", 259, 4, max_len=3))
cfg = WDLConfig(name="elastic3", fields=fields, n_dense=0,
                interactions=(InteractionSpec("fm"),), mlp_dims=(16, 8))
MIX = {0: "picasso_l2", 1: "picasso_l2", 2: "picasso_l2"}
plan = make_plan(cfg, world=4, per_device_batch=8, mesh_shape=(2, 2), **inp["plan_kw"])
apply_assignment(plan, dict(MIX))
state = jax.device_get(init_state(WDLModel(cfg, plan), plan, jax.random.PRNGKey(0)))
rng = np.random.default_rng(7)
emb = {}
for g in plan.groups:
    n = max(g.table_offsets[t.name] + t.vocab for t in g.tables)
    counts = np.zeros(g.rows, np.int32)
    counts[:n] = rng.integers(0, 50, size=n).astype(np.int32)
    emb[str(g.gid)] = state["emb"][str(g.gid)]._replace(counts=counts)
state = {**state, "emb": emb}
bud = revise_plan(plan, hot_bytes=1 << 11, l2_bytes=1 << 12)
apply_assignment(bud, dict(MIX))
state = place_state(migrate_state(plan, bud, state), bud, mesh, AXES)
publish_state(inp["pub"], 10, {"emb": state["emb"], "dense": state["dense"]},
              meta=plan_meta(bud))
one = reshard_plan(bud, 1, 32)
tmpl = jax.device_get(init_state(WDLModel(cfg, one), one, jax.random.PRNGKey(3)))
loaded, _ = load_published(inp["pub"], {"emb": tmpl["emb"], "dense": tmpl["dense"]},
                           plan=one)
out["loaded"] = {k: np.asarray(v) for k, v in ck._flatten(jax.device_get(loaded)).items()}
out["template"] = {"emb": tmpl["emb"], "dense": tmpl["dense"]}
out["meta"] = plan_meta(bud)
"""


def test_load_published_of_the_references_world_4_delta(tmp_path):
    """The reference publishes at world 4 (mesh 2x2, forced host devices);
    the port's world-1 consumer recuts the delta bitwise the reference's
    own world-1 load of it."""
    from repro_torch.convert import state_from_jax
    from test_torch_dist import run_reference

    pub = str(tmp_path / "pub")
    ref = run_reference(REF_PUBLISH, {"pub": pub, "plan_kw": PLAN_KW}, tmp_path)
    four = apply_plan_meta(_plans(4, mesh_shape=(2, 2))[1], ref["meta"])
    one = reshard_plan(four, 1, 32)
    emb, dense = state_from_jax(ref["template"]["emb"], ref["template"]["dense"], one, "cpu")
    got, step = load_published(pub, {"emb": emb, "dense": dense}, plan=one)
    assert step == 10
    mine = _leaves(got)
    assert sorted(mine) == sorted(ref["loaded"])
    for k, v in ref["loaded"].items():
        assert mine[k].dtype == v.dtype and mine[k].tobytes() == v.tobytes(), k
    assert any(int((mine[f"emb/{g.gid}/l2/keys"] < g.rows).sum()) for g in one.groups)



# ------------------------------------------------ the launcher's --stream resume


# the reference's launcher can abort in its teardown (its prefetcher's daemon
# thread inside XLA): once main has returned, exit at once
_REF_TRAIN = ("import os, sys; from repro.launch.train import main; main(); "
              "sys.stdout.flush(); sys.stderr.flush(); os._exit(0)")


def test_stream_resumes_a_world_2_checkpoint_at_world_1_as_the_reference(tmp_path):
    """The reference's launcher streams at world 2 (mesh 2x1, checkpoints at
    steps 2, 4 and 6); copies of its directory resumed at world 1 with
    ``--stream --stream-segments 1`` restore elastically in both launchers
    and train steps 7 and 8 to the same printed losses."""
    import os
    import re
    import shutil
    import subprocess
    import sys

    from test_torch_dist import HASH_SEED, ROOT, ref_env

    flags = ["--arch", "deepfm", "--smoke", "--global-batch", "64", "--log-every", "1",
             "--stream", "--segment-steps", "2"]

    def run(entry, d, *extra, env):
        proc = subprocess.run([sys.executable, *entry, *flags, "--ckpt-dir", str(d), *extra],
                              capture_output=True, text=True, timeout=600, env=env)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return proc.stdout

    ref = ["-c", _REF_TRAIN]
    run(ref, tmp_path / "ck", "--devices", "2", "--mesh", "2x1", "--stream-segments", "3",
        env=ref_env())
    shutil.copytree(tmp_path / "ck", tmp_path / "port")
    exp = run(ref, tmp_path / "ck", "--stream-segments", "1", env=ref_env())
    port_env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PYTHONHASHSEED=HASH_SEED,
                    OMP_NUM_THREADS="1")
    got = run(["-m", "repro_torch.launch.train"], tmp_path / "port", "--device", "cpu",
              "--stream-segments", "1", env=port_env)
    line = "[train] elastic restored world=2 checkpoint at world=1 (resharded step 6)"
    assert line in exp and line in got, got
    pat = r"^  step +(\d+) loss=(\S+) .*$"
    losses = re.findall(pat, got, re.M)
    assert [s for s, _ in losses] == ["7", "8"]
    assert losses == re.findall(pat, exp, re.M)
    assert "[train] stream done at step 8 (world=1)" in got
