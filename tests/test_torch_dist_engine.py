"""The engine at world 4, strategy by strategy, against the reference.

Every case starts both sides from the reference's ``init_embedding_state``
(the port's 4 ranks each take their rows, ``convert.state_from_jax(...,
group=)``), fills the FCounter with tied counts (0-3) and, where the case
has a tier, flushes it (the gathered top-k, ties broken toward the lower
gathered index), then runs one engine forward and backward (the pooled
vectors as their own gradient) on the same deepfm-smoke batch of 64, 16 a
rank (the mixed case: six small tables, one group each, on six
strategies). Held shard by shard: the integer results (the flushed keys, ``uniq``,
``inv``, hits, ``send_slot``, ``recv_ids``, ``overflow``, the FCounter)
bitwise, the floats (pooled vectors, masters, accumulators, tiers,
projection) within 1e-5 of their scale, and every rank's replicated tiers
bitwise alike. The reference runs in one subprocess on 4 forced host
devices (mesh 2x2); the port in one spawn of 4 gloo ranks
(``tests/test_torch_dist.py``).
"""
import types

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import FeatureField as JFeatureField
from repro.configs.base import InteractionSpec as JInteractionSpec
from repro.configs.base import WDLConfig as JWDLConfig
from repro.data.synthetic import make_batch as jmake_batch
from test_torch_dist import W, run_port, run_reference

torch.set_num_threads(1)

B = 64                      # global batch, 16 a rank
L2_PSUM = 44_000            # 1,000 L2 rows: the dense psum is the cheaper reduction
L2_GATHER = 176_000         # 4,000 L2 rows: the all_gather is
MIX = ("picasso", "ps", "picasso_l2", "hybrid", "allgather_rows", "mp_nodedup")

CASES = {
    "picasso": dict(strategy="picasso", plan=dict(hot_bytes=1 << 16), warm=True),
    "picasso-stale": dict(strategy="picasso", plan=dict(hot_bytes=1 << 16), warm=True,
                          engine=dict(cache_update="stale")),
    "picasso-overflow": dict(strategy="picasso", plan=dict(hot_bytes=1 << 16), warm=True,
                             capacity=24),
    "picasso-fp16": dict(strategy="picasso", plan=dict(hot_bytes=1 << 16), warm=True,
                         engine=dict(grad_compress="fp16")),
    "hybrid": dict(strategy="hybrid", plan={}),
    "ps": dict(strategy="ps", plan={}),
    "ps-topk": dict(strategy="ps", plan={}, engine=dict(grad_compress="topk")),
    "picasso_l2-psum": dict(strategy="picasso_l2",
                            plan=dict(hot_bytes=1 << 14, l2_bytes=L2_PSUM), warm=True),
    "picasso_l2-gather": dict(strategy="picasso_l2",
                              plan=dict(hot_bytes=1 << 14, l2_bytes=L2_GATHER), warm=True),
    "picasso_narrow": dict(strategy="picasso_narrow",
                           plan=dict(hot_bytes=1 << 14, l2_bytes=L2_GATHER, narrow_dim=4),
                           warm=True),
    "mp_nodedup": dict(strategy="mp_nodedup", plan=dict(exact_capacity=True)),
    "allgather_rows": dict(strategy="allgather_rows", plan={}),
    "mixed": dict(strategy="mix", cfg="mix6", plan=dict(enable_packing=False,
                                                        exact_capacity=True,
                                                        hot_bytes=1 << 12), warm=True),
}

CTX_FIELDS = ("uniq", "inv", "hit", "cache_slot", "recv_ids", "l2_hit", "l2_slot", "ids")

# the same helpers on both sides (each runs them with its own classes)
SETUP = """
def config_of(case, get_config, FeatureField, InteractionSpec, WDLConfig):
    # deepfm-smoke, or for the mixed case six small tables, unpacked (one
    # group a table, each group on its own strategy)
    if case.get("cfg") != "mix6":
        return get_config("deepfm", smoke=True)
    vocabs = (50, 3000, 120, 9000, 700, 20000)
    fields = tuple(FeatureField(f"f{i}", v, 8, max_len=1 + i % 2, pooling="sum")
                   for i, v in enumerate(vocabs))
    return WDLConfig(name="mix6", fields=fields, n_dense=0,
                     interactions=(InteractionSpec("fm"),), mlp_dims=(8,))


def ctx_info(ctx):
    out = {f: getattr(ctx, f) for f in CTX_FIELDS if getattr(ctx, f, None) is not None}
    r = getattr(ctx, "routing", None)
    if r is not None:
        out["send_slot"], out["overflow"] = r.send_slot, r.overflow
    return out


def strategy_of(case, plan):
    if case["strategy"] == "mix":
        return {g.gid: MIX[g.gid % len(MIX)] for g in plan.groups}
    return case["strategy"]
"""

REF_BODY = """
from repro.configs import get_config
from repro.configs.base import FeatureField, InteractionSpec, WDLConfig
from repro.core.features import pack_group
from repro.core.packing import make_plan
from repro.dist.sharding import batch_specs, emb_specs
from repro.embedding.state import init_embedding_state
from repro.engine import EmbeddingEngine, resolve_assignment
CASES, CTX_FIELDS, MIX, B = inp["cases"], inp["ctx_fields"], inp["mix"], inp["B"]
counts_seed = 5
exec(inp["setup"])


def np_state(emb):
    def tier(t):
        return None if t is None else tuple(np.asarray(x) for x in t)
    return {k: {"w": np.asarray(s.w), "acc": np.asarray(s.acc), "counts": np.asarray(s.counts),
                "cache": tier(s.cache), "l2": tier(s.l2), "proj": tier(s.proj)}
            for k, s in emb.items()}


for name, case in CASES.items():
    cfg = config_of(case, get_config, FeatureField, InteractionSpec, WDLConfig)
    batch = inp["batches"][name]
    plan = make_plan(cfg, world=W, per_device_batch=B // W, mesh_shape=(2, 2), **case["plan"])
    strategy = strategy_of(case, plan)
    resolve_assignment(plan, strategy, world=W)
    emb0 = {str(g): s for g, s in init_embedding_state(jax.random.PRNGKey(0), plan).items()}
    rng = np.random.default_rng(counts_seed)
    emb0 = {k: s._replace(counts=jnp.asarray(rng.integers(0, 4, s.counts.shape[0])
                                             .astype(np.int32)))
            for k, s in emb0.items()}
    res = {"init": np_state(emb0)}
    ekw = dict(case.get("engine", {}))
    cap = case.get("capacity")
    caps = None if cap is None else {g.gid: cap for g in plan.groups}
    engine = EmbeddingEngine(plan, AXES, W, strategy=strategy, use_fused_kernels="off",
                             lr_emb=0.1, capacity=caps, **ekw)
    especs = emb_specs(plan, AXES)
    emb = emb0
    if case.get("warm"):
        flush = jax.jit(shard_map(engine.flush, mesh=mesh, in_specs=(especs,),
                                  out_specs=especs, check_vma=False))
        emb = flush(emb)
        res["flushed"] = np_state(emb)

    def fb(emb, fields):
        packed = {g.gid: pack_group(g, fields) for g in plan.groups}
        pooled, ectx = engine.forward(emb, packed)
        emb2, met = engine.backward(emb, ectx, pooled)
        ctx = {gid: jax.tree.map(lambda y: jnp.asarray(y)[None], ctx_info(c))
               for gid, c in ectx.ctxs.items()}
        return pooled, emb2, {k: v[None] for k, v in met.items()}, ctx

    fields = batch["fields"]
    g = jax.jit(shard_map(fb, mesh=mesh, in_specs=(especs, batch_specs(fields, AXES)),
                          out_specs=(P(AXES), especs, P(AXES), P(AXES)), check_vma=False))
    pooled, emb2, met, ctx = g(emb, jax.tree.map(jnp.asarray, fields))
    res["pooled"] = {k: np.asarray(v) for k, v in pooled.items()}
    res["after"] = np_state(emb2)
    res["met"] = {k: np.asarray(v) for k, v in met.items()}
    res["ctx"] = jax.tree.map(np.asarray, ctx)
    out[name] = res
"""


def _ns(st):
    """A reference state (plain dicts of numpy) as ``state_from_jax`` reads
    it, by attribute."""
    return {k: types.SimpleNamespace(**v) for k, v in st.items()}


def _port_cases(group, cases, init, batches, setup):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FeatureField, InteractionSpec, WDLConfig
    from repro_torch.convert import state_from_jax
    from repro_torch.core.features import pack_group
    from repro_torch.core.packing import make_plan
    from repro_torch.dist.sharding import batch_slice
    from repro_torch.engine import EmbeddingEngine, resolve_assignment

    scope = {"CTX_FIELDS": CTX_FIELDS, "MIX": MIX}
    exec(setup, scope)
    ctx_info, strategy_of = scope["ctx_info"], scope["strategy_of"]

    def state_np(emb):
        def tier(t):
            return None if t is None else tuple(x.numpy().copy() for x in t)
        return {k: {"w": s.w.numpy().copy(), "acc": s.acc.numpy().copy(),
                    "counts": s.counts.numpy().copy(), "cache": tier(s.cache),
                    "l2": tier(s.l2), "proj": tier(s.proj)} for k, s in emb.items()}

    out = {}
    for name, case in cases.items():
        cfg = scope["config_of"](case, get_config, FeatureField, InteractionSpec, WDLConfig)
        fields = batch_slice(batches[name]["fields"], group)
        plan = make_plan(cfg, world=W, per_device_batch=B // W, mesh_shape=(2, 2),
                         **case["plan"])
        strategy = strategy_of(case, plan)
        resolve_assignment(plan, strategy, world=W)
        emb, _ = state_from_jax(_ns(init[name]), {}, plan, "cpu", group=group)
        cap = case.get("capacity")
        engine = EmbeddingEngine(
            plan, W, strategy=strategy, use_fused_kernels="off", lr_emb=0.1, group=group,
            capacity=None if cap is None else {g.gid: cap for g in plan.groups},
            **case.get("engine", {}))
        res = {}
        if case.get("warm"):
            emb = engine.flush(emb)
            res["flushed"] = state_np(emb)
        packed = {g.gid: pack_group(g, fields, "cpu") for g in plan.groups}
        pooled, ectx = engine.forward(emb, packed)
        emb2, met = engine.backward(emb, ectx, pooled)
        res["pooled"] = {gid: v.numpy() for gid, v in pooled.items()}
        res["after"] = state_np(emb2)
        res["met"] = {k: v.numpy() for k, v in met.items()}
        res["ctx"] = {gid: {k: v.numpy() for k, v in ctx_info(c).items()}
                      for gid, c in ectx.ctxs.items()}
        res["n_ids"] = {gid: pb.ids.shape[0] for gid, pb in packed.items()}
        recv = {}
        for gid, c in ectx.ctxs.items():
            if getattr(c, "recv_ids", None) is not None:
                others = [p for p in range(W) if p != group.rank]
                recv[gid] = int((c.recv_ids[others] >= 0).sum())
        res["recv_from_others"] = recv
        out[name] = res
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_engine")
    scope = {}
    exec(SETUP, scope)
    batches = {name: jmake_batch(scope["config_of"](case, jget_config, JFeatureField,
                                                    JInteractionSpec, JWDLConfig),
                                 B, np.random.default_rng(3))
               for name, case in CASES.items()}
    ref = run_reference(REF_BODY, {"cases": CASES, "ctx_fields": CTX_FIELDS, "mix": MIX,
                                   "B": B, "setup": SETUP, "batches": batches}, tmp,
                        timeout=900)
    init = {name: r["init"] for name, r in ref.items()}
    port = run_port(_port_cases, CASES, init, batches, SETUP, tmp=tmp)
    return ref, port


def _close(got, exp, what):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape, (what, got.shape, exp.shape)
    scale = max(float(np.max(np.abs(exp))) if exp.size else 0.0, 1e-30)
    err = float(np.max(np.abs(got - exp))) if exp.size else 0.0
    assert err <= 1e-5 * scale, (what, err, scale)


def _rows_of(port, name, phase, key, leaf):
    """A row-sharded leaf of every rank, concatenated in rank order."""
    return np.concatenate([p[name][phase][key][leaf] for p in port])


def _check_state(ref_st, port, name, phase):
    for key, exp in ref_st.items():
        np.testing.assert_array_equal(_rows_of(port, name, phase, key, "counts"),
                                      exp["counts"], err_msg=f"{name}/{phase}/{key}/counts")
        for leaf in ("w", "acc"):
            _close(_rows_of(port, name, phase, key, leaf), exp[leaf],
                   f"{name}/{phase}/{key}/{leaf}")
        for tier in ("cache", "l2", "proj"):
            if exp[tier] is None:
                assert all(p[name][phase][key][tier] is None for p in port)
                continue
            mine = port[0][name][phase][key][tier]
            for p in port[1:]:   # replicas stay bitwise alike
                for a, b in zip(p[name][phase][key][tier], mine):
                    assert a.tobytes() == b.tobytes(), f"{name}/{phase}/{key}/{tier} replica"
            if tier != "proj":
                np.testing.assert_array_equal(mine[0], exp[tier][0],
                                              err_msg=f"{name}/{phase}/{key}/{tier}.keys")
            for i in range(1 if tier != "proj" else 0, len(mine)):
                _close(mine[i], exp[tier][i], f"{name}/{phase}/{key}/{tier}[{i}]")


@pytest.mark.parametrize("name", list(CASES))
def test_engine_step_matches_reference_shard_by_shard(runs, name):
    ref, port = runs
    r = ref[name]
    if "flushed" in r:
        _check_state(r["flushed"], port, name, "flushed")
    for gid, exp in r["pooled"].items():
        got = np.concatenate([p[name]["pooled"][gid] for p in port])
        _close(got, exp, f"{name}/pooled/{gid}")
    for gid, fields in r["ctx"].items():
        for f, exp in fields.items():
            got = np.stack([p[name]["ctx"][gid][f] for p in port])
            np.testing.assert_array_equal(got, exp, err_msg=f"{name}/ctx/{gid}/{f}")
    for k, exp in r["met"].items():
        got = np.stack([p[name]["met"][k] for p in port])
        np.testing.assert_array_equal(got, exp, err_msg=f"{name}/met/{k}")
    _check_state(r["after"], port, name, "after")


def test_the_cases_cover_what_they_name(runs):
    """Hits where a tier is warm, an overflowing bucket, rows routed between
    ranks, and both of the L2 tier's reductions."""
    from repro_torch.core.packed_embedding import l2_reduction

    ref, port = runs
    hits = {n: int(ref[n]["met"]["cache_hits"].sum()) for n in CASES}
    assert all(hits[n] > 0 for n in CASES if CASES[n].get("warm")), hits
    assert int(ref["picasso-overflow"]["met"]["overflow"].sum()) > 0
    assert all(int(ref[n]["met"]["overflow"].sum()) == 0 for n in CASES
               if n != "picasso-overflow")
    for n in ("picasso", "hybrid", "mp_nodedup", "picasso_narrow"):
        for p in port:
            assert sum(p[n]["recv_from_others"].values()) > 0, n
    assert int(ref["picasso_l2-psum"]["met"]["cache_hits/l2"].sum()) > 0
    assert int(ref["picasso_l2-gather"]["met"]["cache_hits/l2"].sum()) > 0
    for n, want in (("picasso_l2-psum", "psum"), ("picasso_l2-gather", "all_gather")):
        (h2,) = {r["l2"][0].shape[0] for r in ref[n]["after"].values()}
        (n_ids,) = set(port[0][n]["n_ids"].values())
        assert l2_reduction(W, n_ids, 10, h2) == want, (n, h2, n_ids)
    assert {f"overflow/{n}" for n in MIX} <= set(ref["mixed"]["met"])
