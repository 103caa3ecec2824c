"""The port's remaining lookup strategies (``hybrid``, ``ps``,
``mp_nodedup``, ``allgather_rows``) and per-group strategy mixing against
the reference on the CPU, on the same numpy inputs, the reference under
``mesh1``.

- ``ps_lookup`` and ``mp_lookup_nodedup``: bitwise, ids outside ``[0, rps)``
  and heavy duplicates included.
- One engine forward + backward per strategy (deepfm-smoke,
  ``exact_capacity=True``, no cache): pooled outputs and updated tables
  within 1e-5 of the reference's same strategy and of the port's
  ``picasso``, as the reference holds its strategies.
- Mixing on the reference's two-table config (one ``ps`` group, one cached
  ``picasso`` group): dispatch, tier gating, metric keys, the flush that
  skips the ``ps`` group, and 5 training steps and a request against the
  reference.
- Trajectories (``check_train_trajectory``'s bars: loss rtol 1e-4 / atol
  1e-5, hits exactly, state atol 1e-4): a five-name assignment over the
  unpacked deepfm-smoke plan, and ``ps`` and ``allgather_rows`` under
  routed-gradient compression, each step from a shared state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.configs.base import FeatureField as JFeatureField
from repro.configs.base import InteractionSpec as JInteractionSpec
from repro.configs.base import WDLConfig as JWDLConfig
from repro.core import packed_embedding as jpe
from repro.core.assign import apply_assignment as japply_assignment
from repro.core.assign import compile_assignment as jcompile_assignment
from repro.core.features import pack_group as jpack_group
from repro.core.packing import make_plan as jmake_plan
from repro.data.synthetic import make_batch as jmake_batch
from repro.dist.compat import shard_map
from repro.dist.sharding import batch_specs, emb_specs, replicated, to_named
from repro.embedding.state import init_embedding_state as jinit_embedding_state
from repro.engine import EmbeddingEngine as JEngine
from repro.engine import available_strategies as javailable_strategies
from repro.models.wdl import WDLModel as JWDLModel
from repro.serve.serve_step import ServeConfig as JServeConfig
from repro.serve.serve_step import make_serve_step as jmake_serve_step
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import init_state as jinit_state
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.configs.base import FeatureField, InteractionSpec, WDLConfig
from repro_torch.convert import state_from_jax, train_state_from_jax
from repro_torch.core import packed_embedding as pe
from repro_torch.core.features import pack_group
from repro_torch.core.packing import make_plan
from repro_torch.data.synthetic import make_batch
from repro_torch.embedding.state import init_embedding_state, tier_gates
from repro_torch.engine import (AllGatherRowsStrategy, EmbeddingEngine, HybridStrategy,
                                MPNoDedupStrategy, PicassoStrategy, PSStrategy,
                                available_strategies, compile_assignment, get_strategy)
from repro_torch.kernels import ops
from repro_torch.models.wdl import WDLModel
from repro_torch.serve.serve_step import ServeConfig, make_serve_step
from repro_torch.train.train_step import (TrainConfig, init_state, make_flush_fn,
                                          make_train_step)
from test_torch_compress import _TieAwareTopk
from test_torch_train import _check_state, check_train_trajectory

torch.set_num_threads(1)

AXES = ("data", "model")
GB = 16
NEW = ("hybrid", "ps", "mp_nodedup", "allgather_rows")


def _t(x):
    return torch.as_tensor(np.array(x))


# ------------------------------------------------------------ primitives
ROWS, D, N = 300, 10, 96


def _ids(kind: str, rng) -> np.ndarray:
    """Lookup ids of one case: uniform, eight distinct ids repeated (heavy
    duplicates), or a quarter of them outside ``[0, ROWS)`` (the sentinel
    ``ROWS`` among them)."""
    if kind == "uniform":
        return rng.integers(0, ROWS, N).astype(np.int32)
    if kind == "duplicates":
        return rng.choice(rng.integers(0, ROWS, 8), N).astype(np.int32)
    ids = rng.integers(0, ROWS, N)
    out = rng.random(N) < 0.25
    ids[out] = rng.choice([ROWS, ROWS + 7, 2 * ROWS], int(out.sum()))
    return ids.astype(np.int32)


@pytest.mark.parametrize("kind", ["uniform", "duplicates", "out_of_range", "negative"])
def test_ps_lookup_is_bitwise_the_reference(mesh1, kind):
    rng = np.random.default_rng(5)
    w = rng.normal(size=(ROWS, D)).astype(np.float32)
    ids = (rng.integers(-ROWS, ROWS, N).astype(np.int32) if kind == "negative"
           else _ids(kind, rng))
    g = jax.jit(shard_map(lambda w, ids: jpe.ps_lookup(w, ids, axes=AXES, world=1),
                          mesh=mesh1, in_specs=(P(AXES, None), P()), out_specs=P(),
                          check_vma=False))
    exp = np.asarray(g(jnp.asarray(w), jnp.asarray(ids)))
    got = pe.ps_lookup(_t(w), _t(ids), world=1).numpy()
    np.testing.assert_array_equal(got, exp)
    outside = (ids < 0) | (ids >= ROWS)
    assert (got[outside] == 0).all()
    assert outside.any() == (kind in ("out_of_range", "negative"))
    np.testing.assert_array_equal(got[~outside], w[ids[~outside]])
    with pytest.raises(ValueError, match="world=2 needs a repro_torch.dist.Group"):
        pe.ps_lookup(_t(w), _t(ids), world=2)


@pytest.mark.parametrize("kind", ["uniform", "duplicates", "out_of_range"])
@pytest.mark.parametrize("cap", [N, 40])
def test_mp_lookup_nodedup_is_bitwise_the_reference(mesh1, kind, cap):
    """Rows, routing and the owner side bitwise, overflow included at a
    bucket capacity under ``n``; the ctx carries the stable sort, so
    ``inv[order]`` is ``arange(n)`` and no tier is probed."""
    rng = np.random.default_rng(6)
    w = rng.normal(size=(ROWS, D)).astype(np.float32)
    ids = _ids(kind, rng)

    def f(w, ids):
        rows, ctx = jpe.mp_lookup_nodedup(w, ids, axes=AXES, world=1, capacity=cap)
        r = ctx.routing
        return (rows, ctx.uniq, ctx.inv, r.owner, r.pos, r.send_slot, r.kept, r.overflow,
                ctx.recv_ids, ctx.recv_local, ctx.recv_valid)

    g = jax.jit(shard_map(f, mesh=mesh1, in_specs=(P(AXES, None), P()), out_specs=(P(),) * 11,
                          check_vma=False))
    exp = [np.asarray(x) for x in g(jnp.asarray(w), jnp.asarray(ids))]
    rows, ctx = pe.mp_lookup_nodedup(_t(w), _t(ids), world=1, capacity=cap)
    r = ctx.routing
    got = (rows, ctx.uniq, ctx.inv, r.owner, r.pos, r.send_slot, r.kept, r.overflow,
           ctx.recv_ids, ctx.recv_local, ctx.recv_valid)
    for a, b in zip(got, exp):
        np.testing.assert_array_equal(a.numpy(), b)
    assert (int(r.overflow) > 0) == (cap < N)
    assert ctx.order.dtype == torch.int64 and ctx.slot_sorted.dtype == torch.int32
    assert torch.equal(ctx.order, torch.argsort(_t(ids), stable=True))
    assert torch.equal(ctx.slot_sorted, torch.arange(N, dtype=torch.int32))
    assert torch.equal(ctx.inv[ctx.order], ctx.slot_sorted)
    assert not ctx.hit.any() and not ctx.cache_slot.any()


# --------------------------------------------------------------- registry
def test_registry_matches_the_reference():
    assert available_strategies() == javailable_strategies()
    for name, cls in (("hybrid", HybridStrategy), ("ps", PSStrategy),
                      ("mp_nodedup", MPNoDedupStrategy),
                      ("allgather_rows", AllGatherRowsStrategy)):
        assert get_strategy(name) is cls and cls.name == name
    flags = {n: (get_strategy(n).uses_cache, get_strategy(n).uses_l2,
                 get_strategy(n).uses_routing_ctx) for n in available_strategies()}
    from repro.engine import get_strategy as jget_strategy
    assert flags == {n: (jget_strategy(n).uses_cache, jget_strategy(n).uses_l2,
                         jget_strategy(n).uses_routing_ctx) for n in flags}
    with pytest.raises(ValueError, match="unknown lookup strategy"):
        get_strategy("nope")


# ----------------------------------------------------------------- parity
def _roundtrip_plans():
    kw = dict(enable_cache=False, exact_capacity=True)
    return (jmake_plan(jget_config("deepfm", smoke=True), 1, GB, **kw),
            make_plan(get_config("deepfm", smoke=True), 1, GB, **kw))


def _jax_roundtrip(mesh, jplan, strategy, emb0):
    """The reference's ``_engine_roundtrip``: forward + backward of one
    batch through the bare engine, the synthetic loss ``0.5 * sum(pooled^2)``
    (its gradient is ``pooled``)."""
    batch = jmake_batch(jget_config("deepfm", smoke=True), GB, np.random.default_rng(3))
    fields = jax.tree.map(jnp.asarray, batch["fields"])
    engine = JEngine(jplan, AXES, 1, strategy=strategy, use_cache=False, lr_emb=0.1)

    def f(emb, fields):
        packed = {g.gid: jpack_group(g, fields) for g in jplan.groups}
        pooled, ctx = engine.forward(emb, packed)
        emb2, _ = engine.backward(emb, ctx, pooled)
        return pooled, emb2

    especs = emb_specs(jplan, AXES)
    pooled_specs = {g.gid: P(AXES, None, None) for g in jplan.groups}
    g = jax.jit(shard_map(f, mesh=mesh, in_specs=(especs, replicated(fields)),
                          out_specs=(pooled_specs, especs), check_vma=False))
    pooled, emb2 = g(emb0, fields)
    return ({k: np.asarray(v) for k, v in pooled.items()},
            {k: np.asarray(v.w) for k, v in emb2.items()})


def _port_roundtrip(plan, strategy, emb_np, **ekw):
    """The same roundtrip through the port's engine from the same state."""
    batch = jmake_batch(jget_config("deepfm", smoke=True), GB, np.random.default_rng(3))
    emb, _ = state_from_jax(emb_np, {}, plan, "cpu")
    engine = EmbeddingEngine(plan, 1, strategy=strategy, use_cache=False, lr_emb=0.1, **ekw)
    packed = {g.gid: pack_group(g, batch["fields"], "cpu") for g in plan.groups}
    pooled, ctx = engine.forward(emb, packed)
    emb2, metrics = engine.backward(emb, ctx, pooled)
    return ({k: v.numpy() for k, v in pooled.items()},
            {k: v.w.numpy() for k, v in emb2.items()}, metrics, ctx)


def _close_dicts(got, exp, what):
    assert sorted(got) == sorted(exp)
    for k in exp:
        np.testing.assert_allclose(got[k], exp[k], atol=1e-5, rtol=0, err_msg=f"{what}/{k}")


@pytest.mark.parametrize("name", NEW)
def test_strategy_roundtrip_matches_reference_and_picasso(mesh1, name):
    """Pooled outputs and updated tables within 1e-5 of the reference's same
    strategy and of the port's ``picasso`` (the reference's own parity
    bar), every ctx carrying its sort so the backward never sorts."""
    jplan, plan = _roundtrip_plans()
    emb0 = {str(g): s for g, s in jinit_embedding_state(jax.random.PRNGKey(0), jplan).items()}
    emb_np = jax.device_get(emb0)
    jpooled, jtables = _jax_roundtrip(mesh1, jplan, name, emb0)
    pooled, tables, metrics, ctx = _port_roundtrip(plan, name, emb_np)
    _close_dicts(pooled, jpooled, f"{name}/pooled")
    _close_dicts(tables, jtables, f"{name}/table")
    ref_pooled, ref_tables, _, _ = _port_roundtrip(plan, "picasso", emb_np)
    _close_dicts(pooled, ref_pooled, f"{name} vs picasso/pooled")
    _close_dicts(tables, ref_tables, f"{name} vs picasso/table")
    assert int(metrics["overflow"]) == 0 and int(metrics["cache_hits"]) == 0
    for c in ctx.ctxs.values():
        assert torch.equal(c.order, torch.sort(c.inv, stable=True).indices)
        assert torch.equal(c.slot_sorted, c.inv[c.order])
        assert isinstance(c, pe.LookupCtx) == get_strategy(name).uses_routing_ctx


@pytest.mark.parametrize("name", ["picasso", "picasso_l2"] + list(NEW))
def test_broadcast_assignment_is_bitwise_the_single_name_engine(mesh1, name):
    jplan, plan = _roundtrip_plans()
    emb_np = jax.device_get({str(g): s for g, s in
                             jinit_embedding_state(jax.random.PRNGKey(0), jplan).items()})
    pooled, tables, _, _ = _port_roundtrip(plan, name, emb_np)
    pooled2, tables2, _, _ = _port_roundtrip(plan, {g.gid: name for g in plan.groups},
                                             emb_np)
    for a, b in ((pooled, pooled2), (tables, tables2)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", ["ps", "allgather_rows"])
def test_gathered_grads_move_through_compressed_all_gather(monkeypatch, name):
    """The replicated strategies' backward takes its row grads through
    ``compressed_all_gather`` with the engine's mode, once a group."""
    from repro_torch.optim import grad_compression as gcomp

    calls, real = [], gcomp.compressed_all_gather

    def spy(g, world=1, mode="none", fused=None, group=None):
        calls.append((g.shape, mode))
        return real(g, world, mode, fused, group)

    monkeypatch.setattr(gcomp, "compressed_all_gather", spy)
    jplan, plan = _roundtrip_plans()
    emb_np = jax.device_get({str(g): s for g, s in
                             jinit_embedding_state(jax.random.PRNGKey(0), jplan).items()})
    _port_roundtrip(plan, name, emb_np, grad_compress="topk")
    assert calls == [((GB * plan.groups[0].ids_per_sample, D), "topk")]


# ------------------------------------------------------------------ mixed
def _mixed_cfgs():
    """The reference's ``_mixed_cfg``: one tiny table (dim 8) and one large
    table (dim 16), two packed groups the cost model assigns to ``ps`` and
    ``picasso``; built for both packages."""
    out = []
    for ff, isp, wc in ((JFeatureField, JInteractionSpec, JWDLConfig),
                        (FeatureField, InteractionSpec, WDLConfig)):
        fields = (ff("tiny", 64, 8, max_len=1, pooling="sum"),
                  ff("big", 50_000, 16, max_len=1, pooling="sum"))
        out.append(wc(name="mix", fields=fields, n_dense=0, interactions=(isp("fm"),),
                      mlp_dims=(8,)))
    return out


def _mixed_plans(**kw):
    jcfg, cfg = _mixed_cfgs()
    kw = dict(hot_bytes=1 << 14, **kw)
    return jcfg, cfg, jmake_plan(jcfg, 1, GB, **kw), make_plan(cfg, 1, GB, **kw)


def _gid(plan, table):
    return next(g.gid for g in plan.groups if g.tables[0].name == table)


def test_mixed_engine_dispatch_gating_and_metric_keys():
    _, _, jplan, plan = _mixed_plans()
    asg = compile_assignment(plan)
    tiny, big = _gid(plan, "tiny"), _gid(plan, "big")
    assert asg.strategy == {tiny: "ps", big: "picasso"} == jcompile_assignment(jplan).strategy
    eng = EmbeddingEngine(plan, 1, strategy=asg)
    jeng = JEngine(jplan, AXES, 1, strategy=jcompile_assignment(jplan))
    assert eng.strategy_name == jeng.strategy_name == "mixed"
    assert eng.strategy_names == jeng.strategy_names == ("picasso", "ps")
    assert isinstance(eng.strategies[tiny], PSStrategy)
    assert isinstance(eng.strategies[big], PicassoStrategy)
    # both groups have a tier budget; only picasso's participates
    assert plan.cache_rows[tiny] > 0 and plan.cache_rows[big] > 0
    assert eng.cache_on == jeng.cache_on == {tiny: False, big: True}
    assert eng.any_cache
    assert eng.metric_keys == jeng.metric_keys
    assert set(eng.metric_keys) == {"overflow", "cache_hits", "overflow/ps",
                                    "overflow/picasso", "cache_hits/ps",
                                    "cache_hits/picasso"}
    assert EmbeddingEngine(plan, 1).metric_keys == ("overflow", "cache_hits")
    # the dict form and the mix the engine compiled itself agree
    assert EmbeddingEngine(plan, 1, strategy={tiny: "ps", big: "picasso"}).assignment \
        == eng.assignment
    assert plan.strategy == {}
    assert EmbeddingEngine(plan, 1, strategy="auto").assignment == asg.strategy
    assert plan.strategy == asg.strategy  # compiled and recorded
    # the state gates the tiers as the engine does; a ps group's budgeted
    # tier is allocated at full width and is never read
    st = init_embedding_state(torch.Generator().manual_seed(0), plan, torch.device("cpu"))
    assert tier_gates(plan, tiny) == (False, False) and tier_gates(plan, big) == (True, False)
    assert tuple(st[tiny].w.shape) == (plan.group(tiny).rows, 8)
    assert st[tiny].cache.keys.shape[0] == plan.cache_rows[tiny]


def _leaves(st):
    return [st.w, st.acc, st.counts, *st.cache]


def _emb_with_counts(plan):
    """A mixed plan's state whose FCounter counts every row, so a flush of
    any group would load a full tier."""
    emb = {str(g): s for g, s in init_embedding_state(torch.Generator().manual_seed(0), plan,
                                                      torch.device("cpu")).items()}
    for s in emb.values():
        s.counts.copy_(torch.arange(s.counts.shape[0], dtype=torch.int32) % 5 + 1)
    return emb


@pytest.mark.parametrize("how", ["engine", "make_flush_fn"])
def test_mixed_flush_skips_ps_groups(how):
    """The flush leaves every tensor of a ``ps`` group bitwise as it was,
    though the plan budgets it a tier, and loads the ``picasso`` group's.
    ``make_flush_fn`` follows the assignment recorded on the plan."""
    _, _, _, plan = _mixed_plans()
    eng = EmbeddingEngine(plan, 1, strategy="mixed")
    assert plan.strategy == eng.assignment
    tiny, big = _gid(plan, "tiny"), _gid(plan, "big")
    emb = _emb_with_counts(plan)
    before = [t.clone() for t in _leaves(emb[str(tiny)])]
    if how == "engine":
        out = eng.flush(emb)
    else:
        out = make_flush_fn(plan)({"emb": emb, "step": 0})["emb"]
    for a, b in zip(before, _leaves(out[str(tiny)])):
        assert torch.equal(a, b)
    assert (out[str(big)].cache.keys < plan.group(big).rows).all()


def test_mixed_assignment_trains_and_serves_against_reference(mesh1):
    """5 training steps (tier flushed at step 2) and one request of the
    mixed plan against the reference from the same state: losses to rtol
    1e-4 / atol 1e-5, every per-class metric equal, ``cache_hits/ps`` 0
    and picasso hits after the flush, the state of every group as
    ``_check_state`` holds it, the ``ps`` group's tier never touched, and
    probabilities within 1e-5."""
    jcfg, cfg, jplan, plan = _mixed_plans(flush_iters=2, warmup_iters=1)
    japply_assignment(jplan, jcompile_assignment(jplan))
    jmodel, model = JWDLModel(jcfg, jplan), WDLModel(cfg, plan)
    jstate = jinit_state(jmodel, jplan, jax.random.PRNGKey(0), mesh=mesh1, axes=AXES)
    state = train_state_from_jax(jax.device_get(jstate), plan, "cpu")
    jstep, _ = jmake_train_step(jmodel, jplan, mesh1, AXES, GB,
                                JTrainConfig(strategy="mixed", use_fused_kernels="off"),
                                donate=False)
    step = make_train_step(model, plan, GB, TrainConfig(strategy="mixed"), "cpu")
    assert plan.strategy == dict(jplan.strategy)  # the port compiled the same mix
    tiny = _gid(plan, "tiny")
    tier0 = [t.clone() for t in state["emb"][str(tiny)].cache]
    rng = np.random.default_rng(0)
    keys = ("overflow", "cache_hits", "overflow/ps", "overflow/picasso", "cache_hits/ps",
            "cache_hits/picasso")
    hits = 0
    for _ in range(5):
        b = jmake_batch(jcfg, GB, rng)
        state, m = step(state, b)
        jstate, jm = jstep(jstate, jax.device_put(b, to_named(mesh1, batch_specs(b, AXES))))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-5)
        assert {k: int(m[k]) for k in keys} == {k: int(jm[k]) for k in keys}
        assert int(m["cache_hits/ps"]) == 0
        assert int(m["cache_hits"]) == int(m["cache_hits/picasso"])
        hits += int(m["cache_hits/picasso"])
    assert hits > 0
    _check_state(state, jax.device_get(jstate))
    for a, b in zip(tier0, state["emb"][str(tiny)].cache):
        assert torch.equal(a, b)
    b = jmake_batch(jcfg, GB, rng)
    jserve = jmake_serve_step(jmodel, jplan, mesh1, AXES, GB,
                              scfg=JServeConfig(strategy="mixed", use_fused_kernels="off"))
    probs, ctx = make_serve_step(model, plan, GB, ServeConfig(strategy="mixed"),
                                 "cpu").score(state, b)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jserve(jstate, b)), atol=1e-5, rtol=0)
    assert int(ctx.ctxs[_gid(plan, "big")].hit.sum()) > 0
    assert not hasattr(ctx.ctxs[tiny], "hit")


def test_five_strategy_assignment_trajectory_matches_reference(mesh1):
    """``picasso``, ``hybrid``, ``ps``, ``mp_nodedup`` and ``allgather_rows``
    cycled over the unpacked deepfm-smoke plan's 39 groups (the tier only
    on the picasso groups): 8 steps with the step-3 flush to the bars of
    ``check_train_trajectory``, every group's state included."""
    names = ("picasso", "hybrid", "ps", "mp_nodedup", "allgather_rows")
    n_groups = len(make_plan(get_config("deepfm", smoke=True), 1, 64,
                             enable_packing=False).groups)
    assert n_groups == 39
    spec = {gid: names[gid % len(names)] for gid in range(n_groups)}
    check_train_trajectory(mesh1, "deepfm", "psum", 1, plan_kw={"enable_packing": False},
                           strategy=spec)


@pytest.mark.parametrize("mode", ["fp16", "topk"])
@pytest.mark.parametrize("name", ["ps", "allgather_rows"])
def test_gathered_strategies_compressed_match_reference(mesh1, monkeypatch, name, mode):
    """``ps`` and ``allgather_rows`` with their gathered grads compressed:
    each step from a shared state, to the bars of ``check_train_trajectory``.
    Under topk a row tied at its k-th kept column takes the port's selection
    on both sides (``_TieAwareTopk``; ``allgather_rows`` under
    ``PYTHONHASHSEED=13`` ties at step 1); an untied row may not differ."""
    ties = _TieAwareTopk(monkeypatch) if mode == "topk" else None
    check_train_trajectory(mesh1, "deepfm", "psum", 1, shared_state=True, strategy=name,
                           grad_compress=mode)
    if ties is not None:
        assert ties.calls and not ties.untied


def test_backward_carries_every_strategys_sort(monkeypatch):
    """Under the five-name assignment every ``segment_grad`` of a training
    step gets its ctx's permutation (a stable argsort of ``inv`` and ``inv``
    in its order), so the kernel path sorts for no strategy."""
    calls, real = [], ops.segment_grad

    def spy(g_bags, seg, weights, inv, n_rows, fused=None, order=None, sorted_inv=None):
        calls.append((inv, order, sorted_inv))
        return real(g_bags, seg, weights, inv, n_rows, fused, order, sorted_inv)

    monkeypatch.setattr(ops, "segment_grad", spy)
    cfg = get_config("deepfm", smoke=True)
    plan = make_plan(cfg, 1, GB, enable_packing=False, hot_bytes=1 << 14)
    names = ("picasso", "hybrid", "ps", "mp_nodedup", "allgather_rows")
    model = WDLModel(cfg, plan)
    state = init_state(model, plan, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(model, plan, GB, TrainConfig(
        strategy={g.gid: names[g.gid % 5] for g in plan.groups}), "cpu")
    step(state, make_batch(cfg, GB, np.random.default_rng(1)))
    assert len(calls) == len(plan.groups) == 39
    for inv, order, sorted_inv in calls:
        expect_sorted, expect_order = torch.sort(inv, stable=True)
        assert torch.equal(order, expect_order) and torch.equal(sorted_inv, expect_sorted)
