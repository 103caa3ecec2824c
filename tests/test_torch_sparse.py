"""The port's sparse path against the reference on the CPU: scramble,
pack_group, fixed_unique, partition, cache_probe, mp_lookup at world 1
(the reference under the ``mesh1`` fixture), the FCounter update and the
HybridHash flush. Integer outputs must match bitwise; looked-up rows are
copies and must match to 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.configs.base import FeatureField as JField
from repro.configs.base import InteractionSpec as JSpec
from repro.configs.base import WDLConfig as JConfig
from repro.core import packed_embedding as jpe
from repro.core.features import pack_group as jpack_group
from repro.core.hashing import scramble as jscramble
from repro.core.packing import make_plan as jmake_plan
from repro.data.synthetic import make_batch as jmake_batch
from repro.dist.compat import shard_map
from repro.embedding.state import init_embedding_state as jinit_embedding_state
from repro.train.train_step import make_flush_fn
from repro_torch.configs import get_config
from repro_torch.configs.base import FeatureField, InteractionSpec, WDLConfig
from repro_torch.convert import state_from_jax
from repro_torch.core import packed_embedding as pe
from repro_torch.core.features import pack_group
from repro_torch.core.hashing import scramble
from repro_torch.core.packing import make_plan
from repro_torch.data.synthetic import make_batch
from repro_torch.dist import Group
from repro_torch.embedding.state import EmbeddingState
from repro_torch.engine import EmbeddingEngine

torch.set_num_threads(1)

AXES = ("data", "model")


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("vocab,salt", [(39884406, 0), (39884406, 9973), (38532951, 17),
                                        (1024, 5), (3, 10006)])
def test_scramble_wraps_like_uint32(vocab, salt):
    rng = np.random.default_rng(vocab % 1000)
    ids = np.concatenate([np.arange(2**31 - 64, 2**31), rng.integers(0, 2**31 - 1, 256),
                          np.arange(64)]).astype(np.int32)
    got = scramble(_t(ids), vocab, salt)
    exp = np.asarray(jscramble(jnp.asarray(ids), vocab, salt))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), exp)
    assert (got >= 0).all() and (got < vocab).all()


def _multi_hot_configs():
    """Port and reference configs with multi-hot 'sum'/'mean'/'none' fields."""
    specs = [("a", 50, 1, "sum"), ("b", 70, 4, "mean"), ("c", 30, 3, "none"),
             ("d", 90, 2, "sum")]
    out = []
    for field_cls, spec_cls, cfg_cls in ((FeatureField, InteractionSpec, WDLConfig),
                                         (JField, JSpec, JConfig)):
        fields = tuple(field_cls(name=n, vocab=v, dim=4, max_len=m, pooling=p)
                       for n, v, m, p in specs)
        out.append(cfg_cls(name="mh", fields=fields, n_dense=0,
                           interactions=(spec_cls("fm"),), mlp_dims=(8,)))
    return out


@pytest.mark.parametrize("which", ["deepfm-smoke", "multi-hot"])
def test_pack_group_matches_reference(which):
    if which == "deepfm-smoke":
        cfg, jcfg = get_config("deepfm", smoke=True), jget_config("deepfm", smoke=True)
    else:
        cfg, jcfg = _multi_hot_configs()
    plan, jplan = make_plan(cfg, 1, 16), jmake_plan(jcfg, 1, 16)
    batch = make_batch(cfg, 16, np.random.default_rng(7))
    jbatch = jmake_batch(jcfg, 16, np.random.default_rng(7))
    for f in cfg.fields:
        np.testing.assert_array_equal(batch["fields"][f.name]["ids"],
                                      jbatch["fields"][f.name]["ids"])
    for g, jg in zip(plan.groups, jplan.groups):
        pb = pack_group(g, batch["fields"], "cpu")
        jpb = jpack_group(jg, jbatch["fields"])
        np.testing.assert_array_equal(pb.ids.numpy(), np.asarray(jpb.ids))
        np.testing.assert_array_equal(pb.weights.numpy(), np.asarray(jpb.weights))
        np.testing.assert_array_equal(pb.seg.numpy(), np.asarray(jpb.seg))
        assert pb.n_bags == jpb.n_bags
        assert pb.ids.dtype == torch.int32 and pb.seg.dtype == torch.int32


def test_plan_copy_matches_reference():
    for smoke in (True, False):
        plan = make_plan(get_config("deepfm", smoke=smoke), 1, 512)
        jplan = jmake_plan(jget_config("deepfm", smoke=smoke), 1, 512)
        assert [(g.rows, g.dim, g.n_bags, g.table_offsets) for g in plan.groups] == \
            [(g.rows, g.dim, g.n_bags, g.table_offsets) for g in jplan.groups]
        assert (plan.capacity, plan.cache_rows, plan.interleave, plan.microbatch) == \
            (jplan.capacity, jplan.cache_rows, jplan.interleave, jplan.microbatch)
    # the full-width serve_p99 plan this slice runs on one card
    assert plan.groups[0].rows == 187_780_711 and plan.cache_rows[0] == 4_194_304
    assert plan.capacity[0] == 31_952


@pytest.mark.parametrize("n,hi", [(50, 20), (64, 1000), (1, 5)])
def test_fixed_unique_bitwise(n, hi):
    ids = np.random.default_rng(n).integers(0, hi, n).astype(np.int32)
    u = pe.fixed_unique(_t(ids), sentinel=hi)
    ju = jpe.fixed_unique(jnp.asarray(ids), sentinel=hi)
    for a, b in zip(u, ju):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _unique_case(kind, rng):
    if kind == "duplicates":
        return rng.integers(0, 700, 3_000).astype(np.int32), 700
    if kind == "distinct":
        return rng.permutation(2_000).astype(np.int32), 2_000
    if kind == "one id":
        return np.full(257, 41, np.int32), 100
    return rng.integers(0, 3_000, 5_000).astype(np.int32), 3_000   # past 4,096


@pytest.mark.parametrize("kind", ["duplicates", "distinct", "one id", "large"])
def test_fixed_unique_carries_the_stable_sort(kind):
    """``uniq``, ``inv``, ``n_uniq`` and ``uvalid`` bitwise the reference's;
    ``order`` and ``slot_sorted`` are ``inv``'s stable sort, and ``order``
    is the permutation ``segment_grad_pallas`` builds (``argsort`` of the
    slots with one ghost per slot appended, stable), restricted to the real
    positions."""
    ids, hi = _unique_case(kind, np.random.default_rng(len(kind)))
    n = ids.shape[0]
    u = pe.fixed_unique(_t(ids), sentinel=hi)
    ju = jpe.fixed_unique(jnp.asarray(ids), sentinel=hi)
    for a, b in zip(u[:4], ju):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    sorted_inv, order = torch.sort(u.inv, stable=True)
    assert u.order.dtype == torch.int64 and u.slot_sorted.dtype == torch.int32
    assert torch.equal(u.order, order) and torch.equal(u.slot_sorted, sorted_inv)
    slots = jnp.concatenate([jnp.asarray(u.inv.numpy()), jnp.arange(n, dtype=jnp.int32)])
    jorder = np.asarray(jnp.argsort(slots, stable=True))
    np.testing.assert_array_equal(u.order.numpy(), jorder[jorder < n])


@pytest.mark.parametrize("world,capacity", [(1, 64), (1, 5), (4, 3), (4, 40)])
def test_partition_bitwise(world, capacity):
    rng = np.random.default_rng(world * 100 + capacity)
    rps = 25
    ids = rng.integers(0, rps * world, 60).astype(np.int32)
    u = jpe.fixed_unique(jnp.asarray(ids), sentinel=rps * world)
    miss = np.asarray(u.uvalid) & (rng.random(60) < 0.7)
    r = pe.partition(_t(u.uniq), _t(miss), rps, world, capacity)
    jr = jpe.partition(u.uniq, jnp.asarray(miss), rps, world, capacity)
    for a, b in zip(r, jr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if capacity <= 5:
        assert int(r.overflow) > 0


def test_cache_probe_bitwise():
    rng = np.random.default_rng(11)
    keys = np.concatenate([np.sort(rng.choice(500, 24, replace=False)),
                           np.full(8, 500)]).astype(np.int32)
    u = jpe.fixed_unique(jnp.asarray(np.concatenate(
        [keys[:10], rng.integers(0, 500, 30)]).astype(np.int32)), sentinel=500)
    for hk in (keys, None):
        got = pe.cache_probe(_t(u.uniq), _t(u.uvalid), None if hk is None else _t(hk))
        exp = jpe.cache_probe(u.uniq, u.uvalid, None if hk is None else jnp.asarray(hk))
        for a, b in zip(got, exp):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _lookup_inputs(rows=300, d=10, n=96, h=32):
    rng = np.random.default_rng(rows + n)
    w = rng.normal(size=(rows, d)).astype(np.float32)
    ids = rng.integers(0, rows, n).astype(np.int32)
    keys = np.sort(np.concatenate([rng.choice(np.unique(ids), h // 2, replace=False),
                                   np.full(h // 2, rows)])).astype(np.int32)
    hot = rng.normal(size=(h, d)).astype(np.float32)
    return w, ids, keys, hot


def _jax_lookup(mesh, w, ids, keys, hot, capacity, fused):
    def f(w, ids, keys, hot):
        rows_u, ctx = jpe.mp_lookup(w, ids, axes=AXES, world=1, capacity=capacity,
                                    hot_keys=keys, hot_rows=hot, fused=fused)
        counts = jpe.count_frequencies(jnp.zeros((w.shape[0],), jnp.int32), ctx)
        return (rows_u, ctx.uniq, ctx.inv, ctx.hit, ctx.cache_slot,
                ctx.routing.send_slot, ctx.routing.overflow, counts)

    g = jax.jit(shard_map(f, mesh=mesh, in_specs=(P(AXES, None), P(), P(), P()),
                          out_specs=(P(),) * 8, check_vma=False))
    return [np.asarray(x) for x in g(jnp.asarray(w), jnp.asarray(ids),
                                      jnp.asarray(keys), jnp.asarray(hot))]


@pytest.mark.parametrize("capacity,fused", [(96, False), (96, True), (12, False)])
def test_mp_lookup_world1_matches_reference(mesh1, capacity, fused):
    w, ids, keys, hot = _lookup_inputs()
    exp = _jax_lookup(mesh1, w, ids, keys, hot, capacity, fused)
    rows_u, ctx = pe.mp_lookup(_t(w), _t(ids), world=1, capacity=capacity,
                               hot_keys=_t(keys), hot_rows=_t(hot))
    counts = pe.count_frequencies(torch.zeros(w.shape[0], dtype=torch.int32), ctx)
    got = [rows_u, ctx.uniq, ctx.inv, ctx.hit, ctx.cache_slot,
           ctx.routing.send_slot, ctx.routing.overflow, counts]
    np.testing.assert_allclose(got[0].numpy(), exp[0], atol=1e-6, rtol=0)
    for a, b in zip(got[1:], exp[1:]):
        np.testing.assert_array_equal(a.numpy(), b)
    assert int(ctx.hit.sum()) > 0
    assert (int(ctx.routing.overflow) > 0) == (capacity < 96)


def test_lookup_rows_serves_tier_rows_then_master_rows():
    cfg = get_config("deepfm", smoke=True)
    plan = make_plan(cfg, 1, 8)
    g = plan.groups[0]
    rng = np.random.default_rng(2)
    w = _t(rng.normal(size=(g.rows, g.dim)).astype(np.float32))
    h = plan.cache_rows[0]
    keys = torch.full((h,), g.rows, dtype=torch.int32)
    keys[0] = 17
    tier_rows = torch.zeros((h, g.dim))
    tier_rows[0] = 7.0
    st = EmbeddingState(w=w, acc=torch.zeros((g.rows, 1)),
                        counts=torch.zeros(g.rows, dtype=torch.int32),
                        cache=pe.CacheState(keys, tier_rows, torch.zeros((h, 1))))
    ids = torch.tensor([5, 17, 5, 300], dtype=torch.int32)
    got = EmbeddingEngine(plan, 1).lookup_rows({"0": st}, 0, ids)
    np.testing.assert_array_equal(got[[0, 2, 3]].numpy(), w[[5, 5, 300]].numpy())
    assert (got[1] == 7.0).all()


def test_multi_rank_raises():
    """Past world 1 a lookup needs this rank's ``dist.Group``: ``world=2``
    without one, or with a group of another world, raises ``ValueError``."""
    with pytest.raises(ValueError, match="world=2 needs a repro_torch.dist.Group"):
        pe.mp_lookup(torch.zeros((4, 2)), torch.zeros(3, dtype=torch.int32), world=2,
                     capacity=4)
    with pytest.raises(ValueError, match="world=2 but the group given has world 4"):
        pe.mp_lookup(torch.zeros((4, 2)), torch.zeros(3, dtype=torch.int32), world=2,
                     capacity=4, group=Group(0, 4))


def _tied_counts(rows, rng):
    # many ties (values 0..3) across the top-H boundary
    return rng.integers(0, 4, rows).astype(np.int32)


def test_flush_matches_reference_with_ties(mesh1):
    """Two flushes: the first loads a tier from tied counts, the second also
    writes modified tier rows back. Keys must match bitwise, rows/w/acc
    exactly, decayed counts bitwise."""
    jcfg, cfg = jget_config("deepfm", smoke=True), get_config("deepfm", smoke=True)
    jplan, plan = jmake_plan(jcfg, 1, 8), make_plan(cfg, 1, 8)
    emb = {str(g): s for g, s in jinit_embedding_state(jax.random.PRNGKey(0), jplan).items()}
    rng = np.random.default_rng(0)
    rows = jplan.groups[0].rows
    emb["0"] = emb["0"]._replace(counts=jnp.asarray(_tied_counts(rows, rng)))
    flush = make_flush_fn(jplan, mesh1, AXES)
    engine = EmbeddingEngine(plan, 1)
    port, _ = state_from_jax(jax.device_get(emb), {}, plan, "cpu")
    for rnd in range(2):
        if rnd:  # perturb the tier and the counts as serving + training would
            jst = emb["0"]
            bump = rng.normal(size=jst.cache.rows.shape).astype(np.float32)
            new_counts = np.asarray(jst.counts) + _tied_counts(rows, rng)
            emb["0"] = jst._replace(counts=jnp.asarray(new_counts),
                                    cache=jst.cache._replace(rows=jst.cache.rows + bump))
            st = port["0"]
            port["0"] = st._replace(counts=_t(new_counts),
                                    cache=st.cache._replace(rows=st.cache.rows + _t(bump)))
        emb = jax.device_get(flush({"emb": emb})["emb"])
        port = engine.flush(port)
        jst, st = emb["0"], port["0"]
        np.testing.assert_array_equal(st.cache.keys.numpy(), np.asarray(jst.cache.keys))
        np.testing.assert_array_equal(st.cache.rows.numpy(), np.asarray(jst.cache.rows))
        np.testing.assert_array_equal(st.cache.acc.numpy(), np.asarray(jst.cache.acc))
        np.testing.assert_array_equal(st.counts.numpy(), np.asarray(jst.counts))
        np.testing.assert_array_equal(st.w.numpy(), np.asarray(jst.w))
        assert (st.cache.keys < rows).sum() == plan.cache_rows[0]
