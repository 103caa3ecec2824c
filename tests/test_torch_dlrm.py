"""The port's DLRM path against the reference on the CPU.

Kernel layer: the plain dot interaction and its backward in
``repro_torch.kernels.ref`` against ``repro.kernels.ref``, the Pallas
kernels in interpret mode and ``jax.vjp``, over (B, F, D) with a single
pair (F = 2), the bench config's width and the full config's D = 128, at
batches that are no multiple of the Pallas block (atol 1e-5 of the value
scale: float32 sums in another order); the autograd wiring of the kernel
path with the CUDA wrappers stood in for by the plain versions; the
dispatch and shape rules around the CUDA kernels, which run only on the
card (``chip_smoke.py``).

Model and steps: ``dlrm(criteo=False, scale=0.01)``, as the reference's
throughput bench trains it (26 fields at dim 16, 13 dense features through
a 32-16 bottom MLP, 27 vectors in the dots, MLP 64-32), with the
reference's parameters carried over by ``convert``: logits and loss to
1e-5; serving probabilities to 1e-5 with equal tier hits, and the 8-step
training trajectory with a flush at step 3 to the deepfm bars (losses rtol
1e-4 / atol 1e-5, hits and integer state bitwise, float state to 1e-4),
each under ``picasso`` and under ``picasso_narrow`` (narrow dim 4, a
1<<18-byte L2 tier, as the bench runs it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.paper_models import dlrm as jdlrm
from repro.core.assign import apply_assignment as japply_assignment
from repro.core.assign import resolve_assignment as jresolve_assignment
from repro.core.features import pack_group as jpack_group
from repro.core.packing import make_plan as jmake_plan
from repro.data.synthetic import make_batch as jmake_batch
from repro.dist.compat import shard_map
from repro.dist.sharding import batch_specs, emb_specs, replicated, to_named
from repro.engine import EmbeddingEngine as JEngine
from repro.kernels import ref as jref
from repro.kernels.dot_interaction import dot_interaction_pallas
from repro.kernels.interaction_bwd import dot_interaction_bwd_pallas
from repro.models.wdl import WDLModel as JWDLModel
from repro.serve.serve_step import ServeConfig as JServeConfig
from repro.serve.serve_step import make_serve_step as jmake_serve_step
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import init_state as jinit_state
from repro.train.train_step import make_flush_fn as jmake_flush_fn
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs.paper_models import dlrm
from repro_torch.convert import state_from_jax, train_state_from_jax
from repro_torch.core.features import dense_features, pack_group
from repro_torch.core.packing import make_plan
from repro_torch.engine import resolve_assignment
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.layers import interactions as I
from repro_torch.models.wdl import WDLModel
from repro_torch.optim import optimizers as topt
from repro_torch.serve.serve_step import ServeConfig, make_serve_step
from repro_torch.train.train_step import TrainConfig, make_train_step

torch.set_num_threads(1)

AXES = ("data", "model")
GB = 64
STEPS = 8
BENCH = dict(criteo=False, scale=0.01)
# tests/test_torch_train.py's plan (a tiny L1 flushed at step 3 after 2),
# and for picasso_narrow the bench's narrow width and L2 budget
PLAN_KW = {"picasso": dict(hot_bytes=1 << 14, flush_iters=3, warmup_iters=2),
           "picasso_narrow": dict(hot_bytes=1 << 14, flush_iters=3, warmup_iters=2,
                                  narrow_dim=4, l2_bytes=1 << 18)}
# (B, F, D): one pair; the bench config's 27 vectors at D = 16; the full
# config's D = 128. No B is a multiple of the Pallas kernels' block.
DOT_SHAPES = [(5, 2, 3), (16, 27, 16), (33, 27, 128)]


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, exp):
    exp = np.asarray(exp)
    scale = max(float(np.abs(exp).max()), 1.0) if exp.size else 1.0
    np.testing.assert_allclose(np.asarray(got), exp, rtol=0, atol=1e-5 * scale)


def _dot_case(b, f, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, f, d)).astype(np.float32)
    g = rng.normal(size=(b, f * (f - 1) // 2)).astype(np.float32)
    return x, g


# ------------------------------------------------------------------ kernels


@pytest.mark.parametrize("b,f,d", DOT_SHAPES)
def test_dot_interaction_plain_matches_reference_and_pallas(b, f, d):
    x, _ = _dot_case(b, f, d, b + f + d)
    got = ops.dot_interaction(_t(x))
    assert tuple(got.shape) == (b, f * (f - 1) // 2) and got.dtype == torch.float32
    jx = jnp.asarray(x)
    for exp in (jref.dot_interaction_ref(jx),
                dot_interaction_pallas(jx, block_b=16, interpret=True)):
        _close(got.numpy(), exp)
    _close(tref.dot_interaction_ref(_t(x)).numpy(), jref.dot_interaction_ref(jx))


@pytest.mark.parametrize("b,f,d", DOT_SHAPES)
def test_dot_interaction_bwd_plain_matches_reference_pallas_and_vjp(b, f, d):
    x, g = _dot_case(b, f, d, 3 * b + f + d)
    got = ops.dot_interaction_bwd(_t(x), _t(g))
    assert tuple(got.shape) == (b, f, d)
    jx, jg = jnp.asarray(x), jnp.asarray(g)
    _, vjp = jax.vjp(jref.dot_interaction_ref, jx)
    for exp in (jref.dot_interaction_bwd_ref(jx, jg),
                dot_interaction_bwd_pallas(jx, jg, block_b=16, interpret=True), vjp(jg)[0]):
        _close(got.numpy(), exp)


@pytest.mark.parametrize("kernel_path", [False, True])
def test_dot_interaction_autograd(monkeypatch, kernel_path):
    """The gradient of ``ops.dot_interaction`` is ``dot_interaction_bwd_ref``
    on the plain path, and on the kernel path (CUDA wrappers stood in for by
    the plain versions) goes through the backward wrapper exactly once."""
    calls = {"fwd": 0, "bwd": 0}
    if kernel_path:
        def fwd(x):
            calls["fwd"] += 1
            return tref.dot_interaction_ref(x)

        def bwd(x, g):
            calls["bwd"] += 1
            return tref.dot_interaction_bwd_ref(x, g)

        monkeypatch.setattr(ops, "_use_kernel", lambda fused, t, op: True)
        monkeypatch.setattr(ops, "_dot_interaction_cuda", fwd)
        monkeypatch.setattr(ops, "_dot_interaction_bwd_cuda", bwd)
    x, g = _dot_case(9, 27, 16, 4)
    tx = _t(x).requires_grad_(True)
    out = I.dot_interaction(tx)
    # a non-contiguous cotangent: the backward makes it contiguous
    gt = _t(np.ascontiguousarray(g.T)).T
    (got,) = torch.autograd.grad(out, tx, gt)
    if kernel_path:
        assert calls == {"fwd": 1, "bwd": 1}
    _close(got.numpy(), tref.dot_interaction_bwd_ref(_t(x), _t(g)).numpy())
    _close(got.numpy(), jref.dot_interaction_bwd_ref(jnp.asarray(x), jnp.asarray(g)))


def test_dot_forced_on_cpu_tensors_raise():
    x, g = map(_t, _dot_case(4, 5, 6, 0))
    with pytest.raises(ValueError, match="CUDA"):
        ops.dot_interaction(x, fused=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.dot_interaction_bwd(x, g, fused=True)
    # fused=False takes the plain version
    assert torch.equal(ops.dot_interaction(x, fused=False), tref.dot_interaction_ref(x))


def test_dot_wrappers_check_shapes_before_launch(monkeypatch):
    """The CUDA wrappers reject what their kernels do not take before any
    launch (checked here with the device test bypassed)."""
    monkeypatch.setattr(ops, "_launch", lambda *a: pytest.fail("launched"))
    x, g = map(_t, _dot_case(4, 5, 6, 0))
    with pytest.raises(ValueError, match="want"):
        ops._dot_interaction_bwd_cuda(x, g[:, :9].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ops._dot_interaction_cuda(x.transpose(1, 2))
    with pytest.raises(ValueError, match="float32"):
        ops._dot_interaction_bwd_cuda(x, g.double())
    # both kernels: rows of width 0, and one sample in two ring buffers past
    # the 227 KB one block may hold (F = 27, D = 1,100)
    for f, d, what in ((3, 0, "D > 0"), (27, 1100, "shared memory")):
        with pytest.raises(ValueError, match=what):
            ops._dot_interaction_cuda(torch.zeros((2, f, d)))
        with pytest.raises(ValueError, match=what):
            ops._dot_interaction_bwd_cuda(torch.zeros((2, f, d)),
                                          torch.zeros((2, f * (f - 1) // 2)))
    # full width (F = 27, D = 128) fits the forward in two ring buffers and
    # the backward in three
    assert ops.dot_fwd_plan(512, 27, 128)[1] == 2 and ops.dot_bwd_plan(256, 27, 128)[1] == 3


@pytest.mark.parametrize("b,f,d", [(256, 27, 128), (2_000, 27, 16), (256, 27, 16),
                                   (1000, 2, 3), (333, 27, 127), (77, 5, 1), (9, 1, 8),
                                   (3, 27, 1000)])
def test_dot_bwd_wrapper_hands_the_launcher_its_plan(monkeypatch, b, f, d):
    """The backward's launch arguments on the path shape, at the bench width
    (at B = 2,000 a buffer takes 7 samples), and on chip_smoke's edge
    shapes: a ring of two or three buffers of ``spb`` samples whose shared
    memory is the C layout's and fits one block, enough 4 x 4 tiles for the
    threads, enough groups of the batch for the card, and one launch."""
    seen = []
    monkeypatch.setattr(ops, "_launch", lambda name, *a: seen.append((name, a)))
    x, g = torch.zeros((b, f, d)), torch.zeros((b, f * (f - 1) // 2))
    assert tuple(ops._dot_interaction_bwd_cuda(x, g).shape) == (b, f, d)
    ((name, args),) = seen
    assert name == "dot_interaction_bwd" and args[3:6] == (b, f, d)
    spb, stages, threads, smem = args[6:]
    assert (spb, stages, threads, smem) == ops.dot_bwd_plan(b, f, d)
    assert stages in (2, 3) and threads % 32 == 0 and 32 <= threads <= 256
    assert smem == ops.dot_bwd_smem(f, d, spb, stages) <= ops.DOT_SMEM_BYTES
    tiles = -(-f // 4) * -(-d // 4)
    assert spb == 1 or spb * tiles <= threads
    # three buffers unless only two fit (D = 1,000); no more samples a
    # buffer than tiles the threads can take, nor than leave 264 groups
    assert stages == (2 if d == 1000 else 3)
    assert spb == max(1, min(256 // tiles, b // 264))
    assert spb == 1 or -(-b // spb) >= 264


def test_dot_bwd_plan_at_bulk():
    """At B = 65,536 (allocating nothing): full width keeps one sample and
    three buffers a block; D = 16 takes 9 samples a buffer, all the
    threads' tiles."""
    assert ops.dot_bwd_plan(65_536, 27, 128) == ops.dot_bwd_plan(256, 27, 128)
    assert ops.dot_bwd_plan(65_536, 27, 128)[:3] == (1, 3, 224)
    assert ops.dot_bwd_plan(65_536, 27, 16)[:3] == (9, 3, 256)


# the forward's plan boundaries (chip_smoke.DOT_FWD_*) and the path shapes
DOT_FWD_PLANS = [(b, f, d) for f in (2, 27) for d in (1, 3, 16, 128, 129)
                 for b in (1, 37, 65_537)] + [(512, 27, 128), (256, 27, 128), (65_536, 27, 128),
                                              (3, 27, 1000), (600, 5, 8)]


@pytest.mark.parametrize("b,f,d", DOT_FWD_PLANS)
def test_dot_fwd_plan_fits_and_covers_every_sample(b, f, d):
    """The forward's plan: its shared memory is the C layout's and fits the
    227 KB a block may hold; 2 x 2 tiles where the batch gives each SM at
    most two samples, else 4 x 4; the threads take every register tile of a
    ring buffer's samples (looping where a sample has more tiles than 256
    threads), at least 128 (4 x 4) or 256 (2 x 2), and the groups of
    ``spb`` samples cover the batch; no more samples a buffer than fit 16
    KB or leave 264 groups; two buffers."""
    spb, stages, threads, smem, tile = ops.dot_fwd_plan(b, f, d)
    assert tile == (2 if b <= ops.DOT_MIN_GROUPS else 4)
    tiles = ops.dot_fwd_tiles(f, tile)
    assert tiles == (-(-f // 4) * 4 // tile) * (-(-f // 4) * 4 // tile + 1) // 2
    assert stages == 2 and smem == ops.dot_fwd_smem(f, d, spb, 2) <= ops.DOT_SMEM_BYTES
    assert threads % 32 == 0 and threads <= ops.DOT_THREADS
    assert threads >= min(max(spb * tiles, ops.DOT_FWD_MIN_THREADS[tile]), ops.DOT_THREADS)
    assert spb * tiles <= max(threads, tiles)
    assert -(-b // spb) * spb >= b and (spb == 1 or -(-b // spb) >= ops.DOT_MIN_GROUPS)
    sample = 4 * (-(-f // 4) * 4) * (-(-d // 4) * 4)
    assert spb == 1 or spb * sample <= ops.DOT_FWD_STAGE_BYTES
    cap = min(ops.DOT_THREADS // tiles, b // ops.DOT_MIN_GROUPS,
              ops.DOT_FWD_STAGE_BYTES // sample)
    # no sample more within the limits
    assert spb + 1 > cap or ops.dot_fwd_smem(f, d, spb + 1, 2) > ops.DOT_SMEM_BYTES


def test_dot_fwd_plan_at_the_paths_and_past_the_limit():
    """Full DLRM: one sample a buffer in two buffers at every batch;
    training's B = 256 in 2 x 2 tiles (105 of them) on 256 threads,
    serving's B = 512 and bulk in 4 x 4 tiles (28) on 128; the bench width
    9 samples a buffer; one sample past 227 KB in two buffers raises."""
    smem = ops.dot_fwd_smem(27, 128, 1, 2)
    assert ops.dot_fwd_plan(256, 27, 128) == (1, 2, 256, smem, 2)
    assert ops.dot_fwd_plan(512, 27, 128) == ops.dot_fwd_plan(65_536, 27, 128) == (
        1, 2, 128, smem, 4)
    assert ops.dot_fwd_tiles(27, 2) == 105 and ops.dot_fwd_tiles(27) == 28
    assert ops.dot_fwd_plan(65_536, 27, 16)[:3] == (9, 2, 256)
    assert ops.dot_fwd_smem(27, 1000, 1, 2) <= ops.DOT_SMEM_BYTES
    for d in (1100, 4096):
        with pytest.raises(ValueError, match="shared memory"):
            ops.dot_fwd_plan(4, 27, d)


@pytest.mark.parametrize("b,f,d", [(512, 27, 128), (256, 27, 128), (2_000, 27, 16), (37, 2, 3),
                                   (1, 2, 1), (65_537, 2, 129), (9, 1, 8), (5, 0, 4)])
def test_dot_fwd_wrapper_hands_the_launcher_its_plan(monkeypatch, b, f, d):
    """The forward's launch arguments (checked with the device test
    bypassed): the fields and the output, B, F, D, then its plan; no launch
    where there is no pair."""
    seen = []
    monkeypatch.setattr(ops, "_launch", lambda name, *a: seen.append((name, a)))
    x = torch.zeros((b, f, d))
    out = ops._dot_interaction_cuda(x)
    p = f * (f - 1) // 2
    assert tuple(out.shape) == (b, p)
    if not p:
        assert seen == []
        return
    ((name, args),) = seen
    assert name == "dot_interaction"
    assert args == (x.data_ptr(), out.data_ptr(), b, f, d, *ops.dot_fwd_plan(b, f, d))


@pytest.mark.parametrize("f", [2, 27])
@pytest.mark.parametrize("d", [1, 3, 129])
def test_dot_interaction_plain_matches_pallas_at_plan_edges(f, d):
    """The plain forward against the Pallas kernel in interpret mode and the
    reference at the widths the kernel's plan treats apart (a single float,
    a padded column group, one past 128), for a single pair and full F."""
    b = 7
    x, _ = _dot_case(b, f, d, 11 * f + d)
    got = ops.dot_interaction(_t(x))
    jx = jnp.asarray(x)
    for exp in (jref.dot_interaction_ref(jx),
                dot_interaction_pallas(jx, block_b=4, interpret=True)):
        _close(got.numpy(), exp)


# -------------------------------------------------------------------- model


def test_dlrm_config_matches_reference():
    for kw in (dict(), BENCH):
        j, t = jdlrm(**kw), dlrm(**kw)
        assert (t.name, t.n_dense, t.mlp_dims, t.dense_arch) == \
            (j.name, j.n_dense, j.mlp_dims, j.dense_arch)
        assert [(f.name, f.vocab, f.dim, f.max_len, f.pooling) for f in t.fields] == \
            [(f.name, f.vocab, f.dim, f.max_len, f.pooling) for f in j.fields]
        assert [(i.kind, i.kwargs) for i in t.interactions] == \
            [(i.kind, i.kwargs) for i in j.interactions]
    full = dlrm()
    assert (len(full.fields), full.fields[0].dim, full.dense_arch, full.mlp_dims) == \
        (26, 128, (512, 256, 128), (1024, 1024, 512, 256))


@pytest.mark.parametrize("kw,base,deep", [(BENCH, 26 * 16 + 16, 26 * 16 + 16 + 351),
                                          (dict(), 26 * 128 + 128, 26 * 128 + 128 + 351)])
def test_dlrm_wiring_matches_reference(kw, base, deep):
    """Both configs put 27 vectors in the dots (P = 351); the full config is
    planned with every cache off, so no table is sized."""
    plan_kw = dict(enable_cache=False)
    jcfg, cfg = jdlrm(**kw), dlrm(**kw)
    jmodel = JWDLModel(jcfg, jmake_plan(jcfg, 1, 8, **plan_kw))
    model = WDLModel(cfg, make_plan(cfg, 1, 8, **plan_kw))
    assert model.base_dim == jmodel._wiring["base_dim"] == base
    assert model.deep_dim == jmodel._wiring["deep_dim"] == deep
    assert model.consumed_base == jmodel._wiring["consumed_base"] is False


def _bench_pair(b, strategy="picasso"):
    jcfg, cfg = jdlrm(**BENCH), dlrm(**BENCH)
    kw = PLAN_KW[strategy]
    jplan, plan = jmake_plan(jcfg, 1, b, **kw), make_plan(cfg, 1, b, **kw)
    if strategy != "picasso":
        japply_assignment(jplan, jresolve_assignment(jplan, strategy))
        resolve_assignment(plan, strategy)
    return jcfg, cfg, jplan, plan, JWDLModel(jcfg, jplan), WDLModel(cfg, plan)


def test_dlrm_apply_and_loss_match_reference(mesh1):
    """Logits and loss of the bench config from the reference's carried-over
    parameters, the bottom MLP included."""
    b = 16
    jcfg, cfg, jplan, plan, jmodel, model = _bench_pair(b)
    g = plan.groups[0]
    st = jinit_state(jmodel, jplan, jax.random.PRNGKey(1), mesh=mesh1, axes=AXES)
    dense_np = jax.device_get(st["dense"])
    _, dense_t = state_from_jax(jax.device_get(st["emb"]), dense_np, plan, "cpu")
    assert sorted(dense_t) == sorted(dense_np) == ["bottom", "top"]
    own = model.init_dense(torch.Generator().manual_seed(0), torch.device("cpu"))
    assert [tuple(a.shape) for a in topt.tree_leaves(own)] == \
        [tuple(np.shape(a)) for a in jax.tree.leaves(dense_np)]
    rng = np.random.default_rng(2)
    pooled = {g.gid: rng.normal(size=(b, g.n_bags, g.dim)).astype(np.float32)}
    batch = jmake_batch(jcfg, b, rng)
    side = {"labels": _t(batch["labels"]), "dense": dense_features(cfg, batch, "cpu")}
    jl, jlog = jmodel.loss(dense_np, {k: jnp.asarray(v) for k, v in pooled.items()},
                           jax.tree.map(jnp.asarray, batch))
    tl, tlog = model.loss(dense_t, {k: _t(v) for k, v in pooled.items()}, side)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    probs = torch.sigmoid(tlog)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jax.nn.sigmoid(jlog)),
                               atol=1e-5, rtol=0)


def _warm_counts(plan, ids):
    counts = np.zeros(plan.groups[0].rows, np.int32)
    counts[ids[::3]] = 5
    counts[ids[1::3]] = 2
    counts[np.random.default_rng(4).integers(0, len(counts), 4096)] += 1
    return counts


def _jax_tier_hits(mesh, jplan, strategy, emb, fields):
    """(L1 hits, L2 hits) of the reference's lookup of one request."""
    engine = JEngine(jplan, AXES, 1, strategy=strategy, use_fused_kernels="off")

    def f(emb, fields):
        packed = {g.gid: jpack_group(g, fields) for g in jplan.groups}
        _, ctx = engine.forward(emb, packed)
        c = ctx.ctxs[0]
        l2 = jnp.sum(c.l2_hit) if c.l2_hit is not None else jnp.zeros((), jnp.int32)
        return jnp.sum(c.hit), l2

    g = jax.jit(shard_map(f, mesh=mesh, in_specs=(emb_specs(jplan, AXES), replicated(fields)),
                          out_specs=(P(), P()), check_vma=False))
    return tuple(int(x) for x in g(emb, fields))


@pytest.mark.parametrize("strategy", ["picasso", "picasso_narrow"])
def test_dlrm_serve_matches_reference(mesh1, strategy):
    """The bench config with the tiers warmed by the reference's flush: the
    port's probabilities within 1e-5 of the reference's (fused off and on),
    tier hits equal and non-zero (L2 too under ``picasso_narrow``)."""
    b = 16
    jcfg, cfg, jplan, plan, jmodel, model = _bench_pair(b, strategy)
    state = jinit_state(jmodel, jplan, jax.random.PRNGKey(0), mesh=mesh1, axes=AXES)
    batch = jmake_batch(jcfg, b, np.random.default_rng(3))
    ids = pack_group(plan.groups[0], batch["fields"], "cpu").ids.numpy()
    emb = dict(state["emb"])
    emb["0"] = emb["0"]._replace(counts=jnp.asarray(_warm_counts(plan, ids)))
    state = jmake_flush_fn(jplan, mesh1, AXES)({**state, "emb": emb})
    emb_t, dense_t = state_from_jax(jax.device_get(state["emb"]),
                                    jax.device_get(state["dense"]), plan, "cpu")
    serve = make_serve_step(model, plan, b, ServeConfig(strategy=strategy), "cpu")
    probs, ctx = serve.score({"emb": emb_t, "dense": dense_t}, batch)
    c = ctx.ctxs[0]
    hits = (int(c.hit.sum()), int(c.l2_hit.sum()) if c.l2_hit is not None else 0)
    assert probs.shape == (b, 1)
    for mode in ("off", "on"):
        jserve = jmake_serve_step(jmodel, jplan, mesh1, AXES, b, scfg=JServeConfig(
            strategy=strategy, use_fused_kernels=mode))
        np.testing.assert_allclose(probs.numpy(), np.asarray(jserve(state, batch)),
                                   atol=1e-5, rtol=0)
    assert hits == _jax_tier_hits(mesh1, jplan, strategy, state["emb"], batch["fields"])
    assert hits[0] > 0 and (hits[1] > 0 or strategy == "picasso")


@pytest.mark.parametrize("strategy", ["picasso", "picasso_narrow"])
def test_dlrm_train_trajectory_matches_reference(mesh1, strategy):
    """8 steps with a flush at step 3. ``picasso`` compounds over the 8
    steps. ``picasso_narrow`` is held one step at a time from a shared
    state (the reference's, rebuilt by ``train_state_from_jax`` before each
    step), at the same bars: over 8 compounding steps its d = 4 master
    parts from the reference's by up to 4.3e-4 in 17 of 131,300 entries
    under some packing salts (PYTHONHASHSEED 62, 78), while every step from
    a shared state stays within 1e-4."""
    shared_state = strategy == "picasso_narrow"
    jcfg, cfg, jplan, plan, jmodel, model = _bench_pair(GB, strategy)
    jstate = jinit_state(jmodel, jplan, jax.random.PRNGKey(0), mesh=mesh1, axes=AXES)
    state = train_state_from_jax(jax.device_get(jstate), plan, "cpu")
    tc = dict(strategy=strategy, use_fused_kernels="off")
    jstep, _ = jmake_train_step(jmodel, jplan, mesh1, AXES, GB, JTrainConfig(**tc),
                                donate=False)
    step = make_train_step(model, plan, GB, TrainConfig(**tc), "cpu")
    keys = ("cache_hits", "overflow") + (
        ("cache_hits/l1", "cache_hits/l2") if strategy == "picasso_narrow" else ())
    assert set(keys) <= set(step.engine.metric_keys)
    rng = np.random.default_rng(0)
    jl, tl, jm, tm = [], [], [], []
    for _ in range(STEPS):
        b = jmake_batch(jcfg, GB, rng)
        if shared_state:
            state = train_state_from_jax(jax.device_get(jstate), plan, "cpu")
        jstate, jmet = jstep(jstate, jax.device_put(b, to_named(mesh1, batch_specs(b, AXES))))
        state, met = step(state, b)
        jl.append(float(jmet["loss"]))
        tl.append(float(met["loss"]))
        jm.append(tuple(int(jmet[k]) for k in keys))
        tm.append(tuple(int(met[k]) for k in keys))
        if shared_state:
            np.testing.assert_allclose(tl[-1], jl[-1], rtol=1e-4, atol=1e-5)
            assert tm[-1] == jm[-1]
            _check_dlrm_state(state, jax.device_get(jstate), plan, strategy)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-5)
    assert tm == jm
    # the step-3 flush warms the tiers (both under picasso_narrow)
    assert all(h[0] == 0 for h in tm[:3])
    assert all(min(h[:1] + h[2:]) > 0 for h in tm[3:])
    _check_dlrm_state(state, jax.device_get(jstate), plan, strategy)
    assert int(state["opt"]["t"]) == STEPS


def _check_dlrm_state(state, jfin, plan, strategy):
    """The port's train state against the reference's (host numpy): integer
    state bitwise, float state (the tiers, the projection, the dense
    parameters and Adam's moments included) to atol 1e-4."""
    jst, st = jfin["emb"]["0"], state["emb"]["0"]
    assert tuple(st.w.shape) == (plan.groups[0].rows, plan.narrow_width(0))
    np.testing.assert_array_equal(st.counts.numpy(), np.asarray(jst.counts))
    np.testing.assert_array_equal(st.cache.keys.numpy(), np.asarray(jst.cache.keys))
    pairs = [(st.w, jst.w), (st.acc, jst.acc), (st.cache.rows, jst.cache.rows),
             (st.cache.acc, jst.cache.acc)]
    if strategy == "picasso_narrow":
        np.testing.assert_array_equal(st.l2.keys.numpy(), np.asarray(jst.l2.keys))
        pairs += [(st.l2.rows, jst.l2.rows), (st.l2.acc, jst.l2.acc),
                  (st.proj.kernel, jst.proj.kernel), (st.proj.acc, jst.proj.acc)]
    for got, exp in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-4, rtol=0)
    for tree, jtree in ((state["dense"], jfin["dense"]), (state["opt"]["m"], jfin["opt"]["m"]),
                        (state["opt"]["v"], jfin["opt"]["v"])):
        leaves, jleaves = topt.tree_leaves(tree), jax.tree.leaves(jtree)
        assert len(leaves) == len(jleaves) and "bottom" in tree
        for a, b in zip(leaves, jleaves):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)
    assert int(state["opt"]["t"]) == int(jfin["opt"]["t"])
