"""The port's sequence slice against the reference on the CPU: the sequence
and multi-task interactions (forward and gradient), the JAX-compatible
normal draw, the model wiring of sasrec, mind and the paper's configs, their
serving and training, the plain ``embedding_bag`` and the conversion of
their nested parameter trees.

Every case runs the same numpy inputs, made from a seed, through the
reference's function and the port's. Interactions are held to 1e-5 of the
scale: the reference output's largest entry for the output, the largest
entry of any of the case's gradients for each gradient (a gradient that is
zero in exact arithmetic, as a bias in front of a softmax has, is rounding
noise on that scale); probabilities to 1e-5; training at the bars of
``tests/test_torch_train.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import paper_models as jpm
from repro.core.packing import make_plan as jmake_plan
from repro.data.synthetic import make_batch as jmake_batch
from repro.dist.sharding import batch_specs, to_named
from repro.embedding.bag import embedding_bag as jembedding_bag
from repro.layers import interactions as JI
from repro.layers import mlp as jmlp
from repro.models.wdl import WDLModel as JWDLModel
from repro.serve.serve_step import ServeConfig as JServeConfig
from repro.serve.serve_step import make_serve_step as jmake_serve_step
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import init_state as jinit_state
from repro.train.train_step import make_flush_fn
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.configs import paper_models as pm
from repro_torch.convert import state_from_jax, train_state_from_jax
from repro_torch.core import jax_random as R
from repro_torch.core.features import mask_key, pack_group, seq_masks
from repro_torch.core.packing import make_plan
from repro_torch.embedding.bag import embedding_bag
from repro_torch.layers import interactions as I
from repro_torch.layers import mlp as tmlp
from repro_torch.models.wdl import WDLModel
from repro_torch.optim import optimizers as topt
from repro_torch.serve.serve_step import ServeConfig, make_serve_step
from repro_torch.train.train_step import TrainConfig, init_state, make_train_step

from test_torch_train import _check_state, check_train_trajectory

torch.set_num_threads(1)

AXES = ("data", "model")
B, L, D = 5, 6, 8
TOL = 1e-5
PAPER = ("widedeep", "dlrm", "din", "mmoe", "can")


def _t(x, grad=False):
    t = torch.as_tensor(np.array(x))
    return t.requires_grad_(True) if grad else t


def _tree_t(tree, grad=False):
    return {k: _tree_t(v, grad) for k, v in tree.items()} if isinstance(tree, dict) \
        else _t(tree, grad)


def _masks():
    """[B, L] validity: all valid, one valid, none valid, and two random."""
    m = np.random.default_rng(7).random((B, L)) < 0.6
    m[0], m[1], m[2] = True, False, False
    m[1, 0] = True
    return m


def _close(got, exp, what, scale=None):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    assert got.shape == exp.shape, (what, got.shape, exp.shape)
    scale = float(np.abs(exp).max()) if scale is None else scale
    err = float(np.abs(got - exp).max()) if got.size else 0.0
    assert err <= TOL * scale or err == 0.0, f"{what}: err {err} of scale {scale}"


def _check_fn(jfn, tfn, jparams, xs, consts=(), seed=0):
    """``jfn(params, *xs, *consts)`` against ``tfn`` on the same values:
    the output, and through a random cotangent (``jax.vjp`` against
    autograd) the gradients of every parameter and every input in ``xs``."""
    jp = jax.tree.map(jnp.asarray, jparams)
    jc = tuple(jnp.asarray(c) for c in consts)
    jout, vjp = jax.vjp(jax.jit(lambda p, *a: jfn(p, *a, *jc)),
                        jp, *(jnp.asarray(x) for x in xs))
    ct = np.random.default_rng(seed).standard_normal(jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(ct))
    tp = _tree_t(jax.device_get(jparams), grad=True)
    txs = [_t(x, grad=True) for x in xs]
    tout = tfn(tp, *txs, *(_t(c) for c in consts))
    _close(tout.detach().numpy(), jout, "forward")
    leaves = topt.tree_leaves(tp)
    got = torch.autograd.grad(tout, leaves + txs, grad_outputs=_t(ct), allow_unused=True)
    exp = jax.tree.leaves(jgrads[0]) + list(jgrads[1:])
    assert len(got) == len(exp)
    scale = max(float(np.abs(np.asarray(e)).max()) for e in exp)
    for i, (g, e) in enumerate(zip(got, exp)):
        _close(np.zeros(np.shape(e)) if g is None else g.numpy(), e, f"gradient {i}", scale)


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------ interactions

def _stack(fn):
    return lambda *a: jnp.stack(fn(*a), axis=0)


K0 = jax.random.PRNGKey(3)
INTERACTIONS = {
    "linear_terms": lambda: (JI.linear_terms, I.linear_terms,
                             JI.init_linear_terms(K0, 3, D), [_x(B, 3, D)], ()),
    "layernorm": lambda: (jmlp.layernorm, tmlp.layernorm,
                          {"g": _x(D, seed=4), "b": _x(D, seed=5)}, [_x(B, L, D)], ()),
    "mha 1 head causal": lambda: (
        lambda p, x, m: JI.mha(p, x, m, 1), lambda p, x, m: I.mha(p, x, m, 1),
        JI.init_mha(K0, D, 1), [_x(B, L, D)], (_masks(),)),
    "mha 2 heads acausal": lambda: (
        lambda p, x, m: JI.mha(p, x, m, 2, causal=False),
        lambda p, x, m: I.mha(p, x, m, 2, causal=False),
        JI.init_mha(K0, D, 2), [_x(B, L, D)], (_masks(),)),
    "sasrec_block": lambda: (
        lambda p, x, m: JI.sasrec_block(p, x, m, 1), lambda p, x, m: I.sasrec_block(p, x, m, 1),
        JI.init_sasrec_block(K0, D, 1), [_x(B, L, D)], (_masks(),)),
    "self_attn_seq": lambda: (
        lambda p, x, m: JI.self_attn_seq(p, x, m, 2), lambda p, x, m: I.self_attn_seq(p, x, m, 2),
        JI.init_self_attn_seq(K0, D, 2, 2), [_x(B, L, D)], (_masks(),)),
    "target_attn": lambda: (JI.target_attn, I.target_attn, JI.init_target_attn(K0, D),
                            [_x(B, L, D), _x(B, D, seed=2)], (_masks(),)),
    "squash": lambda: (lambda p, v: JI._squash(v), lambda p, v: I._squash(v), {},
                       [_x(B, 4, D)], ()),
    "capsule_routing": lambda: (
        lambda p, x, m: JI.capsule_routing(p, x, m, 3, jax.random.PRNGKey(17), n_interests=4),
        lambda p, x, m: I.capsule_routing(p, x, m, 3, n_interests=4),
        JI.init_capsule(K0, D, 4), [_x(B, L, D)], (_masks(),)),
    "label_aware_attn": lambda: (lambda p, c, t: JI.label_aware_attn(c, t),
                                 lambda p, c, t: I.label_aware_attn(c, t), {},
                                 [_x(B, 4, D), _x(B, D, seed=2)], ()),
    "gru": lambda: (JI.gru, I.gru, JI.init_gru(K0, D), [_x(B, L, D)], (_masks(),)),
    "mmoe": lambda: (_stack(JI.mmoe), lambda p, x: torch.stack(I.mmoe(p, x), 0),
                     JI.init_mmoe(K0, 12, 3, 7, 2), [_x(B, 12)], ()),
    "coaction (4, 4)": lambda: (lambda p, h, t, m: JI.coaction(h, t, m),
                                lambda p, h, t, m: I.coaction(h, t, m), {},
                                [_x(B, L, D), _x(B, D, seed=2)], (_masks(),)),
    "coaction (3, 5), tiled 4 times": lambda: (
        lambda p, h, t, m: JI.coaction(h, t, m, (3, 5)),
        lambda p, h, t, m: I.coaction(h, t, m, (3, 5)), {},
        [_x(B, L, D), _x(B, D, seed=2)], (_masks(),)),
}


@pytest.mark.parametrize("name", sorted(INTERACTIONS))
def test_interaction_matches_reference(name):
    jfn, tfn, params, xs, consts = INTERACTIONS[name]()
    _check_fn(jfn, tfn, params, xs, consts)


def test_fully_masked_sample_is_uniform_not_nan():
    """-1e9 masks: a sample with no valid position gets uniform attention
    and finite outputs; ``self_attn_seq`` reads it at position 0."""
    p = _tree_t(jax.device_get(JI.init_self_attn_seq(K0, D, 2, 1)))
    x, m = _t(_x(B, L, D)), _t(_masks())
    out = I.self_attn_seq(p, x, m, 1)
    assert torch.isfinite(out).all()
    a = I.mha(p["b0"]["attn"], x, torch.zeros_like(m), 1, causal=False)
    v = x @ p["b0"]["attn"]["wv"]
    torch.testing.assert_close(a, (v.mean(1, keepdim=True) @ p["b0"]["attn"]["wo"])
                               .expand_as(a), rtol=1e-5, atol=1e-5)


def test_gru_masked_steps_keep_state():
    """A masked step leaves ``h`` as it was: a sample with no valid step
    ends at the zero state, and appending masked steps changes nothing."""
    p = _tree_t(jax.device_get(JI.init_gru(K0, D)))
    x, m = _t(_x(B, L, D)), _t(_masks())
    h = I.gru(p, x, m)
    assert torch.equal(h[2], torch.zeros(D))
    pad = torch.cat([x, _t(_x(B, 3, D, seed=9))], 1)
    assert torch.equal(I.gru(p, pad, torch.cat([m, torch.zeros((B, 3), dtype=torch.bool)], 1)),
                       h)


# ------------------------------------------------------------- normal draw

@pytest.mark.parametrize("shape", [(1, 4, 8), (8, 4, 10), (5, 4, 50)])
def test_jax_normal_draw(shape):
    key = jax.random.PRNGKey(17)
    np.testing.assert_array_equal(R.bits(R.prng_key(17), shape),
                                  np.asarray(jax.random.bits(key, shape)))
    np.testing.assert_allclose(R.normal(R.prng_key(17), shape),
                               np.asarray(jax.random.normal(key, shape)), rtol=0, atol=2e-6)


def test_jax_key_tree():
    """``split`` and ``fold_in`` give the reference's keys, so an
    initialiser fed a ``JaxKey`` draws the reference's weights."""
    key = jax.random.PRNGKey(5)
    np.testing.assert_array_equal(np.array(R.split(R.prng_key(5), 3), np.uint32),
                                  np.asarray(jax.random.split(key, 3)))
    np.testing.assert_array_equal(np.array(R.fold_in(R.prng_key(5), 11), np.uint32),
                                  np.asarray(jax.random.fold_in(key, 11)))
    for arch in ("sasrec", "mind"):
        jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
        jplan, plan = jmake_plan(jcfg, 1, 4), make_plan(cfg, 1, 4)
        js = jax.device_get(jinit_state(JWDLModel(jcfg, jplan), jplan, jax.random.PRNGKey(0)))
        st = init_state(WDLModel(cfg, plan), plan, R.prng_key(0), "cpu")
        for a, b in zip(topt.tree_leaves(st["dense"]), jax.tree.leaves(js["dense"])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-6)
        np.testing.assert_allclose(st["emb"]["0"].w.numpy(), np.asarray(js["emb"]["0"].w),
                                   rtol=0, atol=2e-6)


# ------------------------------------------------------------------ wiring

def _configs(name, size):
    if name in ("sasrec", "mind"):
        return jget_config(name, smoke=size == "smoke"), get_config(name, smoke=size == "smoke")
    return jpm.PAPER_MODELS[name](scale=size), pm.PAPER_MODELS[name](scale=size)


@pytest.mark.parametrize("name,size", [(a, s) for a in ("sasrec", "mind")
                                       for s in ("smoke", "full")]
                         + [(a, s) for a in ("din", "mmoe", "can") for s in (0.01, 1.0)])
def test_wiring_matches_reference(name, size):
    jcfg, cfg = _configs(name, size)
    assert repr(cfg) == repr(jcfg)
    jplan, plan = jmake_plan(jcfg, 1, 8), make_plan(cfg, 1, 8)
    jw, model = JWDLModel(jcfg, jplan)._wiring, WDLModel(cfg, plan)
    assert (model.base_dim, model.deep_dim, model.consumed_base) == \
        (jw["base_dim"], jw["deep_dim"], jw["consumed_base"])
    assert [f.name for f in model.pooled_fields] == \
        [f.name for f in jcfg.fields if f.pooling != "none"]


def test_unknown_interaction_raises_value_error():
    cfg = get_config("sasrec", smoke=True)
    bad = dataclasses.replace(cfg, interactions=(dataclasses.replace(
        cfg.interactions[0], kind="cin"),))
    with pytest.raises(ValueError, match="unknown interaction cin"):
        WDLModel(bad, make_plan(bad, 1, 8))


def test_sequence_views_and_masks():
    """A sequence field is ``[B, L, D]`` of the packed group output, a
    pooled one ``[B, D]``; the masks are the batch's ``weights > 0`` from
    one copy, flat under ``mask_key``."""
    cfg = get_config("sasrec", smoke=True)
    plan = make_plan(cfg, 1, 8)
    model = WDLModel(cfg, plan)
    pooled = {0: torch.arange(8 * 21 * 16, dtype=torch.float32).reshape(8, 21, 16)}
    assert torch.equal(model.field_emb(pooled, "hist_items"), pooled[0][:, 0:10])
    assert torch.equal(model.field_emb(pooled, "pos"), pooled[0][:, 10:20])
    assert torch.equal(model.field_emb(pooled, "target_item"), pooled[0][:, 20])
    batch = jmake_batch(cfg, 8, np.random.default_rng(0))
    masks = seq_masks(cfg, batch, "cpu")
    assert sorted(masks) == [mask_key("hist_items"), mask_key("pos")]
    for f in ("hist_items", "pos"):
        np.testing.assert_array_equal(masks[mask_key(f)].numpy(),
                                      batch["fields"][f]["weights"] > 0)


# ----------------------------------------------------------------- serving

def _warm_state(mesh1, jcfg, jplan, jmodel, batch, flush=True):
    """The reference's state from PRNGKey(0) with the FCounter warmed on
    half of this request's ids, flushed into the hot tier."""
    state = jinit_state(jmodel, jplan, jax.random.PRNGKey(0), mesh=mesh1, axes=AXES)
    if not flush:
        return state
    emb = dict(state["emb"])
    for g in jplan.groups:
        ids = pack_group(g, batch["fields"], "cpu").ids.numpy()
        counts = np.zeros(g.rows, np.int32)
        counts[ids[::2]] = 3
        emb[str(g.gid)] = emb[str(g.gid)]._replace(counts=jnp.asarray(counts))
    return make_flush_fn(jplan, mesh1, AXES)({**state, "emb": emb})


def check_serve(mesh1, jcfg, cfg, modes=("off",), b=8):
    jplan, plan = jmake_plan(jcfg, 1, b), make_plan(cfg, 1, b)
    jmodel, model = JWDLModel(jcfg, jplan), WDLModel(cfg, plan)
    batch = jmake_batch(jcfg, b, np.random.default_rng(3))
    state = _warm_state(mesh1, jcfg, jplan, jmodel, batch)
    emb_t, dense_t = state_from_jax(jax.device_get(state["emb"]),
                                    jax.device_get(state["dense"]), plan, "cpu")
    probs, ctx = make_serve_step(model, plan, b, ServeConfig(), "cpu").score(
        {"emb": emb_t, "dense": dense_t}, batch)
    assert probs.shape == (b, cfg.n_tasks)
    assert sum(int(c.hit.sum()) for c in ctx.ctxs.values()) > 0
    for mode in modes:
        jserve = jmake_serve_step(jmodel, jplan, mesh1, AXES, b,
                                  scfg=JServeConfig(use_fused_kernels=mode))
        np.testing.assert_allclose(probs.numpy(), np.asarray(jserve(state, batch)),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ["sasrec", "mind"])
def test_smoke_serve_matches_reference(mesh1, arch):
    check_serve(mesh1, jget_config(arch, smoke=True), get_config(arch, smoke=True),
                modes=("off", "on"))


@pytest.mark.parametrize("name", PAPER)
def test_paper_config_serve_matches_reference(mesh1, name):
    check_serve(mesh1, *_configs(name, 0.01))


# ---------------------------------------------------------------- training

@pytest.mark.parametrize("arch", ["sasrec", "mind"])
def test_smoke_train_trajectory_matches_reference(mesh1, arch):
    """8 steps with the flush at step 3, each from a shared state (the
    reference's, carried over) under ``_KinkAware``: over compounding steps
    the two sides' float32 sums in other orders parted sasrec's loss by up to
    2.7e-4 relative after the flush under ``PYTHONHASHSEED=4`` (one of seeds
    1-8), while every step from one state meets the bars."""
    check_train_trajectory(mesh1, arch, "psum", 1, shared_state=True)


# dense elements one paper-config step may hand over (both sides' gradients
# within rounding noise of zero); the sweep over PYTHONHASHSEED 0-16 met at
# most 2 a run (DIN)
MAX_HANDED = 4


@pytest.mark.parametrize("name", PAPER)
def test_paper_config_trains_a_step_like_reference(mesh1, name):
    """One step of each paper config (``scale=0.01``, no tier, as the
    reference's ``test_paper_models_smoke``) from one state: the loss to rtol
    1e-5 and the state after it at ``_check_state``'s bars. Adam's first step is
    ``lr * g / (|g| + eps)``, so a parameter whose gradient lies within
    rounding noise of zero has a step that follows the noise: the last bias
    of DIN's attention MLP sits in front of a softmax that ignores a shift,
    so its gradient is zero in exact arithmetic, and a hidden unit can carry
    a gradient of 1e-10. An element that parts past the 1e-4 bar is handed
    over to the reference's value only where both sides' gradients are
    below 100 eps (Adam moment ``0.1 g`` below 1e-7), and at most
    ``MAX_HANDED`` of them a config; a gradient the port puts where the
    reference has none parts with a moment past that and fails."""
    jcfg, cfg = _configs(name, 0.01)
    gb = 4
    jplan = jmake_plan(jcfg, world=1, per_device_batch=gb, enable_cache=False)
    plan = make_plan(cfg, world=1, per_device_batch=gb, enable_cache=False)
    jmodel = JWDLModel(jcfg, jplan)
    jstate = jinit_state(jmodel, jplan, jax.random.PRNGKey(0), mesh=mesh1, axes=AXES)
    j0 = jax.device_get(jstate)
    state = train_state_from_jax(j0, plan, "cpu")
    jstep, _ = jmake_train_step(jmodel, jplan, mesh1, AXES, gb,
                                JTrainConfig(use_cache=False, use_fused_kernels="off"),
                                donate=False)
    step = make_train_step(WDLModel(cfg, plan), plan, gb, TrainConfig(use_cache=False), "cpu")
    batch = jmake_batch(jcfg, gb, np.random.default_rng(2))
    state, m = step(state, batch)
    jstate, jm = jstep(jstate, jax.device_put(batch, to_named(mesh1, batch_specs(batch, AXES))))
    assert np.isfinite(float(m["loss"]))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    jfin = jax.device_get(jstate)
    held, n_handed = [], 0
    for a, b, mo, jmo in zip(topt.tree_leaves(state["dense"]), jax.tree.leaves(jfin["dense"]),
                             topt.tree_leaves(state["opt"]["m"]),
                             jax.tree.leaves(jfin["opt"]["m"])):
        a, b = a.numpy(), np.asarray(b)
        noise = (np.abs(mo.numpy()) < 1e-7) & (np.abs(np.asarray(jmo)) < 1e-7)
        handed = noise & (np.abs(a - b) > 1e-4)
        n_handed += int(handed.sum())
        held.append(_t(np.where(handed, b, a)))
    assert n_handed <= MAX_HANDED, n_handed
    state["dense"] = topt.tree_unflatten(state["dense"], held)
    _check_state(state, jfin)


# -------------------------------------------------------- bag and convert

def test_embedding_bag_matches_reference():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((50, 7)).astype(np.float32)
    ids = rng.integers(0, 50, 40).astype(np.int32)
    seg = rng.integers(0, 12, 40).astype(np.int32)
    seg[:3] = (12, 15, -1)  # outside [0, n_bags): dropped, as segment_sum drops them
    w = rng.random(40).astype(np.float32)
    for weights in (None, w):
        got = embedding_bag(_t(table), _t(ids), _t(seg), 12,
                            None if weights is None else _t(weights))
        exp = jembedding_bag(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(seg), 12,
                             None if weights is None else jnp.asarray(weights))
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["sasrec", "mind", "mmoe"])
def test_convert_carries_nested_trees_unchanged(name):
    """``b{i}``/``ln_f``/``attn``, ``s``, ``e{i}``/``g{t}`` and ``task{t}``
    carry over leaf for leaf, and the port's own init has that layout."""
    jcfg, cfg = _configs(name, "smoke" if name != "mmoe" else 0.01)
    jplan, plan = jmake_plan(jcfg, 1, 4), make_plan(cfg, 1, 4)
    jstate = jax.device_get(jinit_state(JWDLModel(jcfg, jplan), jplan,
                                        jax.random.PRNGKey(0)))
    _, dense = state_from_jax(jstate["emb"], jstate["dense"], plan, "cpu")
    own = WDLModel(cfg, plan).init_dense(torch.Generator().manual_seed(0),
                                         torch.device("cpu"))
    ref = jax.tree.structure(jax.tree.map(lambda a: 0, jstate["dense"]))
    assert jax.tree.structure(topt.tree_map(lambda a: 0, dense)) == ref
    assert jax.tree.structure(topt.tree_map(lambda a: 0, own)) == ref
    for a, b, c in zip(topt.tree_leaves(dense), jax.tree.leaves(jstate["dense"]),
                       topt.tree_leaves(own)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert tuple(c.shape) == tuple(np.shape(b))
