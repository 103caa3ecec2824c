"""The port's dcn-v2 path against the reference on the CPU.

Kernel layer: the plain cross layer and its backward in
``repro_torch.kernels.ref`` against ``repro.kernels.ref``, the Pallas
kernels in interpret mode and ``jax.vjp``, at widths that are not a
multiple of 4 or 128 and batches that are not a multiple of the block
(atol 1e-5 of the value scale: float32 sums in another order); the autograd
wiring of the kernel path with the CUDA wrappers stood in for by the plain
versions; the dispatch and shape rules around the CUDA kernels, which run
only on the card (``chip_smoke.py``).

Model and steps: dcn-v2-smoke (26 fields at dim 16 + 13 dense features,
three cross layers over the 429-wide base, MLP 64-32) with the reference's
parameters carried over by ``convert``: logits and loss to 1e-5, serving
probabilities to 1e-5 with equal tier hits, and the 8-step training
trajectory with a flush at step 3 to the deepfm bars (losses rtol 1e-4 /
atol 1e-5, hits and integer state bitwise, float state to 1e-4).
"""
import dataclasses
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serve import ROOT, _env, check_smoke_serve
from test_torch_train import check_train_trajectory

from repro.configs import get_config as jget_config
from repro.core.packing import make_plan as jmake_plan
from repro.data.synthetic import make_batch as jmake_batch
from repro.kernels import ref as jref
from repro.kernels.cross_layer import cross_layer_pallas
from repro.kernels.interaction_bwd import cross_layer_bwd_pallas
from repro.models.wdl import WDLModel as JWDLModel
from repro.train.train_step import init_state as jinit_state
from repro_torch.configs import get_config
from repro_torch.convert import state_from_jax
from repro_torch.core.features import dense_features
from repro_torch.core.packing import make_plan
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.layers import interactions as I
from repro_torch.models.wdl import WDLModel
from repro_torch.optim import optimizers as topt

torch.set_num_threads(1)

AXES = ("data", "model")


def _t(x):
    return torch.as_tensor(np.array(x))


def _cross_case(b, d, seed):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(b, d)).astype(np.float32)
    x = rng.normal(size=(b, d)).astype(np.float32)
    w = (rng.normal(size=(d, d)) / np.sqrt(d)).astype(np.float32)
    bias = rng.normal(size=d).astype(np.float32)
    g = rng.normal(size=(b, d)).astype(np.float32)
    return x0, x, w, bias, g


def _scale(exp):
    return max(float(np.abs(np.asarray(exp)).max()), 1.0)


def _close(got, exp):
    exp = np.asarray(exp)
    np.testing.assert_allclose(np.asarray(got), exp, rtol=0, atol=1e-5 * _scale(exp))


# (B, d): d = 429 is dcn-v2's width; 37, 67 and 130 are no multiple of 4,
# 128 or of the Pallas kernels' 128-row batch block
CROSS_SHAPES = [(8, 16), (37, 29), (130, 67), (200, 429)]


@pytest.mark.parametrize("b,d", CROSS_SHAPES)
def test_cross_layer_plain_matches_reference_and_pallas(b, d):
    x0, x, w, bias, _ = _cross_case(b, d, b + d)
    got = ops.cross_layer(_t(x0), _t(x), _t(w), _t(bias))
    assert got.shape == (b, d) and got.dtype == torch.float32
    jargs = tuple(map(jnp.asarray, (x0, x, w, bias)))
    for exp in (jref.cross_layer_ref(*jargs), cross_layer_pallas(*jargs, interpret=True)):
        _close(got.numpy(), exp)
    _close(tref.cross_layer_ref(_t(x0), _t(x), _t(w), _t(bias)).numpy(),
           jref.cross_layer_ref(*jargs))


@pytest.mark.parametrize("b,d", CROSS_SHAPES)
def test_cross_layer_bwd_plain_matches_reference_pallas_and_vjp(b, d):
    x0, x, w, bias, g = _cross_case(b, d, 3 * b + d)
    got = ops.cross_layer_bwd(*map(_t, (x0, x, w, bias, g)))
    jargs = tuple(map(jnp.asarray, (x0, x, w, bias)))
    jg = jnp.asarray(g)
    _, vjp = jax.vjp(jref.cross_layer_ref, *jargs)
    for exp in (jref.cross_layer_bwd_ref(*jargs, jg),
                cross_layer_bwd_pallas(*jargs, jg, interpret=True), vjp(jg)):
        assert len(exp) == len(got) == 4
        for a, e in zip(got, exp):
            assert tuple(a.shape) == tuple(e.shape)
            _close(a.numpy(), e)


def _plain_cross(monkeypatch):
    """Take the kernel path on CPU tensors with the CUDA wrappers stood in
    for by their plain versions, so autograd runs the kernel path's wiring."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(*a):
        calls["fwd"] += 1
        return tref.cross_layer_ref(*a)

    def bwd(*a):
        calls["bwd"] += 1
        return tref.cross_layer_bwd_ref(*a)

    monkeypatch.setattr(ops, "_use_kernel", lambda fused, t, op: True)
    monkeypatch.setattr(ops, "_cross_layer_cuda", fwd)
    monkeypatch.setattr(ops, "_cross_layer_bwd_cuda", bwd)
    return calls


@pytest.mark.parametrize("alias", [False, True])
def test_cross_kernel_path_is_differentiable(monkeypatch, alias):
    """Gradients reach x0, x, w and b through the kernel path; at layer 0 x
    is x0 itself, and its gradient is the sum of both cotangents."""
    calls = _plain_cross(monkeypatch)
    x0, x, w, bias, g = _cross_case(33, 21, 5)
    if alias:
        x = x0
    tx0 = _t(x0).requires_grad_(True)
    tx = tx0 if alias else _t(x).requires_grad_(True)
    tw, tb = _t(w).requires_grad_(True), _t(bias).requires_grad_(True)
    out = ops.cross_layer(tx0, tx, tw, tb)
    assert out.grad_fn is not None
    # a non-contiguous cotangent: the backward makes it contiguous
    gt = _t(np.ascontiguousarray(g.T)).T
    assert not gt.is_contiguous()
    leaves = (tx0, tw, tb) if alias else (tx0, tx, tw, tb)
    got = torch.autograd.grad(out, leaves, gt)
    assert calls == {"fwd": 1, "bwd": 1}
    if alias:
        f = lambda a, w_, b_: jref.cross_layer_ref(a, a, w_, b_)  # noqa: E731
        _, vjp = jax.vjp(f, *map(jnp.asarray, (x0, w, bias)))
    else:
        _, vjp = jax.vjp(jref.cross_layer_ref, *map(jnp.asarray, (x0, x, w, bias)))
    for a, e in zip(got, vjp(jnp.asarray(g))):
        _close(a.numpy(), e)


def test_cross_net_matches_reference():
    """Three stacked layers with the reference's parameter layout."""
    from repro.layers import interactions as JI

    rng = np.random.default_rng(8)
    d = 45
    p = {f"l{i}": {"w": (rng.normal(size=(d, d)) / np.sqrt(d)).astype(np.float32),
                   "b": rng.normal(size=d).astype(np.float32) * 0.1} for i in range(3)}
    x0 = rng.normal(size=(19, d)).astype(np.float32)
    got = I.cross_net(topt.tree_map(_t, p), _t(x0))
    _close(got.numpy(), JI.cross_net(jax.tree.map(jnp.asarray, p), jnp.asarray(x0)))
    init = I.init_cross(torch.Generator().manual_seed(0), d, 3, torch.device("cpu"))
    assert sorted(init) == ["l0", "l1", "l2"]
    assert all(tuple(v["w"].shape) == (d, d) and tuple(v["b"].shape) == (d,)
               and not v["b"].any() for v in init.values())


def test_cross_forced_on_cpu_tensors_raise():
    x0, x, w, bias, g = map(_t, _cross_case(4, 6, 0))
    with pytest.raises(ValueError, match="CUDA"):
        ops.cross_layer(x0, x, w, bias, fused=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.cross_layer_bwd(x0, x, w, bias, g, fused=True)


def test_cross_wrappers_check_shapes_before_launch(monkeypatch):
    """The CUDA wrappers reject what their kernels do not take before any
    launch (checked here with the device test bypassed)."""
    monkeypatch.setattr(ops, "_launch", lambda *a: pytest.fail("launched"))
    x0, x, w, bias, g = map(_t, _cross_case(4, 6, 0))
    with pytest.raises(ValueError, match="want"):
        ops._cross_layer_cuda(x0, x, w[:5], bias)
    with pytest.raises(ValueError, match="want"):
        ops._cross_layer_cuda(x0[:3], x, w, bias)
    with pytest.raises(ValueError, match="want"):
        ops._cross_layer_bwd_cuda(x0, x, w, bias, g[:, :5].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ops._cross_layer_cuda(x0, x, w.T, bias)
    with pytest.raises(ValueError, match="float32"):
        ops._cross_layer_bwd_cuda(x0, x, w, bias.double(), g)


@pytest.mark.parametrize("b,d", [(1, 16), (16, 29), (65, 67), (256, 429), (512, 429),
                                 (65_536, 429), (65_537, 429), (37, 1)])
def test_cross_plan_tiles_the_contractions(b, d):
    """Each pass's cluster splits its contraction (d for the forward and dx,
    B for dW) into whole 32-wide slabs in rank order, none empty, fixed by
    (B, d) alone."""
    plan = ops.cross_plan(b, d)
    assert plan == ops.cross_plan(b, d)
    for n, c in zip((d, d, b), plan):
        assert c in (1, 2, 4, 8)
        ranges = ops.cross_ranges(n, c)
        assert len(ranges) == c and ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(lo < hi and lo % 32 == 0 for lo, hi in ranges)
        assert all(p[1] == q[0] for p, q in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("b,d", CROSS_SHAPES + [(65, 429)])
def test_cross_3xtf32_arithmetic_matches_reference_and_pallas(b, d):
    """The precision argument of the cross kernels, checked on the CPU: the
    forward and all four cotangents computed in 3xTF32 (``tref``'s
    emulation) in the kernels' split-K order (``ops.cross_plan``) stay
    within 1e-5 of scale of the reference and the Pallas kernels. Largest
    error seen: printed (``-s``)."""
    x0, x, w, bias, g = _cross_case(b, d, 7 * b + d)
    tx0, tx, tw, tb, tg = map(_t, (x0, x, w, bias, g))
    plan = ops.cross_plan(b, d)
    kf, kd, kb = (ops.cross_ranges(n, c) for n, c in zip((d, d, b), plan))
    out = tx0 * (tref.matmul_3xtf32(tx, tw, kf) + tb) + tx
    z = tref.matmul_3xtf32(tx, tw, kd)  # the dx pass recomputes z in its own split
    gz = tg * tx0
    gb = None
    for lo, hi in kb:  # each rank's column sums, then the ranks in order
        part = gz[lo:hi].sum(dim=0)
        gb = part if gb is None else gb + part
    grads = (tg * (z + tb), tref.matmul_3xtf32(gz, tw.T.contiguous(), kd) + tg,
             tref.matmul_3xtf32(tx.T.contiguous(), gz, kb), gb)
    jargs = tuple(map(jnp.asarray, (x0, x, w, bias)))
    worst = 0.0
    for exp in (jref.cross_layer_ref(*jargs), cross_layer_pallas(*jargs, interpret=True)):
        _close(out.numpy(), exp)
        worst = max(worst, float(np.abs(out.numpy() - exp).max()) / _scale(exp))
    for exp in (jref.cross_layer_bwd_ref(*jargs, jnp.asarray(g)),
                cross_layer_bwd_pallas(*jargs, jnp.asarray(g), interpret=True)):
        for a, e in zip(grads, exp):
            _close(a.numpy(), e)
            worst = max(worst, float(np.abs(a.numpy() - np.asarray(e)).max()) / _scale(e))
    if d == 429:  # one tf32 product alone (big_a @ big_b) misses the bar
        big_x, big_w = tref.tf32_split(tx)[0], tref.tf32_split(tw)[0]
        one = tx0 * (big_x @ big_w + tb) + tx
        exp = np.asarray(jref.cross_layer_ref(*jargs))
        assert float(np.abs(one.numpy() - exp).max()) > 1e-5 * _scale(exp)
    print(f"3xTF32 cross (B={b}, d={d}, clusters {plan}): "
          f"largest error {worst:.3g} of scale")


def _smoke_model_pair(b):
    jcfg, cfg = jget_config("dcn-v2", smoke=True), get_config("dcn-v2", smoke=True)
    jplan, plan = jmake_plan(jcfg, 1, b), make_plan(cfg, 1, b)
    return jcfg, cfg, JWDLModel(jcfg, jplan), WDLModel(cfg, plan), jplan, plan


def _converted(mesh, b, seed):
    """A reference dcn-v2-smoke state made on ``mesh`` and carried over by
    ``state_from_jax``: (reference dense params on the host, port emb, port
    dense params, models and the port's plan)."""
    jcfg, cfg, jmodel, model, jplan, plan = _smoke_model_pair(b)
    st = jinit_state(jmodel, jplan, jax.random.PRNGKey(seed), mesh=mesh, axes=AXES)
    dense_np = jax.device_get(st["dense"])
    emb_t, dense_t = state_from_jax(jax.device_get(st["emb"]), dense_np, plan, "cpu")
    return jcfg, cfg, jmodel, model, plan, dense_np, emb_t, dense_t


def test_dcn_config_matches_reference():
    for smoke in (False, True):
        j, t = jget_config("dcn-v2", smoke=smoke), get_config("dcn-v2", smoke=smoke)
        assert (t.name, t.n_dense, t.mlp_dims, t.dense_arch) == \
            (j.name, j.n_dense, j.mlp_dims, j.dense_arch)
        assert [(f.name, f.vocab, f.dim) for f in t.fields] == \
            [(f.name, f.vocab, f.dim) for f in j.fields]
        assert [(i.kind, i.kwargs) for i in t.interactions] == \
            [(i.kind, i.kwargs) for i in j.interactions]
    _, _, jmodel, model, _, _ = _smoke_model_pair(8)
    assert model.base_dim == jmodel._wiring["base_dim"] == 26 * 16 + 13
    assert model.deep_dim == jmodel._wiring["deep_dim"]
    assert model.consumed_base == jmodel._wiring["consumed_base"] is True


def test_dcn_smoke_apply_and_loss_match_reference(mesh1):
    b = 16
    jcfg, cfg, jmodel, model, plan, dense_np, _, dense_t = _converted(mesh1, b, 1)
    g = plan.groups[0]
    rng = np.random.default_rng(2)
    pooled = {g.gid: rng.normal(size=(b, g.n_bags, g.dim)).astype(np.float32)}
    batch = jmake_batch(jcfg, b, rng)
    side = {"labels": _t(batch["labels"]), "dense": dense_features(cfg, batch, "cpu")}
    jl, jlog = jmodel.loss(dense_np, {k: jnp.asarray(v) for k, v in pooled.items()},
                           jax.tree.map(jnp.asarray, batch))
    tp = {k: _t(v) for k, v in pooled.items()}
    tl, tlog = model.loss(dense_t, tp, side)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    logits = model.apply(dense_t, tp, side)
    assert torch.equal(logits, tlog) and logits.shape == (b, 1)


def test_convert_carries_cross_params_unchanged(mesh1):
    _, _, _, model, plan, dense_np, emb_t, dense_t = _converted(mesh1, 8, 3)
    assert tuple(emb_t["0"].w.shape) == (plan.groups[0].rows, 16)
    assert sorted(dense_t) == sorted(dense_np) == ["i0_cross", "top"]
    assert sorted(dense_t["i0_cross"]) == ["l0", "l1", "l2"]
    for i in range(3):
        for k in ("w", "b"):
            np.testing.assert_array_equal(dense_t["i0_cross"][f"l{i}"][k].numpy(),
                                          np.asarray(dense_np["i0_cross"][f"l{i}"][k]))
    # the port's own init has the same layout
    own = model.init_dense(torch.Generator().manual_seed(0), torch.device("cpu"))
    assert jax.tree.structure(jax.tree.map(lambda a: 0, dense_np)) == \
        jax.tree.structure(topt.tree_map(lambda a: 0, own))
    for a, b in zip(topt.tree_leaves(own), jax.tree.leaves(dense_np)):
        assert tuple(a.shape) == tuple(np.shape(b))


def test_unported_dense_side_still_raises():
    """A sequence field (ported with sasrec and mind) leaves the pooled base
    and takes the reference's wiring width; a bottom MLP (``dense_arch``) is
    ported with dlrm and widens the base by its last width, not
    ``n_dense``."""
    cfg = get_config("dcn-v2", smoke=True)
    plan = make_plan(cfg, 1, 8)
    bottom = WDLModel(dataclasses.replace(cfg, dense_arch=(16,)), plan)
    assert bottom.base_dim == 26 * 16 + 16
    f = dataclasses.replace(cfg.fields[0], pooling="none")
    seq = dataclasses.replace(cfg, fields=(f,) + cfg.fields[1:])
    jseq = dataclasses.replace(jget_config("dcn-v2", smoke=True), fields=(
        dataclasses.replace(jget_config("dcn-v2", smoke=True).fields[0], pooling="none"),
    ) + jget_config("dcn-v2", smoke=True).fields[1:])
    model = WDLModel(seq, make_plan(seq, 1, 8))
    jw = JWDLModel(jseq, jmake_plan(jseq, 1, 8))._wiring
    assert (model.base_dim, model.deep_dim) == (jw["base_dim"], jw["deep_dim"]) \
        == (25 * 16 + 13, 25 * 16 + 13)
    assert f.name not in [g.name for g in model.pooled_fields]


def test_dcn_smoke_serve_matches_reference(mesh1):
    check_smoke_serve(mesh1, "dcn-v2")


def test_dcn_smoke_train_trajectory_matches_reference(mesh1):
    check_train_trajectory(mesh1, "dcn-v2", "psum", 2)


@pytest.mark.parametrize("launcher,args,pattern", [
    ("serve", ["--n-requests", "2", "--batch", "16"],
     r"\[serve\] dcn-v2 B=16: p50=[\d.]+ms p99=[\d.]+ms mean_prob=[\d.]+"),
    ("train", ["--steps", "2", "--global-batch", "16", "--log-every", "1"],
     r"^  step +2 loss=[\d.]+ hits=\d+ ovf=\d+$"),
])
def test_launchers_run_dcn_smoke_on_cpu(launcher, args, pattern):
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{launcher}", "--arch", "dcn-v2",
         "--smoke", "--device", "cpu", *args],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert re.search(pattern, out.stdout, re.M), out.stdout
