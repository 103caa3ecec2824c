"""The port's LM family against the reference on the CPU, part 3: the
gradients of ``lm_loss`` and three steps of ``make_lm_train_step`` against
the reference's jitted step on a 1x1 mesh, from the same weights; the
step's mesh checks.

Bars:

* gradients within 1e-5 of each leaf's largest entry (measured 1.6e-6);
* three training steps: each loss within rtol 1e-5, parameters and Adam
  moments within atol 1e-4 (the bars of ``tests/test_torch_train.py``;
  measured 1.8e-5 of a leaf's largest entry: Adam's first steps follow the
  rounding of gradients near ``eps``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import cells as jcells
from repro.layers import transformer as JT
from repro.optim import optimizers as jopt
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax, opt_state_from_jax
from repro_torch.dist.compat import Group
from repro_torch.launch import cells as tcells
from repro_torch.layers import transformer as TT
from repro_torch.optim import optimizers as topt

from test_torch_lm import SMOKE_LMS, TOL, _cfgs, _err, _jax_params, _np, _t, _tokens

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", SMOKE_LMS)
def test_lm_loss_gradients_match_reference(arch):
    jc, tc = _cfgs(arch)
    jp = _jax_params(jc)
    toks = _tokens(jc, seed=3)
    gj = jax.grad(lambda p: JT.lm_loss(jc, p, jnp.asarray(toks), attn_chunk=8,
                                       loss_chunk=8))(jp)
    leaves = [p.detach().requires_grad_(True)
              for p in topt.tree_leaves(lm_params_from_jax(jp, "cpu"))]
    loss = TT.lm_loss(tc, topt.tree_unflatten(jp, leaves), _t(toks).long(), attn_chunk=8,
                      loss_chunk=8)
    gt = torch.autograd.grad(loss, leaves)
    for a, b in zip(gt, jax.tree.leaves(gj)):
        assert _err(_np(a), b) <= TOL


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mixtral-8x22b"])
def test_lm_train_step_matches_reference(arch, mesh1):
    """Three steps of ``make_lm_train_step`` (lr 1e-4, chunks of 8) against
    the reference's jitted step on a 1x1 mesh, from the same weights."""
    jc, tc = _cfgs(arch)
    jp = _jax_params(jc)
    fn, *_ = jcells.make_lm_train_step(jc, mesh1, attn_chunk=8, loss_chunk=8)
    jstate = (jax.tree.map(jnp.array, jp), jopt.adam_init(jax.tree.map(jnp.array, jp)))
    step = tcells.make_lm_train_step(tc, attn_chunk=8, loss_chunk=8)
    tp = lm_params_from_jax(jp, "cpu")
    topt_state = topt.adam_init(tp)
    for i in range(3):
        toks = _tokens(jc, seed=10 + i)
        jpp, jo, jl = fn(*jstate, jnp.asarray(toks))
        jstate = (jpp, jo)
        tp, topt_state, tl = step(tp, topt_state, _t(toks).long())
        assert abs(float(tl) - float(jl)) <= TOL * abs(float(jl))
    ref_opt = opt_state_from_jax(jax.device_get(jstate[1]), "cpu")
    assert int(topt_state["t"]) == int(ref_opt["t"]) == 3
    for got, ref in ((tp, lm_params_from_jax(jax.device_get(jstate[0]), "cpu")),
                     (topt_state["m"], ref_opt["m"]), (topt_state["v"], ref_opt["v"])):
        for a, b in zip(topt.tree_leaves(got), topt.tree_leaves(ref)):
            np.testing.assert_allclose(_np(a), _np(b), atol=1e-4, rtol=0)


def test_lm_train_step_is_world_1():
    """A group of world 1 gives the world-1 step (its mesh 1x1); past world 1
    the step needs a mesh of the group's world and a known shard mode
    (``tests/test_torch_dist_lm.py`` runs it on 4 ranks)."""
    cfg = get_config("stablelm-1.6b", smoke=True)
    four = Group(0, 4, None, "gloo")
    with pytest.raises(ValueError, match="mesh"):
        tcells.make_lm_train_step(cfg, group=four, mesh_shape=(3, 1))
    with pytest.raises(ValueError, match="shard_mode"):
        tcells.make_lm_train_step(cfg, group=four, mesh_shape=(2, 2), shard_mode="zero3")
    tcells.make_lm_train_step(cfg, group=Group(0, 1, None, "none"), mesh_shape=(1, 1))
