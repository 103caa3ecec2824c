"""The LM train step past world 1 on the CPU: 4 gloo ranks against the
reference on 4 forced host devices, from the same weights and tokens, for
stablelm-smoke (MHA) at meshes 2x2, 1x4 and 4x1, under ``shard_mode``
``'fsdp'`` and ``'zero1'``, and the parameter layout. The same harness
runs mistral-nemo-smoke (GQA: its K/V columns split mid-head at 1x4) in
``tests/test_torch_dist_lm_gqa.py`` and mixtral-smoke's MoE with
``moe_shard`` off and on in ``tests/test_torch_dist_lm_moe.py`` (one file
each, so each runs in under a minute alone).

The reference jits ``repro.launch.cells.make_lm_train_step`` on the mesh
(GSPMD partitions it by ``lm_param_specs``); the port's ranks run
``repro_torch.launch.cells.make_lm_train_step(group=, mesh_shape=)`` on
their shards (``convert.lm_params_from_jax(rank=, mesh_shape=, specs=)``)
and gather them for the checks (``transformer.gather_params``). Both sides
run once for the module, side by side.

Bars (``tests/test_torch_lm_train.py``'s): three steps of tokens
``[8, 32]`` with chunks of 8, each loss within rtol 1e-5, the parameters
and Adam moments within atol 1e-4; every rank's loss equal.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.layers import transformer as JT
from repro_torch import dist as rdist
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax, opt_state_from_jax
from repro_torch.launch import cells as tcells
from repro_torch.layers import transformer as TT
from repro_torch.optim import optimizers as topt

from test_torch_dist import W, run_port, start_reference
from test_torch_lm import TOL, _np

torch.set_num_threads(1)

STEPS = 3
MESHES = ((2, 2), (1, 4), (4, 1))
MODES = ("fsdp", "zero1")
ARCHS = ("stablelm-1.6b",)
CASES = [(a, m, mode, False) for a in ARCHS for m in MESHES for mode in MODES]


def case_id(case) -> str:
    arch, mesh, mode, moe = case
    return f"{arch}-{mesh[0]}x{mesh[1]}-{mode}" + ("-moe_shard" if moe else "")


def lm_inputs(archs):
    """One draw of weights an arch (the reference's ``init_lm_params``,
    PRNGKey(0)) and the tokens of each step."""
    out = {}
    for arch in archs:
        cfg = jget_config(arch, smoke=True)
        params = jax.device_get(JT.init_lm_params(cfg, jax.random.PRNGKey(0)))
        toks = [np.random.default_rng(10 + i).integers(0, cfg.vocab, (8, 32)).astype(np.int32)
                for i in range(STEPS)]
        out[arch] = (params, toks)
    return out


REF_BODY = """
from repro.configs import get_config
from repro.launch import cells as JC
from repro.launch.mesh import make_test_mesh
from repro.optim.optimizers import adam_init
weights, cases = inp
for arch, mesh_shape, mode, moe in cases:
    cfg = get_config(arch, smoke=True)
    params0, toks = weights[arch]
    m = make_test_mesh(*mesh_shape)
    fn, *_ = JC.make_lm_train_step(cfg, m, attn_chunk=8, loss_chunk=8, shard_mode=mode,
                                   moe_shard=moe)
    p = jax.tree.map(jnp.asarray, params0)
    state = (p, adam_init(jax.tree.map(jnp.asarray, params0)))
    losses = []
    for t in toks:
        p2, o2, l = fn(*state, jnp.asarray(t))
        state = (p2, o2)
        losses.append(float(l))
    out[(arch, mesh_shape, mode, moe)] = jax.device_get(
        {"losses": losses, "params": state[0], "opt": state[1]})
"""


def port_rank(group, weights, cases):
    out = {}
    for arch, mesh, mode, moe in cases:
        cfg = get_config(arch, smoke=True)
        params0, toks = weights[arch]
        mshape = dict(zip(("data", "model"), mesh))
        pspecs = TT.lm_param_specs(cfg, mshape, fsdp=mode == "fsdp")
        mspecs = tcells.moment_specs(cfg, mesh)
        params = lm_params_from_jax(params0, "cpu", rank=group.rank, mesh_shape=mesh,
                                    specs=pspecs)
        opt = topt.adam_init(lm_params_from_jax(params0, "cpu", rank=group.rank,
                                                mesh_shape=mesh, specs=mspecs))
        step = tcells.make_lm_train_step(cfg, attn_chunk=8, loss_chunk=8, group=group,
                                         mesh_shape=mesh, shard_mode=mode, moe_shard=moe)
        losses = []
        for t in toks:
            params, opt, loss = step(params, opt, torch.from_numpy(t).long())
            losses.append(float(loss))
        axes = rdist.axis_groups(group, mesh)
        whole = [TT.gather_params(params, pspecs, axes),
                 TT.gather_params(opt["m"], mspecs, axes),
                 TT.gather_params(opt["v"], mspecs, axes)]
        out[(arch, mesh, mode, moe)] = {
            "losses": losses, "t": int(opt["t"]),
            "whole": [[_np(x) for x in topt.tree_leaves(tree)] for tree in whole]
            if group.rank == 0 else None}
    return out


def run_both(tmp, archs, cases):
    weights = lm_inputs(archs)
    collect = start_reference(REF_BODY, (weights, cases), tmp)
    try:
        port = run_port(port_rank, weights, cases, tmp=tmp)
    finally:
        ref = collect()
    return ref, port


def check_case(ref, port, case):
    r = ref[case]
    for rank in range(W):
        np.testing.assert_allclose(port[rank][case]["losses"], r["losses"], rtol=TOL)
        assert port[rank][case]["losses"] == port[0][case]["losses"]
        assert port[rank][case]["t"] == STEPS
    ropt = opt_state_from_jax(r["opt"], "cpu")
    assert int(ropt["t"]) == STEPS
    got_p, got_m, got_v = port[0][case]["whole"]
    for got, exp in ((got_p, lm_params_from_jax(r["params"], "cpu")), (got_m, ropt["m"]),
                     (got_v, ropt["v"])):
        exp = topt.tree_leaves(exp)
        assert len(got) == len(exp)
        for a, b in zip(got, exp):
            np.testing.assert_allclose(a, _np(b), atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("dist_lm"), ARCHS, CASES)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_lm_train_step_matches_reference(both, case):
    check_case(*both, case)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mistral-nemo-12b", "yi-34b",
                                  "phi3.5-moe-42b-a6.6b", "mixtral-8x22b"])
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", MESHES + ((8, 4), (3, 5)))
def test_param_specs_equal_reference(arch, fsdp, mesh):
    """``lm_param_specs`` leaf for leaf the reference's, its ``("data",)``
    tuples written ``"data"``, at smoke and full widths."""
    mshape = dict(zip(("data", "model"), mesh))
    for a in (arch,):
        for smoke in (True, False):
            ref = JT.lm_param_specs(jget_config(a, smoke=smoke), mshape, fsdp=fsdp)
            got = TT.lm_param_specs(get_config(a, smoke=smoke), mshape, fsdp=fsdp)
            flat = jax.tree.leaves(ref, is_leaf=lambda x: isinstance(x, P))
            norm = [tuple("data" if e == ("data",) else e for e in s) for s in flat]
            assert norm == topt.tree_leaves(got)


def test_shard_params_tiles_every_leaf():
    """The ranks' blocks (``shard_params``) put back at their mesh
    coordinates rebuild every leaf."""
    cfg = get_config("mistral-nemo-12b", smoke=True)
    p = TT.init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for mesh in MESHES:
        specs = TT.lm_param_specs(cfg, dict(zip(("data", "model"), mesh)))
        cuts = [topt.tree_leaves(TT.shard_params(p, specs, mesh, r)) for r in range(W)]
        for i, (leaf, spec) in enumerate(zip(topt.tree_leaves(p), topt.tree_leaves(specs))):
            rebuilt = torch.full_like(leaf, float("nan"))
            for r in range(W):
                coord = {"data": r // mesh[1], "model": r % mesh[1]}
                idx = tuple(slice(None) if ax is None else
                            slice(coord[ax] * (leaf.shape[d] // n),
                                  (coord[ax] + 1) * (leaf.shape[d] // n))
                            for d, (ax, n) in enumerate(
                                (ax, {"data": mesh[0], "model": mesh[1]}.get(ax, 1))
                                for ax in spec))
                rebuilt[idx] = cuts[r][i]
            assert torch.equal(rebuilt, leaf)
