"""SchNet past world 1 on the CPU: 4 gloo ranks against the reference on 4
forced host devices (mesh 2x2), from the same weights and batches.

The reference shards the edge arrays over the whole mesh inside
``shard_map(check_vma=False)`` and psums each interaction's partial node
sum; its step pmeans the gradients and the loss (``repro.launch.cells.
make_schnet_step``). The port's ranks each take their block of the edge
arrays (padded with zero-weight edges to a multiple of 4, which the
reference gets padded alike) and psum with a psum backward
(``dist.spmd.psum_psum``), so the pmean'd gradient is the world-1 one.
Both sides run once for the module, side by side; the tests read their
results (the pattern of ``tests/test_torch_dist.py``).

Bars: energies, losses and gradients within 1e-5 (the loss relative, the
others of each leaf's largest entry); three ``make_schnet_step`` steps at
the bars of ``tests/test_torch_train.py`` (losses rtol 1e-5, parameters and
Adam moments atol 1e-4); every rank's results equal; the port's world-4
gradients within 1e-5 of its world-1 ones.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import graph as JG
from repro.models import schnet as JS
from repro_torch import dist as rdist
from repro_torch.configs import get_config
from repro_torch.convert import opt_state_from_jax, schnet_params_from_jax
from repro_torch.launch import cells as tcells
from repro_torch.models import schnet as TS
from repro_torch.optim import optimizers as topt

from test_torch_dist import W, run_port, start_reference
from test_torch_lm import TOL, _err

torch.set_num_threads(1)

STEPS = 3
MESH = (2, 2)


def _batches():
    g = JG.synthetic_graph(120, 501, 16, seed=0)      # 501 edges: 3 padding edges
    full = {k: g[k] for k in ("nodes", "src", "dst", "dist", "target")}
    full["edge_w"] = np.ones(501, np.float32)
    full["node_w"] = (np.random.default_rng(1).random(120) < 0.5).astype(np.float32)
    return {"features": (16, full),
            "molecules": (0, JG.molecule_batch(8, 10, 16, seed=4)),
            "molecules_pad": (0, JG.molecule_batch(5, 10, 17, seed=5))}


BATCHES = _batches()


def _padded(batch):
    """The batch with its edges padded as ``tcells.pad_edges`` pads them."""
    t = {k: torch.from_numpy(np.array(v, copy=True)) for k, v in batch.items()}
    return {k: v.numpy() for k, v in tcells.pad_edges(t, W).items()}


REF_BODY = """
from repro.configs import get_config
from repro.launch import cells as JC
from repro.models import schnet as JS
from repro.optim.optimizers import adam_init
cfg = get_config("schnet", smoke=True)
EDGES = ("src", "dst", "dist", "edge_w")
for name, (batch, params0) in inp.items():
    params = jax.tree.map(jnp.asarray, params0)
    d_feat = batch["nodes"].shape[1] if batch["nodes"].ndim == 2 else 0
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    bspec = {k: (P(AXES) if k in EDGES else P()) for k in b}

    def grads(p, b):
        e = JS.schnet_forward(cfg, p, b["nodes"], b["src"], b["dst"], b["dist"],
                              b["edge_w"], axes=AXES)
        loss, g = jax.value_and_grad(lambda q: JS.schnet_loss(cfg, q, b, axes=AXES))(p)
        return e, lax.pmean(loss, AXES), lax.pmean(g, AXES)

    f = jax.jit(shard_map(grads, mesh=mesh, in_specs=(P(), bspec), out_specs=(P(), P(), P()),
                          check_vma=False))
    e, loss, g = f(params, b)
    fn, *_ = JC.make_schnet_step(cfg, mesh, d_feat, name.startswith("molecules"))
    state = (jax.tree.map(jnp.array, params), adam_init(jax.tree.map(jnp.array, params)))
    losses = []
    for _ in range(STEPS):
        p2, o2, l = fn(*state, b)
        state = (p2, o2)
        losses.append(float(l))
    out[name] = jax.device_get({"energy": e, "loss": loss, "grads": g, "losses": losses,
                                "params": state[0], "opt": state[1]})
"""


def _port_rank(group, inputs):
    cfg = get_config("schnet", smoke=True)
    out = {}
    for name, (batch, params0) in inputs.items():
        tb = {k: torch.from_numpy(np.array(v, copy=True)) for k, v in batch.items()}
        p = schnet_params_from_jax(params0, "cpu", rank=group.rank, mesh_shape=MESH)
        blk = tcells.edge_block(tb, group)
        e = TS.schnet_forward(cfg, p, blk["nodes"], blk["src"], blk["dst"], blk["dist"],
                              blk["edge_w"], group=group)
        loss, g = tcells.value_and_grad(
            lambda q, b: TS.schnet_loss(cfg, q, tcells.edge_block(b, group), group=group))(p, tb)
        g = topt.tree_map(lambda x: rdist.psum(x, group) / group.world, g)
        loss = rdist.psum(loss, group) / group.world
        step = tcells.make_schnet_step(cfg, group=group)
        opt = topt.adam_init(p)
        losses = []
        for _ in range(STEPS):
            p, opt, lt = step(p, opt, tb)
            losses.append(float(lt))
        out[name] = {"energy": e.detach().numpy(), "loss": float(loss),
                     "grads": [x.numpy() for x in topt.tree_leaves(g)], "losses": losses,
                     "params": [x.numpy() for x in topt.tree_leaves(p)],
                     "m": [x.numpy() for x in topt.tree_leaves(opt["m"])],
                     "v": [x.numpy() for x in topt.tree_leaves(opt["v"])],
                     "t": int(opt["t"])}
    return out


def _params0(d_feat):
    jcfg = jget_config("schnet", smoke=True)
    return jax.device_get(JS.init_schnet(jcfg, jax.random.PRNGKey(7), d_feat=d_feat))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reference in a subprocess and the port's 4 ranks, run side by
    side from one draw of weights on the padded batches."""
    tmp = tmp_path_factory.mktemp("dist_gnn")
    inputs = {n: (_padded(b), _params0(d)) for n, (d, b) in BATCHES.items()}
    collect = start_reference(REF_BODY, inputs, tmp, STEPS=STEPS)
    try:
        port = run_port(_port_rank, inputs, tmp=tmp)
    finally:
        ref = collect()
    return inputs, ref, port


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_energies_loss_and_gradients_match_reference(both, name):
    _, ref, port = both
    r = ref[name]
    for rank in range(W):
        got = port[rank][name]
        assert _err(got["energy"], r["energy"]) <= TOL
        assert abs(got["loss"] - float(r["loss"])) <= TOL * abs(float(r["loss"]))
        gl = topt.tree_leaves(schnet_params_from_jax(r["grads"], "cpu"))
        assert len(gl) == len(got["grads"])
        for a, b in zip(got["grads"], gl):
            assert _err(a, b.numpy()) <= TOL
        np.testing.assert_array_equal(got["energy"], port[0][name]["energy"])
        for a, b in zip(got["grads"], port[0][name]["grads"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_schnet_step_matches_reference(both, name):
    """Three steps of ``make_schnet_step`` at world 4 against the
    reference's jitted step on mesh 2x2."""
    _, ref, port = both
    r = ref[name]
    ropt = opt_state_from_jax(r["opt"], "cpu")
    rp = topt.tree_leaves(schnet_params_from_jax(r["params"], "cpu"))
    for rank in range(W):
        got = port[rank][name]
        np.testing.assert_allclose(got["losses"], r["losses"], rtol=TOL)
        assert got["t"] == int(ropt["t"]) == STEPS
        for mine, theirs in ((got["params"], rp), (got["m"], topt.tree_leaves(ropt["m"])),
                             (got["v"], topt.tree_leaves(ropt["v"]))):
            for a, b in zip(mine, theirs):
                np.testing.assert_allclose(a, b.numpy(), atol=1e-4, rtol=0)
        for a, b in zip(got["params"], port[0][name]["params"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_world4_gradient_is_the_world1_gradient(both, name):
    """The psum's psum backward and the step's pmean give the port's own
    world-1 gradient on the unpadded batch."""
    inputs, _, port = both
    cfg = get_config("schnet", smoke=True)
    _, batch = BATCHES[name]
    tb = {k: torch.from_numpy(np.array(v, copy=True)) for k, v in batch.items()}
    p = schnet_params_from_jax(inputs[name][1], "cpu")
    loss, g = tcells.value_and_grad(lambda q, b: TS.schnet_loss(cfg, q, b))(p, tb)
    assert abs(port[0][name]["loss"] - float(loss)) <= TOL * abs(float(loss))
    for a, b in zip(port[0][name]["grads"], topt.tree_leaves(g)):
        assert _err(a, b.numpy()) <= TOL
