"""The port's SchNet and its graph data against the reference on the CPU:
every array of ``data/graph.py``, the rbf centers, the shifted softplus,
the weights drawn from a ``JaxKey``, ``schnet_forward`` and ``schnet_loss``
on features and on species ids, per node and per graph, their gradients,
and three steps of ``make_schnet_step``.

Every case runs the same numpy inputs, made from a seed, through the
reference's function and the port's. Bars:

* graph arrays, the rbf centers (``jnp.linspace``) bitwise;
* the shifted softplus within 2 float32 ulps of each value plus 2^-24 of
  the largest (it takes ``jax.nn.softplus``'s formula, ``logaddexp(x, 0)``,
  whose ``exp`` and ``log1p`` differ from XLA's in the last bit; measured
  over 100,001 points in [-30, 30]: 1,299 values differ, by at most 4.8e-7,
  where the shift by log 2 leaves a value near 0; ``F.softplus`` differs
  in 3,073); its gradient is the reference's ``exp(x - softplus(x))``,
  0.5 at 0 exactly;
* weights from a ``JaxKey`` within 2e-6, carried over bitwise;
* energies and losses within 1e-5 (the loss relative; measured 2.4e-7),
  gradients within 1e-5 of each leaf's largest entry (measured: at most
  2.6e-6);
* three training steps: each loss within rtol 1e-5, parameters and Adam
  moments within atol 1e-4 (the bars of ``tests/test_torch_train.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import graph as JG
from repro.launch import cells as jcells
from repro.models import schnet as JS
from repro.optim import optimizers as jopt
from repro_torch.configs import get_config
from repro_torch.convert import opt_state_from_jax, schnet_params_from_jax
from repro_torch.core.jax_random import prng_key
from repro_torch.data import graph as TG
from repro_torch.dist.compat import Group
from repro_torch.launch import cells as tcells
from repro_torch.models import schnet as TS
from repro_torch.optim import optimizers as topt

from test_torch_lm import TOL, _err, _np

torch.set_num_threads(1)

def _assert_same_arrays(got: dict, ref: dict) -> None:
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# ---------------------------------------------------------------------------
# graph data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_feat", [True, False])
def test_synthetic_graph_is_bitwise_reference(with_feat):
    _assert_same_arrays(TG.synthetic_graph(300, 2000, 7, seed=3, with_feat=with_feat),
                        JG.synthetic_graph(300, 2000, 7, seed=3, with_feat=with_feat))


@pytest.mark.parametrize("max_nodes,max_edges", [(4000, 6000), (50, 80)])
def test_sampled_and_padded_subgraph_is_bitwise_reference(max_nodes, max_edges):
    """Fanout sampling over the CSR, then padding (room to spare, and cut)."""
    g = JG.synthetic_graph(500, 6000, 0, seed=1, with_feat=False)
    seeds = np.random.default_rng(2).choice(500, 32, replace=False)
    ref = JG.sample_neighbors(g, seeds, (5, 3), np.random.default_rng(4))
    got = TG.sample_neighbors(g, seeds, (5, 3), np.random.default_rng(4))
    _assert_same_arrays(got, ref)
    _assert_same_arrays(TG.pad_subgraph(got, g, max_nodes, max_edges),
                        JG.pad_subgraph(ref, g, max_nodes, max_edges))


def test_molecule_batch_is_bitwise_reference():
    _assert_same_arrays(TG.molecule_batch(16, 30, 64, seed=5),
                        JG.molecule_batch(16, 30, 64, seed=5))


# ---------------------------------------------------------------------------
# the model's pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_rbf,cutoff", [(300, 10.0), (8, 5.0), (64, 7.3), (2, 1.0),
                                          (1, 3.0)])
def test_rbf_centers_are_bitwise_linspace(n_rbf, cutoff):
    ref = np.asarray(jnp.linspace(0.0, cutoff, n_rbf))
    got = TS.rbf_centers(n_rbf, cutoff)
    assert got.dtype == np.float32 and ref.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    dist = np.random.default_rng(0).uniform(0.5, 9.5, 50).astype(np.float32)
    assert _err(_np(TS.rbf_expand(torch.from_numpy(dist), n_rbf, cutoff)),
                JS.rbf_expand(jnp.asarray(dist), n_rbf, cutoff)) <= 1e-6


def test_ssp_matches_reference():
    x = np.linspace(-30, 30, 100_001).astype(np.float32)
    ref = np.asarray(JS.ssp(jnp.asarray(x)))
    got = _np(TS.ssp(torch.from_numpy(x)))
    ulp = np.spacing(np.abs(ref).astype(np.float32))
    assert np.all(np.abs(got - ref) <= 2 * ulp + np.abs(ref).max() * 2.0 ** -24)


def test_ssp_gradient_is_the_reference_s():
    """At 0 exactly (a zero bias on a node with no incoming edge) autograd of
    the formula would give 1; the reference's JVP gives 0.5."""
    x = np.array([0.0, -0.0, 1e-30, -3.0, 2.5, 40.0, -60.0], np.float32)
    ref = np.asarray(jax.vmap(jax.grad(JS.ssp))(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    got = torch.autograd.grad(TS.ssp(t).sum(), t)[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    assert got[0] == 0.5


@pytest.mark.parametrize("d_feat", [0, 16])
def test_init_from_jax_key_matches_reference(d_feat):
    cfg, jcfg = get_config("schnet", smoke=True), jget_config("schnet", smoke=True)
    jp = jax.device_get(JS.init_schnet(jcfg, jax.random.PRNGKey(0), d_feat=d_feat))
    tp = TS.init_schnet(cfg, prng_key(0), "cpu", d_feat=d_feat)
    conv = schnet_params_from_jax(jp, "cpu")
    jl, tl, cl = jax.tree.leaves(jp), topt.tree_leaves(tp), topt.tree_leaves(conv)
    assert len(tl) == len(jl) == len(cl)
    for a, b, c in zip(tl, jl, cl):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert float(np.abs(_np(a) - b).max()) <= 2e-6
        np.testing.assert_array_equal(_np(c), b)


# ---------------------------------------------------------------------------
# forward, loss, gradients, steps
# ---------------------------------------------------------------------------


def _batches():
    """Per-node regression on node features (a full graph with ``node_w``),
    on species ids (a padded sampled subgraph), and per graph (molecules)."""
    g = JG.synthetic_graph(120, 500, 16, seed=0)
    full = {k: g[k] for k in ("nodes", "src", "dst", "dist", "target")}
    full["edge_w"] = np.ones(500, np.float32)
    full["node_w"] = (np.random.default_rng(1).random(120) < 0.5).astype(np.float32)
    gs = JG.synthetic_graph(200, 1500, 0, seed=2, with_feat=False)
    sub = JG.sample_neighbors(gs, np.arange(0, 200, 9), (4, 3), np.random.default_rng(3))
    return {"features": (16, full),
            "species": (0, JG.pad_subgraph(sub, gs, 160, 200)),
            "molecules": (0, JG.molecule_batch(8, 10, 24, seed=4))}


BATCHES = _batches()


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in batch.items()}


def _params(d_feat):
    jcfg = jget_config("schnet", smoke=True)
    jp = jax.device_get(JS.init_schnet(jcfg, jax.random.PRNGKey(7), d_feat=d_feat))
    return jp, schnet_params_from_jax(jp, "cpu")


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_forward_loss_and_gradients_match_reference(name):
    cfg, jcfg = get_config("schnet", smoke=True), jget_config("schnet", smoke=True)
    d_feat, batch = BATCHES[name]
    jp, tp = _params(d_feat)
    jb, tb = _jb(batch), _tb(batch)
    ref = JS.schnet_forward(jcfg, jp, jb["nodes"], jb["src"], jb["dst"], jb["dist"],
                            jb["edge_w"])
    got = TS.schnet_forward(cfg, tp, tb["nodes"], tb["src"], tb["dst"], tb["dist"],
                            tb["edge_w"])
    assert _err(_np(got), ref) <= TOL
    lj, gj = jax.value_and_grad(lambda p: JS.schnet_loss(jcfg, p, jb))(jp)
    leaves = [p.detach().requires_grad_(True) for p in topt.tree_leaves(tp)]
    lt = TS.schnet_loss(cfg, topt.tree_unflatten(tp, leaves), tb)
    assert abs(float(lt.detach()) - float(lj)) <= TOL * abs(float(lj))
    for a, b in zip(torch.autograd.grad(lt, leaves), jax.tree.leaves(gj)):
        assert _err(_np(a), b) <= TOL


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_schnet_step_matches_reference(name, mesh1):
    """Three steps of ``make_schnet_step`` (lr 1e-3) against the reference's
    jitted step on a 1x1 mesh, from the same weights."""
    cfg, jcfg = get_config("schnet", smoke=True), jget_config("schnet", smoke=True)
    d_feat, batch = BATCHES[name]
    jp, tp = _params(d_feat)
    fn, *_ = jcells.make_schnet_step(jcfg, mesh1, d_feat, name == "molecules")
    jstate = (jax.tree.map(jnp.array, jp), jopt.adam_init(jax.tree.map(jnp.array, jp)))
    step = tcells.make_schnet_step(cfg)
    opt = topt.adam_init(tp)
    for _ in range(3):
        jpp, jo, jl = fn(*jstate, _jb(batch))
        jstate = (jpp, jo)
        tp, opt, tl = step(tp, opt, _tb(batch))
        assert abs(float(tl) - float(jl)) <= TOL * abs(float(jl))
    ref_opt = opt_state_from_jax(jax.device_get(jstate[1]), "cpu")
    assert int(opt["t"]) == int(ref_opt["t"]) == 3
    for got, ref in ((tp, schnet_params_from_jax(jax.device_get(jstate[0]), "cpu")),
                     (opt["m"], ref_opt["m"]), (opt["v"], ref_opt["v"])):
        for a, b in zip(topt.tree_leaves(got), topt.tree_leaves(ref)):
            np.testing.assert_allclose(_np(a), _np(b), atol=1e-4, rtol=0)


def test_schnet_is_world_1():
    """A group of world 1 is the world-1 path bitwise; past world 1 each rank
    takes its block of the edge arrays, padded by zero-weight edges, and
    the node arrays whole (``tests/test_torch_dist_gnn.py`` runs the step on
    4 ranks)."""
    cfg = get_config("schnet", smoke=True)
    _, batch = BATCHES["molecules"]
    _, tp = _params(0)
    loss1 = TS.schnet_loss(cfg, tp, _tb(batch), group=Group(0, 1, None, "none"))
    assert torch.equal(loss1, TS.schnet_loss(cfg, tp, _tb(batch)))
    tb = _tb(batch)
    e = tb["src"].shape[0]
    blocks = [tcells.edge_block(tb, Group(r, 5, None, "gloo")) for r in range(5)]
    n = -(-e // 5)
    for k in tcells.EDGE_KEYS:
        whole = torch.cat([b[k] for b in blocks])
        assert whole.shape[0] == 5 * n
        assert torch.equal(whole[:e], tb[k]) and not whole[e:].any()
    for k in set(tb) - set(tcells.EDGE_KEYS):
        assert all(b[k] is tb[k] for b in blocks)
    assert tcells.edge_block(tb, Group(0, 1, None, "none")) is tb
