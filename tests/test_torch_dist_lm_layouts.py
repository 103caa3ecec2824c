"""Tensor-parallel layouts that no registered config takes, and the
prefill cell's ``moe_shard``, past world 1 on the CPU: 4 gloo ranks against
the reference on 4 forced host devices, at meshes 2x2 and 1x4.

The configs are the smoke configs changed by ``dataclasses.replace`` on
both sides (``LAYOUTS``):

* ``tied``: stablelm-smoke with ``tie_embeddings`` (the head is the
  vocab-parallel ``emb.T``);
* ``wo_replicated``: mistral-nemo-smoke with 3 heads of 22, so ``H * hd =
  66`` does not split over 4 model ranks: at 1x4 the attention runs whole
  on every rank; at 2x2 the query heads and the K/V heads split mid-way;
* ``kv_replicated``: 4 query heads of 22 and one K/V head: at 1x4 its 22
  columns stay replicated beside query heads split whole; at 2x2 they are
  gathered over ``"model"``.

For each config and mesh: one ``make_lm_train_step`` step (``'fsdp'``,
tokens ``[8, 16]``, chunks of 8) against the reference's jitted step, and
the prefill and decode cells' steps (``build_lm_cell``, its
``get_config`` given these configs) on one numpy draw: prefill of
``[4, 32]``, then two decode steps from a numpy cache of 48 positions.
mixtral-smoke's prefill with ``moe_shard`` at 2x2 is held against
``build_lm_cell(lm_kw={"moe_shard": True})``.

Bars: ``tests/test_torch_dist_lm.py``'s for the step (loss rtol 1e-5,
parameters atol 1e-4), ``tests/test_torch_dist_lm_serve.py``'s for the
logits and caches (1e-5 of the reference's largest entry).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.layers import transformer as JT
from repro_torch import dist as rdist
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import cells as tcells
from repro_torch.layers import transformer as TT
from repro_torch.optim import optimizers as topt

from test_torch_dist import W, run_port, start_reference
from test_torch_dist_lm_serve import block, within
from test_torch_lm import TOL, _np

torch.set_num_threads(1)

B, S, SEQ = 4, 32, 48
LENGTHS = (S, S + 1)
LAYOUTS = {"tied": ("stablelm-1.6b", dict(tie_embeddings=True)),
           "wo_replicated": ("mistral-nemo-12b", dict(d_model=66, n_heads=3, n_kv_heads=3)),
           "kv_replicated": ("mistral-nemo-12b", dict(d_model=88, n_heads=4, n_kv_heads=1))}
MESHES = ((2, 2), (1, 4))
CASES = [(n, m) for n in LAYOUTS for m in MESHES]
MOE_CASE = ("mixtral-8x22b", (2, 2))


def case_id(case) -> str:
    return f"{case[0]}-{case[1][0]}x{case[1][1]}"


def _cfg(get, name):
    if name in LAYOUTS:
        arch, kw = LAYOUTS[name]
        return dataclasses.replace(get(arch, smoke=True), **kw)
    return get(name, smoke=True)


def _inputs():
    """One draw a config: the reference's weights (PRNGKey(4)), train and
    prefill tokens, decode tokens and a cache of ``SEQ`` positions."""
    out = {}
    for name in list(LAYOUTS) + [MOE_CASE[0]]:
        cfg = _cfg(jget_config, name)
        params = jax.device_get(JT.init_lm_params(cfg, jax.random.PRNGKey(4)))
        rng = np.random.default_rng(6)
        sh = (cfg.n_layers, B, SEQ, cfg.n_kv_heads, cfg.head_dim)
        out[name] = {"params": params,
                     "train": rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32),
                     "prefill": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
                     "dec": [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
                             for _ in LENGTHS],
                     "k": rng.standard_normal(sh).astype(np.float32),
                     "v": rng.standard_normal(sh).astype(np.float32)}
    return out


REF_BODY = """
import dataclasses
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.launch import cells as JC
from repro.launch.mesh import make_test_mesh
from repro.layers.transformer import KVCache
from repro.optim.optimizers import adam_init
weights, cases, moe_case = inp
def cfg_of(name):
    if name in LAYOUTS:
        arch, kw = LAYOUTS[name]
        return dataclasses.replace(get_config(arch, smoke=True), **kw)
    return get_config(name, smoke=True)
JC.get_config = lambda name, smoke=False: cfg_of(name)
def prefill(name, m, lm_kw=None):
    w = weights[name]
    cell = JC.build_lm_cell(name, ShapeSpec("p", "prefill", {"seq_len": S, "global_batch": B}),
                            m, smoke=True, lm_kw=lm_kw)
    logits, cache = cell.fn(jax.tree.map(jnp.asarray, w["params"]), jnp.asarray(w["prefill"]))
    return {"logits": np.asarray(logits), "k": np.asarray(cache.k), "v": np.asarray(cache.v)}
for name, mesh_shape in cases:
    w = weights[name]
    m = make_test_mesh(*mesh_shape)
    fn, *_ = JC.make_lm_train_step(cfg_of(name), m, attn_chunk=8, loss_chunk=8)
    p2, _, loss = fn(jax.tree.map(jnp.asarray, w["params"]),
                     adam_init(jax.tree.map(jnp.asarray, w["params"])), jnp.asarray(w["train"]))
    res = {"loss": float(loss), "params": jax.device_get(p2)}
    res.update(prefill(name, m))
    dec = JC.build_lm_cell(name, ShapeSpec("d", "decode", {"seq_len": SEQ, "global_batch": B}),
                           m, smoke=True)
    c = KVCache(jnp.asarray(w["k"]), jnp.asarray(w["v"]))
    res["dec"] = []
    for t, ln in zip(w["dec"], LENGTHS):
        lg, c = dec.fn(jax.tree.map(jnp.asarray, w["params"]), c, jnp.asarray(t), jnp.int32(ln))
        res["dec"].append(np.asarray(lg))
    res["dec_k"], res["dec_v"] = np.asarray(c.k), np.asarray(c.v)
    out[(name, mesh_shape)] = res
out[("moe_shard",) + moe_case] = prefill(moe_case[0], make_test_mesh(*moe_case[1]),
                                         {"moe_shard": True})
"""


def _port_rank(group, weights, cases, moe_case):
    out = {}
    for name, mesh in cases:
        cfg, w = _cfg(get_config, name), weights[name]
        specs = TT.lm_param_specs(cfg, dict(zip(("data", "model"), mesh)))
        params = lm_params_from_jax(w["params"], "cpu", rank=group.rank, mesh_shape=mesh,
                                    specs=specs)
        step = tcells.make_lm_train_step(cfg, attn_chunk=8, loss_chunk=8, group=group,
                                         mesh_shape=mesh)
        p2, _, loss = step(params, topt.adam_init(params), torch.from_numpy(w["train"]).long())
        whole = TT.gather_params(p2, specs, rdist.axis_groups(group, mesh))
        res = {"loss": float(loss), "params": [_np(x) for x in topt.tree_leaves(whole)]
               if group.rank == 0 else None}
        pre = tcells.make_lm_prefill_step(cfg, group=group, mesh_shape=mesh)
        with torch.no_grad():
            logits, cache = pre(params, torch.from_numpy(w["prefill"]).long())
        res.update(logits=logits.numpy(), k=cache.k.numpy(), v=cache.v.numpy())
        cs = tcells.cache_specs(B, mesh)
        blk = TT.shard_params({"k": torch.from_numpy(w["k"]), "v": torch.from_numpy(w["v"])},
                              {"k": cs, "v": cs}, mesh, group.rank)
        c = TT.KVCache(blk["k"].clone(), blk["v"].clone())
        dec = tcells.make_lm_decode_step(cfg, SEQ, group=group, mesh_shape=mesh)
        res["dec"] = []
        with torch.no_grad():
            for t, ln in zip(w["dec"], LENGTHS):
                lg, c = dec(params, c, torch.from_numpy(t).long(), ln)
                res["dec"].append(lg.numpy().copy())
        res.update(dec_k=c.k.numpy(), dec_v=c.v.numpy())
        out[(name, mesh)] = res
    name, mesh = moe_case
    cfg, w = _cfg(get_config, name), weights[name]
    specs = TT.lm_param_specs(cfg, dict(zip(("data", "model"), mesh)))
    params = lm_params_from_jax(w["params"], "cpu", rank=group.rank, mesh_shape=mesh,
                                specs=specs)
    pre = tcells.make_lm_prefill_step(cfg, group=group, mesh_shape=mesh, moe_shard=True)
    with torch.no_grad():
        logits, cache = pre(params, torch.from_numpy(w["prefill"]).long())
    out[("moe_shard",) + moe_case] = {"logits": logits.numpy(), "k": cache.k.numpy(),
                                      "v": cache.v.numpy()}
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_lm_layouts")
    weights = _inputs()
    collect = start_reference(REF_BODY, (weights, CASES, MOE_CASE), tmp, B=B, S=S, SEQ=SEQ,
                              LENGTHS=LENGTHS, LAYOUTS=LAYOUTS)
    try:
        port = run_port(_port_rank, weights, CASES, MOE_CASE, tmp=tmp)
    finally:
        ref = collect()
    return ref, port


def _check_prefill(r, port, key, mesh):
    scale = float(np.abs(r["logits"]).max())
    cdims = {d: ax for d, ax in enumerate(tcells.cache_specs(B, mesh)) if ax}
    for rank in range(W):
        got = port[rank][key]
        within(got["logits"], block(r["logits"], mesh, rank, {0: "data", 1: "model"}), scale)
        for k in ("k", "v"):
            within(got[k], block(r[k], mesh, rank, cdims), float(np.abs(r[k]).max()))


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_train_step_matches_reference(both, case):
    ref, port = both
    r = ref[case]
    for rank in range(W):
        assert abs(port[rank][case]["loss"] - r["loss"]) <= TOL * abs(r["loss"])
    exp = topt.tree_leaves(lm_params_from_jax(r["params"], "cpu"))
    got = port[0][case]["params"]
    assert len(got) == len(exp)
    for a, b in zip(got, exp):
        np.testing.assert_allclose(a, _np(b), atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_prefill_matches_reference(both, case):
    ref, port = both
    _check_prefill(ref[case], port, case, case[1])


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_decode_matches_reference(both, case):
    """Two decode steps from one numpy cache: the logits of the rank's
    vocab block, then its cache blocks."""
    ref, port = both
    r, mesh = ref[case], case[1]
    cdims = {d: ax for d, ax in enumerate(tcells.cache_specs(B, mesh)) if ax}
    for rank in range(W):
        got = port[rank][case]
        assert len(got["dec"]) == len(r["dec"]) == len(LENGTHS)
        for a, b in zip(got["dec"], r["dec"]):
            within(a, block(b, mesh, rank, {1: "model"}), float(np.abs(b).max()))
        for k in ("dec_k", "dec_v"):
            within(got[k], block(r[k], mesh, rank, cdims), float(np.abs(r[k]).max()))


def test_moe_shard_prefill_matches_reference(both):
    """mixtral-smoke's prefill at 2x2 with ``moe_shard``: each data rank's
    tokens one MoE group, as the reference's ``_moe_exec`` dispatches."""
    ref, port = both
    key = ("moe_shard",) + MOE_CASE
    _check_prefill(ref[key], port, key, MOE_CASE[1])
