"""Prefill and decode past world 1 on the CPU: 4 gloo ranks against the
reference's serving cells (``repro.launch.cells.build_lm_cell``'s prefill
and decode steps) on 4 forced host devices, at meshes 2x2 and 1x4, for
mistral-nemo-smoke (GQA) and mixtral-smoke (MoE, a sliding window of 16:
its decode cache is a ring of 16, and the third step wraps it).

The reference lays the parameters out by ``lm_param_specs`` (FSDP) and
the cache by ``_cache_specs`` (S over ``"model"``, B over ``"data"``);
GSPMD turns decode's softmax into a split-K combine. The port's ranks hold
the same blocks (``convert.lm_params_from_jax(rank=, ...)``,
``cells.cache_specs``) and run ``cells.make_lm_prefill_step`` and
``make_lm_decode_step``. Prefill returns each rank's block of the
last-position logits (``P(data, model)``) and of the cache; decode returns
the whole batch's logits for the rank's vocab block (``P(None, model)``).

Bars: logits and cache blocks within 1e-5 of the reference's largest
logit (cache: its largest entry), each of three decode steps and the
cache after them. ``tests/test_torch_dist_lm_layouts.py`` holds the
layouts that no registered config takes (a tied embedding, a replicated
``wo`` or K/V head) and the prefill's ``moe_shard`` against the reference.
"""
import inspect

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.layers import transformer as JT
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import cells as tcells
from repro_torch.layers import transformer as TT

from test_torch_dist import W, run_port, start_reference
from test_torch_lm import TOL

torch.set_num_threads(1)

B, S, SEQ = 4, 32, 48
ARCHS = ("mistral-nemo-12b", "mixtral-8x22b")
MESHES = ((2, 2), (1, 4))
CASES = [(a, m) for a in ARCHS for m in MESHES]


def _lengths(cache_len):
    """Decode fills: past the prefill, or (a ring) across its wrap."""
    return [S, S + 1, S + 2] if cache_len > S else [cache_len - 2, cache_len - 1, cache_len]


def ring_cache(k: np.ndarray, cache_len: int) -> np.ndarray:
    """A prefill cache ``[L, B, S, G, hd]`` as the decode cell's cache of
    ``cache_len``: position ``p`` at slot ``p % cache_len``, the last
    ``cache_len`` positions when it is a ring."""
    out = np.zeros(k.shape[:2] + (cache_len,) + k.shape[3:], k.dtype)
    for p in range(max(0, S - cache_len), S):
        out[:, :, p % cache_len] = k[:, :, p]
    return out


def _inputs():
    out = {}
    for arch in ARCHS:
        cfg = jget_config(arch, smoke=True)
        params = jax.device_get(JT.init_lm_params(cfg, jax.random.PRNGKey(1)))
        rng = np.random.default_rng(5)
        toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        dtoks = [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32) for _ in range(3)]
        out[arch] = (params, toks, dtoks)
    return out


REF_BODY = """
from repro.configs.base import ShapeSpec
from repro.launch import cells as JC
from repro.launch.mesh import make_test_mesh
from repro.layers.transformer import KVCache
weights, cases = inp
for arch, mesh_shape in cases:
    m = make_test_mesh(*mesh_shape)
    params0, toks, dtoks = weights[arch]
    params = jax.tree.map(jnp.asarray, params0)
    pre = JC.build_lm_cell(arch, ShapeSpec("p", "prefill", {"seq_len": S, "global_batch": B}),
                           m, smoke=True)
    logits, cache = pre.fn(params, jnp.asarray(toks))
    dec = JC.build_lm_cell(arch, ShapeSpec("d", "decode", {"seq_len": SEQ, "global_batch": B}),
                           m, smoke=True)
    cl = int(dec.args[1].k.shape[2])
    ring = lambda a: RING(np.asarray(a), cl)
    c = KVCache(jnp.asarray(ring(cache.k)), jnp.asarray(ring(cache.v)))
    outs = []
    for t, ln in zip(dtoks, LENGTHS(cl)):
        lg, c = dec.fn(params, c, jnp.asarray(t), jnp.int32(ln))
        outs.append(np.asarray(lg))
    out[(arch, mesh_shape)] = {"logits": np.asarray(logits), "k": np.asarray(cache.k),
                               "v": np.asarray(cache.v), "cache_len": cl, "dec": outs,
                               "dec_k": np.asarray(c.k), "dec_v": np.asarray(c.v)}
"""


def _port_rank(group, weights, cases, ref_caches):
    out = {}
    for arch, mesh in cases:
        cfg = get_config(arch, smoke=True)
        params0, toks, dtoks = weights[arch]
        specs = TT.lm_param_specs(cfg, dict(zip(("data", "model"), mesh)))
        params = lm_params_from_jax(params0, "cpu", rank=group.rank, mesh_shape=mesh,
                                    specs=specs)
        pre = tcells.make_lm_prefill_step(cfg, group=group, mesh_shape=mesh)
        with torch.no_grad():
            logits, cache = pre(params, torch.from_numpy(toks).long())
        cl = tcells.decode_cache_len(cfg, SEQ)
        cs = tcells.cache_specs(B, mesh)
        k, v = ref_caches[(arch, mesh)]
        blk = TT.shard_params({"k": torch.from_numpy(ring_cache(k, cl)),
                               "v": torch.from_numpy(ring_cache(v, cl))},
                              {"k": cs, "v": cs}, mesh, group.rank)
        c = TT.KVCache(blk["k"].clone(), blk["v"].clone())
        dec = tcells.make_lm_decode_step(cfg, cl, group=group, mesh_shape=mesh)
        outs = []
        with torch.no_grad():
            for t, ln in zip(dtoks, _lengths(cl)):
                lg, c = dec(params, c, torch.from_numpy(t).long(), ln)
                outs.append(lg.numpy().copy())
        out[(arch, mesh)] = {"logits": logits.numpy(), "k": cache.k.numpy(),
                             "v": cache.v.numpy(), "cache_len": cl, "dec": outs,
                             "dec_k": c.k.numpy(), "dec_v": c.v.numpy()}
    return out


def _run_reference(tmp, weights):
    helpers = inspect.getsource(ring_cache) + inspect.getsource(_lengths)
    body = helpers + "RING, LENGTHS = ring_cache, _lengths\n" + REF_BODY
    return start_reference(body, (weights, CASES), tmp, B=B, S=S, SEQ=SEQ)()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reference first: both sides' decode starts from its prefill
    cache."""
    tmp = tmp_path_factory.mktemp("dist_lm_serve")
    weights = _inputs()
    ref = _run_reference(tmp, weights)
    caches = {c: (ref[c]["k"], ref[c]["v"]) for c in CASES}
    return ref, run_port(_port_rank, weights, CASES, caches, tmp=tmp)


def block(x, mesh, rank, dims):
    """Rank ``rank``'s block of ``x`` along ``dims`` (``{dim: axis}``)."""
    coord = {"data": (rank // mesh[1], mesh[0]), "model": (rank % mesh[1], mesh[1])}
    for d, ax in dims.items():
        i, n = coord[ax]
        sz = x.shape[d] // n
        x = x[(slice(None),) * d + (slice(i * sz, (i + 1) * sz),)]
    return x


def within(got, exp, scale):
    assert got.shape == exp.shape, (got.shape, exp.shape)
    assert float(np.abs(got - exp).max()) <= TOL * scale


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}")
def test_prefill_matches_reference(both, case):
    ref, port = both
    r, mesh = ref[case], case[1]
    scale = float(np.abs(r["logits"]).max())
    cs = tcells.cache_specs(B, mesh)
    cdims = {d: ax for d, ax in enumerate(cs) if ax}
    for rank in range(W):
        got = port[rank][case]
        within(got["logits"], block(r["logits"], mesh, rank, {0: "data", 1: "model"}), scale)
        for k in ("k", "v"):
            exp = block(r[k], mesh, rank, cdims)
            within(got[k], exp, float(np.abs(r[k]).max()))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}")
def test_decode_matches_reference(both, case):
    """Three decode steps from the prefill's cache (mixtral's ring wraps on
    the third); the logits for the rank's vocab block, the cache blocks."""
    ref, port = both
    r, mesh = ref[case], case[1]
    assert port[0][case]["cache_len"] == r["cache_len"]
    cdims = {d: ax for d, ax in enumerate(tcells.cache_specs(B, mesh)) if ax}
    for rank in range(W):
        got = port[rank][case]
        for a, b in zip(got["dec"], r["dec"]):
            within(a, block(b, mesh, rank, {1: "model"}), float(np.abs(b).max()))
        for k in ("dec_k", "dec_v"):
            within(got[k], block(r[k], mesh, rank, cdims), float(np.abs(r[k]).max()))
