"""Decoder-only LM stack for the five LM-family archs
(``repro.layers.transformer`` in torch).

Layer parameters stay stacked ``[L, ...]`` as in the reference, so the
leaves map one to one; the stack runs as a Python loop over ``l`` where the
reference scans. ``remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``), as ``jax.checkpoint`` does.

Dtypes follow the reference leaf by leaf. ``init_lm_params`` stores every
leaf in ``cfg.dtype`` but ``emb``, which comes out float32 there (it is
scaled by a numpy float64, which JAX does not treat as weakly typed). So
the residual stream is float32, each product of it with a bfloat16 weight
is a float32 product (``mlp.mixed_matmul``, JAX's promotion), the loss is
float32, and ``lm_prefill`` returns its cache in the stream's dtype while
``init_kv_cache`` makes one in ``cfg.dtype``.

``lm_decode_step`` writes the new K/V into the cache in place (the
reference returns a new cache) at ``length`` clamped into the cache, as
XLA clamps a ``dynamic_update_slice``. ``abstract_lm_params``,
``abstract_kv_cache`` and ``unroll`` serve the XLA lowering only (ROADMAP
Queue 1 item 7b.2).

Past world 1 (``mesh=``, an ``LMMesh``) each rank holds its shards of
every leaf as ``lm_param_specs`` lays them out on the ``("data",
"model")`` mesh, and the functions below compute what GSPMD partitions the
reference into (``dist.spmd`` holds the collectives):

* Megatron TP over ``"model"``: ``wq``/``wk``/``wv``/``w1``/``w3`` are
  column-parallel (their input enters through ``copy_to``), ``wo``/``w2``
  row-parallel (``reduce_from``); a leaf whose spec has no ``"model"`` is
  replicated and its product computed whole on every rank. Whole query
  heads stay on their rank when ``H % tp == 0``; K/V columns that split
  a head, or that the local heads do not own, are gathered over
  ``"model"`` (``gather_dim``, whose backward sums the ranks' parts);
* FSDP over ``"data"``: each layer's shards are gathered inside the layer
  (inside the remat, so the backward gathers them again), and the gather's
  backward reduce-scatters the gradient;
* the embedding and the head are vocab-parallel: the lookup masks ids
  outside the rank's vocab block and psums, and the CE takes its max, its
  sum of exponentials and its target logit across ``"model"``;
* tokens split over ``"data"``; ``lm_loss`` returns this rank's share of
  the global mean (its CE sum over the global token count), so the
  gradients of the shares summed over ``"data"`` are the loss's;
* the MoE dispatch is global (the normed tokens gathered over ``"data"``,
  one dispatch, the rank's rows kept) unless ``moe_local`` (the reference's
  ``moe_exec``: each data rank's tokens one group, with its own capacity);
* prefill returns this rank's block of the sequence-sharded cache
  (``repro.launch.cells._cache_specs``) and the last position's logits for
  its vocab block; decode runs the whole batch on every rank with the
  weights in place (its few tokens' activations move instead: each ``D``
  contraction split over ``"data"`` and psum'd), writes the new K/V on the
  rank that owns the slot, combines the attention across ``"model"``
  (``attention.decode_attention``), and returns the logits of the whole
  batch for the rank's vocab block (``P(None, "model")``). At world 1 the
  same body runs on a mesh of world-1 groups, whose collectives are
  identities.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.core.jax_random import Rng, rng_normal, rng_split
from repro_torch.dist.compat import WORLD1, Group
from repro_torch.dist.spmd import copy_to, gather_along, gather_dim, reduce_from
from repro_torch.layers.attention import (apply_rope, chunked_causal_attention,
                                          decode_attention)
from repro_torch.layers.mlp import mixed_matmul, split_matmul
from repro_torch.layers.moe import moe_ffn
from repro_torch.optim.optimizers import weak_scalar


def _dt(cfg: LMConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def init_lm_params(cfg: LMConfig, rng: Rng, device: Union[str, torch.device]) -> Dict:
    """The reference's weights from a ``JaxKey`` (drawn on the host), or
    draws of the same shapes, in the same order, from a generator."""
    device = torch.device(device)
    dt = _dt(cfg)
    L, D, H, G = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.head_dim
    ks = rng_split(rng, 12)

    def nrm(k, shape, fan_in):
        # normal / np.sqrt(fan_in): the numpy float64 divisor is float32 in JAX
        w = rng_normal(k, shape, device).div_(float(np.float32(np.sqrt(fan_in))))
        return w.to(dt)

    # emb * 0.02 (weak: rounded to dt) * np.sqrt(1.0) (float64: float32 in JAX)
    p: Dict[str, Any] = {
        "emb": (nrm(ks[0], (cfg.vocab, D), 1.0) * weak_scalar(0.02, dt)).to(torch.float32),
        "ln_f": torch.ones((D,), dtype=dt, device=device),
        "layers": {
            "ln1": torch.ones((L, D), dtype=dt, device=device),
            "ln2": torch.ones((L, D), dtype=dt, device=device),
            "wq": nrm(ks[1], (L, D, H * hd), D),
            "wk": nrm(ks[2], (L, D, G * hd), D),
            "wv": nrm(ks[3], (L, D, G * hd), D),
            "wo": nrm(ks[4], (L, H * hd, D), H * hd),
        },
    }
    if not cfg.tie_embeddings:
        p["head"] = nrm(ks[5], (D, cfg.vocab), D)
    if cfg.moe is not None:
        E, F = cfg.moe.n_experts, cfg.moe.d_ff
        p["layers"].update({
            "router": nrm(ks[6], (L, D, E), D),
            "w1": nrm(ks[7], (L, E, D, F), D),
            "w3": nrm(ks[8], (L, E, D, F), D),
            "w2": nrm(ks[9], (L, E, F, D), F),
        })
    else:
        F = cfg.d_ff
        p["layers"].update({
            "w1": nrm(ks[7], (L, D, F), D),
            "w3": nrm(ks[8], (L, D, F), D),
            "w2": nrm(ks[9], (L, F, D), F),
        })
    return p


Spec = Tuple[Optional[str], ...]


def lm_param_specs(cfg: LMConfig, mesh_shape: Dict[str, int], fsdp: bool = True) -> Dict:
    """Each leaf's layout on the ``("data", "model")`` mesh, a tuple with an
    axis name (or ``None``) a dim (``repro.layers.transformer.
    lm_param_specs`` with its defaults): Megatron TP over ``"model"`` on the
    contraction-free dim, FSDP over ``"data"`` on a second dim (``fsdp``;
    else replicated over ``"data"``). A dim is sharded only where the
    axis's size divides it."""
    tp = int(mesh_shape["model"])
    dpn = int(mesh_shape["data"]) if fsdp else 0

    def p_tp(sz):
        return "model" if tp and sz % tp == 0 else None

    def p_dp(sz):
        return "data" if fsdp and dpn and sz % dpn == 0 else None

    D, hd = cfg.d_model, cfg.head_dim
    H, G, V = cfg.n_heads, cfg.n_kv_heads, cfg.vocab
    specs: Dict[str, Any] = {
        "emb": (p_tp(V), p_dp(D)),   # vocab-sharded embedding
        "ln_f": (None,),
        "layers": {
            "ln1": (None, None), "ln2": (None, None),
            "wq": (None, p_dp(D), p_tp(H * hd)),
            "wk": (None, p_dp(D), p_tp(G * hd)),
            "wv": (None, p_dp(D), p_tp(G * hd)),
            "wo": (None, p_tp(H * hd), p_dp(D)),
        },
    }
    if cfg.moe is None:
        F = cfg.d_ff
        specs["layers"].update({"w1": (None, p_dp(D), p_tp(F)),
                                "w3": (None, p_dp(D), p_tp(F)),
                                "w2": (None, p_tp(F), p_dp(D))})
    else:
        F = cfg.moe.d_ff
        specs["layers"].update({"router": (None, p_dp(D), None),
                                "w1": (None, None, p_dp(D), p_tp(F)),
                                "w3": (None, None, p_dp(D), p_tp(F)),
                                "w2": (None, None, p_tp(F), p_dp(D))})
    if not cfg.tie_embeddings:
        specs["head"] = (p_dp(D), p_tp(V))
    return specs


def _spec_map(fn, tree: Any, specs: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _spec_map(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


def shard_params(tree: Any, specs: Any, mesh_shape: Sequence[int], rank: int) -> Any:
    """Rank ``rank``'s block of every leaf of a whole tree (tensors or
    numpy arrays) laid out by ``specs`` on a ``(data, model)`` mesh of
    ``mesh_shape``, row-major (``launch.mesh.rank_coords``)."""
    dp, tp = (int(x) for x in mesh_shape)
    where = {"data": (rank // tp, dp), "model": (rank % tp, tp)}

    def cut(x, spec):
        for dim, ax in enumerate(spec):
            if ax is not None:
                i, n = where[ax]
                size = x.shape[dim] // n
                x = x[(slice(None),) * dim + (slice(i * size, (i + 1) * size),)]
        return x

    return _spec_map(cut, tree, specs)


def gather_params(tree: Any, specs: Any, axes: Dict[str, Group]) -> Any:
    """The inverse of ``shard_params``: every leaf whole on every rank
    (``axes`` from ``dist.axis_groups``; no autograd)."""
    def whole(x, spec):
        for dim, ax in enumerate(spec):
            if ax is not None:
                x = gather_along(x, axes[ax], dim)
        return x

    return _spec_map(whole, tree, specs)


class LMMesh(NamedTuple):
    """A rank's place on the ``("data", "model")`` mesh for the LM: its
    axis groups, the specs of the parameters it holds, whether the batch is
    split over ``"data"`` (training and prefill: the rank's tokens are its
    data block; decode: the cache's batch is, the tokens whole on every
    rank) and whether the MoE dispatches each data rank's tokens as one
    group (``moe_exec``)."""

    data: Group
    model: Group
    specs: Dict
    tokens_split: bool = True
    moe_local: bool = False


def lm_mesh(axes: Dict[str, Group], specs: Dict, tokens_split: bool = True,
            moe_local: bool = False) -> LMMesh:
    return LMMesh(axes["data"], axes["model"], specs,
                  tokens_split and axes["data"].world > 1, moe_local)


def _fsdp(x: torch.Tensor, spec: Spec, mesh: LMMesh) -> torch.Tensor:
    """A leaf with its ``"data"`` dims gathered (the gradient reduce-scattered)."""
    for dim, ax in enumerate(spec):
        if ax == "data":
            x = gather_dim(x, mesh.data, dim)
    return x


def _tp(spec: Spec) -> bool:
    return "model" in spec


def _rmsnorm(g: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * g


def _layer_params(params: Dict, l: int) -> Dict:
    return {k: v[l] for k, v in params["layers"].items()}


def _gather_layer(lp: Dict, mesh: LMMesh) -> Dict:
    """A layer's leaves (indexed out of the stack) with their FSDP dims
    gathered over ``"data"``."""
    sp = mesh.specs["layers"]
    return {k: _fsdp(v, sp[k][1:], mesh) for k, v in lp.items()}


def _head(cfg: LMConfig, params: Dict, mesh: Optional[LMMesh] = None) -> torch.Tensor:
    if mesh is None:
        return params["emb"].T if cfg.tie_embeddings else params["head"]
    if cfg.tie_embeddings:
        return _fsdp(params["emb"], mesh.specs["emb"], mesh).T
    return _fsdp(params["head"], mesh.specs["head"], mesh)


def _vocab_split(cfg: LMConfig, mesh: Optional[LMMesh]) -> bool:
    return mesh is not None and mesh.model.world > 1 and _tp(mesh.specs["emb"])


def _vocab_rows(emb: torch.Tensor, tokens: torch.Tensor,
                model: Optional[Group]) -> torch.Tensor:
    """``emb[tokens]``; with ``model``, ``emb`` is the rank's vocab block:
    ids outside it give zeros, then a psum over ``"model"``."""
    if model is None:
        return emb[tokens]
    n = emb.shape[0]
    local = tokens - model.rank * n
    inside = (local >= 0) & (local < n)
    rows = emb[torch.clamp(local, 0, n - 1)]
    return reduce_from(torch.where(inside[..., None], rows, torch.zeros_like(rows)), model)


def _embed(cfg: LMConfig, params: Dict, tokens: torch.Tensor,
           mesh: Optional[LMMesh] = None) -> torch.Tensor:
    """The embedding lookup; vocab-parallel past world 1."""
    if mesh is None:
        return params["emb"][tokens]
    emb = _fsdp(params["emb"], mesh.specs["emb"], mesh)
    return _vocab_rows(emb, tokens, mesh.model if _vocab_split(cfg, mesh) else None)


def _qkv(cfg: LMConfig, lp: Dict, x: torch.Tensor, pos: torch.Tensor):
    b, s, _ = x.shape
    hd, h, g = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    hx = _rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q = mixed_matmul(hx, lp["wq"]).reshape(b, s, h, hd)
    k = mixed_matmul(hx, lp["wk"]).reshape(b, s, g, hd)
    v = mixed_matmul(hx, lp["wv"]).reshape(b, s, g, hd)
    return apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta), v


def _gather_d(y: torch.Tensor, split: Optional[Group]) -> torch.Tensor:
    """A product's ``D`` columns, split over ``split``, gathered whole."""
    return y if split is None else gather_along(y, split, -1)


def _ffn(cfg: LMConfig, lp: Dict, x: torch.Tensor, moe_cap: float,
         mesh: Optional[LMMesh] = None, moe_groups: int = 1,
         split: Optional[Group] = None) -> torch.Tensor:
    """The second half of a layer: ``x`` plus the SwiGLU (or MoE, its
    tokens dispatched in ``moe_groups`` groups) of its norm; with ``mesh``,
    on a rank's (gathered) shards. With ``split`` (decode: ``x`` whole on
    every rank) the weights' ``D`` stays split over ``"data"``: each ``D``
    contraction is psum'd and the ``D`` outputs gathered."""
    b, s, d = x.shape
    hx = _rmsnorm(lp["ln2"], x, cfg.norm_eps)
    sp = mesh.specs["layers"] if mesh is not None else None
    model = mesh.model if mesh is not None and _tp(sp["w1"]) else None
    if cfg.moe is not None:
        flat = hx.reshape(b * s, d)
        glob = mesh is not None and mesh.tokens_split and not mesh.moe_local
        if glob:   # one dispatch over every data rank's tokens, as the reference's
            flat = gather_dim(flat, mesh.data, 0)
        y = moe_ffn(flat, lp["router"], lp["w1"], lp["w2"], lp["w3"], cfg.moe.top_k,
                    capacity_factor=moe_cap, groups=moe_groups, model=model, split=split)
        if glob:
            y = y.narrow(0, mesh.data.rank * b * s, b * s)
        return x + y.reshape(b, s, d)
    if model is not None:
        hx = copy_to(hx, model)
    g = split_matmul(hx, lp["w3"], split)
    y = mixed_matmul(g * torch.sigmoid(g) * split_matmul(hx, lp["w1"], split), lp["w2"])
    if model is not None:
        y = reduce_from(y, model)
    return x + _gather_d(y, split)


def _rope_heads(x: torch.Tensor, n: int, hd: int, pos: torch.Tensor,
                theta: float) -> torch.Tensor:
    b, s = x.shape[:2]
    return apply_rope(x.reshape(b, s, n, hd), pos, theta)


def _attn(cfg: LMConfig, lp: Dict, x: torch.Tensor, pos: torch.Tensor, attn_chunk: int):
    """``x`` plus the attention block on whole weights, and its (roped) k, v."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, lp, x, pos)
    o = chunked_causal_attention(q, k, v, chunk=attn_chunk, window=cfg.swa_window)
    return x + mixed_matmul(o.reshape(b, s, -1), lp["wo"]), k, v


def _attn_tp(cfg: LMConfig, lp: Dict, x: torch.Tensor, pos: torch.Tensor,
             attn_chunk: int, mesh: LMMesh, want_kv: bool = False):
    """``x`` plus the attention block on a rank's shards, and (``want_kv``)
    the roped K/V of all ``G`` heads for the rank's tokens.

    With ``wo`` sharded (``H * hd % tp == 0``) each rank attends with its
    own query heads when ``H % tp == 0``, else with all of them and keeps
    its rows of ``o``; K/V come from the rank's own columns when its heads
    own them, else gathered over ``"model"`` (a head split mid-way, or GQA
    groups across ranks). Every share a rank reads enters through
    ``copy_to`` or ``gather_dim``, so the gradients sum over the ranks.
    With ``wo`` replicated (``H * hd % tp != 0``) so are ``wq``, ``wk`` and
    ``wv`` (``G * hd`` divides ``H * hd``), and the block runs whole on
    every rank."""
    b, s, _ = x.shape
    hd, h, g = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    theta, mg = cfg.rope_theta, mesh.model
    tp, m = mg.world, mg.rank
    sp = mesh.specs["layers"]
    if not _tp(sp["wo"]):
        return _attn(cfg, lp, x, pos, attn_chunk)
    hx = _rmsnorm(lp["ln1"], x, cfg.norm_eps)
    hxc = copy_to(hx, mg)
    own_heads = h % tp == 0
    q = mixed_matmul(hxc, lp["wq"])
    if not own_heads:
        q = gather_dim(q, mg, -1)
    hl = q.shape[-1] // hd
    q = _rope_heads(q, hl, hd, pos, theta)
    aligned = own_heads and g % tp == 0

    def kv(name):
        if _tp(sp[name]):
            y = mixed_matmul(hxc, lp[name])
            return y if aligned else gather_dim(y, mg, -1)
        return copy_to(mixed_matmul(hx, lp[name]), mg)

    k, v = kv("wk"), kv("wv")
    gl = k.shape[-1] // hd
    k, v = _rope_heads(k, gl, hd, pos, theta), v.reshape(b, s, gl, hd)
    if aligned:
        o = chunked_causal_attention(q, k, v, chunk=attn_chunk, window=cfg.swa_window)
    else:   # one K/V head per query head this rank attends with
        first = m * hl if own_heads else 0
        sel = torch.div(torch.arange(first, first + hl, device=x.device), h // g,
                        rounding_mode="floor")
        o = chunked_causal_attention(q, k.index_select(2, sel), v.index_select(2, sel),
                                     chunk=attn_chunk, window=cfg.swa_window)
    o = o.reshape(b, s, -1)
    if not own_heads:
        cols = h * hd // tp
        o = o.narrow(-1, m * cols, cols)
    x = x + reduce_from(mixed_matmul(o, lp["wo"]), mg)
    if want_kv and aligned:
        k, v = gather_along(k, mg, 2), gather_along(v, mg, 2)
    return x, k, v


def _layer(cfg: LMConfig, lp: Dict, x: torch.Tensor, pos: torch.Tensor, attn_chunk: int,
           moe_cap: float, mesh: Optional[LMMesh] = None, want_kv: bool = True,
           moe_groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer: the new stream and the layer's (roped) k and v (with
    ``mesh``, on the rank's shards, gathered inside: K/V of all heads
    only with ``want_kv``)."""
    if mesh is not None:
        lp = _gather_layer(lp, mesh)
        x, k, v = _attn_tp(cfg, lp, x, pos, attn_chunk, mesh, want_kv)
        return _ffn(cfg, lp, x, moe_cap, mesh), k, v
    x, k, v = _attn(cfg, lp, x, pos, attn_chunk)
    return _ffn(cfg, lp, x, moe_cap, moe_groups=moe_groups), k, v


def _backbone(cfg: LMConfig, params: Dict, tokens: torch.Tensor, attn_chunk: int,
              remat: bool, moe_cap: float, mesh: Optional[LMMesh] = None,
              moe_groups: int = 1) -> torch.Tensor:
    x = _embed(cfg, params, tokens, mesh)
    pos = torch.arange(tokens.shape[1], device=tokens.device)

    def body(x, lp):
        return _layer(cfg, lp, x, pos, attn_chunk, moe_cap, mesh, want_kv=False,
                      moe_groups=moe_groups)[0]

    for l in range(cfg.n_layers):
        lp = _layer_params(params, l)
        if remat and torch.is_grad_enabled():
            x = checkpoint(body, x, lp, use_reentrant=False)
        else:
            x = body(x, lp)
    return _rmsnorm(params["ln_f"], x, cfg.norm_eps)


def lm_forward(cfg: LMConfig, params: Dict, tokens: torch.Tensor, attn_chunk: int = 512,
               remat: bool = True, moe_cap: float = 1.25) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V]."""
    x = _backbone(cfg, params, tokens, attn_chunk, remat, moe_cap)
    return mixed_matmul(x, _head(cfg, params))


def _ce(head: torch.Tensor, xc: torch.Tensor, tgt: torch.Tensor,
        wc: torch.Tensor) -> torch.Tensor:
    lg = mixed_matmul(xc, head).to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    true = torch.gather(lg, -1, tgt[..., None])[..., 0]
    return ((lse - true) * wc).sum()


def _ce_vocab(model: Group, head: torch.Tensor, xc: torch.Tensor, tgt: torch.Tensor,
              wc: torch.Tensor) -> torch.Tensor:
    """``_ce`` with the head's vocab split over ``model``: the max, the sum
    of exponentials and the target's logit taken across the ranks."""
    lg = mixed_matmul(copy_to(xc, model), head).to(torch.float32)   # [b, s, V / tp]
    top = gather_along(lg.detach().amax(-1)[None], model, 0).amax(0)
    lse = torch.log(reduce_from(torch.exp(lg - top[..., None]).sum(-1), model)) + top
    n = lg.shape[-1]
    local = tgt - model.rank * n
    inside = (local >= 0) & (local < n)
    own = torch.gather(lg, -1, torch.clamp(local, 0, n - 1)[..., None])[..., 0]
    true = reduce_from(torch.where(inside, own, torch.zeros_like(own)), model)
    return ((lse - true) * wc).sum()


def lm_loss(cfg: LMConfig, params: Dict, tokens: torch.Tensor, attn_chunk: int = 512,
            remat: bool = True, moe_cap: float = 1.25, loss_chunk: int = 0,
            mesh: Optional[LMMesh] = None, moe_groups: int = 1) -> torch.Tensor:
    """Next-token CE, mean over tokens; the last position has weight 0.

    ``loss_chunk`` > 0 (dividing S, below it) computes the [B, S, V] logits a
    sequence chunk at a time, each recomputed in the backward, so the
    full-vocab logits never materialize. ``moe_groups`` is the groups of the
    reference's ``moe_exec`` (its layout pin dropped): the MoE dispatches
    each of that many token groups alone, as a mesh's data shards do under
    ``moe_shard``.

    With ``mesh`` (``tokens`` this rank's data block, ``params`` its shards)
    it returns this rank's share: its tokens' CE sum over the global token
    count, the same on every rank of a ``"model"`` group; the loss is the
    psum of the shares over ``"data"``.
    """
    b, s = tokens.shape
    x = _backbone(cfg, params, tokens, attn_chunk, remat, moe_cap, mesh, moe_groups)
    head = _head(cfg, params, mesh)
    ce = (lambda *a: _ce_vocab(mesh.model, *a)) if _vocab_split(cfg, mesh) else _ce
    # predict token t+1 from position t
    tgt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    w = torch.ones((b, s), dtype=torch.float32, device=tokens.device)
    w[:, -1] = 0.0
    if loss_chunk and s % loss_chunk == 0 and s > loss_chunk:
        total = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for i in range(s // loss_chunk):
            sl = slice(i * loss_chunk, (i + 1) * loss_chunk)
            part = (checkpoint(ce, head, x[:, sl], tgt[:, sl], w[:, sl], use_reentrant=False)
                    if torch.is_grad_enabled() else ce(head, x[:, sl], tgt[:, sl], w[:, sl]))
            total = total + part
    else:
        total = ce(head, x, tgt, w)
    n_b = b * mesh.data.world if mesh is not None and mesh.tokens_split else b
    return total / (n_b * (s - 1))


# ---------------------------------------------------------------------------
# serving: prefill + decode with KV cache
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, S, G, hd]
    v: torch.Tensor


def init_kv_cache(cfg: LMConfig, batch: int, seq: int,
                  device: Union[str, torch.device]) -> KVCache:
    sh = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(sh, dtype=_dt(cfg), device=device),
                   torch.zeros(sh, dtype=_dt(cfg), device=device))


def _logits(cfg: LMConfig, params: Dict, x: torch.Tensor,
            mesh: Optional[LMMesh]) -> torch.Tensor:
    """The head's product (with ``mesh``: the rank's vocab block)."""
    head = _head(cfg, params, mesh)
    if _vocab_split(cfg, mesh):
        x = copy_to(x, mesh.model)
    return mixed_matmul(x, head)


def _world1_mesh(cfg: LMConfig) -> LMMesh:
    return LMMesh(WORLD1, WORLD1, lm_param_specs(cfg, {"data": 1, "model": 1}), False)


def _whole(y: torch.Tensor, spec: Spec, mesh: LMMesh) -> torch.Tensor:
    return gather_along(y, mesh.model, -1) if _tp(spec) else y


def lm_decode_step(cfg: LMConfig, params: Dict, cache: KVCache, tokens: torch.Tensor,
                   length: Union[int, torch.Tensor], moe_cap: float = 1.25,
                   mesh: Optional[LMMesh] = None) -> Tuple[torch.Tensor, KVCache]:
    """One decode step. tokens [B, 1]; length: the current cache fill (a
    scalar), the new token's position. The new K/V land in ``cache`` in
    place, at ``length`` clamped to ``[0, S - 1]``; attention reads the
    first ``length + 1`` positions (the window's last ones).

    With ``mesh``: ``tokens`` are the whole batch on every rank, ``cache``
    the rank's block of a cache sharded along S over ``"model"`` and, with
    ``mesh.tokens_split``, along B over ``"data"``; the logits come back
    for the whole batch and the rank's vocab block. Decode's few tokens
    move and the weights stay in place: each product's ``D`` contraction
    is split over ``"data"`` and psum'd (``mlp.split_matmul``), its ``D``
    outputs gathered; every rank computes all heads' q and the new K/V,
    the rank owning the slot writes its batch block's, the attention over
    the cache's S blocks combines across ``"model"``, each data rank's
    batch block of it is gathered over ``"data"``, and ``wo`` and ``w2``
    are row-parallel over ``"model"``; these psums carry no gradient."""
    mesh = _world1_mesh(cfg) if mesh is None else mesh
    b = tokens.shape[0]
    dev = tokens.device
    hd, h, g = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    mg, sp = mesh.model, mesh.specs["layers"]
    split = mesh.data if mesh.data.world > 1 and mesh.specs["emb"][1] == "data" else None
    s_loc = cache.k.shape[2]
    off = mg.rank * s_loc
    bl = cache.k.shape[1]                           # the cache's batch rows
    rows = (slice(mesh.data.rank * bl, (mesh.data.rank + 1) * bl) if mesh.tokens_split
            else slice(None))
    x = _vocab_rows(params["emb"], tokens, mg if _vocab_split(cfg, mesh) else None)
    x = _gather_d(x, split)                                     # [B, 1, D]
    pos = torch.as_tensor(length, device=dev).reshape(1)        # position of the new token
    local = torch.clamp(pos, 0, s_loc * mg.world - 1) - off
    mine = (local >= 0) & (local < s_loc)
    at = torch.clamp(local, 0, s_loc - 1)
    ffn_mesh = mesh._replace(tokens_split=False)                # the tokens are whole
    for l in range(cfg.n_layers):
        lp = _layer_params(params, l)
        kc, vc = cache.k[l], cache.v[l]
        hx = _rmsnorm(lp["ln1"], x, cfg.norm_eps)
        q, k, v = (_whole(split_matmul(hx, lp[w], split), sp[w], mesh)
                   for w in ("wq", "wk", "wv"))
        q = _rope_heads(q, h, hd, pos, cfg.rope_theta)
        k = _rope_heads(k, g, hd, pos, cfg.rope_theta)[rows]
        v = v.reshape(b, 1, g, hd)[rows]
        for c, new in ((kc, k), (vc, v)):
            c.index_copy_(1, at, torch.where(mine, new.to(c.dtype), c.index_select(1, at)))
        o = decode_attention(q[rows], kc, vc, pos + 1, window=cfg.swa_window, group=mg,
                             offset=off)
        if mesh.tokens_split:
            o = gather_along(o, mesh.data, 0)
        o = o.reshape(b, 1, -1)
        if _tp(sp["wo"]):
            cols = h * hd // mg.world
            o = reduce_from(mixed_matmul(o.narrow(-1, mg.rank * cols, cols), lp["wo"]), mg)
        else:
            o = mixed_matmul(o, lp["wo"])
        x = _ffn(cfg, lp, x + _gather_d(o, split), moe_cap, ffn_mesh, split=split)
    x = _rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return split_matmul(x, _head(cfg, params), split)[:, 0], cache


def lm_prefill(cfg: LMConfig, params: Dict, tokens: torch.Tensor, attn_chunk: int = 512,
               moe_cap: float = 1.25, mesh: Optional[LMMesh] = None
               ) -> Tuple[torch.Tensor, KVCache]:
    """Prefill: tokens [B, S] -> (last-position logits, the filled cache in
    the stream's dtype). With ``mesh``: ``tokens`` are this rank's data
    block, and it returns the logits of its vocab block and its block of
    the cache sharded along S over ``"model"``."""
    x = _embed(cfg, params, tokens, mesh)
    s = tokens.shape[1]
    pos = torch.arange(s, device=tokens.device)
    if mesh is not None and s % mesh.model.world:
        raise ValueError(f"a prefill of {s} positions does not split over "
                         f"{mesh.model.world} model ranks")
    ks, vs = [], []
    for l in range(cfg.n_layers):
        x, k, v = _layer(cfg, _layer_params(params, l), x, pos, attn_chunk, moe_cap, mesh)
        if mesh is not None:
            n = s // mesh.model.world
            k, v = k.narrow(1, mesh.model.rank * n, n), v.narrow(1, mesh.model.rank * n, n)
        ks.append(k.to(x.dtype))
        vs.append(v.to(x.dtype))
    x = _rmsnorm(params["ln_f"], x, cfg.norm_eps)
    if mesh is None:
        logits = mixed_matmul(x, _head(cfg, params))[:, -1]
    else:
        logits = _logits(cfg, params, x[:, -1:], mesh)[:, 0]
    return logits, KVCache(torch.stack(ks), torch.stack(vs))
