"""Decoder-only LM stack for the five LM-family archs
(``repro.layers.transformer`` in torch, at world 1).

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
``abstract_kv_cache``, ``lm_param_specs`` and ``unroll`` serve the XLA
lowering only, and ``moe_exec`` (the token-group MoE dispatch a mesh's
data shards ask for) is past world 1: they are ROADMAP Queue 1 item 7b.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.core.jax_random import Rng, rng_normal, rng_split
from repro_torch.layers.attention import (apply_rope, chunked_causal_attention,
                                          decode_attention)
from repro_torch.layers.mlp import mixed_matmul
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


def _rmsnorm(g: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * g


def _layer_params(params: Dict, l: int) -> Dict:
    return {k: v[l] for k, v in params["layers"].items()}


def _head(cfg: LMConfig, params: Dict) -> torch.Tensor:
    return params["emb"].T if cfg.tie_embeddings else params["head"]


def _qkv(cfg: LMConfig, lp: Dict, x: torch.Tensor, pos: torch.Tensor):
    b, s, _ = x.shape
    hd, h, g = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    hx = _rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q = mixed_matmul(hx, lp["wq"]).reshape(b, s, h, hd)
    k = mixed_matmul(hx, lp["wk"]).reshape(b, s, g, hd)
    v = mixed_matmul(hx, lp["wv"]).reshape(b, s, g, hd)
    return apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta), v


def _ffn(cfg: LMConfig, lp: Dict, x: torch.Tensor, moe_cap: float) -> torch.Tensor:
    """The second half of a layer: ``x`` plus the SwiGLU (or MoE) of its norm."""
    b, s, d = x.shape
    hx = _rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if cfg.moe is not None:
        y = moe_ffn(hx.reshape(b * s, d), lp["router"], lp["w1"], lp["w2"], lp["w3"],
                    cfg.moe.top_k, capacity_factor=moe_cap)
        return x + y.reshape(b, s, d)
    g = mixed_matmul(hx, lp["w3"])
    return x + mixed_matmul(g * torch.sigmoid(g) * mixed_matmul(hx, lp["w1"]), lp["w2"])


def _layer(cfg: LMConfig, lp: Dict, x: torch.Tensor, pos: torch.Tensor, attn_chunk: int,
           moe_cap: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer: the new stream and the layer's (roped) k and v."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, lp, x, pos)
    o = chunked_causal_attention(q, k, v, chunk=attn_chunk, window=cfg.swa_window)
    x = x + mixed_matmul(o.reshape(b, s, -1), lp["wo"])
    return _ffn(cfg, lp, x, moe_cap), k, v


def _backbone(cfg: LMConfig, params: Dict, tokens: torch.Tensor, attn_chunk: int,
              remat: bool, moe_cap: float) -> torch.Tensor:
    x = params["emb"][tokens]
    pos = torch.arange(tokens.shape[1], device=tokens.device)

    def body(x, lp):
        return _layer(cfg, lp, x, pos, attn_chunk, moe_cap)[0]

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


def lm_loss(cfg: LMConfig, params: Dict, tokens: torch.Tensor, attn_chunk: int = 512,
            remat: bool = True, moe_cap: float = 1.25, loss_chunk: int = 0) -> torch.Tensor:
    """Next-token CE, mean over tokens; the last position has weight 0.

    ``loss_chunk`` > 0 (dividing S, below it) computes the [B, S, V] logits a
    sequence chunk at a time, each recomputed in the backward, so the
    full-vocab logits never materialize.
    """
    b, s = tokens.shape
    x = _backbone(cfg, params, tokens, attn_chunk, remat, moe_cap)
    head = _head(cfg, params)
    # predict token t+1 from position t
    tgt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    w = torch.ones((b, s), dtype=torch.float32, device=tokens.device)
    w[:, -1] = 0.0
    if loss_chunk and s % loss_chunk == 0 and s > loss_chunk:
        total = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for i in range(s // loss_chunk):
            sl = slice(i * loss_chunk, (i + 1) * loss_chunk)
            part = (checkpoint(_ce, head, x[:, sl], tgt[:, sl], w[:, sl], use_reentrant=False)
                    if torch.is_grad_enabled() else _ce(head, x[:, sl], tgt[:, sl], w[:, sl]))
            total = total + part
    else:
        total = _ce(head, x, tgt, w)
    return total / (b * (s - 1))


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


def lm_decode_step(cfg: LMConfig, params: Dict, cache: KVCache, tokens: torch.Tensor,
                   length: Union[int, torch.Tensor], moe_cap: float = 1.25
                   ) -> Tuple[torch.Tensor, KVCache]:
    """One decode step. tokens [B, 1]; length: the current cache fill (a
    scalar), the new token's position. The new K/V land in ``cache`` in
    place, at ``length`` clamped to ``[0, S - 1]``; attention reads the
    first ``length + 1`` positions (the window's last ones)."""
    b = tokens.shape[0]
    dev = tokens.device
    x = params["emb"][tokens]                                  # [B, 1, D]
    pos = torch.as_tensor(length, device=dev).reshape(1)       # position of the new token
    at = torch.clamp(pos, 0, cache.k.shape[2] - 1)
    for l in range(cfg.n_layers):
        lp = _layer_params(params, l)
        kc, vc = cache.k[l], cache.v[l]
        q, k, v = _qkv(cfg, lp, x, pos)
        kc.index_copy_(1, at, k.to(kc.dtype))
        vc.index_copy_(1, at, v.to(vc.dtype))
        o = decode_attention(q, kc, vc, pos + 1, window=cfg.swa_window)
        x = x + mixed_matmul(o.reshape(b, 1, -1), lp["wo"])
        x = _ffn(cfg, lp, x, moe_cap)
    x = _rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return mixed_matmul(x, _head(cfg, params))[:, 0], cache


def lm_prefill(cfg: LMConfig, params: Dict, tokens: torch.Tensor, attn_chunk: int = 512,
               moe_cap: float = 1.25) -> Tuple[torch.Tensor, KVCache]:
    """Prefill: tokens [B, S] -> (last-position logits, the filled cache in
    the stream's dtype)."""
    x = params["emb"][tokens]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    ks, vs = [], []
    for l in range(cfg.n_layers):
        x, k, v = _layer(cfg, _layer_params(params, l), x, pos, attn_chunk, moe_cap)
        ks.append(k.to(x.dtype))
        vs.append(v.to(x.dtype))
    x = _rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return mixed_matmul(x, _head(cfg, params))[:, -1], KVCache(torch.stack(ks),
                                                               torch.stack(vs))
