"""Feature-interaction modules (``repro.layers.interactions`` in torch).

Each module is an initialiser and an apply function over a plain parameter
dict with the reference's layout. Inputs are per-field views of the packed
group outputs: pooled fields ``[B, D]``, sequence fields ``[B, L, D]``.

FM, DLRM's dots and the DCN-v2 cross layer go through ``kernels.ops`` (CUDA
kernels on the card). The sequence modules (SASRec self-attention, DIN
target attention, MIND capsules, the DIEN GRU, MMoE and CAN's co-action) are
plain torch, as the reference leaves them to XLA. They copy the reference
exactly, its quirks included: masks fill ``-1e9`` (a fully masked sample
gets uniform weights, not NaN), and ``gru`` is not a textbook GRU (its
candidate reuses the update gate's weight slice). The initialisers take a
``torch.Generator`` or a ``JaxKey`` (``core.jax_random``) and a device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.jax_random import (JaxKey, Rng, normal_on, prng_key, rng_normal,
                                         rng_split)
from repro_torch.kernels import ops
from repro_torch.layers.mlp import init_layernorm, init_linear, init_mlp, layernorm, linear, mlp

NEG = -1e9  # the reference's mask fill


# ---------------------------------------------------------------------------
# wide / FM family
# ---------------------------------------------------------------------------


def init_linear_terms(rng: Rng, n_fields: int, dim: int, device: torch.device,
                      dtype=torch.float32) -> Dict:
    return {"w": rng_normal(rng, (n_fields, dim), device, dtype) * 0.01}


def linear_terms(p: Dict, fields: torch.Tensor) -> torch.Tensor:
    """FM 1st order / wide part: sum_f <w_f, e_f>. fields: [B, F, D]."""
    return torch.einsum("bfd,fd->b", fields, p["w"])[:, None]


def fm_interaction(fields: torch.Tensor, fused: Optional[bool] = None) -> torch.Tensor:
    """FM 2nd order over field embeddings [B, F, D] -> [B, 1]:
    0.5 * sum_d ((sum_f v)^2 - sum_f v^2), through ``ops.fm_interaction``."""
    return ops.fm_interaction(fields, fused=fused)


def dot_interaction(fields: torch.Tensor, fused: Optional[bool] = None) -> torch.Tensor:
    """DLRM pairwise dots [B, F, D] -> [B, F*(F-1)/2], through
    ``ops.dot_interaction``."""
    return ops.dot_interaction(fields, fused=fused)


# ---------------------------------------------------------------------------
# DCN-v2 cross network
# ---------------------------------------------------------------------------


def init_cross(rng: Rng, d: int, n_layers: int, device: torch.device,
               dtype=torch.float32) -> Dict:
    """``{"l0": {"w": [d, d], "b": [d]}, ...}``, the reference's layout:
    ``w`` normal with scale ``1/sqrt(d)``, ``b`` zero."""
    ks = rng_split(rng, n_layers)
    return {f"l{i}": {"w": rng_normal(ks[i], (d, d), device, dtype) * (1.0 / d ** 0.5),
                      "b": torch.zeros((d,), dtype=dtype, device=device)}
            for i in range(n_layers)}


def cross_net(p: Dict, x0: torch.Tensor, fused: Optional[bool] = None) -> torch.Tensor:
    """x_{l+1} = x0 * (x_l W + b) + x_l (DCN-v2 full-rank), each layer
    through ``ops.cross_layer``."""
    x = x0
    for i in range(len(p)):
        x = ops.cross_layer(x0, x, p[f"l{i}"]["w"], p[f"l{i}"]["b"], fused=fused)
    return x


# ---------------------------------------------------------------------------
# sequence attention (SASRec / DIN)
# ---------------------------------------------------------------------------


def init_mha(rng: Rng, d: int, n_heads: int, device: torch.device,
             dtype=torch.float32) -> Dict:
    k = rng_split(rng, 4)
    s = 1.0 / np.sqrt(d)
    return {name: rng_normal(k[i], (d, d), device, dtype) * s
            for i, name in enumerate(("wq", "wk", "wv", "wo"))}


def mha(p: Dict, x: torch.Tensor, mask: torch.Tensor, n_heads: int,
        causal: bool = True) -> torch.Tensor:
    """x: [B, L, D]; mask: [B, L] validity. Masked logits are -1e9."""
    b, l, d = x.shape
    h = n_heads
    hd = d // h
    q, k, v = ((x @ p[w]).reshape(b, l, h, hd).transpose(1, 2) for w in ("wq", "wk", "wv"))
    logits = q @ k.transpose(-1, -2) / float(np.sqrt(hd))
    neg = torch.full((), NEG, dtype=logits.dtype, device=logits.device)
    logits = torch.where(mask[:, None, None, :], logits, neg)
    if causal:
        cm = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
        logits = torch.where(cm[None, None], logits, neg)
    a = torch.softmax(logits, dim=-1)
    o = (a @ v).transpose(1, 2).reshape(b, l, d)
    return o @ p["wo"]


def init_sasrec_block(rng: Rng, d: int, n_heads: int, device: torch.device,
                      dtype=torch.float32) -> Dict:
    k1, k2, k3 = rng_split(rng, 3)
    return {"ln1": init_layernorm(d, device, dtype),
            "attn": init_mha(k1, d, n_heads, device, dtype),
            "ln2": init_layernorm(d, device, dtype),
            "ff1": init_linear(k2, d, d, device, dtype),
            "ff2": init_linear(k3, d, d, device, dtype)}


def sasrec_block(p: Dict, x: torch.Tensor, mask: torch.Tensor, n_heads: int) -> torch.Tensor:
    h = mha(p["attn"], layernorm(p["ln1"], x), mask, n_heads, causal=True)
    x = x + h
    f = linear(p["ff2"], torch.relu(linear(p["ff1"], layernorm(p["ln2"], x))))
    return (x + f) * mask[..., None].to(x.dtype)


def init_self_attn_seq(rng: Rng, d: int, n_blocks: int, n_heads: int,
                       device: torch.device, dtype=torch.float32) -> Dict:
    ks = rng_split(rng, n_blocks)
    return {**{f"b{i}": init_sasrec_block(ks[i], d, n_heads, device, dtype)
               for i in range(n_blocks)},
            "ln_f": init_layernorm(d, device, dtype)}


def self_attn_seq(p: Dict, seq: torch.Tensor, mask: torch.Tensor,
                  n_heads: int = 1) -> torch.Tensor:
    """SASRec encoder: [B, L, D] -> [B, D] at the last valid position
    (``max(sum(mask) - 1, 0)``: position 0 for a fully masked sample)."""
    x = seq
    for i in range(len([k for k in p if k.startswith("b")])):
        x = sasrec_block(p[f"b{i}"], x, mask, n_heads)
    x = layernorm(p["ln_f"], x)
    idx = torch.clamp(mask.sum(dim=1).to(torch.int64) - 1, min=0)
    return x[torch.arange(x.shape[0], device=x.device), idx]


def init_target_attn(rng: Rng, d: int, device: torch.device, hidden: int = 36,
                     dtype=torch.float32) -> Dict:
    return {"mlp": init_mlp(rng, 4 * d, (hidden, 1), device, dtype)}


def target_attn(p: Dict, hist: torch.Tensor, target: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """DIN attention: weight(h) = MLP([h, t, h*t, h-t]); [B,L,D],[B,D] -> [B,D]."""
    t = target[:, None, :].expand_as(hist)
    feat = torch.cat([hist, t, hist * t, hist - t], dim=-1)
    w = mlp(p["mlp"], feat, final_act=False)[..., 0]           # [B, L]
    w = torch.where(mask, w, torch.full((), NEG, dtype=w.dtype, device=w.device))
    w = torch.softmax(w, dim=-1) * mask.to(w.dtype)
    return torch.einsum("bl,bld->bd", w, hist)


# ---------------------------------------------------------------------------
# MIND capsule routing
# ---------------------------------------------------------------------------

ROUTING_KEY = prng_key(17)  # the reference's fixed routing init, PRNGKey(17)


def init_capsule(rng: Rng, d: int, n_interests: int, device: torch.device,
                 dtype=torch.float32) -> Dict:
    return {"s": rng_normal(rng, (d, d), device, dtype) * (1.0 / np.sqrt(d))}


def _squash(v: torch.Tensor) -> torch.Tensor:
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    return (n2 / (1.0 + n2)) * v * torch.rsqrt(n2 + 1e-9)


def capsule_routing(p: Dict, hist: torch.Tensor, mask: torch.Tensor, iters: int,
                    key: JaxKey = ROUTING_KEY, n_interests: int = 4) -> torch.Tensor:
    """B2I dynamic routing: [B, L, D] -> [B, K, D] interest capsules. The
    routing logits start from ``jax.random.normal(key, (B, K, L))``, the
    reference's numbers (``core.jax_random``), drawn once per shape."""
    b, l, _ = hist.shape
    low = hist @ p["s"]                                         # [B, L, D]
    logits = normal_on(key, (b, n_interests, l), hist.device).to(low.dtype)
    neg = torch.full((), NEG, dtype=low.dtype, device=low.device)
    caps = None
    for _ in range(iters):
        w = torch.softmax(torch.where(mask[:, None, :], logits, neg), dim=-1)
        caps = _squash(torch.einsum("bkl,bld->bkd", w, low))
        logits = logits + torch.einsum("bkd,bld->bkl", caps, low)
    return caps


def label_aware_attn(interests: torch.Tensor, target: torch.Tensor,
                     pw: float = 2.0) -> torch.Tensor:
    """MIND label-aware attention: [B,K,D],[B,D] -> [B,D]."""
    s = torch.einsum("bkd,bd->bk", interests, target)
    w = torch.softmax(pw * s, dim=-1)
    return torch.einsum("bk,bkd->bd", w, interests)


# ---------------------------------------------------------------------------
# DIEN GRU / MMoE / CAN co-action
# ---------------------------------------------------------------------------


def init_gru(rng: Rng, d: int, device: torch.device, dtype=torch.float32) -> Dict:
    k1, k2 = rng_split(rng, 2)
    s = 1.0 / np.sqrt(d)
    return {"wx": rng_normal(k1, (d, 3 * d), device, dtype) * s,
            "wh": rng_normal(k2, (d, 3 * d), device, dtype) * s,
            "b": torch.zeros((3 * d,), dtype=dtype, device=device)}


def gru(p: Dict, seq: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, L, D] -> [B, D] final hidden state, the reference's recurrence as
    it stands: the candidate ``n`` reuses the ``z`` slice of ``wx`` and
    ``wh``, the third slice ``s`` is unused, a masked step keeps ``h``."""
    b, l, d = seq.shape
    h = torch.zeros((b, d), dtype=seq.dtype, device=seq.device)
    for t in range(l):
        x = seq[:, t]
        z, r, _ = torch.split(x @ p["wx"] + h @ p["wh"] + p["b"], d, dim=-1)
        z, r = torch.sigmoid(z), torch.sigmoid(r)
        n = torch.tanh(x @ p["wx"][:, :d] + (r * h) @ p["wh"][:, :d])
        h = torch.where(mask[:, t, None], (1 - z) * h + z * n, h)
    return h


def init_mmoe(rng: Rng, d_in: int, n_experts: int, expert_dim: int, n_tasks: int,
              device: torch.device, dtype=torch.float32) -> Dict:
    ks = rng_split(rng, n_experts + n_tasks)
    return {**{f"e{i}": init_mlp(ks[i], d_in, (expert_dim, expert_dim), device, dtype)
               for i in range(n_experts)},
            **{f"g{t}": init_linear(ks[n_experts + t], d_in, n_experts, device, dtype)
               for t in range(n_tasks)}}


def mmoe(p: Dict, x: torch.Tensor) -> List[torch.Tensor]:
    n_e = len([k for k in p if k.startswith("e")])
    n_t = len([k for k in p if k.startswith("g")])
    experts = torch.stack([mlp(p[f"e{i}"], x) for i in range(n_e)], dim=1)  # [B,E,H]
    return [torch.einsum("be,beh->bh", torch.softmax(linear(p[f"g{t}"], x), dim=-1), experts)
            for t in range(n_t)]


def coaction(hist: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
             layers: Tuple[int, ...] = (4, 4)) -> torch.Tensor:
    """CAN co-action unit: the target embedding, tiled up to the weights the
    layers need (``ceil(need / D)`` copies), is reshaped into MLP weights
    applied to the history, ``tanh`` after each layer ([B,L,D] x [B,D] ->
    [B, layers[-1]])."""
    b, _, d = hist.shape
    shapes, need, d_in = [], 0, d
    for h in layers:
        shapes.append((d_in, h))
        need += d_in * h
        d_in = h
    wflat = target.repeat(1, int(np.ceil(need / d)))[:, :need]
    x, off = hist, 0
    for di, do in shapes:
        w = wflat[:, off:off + di * do].reshape(b, di, do)
        off += di * do
        x = torch.tanh(torch.einsum("bld,bdo->blo", x, w))
    return (x * mask[..., None].to(x.dtype)).sum(dim=1)
