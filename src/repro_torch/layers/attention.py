"""GQA attention with RoPE, causal/sliding-window masking, chunked prefill
(static q-chunks with exact per-chunk K ranges) and KV-cache decode
(``repro.layers.attention`` in torch).

Plain torch, term by term the reference's: float32 logits, a ``-1e30``
mask, the softmax's weights cast to ``v``'s dtype. Operands of mixed
dtypes promote as JAX promotes them (``mlp.mixed_einsum``): a float32
activation against a bfloat16 cache computes in float32.

Past world 1 the decode cache is sharded along S over ``"model"``
(``repro.launch.cells._cache_specs``), and GSPMD turns the reference's
softmax over it into a split-K combine; ``decode_attention(group=,
offset=)`` writes that combine out (flash-decoding): the global max of
the logits, then psums of each rank's sum of exponentials and of its
weighted values, masks on global positions.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.dist.compat import Group, psum
from repro_torch.dist.spmd import gather_along
from repro_torch.layers.mlp import mixed_einsum


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; pos: [S] (or [B, S])."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # [hd/2]
    ang = pos[..., :, None].to(torch.float32) * freqs          # [..., S, hd/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.dim() == 4 and ang.dim() == 2:                        # [B,S,H,hd] with pos [S]
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    elif x.dim() == 4:                                         # pos [B,S]
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    xr1 = x1 * cos - x2 * sin
    xr2 = x1 * sin + x2 * cos
    out = torch.stack([xr1, xr2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q: [B,Sq,H,hd], k/v: [B,Sk,G,hd] grouped KV; returns [B,Sq,H,hd]."""
    b, sq, h, hd = q.shape
    g = k.shape[2]
    rep = h // g
    qg = q.reshape(b, sq, g, rep, hd)
    logits = mixed_einsum("bsgrd,btgd->bgrst", qg, k).to(torch.float32)
    # the reference divides by a numpy float64, which JAX makes float32
    logits = logits / float(np.float32(np.sqrt(hd)))
    if mask is not None:
        logits = torch.where(mask, logits, torch.tensor(-1e30, dtype=torch.float32,
                                                        device=logits.device))
    a = torch.softmax(logits, dim=-1).to(v.dtype)
    o = mixed_einsum("bgrst,btgd->bsgrd", a, v)
    return o.reshape(b, sq, h, hd)


def chunked_causal_attention(
    q: torch.Tensor,          # [B, S, H, hd]
    k: torch.Tensor,          # [B, S, G, hd]
    v: torch.Tensor,          # [B, S, G, hd]
    chunk: int = 512,
    window: Optional[int] = None,   # sliding-window attention width
) -> torch.Tensor:
    """Causal (optionally sliding-window) attention over static q-chunks,
    each against the K range it can see (aligned down to a chunk), so the
    [S, S] score matrix is never materialized (peak is [chunk, Kspan]).
    With ``s <= chunk`` or ``s % chunk`` one full masked matrix."""
    b, s, h, hd = q.shape
    dev = q.device
    if s <= chunk or s % chunk != 0:
        pos = torch.arange(s, device=dev)
        m = pos[:, None] >= pos[None, :]
        if window is not None:
            m &= pos[:, None] - pos[None, :] < window
        return _sdpa(q, k, v, m[None, None, None, :, :])
    outs = []
    for i in range(s // chunk):
        q_i = q[:, i * chunk:(i + 1) * chunk]
        hi = (i + 1) * chunk
        lo = 0 if window is None else max(0, hi - window - chunk + 1)
        lo = (lo // chunk) * chunk  # align for static shapes
        k_i, v_i = k[:, lo:hi], v[:, lo:hi]
        qpos = i * chunk + torch.arange(chunk, device=dev)
        kpos = lo + torch.arange(hi - lo, device=dev)
        m = qpos[:, None] >= kpos[None, :]
        if window is not None:
            m &= qpos[:, None] - kpos[None, :] < window
        outs.append(_sdpa(q_i, k_i, v_i, m[None, None, None, :, :]))
    return torch.cat(outs, dim=1)


def decode_attention(
    q: torch.Tensor,          # [B, 1, H, hd]
    k_cache: torch.Tensor,    # [B, S, G, hd]
    v_cache: torch.Tensor,    # [B, S, G, hd]
    length: Union[int, torch.Tensor],   # [] or [B] valid cache length
    window: Optional[int] = None,
    group: Optional[Group] = None,
    offset: int = 0,
) -> torch.Tensor:
    """One-token decode against the KV cache: positions ``< length`` (and,
    with a window, ``>= length - window``) are valid. With ``group`` past
    world 1 the cache holds this rank's positions ``offset + [0, S)`` of a
    cache sharded along S, and the softmax combines across the group."""
    b, s, g, hd = k_cache.shape
    pos = offset + torch.arange(s, device=k_cache.device)
    ln = torch.as_tensor(length, device=k_cache.device).reshape(-1, 1)
    valid = pos[None, :] < ln
    if window is not None:
        valid &= pos[None, :] >= ln - window
    mask = valid[:, None, None, None, :]                   # [B,1,1,1,S]
    if group is None or group.world == 1:
        return _sdpa(q, k_cache, v_cache, mask)
    h = q.shape[2]
    qg = q.reshape(b, 1, g, h // g, hd)
    logits = mixed_einsum("bsgrd,btgd->bgrst", qg, k_cache).to(torch.float32)
    logits = logits / float(np.float32(np.sqrt(hd)))
    logits = torch.where(mask, logits, torch.tensor(-1e30, dtype=torch.float32,
                                                    device=logits.device))
    top = gather_along(logits.amax(-1, keepdim=True)[None], group, 0).amax(0)
    e = torch.exp(logits - top)
    denom = psum(e.sum(-1, keepdim=True), group)               # [B,g,r,1,1]
    o = psum(mixed_einsum("bgrst,btgd->bgrsd", e, v_cache), group) / denom
    return o.permute(0, 3, 1, 2, 4).reshape(b, 1, h, hd).to(v_cache.dtype)
