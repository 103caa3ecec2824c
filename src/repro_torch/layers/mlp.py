"""MLP tower and layer norm (``repro.layers.mlp`` in torch) over plain
parameter dicts ``{"l0": {"w": [d_in, d_out], "b": [d_out]}, ...}``, the
reference's layout. The initialisers take a ``torch.Generator`` or a
``core.jax_random.JaxKey`` (``rng``) and split it as the reference splits
its key.

Dense products stay ``torch.matmul``, as the reference leaves them to XLA.
TF32 is switched off for both matmuls and cuDNN so float32 products on the
card keep full float32 precision, like the reference: TF32 keeps about
three decimal digits and would break the 1e-5 parity with it.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.jax_random import Rng, rng_normal, rng_split
from repro_torch.dist.compat import Group, psum

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def init_linear(rng: Rng, d_in: int, d_out: int, device: torch.device,
                dtype=torch.float32) -> Dict:
    """``w`` normal with the float32 scale ``sqrt(2 / d_in)``, ``b`` zero."""
    w = rng_normal(rng_split(rng, 2)[0], (d_in, d_out), device, dtype)
    return {"w": w * float(np.sqrt(np.float32(2.0 / d_in))),
            "b": torch.zeros((d_out,), dtype=dtype, device=device)}


def linear(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def mixed_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as JAX computes it for operands of two dtypes: both promoted
    to their common dtype first (a float32 activation against a bfloat16
    weight is a float32 product)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def mixed_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` of two operands, promoted as ``mixed_matmul``."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def split_matmul(a: torch.Tensor, b: torch.Tensor, group: Optional[Group] = None
                 ) -> torch.Tensor:
    """``mixed_matmul(a, b)`` where ``b`` holds this rank's block of the
    contraction dim over ``group`` and ``a`` is whole on every rank: the
    rank's part of the contraction, psum'd over ``group`` (no autograd; a
    plain product without ``group``)."""
    if group is None:
        return mixed_matmul(a, b)
    n = b.shape[-2]
    return psum(mixed_matmul(a.narrow(-1, group.rank * n, n), b), group)


def init_mlp(rng: Rng, d_in: int, dims: Sequence[int], device: torch.device,
             dtype=torch.float32) -> Dict:
    params = {}
    d = d_in
    for i, h in enumerate(dims):
        rng, k = rng_split(rng, 2)
        params[f"l{i}"] = init_linear(k, d, h, device, dtype)
        d = h
    return params


def n_layers(p: Dict) -> int:
    return len([k for k in p if k.startswith("l")])


def mlp(p: Dict, x: torch.Tensor, act=torch.relu, final_act: bool = True) -> torch.Tensor:
    n = n_layers(p)
    for i in range(n):
        x = linear(p[f"l{i}"], x)
        if i < n - 1 or final_act:
            x = act(x)
    return x


def init_layernorm(d: int, device: torch.device, dtype=torch.float32) -> Dict:
    return {"g": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: Dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]
