"""MLP tower (``repro.layers.mlp`` in torch) over plain parameter dicts
``{"l0": {"w": [d_in, d_out], "b": [d_out]}, ...}``, the reference's layout.

Dense products stay ``torch.matmul``, as the reference leaves them to XLA.
TF32 is switched off for both matmuls and cuDNN so float32 products on the
card keep full float32 precision, like the reference: TF32 keeps about
three decimal digits and would break the 1e-5 parity with it.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def init_linear(generator: torch.Generator, d_in: int, d_out: int,
                device: torch.device, dtype=torch.float32) -> Dict:
    w = torch.randn((d_in, d_out), generator=generator, dtype=dtype, device=device)
    return {"w": w * (2.0 / d_in) ** 0.5,
            "b": torch.zeros((d_out,), dtype=dtype, device=device)}


def linear(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def init_mlp(generator: torch.Generator, d_in: int, dims: Sequence[int],
             device: torch.device, dtype=torch.float32) -> Dict:
    params = {}
    d = d_in
    for i, h in enumerate(dims):
        params[f"l{i}"] = init_linear(generator, d, h, device, dtype)
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
