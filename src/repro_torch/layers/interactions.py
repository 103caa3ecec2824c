"""Feature-interaction modules (``repro.layers.interactions`` in torch): the
FM interaction deepfm uses, DLRM's pairwise dots and the DCN-v2 cross
network. The other interactions come with later slices.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import ops


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


def init_cross(generator: torch.Generator, d: int, n_layers: int, device: torch.device,
               dtype=torch.float32) -> Dict:
    """``{"l0": {"w": [d, d], "b": [d]}, ...}``, the reference's layout:
    ``w`` normal with scale ``1/sqrt(d)``, ``b`` zero."""
    return {f"l{i}": {"w": torch.randn((d, d), generator=generator, dtype=dtype,
                                       device=device) * (1.0 / d ** 0.5),
                      "b": torch.zeros((d,), dtype=dtype, device=device)}
            for i in range(n_layers)}


def cross_net(p: Dict, x0: torch.Tensor, fused: Optional[bool] = None) -> torch.Tensor:
    """x_{l+1} = x0 * (x_l W + b) + x_l (DCN-v2 full-rank), each layer
    through ``ops.cross_layer``."""
    x = x0
    for i in range(len(p)):
        x = ops.cross_layer(x0, x, p[f"l{i}"]["w"], p[f"l{i}"]["b"], fused=fused)
    return x
