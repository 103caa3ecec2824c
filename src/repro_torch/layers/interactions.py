"""Feature-interaction modules (``repro.layers.interactions`` in torch): the
FM interaction deepfm uses. The other interactions come with later slices.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops


def fm_interaction(fields: torch.Tensor, fused: Optional[bool] = None) -> torch.Tensor:
    """FM 2nd order over field embeddings [B, F, D] -> [B, 1]:
    0.5 * sum_d ((sum_f v)^2 - sum_f v^2), through ``ops.fm_interaction``."""
    return ops.fm_interaction(fields, fused=fused)
