"""PICASSO Interleaving (paper §III-C), ``repro.core.interleaving`` in torch.

The reference pins K-Interleaving wave boundaries with XLA's
``optimization_barrier``, a scheduling hint that is the identity on values.
PyTorch runs eagerly in issue order on one stream, so the barrier has
nothing to pin and is the identity here too. Overlap across waves comes
back with CUDA streams and events in a later slice of the port.
"""
from __future__ import annotations

from typing import Any, List, Sequence


def wave_barrier(values: Sequence[Any]) -> List[Any]:
    """Pin completion of a K-interleave wave: the identity in eager mode."""
    return list(values)
