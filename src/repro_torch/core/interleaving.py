"""PICASSO Interleaving (paper §III-C), ``repro.core.interleaving`` in torch.

The reference pins K-Interleaving wave boundaries and the D-Interleaving
micro-batch handoff with XLA's ``optimization_barrier``, a scheduling hint
that is the identity on values. PyTorch runs eagerly in issue order on one
stream, so the barriers have nothing to pin and are the identity here too.
Overlap comes back with CUDA streams and events in a later slice of the
port.
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple, Union


def wave_barrier(values: Sequence[Any]) -> List[Any]:
    """Pin completion of a K-interleave wave: the identity in eager mode."""
    return list(values)


def pipeline_handoff(current: Any, prefetch: Any) -> Tuple[Any, Any]:
    """Two-slot D-Interleaving boundary (Fig. 8b): chunk i's dense-stage
    input and chunk i+1's just-issued forward. Issue order already pins the
    schedule in eager mode, so this is the identity."""
    return current, prefetch


def resolve_overlap(spec: Union[str, bool, None], n_micro: int) -> bool:
    """Map a ``TrainConfig.overlap`` spelling to a bool, once: ``'auto'`` /
    ``None`` is on exactly when the step has more than one micro-batch;
    ``'on'``/``'off'``/bools force it. Raises on anything else."""
    if spec is None or spec == "auto":
        return n_micro > 1
    if isinstance(spec, bool):
        return spec
    if spec == "on":
        return True
    if spec == "off":
        return False
    raise ValueError(f"overlap must be 'auto', 'on', 'off' or a bool; got {spec!r}")
