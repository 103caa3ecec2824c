"""Mesh shapes for one process per rank (``repro.launch.mesh`` in torch).

The reference's mesh names ``("data", "model")`` axes over its devices and
runs every collective over all of them, so a rank is one device of a flat
world: ``world = prod(shape)``, and rank ``r`` sits at the row-major
coordinates ``divmod(r, shape[1])``, as ``lax.axis_index(("data",
"model"))`` numbers the mesh. ``mesh_world`` and ``rank_coords`` live in
``dist.compat`` (its ``axis_groups`` lays a mesh over a group) and are
re-exported here.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.dist.compat import mesh_world, rank_coords

__all__ = ["AXES", "describe", "mesh_world", "parse_mesh", "rank_coords"]

AXES = ("data", "model")


def parse_mesh(spec: str, devices: int = 0) -> Tuple[int, ...]:
    """``--mesh``/``--devices`` as the reference's launchers read them:
    ``'4x2'`` -> ``(4, 2)``, ``'4'`` -> ``(4,)``; no ``--mesh`` is
    ``(devices, 1)`` (``(1, 1)`` without ``--devices``). A ``--devices``
    count that differs from the mesh's size raises."""
    if spec:
        shape = tuple(int(x) for x in spec.lower().split("x"))
        if not shape or any(s < 1 for s in shape) or len(shape) > len(AXES):
            raise ValueError(f"--mesh {spec!r}: one or two positive sizes, e.g. 4x2 or 4")
    else:
        shape = (max(int(devices), 1), 1)
    if devices and mesh_world(shape) != int(devices):
        raise ValueError(f"--mesh {spec} has {mesh_world(shape)} ranks but --devices "
                         f"{devices}")
    return shape


def describe(shape: Optional[Tuple[int, ...]]) -> str:
    return "x".join(str(s) for s in shape) if shape else "1x1"
