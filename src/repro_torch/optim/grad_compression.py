"""Gradient compression (``repro.optim.grad_compression`` in torch).

Two wire paths, two APIs:

**Dense DP all-reduce** (``compressed_psum``): the psum payload is rounded
to a narrow dtype (bf16 / fp16 / f8_e4m3) with error feedback: the rounding
residual comes back beside the sum. The reference's train step discards it,
so no error feedback carries across steps; the port's does the same.

**Routed sparse gradients** (``compress_rows`` / ``decompress_rows`` and
``compressed_all_gather``): the transposed Shuffle moves ``[world*cap, D]``
gradient rows every step; ``grad_compress`` modes shrink that payload and
expand it on the owner side:

``'none'``  -- passthrough (the default; bitwise-identical training).
``'fp16'``  -- per-row amax scale + float16 cast: about half the bytes,
              relative error about 2^-11 of the row max.
``'topk'``  -- per-row magnitude top-k (k = D // TOPK_FRACTION): only the
              heaviest coordinates travel, the rest are dropped.

Both modes compress all-zero rows to exact zeros, so padded bucket slots
survive the roundtrip bitwise, which the dedup + Adagrad behind the hop
relies on. The per-row kernels are ``kernels.ops``'s CUDA kernels for CUDA
tensors and their plain versions on the CPU (``fused=`` as on the sparse
hot path). Past world 1 the compressed payload is what crosses the wire
(``dist.compat``): the narrow dense payload is all_gathered and summed in
rank order in its narrow dtype, the routed payload tensors each ride the
collective. At world 1 every collective is the identity, but the lossy
roundtrip still runs, exactly where the reference runs it. Tier-maintenance
traffic (tier psums, flush reloads) stays exact: only the per-step routed
payload is compressed.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.dist.compat import Group, all_gather_tiled, psum, resolve_group
from repro_torch.kernels import ops
from repro_torch.optim.optimizers import tree_map

_DTYPES = {"none": None, "bf16": torch.bfloat16, "fp16": torch.float16,
           "f8": torch.float8_e4m3fn}
# float8_e4m3fn has no infinity. ml_dtypes (the reference's cast) rounds
# |x| up to 464, halfway from its largest finite 448 to 480, to 448 and
# turns anything past it, infinities included, into NaN; torch's cast
# saturates to +-448 instead, so the port sets those NaNs itself.
_F8_OVERFLOW = 464.0

# routed-path (sparse) modes; 'topk' keeps d // TOPK_FRACTION coords per row
ROUTED_MODES = ("none", "fp16", "topk")
TOPK_FRACTION = 4


def validate_dense_mode(mode: str) -> str:
    if mode not in _DTYPES:
        raise ValueError(f"grad_compression must be one of {tuple(_DTYPES)}; got {mode!r}")
    return mode


def _narrow_roundtrip(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``x.astype(dt).astype(float32)`` as the reference rounds it, f8
    overflow to NaN included."""
    q = x.to(dt).to(torch.float32)
    if dt == torch.float8_e4m3fn:
        q = torch.where(x.abs() > _F8_OVERFLOW, torch.full_like(q, float("nan")), q)
    return q


def _narrow_sum(q: torch.Tensor, dt: torch.dtype, group: Group) -> torch.Tensor:
    """The psum of a narrow payload ``q`` (float32 values of dtype ``dt``)
    with ``dt`` on the wire: every rank's payload is all_gathered in ``dt``
    and summed in rank order from zero, so every rank holds the same bits. The adds
    round as the reference's all-reduce of a narrow dtype does on the CPU:
    float16 rounds every partial sum to float16, bfloat16 and float8 keep
    the partial sums in float32 and round once."""
    if group.world == 1:
        return q
    parts = all_gather_tiled(q.to(dt), group).reshape((group.world,) + tuple(q.shape))
    s = torch.zeros(q.shape, dtype=torch.float32, device=q.device)  # -0.0 sums to +0.0
    for p in parts:
        s = s + p.to(torch.float32)
        if dt == torch.float16:
            s = _narrow_roundtrip(s, dt)
    return _narrow_roundtrip(s, dt)


def compressed_psum(grads: Any, world: int = 1, mode: str = "none",
                    residual: Optional[Any] = None,
                    group: Optional[Group] = None) -> Tuple[Any, Any]:
    """psum with the payload rounded to a narrow dtype + error feedback.

    Returns (summed grads fp32, new residual). ``'none'`` is the plain
    psum; otherwise the narrow payload crosses the wire (``_narrow_sum``).
    At world 1 the psum is the identity, so the sum is the rounded payload
    read back in float32."""
    grp = resolve_group(world, group)
    dt = _DTYPES[validate_dense_mode(mode)]
    if dt is None:
        if grp.world > 1:
            grads = tree_map(lambda g: psum(g, grp), grads)
        return grads, residual

    def one(g, r=None):
        # the reference adds a zero residual, which XLA folds away (a -0.0
        # gradient stays -0.0), so no residual means no addition here
        x = g if r is None else g + r
        q = _narrow_roundtrip(x, dt)   # the narrow payload, read back
        return _narrow_sum(q, dt, grp), x - q  # the sum, the error-feedback residual

    # tuples are leaves of a dict tree
    pairs = tree_map(one, grads) if residual is None else tree_map(one, grads, residual)
    return tree_map(lambda t: t[0], pairs), tree_map(lambda t: t[1], pairs)


# ---------------------------------------------------------------------------
# routed sparse-gradient payloads
# ---------------------------------------------------------------------------


class Fp16Rows(NamedTuple):
    """fp16 wire payload: scaled rows + their per-row fp32 scales."""

    q: torch.Tensor      # [m, D] float16, values in [-1, 1]
    scale: torch.Tensor  # [m, 1] float32 row amax


class TopkRows(NamedTuple):
    """topk wire payload: the k heaviest signed values + their columns."""

    vals: torch.Tensor  # [m, k]
    idx: torch.Tensor   # [m, k] int32


def topk_k(d: int) -> int:
    """Static per-row budget of the 'topk' mode."""
    return max(1, d // TOPK_FRACTION)


def validate_routed_mode(mode: str) -> str:
    if mode not in ROUTED_MODES:
        raise ValueError(
            f"grad_compress must be one of {ROUTED_MODES}; got {mode!r}")
    return mode


def compress_rows(g: torch.Tensor, mode: str, fused: Optional[bool] = None) -> Any:
    """``[m, D]`` gradient rows -> wire payload for ``mode``. Every payload
    tensor keeps the leading ``m`` dimension, so a row-preserving collective
    can move each of them and ``decompress_rows`` expand them after."""
    if mode == "none":
        return g
    if mode == "fp16":
        return Fp16Rows(*ops.compress_fp16(g, fused=fused))
    if mode == "topk":
        return TopkRows(*ops.compress_topk(g, topk_k(g.shape[-1]), fused=fused))
    raise ValueError(validate_routed_mode(mode))


def decompress_rows(payload: Any, d: int, mode: str,
                    fused: Optional[bool] = None) -> torch.Tensor:
    """Inverse of ``compress_rows``: wire payload -> ``[m, D]`` fp32 rows."""
    if mode == "none":
        return payload
    if mode == "fp16":
        return ops.decompress_fp16(payload.q, payload.scale, fused=fused)
    if mode == "topk":
        return ops.decompress_topk(payload.vals, payload.idx, d, fused=fused)
    raise ValueError(validate_routed_mode(mode))


def compressed_all_gather(g: torch.Tensor, world: int = 1, mode: str = "none",
                          fused: Optional[bool] = None,
                          group: Optional[Group] = None) -> torch.Tensor:
    """all_gather of gradient rows with the payload compressed on the wire.
    Every rank gathers the same payload tensors and decompresses them alike,
    so replica-consistent consumers stay consistent; at world 1 the gather
    is the identity and only the roundtrip remains. The ``ps`` and
    ``allgather_rows`` strategies' backward moves its grads through it."""
    grp = resolve_group(world, group)
    if mode == "none":
        return all_gather_tiled(g, grp)
    payload = compress_rows(g, mode, fused=fused)
    payload = type(payload)(*(all_gather_tiled(x, grp) for x in payload))
    return decompress_rows(payload, g.shape[-1], mode, fused=fused)
