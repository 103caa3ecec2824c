"""Dispatch wrappers for the port's CUDA kernels (``repro.kernels.ops`` in
torch).

Every wrapper takes ``fused=``: ``None`` follows the tensors (the CUDA
kernel for tensors on the card, the plain version in ``kernels.ref`` for
tensors on the CPU), ``True`` forces the kernel and raises for CPU tensors,
``False`` forces the plain version. ``resolve_fused`` maps the user-facing
``use_fused_kernels`` spelling (``'auto' | 'on' | 'off' | bool``) to that
override once, at engine construction. There is no silent fallback: a
kernel that does not build or launch raises.

Each wrapper adds one to ``launches[name]`` where it launches its kernel and
nowhere else, so a run can show that its main path went through the
kernels (``reset_launches`` before, read after).

``gather_pool`` is a ``torch.autograd.Function`` like the reference's
``jax.custom_vjp``; its backward (the ``segment_grad`` transpose) belongs to
the training slice and raises until then. Serving needs no gradient.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch.kernels import build, ref

launches: Dict[str, int] = {"tier_probe": 0, "gather_pool": 0, "fm_interaction": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def resolve_fused(spec: Union[str, bool, None]) -> Optional[bool]:
    """``'auto'``/``None`` -> ``None`` (kernel exactly where the tensors are
    on CUDA); ``'on'``/``True`` -> ``True``; ``'off'``/``False`` ->
    ``False``. Raises on anything else so typos fail at construction."""
    if spec is None or spec == "auto":
        return None
    if isinstance(spec, bool):
        return spec
    if spec == "on":
        return True
    if spec == "off":
        return False
    raise ValueError(
        f"use_fused_kernels must be 'auto', 'on', 'off' or a bool; got {spec!r}")


def _use_kernel(fused: Optional[bool], t: torch.Tensor, op: str) -> bool:
    if fused is None:
        return t.is_cuda
    if fused and not t.is_cuda:
        raise ValueError(f"{op}: fused kernels need CUDA tensors, got {t.device}")
    return bool(fused)


def _expect(t: torch.Tensor, what: str, dtype: torch.dtype, ndim: int,
            device: torch.device) -> None:
    if t.dtype != dtype or t.dim() != ndim or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{what}: want a contiguous {ndim}-d {dtype} tensor on {device}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def _launch(name: str, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    rc = build.launcher(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (cudaError {rc})")
    launches[name] += 1


# ---------------------------------------------------------------- tier probe


def _tier_probe_cuda(uniq, uvalid, keys, rows):
    dev = rows.device
    _expect(uniq, "tier_probe uniq", torch.int32, 1, dev)
    _expect(uvalid, "tier_probe uvalid", torch.bool, 1, dev)
    _expect(keys, "tier_probe keys", torch.int32, 1, dev)
    _expect(rows, "tier_probe rows", torch.float32, 2, dev)
    n = uniq.shape[0]
    h, d = rows.shape
    if uvalid.shape[0] != n or keys.shape[0] != h or h == 0:
        raise ValueError(f"tier_probe: uniq {n}, uvalid {uvalid.shape[0]}, "
                         f"keys {keys.shape[0]}, rows {h}x{d} (need H > 0)")
    hit = torch.empty((n,), dtype=torch.bool, device=dev)
    slot = torch.empty((n,), dtype=torch.int32, device=dev)
    out = torch.empty((n, d), dtype=rows.dtype, device=dev)
    if n:
        _launch("tier_probe", uniq.data_ptr(), uvalid.data_ptr(), keys.data_ptr(),
                rows.data_ptr(), hit.data_ptr(), slot.data_ptr(), out.data_ptr(),
                n, h, d)
    return hit, slot, out


def tier_probe(uniq, uvalid, keys, rows, fused: Optional[bool] = None):
    """Probe one sorted-key cache tier: ``(hit, slot, rows)`` with miss rows
    exactly zero and ``slot`` the clamped searchsorted position."""
    if _use_kernel(fused, rows, "tier_probe"):
        return _tier_probe_cuda(uniq, uvalid, keys, rows)
    return ref.tier_probe_ref(uniq, uvalid, keys, rows)


# --------------------------------------------------------------- gather pool


def _gather_pool_cuda(rows_u, inv, weights, seg, n_bags: int):
    dev = rows_u.device
    _expect(rows_u, "gather_pool rows_u", torch.float32, 2, dev)
    _expect(inv, "gather_pool inv", torch.int32, 1, dev)
    _expect(weights, "gather_pool weights", torch.float32, 1, dev)
    _expect(seg, "gather_pool seg", torch.int32, 1, dev)
    n = inv.shape[0]
    if weights.shape[0] != n or seg.shape[0] != n:
        raise ValueError(f"gather_pool: inv {n}, weights {weights.shape[0]}, "
                         f"seg {seg.shape[0]} must match")
    d = rows_u.shape[1]
    if max(n, n_bags) >= 2**31 - 1 or d > 1024:
        raise ValueError(f"gather_pool: n={n}, n_bags={n_bags}, D={d} exceed the "
                         "kernel's int32 offsets or its 1024-thread block")
    out = torch.empty((n_bags, d), dtype=rows_u.dtype, device=dev)
    if n_bags and d:
        offsets = torch.empty((n_bags + 1,), dtype=torch.int32, device=dev)
        _launch("gather_pool", rows_u.data_ptr(), inv.data_ptr(), weights.data_ptr(),
                seg.data_ptr(), offsets.data_ptr(), out.data_ptr(), n, n_bags, d)
    return out


class _GatherPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows_u, inv, weights, seg, n_bags: int, use_kernel: bool):
        if use_kernel:
            return _gather_pool_cuda(rows_u, inv, weights, seg, n_bags)
        return ref.gather_pool_ref(rows_u, inv, weights, seg, n_bags)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError("segment_grad: next slice")


def gather_pool(rows_u, inv, weights, seg, n_bags: int,
                fused: Optional[bool] = None):
    """Fused forward SegmentReduction ``bags[seg] += w * rows_u[inv]``.
    Requires ``seg`` sorted ascending; a bag no position maps to is 0."""
    return _GatherPool.apply(rows_u, inv, weights, seg, int(n_bags),
                             _use_kernel(fused, rows_u, "gather_pool"))


# ------------------------------------------------------------ fm interaction


def _fm_interaction_cuda(fields):
    _expect(fields, "fm_interaction fields", torch.float32, 3, fields.device)
    b, f, d = fields.shape
    out = torch.empty((b, 1), dtype=fields.dtype, device=fields.device)
    if b:
        _launch("fm_interaction", fields.data_ptr(), out.data_ptr(), b, f, d)
    return out


def fm_interaction(fields, fused: Optional[bool] = None):
    """FM second order over field embeddings ``[B, F, D] -> [B, 1]``."""
    if _use_kernel(fused, fields, "fm_interaction"):
        return _fm_interaction_cuda(fields)
    return ref.fm_interaction_ref(fields)
