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
kernels (``reset_launches`` before, read after); ``sorts`` counts the sorts
a wrapper runs on the card before its kernel (``segment_grad`` called
without the forward's permutation).

``gather_pool``, ``fm_interaction``, ``dot_interaction``, ``cross_layer``
and ``gather_project`` are ``torch.autograd.Function``s like the reference's
``jax.custom_vjp``s: their backwards are the ``segment_grad``,
``fm_interaction_bwd``, ``dot_interaction_bwd``, ``cross_layer_bwd`` and
``gather_project_grad`` kernels for CUDA tensors and the plain versions for
CPU tensors. ``segment_grad`` and ``dedup_adagrad``
are also standalone ops for the engine's explicit backward, and
``gather_project_grad`` a standalone op as in the reference (the engine
folds the narrow cotangent itself); ``dedup_adagrad`` updates the table and
accumulator it is given in place.

Host-resident operands (``--pin-l2``): ``tier_probe``'s ``keys``/``rows``
and ``dedup_adagrad``'s ``w``/``acc`` may be CPU tensors in mapped pinned
memory (``kernels.host_memory``), which the kernels read and write in place
over the bus; ``take_rows``/``put_rows`` gather and scatter the rows of such
a table (``csrc/host_rows.cu``). Those wrappers follow their compute operand
(the ids, the gradient, the indices), never the table, so ``fused=None``
with a pinned table and ids on the card launches the kernel; the plain
version raises on the card given a host-resident table rather than staging
it. Any other CPU operand beside CUDA ones raises.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch

from repro_torch.kernels import build, host_memory, ref

launches: Dict[str, int] = {"tier_probe": 0, "gather_pool": 0, "fm_interaction": 0,
                            "segment_grad": 0, "dedup_adagrad": 0,
                            "fm_interaction_bwd": 0, "cross_layer": 0,
                            "cross_layer_bwd": 0, "gather_project": 0,
                            "gather_project_grad": 0, "fp16_compress": 0,
                            "fp16_decompress": 0, "topk_compress": 0,
                            "topk_decompress": 0, "dot_interaction": 0,
                            "dot_interaction_bwd": 0, "host_rows": 0}


# sorts a wrapper ran on the card before its kernel: ``segment_grad`` sorts
# only when it is called without the forward's permutation
sorts: Dict[str, int] = {"segment_grad": 0}
# the launches (of ``launches``) given a host-resident operand (--pin-l2)
host_launches: Dict[str, int] = {"tier_probe": 0, "dedup_adagrad": 0, "host_rows": 0}


def reset_launches() -> None:
    for counts in (launches, sorts, host_launches):
        for name in counts:
            counts[name] = 0


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
            device: torch.device, host: bool = False) -> int:
    """Check ``t`` and return the address its kernel takes. ``host`` also
    accepts a CPU tensor in mapped pinned memory (its device address)."""
    on_host = host and t.device.type == "cpu" and device.type == "cuda"
    if (t.dtype != dtype or t.dim() != ndim or (t.device != device and not on_host)
            or not t.is_contiguous()):
        raise ValueError(
            f"{what}: want a contiguous {ndim}-d {dtype} tensor on {device}"
            f"{' or in mapped pinned host memory' if host else ''}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device} "
            f"(contiguous={t.is_contiguous()})")
    return host_memory.device_pointer(t, what) if on_host else t.data_ptr()


def _plain_on_host(compute: torch.Tensor, op: str, *tables: torch.Tensor) -> None:
    """The plain versions compute where the tensors are: on the card they
    refuse a host-resident table instead of staging it over the bus."""
    if compute.is_cuda and any(t.device.type == "cpu" for t in tables):
        raise ValueError(f"{op}: the plain version does not read a host-resident "
                         "table from the card; use the kernel (fused='auto' or 'on')")


def _launch(name: str, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    rc = build.launcher(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (cudaError {rc})")
    launches[name] += 1


# ---------------------------------------------------------------- tier probe


_SM_COUNTS: Dict[int, int] = {}


def sm_count(device) -> int:
    """SMs of the card ``device`` lies on (132 on an H100 SXM), which the
    launch plans below fill."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _SM_COUNTS:
        _SM_COUNTS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNTS[idx]


# threads an SM of tier_probe's k-ary search keeps busy: 40 of its 64 warps
# (more lanes a query past that were slower at every path shape the bench
# script's --sweep timed on the H100)
PROBE_SM_THREADS = 1280


def tier_probe_plan(n: int, sms: int) -> int:
    """Lanes a query of the ``tier_probe`` kernel for ``n`` queries on a
    card of ``sms`` SMs: the most (a power of two up to a warp) for which
    all ``n * lanes`` threads fit in ``PROBE_SM_THREADS`` on each SM.
    ``1`` is the ranged search (bulk)."""
    lanes = 32
    while lanes > 1 and n * lanes > sms * PROBE_SM_THREADS:
        lanes //= 2
    return lanes


def _tier_probe_cuda(uniq, uvalid, keys, rows):
    dev = uniq.device
    _expect(uniq, "tier_probe uniq", torch.int32, 1, dev)
    _expect(uvalid, "tier_probe uvalid", torch.bool, 1, dev)
    keys_p = _expect(keys, "tier_probe keys", torch.int32, 1, dev, host=True)
    rows_p = _expect(rows, "tier_probe rows", torch.float32, 2, dev, host=True)
    n = uniq.shape[0]
    h, d = rows.shape
    if uvalid.shape[0] != n or keys.shape[0] != h or h == 0:
        raise ValueError(f"tier_probe: uniq {n}, uvalid {uvalid.shape[0]}, "
                         f"keys {keys.shape[0]}, rows {h}x{d} (need H > 0)")
    hit = torch.empty((n,), dtype=torch.bool, device=dev)
    slot = torch.empty((n,), dtype=torch.int32, device=dev)
    out = torch.empty((n, d), dtype=rows.dtype, device=dev)
    if n:
        _launch("tier_probe", uniq.data_ptr(), uvalid.data_ptr(), keys_p,
                rows_p, hit.data_ptr(), slot.data_ptr(), out.data_ptr(),
                n, h, d, tier_probe_plan(n, sm_count(dev)))
        host_launches["tier_probe"] += keys.device != dev or rows.device != dev
    return hit, slot, out


def tier_probe(uniq, uvalid, keys, rows, fused: Optional[bool] = None):
    """Probe one sorted-key cache tier: ``(hit, slot, rows)`` with miss rows
    exactly zero and ``slot`` the clamped searchsorted position. ``keys`` and
    ``rows`` may be host-resident (the module docstring)."""
    if _use_kernel(fused, uniq, "tier_probe"):
        return _tier_probe_cuda(uniq, uvalid, keys, rows)
    _plain_on_host(uniq, "tier_probe", keys, rows)
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
    if max(n, n_bags) >= 2**31 - 1:
        raise ValueError(f"gather_pool: n={n}, n_bags={n_bags} exceed the kernel's "
                         "int32 positions and bags")
    out = torch.empty((n_bags, d), dtype=rows_u.dtype, device=dev)
    if n_bags and d:  # one launch, no scratch
        _launch("gather_pool", rows_u.data_ptr(), inv.data_ptr(), weights.data_ptr(),
                seg.data_ptr(), out.data_ptr(), n, n_bags, d)
    return out


class _GatherPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows_u, inv, weights, seg, n_bags: int, use_kernel: bool):
        ctx.save_for_backward(inv, weights, seg)
        ctx.n_rows, ctx.use_kernel = rows_u.shape[0], use_kernel
        if use_kernel:
            return _gather_pool_cuda(rows_u, inv, weights, seg, n_bags)
        return ref.gather_pool_ref(rows_u, inv, weights, seg, n_bags)

    @staticmethod
    def backward(ctx, g):
        inv, weights, seg = ctx.saved_tensors
        g = g.contiguous()
        if ctx.use_kernel:
            g_rows = _segment_grad_cuda(g, seg, weights, inv, ctx.n_rows)
        else:
            g_rows = ref.segment_grad_ref(g, seg, weights, inv, ctx.n_rows)
        # the weights are pooling constants (the reference's zero cotangent)
        return g_rows, None, None, None, None, None


def gather_pool(rows_u, inv, weights, seg, n_bags: int,
                fused: Optional[bool] = None):
    """Fused forward SegmentReduction ``bags[seg] += w * rows_u[inv]``.
    Requires ``seg`` sorted ascending; a bag no position maps to is 0."""
    return _GatherPool.apply(rows_u, inv, weights, seg, int(n_bags),
                             _use_kernel(fused, rows_u, "gather_pool"))


# -------------------------------------------------------------- segment grad


SEGMENT_GRAD_BUF_FLOATS, SEGMENT_GRAD_MAX_CHUNK = 8192, 512


def segment_grad_plan(n: int, d: int, sms: int) -> Tuple[int, int]:
    """``(tile, chunk)`` of the ``segment_grad`` kernel for ``n`` positions
    of width ``d`` on a card of ``sms`` SMs: ``tile`` sorted positions a
    block owns (the largest power of two <= 256 that still gives each SM a
    block, at least 16, and no more than a buffer holds) and ``chunk``
    positions a staging buffer of 8,192 products holds (at most 512), so
    that the block's shared memory, which the launcher sizes from both,
    stays under the 48 KB a block gets unasked. The bench script's
    ``--sweep`` times the other tiles and chunks."""
    chunk = max(1, min(SEGMENT_GRAD_MAX_CHUNK, SEGMENT_GRAD_BUF_FLOATS // d))
    tile = 256
    while tile > 16 and -(-n // tile) < sms:
        tile //= 2
    return min(tile, chunk), chunk


def _segment_grad_cuda(g_bags, seg, weights, inv, n_rows: int, order=None,
                       sorted_inv=None):
    dev = g_bags.device
    _expect(g_bags, "segment_grad g_bags", torch.float32, 2, dev)
    _expect(seg, "segment_grad seg", torch.int32, 1, dev)
    _expect(weights, "segment_grad weights", torch.float32, 1, dev)
    _expect(inv, "segment_grad inv", torch.int32, 1, dev)
    n = inv.shape[0]
    if weights.shape[0] != n or seg.shape[0] != n:
        raise ValueError(f"segment_grad: inv {n}, weights {weights.shape[0]}, "
                         f"seg {seg.shape[0]} must match")
    if (order is None) != (sorted_inv is None):
        raise ValueError("segment_grad: pass both order and sorted_inv, or neither")
    if order is not None:
        _expect(order, "segment_grad order", torch.int64, 1, dev)
        _expect(sorted_inv, "segment_grad sorted_inv", torch.int32, 1, dev)
        if order.shape[0] != n or sorted_inv.shape[0] != n:
            raise ValueError(f"segment_grad: order {order.shape[0]} and sorted_inv "
                             f"{sorted_inv.shape[0]} must match inv {n}")
    d = g_bags.shape[1]
    if max(n, n_rows, g_bags.shape[0]) >= 2**31 - 1 or d > 1024:
        raise ValueError(f"segment_grad: n={n}, n_rows={n_rows}, D={d} exceed the "
                         "kernel's int32 positions or its 1024 columns")
    out = torch.empty((n_rows, d), dtype=g_bags.dtype, device=dev)
    if n_rows and d:
        if order is None:
            # stable: a slot's positions keep their original (segment_sum) order
            sorted_inv, order = torch.sort(inv, stable=True)
            sorts["segment_grad"] += 1
        _launch("segment_grad", g_bags.data_ptr(), seg.data_ptr(), weights.data_ptr(),
                order.data_ptr(), sorted_inv.data_ptr(), out.data_ptr(), n, n_rows, d,
                *segment_grad_plan(n, d, sm_count(dev)))
    return out


def segment_grad(g_bags, seg, weights, inv, n_rows: int,
                 fused: Optional[bool] = None, order=None, sorted_inv=None):
    """Transpose of ``gather_pool`` as a standalone op (the engine's explicit
    backward): ``g_rows[u] = sum_{inv[i]=u} w[i] * g_bags[seg[i]]`` for
    ``u < n_rows``; slots no position maps to are exactly 0. ``order`` (a
    stable argsort of ``inv``, int64) and ``sorted_inv`` (``inv[order]``,
    int32) are the forward unique's permutation; given them, the kernel
    runs without a sort. Without them it sorts first (``sorts``)."""
    if _use_kernel(fused, g_bags, "segment_grad"):
        return _segment_grad_cuda(g_bags, seg, weights, inv, int(n_rows), order,
                                  sorted_inv)
    return ref.segment_grad_ref(g_bags, seg, weights, inv, int(n_rows), order, sorted_inv)


# ------------------------------------------------------------- dedup adagrad


def dedup_scratch(m: int) -> Tuple[int, int]:
    """``(cap, ints)`` of the dedup kernels' int32 scratch for ``m``
    gradient rows: a hash table of ``cap`` two-int slots (``cap`` the least
    power of two >= 2m, so linear probing always finds a free slot), then
    the per-position ``next`` and ``slot_of`` lists."""
    cap = 1 << max(2 * m - 1, 1).bit_length()
    return cap, 2 * cap + 2 * m


def _dedup_adagrad_cuda(w, acc, idx, g, valid, lr: float, eps: float):
    dev = g.device
    w_p = _expect(w, "dedup_adagrad w", torch.float32, 2, dev, host=True)
    acc_p = _expect(acc, "dedup_adagrad acc", torch.float32, 2, dev, host=True)
    _expect(idx, "dedup_adagrad idx", torch.int32, 1, dev)
    _expect(g, "dedup_adagrad g", torch.float32, 2, dev)
    _expect(valid, "dedup_adagrad valid", torch.bool, 1, dev)
    rows, d = w.shape
    m = idx.shape[0]
    if tuple(acc.shape) != (rows, 1) or tuple(g.shape) != (m, d) or valid.shape[0] != m:
        raise ValueError(f"dedup_adagrad: w {tuple(w.shape)}, acc {tuple(acc.shape)}, "
                         f"idx {m}, g {tuple(g.shape)}, valid {valid.shape[0]}")
    if rows >= 2**31 - 1 or m >= 2**30 or not 0 < d <= 128:
        raise ValueError(f"dedup_adagrad: rows={rows}, m={m}, D={d}: row + 1 must fit "
                         "int32, the hash table 2^31 slots, and the warp covers D <= 128")
    if m:
        # a memset and two kernels: the table is cleared, filled, then read
        cap, ints = dedup_scratch(m)
        scratch = torch.empty((ints,), dtype=torch.int32, device=dev)
        _launch("dedup_adagrad", w_p, acc_p, idx.data_ptr(),
                valid.data_ptr(), g.data_ptr(), scratch.data_ptr(), scratch.numel(), m,
                rows, d, cap, float(lr), float(eps))
        host_launches["dedup_adagrad"] += w.device != dev or acc.device != dev
    return w, acc


def dedup_adagrad(w, acc, idx, g, valid, lr: float, eps: float,
                  fused: Optional[bool] = None):
    """Sum duplicate row grads and apply row-wise adagrad to the touched rows
    of ``(w, acc)``, in place on the tensors given; returns them. Duplicates
    are summed in ascending position order from +0.0 (the reference's
    stable-sorted order; the kernel groups them by hashing, without a sort):
    untouched rows stay bitwise unchanged, touched rows match the plain
    version to about 1 ULP of the adagrad arithmetic. ``w`` and ``acc`` may
    be host-resident (the module docstring): the kernel's atomics work on
    its device scratch only, and it writes the rows with plain stores."""
    if _use_kernel(fused, g, "dedup_adagrad"):
        return _dedup_adagrad_cuda(w, acc, idx, g, valid, lr, eps)
    _plain_on_host(g, "dedup_adagrad", w, acc)
    return ref.dedup_adagrad_ref(w, acc, idx, g, valid, lr, eps)


# ----------------------------------------------------- host-resident rows


def _host_rows_cuda(table, idx, rows, scatter: bool):
    dev = idx.device
    if table.dtype not in (torch.float32, torch.int32) or rows.dtype != table.dtype:
        raise ValueError(f"host_rows: 4-byte tables only, got {table.dtype} / {rows.dtype}")
    t_p = _expect(table, "host_rows table", table.dtype, table.dim(), dev, host=True)
    _expect(idx, "host_rows idx", torch.int64, 1, dev)
    _expect(rows, "host_rows rows", table.dtype, table.dim(), dev)
    n = idx.shape[0]
    width = 1 if table.dim() == 1 else table.shape[1]
    if table.dim() > 2 or rows.shape[0] != n or tuple(rows.shape[1:]) != tuple(table.shape[1:]):
        raise ValueError(f"host_rows: table {tuple(table.shape)}, idx {n}, "
                         f"rows {tuple(rows.shape)}")
    if n and width:
        _launch("host_rows", t_p, idx.data_ptr(), rows.data_ptr(), n, table.shape[0], width,
                int(scatter))
        host_launches["host_rows"] += table.device != dev
    return rows


def take_rows(table: torch.Tensor, idx: torch.Tensor,
              fused: Optional[bool] = None) -> torch.Tensor:
    """``table[idx]`` on ``idx``'s device. A table on that device is indexed
    as before; a host-resident one (a CPU table beside indices on the card)
    is gathered over the bus by the ``host_rows`` kernel, whose plain
    version refuses it (the module docstring). The indices must lie in
    ``[0, rows)``, as torch indexing needs."""
    if table.device == idx.device:
        return table[idx.long()]
    if _use_kernel(fused, idx, "host_rows"):
        out = torch.empty((idx.shape[0],) + tuple(table.shape[1:]), dtype=table.dtype,
                          device=idx.device)
        return _host_rows_cuda(table, idx.long().contiguous(), out, scatter=False)
    _plain_on_host(idx, "host_rows", table)
    return ref.take_rows_ref(table, idx)


def put_rows(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
             fused: Optional[bool] = None) -> None:
    """``table[idx] = rows`` in place, dispatched as ``take_rows``; the
    indices name distinct rows (or rows that take equal values)."""
    if table.device == idx.device:
        table[idx.long()] = rows
        return
    if _use_kernel(fused, idx, "host_rows"):
        _host_rows_cuda(table, idx.long().contiguous(), rows.contiguous(), scatter=True)
        return
    _plain_on_host(idx, "host_rows", table)
    ref.put_rows_ref(table, idx, rows)


# ------------------------------------------------------------ fm interaction


# the forward stages a block's samples in shared memory: at most 16 KB of
# them (several blocks an SM at bulk), at most the 48 KB a block gets
# unasked, at most FM_MAX_WARPS samples a block, a warp each (eight were the
# fastest at bulk on the H100: scripts/torch_fm_project_bench.py --sweep)
FM_STAGE_BYTES, FM_SMEM_BYTES, FM_MAX_WARPS = 16 * 1024, 48 * 1024, 8


def fm_plan(b: int, f: int, d: int, sms: int) -> Tuple[int, int, int]:
    """``(spb, threads, staged)`` of the forward kernel at ``[B, F, D]`` on a
    card of ``sms`` SMs. ``spb`` consecutive samples a block and a warp a
    sample: ``B // sms`` (so that each SM gets a block where the batch
    allows), but no more than fit FM_STAGE_BYTES nor FM_MAX_WARPS, and at
    least one. ``staged`` is 0 where one sample (plus the 12 bytes of
    alignment slack) exceeds FM_SMEM_BYTES: then each warp reads its sample
    from device memory directly, FM_MAX_WARPS samples a block as the first
    kernel took them."""
    sample = 4 * f * d
    if sample + 12 > FM_SMEM_BYTES:
        spb = max(1, min(b // sms, FM_MAX_WARPS))
        return spb, 32 * spb, 0
    spb = max(1, min(b // sms, FM_STAGE_BYTES // max(sample, 4), FM_MAX_WARPS))
    return spb, 32 * spb, 1


def _fm_interaction_cuda(fields):
    _expect(fields, "fm_interaction fields", torch.float32, 3, fields.device)
    b, f, d = fields.shape
    out = torch.empty((b, 1), dtype=fields.dtype, device=fields.device)
    if b:
        _launch("fm_interaction", fields.data_ptr(), out.data_ptr(), b, f, d,
                *fm_plan(b, f, d, sm_count(fields.device)))
    return out


# the backward stages a block's samples as the forward does (at most
# FM_STAGE_BYTES of them), beside their column sums and cotangents: at
# least FMB_MIN_FLOATS floats of samples a block (tiny samples were slower
# one block an SM), at most FMB_MAX_SAMPLES, and a 16-byte store a thread,
# at most FMB_MAX_THREADS threads (scripts/torch_fmbwd_topk_bench.py --sweep
# on the H100)
FMB_MIN_FLOATS, FMB_MAX_SAMPLES, FMB_MAX_THREADS = 64, 8, 256


def _threads_for(n: int, most: int) -> int:
    """``n`` threads rounded up to whole warps, one warp to ``most``."""
    return max(32, min(most, -(-n // 32) * 32))


def fm_bwd_plan(b: int, f: int, d: int, sms: int) -> Tuple[int, int, int]:
    """``(spb, threads, staged)`` of the backward kernel at ``[B, F, D]`` on
    a card of ``sms`` SMs. ``spb`` consecutive samples a block: ``B // sms``
    (so that each SM gets a block where the batch allows), but no more than
    fit FM_STAGE_BYTES nor FMB_MAX_SAMPLES, and at least FMB_MIN_FLOATS of
    floats' worth (small samples share a block); then the largest no more
    than that for which a block's ``spb * F * D`` outputs are whole 16-byte
    stores (every block's output range aligned like the first's), else 1.
    ``staged`` is 0 where one sample with its D column sums, its cotangent
    and 12 bytes of alignment slack passes FM_SMEM_BYTES, or where a sample
    is under 16 bytes: then a thread owns a (sample, column) and reads
    device memory directly, so the threads cover the block's ``spb * D``
    columns. Staged, every thread writes: one a 16-byte store, and at least
    one a sample (each loads a cotangent)."""
    fd = f * d
    least = -(-FMB_MIN_FLOATS // fd)
    if fd < 4 or 4 * (fd + d + 1 + 3) > FM_SMEM_BYTES:
        spb = max(1, least, min(b // sms, FMB_MAX_SAMPLES))
        return spb, _threads_for(spb * d, FMB_MAX_THREADS), 0
    spb = max(1, min(max(b // sms, least), max(FMB_MAX_SAMPLES, least),
                     FM_STAGE_BYTES // (4 * fd)))
    spb = next((n for n in range(spb, 0, -1) if n * fd % 4 == 0), 1)
    return spb, _threads_for(max(spb, -(-spb * fd // 4)), FMB_MAX_THREADS), 1


def _fm_interaction_bwd_cuda(fields, g):
    dev = fields.device
    _expect(fields, "fm_interaction_bwd fields", torch.float32, 3, dev)
    _expect(g, "fm_interaction_bwd g", torch.float32, 2, dev)
    b, f, d = fields.shape
    if tuple(g.shape) != (b, 1):
        raise ValueError(f"fm_interaction_bwd: g {tuple(g.shape)}, want {(b, 1)}")
    out = torch.empty_like(fields)
    if out.numel():
        _launch("fm_interaction_bwd", fields.data_ptr(), g.data_ptr(), out.data_ptr(),
                b, f, d, *fm_bwd_plan(b, f, d, sm_count(dev)))
    return out


def fm_interaction_bwd(fields, g, fused: Optional[bool] = None):
    """d/dfields of ``fm_interaction``: ``g[b] * (sum_f v - v)``."""
    if _use_kernel(fused, fields, "fm_interaction_bwd"):
        return _fm_interaction_bwd_cuda(fields, g)
    return ref.fm_interaction_bwd_ref(fields, g)


class _FMInteraction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fields, use_kernel: bool):
        ctx.save_for_backward(fields)
        ctx.use_kernel = use_kernel
        if use_kernel:
            return _fm_interaction_cuda(fields)
        return ref.fm_interaction_ref(fields)

    @staticmethod
    def backward(ctx, g):
        (fields,) = ctx.saved_tensors
        g = g.contiguous()
        if ctx.use_kernel:
            return _fm_interaction_bwd_cuda(fields, g), None
        return ref.fm_interaction_bwd_ref(fields, g), None


def fm_interaction(fields, fused: Optional[bool] = None):
    """FM second order over field embeddings ``[B, F, D] -> [B, 1]``,
    differentiable through ``fm_interaction_bwd``."""
    return _FMInteraction.apply(fields, _use_kernel(fused, fields, "fm_interaction"))


# ----------------------------------------------------------- dot interaction

# both dot kernels opt in to what one block may hold on the H100 (227 KB);
# their ring buffers take fewer samples where a batch would not give two
# groups to each of the card's 132 SMs
DOT_SMEM_BYTES, DOT_THREADS, DOT_MIN_GROUPS = 232_448, 256, 264
# the forward's ring buffers hold up to 16 KB of samples (one of full
# DLRM's 14.3 KB; several of narrower ones), and its blocks have at least
# 128 threads with 4 x 4 tiles, 256 with 2 x 2 (the fastest of 32-256 on
# the H100 at B = 256, 512 and 65,536, F = 27, D = 128:
# scripts/torch_dot_dedup_bench.py --sweep, PERF.md)
DOT_FWD_STAGE_BYTES, DOT_FWD_MIN_THREADS = 16 * 1024, {4: 128, 2: 256}


def _up4(v: int) -> int:
    return (v + 3) & ~3


def dot_fwd_tiles(f: int, tile: int = 4) -> int:
    """``tile x tile`` register tiles of the forward's ``F x F`` triangle
    (rows padded to ``up4(F)``), diagonal tiles included."""
    t = _up4(f) // tile
    return t * (t + 1) // 2


def dot_fwd_smem(f: int, d: int, spb: int, stages: int) -> int:
    """Bytes of the forward kernel's shared memory: ``stages`` buffers of
    rows ``[spb, up4(F), up4(D)]``, then the output stage ``[spb * P]``
    (the C ``Layout``)."""
    p = f * (f - 1) // 2
    return 4 * (stages * spb * _up4(f) * _up4(d) + _up4(spb * p))


def dot_fwd_plan(b: int, f: int, d: int) -> Tuple[int, int, int, int, int]:
    """``(spb, stages, threads, smem, tile)`` of the forward kernel at ``[B,
    F, D]``. ``tile``: 2 x 2 register tiles where the batch gives each SM
    at most two samples (B <= DOT_MIN_GROUPS: a block's latency is its
    threads' fmaf chains, four times shorter), else 4 x 4 (a quarter of the
    shared-memory reads a dot). ``spb`` samples in each of two ring buffers
    (three were slower at every full-width batch): as many as fit
    DOT_FWD_STAGE_BYTES, but no more than one tile a thread takes, nor than
    leave DOT_MIN_GROUPS groups of the batch, nor than fit DOT_SMEM_BYTES.
    ``threads``: one a tile, and at least DOT_FWD_MIN_THREADS (they share
    the copies in and out). Raises where not even one sample in two
    buffers fits."""
    tile = 2 if b <= DOT_MIN_GROUPS else 4
    tiles = dot_fwd_tiles(f, tile)
    spb = max(1, min(DOT_THREADS // tiles, b // DOT_MIN_GROUPS,
                     DOT_FWD_STAGE_BYTES // (4 * _up4(f) * _up4(d))))
    while spb > 1 and dot_fwd_smem(f, d, spb, 2) > DOT_SMEM_BYTES:
        spb -= 1
    if dot_fwd_smem(f, d, spb, 2) > DOT_SMEM_BYTES:
        raise ValueError(f"dot_interaction: F={f}, D={d}: one sample in two ring buffers "
                         f"takes {dot_fwd_smem(f, d, 1, 2)} bytes, more than the "
                         f"{DOT_SMEM_BYTES} of shared memory a block may hold")
    threads = min(DOT_THREADS, max(-(-spb * tiles // 32) * 32, DOT_FWD_MIN_THREADS[tile]))
    return spb, 2, threads, dot_fwd_smem(f, d, spb, 2), tile


def dot_bwd_smem(f: int, d: int, spb: int, stages: int) -> int:
    """Bytes of the backward kernel's shared memory: the pair table, the
    symmetric cotangent S ``[spb, F, up4(F)]``, then ``stages`` buffers of
    rows ``[spb, F, up4(D)]`` and raw cotangents ``[spb * P]`` (the C
    ``Layout``)."""
    p = f * (f - 1) // 2
    stage = spb * f * _up4(d) + _up4(spb * p)
    return 4 * (_up4(p) + spb * f * _up4(f) + stages * stage)


def dot_bwd_plan(b: int, f: int, d: int) -> Tuple[int, int, int, int]:
    """``(spb, stages, threads, smem)`` of the backward kernel at ``[B, F,
    D]``: ``spb`` samples a ring buffer, enough for one 4 x 4 tile a thread
    where a sample has fewer tiles than DOT_THREADS, but no more than
    leaves DOT_MIN_GROUPS groups of the batch; three buffers where they
    fit, else two. Raises where not even one sample in two buffers fits."""
    tiles = (_up4(f) // 4) * (_up4(d) // 4)
    fill = max(1, b // DOT_MIN_GROUPS)
    for stages in (3, 2):
        spb = max(1, min(DOT_THREADS // tiles, fill))
        while spb > 1 and dot_bwd_smem(f, d, spb, stages) > DOT_SMEM_BYTES:
            spb = max(1, spb // 2)
        smem = dot_bwd_smem(f, d, spb, stages)
        if smem <= DOT_SMEM_BYTES:
            threads = min(DOT_THREADS, -(-spb * tiles // 32) * 32)
            return spb, stages, threads, smem
    raise ValueError(f"dot_interaction_bwd: F={f}, D={d}: one sample in two ring buffers "
                     f"takes {dot_bwd_smem(f, d, 1, 2)} bytes, more than the "
                     f"{DOT_SMEM_BYTES} of shared memory a block may hold")


def _dot_interaction_cuda(fields):
    _expect(fields, "dot_interaction fields", torch.float32, 3, fields.device)
    b, f, d = fields.shape
    p = f * (f - 1) // 2
    if d == 0:
        raise ValueError(f"dot_interaction: F={f}, D={d}: the kernel takes D > 0")
    plan = dot_fwd_plan(b, f, d) if p else None  # raises for a sample too large
    out = torch.empty((b, p), dtype=fields.dtype, device=fields.device)
    if b and plan:
        _launch("dot_interaction", fields.data_ptr(), out.data_ptr(), b, f, d, *plan)
    return out


def _dot_interaction_bwd_cuda(fields, g):
    dev = fields.device
    _expect(fields, "dot_interaction_bwd fields", torch.float32, 3, dev)
    _expect(g, "dot_interaction_bwd g", torch.float32, 2, dev)
    b, f, d = fields.shape
    p = f * (f - 1) // 2
    if tuple(g.shape) != (b, p):
        raise ValueError(f"dot_interaction_bwd: g {tuple(g.shape)}, want {(b, p)}")
    if d == 0:
        raise ValueError(f"dot_interaction_bwd: F={f}, D={d}: the kernel takes D > 0")
    plan = dot_bwd_plan(b, f, d) if f else None  # raises for a sample too large
    out = torch.empty_like(fields)
    if b and plan:
        _launch("dot_interaction_bwd", fields.data_ptr(), g.data_ptr(), out.data_ptr(),
                b, f, d, *plan)
    return out


def dot_interaction_bwd(fields, g, fused: Optional[bool] = None):
    """d/dfields of ``dot_interaction``: ``(gZ + gZ^T) @ x`` with the
    ``[B, P]`` cotangent ``g`` scattered into the strict upper triangle."""
    if _use_kernel(fused, fields, "dot_interaction_bwd"):
        return _dot_interaction_bwd_cuda(fields, g)
    return ref.dot_interaction_bwd_ref(fields, g)


class _DotInteraction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fields, use_kernel: bool):
        ctx.save_for_backward(fields)
        ctx.use_kernel = use_kernel
        if use_kernel:
            return _dot_interaction_cuda(fields)
        return ref.dot_interaction_ref(fields)

    @staticmethod
    def backward(ctx, g):
        (fields,) = ctx.saved_tensors
        g = g.contiguous()
        if ctx.use_kernel:
            return _dot_interaction_bwd_cuda(fields, g), None
        return ref.dot_interaction_bwd_ref(fields, g), None


def dot_interaction(fields, fused: Optional[bool] = None):
    """DLRM pairwise dots over field embeddings ``[B, F, D] -> [B,
    F(F-1)/2]``, the strict upper triangle of ``X X^T`` in
    ``np.triu_indices`` order, differentiable through
    ``dot_interaction_bwd``."""
    return _DotInteraction.apply(fields, _use_kernel(fused, fields, "dot_interaction"))


# --------------------------------------------------------------- cross layer


def _expect_cross(what: str, x0, x, w, b, g=None) -> None:
    dev = x.device
    _expect(x0, f"{what} x0", torch.float32, 2, dev)
    _expect(x, f"{what} x", torch.float32, 2, dev)
    _expect(w, f"{what} w", torch.float32, 2, dev)
    _expect(b, f"{what} b", torch.float32, 1, dev)
    bsz, d = x.shape
    shapes = [tuple(x0.shape), tuple(w.shape), tuple(b.shape)]
    want = [(bsz, d), (d, d), (d,)]
    if g is not None:
        _expect(g, f"{what} g", torch.float32, 2, dev)
        shapes.append(tuple(g.shape))
        want.append((bsz, d))
    if shapes != want:
        raise ValueError(f"{what}: x {(bsz, d)}, x0/w/b{'/g' if g is not None else ''} "
                         f"{shapes}, want {want}")


# the cross kernels' output tile, contraction slab and largest (portable)
# cluster; a grid of CROSS_MIN_BLOCKS blocks puts three quarters of the
# H100's 132 SMs to work
CROSS_TILE, CROSS_SLAB, CROSS_MAX_CLUSTER, CROSS_MIN_BLOCKS = 64, 32, 8, 99


def cross_cluster(n: int, tiles: int) -> int:
    """Blocks of a cluster that split a contraction of ``n`` for each of
    ``tiles`` output tiles: the smallest of 1, 2, 4, 8 (the sizes the
    kernels are built for) that puts CROSS_MIN_BLOCKS blocks to work, and
    no more than gives every block a 32-wide slab. Larger clusters only add
    cross-block sums (``scripts/torch_cross_bench.py --sweep`` on the
    H100); 1 where the tiles alone fill the card."""
    slabs, c = -(-n // CROSS_SLAB), 1
    while tiles * c < CROSS_MIN_BLOCKS and 2 * c <= min(CROSS_MAX_CLUSTER, slabs):
        c *= 2
    return c


def cross_plan(bsz: int, d: int) -> Tuple[int, int, int]:
    """``(c_fwd, c_dx, c_dw)``: the cluster sizes of the forward
    (contraction d over ceil(B/64) x ceil(d/64) output tiles), of the
    backward's dx pass (contraction d, twice those tiles: gx0's and gx's)
    and of its dW pass (contraction B, ceil(d/64)^2 tiles). Fixed by (B, d)
    alone, so a shape always sums in the same order."""
    tiles_b, tiles_d = -(-bsz // CROSS_TILE), -(-d // CROSS_TILE)
    return (cross_cluster(d, tiles_b * tiles_d), cross_cluster(d, 2 * tiles_b * tiles_d),
            cross_cluster(bsz, tiles_d * tiles_d))


def cross_ranges(n: int, c: int) -> List[Tuple[int, int]]:
    """Rank r's part ``[lo, hi)`` of a contraction of ``n`` split over a
    cluster of ``c`` in whole 32-wide slabs, for r in rank order (the
    kernels' ``range_lo``)."""
    slabs = -(-n // CROSS_SLAB)
    cuts = [min(n, slabs * r // c * CROSS_SLAB) for r in range(c + 1)]
    return list(zip(cuts, cuts[1:]))


def _cross_layer_cuda(x0, x, w, b):
    _expect_cross("cross_layer", x0, x, w, b)
    bsz, d = x.shape
    out = torch.empty_like(x)
    if bsz and d:
        _launch("cross_layer", x0.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(),
                out.data_ptr(), bsz, d, cross_plan(bsz, d)[0])
    return out


def _cross_layer_bwd_cuda(x0, x, w, b, g):
    _expect_cross("cross_layer_bwd", x0, x, w, b, g)
    bsz, d = x.shape
    gx0, gx = torch.empty_like(x), torch.empty_like(x)
    if not (bsz and d):
        return gx0, gx, torch.zeros_like(w), torch.zeros_like(b)
    gw, gb = torch.empty_like(w), torch.empty_like(b)
    _launch("cross_layer_bwd", x0.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(),
            g.data_ptr(), gx0.data_ptr(), gx.data_ptr(), gw.data_ptr(), gb.data_ptr(),
            bsz, d, *cross_plan(bsz, d)[1:])
    return gx0, gx, gw, gb


def cross_layer_bwd(x0, x, w, b, g, fused: Optional[bool] = None):
    """d/d(x0, x, w, b) of ``cross_layer`` for the cotangent ``g``:
    ``(g*z, (g*x0) @ w.T + g, x.T @ (g*x0), sum_B g*x0)`` with
    ``z = x @ w + b`` recomputed."""
    if _use_kernel(fused, x, "cross_layer_bwd"):
        return _cross_layer_bwd_cuda(x0, x, w, b, g)
    return ref.cross_layer_bwd_ref(x0, x, w, b, g)


class _CrossLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, x, w, b, use_kernel: bool):
        ctx.save_for_backward(x0, x, w, b)
        ctx.use_kernel = use_kernel
        if use_kernel:
            return _cross_layer_cuda(x0, x, w, b)
        return ref.cross_layer_ref(x0, x, w, b)

    @staticmethod
    def backward(ctx, g):
        x0, x, w, b = ctx.saved_tensors
        g = g.contiguous()
        if ctx.use_kernel:
            grads = _cross_layer_bwd_cuda(x0, x, w, b, g)
        else:
            grads = ref.cross_layer_bwd_ref(x0, x, w, b, g)
        # at layer 0 x is x0: autograd sums the two cotangents it gets
        return (*grads, None)


def cross_layer(x0, x, w, b, fused: Optional[bool] = None):
    """DCN-v2 cross layer ``x0 * (x @ w + b) + x`` for ``x0, x [B, d]``,
    ``w [d, d]``, ``b [d]``, differentiable through ``cross_layer_bwd``."""
    return _CrossLayer.apply(x0, x, w, b, _use_kernel(fused, x, "cross_layer"))


# ------------------------------------------------------------ gather project

# gather_project_grad takes proj of at most _SMEM_FLOATS floats (48 KB, the
# earlier sort-based kernel's limit, kept); its sum kernel gives a slot a
# group of lanes, as many (up to a lane an output) as let all slots' lanes
# fit GPG_SM_THREADS threads an SM, at least one lane for 8 outputs, and a
# block GPG_SLOTS slots, at most GPG_MAX_THREADS threads
# (scripts/torch_fp16dec_projgrad_bench.py --sweep on the H100)
_SMEM_FLOATS, GPG_SM_THREADS, GPG_SLOTS, GPG_MAX_THREADS = 12288, 2048, 32, 256
# gather_project: GP_THREADS threads a block over a tile of at most
# GP_MAX_TILE positions (no fewer than GP_MIN_TILE just to fill the card),
# each lane gathering at most GP_GATHER_BATCH of them; proj and the tile's
# narrow rows in the 48 KB of shared memory a block gets unasked
GP_THREADS, GP_MAX_TILE, GP_MIN_TILE, GP_GATHER_BATCH = 256, 256, 16, 4
GP_SMEM_BYTES = 48 * 1024
GP_SMALL_PRODUCT, GP_SMALL_ROWS = 64, 4


def _vec_width(v: int, align: int = 16) -> int:
    """The widest of 4, 2 and 1 floats that divides ``v`` and whose bytes
    divide ``align``."""
    return next(w for w in (4, 2, 1) if v % w == 0 and align % (4 * w) == 0)


def gather_project_smem(nd: int, d: int, tile: int) -> int:
    """Bytes of the kernel's shared memory: proj ``[d, D]`` and the tile's
    narrow rows ``[tile, d]`` (each padded to 4 floats), then its ``ok``
    bytes."""
    return 4 * (_up4(nd * d) + _up4(tile * nd)) + tile


def gather_project_limits(nd: int, d: int, align: int = 16) -> Tuple[int, int]:
    """``(w, cw)``: the floats a lane gathers of a narrow row and owns of a
    wide row. Raises where the kernel cannot take ``d = nd``, ``D = d``:
    more than GP_THREADS lanes for a row, or proj and one row past
    GP_SMEM_BYTES."""
    w, cw = _vec_width(nd, align), _vec_width(d) if d > 0 else 1
    if (nd <= 0 or d <= 0 or nd // w > GP_THREADS or d // cw > GP_THREADS
            or gather_project_smem(nd, d, 1) > GP_SMEM_BYTES):
        raise ValueError(f"gather_project: d={nd}, D={d} exceed the kernel's {GP_THREADS} "
                         f"lanes a row or its {GP_SMEM_BYTES} bytes of shared memory")
    return w, cw


def gather_project_plan(n: int, nd: int, d: int, sms: int,
                        align: int = 16) -> Tuple[int, int, int, int, int]:
    """``(w, cw, rows, threads, tile)`` of the ``gather_project`` kernel for
    ``n`` positions, ``back [m, d=nd]`` aligned to ``align`` bytes and
    ``proj [nd, D=d]``, on a card of ``sms`` SMs. ``w`` and ``cw`` from
    ``gather_project_limits``. ``tile`` positions a block: the largest power
    of two up to GP_MAX_TILE that still gives each SM a block (not below
    GP_MIN_TILE for that), that the block's lanes gather in one batch of
    GP_GATHER_BATCH, and whose shared memory fits. ``rows``: the positions
    a product slot (``D / cw`` lanes; ``threads // (D / cw)`` slots) takes
    at once, the least of 1, 2, 4, 8 that covers the tile in one round, but
    at most GP_SMALL_ROWS where a position's product is at most
    GP_SMALL_PRODUCT multiply-adds: there a proj vector serves little, and
    eight rows' registers cost blocks an SM at bulk (the bench's
    ``--sweep`` on the H100); the slots then take the tile in rounds."""
    w, cw = gather_project_limits(nd, d, align)
    g, slots = nd // w, GP_THREADS // (d // cw)
    tile = GP_MAX_TILE
    while tile > 1 and (tile > GP_GATHER_BATCH * (GP_THREADS // g)
                        or gather_project_smem(nd, d, tile) > GP_SMEM_BYTES
                        or (tile > GP_MIN_TILE and -(-n // tile) < sms)):
        tile //= 2
    most = GP_SMALL_ROWS if nd * d <= GP_SMALL_PRODUCT else 8
    rows = next((r for r in (1, 2, 4, 8) if r <= most and slots * r >= tile), most)
    return w, cw, rows, GP_THREADS, tile


def _alignment(t: torch.Tensor) -> int:
    """The largest power of two up to 16 that divides ``t``'s address."""
    ptr = t.data_ptr()
    return min(16, ptr & -ptr) if ptr else 16


def _expect_project(what: str, idx, kept, proj, dev) -> None:
    _expect(idx, f"{what} idx", torch.int32, 1, dev)
    _expect(kept, f"{what} kept", torch.bool, 1, dev)
    _expect(proj, f"{what} proj", torch.float32, 2, dev)
    if kept.shape[0] != idx.shape[0]:
        raise ValueError(f"{what}: idx {idx.shape[0]} and kept {kept.shape[0]} must match")


def _gather_project_cuda(back, idx, kept, proj):
    dev = back.device
    _expect(back, "gather_project back", torch.float32, 2, dev)
    _expect_project("gather_project", idx, kept, proj, dev)
    m, nd = back.shape
    n = idx.shape[0]
    d = proj.shape[1]
    if proj.shape[0] != nd:
        raise ValueError(f"gather_project: back {(m, nd)} and proj {tuple(proj.shape)}")
    if n >= 2**31 - 1:
        raise ValueError(f"gather_project: n={n} exceeds the kernel's int32 positions")
    align = _alignment(back)
    gather_project_limits(nd, d, align)  # raises before any card query
    wide = torch.empty((n, d), dtype=back.dtype, device=dev)
    narrow = torch.empty((n, nd), dtype=back.dtype, device=dev)
    if n:
        _launch("gather_project", back.data_ptr(), idx.data_ptr(), kept.data_ptr(),
                proj.data_ptr(), wide.data_ptr(), narrow.data_ptr(), m, n, nd, d,
                *gather_project_plan(n, nd, d, sm_count(dev), align))
    return wide, narrow


def gather_project_grad_plan(m: int, nd: int, d: int, sms: int,
                             align: int = 16) -> Tuple[int, int, int]:
    """``(lanes, cw, threads)`` of the ``gather_project_grad`` sum kernel for
    ``m`` slots, ``proj [nd, D=d]`` and ``g_wide`` aligned to ``align`` bytes
    on a card of ``sms`` SMs. ``lanes`` a slot, a power of two: the most,
    up to ``nd`` rounded up (a lane an output), for which all ``m * lanes``
    threads fit GPG_SM_THREADS on each SM, and no fewer than ``nd / 8``
    rounded up (8 outputs a lane); a lane takes every ``lanes``-th output.
    ``cw`` the floats a ``g_wide`` row load takes: the widest of 4, 2, 1
    that divides ``d`` and whose bytes divide ``align``. ``threads`` a
    block: GPG_SLOTS slots, at most GPG_MAX_THREADS threads."""
    top = 1 << max(nd - 1, 0).bit_length()
    lanes = min(32, top)
    while lanes > max(1, top // 8) and m * lanes > sms * GPG_SM_THREADS:
        lanes //= 2
    return lanes, _vec_width(d, align), min(GPG_MAX_THREADS, GPG_SLOTS * lanes)


def _gather_project_grad_cuda(g_wide, g_narrow, idx, kept, proj, m: int):
    dev = g_wide.device
    _expect(g_wide, "gather_project_grad g_wide", torch.float32, 2, dev)
    _expect(g_narrow, "gather_project_grad g_narrow", torch.float32, 2, dev)
    _expect_project("gather_project_grad", idx, kept, proj, dev)
    n = idx.shape[0]
    nd, d = proj.shape
    if tuple(g_wide.shape) != (n, d) or tuple(g_narrow.shape) != (n, nd):
        raise ValueError(f"gather_project_grad: g_wide {tuple(g_wide.shape)}, g_narrow "
                         f"{tuple(g_narrow.shape)}, want {(n, d)} and {(n, nd)}")
    if (max(n, m) >= 2**31 - 1 or not 0 < nd <= 256 or d <= 0
            or nd * d > _SMEM_FLOATS):
        raise ValueError(f"gather_project_grad: n={n}, m={m}, d={nd}, D={d} exceed the "
                         "kernel's int32 offsets, its 256 outputs a slot or 48 KB of proj")
    out = torch.empty((m, nd), dtype=g_wide.dtype, device=dev)
    if m:
        # the kernel's slot lists (head [m], next [n]); it drops not-kept
        # positions and slots outside [0, m) and sums each slot's positions
        # in ascending order, as the reference's segment_sum does
        scratch = torch.empty((m + n,), dtype=torch.int32, device=dev)
        _launch("gather_project_grad", g_wide.data_ptr(), g_narrow.data_ptr(),
                proj.data_ptr(), idx.data_ptr(), kept.data_ptr(), scratch.data_ptr(),
                out.data_ptr(), n, m, nd, d,
                *gather_project_grad_plan(m, nd, d, sm_count(dev), _alignment(g_wide)))
    return out


def gather_project_grad(g_wide, g_narrow, idx, kept, proj, m: int,
                        fused: Optional[bool] = None):
    """Transpose of ``gather_project`` w.r.t. the routed buffer, standalone:
    ``g_back[j] = sum_{idx[i]=j, kept[i]} (g_wide[i] @ proj^T + g_narrow[i])``
    for ``j < m``; slots no kept position maps to are exactly 0."""
    if _use_kernel(fused, g_wide, "gather_project_grad"):
        return _gather_project_grad_cuda(g_wide, g_narrow, idx, kept, proj, int(m))
    return ref.gather_project_grad_ref(g_wide, g_narrow, idx, kept, proj, int(m))


class _GatherProject(torch.autograd.Function):
    @staticmethod
    def forward(ctx, back, idx, kept, proj, use_kernel: bool):
        if use_kernel:
            wide, narrow = _gather_project_cuda(back, idx, kept, proj)
        else:
            wide, narrow = ref.gather_project_ref(back, idx, kept, proj)
        # the narrow residual is already masked, so the projection's
        # cotangent below needs no mask
        ctx.save_for_backward(idx, kept, narrow, proj)
        ctx.m, ctx.use_kernel = back.shape[0], use_kernel
        return wide, narrow

    @staticmethod
    def backward(ctx, g_wide, g_narrow):
        idx, kept, narrow, proj = ctx.saved_tensors
        g_wide, g_narrow = g_wide.contiguous(), g_narrow.contiguous()
        if ctx.use_kernel:
            g_back = _gather_project_grad_cuda(g_wide, g_narrow, idx, kept, proj, ctx.m)
        else:
            g_back = ref.gather_project_grad_ref(g_wide, g_narrow, idx, kept, proj, ctx.m)
        # a plain product outside any kernel, as in the reference
        g_proj = narrow.T @ g_wide
        return g_back, None, None, g_proj, None


def gather_project(back, idx, kept, proj, fused: Optional[bool] = None):
    """Narrow-row stitch of ``picasso_narrow``: gather ``[d]``-narrow rows
    out of the routed-back buffer ``back [m, d]`` at ``idx`` and project them
    up through ``proj [d, D]`` in one pass. Returns ``(wide [n, D], narrow
    [n, d])``, exact zeros where ``kept`` is false or ``idx`` falls outside
    ``[0, m)``. Differentiable: ``back`` through ``gather_project_grad``,
    ``proj`` as ``narrow^T @ g_wide``."""
    return _GatherProject.apply(back, idx, kept, proj,
                                _use_kernel(fused, back, "gather_project"))


# ---------------------------------------------------------------------------
# routed-gradient wire compression (grad_compress modes; the collective
# wrappers live in repro_torch.optim.grad_compression). No autograd: the
# payload is built from a gradient after the backward.
# ---------------------------------------------------------------------------


def _fp16_compress_cuda(g):
    dev = g.device
    _expect(g, "fp16_compress g", torch.float32, 2, dev)
    m, d = g.shape
    if d == 0:
        raise ValueError("fp16_compress: rows of width 0")
    q = torch.empty((m, d), dtype=torch.float16, device=dev)
    scale = torch.empty((m, 1), dtype=torch.float32, device=dev)
    if m:
        _launch("fp16_compress", g.data_ptr(), q.data_ptr(), scale.data_ptr(), m, d,
                *fp16_compress_plan(m, d, sm_count(dev)))
    return q, scale


def compress_fp16(g, fused: Optional[bool] = None):
    """Per-row amax scale + float16 cast: ``(q [m, D] f16, scale [m, 1] f32)``.
    All-zero rows compress to exact zeros (padded bucket slots roundtrip
    bitwise); a row holding a NaN compresses to NaN."""
    if _use_kernel(fused, g, "fp16_compress"):
        return _fp16_compress_cuda(g)
    return ref.fp16_compress_ref(g)


def _fp16_decompress_cuda(q, scale):
    dev = q.device
    _expect(q, "fp16_decompress q", torch.float16, 2, dev)
    _expect(scale, "fp16_decompress scale", torch.float32, 2, dev)
    m, d = q.shape
    if tuple(scale.shape) != (m, 1):
        raise ValueError(f"fp16_decompress: q {(m, d)}, scale {tuple(scale.shape)}")
    out = torch.empty((m, d), dtype=torch.float32, device=dev)
    if m and d:
        _launch("fp16_decompress", q.data_ptr(), scale.data_ptr(), out.data_ptr(), m * d, d,
                *fp16_decompress_plan(m, d, sm_count(dev)))
    return out


# fp16_decompress: a thread a quad of 4 outputs, FD_THREADS threads a
# block; where the quads pass what the SMs hold at once (FD_SM_THREADS
# each), a thread takes FD_ROUNDS of them, grid-stride: at bulk 3 % faster
# than a quad a thread, at the path shapes 4 % slower; blocks of 256 ran
# as fast as any other size at every path shape
# (scripts/torch_fp16dec_projgrad_bench.py --sweep on the H100)
FD_THREADS, FD_SM_THREADS, FD_ROUNDS = 256, 2048, 2


def fp16_decompress_plan(m: int, d: int, sms: int) -> Tuple[int, int]:
    """``(blocks, threads)`` of the decompression kernel for ``m`` rows of
    width ``d`` on a card of ``sms`` SMs: FD_THREADS threads a block, a
    thread a quad (4 outputs), or FD_ROUNDS quads where the quads pass
    ``sms * FD_SM_THREADS``."""
    quads = max(1, -(-m * d // 4))
    rounds = FD_ROUNDS if quads > sms * FD_SM_THREADS else 1
    return -(-quads // (FD_THREADS * rounds)), FD_THREADS


def decompress_fp16(q, scale, fused: Optional[bool] = None):
    """``float32(q) * scale``: the rows ``compress_fp16`` encoded."""
    if _use_kernel(fused, q, "fp16_decompress"):
        return _fp16_decompress_cuda(q, scale)
    return ref.fp16_decompress_ref(q, scale)


def _topk_compress_cuda(g, k: int):
    dev = g.device
    _expect(g, "topk_compress g", torch.float32, 2, dev)
    m, d = g.shape
    if not 0 < k <= d:
        raise ValueError(f"topk_compress: k={k} must lie in [1, D={d}]")
    vals = torch.empty((m, k), dtype=torch.float32, device=dev)
    idx = torch.empty((m, k), dtype=torch.int32, device=dev)
    if m:
        _launch("topk_compress", g.data_ptr(), vals.data_ptr(), idx.data_ptr(), m, d, k,
                *topk_compress_plan(m, d, k, sm_count(dev)))
    return vals, idx


def compress_topk(g, k: int, fused: Optional[bool] = None):
    """Per-row magnitude top-k sparsification: ``(vals [m, k], idx [m, k]
    int32)``, descending magnitude, ties toward the lower column, a NaN
    above every number."""
    if _use_kernel(fused, g, "topk_compress"):
        return _topk_compress_cuda(g, int(k))
    return ref.topk_compress_ref(g, int(k))


# the compression kernels either stage a tile of consecutive rows of g in
# shared memory (row_stage.cuh: a multiple of ROW_TILE rows keeps every
# tile of g at g's alignment and every output tile on 16 bytes), the tile
# with its other buffers at most ROW_SMEM_BYTES, or go direct: one thread a
# row reads g, ROW_DIRECT_THREADS rows a block. fp16_compress stages rows
# of at least FC_STAGE_MIN_D floats, at most FC_MAX_ROWS rows and
# FC_MAX_THREADS threads a block, a thread a group of 8 outputs (a 16-byte
# store); topk_compress stages only where it makes k passes (k >=
# TK_STAGE_MIN_K), at most TK_MAX_ROWS rows a block, a thread a row: its
# one-scan selection ran faster direct at every width
# (scripts/torch_compress_bench.py --sweep on the H100)
ROW_SMEM_BYTES, ROW_TILE, ROW_DIRECT_THREADS = 48 * 1024, 8, 128
FC_STAGE_MIN_D, FC_MAX_ROWS, FC_MAX_THREADS = 9, 256, 256
TK_STAGE_MIN_K, TK_MAX_ROWS = 9, 256


def _row_tile(m: int, sms: int, most: int, row_bytes: int) -> int:
    """Rows a staged tile: ``m // sms`` rounded down to a multiple of
    ROW_TILE (so that each SM gets a block where ``m`` allows), at least
    ROW_TILE and at most ``most``, and no more than fit ROW_SMEM_BYTES at
    ``row_bytes`` a row plus 12 bytes of alignment slack; 0 where ROW_TILE
    rows do not fit."""
    fit = (ROW_SMEM_BYTES - 12) // row_bytes // ROW_TILE * ROW_TILE
    return min(fit, max(ROW_TILE, min(most, m // sms // ROW_TILE * ROW_TILE)))


def fp16_compress_plan(m: int, d: int, sms: int) -> Tuple[int, int, int]:
    """``(rows, threads, staged)`` of the fp16 compression kernel for ``m``
    rows of width ``d`` on a card of ``sms`` SMs. Staged where ``d`` is at
    least FC_STAGE_MIN_D: ``rows`` from ``_row_tile`` at ``4 * d`` bytes of
    floats and 4 of divisor a row; ``threads`` one a row and one a group of
    8 outputs, at most FC_MAX_THREADS. Direct (``staged`` 0) for narrower
    rows or where eight rows do not fit (D > 1,534): ROW_DIRECT_THREADS
    rows a block, a thread each."""
    rows = _row_tile(m, sms, FC_MAX_ROWS, 4 * d + 4)
    if d < FC_STAGE_MIN_D or rows == 0:
        return ROW_DIRECT_THREADS, ROW_DIRECT_THREADS, 0
    return rows, _threads_for(max(rows, -(-rows * d // 8)), FC_MAX_THREADS), 1


def topk_compress_plan(m: int, d: int, k: int, sms: int) -> Tuple[int, int, int]:
    """``(rows, threads, staged)`` of the top-k compression kernel for ``m``
    rows of width ``d`` keeping ``k`` on a card of ``sms`` SMs. Staged
    where the kernel makes k passes (``k`` at least TK_STAGE_MIN_K):
    ``rows`` from ``_row_tile`` at ``4 * d`` bytes of floats and ``8 * k``
    of outputs a row, a thread a row. Direct
    (``staged`` 0) for the one-scan selection of ``k <= 8`` and where eight
    rows do not fit (D > 1,023 at k = D // 4): ROW_DIRECT_THREADS rows a
    block, a thread each."""
    rows = _row_tile(m, sms, TK_MAX_ROWS, 4 * d + 8 * k)
    if k < TK_STAGE_MIN_K or rows == 0:
        return ROW_DIRECT_THREADS, ROW_DIRECT_THREADS, 0
    return rows, _threads_for(rows, TK_MAX_ROWS), 1


# topk_decompress builds a tile of rows in shared memory and writes it
# whole: at most TD_MAX_ROWS rows a block and TD_MAX_THREADS threads, each
# thread at most TD_VECS 16-byte stores (scripts/torch_fmbwd_topk_bench.py
# --sweep on the H100)
TD_SMEM_BYTES, TD_MAX_ROWS, TD_VECS, TD_MAX_THREADS = 48 * 1024, 256, 4, 256


def topk_decompress_plan(m: int, d: int, sms: int) -> Tuple[int, int]:
    """``(rows, threads)`` of the decompression kernel for ``m`` rows of
    width ``d`` on a card of ``sms`` SMs. ``rows`` a tile: the largest power
    of two from 4 to TD_MAX_ROWS (a multiple of 4, so every tile starts on
    a 16-byte boundary of the output) that gives each SM a block where
    ``m`` allows and whose ``rows * d`` floats fit TD_SMEM_BYTES; 4 where
    none fits (the kernel then builds the tile in the output itself).
    ``threads``: one a row, and enough for at most TD_VECS 16-byte stores
    each, at most TD_MAX_THREADS. ``k`` changes neither: a row's entries
    are one thread's."""
    rows = TD_MAX_ROWS
    while rows > 4 and (rows * d * 4 > TD_SMEM_BYTES or -(-m // rows) < sms):
        rows //= 2
    want = max(rows, -(-rows * d // (4 * TD_VECS)))
    return rows, _threads_for(want, TD_MAX_THREADS)


def _topk_decompress_cuda(vals, idx, d: int):
    dev = vals.device
    _expect(vals, "topk_decompress vals", torch.float32, 2, dev)
    _expect(idx, "topk_decompress idx", torch.int32, 2, dev)
    m, k = vals.shape
    if tuple(idx.shape) != (m, k) or d <= 0:
        raise ValueError(f"topk_decompress: vals {(m, k)}, idx {tuple(idx.shape)}, D={d}")
    out = torch.empty((m, d), dtype=torch.float32, device=dev)
    if m:
        _launch("topk_decompress", vals.data_ptr(), idx.data_ptr(), out.data_ptr(), m, d, k,
                *topk_decompress_plan(m, d, sm_count(dev)))
    return out


def decompress_topk(vals, idx, d: int, fused: Optional[bool] = None):
    """A zero ``[m, d]`` block with ``vals`` set at ``idx``; columns outside
    ``[0, d)`` are dropped."""
    if _use_kernel(fused, vals, "topk_decompress"):
        return _topk_decompress_cuda(vals, idx, int(d))
    return ref.topk_decompress_ref(vals, idx, int(d))
