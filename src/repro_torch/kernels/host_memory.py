"""Pinned host memory the card reads and writes over the bus (``--pin-l2``).

``pinned_empty`` returns a CPU tensor backed by an exact-size, page-locked
buffer mapped into the device address space (``cudaHostAlloc`` in
``csrc/host_rows.cu``). torch's own ``pin_memory`` goes through its caching
host allocator, which rounds a block up to a power of two: full DLRM's
22.38 GiB narrow master would take 32 GiB of host RAM. The buffer is freed
when the last tensor viewing it is.

``device_pointer`` gives the address a kernel uses for such a tensor, from
the ``cudaHostGetDevicePointer`` of its buffer (never assumed equal to the
host address), and raises for any other CPU tensor: the kernels take a host
operand only where it lies in one of these buffers.

The card reads and writes these buffers asynchronously, from kernels still
queued when the host goes on. A host-side read or write of a mapped tensor
(a checkpoint's save or restore, a published delta's load) is therefore
ordered after the card's queued work by ``wait_for_card`` first; a copy
between a mapped tensor and a device tensor is stream-ordered already.

Nothing here runs at import; every function but ``is_mapped``,
``device_pointer``, ``pinned_bytes`` and ``wait_for_card`` needs the card
and builds the library at first use.
"""
from __future__ import annotations

import bisect
import ctypes
import threading
import weakref
from typing import Dict, Iterable, List, Tuple

import torch

from repro_torch.kernels import build

# host base address -> (bytes, device base address) of every live buffer
_BUFFERS: Dict[int, Tuple[int, int]] = {}
_BASES: List[int] = []  # sorted keys of _BUFFERS
_LOCK = threading.Lock()


def _free(host: int) -> None:
    with _LOCK:
        _BUFFERS.pop(host, None)
        i = bisect.bisect_left(_BASES, host)
        if i < len(_BASES) and _BASES[i] == host:
            _BASES.pop(i)
    rc = build.function("host_rows", "host_rows_free")(host)
    if rc != 0:
        raise RuntimeError(f"cudaFreeHost failed (cudaError {rc})")


def pinned_empty(shape, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """An uninitialised CPU tensor in mapped, page-locked host memory of
    exactly its size (at least one element is allocated)."""
    shape = tuple(int(s) for s in shape)
    numel = torch.Size(shape).numel()
    nbytes = max(1, numel) * torch.empty((), dtype=dtype).element_size()
    host, dev = ctypes.c_void_p(), ctypes.c_void_p()
    rc = build.function("host_rows", "host_rows_alloc")(nbytes, ctypes.byref(host),
                                                         ctypes.byref(dev))
    if rc != 0 or not host.value or not dev.value:
        raise RuntimeError(f"cudaHostAlloc of {nbytes} mapped bytes failed (cudaError {rc})")
    buf = (ctypes.c_uint8 * nbytes).from_address(host.value)
    fin = weakref.finalize(buf, _free, host.value)
    fin.atexit = False  # the process's exit frees it; CUDA may be gone by then
    with _LOCK:
        _BUFFERS[host.value] = (nbytes, dev.value)
        bisect.insort(_BASES, host.value)
    return torch.frombuffer(buf, dtype=torch.uint8).view(dtype)[:numel].view(shape)


def pinned_like(t: torch.Tensor) -> torch.Tensor:
    """A mapped pinned copy of ``t`` (any device)."""
    out = pinned_empty(t.shape, t.dtype)
    out.copy_(t)
    return out


def _lookup(t: torch.Tensor):
    """``(host base, bytes, device base)`` of the buffer holding all of
    ``t``'s storage, or ``None``."""
    if t.device.type != "cpu":
        return None
    storage = t.untyped_storage()
    start = storage.data_ptr()
    end = start + storage.nbytes()
    with _LOCK:
        i = bisect.bisect_right(_BASES, start) - 1
        if i < 0:
            return None
        base = _BASES[i]
        nbytes, dev = _BUFFERS[base]
    if end > base + nbytes:
        return None
    return base, nbytes, dev


def is_mapped(t: torch.Tensor) -> bool:
    """True for a CPU tensor that lies in one of ``pinned_empty``'s buffers."""
    return _lookup(t) is not None


def device_pointer(t: torch.Tensor, what: str = "operand") -> int:
    """The device address of host tensor ``t``'s first element."""
    found = _lookup(t)
    if found is None:
        raise ValueError(f"{what}: a host operand must lie in mapped pinned memory "
                         "(repro_torch.kernels.host_memory.pinned_empty); got a CPU "
                         f"tensor at {t.data_ptr():#x} that does not")
    base, _, dev = found
    return dev + (t.data_ptr() - base)


def driver_pinned(t: torch.Tensor) -> bool:
    """The CUDA driver's own check of ``t``'s first byte: page-locked host memory
    mapped at the device address ``device_pointer`` gives. (torch's
    ``Tensor.is_pinned`` knows only its own host allocator's blocks and
    reports False for these buffers.)"""
    if not is_mapped(t):
        return False
    kind, dev = ctypes.c_int(), ctypes.c_void_p()
    rc = build.function("host_rows", "host_rows_pointer_kind")(
        t.data_ptr(), ctypes.byref(kind), ctypes.byref(dev))
    return rc == 0 and kind.value == 1 and dev.value == device_pointer(t)


def pinned_bytes() -> int:
    """Bytes held in live ``pinned_empty`` buffers."""
    with _LOCK:
        return sum(n for n, _ in _BUFFERS.values())


def wait_for_card(tensors: Iterable) -> None:
    """Block until every card's queued work is done when any of ``tensors``
    lies in mapped pinned memory, so that the host reads what the queued
    kernels write there and its own writes land after their reads. Other
    items (device tensors, arrays, ints) are ignored; without a mapped
    tensor among them nothing waits."""
    if any(isinstance(t, torch.Tensor) and is_mapped(t) for t in tensors):
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
