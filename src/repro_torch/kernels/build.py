"""Build the port's CUDA kernels with ``nvcc`` at first use and bind them.

Each ``csrc/<name>.cu`` has a plain C entry point (``<name>_launch``) and is
compiled for ``sm_90a`` into its own shared library, loaded with ``ctypes``:
no PyTorch headers, so a build takes seconds. One ``nvcc`` runs per source,
all started together. Libraries are named by a hash of their source, the
shared ``csrc/*.cuh`` headers and the flags inside ``_build/`` (git-ignored),
so a changed source or header is rebuilt and an unchanged one is reused
within a checkout. A failed build raises; there is no fallback.

Nothing here runs at import: the CPU tests import every module, and this
machine-side build needs the CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# flags of one source only: gather_project_grad's 72 template instantiations
# (lanes x outputs a lane x load width) are the longest build by far, so its
# device code is compiled in parallel threads
EXTRA_FLAGS: Dict[str, Tuple[str, ...]] = {"gather_project_grad": ("--split-compile=0",)}

_P, _I64, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
# kernel name -> argtypes of its C entry point ``<name>_launch``
SIGNATURES: Dict[str, List] = {
    # uniq, uvalid, keys, rows, hit, slot, rows_out, n, h, d, lanes, stream
    "tier_probe": [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I, _I, _P],
    # rows_u, inv, w, seg, out, n, n_bags, d, stream
    "gather_pool": [_P, _P, _P, _P, _P, _I64, _I64, _I, _P],
    # x, out, b, f, d, samples a block, threads, staged, stream
    "fm_interaction": [_P, _P, _I64, _I, _I, _I, _I, _I, _P],
    # g_bags, seg, w, order, sorted_inv, out, n, n_rows, d, tile, chunk, stream
    "segment_grad": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I, _I, _I, _P],
    # w, acc, idx, valid, g, scratch, scratch ints, m, rows, d, cap, lr, eps, stream
    "dedup_adagrad": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I64, _F, _F, _P],
    # x, g, out, b, f, d, samples a block, threads, staged, stream
    "fm_interaction_bwd": [_P, _P, _P, _I64, _I, _I, _I, _I, _I, _P],
    # x0, x, w, b, out, b_rows, d, cluster, stream
    "cross_layer": [_P, _P, _P, _P, _P, _I64, _I, _I, _P],
    # x0, x, w, b, g, gx0, gx, gw, gb, b_rows, d, cluster_dx, cluster_dw, stream
    "cross_layer_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _P],
    # back, idx, kept, proj, wide, narrow, m, n, nd, d, w, cw, rows, threads,
    # tile, stream
    "gather_project": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I, _I, _I, _I, _I, _I, _I, _P],
    # g_wide, g_narrow, proj, idx, kept, scratch (head, next), out, n, m, nd,
    # d, lanes, cw, threads, stream
    "gather_project_grad": [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I, _I, _I, _I, _I, _P],
    # g, q, scale, m, d, rows a block, threads, staged, stream
    "fp16_compress": [_P, _P, _P, _I64, _I, _I, _I, _I, _P],
    # q, scale, out, m * d, d, blocks, threads, stream
    "fp16_decompress": [_P, _P, _P, _I64, _I, _I, _I, _P],
    # g, vals, idx, m, d, k, rows a block, threads, staged, stream
    "topk_compress": [_P, _P, _P, _I64, _I, _I, _I, _I, _I, _P],
    # vals, idx, out, m, d, k, rows a block, threads, stream
    "topk_decompress": [_P, _P, _P, _I64, _I, _I, _I, _I, _P],
    # x, out, b, f, d, samples a group, stages, threads, smem bytes, tile, stream
    "dot_interaction": [_P, _P, _I64, _I, _I, _I, _I, _I, _I64, _I, _P],
    # x, g, out, b, f, d, samples a group, stages, threads, smem bytes, stream
    "dot_interaction_bwd": [_P, _P, _P, _I64, _I, _I, _I, _I, _I, _I64, _P],
    # table, idx, rows on the card, n, table rows, width in words, scatter, stream
    "host_rows": [_P, _P, _P, _I64, _I64, _I, _I, _P],
}
# the other C entry points of a library: name -> symbol -> argtypes
EXTRA_SYMBOLS: Dict[str, Dict[str, List]] = {
    # bytes, *host, *dev: pinned mapped host memory, and its release
    "host_rows": {"host_rows_alloc": [ctypes.c_uint64, ctypes.POINTER(_P),
                                      ctypes.POINTER(_P)],
                  "host_rows_free": [_P],
                  # ptr, *memory type, *device address (cudaPointerGetAttributes)
                  "host_rows_pointer_kind": [_P, ctypes.POINTER(_I), ctypes.POINTER(_P)]},
}

_LAUNCHERS: Dict[str, Callable[..., int]] = {}
_LIBS: List[ctypes.CDLL] = []  # keep the loaded libraries alive
# kernel name -> compiler output of its last build (``-Xptxas -v`` lines)
BUILD_LOG: Dict[str, str] = {}
# kernel name -> wall seconds from the start of its last build_all to the end
# of its nvcc (the longest one is the build's critical path)
BUILD_SECONDS: Dict[str, float] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built at first use and "
        "need the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def _flags(name: str) -> Tuple[str, ...]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(_flags(name)).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return src, BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every kernel whose library is missing, one ``nvcc`` process
    per source, all running at once. Returns the wall seconds it took."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in SIGNATURES:
        src, out = _target(name)
        if out.exists():
            continue
        tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
        cmd = [nvcc(), *_flags(name), "-o", str(tmp), str(src)]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))

    def wait(name: str, proc: subprocess.Popen) -> None:
        BUILD_LOG[name], _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0

    waiters = [threading.Thread(target=wait, args=(name, proc)) for name, _, _, proc in jobs]
    for t in waiters:
        t.start()
    for t in waiters:
        t.join()
    failed = []
    for name, out, tmp, proc in jobs:
        log = BUILD_LOG[name]
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def function(name: str, symbol: str) -> Callable[..., int]:
    """The C entry point ``symbol`` of kernel ``name``'s library, building
    everything first if needed; it returns a CUDA error code."""
    fn = _LAUNCHERS.get(symbol)
    if fn is None:
        build_all()
        lib = ctypes.CDLL(str(_target(name)[1]))
        _LIBS.append(lib)
        fn = getattr(lib, symbol)
        fn.argtypes = (SIGNATURES[name] if symbol == f"{name}_launch"
                       else EXTRA_SYMBOLS[name][symbol])
        fn.restype = ctypes.c_int
        _LAUNCHERS[symbol] = fn
    return fn


def launcher(name: str) -> Callable[..., int]:
    """The C entry point of kernel ``name``, building everything first if
    needed. It returns the ``cudaGetLastError()`` code of its launch."""
    return function(name, f"{name}_launch")
