"""Checkpoint save/restore (``repro.train.checkpoint`` in torch): atomic,
async-capable, verified, streamed.

Layout, leaf for leaf the reference's: ``<dir>/step_<n:08d>/manifest.json``
plus one ``.npy`` file per leaf (``.npy.zst`` where ``zstandard`` imports),
named by the leaf's path with ``/`` -> ``__``, each with the crc32 of its
bytes on disk. A checkpoint written by either package restores in the
other: the train state's ``step`` is the reference's 0-d int32 leaf on disk
and the port's host int in memory.

Streaming: a leaf is written in row chunks of at most ``CHUNK_BYTES``
(device to host, then into the file), the crc32 accumulating over the
chunks, so host memory holds one chunk and not the 7.5 GB table; the
uncompressed file is bitwise what ``np.save`` writes. Restore first opens
every leaf and checks its bytes against its crc32, its header, size and
rows, then copies the rows into the template's tensors in place, chunk by
chunk, from the files it still holds open: a corrupt checkpoint, or one of
another shape, is refused before the template is touched, a directory
pruned meanwhile still loads whole, and device memory does not grow.

Integrity: a crc32 mismatch, a torn or missing leaf file, a bad payload or
an unreadable manifest raises ``CheckpointCorrupt``; ``restore_verified``
quarantines such a checkpoint (``step_<n>`` -> ``step_<n>.corrupt``) and
falls back to the previous one.

Packing salts: the port's manifests record the per-table packing salts
(``core.features.table_salts``) under a top-level ``"salts"`` key beside
``meta``. A restore compares them with this process's and raises
``SaltMismatch`` (a ``ValueError`` naming ``PYTHONHASHSEED``) on any
difference: a table restored under other salts would serve every lookup
from a wrong row. A manifest without salts (one the reference wrote)
restores unchecked (``load_checkpoint_salts`` returns ``None``).

World size: the port runs one rank. A leaf whose rows differ from the
template's was written at another world size; ``on_row_mismatch='error'``
raises ``WorldMismatch`` (a ``NotImplementedError``: the elastic restore
belongs to ROADMAP Queue 1 item 6), ``'keep'`` and ``'repad'`` keep the
reference's meaning.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import tempfile
import threading
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.features import SaltMismatch
from repro_torch.kernels import host_memory

try:  # optional: plain .npy files where zstandard is missing
    import zstandard
except ImportError:
    zstandard = None

_SEP = "/"
_CORRUPT_SUFFIX = ".corrupt"
CHUNK_BYTES = 256 << 20  # rows moved and hashed at a time


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed integrity verification (checksum mismatch, torn or
    missing leaf file, bad payload, unreadable manifest). Recovery is to
    quarantine and fall back (``restore_verified``)."""

    def __init__(self, msg: str, step: Optional[int] = None,
                 leaf: Optional[str] = None):
        super().__init__(msg)
        self.step = step
        self.leaf = leaf


class WorldMismatch(NotImplementedError):
    """A leaf's rows say it was written at another world size."""


# ---------------------------------------------------------------------------
# pytree walk (dicts and NamedTuples; None subtrees are skipped)
# ---------------------------------------------------------------------------


def _flatten(tree) -> Dict[str, Any]:
    flat = {}

    def rec(prefix, node):
        if node is None:  # optional subtree (a group without an L2 tier)
            return
        if isinstance(node, dict):
            for k, v in node.items():
                rec(f"{prefix}{_SEP}{k}" if prefix else str(k), v)
        elif hasattr(node, "_fields"):  # NamedTuple
            for k in node._fields:
                rec(f"{prefix}{_SEP}{k}" if prefix else str(k), getattr(node, k))
        else:
            flat[prefix] = node

    rec("", tree)
    return flat


def _unflatten_into(template, flat: Dict[str, Any]):
    def rec(prefix, node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: rec(f"{prefix}{_SEP}{k}" if prefix else str(k), v)
                    for k, v in node.items()}
        if hasattr(node, "_fields"):
            return type(node)(**{k: rec(f"{prefix}{_SEP}{k}" if prefix else str(k),
                                        getattr(node, k)) for k in node._fields})
        return flat[prefix]

    return rec("", template)


def _np_dtype(x) -> np.dtype:
    if isinstance(x, torch.Tensor):
        return torch.empty((), dtype=x.dtype).numpy().dtype
    if isinstance(x, (bool, np.bool_)):
        return np.dtype(np.bool_)
    if isinstance(x, int):  # the host step counter: the reference's int32
        return np.dtype(np.int32)
    return np.asarray(x).dtype


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else ()


def host_snapshot(tree) -> Any:
    """A host copy of every leaf (tensors to CPU copies, arrays copied), so
    a later in-place step cannot change what gets written. A leaf in mapped
    pinned memory (``--pin-l2``) is copied after the card's queued writes to
    it have landed."""
    flat = _flatten(tree)
    host_memory.wait_for_card(flat.values())

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        if isinstance(x, np.ndarray):
            return x.copy()
        return x

    return _unflatten_into(tree, {k: leaf(v) for k, v in flat.items()})


# ---------------------------------------------------------------------------
# streamed .npy leaves
# ---------------------------------------------------------------------------


def _npy_header(shape: Tuple[int, ...], dtype: np.dtype) -> bytes:
    """The header ``np.save`` writes for a C-ordered array of this shape."""
    d = {"descr": np.lib.format.dtype_to_descr(dtype), "fortran_order": False,
         "shape": tuple(int(s) for s in shape)}
    buf = io.BytesIO()
    try:
        np.lib.format.write_array_header_1_0(buf, d)
    except ValueError:  # a header past 64 KiB: version 2.0, as np.save
        buf = io.BytesIO()
        np.lib.format.write_array_header_2_0(buf, d)
    return buf.getvalue()


def _row_chunks(x, dtype: np.dtype):
    """The leaf's bytes in row chunks of at most ``CHUNK_BYTES``."""
    shape = _shape(x)
    if not isinstance(x, torch.Tensor):
        arr = np.ascontiguousarray(np.asarray(x, dtype=dtype))
        if arr.ndim == 0 or arr.nbytes <= CHUNK_BYTES:
            yield arr.tobytes()
            return
        x = torch.from_numpy(arr)
    if len(shape) == 0:
        yield x.detach().to("cpu").numpy().astype(dtype, copy=False).tobytes()
        return
    row_bytes = max(1, int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize)
    step = max(1, CHUNK_BYTES // row_bytes)
    for r0 in range(0, shape[0], step):
        chunk = x[r0:r0 + step].detach().to("cpu").contiguous().numpy()
        yield memoryview(chunk).cast("B")


class _CrcWriter:
    """File sink hashing the bytes as they land on disk."""

    def __init__(self, f):
        self.f, self.crc = f, 0

    def write(self, b) -> int:
        self.crc = zlib.crc32(b, self.crc)
        return self.f.write(b)

    def flush(self):
        self.f.flush()


def _write_leaf(path: Path, x, compress: bool) -> Tuple[int, Tuple[int, ...], np.dtype]:
    dtype = _np_dtype(x)
    shape = _shape(x)
    header = _npy_header(shape, dtype)
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    with open(path, "wb") as f:
        sink = _CrcWriter(f)
        if compress:
            # the pledged size puts the content size in the frame header, so
            # the reference's one-shot ``decompress`` reads the frame
            zw = zstandard.ZstdCompressor(level=3).stream_writer(
                sink, size=len(header) + nbytes, closefd=False)
            zw.write(header)
            for chunk in _row_chunks(x, dtype):
                zw.write(chunk)
            zw.flush(zstandard.FLUSH_FRAME)
            zw.close()
        else:
            sink.write(header)
            for chunk in _row_chunks(x, dtype):
                sink.write(chunk)
    return sink.crc & 0xFFFFFFFF, shape, dtype


def _file_crc(f) -> int:
    """crc32 of an open file's bytes, read from its start; leaves it
    positioned at its start again. Each read asks for no more than the
    bytes left: a read sized ``CHUNK_BYTES`` sets up a 256 MiB buffer
    however small the file, which some hosts' kernels make cost
    milliseconds (on the H100 host, seconds for a smoke checkpoint's
    small leaves)."""
    crc, left = 0, os.fstat(f.fileno()).st_size
    f.seek(0)
    while True:
        b = f.read(max(1, min(CHUNK_BYTES, left)))
        if not b:
            f.seek(0)
            return crc & 0xFFFFFFFF
        crc = zlib.crc32(b, crc)
        left -= len(b)


def _read_array(f, shape: Tuple[int, ...], dtype: np.dtype, what: str,
                order: str = "C") -> np.ndarray:
    """The next ``shape`` array of ``f``, read straight into a new array."""
    arr = np.empty(shape, dtype=dtype, order=order)
    mv = memoryview(arr.reshape(-1, order="A") if arr.ndim else arr.reshape(1)).cast("B")
    got = 0
    while got < len(mv):
        n = f.readinto(mv[got:])
        if not n:
            raise ValueError(f"{what}: payload ends {len(mv) - got} bytes short")
        got += n
    return arr


class _Payload:
    """An open leaf file (decompressed on the fly for ``.zst``) positioned
    just past its ``.npy`` header."""

    def __init__(self, raw, compressed: bool):
        self.raw = raw
        self.f = raw
        if compressed:
            self.f = zstandard.ZstdDecompressor().stream_reader(raw)
        version = np.lib.format.read_magic(self.f)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        self.shape, self.fortran, self.dtype = read(self.f)
        self.shape = tuple(self.shape)
        if not compressed:  # a short or long file fails here, not mid-load
            want = raw.tell() + int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize
            size = os.fstat(raw.fileno()).st_size
            if size != want:
                raise ValueError(f"file holds {size} bytes, its header says {want}")

    def close(self):
        if self.f is not self.raw:
            self.f.close()
        self.raw.close()


def _decode_errors():
    errs = (ValueError, OSError, EOFError)
    return errs + ((zstandard.ZstdError,) if zstandard is not None else ())


def _open_payload(raw, path: Path, name: str, step: int) -> _Payload:
    """``raw`` (the leaf's open file) as a payload; the caller closes it."""
    compressed = path.name.endswith(".zst")
    if compressed and zstandard is None:
        raise CheckpointCorrupt(
            f"checkpoint step_{step:08d}: leaf {name!r} is zstd-compressed "
            f"({path.name}) but this process has no 'zstandard' module to read it",
            step=step, leaf=name)
    try:
        return _Payload(raw, compressed)
    except _decode_errors() as e:
        raise CheckpointCorrupt(
            f"checkpoint step_{step:08d}: leaf {name!r} is not a valid .npy payload "
            f"({e})", step=step, leaf=name) from e


def _read_into(p: _Payload, t, rows: int, name: str, step: int):
    """The payload's data into ``t`` (a tensor: in place, by row chunks) or
    a new numpy array; ``rows`` of the stored rows are read."""
    dtype = p.dtype
    tail = p.shape[1:]
    row_bytes = max(1, int(np.prod(tail, dtype=np.int64)) * dtype.itemsize)
    try:
        if p.fortran or not isinstance(t, torch.Tensor) or len(p.shape) == 0:
            arr = _read_array(p.f, p.shape, dtype, name, "F" if p.fortran else "C")
            if len(p.shape):
                arr = arr[:rows]
            if isinstance(t, torch.Tensor):
                src = torch.from_numpy(np.array(arr, order="C"))
                (t if t.dim() == 0 else t[: src.shape[0]]).copy_(src)
                return t
            return arr
        step_rows = max(1, CHUNK_BYTES // row_bytes)
        tdt = _np_dtype(t)
        for r0 in range(0, rows, step_rows):
            r1 = min(rows, r0 + step_rows)
            arr = _read_array(p.f, (r1 - r0,) + tail, dtype, name)
            t[r0:r1].copy_(torch.from_numpy(arr.astype(tdt, copy=False)))
        return t
    except _decode_errors() as e:
        raise CheckpointCorrupt(f"checkpoint step_{step:08d}: leaf {name!r} unreadable "
                                f"({e})", step=step, leaf=name) from e


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------


def save_checkpoint(ckpt_dir: str, step: int, state: Any, keep: int = 3,
                    meta: Optional[Dict[str, Any]] = None,
                    salts: Optional[Dict[str, int]] = None) -> str:
    """Atomic checkpoint: write into a temporary directory, then rename.

    ``meta`` is the optional JSON sidecar (the trainer records the live plan
    revision, ``runtime.plan_meta``); ``salts`` the packing salts of the
    plan's tables (``core.features.table_salts``), which restores check.
    Leaves may live on any device; each is streamed to disk in row chunks,
    a leaf in mapped pinned memory after the card's queued writes to it.
    """
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_"))
    compress = zstandard is not None
    manifest = {}
    flat = _flatten(state)
    host_memory.wait_for_card(flat.values())
    try:
        for name, x in flat.items():
            fn = name.replace(_SEP, "__") + (".npy.zst" if compress else ".npy")
            crc, shape, dtype = _write_leaf(tmp / fn, x, compress)
            manifest[name] = {"file": fn, "shape": list(shape), "dtype": str(dtype),
                              "crc32": crc}
        doc = {"step": step, "leaves": manifest}
        if meta is not None:
            doc["meta"] = meta
        if salts is not None:
            doc["salts"] = {str(k): int(v) for k, v in salts.items()}
        (tmp / "manifest.json").write_text(json.dumps(doc))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc_checkpoints(ckpt_dir, keep)
    return str(final)


# ---------------------------------------------------------------------------
# directory bookkeeping
# ---------------------------------------------------------------------------


def _parse_step_dir(p: Path) -> Optional[int]:
    """``step_00000040`` -> 40; quarantined or unparseable entries -> None."""
    if not p.name.startswith("step_") or p.name.endswith(_CORRUPT_SUFFIX):
        return None
    try:
        return int(p.name.split("_")[1])
    except (IndexError, ValueError):
        return None


def _gc_checkpoints(ckpt_dir: Path, keep: int) -> None:
    # quarantined checkpoints are forensic evidence, never collected here
    steps = sorted(p for p in ckpt_dir.iterdir() if _parse_step_dir(p) is not None)
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def available_steps(ckpt_dir: str) -> List[int]:
    """Steps with a manifest on disk, ascending (quarantined dirs excluded)."""
    d = Path(ckpt_dir)
    if not d.exists():
        return []
    out = []
    for p in d.iterdir():
        s = _parse_step_dir(p)
        if s is not None and (p / "manifest.json").exists():
            out.append(s)
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def quarantine_checkpoint(ckpt_dir: str, step: int) -> Optional[str]:
    """Rename ``step_<n>`` -> ``step_<n>.corrupt`` so no reader sees it while
    the bytes stay on disk. Returns the new path, or ``None`` if the
    directory had already gone."""
    src = Path(ckpt_dir) / f"step_{step:08d}"
    if not src.exists():
        return None
    dst = src.with_name(src.name + _CORRUPT_SUFFIX)
    if dst.exists():  # re-quarantine of a rewritten step: keep both
        n = 1
        while dst.with_name(f"{src.name}{_CORRUPT_SUFFIX}.{n}").exists():
            n += 1
        dst = dst.with_name(f"{src.name}{_CORRUPT_SUFFIX}.{n}")
    os.rename(src, dst)
    return str(dst)


def _read_manifest(ckpt_dir: str, step: int) -> Dict[str, Any]:
    """Manifest of one step; unreadable -> CheckpointCorrupt, a missing
    directory -> FileNotFoundError (pruned, not corrupt)."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    if not d.exists():
        raise FileNotFoundError(f"no checkpoint step_{step:08d} under {ckpt_dir}")
    try:
        return json.loads((d / "manifest.json").read_text())
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointCorrupt(f"checkpoint step_{step:08d}: manifest unreadable ({e})",
                                step=step) from e


def _newest_readable(ckpt_dir: str, key: str) -> Optional[Any]:
    for s in reversed(available_steps(ckpt_dir)):
        try:
            return _read_manifest(ckpt_dir, s).get(key)
        except CheckpointCorrupt:
            continue  # restore_verified will quarantine it
    return None


def load_checkpoint_meta(ckpt_dir: str, step: Optional[int] = None
                         ) -> Optional[Dict[str, Any]]:
    """The ``meta`` sidecar of a checkpoint (``None`` if absent). With
    ``step=None`` it walks back from the newest checkpoint past any whose
    manifest is unreadable. Revise the plan from it before building the
    restore template: tier shapes follow the recorded revision."""
    if step is not None:
        return _read_manifest(ckpt_dir, step).get("meta")
    return _newest_readable(ckpt_dir, "meta")


def load_checkpoint_salts(ckpt_dir: str, step: Optional[int] = None
                          ) -> Optional[Dict[str, int]]:
    """The packing salts a checkpoint records (``None``: written without
    them, as the reference writes every checkpoint)."""
    if step is not None:
        return _read_manifest(ckpt_dir, step).get("salts")
    return _newest_readable(ckpt_dir, "salts")


def check_salts(recorded: Optional[Dict[str, int]], where: str = "checkpoint") -> bool:
    """Compare recorded packing salts with this process's; ``SaltMismatch``
    on a difference. Returns whether there was anything to check."""
    if recorded is None:
        return False
    from repro_torch.core.features import table_salt

    bad = {t: (int(v), table_salt(t)) for t, v in recorded.items() if table_salt(t) != int(v)}
    if bad:
        t, (was, now) = sorted(bad.items())[0]
        raise SaltMismatch(
            f"{where} was packed under other table salts than this process computes "
            f"({len(bad)} of {len(recorded)} tables differ; {t!r}: {was} there, {now} "
            "here): the salt is hash(table) % 10007 and Python salts str hashes per "
            "process, so run every process of a deployment under the same "
            "PYTHONHASHSEED (set PYTHONHASHSEED to the writer's value)")
    return True


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------


def restore_checkpoint(ckpt_dir: str, template: Any, step: Optional[int] = None,
                       shardings: Any = None, on_row_mismatch: str = "error",
                       verify: bool = True) -> Tuple[Any, int]:
    """Restore into ``template`` (a state of tensors, numpy arrays and host
    ints). Tensor leaves are filled in place, chunk by chunk; numpy leaves
    come back as new arrays and int leaves as host ints.

    ``verify`` (default on) re-hashes every leaf's bytes against the
    manifest's crc32 before any leaf is read, and raises
    ``CheckpointCorrupt`` on a mismatch, a missing leaf file or an
    unreadable manifest. The recorded packing salts are checked
    (``check_salts``). ``on_row_mismatch`` decides what a stored leaf whose
    leading dim differs from the template's does: ``'error'`` raises
    ``WorldMismatch``; ``'keep'`` returns the leaf at its stored rows (a new
    tensor on the template's device); ``'repad'`` zero-extends or truncates
    into the template's rows (states without cache tiers only).
    ``shardings`` is accepted for the reference's signature: at world 1 the
    placement is the template's own. A template leaf in mapped pinned memory
    (``--pin-l2``) is written after the card's queued work on it is done.
    """
    del shardings  # world 1: the template's placement is the placement
    if on_row_mismatch not in ("error", "keep", "repad"):
        raise ValueError(f"on_row_mismatch must be 'error', 'keep', or 'repad', got "
                         f"{on_row_mismatch!r}")
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    doc = _read_manifest(ckpt_dir, step)
    manifest = doc["leaves"]
    check_salts(doc.get("salts"), f"checkpoint step_{step:08d}")
    tflat = _flatten(template)
    # pass 1: every check that can fail (file, crc, header, size, shape)
    # before any leaf is written. Each leaf's file stays open until pass 2
    # has read it, so a publisher's or trainer's GC that removes the step
    # directory meanwhile cannot make the load fail half-way: the template
    # gets the whole checkpoint or none of it.
    held: Dict[str, Any] = {}
    try:
        for name, t in tflat.items():
            info = manifest.get(name)
            if info is None:
                raise KeyError(f"checkpoint step_{step:08d} has no leaf {name!r}: the "
                               "template enables state the run that wrote it did not "
                               "(e.g. an L2 tier turned on after checkpointing)")
            path = d / info["file"]
            try:
                raw = held[name] = open(path, "rb")
                crc = _file_crc(raw) if verify and "crc32" in info else None
            except OSError as e:
                raise CheckpointCorrupt(f"checkpoint step_{step:08d}: leaf file "
                                        f"{info['file']} missing or unreadable ({e})",
                                        step=step, leaf=name) from e
            if crc is not None and crc != info["crc32"]:
                raise CheckpointCorrupt(
                    f"checkpoint step_{step:08d}: leaf {name!r} checksum mismatch "
                    f"(stored {info['crc32']:#010x}, on-disk {crc:#010x}): torn write "
                    "or disk corruption", step=step, leaf=name)
            p = held[name] = _open_payload(raw, path, name, step)
            shape, tshape = p.shape, _shape(t)
            if shape != tshape:
                if not (len(shape) >= 1 and shape[1:] == tshape[1:]):
                    raise ValueError(f"{name}: stored {shape} vs template {tshape}")
                if on_row_mismatch == "error":
                    raise WorldMismatch(
                        f"{name}: stored {shape} vs template {tshape}: the row count "
                        "(world padding) differs, so this checkpoint was written at a "
                        "different world size. The elastic restore that remaps tier "
                        "sentinel keys (runtime.elastic) is ROADMAP Queue 1 item 6 and "
                        "not ported; a blind re-pad would corrupt them.")
        # pass 2: load, once no queued kernel reads or writes a mapped leaf
        host_memory.wait_for_card(tflat.values())
        out = {}
        for name, t in tflat.items():
            p = held[name]
            shape, tshape = p.shape, _shape(t)
            if isinstance(t, torch.Tensor):
                if shape == tshape:
                    out[name] = _read_into(p, t, shape[0] if shape else 0, name, step)
                elif on_row_mismatch == "keep":
                    fresh = torch.empty(shape, dtype=t.dtype, device=t.device)
                    out[name] = _read_into(p, fresh, shape[0], name, step)
                else:  # 'repad': zero tail rows, stored rows up to the template's
                    n = min(shape[0], tshape[0])
                    t[n:].zero_()
                    out[name] = _read_into(p, t, n, name, step)
            else:
                arr = _read_into(p, None, shape[0] if shape else 0, name, step)
                if shape != tshape and on_row_mismatch == "repad":
                    new = np.zeros(tshape, arr.dtype)
                    n = min(arr.shape[0], tshape[0])
                    new[:n] = arr[:n]
                    arr = new
                if isinstance(t, (bool, int, np.integer)) and not isinstance(t, np.ndarray):
                    out[name] = int(arr)
                elif isinstance(t, float):
                    out[name] = float(arr)
                else:
                    out[name] = arr.astype(_np_dtype(t), copy=False)
    finally:
        for h in held.values():
            h.close()
    return _unflatten_into(template, out), step


def restore_verified(ckpt_dir: str, template: Any, *, step: Optional[int] = None,
                     shardings: Any = None, on_row_mismatch: str = "error",
                     quarantine: bool = True,
                     log: Optional[Callable[[str], None]] = None) -> Tuple[Any, int]:
    """Restore the newest checkpoint that passes integrity verification.

    Walks the available steps newest-first (or from ``step`` down); one that
    raises ``CheckpointCorrupt`` is quarantined and the walk falls back to
    the previous one. Shape, world and salt mismatches propagate. Raises
    ``FileNotFoundError`` when no verifiable checkpoint remains.
    """
    log = log or (lambda s: None)
    steps = [s for s in reversed(available_steps(ckpt_dir)) if step is None or s <= step]
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    for s in steps:
        try:
            return restore_checkpoint(ckpt_dir, template, step=s, shardings=shardings,
                                      on_row_mismatch=on_row_mismatch, verify=True)
        except CheckpointCorrupt as e:
            if quarantine:
                q = quarantine_checkpoint(ckpt_dir, s)
                log(f"quarantined corrupt checkpoint step {s}"
                    f"{' -> ' + q if q else ''} ({e}); falling back")
            else:
                log(f"corrupt checkpoint step {s} ({e}); falling back")
    raise FileNotFoundError(f"no verifiable checkpoint under {ckpt_dir}: all "
                            f"{len(steps)} candidate(s) failed integrity checks")


class AsyncCheckpointer:
    """Snapshot to host, then write in a background thread.

    ``save`` copies every leaf to host memory before it returns: the port
    updates the state in place, so a writer reading live tensors while the
    next step runs would write a torn mixture of two steps. Host memory
    holds one snapshot (the whole state) while it is written."""

    def __init__(self, ckpt_dir: str, keep: int = 3,
                 salts: Optional[Dict[str, int]] = None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.salts = salts
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_path: Optional[str] = None

    def save(self, step: int, state: Any, meta: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        host_state = host_snapshot(state)  # synchronous snapshot, async write

        def work():
            try:
                self.last_path = save_checkpoint(self.ckpt_dir, step, host_state,
                                                 self.keep, meta=meta, salts=self.salts)
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
