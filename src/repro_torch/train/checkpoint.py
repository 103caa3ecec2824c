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

World size: a leaf whose rows differ from the template's was written at
another world size; ``on_row_mismatch='error'`` raises ``WorldMismatch`` (a
``ValueError``, the class the reference raises) pointing to the elastic
restore (``runtime.elastic.restore_elastic``, which remaps the tier
sentinels); ``'keep'`` and ``'repad'`` have the reference's meaning at any
world.

Past world 1 (``group=`` a ``dist.Group`` of world W, on every rank at
once) a checkpoint is still the *logical* state, file for file what the
reference writes from its one process at the same mesh: a row-sharded leaf
(``w``/``acc``/``counts``, the narrow master; ``dist.sharding``) is one file
holding every rank's rows in rank order, padding rows included, and a
replicated leaf (tiers, projection, dense parameters, Adam, ``step``) is
written once. Leaf ``k`` of the flattened state has an owner, rank ``k %
W``, which writes, hashes and reads what one rank must:

* a row-sharded ``.npy`` leaf: the owner writes the header and each rank
  writes its own rows at their offset, chunk by chunk, hashing them; the
  file's crc32 is combined from the parts (``crc32_combine``). On restore
  each rank hashes and reads its own rows in place, and the parts' crcs
  are combined on every rank, so every rank reaches the same verdict;
* a row-sharded ``.npy.zst`` leaf is one zstd frame (the reference reads
  only the first frame of a file): the owner compresses it, every other
  rank sending its rows in chunks, and on restore the owner hashes and
  decompresses it once and sends each rank its rows chunk by chunk, so no
  rank decompresses the stream up to its block;
* a replicated leaf: the owner writes its own replica; on restore it
  hashes and reads the file once and broadcasts it in chunks.

Host memory holds at most a chunk (``CHUNK_BYTES``) a rank. The bytes and
verdicts move on the checkpoint group (``Group.ckpt_pg``), never on the
step's. A save writes into a temporary directory, then agrees, and rank 0
writes the manifest, renames the directory to ``step_<n>`` (so it appears
only with every rank's rows in it) and collects old steps; every rank
returns after the rename. The steps a directory holds, its manifest and
meta are read by rank 0 and broadcast; ``restore_verified`` walks that one
list, every rank raises the same error, and rank 0 quarantines a corrupt
step once, after every rank has closed its files and before any rank
goes on. A checkpoint written at another world (its rows, or the world its
meta records) raises ``WorldMismatch`` under ``'error'``. ``'keep'`` gives
rank ``r`` rows ``[r*R/W, (r+1)*R/W)`` of a leaf stored with ``R`` rows, in a
new tensor; ``'repad'`` gives each rank its cut of the template's rows,
read from the stored rows and zero past them: the logical leaf zero-extended
or truncated, as at world 1. ``restore_resharded`` is ``'repad'`` with the
check the elastic restore needs: the rows a cut drops hold no FCounter
mass, read by the rank that reads them and agreed before anything is
written. ``.npy`` leaves are read by each rank at its own cut; a
``.npy.zst`` leaf stays one frame, read by its owner, who sends each rank
its cut's rows.
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
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.features import SaltMismatch
from repro_torch.dist import compat
from repro_torch.dist.compat import WORLD1, Group
from repro_torch.dist.sharding import row_sharded_leaf
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

    def __reduce__(self):  # keeps step and leaf across ranks
        return (type(self), (str(self), self.step, self.leaf))


class WorldMismatch(ValueError):
    """A leaf's rows, or the meta, say it was written at another world size."""


_ELASTIC = ("Restore through the elastic path (runtime.elastic.restore_elastic / "
            "embedding.state.reshard_state), which remaps tier sentinel keys; a blind "
            "re-pad would corrupt them.")


def _group(group: Optional[Group]) -> Group:
    return WORLD1 if group is None else group


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


def _host_leaf(t, arr: np.ndarray):
    """A stored array as the template's non-tensor leaf: a host int or
    float, or an array of the template's dtype."""
    if isinstance(t, (bool, int, np.integer)) and not isinstance(t, np.ndarray):
        return int(arr)
    if isinstance(t, float):
        return float(arr)
    return arr.astype(_np_dtype(t), copy=False)


def device_snapshot(tree) -> Any:
    """A copy of every leaf on its own device (tensors cloned, arrays
    copied), so a later in-place step cannot change what gets written,
    without staging the state through host memory."""
    flat = _flatten(tree)
    host_memory.wait_for_card(flat.values())

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach().clone()
        if isinstance(x, np.ndarray):
            return x.copy()
        return x

    return _unflatten_into(tree, {k: leaf(v) for k, v in flat.items()})


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


def _open_checked(d: Path, info: Dict[str, Any], name: str, step: int, verify: bool,
                  held: Dict[Any, Any], key: Any) -> _Payload:
    """A leaf's file opened, its bytes checked against the manifest's crc32
    (``verify``) and its payload opened; the handle stays in ``held[key]``
    for the caller to close. Raises ``CheckpointCorrupt``."""
    path = d / info["file"]
    try:
        raw = held[key] = open(path, "rb")
        crc = _file_crc(raw) if verify and "crc32" in info else None
    except OSError as e:
        raise CheckpointCorrupt(f"checkpoint step_{step:08d}: leaf file {info['file']} "
                                f"missing or unreadable ({e})", step=step, leaf=name) from e
    if crc is not None and crc != info["crc32"]:
        raise CheckpointCorrupt(
            f"checkpoint step_{step:08d}: leaf {name!r} checksum mismatch "
            f"(stored {info['crc32']:#010x}, on-disk {crc:#010x}): torn write "
            "or disk corruption", step=step, leaf=name)
    p = held[key] = _open_payload(raw, path, name, step)
    return p


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
                    salts: Optional[Dict[str, int]] = None,
                    group: Optional[Group] = None) -> str:
    """Atomic checkpoint: write into a temporary directory, then rename.

    ``meta`` is the optional JSON sidecar (the trainer records the live plan
    revision, ``runtime.plan_meta``); ``salts`` the packing salts of the
    plan's tables (``core.features.table_salts``), which restores check.
    Leaves may live on any device; each is streamed to disk in row chunks,
    a leaf in mapped pinned memory after the card's queued writes to it.
    Past world 1 every rank of ``group`` calls it with its own state and
    they write one checkpoint together (module docstring).
    """
    if _group(group).world > 1:
        return _save_ranks(ckpt_dir, step, state, keep, meta, salts, group)
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


def available_steps(ckpt_dir: str, group: Optional[Group] = None) -> List[int]:
    """Steps with a manifest on disk, ascending (quarantined dirs excluded);
    past world 1, rank 0's listing on every rank."""
    if _group(group).world > 1:
        return _on_rank0(lambda: available_steps(ckpt_dir), group)
    d = Path(ckpt_dir)
    if not d.exists():
        return []
    out = []
    for p in d.iterdir():
        s = _parse_step_dir(p)
        if s is not None and (p / "manifest.json").exists():
            out.append(s)
    return sorted(out)


def latest_step(ckpt_dir: str, group: Optional[Group] = None) -> Optional[int]:
    steps = available_steps(ckpt_dir, group)
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


def load_checkpoint_meta(ckpt_dir: str, step: Optional[int] = None,
                         group: Optional[Group] = None) -> Optional[Dict[str, Any]]:
    """The ``meta`` sidecar of a checkpoint (``None`` if absent). With
    ``step=None`` it walks back from the newest checkpoint past any whose
    manifest is unreadable. Revise the plan from it before building the
    restore template: tier shapes follow the recorded revision. Past world
    1, rank 0 reads it for every rank."""
    if _group(group).world > 1:
        return _on_rank0(lambda: load_checkpoint_meta(ckpt_dir, step), group)
    if step is not None:
        return _read_manifest(ckpt_dir, step).get("meta")
    return _newest_readable(ckpt_dir, "meta")


def load_checkpoint_salts(ckpt_dir: str, step: Optional[int] = None,
                          group: Optional[Group] = None) -> Optional[Dict[str, int]]:
    """The packing salts a checkpoint records (``None``: written without
    them, as the reference writes every checkpoint); past world 1, rank 0's
    reading on every rank."""
    if _group(group).world > 1:
        return _on_rank0(lambda: load_checkpoint_salts(ckpt_dir, step), group)
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
                       verify: bool = True, group: Optional[Group] = None
                       ) -> Tuple[Any, int]:
    """Restore into ``template`` (a state of tensors, numpy arrays and host
    ints). Tensor leaves are filled in place, chunk by chunk; numpy leaves
    come back as new arrays and int leaves as host ints.

    ``verify`` (default on) re-hashes every leaf's bytes against the
    manifest's crc32 before any leaf is read, and raises
    ``CheckpointCorrupt`` on a mismatch, a missing leaf file or an
    unreadable manifest. The recorded packing salts are checked
    (``check_salts``). ``on_row_mismatch`` decides what a stored leaf whose
    leading dim differs from the template's does: ``'error'`` raises
    ``WorldMismatch`` (a ``ValueError``) with the pointer to
    ``runtime.elastic.restore_elastic``; ``'keep'`` returns the leaf at its
    stored rows (a new tensor on the template's device; past world 1 each
    rank's equal share of them); ``'repad'`` zero-extends or truncates into
    the template's rows (states without cache tiers only: the sentinels are
    not remapped).
    ``shardings`` is accepted for the reference's signature: the placement
    is the template's own (past world 1, this rank's rows). A template leaf
    in mapped pinned memory (``--pin-l2``) is written after the card's
    queued work on it is done. Past world 1 every rank of ``group`` calls
    it with its own template; each gets its rows of the row-sharded leaves
    and every replicated leaf, and every rank raises the same error
    (module docstring).
    """
    del shardings  # the template's placement is the placement
    if on_row_mismatch not in ("error", "keep", "repad"):
        raise ValueError(f"on_row_mismatch must be 'error', 'keep', or 'repad', got "
                         f"{on_row_mismatch!r}")
    if _group(group).world > 1:
        return _restore_ranks(ckpt_dir, template, step, on_row_mismatch, verify, group)
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
            p = _open_checked(d, info, name, step, verify, held, name)
            shape, tshape = p.shape, _shape(t)
            if shape != tshape:
                if not (len(shape) >= 1 and shape[1:] == tshape[1:]):
                    raise ValueError(f"{name}: stored {shape} vs template {tshape}")
                if on_row_mismatch == "error":
                    raise WorldMismatch(
                        f"{name}: stored {shape} vs template {tshape}: the row count "
                        "(world padding) differs, so this checkpoint was written at a "
                        f"different world size. {_ELASTIC}")
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
                if on_row_mismatch == "repad":
                    arr = _repad(arr, tshape)
                out[name] = _host_leaf(t, arr)
    finally:
        for h in held.values():
            h.close()
    return _unflatten_into(template, out), step


def restore_verified(ckpt_dir: str, template: Any, *, step: Optional[int] = None,
                     shardings: Any = None, on_row_mismatch: str = "error",
                     quarantine: bool = True,
                     log: Optional[Callable[[str], None]] = None,
                     group: Optional[Group] = None) -> Tuple[Any, int]:
    """Restore the newest checkpoint that passes integrity verification.

    Walks the available steps newest-first (or from ``step`` down); one that
    raises ``CheckpointCorrupt`` is quarantined and the walk falls back to
    the previous one. Shape, world and salt mismatches propagate. Raises
    ``FileNotFoundError`` when no verifiable checkpoint remains. Past world
    1 every rank walks rank 0's list, reaches the same verdicts and restores
    the same step; rank 0 quarantines a corrupt step once, while no rank
    has it open.
    """
    log = log or (lambda s: None)
    grp = _group(group)
    steps = [s for s in reversed(available_steps(ckpt_dir, grp)) if step is None or s <= step]
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    for s in steps:
        try:
            return restore_checkpoint(ckpt_dir, template, step=s, shardings=shardings,
                                      on_row_mismatch=on_row_mismatch, verify=True,
                                      group=grp)
        except CheckpointCorrupt as e:
            if quarantine:
                q = (quarantine_checkpoint(ckpt_dir, s) if grp.world == 1
                     else _on_rank0(lambda: quarantine_checkpoint(ckpt_dir, s), grp))
                log(f"quarantined corrupt checkpoint step {s}"
                    f"{' -> ' + q if q else ''} ({e}); falling back")
            else:
                log(f"corrupt checkpoint step {s} ({e}); falling back")
    raise FileNotFoundError(f"no verifiable checkpoint under {ckpt_dir}: all "
                            f"{len(steps)} candidate(s) failed integrity checks")


# ---------------------------------------------------------------------------
# past world 1: the ranks write and read one checkpoint (module docstring)
# ---------------------------------------------------------------------------


def _gf2_times(mat: List[int], vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat: List[int]) -> List[int]:
    return [_gf2_times(mat, m) for m in mat]


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """zlib's ``crc32_combine`` (which Python's ``zlib`` does not expose):
    the crc32 of ``a + b`` from ``crc32(a)``, ``crc32(b)`` and ``len(b)``."""
    if len2 <= 0:
        return crc1 & 0xFFFFFFFF
    odd = [0xEDB88320] + [1 << n for n in range(31)]  # the operator for one zero bit
    even = _gf2_square(odd)  # two zero bits
    odd = _gf2_square(even)  # four
    while True:  # apply len2 zero bytes to crc1
        even = _gf2_square(odd)
        if len2 & 1:
            crc1 = _gf2_times(even, crc1)
        len2 >>= 1
        if not len2:
            break
        odd = _gf2_square(even)
        if len2 & 1:
            crc1 = _gf2_times(odd, crc1)
        len2 >>= 1
        if not len2:
            break
    return (crc1 ^ crc2) & 0xFFFFFFFF


def _on_rank0(fn: Callable[[], Any], group: Group) -> Any:
    """``fn()`` run on rank 0; its value, or its exception raised, on every
    rank."""
    res = None
    if group.rank == 0:
        try:
            res = ("ok", fn())
        except Exception as e:  # noqa: BLE001 — raised again on every rank
            res = ("err", e)
    res = compat.ckpt_broadcast_object(res, group)
    if res[0] == "err":
        raise res[1]
    return res[1]


def _first_error(errors: List[Tuple[int, BaseException]]) -> Optional[BaseException]:
    """The error of the lowest leaf index (the lowest rank's among equals)."""
    return min(errors, key=lambda e: e[0])[1] if errors else None


def _agree_errors(errors: List[Tuple[int, BaseException]], group: Group) -> None:
    """Raise on every rank the first error any rank hit (``_first_error``)."""
    every = [e for errs in compat.ckpt_gather_objects(errors, group) for e in errs]
    err = _first_error(every)
    if err is not None:
        raise err


def _bytes_tensor(chunk) -> torch.Tensor:
    """A chunk's bytes as a host uint8 tensor (no copy where it is writable)."""
    a = np.frombuffer(chunk, dtype=np.uint8)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _pwrite_all(fd: int, b, off: int) -> None:
    mv = memoryview(b).cast("B")
    while len(mv):
        n = os.pwrite(fd, mv, off)
        mv, off = mv[n:], off + n


def _write_rows(path: Path, x, owner: int, group: Group):
    """This rank's rows of a row-sharded leaf into their place in the
    leaf's ``.npy`` file (the owner also writes the header); the logical
    shape, the dtype, the header's (crc, bytes) on the owner and the rows'
    (crc, bytes)."""
    dtype, shape = _np_dtype(x), _shape(x)
    logical = (shape[0] * group.world,) + shape[1:]
    header = _npy_header(logical, dtype)
    row_bytes = int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize
    off = len(header) + group.rank * shape[0] * row_bytes
    crc = n = 0
    fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        if group.rank == owner:
            _pwrite_all(fd, header, 0)
        for chunk in _row_chunks(x, dtype):
            crc = zlib.crc32(chunk, crc)
            _pwrite_all(fd, chunk, off + n)
            n += len(memoryview(chunk).cast("B"))
    finally:
        os.close(fd)
    head = (zlib.crc32(header) & 0xFFFFFFFF, len(header)) if group.rank == owner else None
    return logical, dtype, head, (crc & 0xFFFFFFFF, n)


def _write_gathered(path: Path, x, owner: int, group: Group, tag: int, write: bool):
    """A row-sharded leaf as one zstd frame: the owner compresses every
    rank's rows in rank order, each other rank sending its own chunk by
    chunk. The owner goes on receiving after a write error (so no sender
    waits forever) and returns ``((crc, logical shape, dtype), error)``;
    the others ``(None, None)``."""
    dtype, shape = _np_dtype(x), _shape(x)
    if group.rank != owner:
        for chunk in _row_chunks(x, dtype):
            compat.ckpt_send_bytes(_bytes_tensor(chunk), owner, group, tag)
        return None, None
    rps = shape[0]
    logical = (rps * group.world,) + shape[1:]
    header = _npy_header(logical, dtype)
    row_bytes = max(1, int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize)
    step_rows = max(1, CHUNK_BYTES // row_bytes)
    own = _row_chunks(x, dtype)
    err, f, sink, zw = None, None, None, None
    try:
        if write:
            f = open(path, "wb")
            sink = _CrcWriter(f)
            zw = zstandard.ZstdCompressor(level=3).stream_writer(
                sink, size=len(header) + int(np.prod(logical, dtype=np.int64)) * dtype.itemsize,
                closefd=False)
            zw.write(header)
        for p in range(group.world):
            for r0 in range(0, rps, step_rows):
                if p == group.rank:
                    data = next(own)
                else:
                    nb = (min(rps, r0 + step_rows) - r0) * row_bytes
                    data = compat.ckpt_recv_bytes(torch.empty(nb, dtype=torch.uint8), p,
                                                  group, tag).numpy()
                if zw is not None and err is None:
                    try:
                        zw.write(data)
                    except (OSError, zstandard.ZstdError) as e:
                        err = e
        if zw is not None and err is None:
            zw.flush(zstandard.FLUSH_FRAME)
            zw.close()
    except (OSError, zstandard.ZstdError) as e:
        err = err or e
    finally:
        if f is not None:
            f.close()
    return ((sink.crc & 0xFFFFFFFF, logical, dtype) if sink is not None else None), err


def _save_ranks(ckpt_dir, step: int, state: Any, keep: int, meta, salts,
                group: Group) -> str:
    """``save_checkpoint`` past world 1 (module docstring)."""
    ckpt_dir = Path(ckpt_dir)
    flat = _flatten(state)
    host_memory.wait_for_card(flat.values())
    compress = all(compat.ckpt_gather_objects(zstandard is not None, group))

    def mkdir():
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        return tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")

    tmp = Path(_on_rank0(mkdir, group))
    errors: List[Tuple[int, BaseException]] = []
    entries: Dict[str, Dict[str, Any]] = {}   # leaves this rank wrote whole
    heads: Dict[str, Tuple[int, int]] = {}    # the .npy headers it wrote
    parts: Dict[str, Tuple[int, int]] = {}    # its rows of row-sharded .npy leaves
    for k, (name, x) in enumerate(flat.items()):
        owner = k % group.world
        fn = name.replace(_SEP, "__") + (".npy.zst" if compress else ".npy")
        sharded = row_sharded_leaf(name) and len(_shape(x)) >= 1
        try:
            if sharded and compress:
                got, err = _write_gathered(tmp / fn, x, owner, group, k, not errors)
                if err is not None:
                    raise err
            elif sharded:
                if errors:
                    continue
                logical, dtype, head, part = _write_rows(tmp / fn, x, owner, group)
                parts[name] = part
                if head is not None:
                    heads[name] = head
                    entries[name] = {"file": fn, "shape": list(logical), "dtype": str(dtype)}
                continue
            elif group.rank == owner and not errors:
                got = _write_leaf(tmp / fn, x, compress)
            else:
                continue
            if got is not None:
                crc, shape, dtype = got
                entries[name] = {"file": fn, "shape": list(shape), "dtype": str(dtype),
                                 "crc32": crc}
        except OSError as e:
            errors.append((k, e))
    reports = compat.ckpt_gather_objects((errors, entries, heads, parts), group)
    err = _first_error([e for r in reports for e in r[0]])
    if err is not None:
        if group.rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
        raise err

    def finish() -> str:
        manifest = {}
        for name in flat:
            info = next(r[1][name] for r in reports if name in r[1])
            if name in parts:  # the header, then every rank's rows in rank order
                crc = next(r[2][name] for r in reports if name in r[2])[0]
                for r in reports:
                    crc = crc32_combine(crc, *r[3][name])
                info = {**info, "crc32": crc}
            manifest[name] = info
        doc = {"step": step, "leaves": manifest}
        if meta is not None:
            doc["meta"] = meta
        if salts is not None:
            doc["salts"] = {str(k): int(v) for k, v in salts.items()}
        final = ckpt_dir / f"step_{step:08d}"
        try:
            (tmp / "manifest.json").write_text(json.dumps(doc))
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        _gc_checkpoints(ckpt_dir, keep)
        return str(final)

    return _on_rank0(finish, group)


_RECUT = "recut"  # restore_resharded's mode: 'repad' and the dropped-tail check


class _Leaf(NamedTuple):
    """One leaf of a restore past world 1: who reads it and how."""

    k: int
    name: str
    t: Any              # the template's leaf
    info: Dict[str, Any]
    owner: int
    sharded: bool       # row-sharded: rank r's leaf is the cut of rps rows from r * rps
    block: bool         # a row-sharded .npy leaf: each rank reads its cut from the file
    stored: Tuple[int, ...]
    want: Tuple[int, ...]   # the logical shape the template holds
    rps: int            # a row-sharded leaf's rows a rank; else 0
    fresh: bool         # 'keep' of another row count: a new tensor at the stored rows


def _leaf_plan(k: int, name: str, t, info: Dict[str, Any], group: Group,
               mode: str) -> _Leaf:
    stored = tuple(int(v) for v in info["shape"])
    tshape = _shape(t)
    sharded = row_sharded_leaf(name) and isinstance(t, torch.Tensor) and len(tshape) >= 1
    want = (tshape[0] * group.world,) + tshape[1:] if sharded else tshape
    fresh = mode == "keep" and len(stored) >= 1 and stored[:1] != want[:1]
    rps = (stored[0] // group.world if fresh else tshape[0]) if sharded else 0
    block = sharded and not info["file"].endswith(".zst")
    return _Leaf(k, name, t, info, k % group.world, sharded, block, stored, want, rps,
                 fresh)


def _shape_error(lp: _Leaf, mode: str, group: Group) -> Optional[BaseException]:
    """The stored shape against the template's under ``mode``: the same
    verdict on every rank (both come from the manifest and the template)."""
    if lp.stored == lp.want:
        return None
    if not (len(lp.stored) >= 1 and lp.stored[1:] == lp.want[1:]):
        return ValueError(f"{lp.name}: stored {lp.stored} vs template {lp.want}")
    if mode == "error":
        return WorldMismatch(
            f"{lp.name}: stored {lp.stored} vs {lp.want} at this world: the row count "
            "(world padding) differs, so this checkpoint was written at a different world "
            f"size. {_ELASTIC}")
    if mode == _RECUT and not lp.sharded:
        return ValueError(f"{lp.name}: stored {lp.stored} vs template {lp.want}: only the "
                          "row-sharded leaves' rows change with the world; shape the "
                          "template by the checkpoint's plan revision (apply_plan_meta)")
    if lp.fresh and lp.sharded and lp.stored[0] % group.world:
        return ValueError(f"{lp.name}: on_row_mismatch='keep' of {lp.stored[0]} stored rows "
                          f"over {group.world} ranks: they do not split")
    return None


def _cut(lp: _Leaf, rank: int) -> Tuple[int, int]:
    """The stored rows ``[a, b)`` rank ``rank`` reads into the first rows of
    its leaf of a row-sharded leaf (its rows past ``b - a`` are zero)."""
    lo = rank * lp.rps
    return min(lo, lp.stored[0]), min(lo + lp.rps, lp.stored[0])


def _dropped_tail(lp: _Leaf, group: Group) -> int:
    """Stored rows of an FCounter leaf past every rank's cut (the rows a
    ``restore_resharded`` drops), else 0."""
    if not (lp.sharded and lp.name.endswith(_SEP + "counts")):
        return 0
    return max(0, lp.stored[0] - group.world * lp.rps)


def _tail_error(lp: _Leaf, tail: np.ndarray, s: int) -> Optional[BaseException]:
    if not np.asarray(tail).any():
        return None
    return ValueError(f"checkpoint step_{s:08d}: {lp.name}: restoring {lp.stored[0]} stored "
                      f"rows into {lp.want[0]} would drop rows with nonzero FCounter mass: "
                      "the truncated tail must be pure padding")


def _repad(arr: np.ndarray, tshape: Tuple[int, ...]) -> np.ndarray:
    """``arr`` zero-extended or truncated to ``tshape``'s rows."""
    if tuple(arr.shape) == tuple(tshape):
        return arr
    new = np.zeros(tshape, arr.dtype)
    n = min(arr.shape[0], tshape[0])
    new[:n] = arr[:n]
    return new


def _npy_head(raw) -> Tuple[Tuple[int, ...], bool, np.dtype, int]:
    """An open ``.npy`` file's shape, order, dtype and header length."""
    raw.seek(0)
    version = np.lib.format.read_magic(raw)
    read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
            else np.lib.format.read_array_header_2_0)
    shape, fortran, dtype = read(raw)
    return tuple(shape), fortran, dtype, raw.tell()


def _region_crc(raw, start: int, length: int) -> Tuple[int, int]:
    """(crc32, bytes) of ``length`` bytes of ``raw`` from ``start``, or of
    as many as the file holds."""
    raw.seek(start)
    crc = got = 0
    while got < length:
        b = raw.read(min(CHUNK_BYTES, length - got))
        if not b:
            break
        crc = zlib.crc32(b, crc)
        got += len(b)
    return crc & 0xFFFFFFFF, got


def _check_block(lp: _Leaf, d: Path, s: int, verify: bool, group: Group, held: dict,
                 tail: bool):
    """Pass 1 of a row-sharded ``.npy`` leaf on this rank: open it, hash
    its header (the owner) and this rank's cut of the stored rows (the last
    rank's runs to the stored end, so the parts tile the file). Returns the
    header's and rows' (crc, bytes) and the leaf's problem, if any (judged
    after the crc): a header that disagrees with the manifest, or, with
    ``tail``, FCounter mass in the rows the cut drops (read by the last
    rank)."""
    path = d / lp.info["file"]
    try:
        raw = held[lp.k] = open(path, "rb")
        shape, fortran, dtype, hlen = _npy_head(raw)
    except (OSError, ValueError, EOFError) as e:
        raise CheckpointCorrupt(f"checkpoint step_{s:08d}: leaf {lp.name!r} missing or not "
                                f"a valid .npy file ({e})", step=s, leaf=lp.name) from e
    dt = np.dtype(lp.info["dtype"])
    row_bytes = int(np.prod(lp.stored[1:], dtype=np.int64)) * dt.itemsize
    a, b = _cut(lp, group.rank)
    last = group.rank == group.world - 1
    if last:
        b = lp.stored[0]
    head = part = late = None
    if verify and "crc32" in lp.info:
        if group.rank == lp.owner:
            head = _region_crc(raw, 0, hlen)
        part = _region_crc(raw, hlen + a * row_bytes, (b - a) * row_bytes)
    size = os.fstat(raw.fileno()).st_size
    if (shape, fortran, dtype) != (lp.stored, False, dt):
        late = CheckpointCorrupt(
            f"checkpoint step_{s:08d}: leaf {lp.name!r} header says {shape} {dtype} "
            f"(fortran={fortran}), its manifest {lp.stored} {dt}", step=s, leaf=lp.name)
    elif size != hlen + lp.stored[0] * row_bytes:
        late = CheckpointCorrupt(
            f"checkpoint step_{s:08d}: leaf {lp.name!r} is not a valid .npy payload "
            f"(file holds {size} bytes, its header says {hlen + lp.stored[0] * row_bytes})",
            step=s, leaf=lp.name)
    elif tail and last and (n := _dropped_tail(lp, group)):
        raw.seek(hlen + (lp.stored[0] - n) * row_bytes)
        late = _tail_error(lp, _read_array(raw, (n,) + lp.stored[1:], dt, lp.name), s)
    return head, part, late


def _check_owned(lp: _Leaf, d: Path, s: int, verify: bool, held: dict, group: Group,
                 tail: bool) -> None:
    """Pass 1 of a leaf its owner reads whole: open, hash, header against
    the manifest; with ``tail``, the FCounter rows a cut drops, read
    through a second handle so the payload stays at its first row."""
    p = _open_checked(d, lp.info, lp.name, s, verify, held, lp.k)
    if p.shape != lp.stored or p.dtype != np.dtype(lp.info["dtype"]):
        raise CheckpointCorrupt(f"checkpoint step_{s:08d}: leaf {lp.name!r} holds "
                                f"{p.shape} {p.dtype}, its manifest {lp.stored} "
                                f"{lp.info['dtype']}", step=s, leaf=lp.name)
    n = _dropped_tail(lp, group) if tail else 0
    if n:
        path = d / lp.info["file"]
        q = _open_payload(open(path, "rb"), path, lp.name, s)
        try:
            dt, keep = p.dtype, lp.stored[0] - n
            row_bytes = int(np.prod(lp.stored[1:], dtype=np.int64)) * dt.itemsize
            for r0, r1 in _chunks(keep, row_bytes):  # the kept rows, read past
                _read_array(q.f, (r1 - r0,) + lp.stored[1:], dt, lp.name)
            err = _tail_error(lp, _read_array(q.f, (n,) + lp.stored[1:], dt, lp.name), s)
        except _decode_errors() as e:
            raise CheckpointCorrupt(f"checkpoint step_{s:08d}: leaf {lp.name!r} unreadable "
                                    f"({e})", step=s, leaf=lp.name) from e
        finally:
            q.close()
        if err is not None:
            raise err


def _chunks(rows: int, row_bytes: int):
    step = max(1, CHUNK_BYTES // max(1, row_bytes))
    return [(r0, min(rows, r0 + step)) for r0 in range(0, rows, step)]


def _put(t: torch.Tensor, r0: int, r1: int, arr: np.ndarray) -> None:
    t[r0:r1].copy_(torch.from_numpy(arr.astype(_np_dtype(t), copy=False)))


class _OwnerReader:
    """The owner's reads of a payload, chunk by chunk in C order; after an
    error it hands out zeros (so every receiver gets its chunks) and keeps
    the first error."""

    def __init__(self, p: _Payload, lp: _Leaf, s: int):
        self.p, self.lp, self.s = p, lp, s
        self.dtype = np.dtype(lp.info["dtype"])
        self.err: Optional[BaseException] = None
        self.whole = None
        if p.fortran:  # never written by either package: read it whole
            self.whole = self._guard(lambda: np.ascontiguousarray(
                _read_array(p.f, p.shape, self.dtype, lp.name, "F")))

    def _guard(self, fn):
        try:
            return fn()
        except _decode_errors() as e:
            self.err = self.err or CheckpointCorrupt(
                f"checkpoint step_{self.s:08d}: leaf {self.lp.name!r} unreadable ({e})",
                step=self.s, leaf=self.lp.name)
            return None

    def rows(self, r0: int, r1: int) -> np.ndarray:
        shape = (r1 - r0,) + self.lp.stored[1:]
        arr = None
        if self.err is None:
            arr = (self.whole[r0:r1] if self.whole is not None else
                   self._guard(lambda: _read_array(self.p.f, shape, self.dtype, self.lp.name)))
        return arr if arr is not None else np.zeros(shape, self.dtype)


def _load_leaf(lp: _Leaf, held: dict, s: int, group: Group, mode: str):
    """Pass 2 of one leaf: this rank's value and its error, if any."""
    t, rank, tail = lp.t, group.rank, lp.stored[1:]
    dt = np.dtype(lp.info["dtype"])
    row_bytes = int(np.prod(tail, dtype=np.int64)) * dt.itemsize
    if lp.sharded and lp.fresh:
        t = torch.empty((lp.rps,) + tuple(tail), dtype=t.dtype, device=t.device)
    if lp.block:  # this rank's cut, in place, from its own open file
        a, b = _cut(lp, rank)
        raw = held[lp.k]
        _, _, _, hlen = _npy_head(raw)
        raw.seek(hlen + a * row_bytes)
        try:
            for r0, r1 in _chunks(b - a, row_bytes):
                _put(t, r0, r1, _read_array(raw, (r1 - r0,) + tail, dt, lp.name))
        except _decode_errors() as e:
            return t, CheckpointCorrupt(f"checkpoint step_{s:08d}: leaf {lp.name!r} "
                                        f"unreadable ({e})", step=s, leaf=lp.name)
        t[b - a:].zero_()
        return t, None
    reader = _OwnerReader(held[lp.k], lp, s) if rank == lp.owner else None
    if lp.sharded:  # the owner decompresses once and sends each rank its cut
        for q in range(group.world):
            if rank not in (q, lp.owner):
                continue
            a, b = _cut(lp, q)
            for r0, r1 in _chunks(b - a, row_bytes):
                if rank == lp.owner:
                    arr = reader.rows(a + r0, a + r1)
                    if q == rank:
                        _put(t, r0, r1, arr)
                    else:
                        compat.ckpt_send_bytes(_bytes_tensor(arr), q, group, lp.k)
                else:
                    buf = torch.empty((r1 - r0) * row_bytes, dtype=torch.uint8)
                    compat.ckpt_recv_bytes(buf, lp.owner, group, lp.k)
                    _put(t, r0, r1, buf.numpy().view(dt).reshape((r1 - r0,) + tail))
            if q == rank:
                t[b - a:].zero_()
        return t, reader.err if reader is not None else None
    if isinstance(t, torch.Tensor) and t.dim() >= 1:  # replicated: read once, broadcast
        if lp.fresh:
            t = torch.empty(lp.stored, dtype=t.dtype, device=t.device)
        rows = min(lp.stored[0], t.shape[0])  # 'repad' truncates or zero-extends
        for r0, r1 in _chunks(rows, row_bytes):
            if reader is not None:
                buf = _bytes_tensor(np.ascontiguousarray(reader.rows(r0, r1)))
            else:
                buf = torch.empty((r1 - r0) * row_bytes, dtype=torch.uint8)
            compat.ckpt_broadcast_bytes(buf, group, lp.owner)
            _put(t, r0, r1, buf.numpy().view(dt).reshape((r1 - r0,) + tail))
        t[rows:].zero_()
        return t, reader.err if reader is not None else None
    got = None  # a host or 0-d leaf: small, sent whole
    if reader is not None:
        try:
            got = ("ok", _read_into(held[lp.k], None, lp.stored[0] if lp.stored else 0,
                                    lp.name, s))
        except CheckpointCorrupt as e:
            got = ("err", e)
    got = compat.ckpt_broadcast_object(got, group, src=lp.owner)
    if got[0] == "err":
        return t, got[1]
    if isinstance(t, torch.Tensor):
        t.copy_(torch.from_numpy(np.array(got[1], order="C")))
        return t, None
    arr = got[1]
    if mode in ("repad", _RECUT) and np.ndim(arr):
        arr = _repad(arr, _shape(t))
    return _host_leaf(t, arr), None


def _restore_ranks(ckpt_dir, template: Any, step: Optional[int], mode: str,
                   verify: bool, group: Group) -> Tuple[Any, int]:
    """``restore_checkpoint`` past world 1 (module docstring); ``mode`` is
    an ``on_row_mismatch`` or ``_RECUT``."""

    def pick():
        s = step if step is not None else latest_step(ckpt_dir)
        if s is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        return s, _read_manifest(ckpt_dir, s)

    s, doc = _on_rank0(pick, group)
    where = f"checkpoint step_{s:08d}"
    meta = doc.get("meta") or {}
    if mode == "error" and int(meta.get("world", group.world)) != group.world:
        raise WorldMismatch(
            f"{where} was written at world {meta['world']} (mesh "
            f"{meta.get('mesh_shape')}), this run is world {group.world}: a different "
            f"world size. {_ELASTIC}")
    check_salts(doc.get("salts"), where)
    d = Path(ckpt_dir) / f"step_{s:08d}"
    leaves = []
    for k, (name, t) in enumerate(_flatten(template).items()):
        info = doc["leaves"].get(name)
        if info is None:
            raise KeyError(f"{where} has no leaf {name!r}: the template enables state the "
                           "run that wrote it did not (e.g. an L2 tier turned on after "
                           "checkpointing)")
        leaves.append(_leaf_plan(k, name, t, info, group, mode))
    tail = mode == _RECUT
    held: Dict[int, Any] = {}
    try:
        # pass 1: every check that can fail, on every rank, before any write
        errors, heads, parts, lates = [], {}, {}, {}
        for lp in leaves:
            bad = _shape_error(lp, mode, group)
            if bad is not None:
                errors.append((lp.k, bad))
                continue
            try:
                if lp.block:
                    head, part, late = _check_block(lp, d, s, verify, group, held, tail)
                    heads[lp.k], parts[lp.k], lates[lp.k] = head, part, late
                elif group.rank == lp.owner:
                    _check_owned(lp, d, s, verify, held, group, tail)
            except (CheckpointCorrupt, ValueError) as e:
                errors.append((lp.k, e))
            except (OSError, EOFError) as e:
                errors.append((lp.k, CheckpointCorrupt(
                    f"{where}: leaf {lp.name!r} missing or unreadable ({e})", step=s,
                    leaf=lp.name)))
        reports = compat.ckpt_gather_objects((errors, heads, parts, lates), group)
        found = [e for r in reports for e in r[0]]
        for lp in leaves:
            if not lp.block or any(k == lp.k for k, _ in found):
                continue
            if verify and "crc32" in lp.info:
                crc = reports[lp.owner][1][lp.k][0]
                for r in reports:
                    crc = crc32_combine(crc, *r[2][lp.k])
                if crc != lp.info["crc32"]:
                    found.append((lp.k, CheckpointCorrupt(
                        f"{where}: leaf {lp.name!r} checksum mismatch (stored "
                        f"{lp.info['crc32']:#010x}, on-disk {crc:#010x}): torn write or disk "
                        "corruption", step=s, leaf=lp.name)))
                    continue
            late = next((r[3][lp.k] for r in reports if r[3].get(lp.k) is not None), None)
            if late is not None:
                found.append((lp.k, late))
        err = _first_error(found)
        if err is not None:
            raise err
        # pass 2: load, once no queued kernel reads or writes a mapped leaf
        host_memory.wait_for_card(lp.t for lp in leaves)
        out, errors = {}, []
        for lp in leaves:
            out[lp.name], err = _load_leaf(lp, held, s, group, mode)
            if err is not None:
                errors.append((lp.k, err))
        _agree_errors(errors, group)
    finally:
        for h in held.values():
            h.close()
    return _unflatten_into(template, out), s


def restore_resharded(ckpt_dir: str, template: Any, step: Optional[int] = None,
                      group: Optional[Group] = None) -> Tuple[Any, int]:
    """Past world 1, a checkpoint of another world restored into this
    world's ``template``: every rank of ``group`` reads its cut of each
    row-sharded leaf from the stored rows, zero past them (``'repad'``), so
    no rank holds the whole table. FCounter rows that no cut takes (the
    stored table padded past this world's rows) must be zero: the rank that
    reads them checks, and every rank raises the same ``ValueError`` before
    anything is written (pass 1's agreement). The tier sentinels are left
    as stored: ``runtime.elastic.restore_elastic`` remaps them."""
    grp = _group(group)
    if grp.world == 1:
        raise ValueError("restore_resharded is the restore past world 1; at world 1 "
                         "restore with on_row_mismatch='keep' and recut "
                         "(embedding.state.reshard_state)")
    return _restore_ranks(ckpt_dir, template, step, _RECUT, True, grp)


class AsyncCheckpointer:
    """Snapshot, then write in a background thread.

    ``save`` copies every leaf before it returns: the port updates the
    state in place, so a writer reading live tensors while the next step
    runs would write a torn mixture of two steps. At world 1 the copy is in
    host memory, which holds one snapshot (the whole state) while it is
    written. Past world 1 (``group``) the copy stays on each leaf's device
    (``device_snapshot``), so host memory holds a chunk a rank, and the
    thread writes the ranks' checkpoint together over the checkpoint group
    (``Group.ckpt_pg``): the steps' collectives go on on the step's group
    meanwhile. Every path that reads the directory through the checkpoint
    group (restores, ``latest_step``, chaos) calls ``wait`` first, so the
    group has one user at a time."""

    def __init__(self, ckpt_dir: str, keep: int = 3,
                 salts: Optional[Dict[str, int]] = None, group: Optional[Group] = None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.salts = salts
        self.group = _group(group)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_path: Optional[str] = None

    def save(self, step: int, state: Any, meta: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        # synchronous snapshot, async write
        snap = host_snapshot(state) if self.group.world == 1 else device_snapshot(state)

        def work():
            try:
                self.last_path = save_checkpoint(self.ckpt_dir, step, snap, self.keep,
                                                 meta=meta, salts=self.salts,
                                                 group=self.group)
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
