"""Calibration pass: microbench the priced ops, fit curves, cache to disk
(``repro.perf.calibration`` in torch).

The priced ops are timed across a small size grid through the port's
**dispatchers** (``repro_torch.kernels.ops`` with ``fused=None``, the
launchers' ``'auto'``), so the curves price what the engine executes on
this device: the CUDA kernels ``gather_pool``, ``dedup_adagrad``,
``tier_probe`` and ``gather_project`` on the card, their plain versions on
the CPU. Each timing brackets the calls with ``torch.cuda.synchronize`` on
the card. ``dense_matmul`` is ``torch.matmul``, the plain product the
reference also prices outside Pallas.

The wire curves time the port's own hops over the ranks of ``group``:
``optim.grad_compression.compressed_all_gather`` (``wire_ag``) and
``core.packed_embedding._compressed_a2a_rows`` (``wire_a2a``), each with
no compression, at the reference's payloads and byte counts (``bytes =
world * m * 4``). At world 1 both are the identity (the send buffer is the
receive buffer; no collective and no device work runs), so the curves are
the timing floor of a call and a synchronize. The reference's world-1 mesh
prices a local copy instead.

Past world 1 (one process per rank) every rank must hold the same model,
or the ranks compile different assignments and deadlock in the first
collective one of them skips. So rank 0 alone reads and writes the file,
and the choice to reuse it or to bench is its, broadcast; every rank times
the wire hops together; the kernel curves are timed by rank 0 alone while
the others wait (the ranks may share one card); and rank 0's samples are
broadcast, so every rank fits the same model bitwise.

The file is stamped with the reference's keys (``version``, ``backend``,
``interpret``); ``backend`` names the port and the device type
(``torch-cuda`` or ``torch-cpu``), so neither package ever reuses the
other's curves, nor the CPU's the card's. Past world 1 the stamp adds
``world``, the world its wire curves were timed at; a file of another
world is re-benched, and a file without the key counts as world 1.

Lifecycle (``get_cost_model``, the launchers' entry point):

``off``   -> ``None``: ``repro_torch.core.assign`` keeps its constant model,
             byte for byte.
``auto``  -> load ``--calib-file`` if it exists and its stamp matches this
             process; otherwise run the microbenches and write the file.
``force`` -> always re-bench and overwrite the file.

The file keeps the raw ``(work, us)`` samples next to the fitted curves.
"""
from __future__ import annotations

import json
import os
import pathlib
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.dist.compat import WORLD1, Group, barrier, ckpt_broadcast_object
from repro_torch.perf.cost_model import PRICED_OPS, CostCurve, CostModel

CALIB_VERSION = 1
DEFAULT_CALIB_PATH = os.path.join(
    os.path.expanduser("~"), ".cache", "repro_torch", "calibration.json")

# size grids: 'small' is the startup default (a few hundred ms of benching),
# 'tiny' is the smoke/CI grid. ns = ids per call, ds = row dims,
# wire_kb = per-shard payloads, mm = square-matmul sides.
GRIDS: Dict[str, Dict[str, Any]] = {
    "tiny": dict(ns=(32, 128), ds=(8,), wire_kb=(4, 32), mm=(16, 48),
                 iters=1, warmup=1),
    "small": dict(ns=(64, 256, 1024), ds=(8, 32), wire_kb=(4, 64, 512),
                  mm=(32, 64, 128), iters=3, warmup=1),
}

Samples = Dict[str, List[Tuple[float, float]]]
Device = Union[str, torch.device]


def backend_stamp(device: Device = "cuda", world: int = 1) -> Dict[str, Any]:
    """What a calibration is valid for: re-fit when any of this changes.
    The port has no interpreter, so ``interpret`` is always False; past
    world 1, ``world`` is the world the wire curves were timed at (absent
    at world 1)."""
    stamp = {"version": CALIB_VERSION,
             "backend": f"torch-{torch.device(device).type}",
             "interpret": False}
    if world > 1:
        stamp["world"] = int(world)
    return stamp


def _time(fn, *args, iters: int, warmup: int, device: torch.device) -> float:
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(max(warmup, 1)):
        fn(*args)
    sync()
    ts = []
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e6)


# ---------------------------------------------------------------------------
# per-op microbenches (the port's dispatchers, fused=None)
# ---------------------------------------------------------------------------


def _on(dev: torch.device, a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(a).to(dev)


@torch.no_grad()
def _bench_gather_pool(n: int, d: int, it: Mapping[str, int], dev: torch.device) -> float:
    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    n_bags = max(4, n // 8)
    rows_u = _on(dev, rng.normal(size=(n, d)).astype(np.float32))
    inv = _on(dev, rng.integers(0, n, n).astype(np.int32))
    w = _on(dev, rng.normal(size=n).astype(np.float32))
    seg = np.sort(np.concatenate(
        [np.arange(n_bags), rng.integers(0, n_bags, n - n_bags)]))
    seg = _on(dev, seg.astype(np.int32))
    return _time(lambda r: ops.gather_pool(r, inv, w, seg, n_bags), rows_u, **it,
                 device=dev)


@torch.no_grad()
def _bench_dedup_adagrad(n: int, d: int, it: Mapping[str, int], dev: torch.device) -> float:
    from repro_torch.kernels import ops

    rng = np.random.default_rng(1)
    rows, hot = 4 * n, max(8, n // 8)
    w = _on(dev, rng.normal(size=(rows, d)).astype(np.float32))
    acc = _on(dev, np.abs(rng.normal(size=(rows, 1))).astype(np.float32))
    idx = _on(dev, rng.integers(0, hot, n).astype(np.int32))
    g = _on(dev, rng.normal(size=(n, d)).astype(np.float32))
    valid = _on(dev, rng.random(n) < 0.9)
    return _time(lambda w_, a_: ops.dedup_adagrad(w_, a_, idx, g, valid, 0.05, 1e-8),
                 w, acc, **it, device=dev)


@torch.no_grad()
def _bench_tier_probe(n: int, d: int, it: Mapping[str, int], dev: torch.device) -> float:
    from repro_torch.kernels import ops

    rng = np.random.default_rng(2)
    h = max(8, n // 2)
    keys = _on(dev, np.sort(rng.choice(10 * h, h, replace=False)).astype(np.int32))
    rows = _on(dev, rng.normal(size=(h, d)).astype(np.float32))
    uniq = torch.sort(_on(dev, rng.integers(0, 10 * h, n).astype(np.int32))).values
    uvalid = _on(dev, np.arange(n) < int(0.9 * n))
    return _time(lambda u: ops.tier_probe(u, uvalid, keys, rows), uniq, **it, device=dev)


@torch.no_grad()
def _bench_gather_project(n: int, d: int, it: Mapping[str, int], dev: torch.device) -> float:
    from repro_torch.kernels import ops

    rng = np.random.default_rng(3)
    nd = max(4, d // 4)
    back = _on(dev, rng.normal(size=(n, nd)).astype(np.float32))
    idx = _on(dev, rng.integers(0, n, n).astype(np.int32))
    kept = _on(dev, rng.random(n) < 0.9)
    proj = _on(dev, rng.normal(size=(nd, d)).astype(np.float32))
    return _time(lambda b, p: ops.gather_project(b, idx, kept, p), back, proj, **it,
                 device=dev)


@torch.no_grad()
def _bench_wire(kind: str, per_shard_kb: int, it: Mapping[str, int],
                dev: torch.device, group: Group = WORLD1) -> Tuple[float, float]:
    """Returns (bytes_on_wire_per_shard, us) for one uncompressed hop of the
    port's own over ``group`` (every rank calls it together; the identity at
    world 1). As the reference's: the all_to_all sends each rank ``[world,
    m]`` rows, the all_gather gathers ``[1, m]`` a rank, and both move
    ``world * m`` floats a shard."""
    from repro_torch.core.packed_embedding import _compressed_a2a_rows
    from repro_torch.optim.grad_compression import compressed_all_gather

    world = group.world
    m = max(1, (per_shard_kb * 1024 // 4) // world)
    if kind == "wire_a2a":
        x = torch.zeros((world, m), dtype=torch.float32, device=dev)

        def hop(y):
            return _compressed_a2a_rows(y, group=group)
    else:
        x = torch.zeros((1, m), dtype=torch.float32, device=dev)

        def hop(y):
            return compressed_all_gather(y, world, group=group)
    return float(world * m * 4), _time(hop, x, **it, device=dev)


@torch.no_grad()
def _bench_matmul(k: int, it: Mapping[str, int], dev: torch.device) -> float:
    rng = np.random.default_rng(4)
    a = _on(dev, rng.normal(size=(k, k)).astype(np.float32))
    b = _on(dev, rng.normal(size=(k, k)).astype(np.float32))
    return _time(torch.matmul, a, b, **it, device=dev)


def run_calibration(grid: str = "small",
                    log: Optional[Callable[[str], None]] = None,
                    device: Device = "cuda", group: Optional[Group] = None) -> Samples:
    """Run the microbench grid on ``device`` (the card unless the caller
    asks for the CPU); returns per-op raw ``(work, us)`` samples. Past world
    1 every rank of ``group`` calls it together: the wire hops are timed
    over the group, the kernels and the matmul by rank 0 alone while the
    others wait, and every rank returns rank 0's samples."""
    if grid not in GRIDS:
        raise ValueError(f"unknown calibration grid {grid!r}; "
                         f"options: {sorted(GRIDS)}")
    grp = WORLD1 if group is None else group
    dev = resolve_device(device)
    g = GRIDS[grid]
    it = {"iters": g["iters"], "warmup": g["warmup"]}
    t0 = time.perf_counter()
    samples: Samples = {op: [] for op in PRICED_OPS}
    sparse = {"gather_pool": _bench_gather_pool,
              "dedup_adagrad": _bench_dedup_adagrad,
              "tier_probe": _bench_tier_probe,
              "gather_project": _bench_gather_project}
    if grp.rank == 0:
        for op, bench in sparse.items():
            for n in g["ns"]:
                for d in g["ds"]:
                    samples[op].append((float(n * d), bench(n, d, it, dev)))
    barrier(grp)  # the kernels were timed alone on the card
    for kind in ("wire_a2a", "wire_ag"):
        for kb in g["wire_kb"]:
            samples[kind].append(_bench_wire(kind, kb, it, dev, grp))
    if grp.rank == 0:
        for k in g["mm"]:
            samples["dense_matmul"].append((float(k) ** 3, _bench_matmul(k, it, dev)))
    samples = ckpt_broadcast_object(samples, grp)
    if log:
        n_pts = sum(len(v) for v in samples.values())
        log(f"calibrated {len(samples)} ops / {n_pts} grid points "
            f"(grid={grid}) in {time.perf_counter() - t0:.1f}s")
    return samples


def fit_cost_model(samples: Samples, *, hit_prior: Optional[float] = None,
                   device: Device = "cuda", world: int = 1) -> CostModel:
    """Fit the monotone curves and stamp the model for ``device`` (and the
    ``world`` its wire curves were timed at)."""
    stamp = backend_stamp(device, world)
    kw = {} if hit_prior is None else {"hit_prior": float(hit_prior)}
    return CostModel(
        curves={op: CostCurve.fit(pts) for op, pts in samples.items()},
        backend=stamp["backend"], interpret=stamp["interpret"],
        meta={k: v for k, v in stamp.items() if k in ("version", "world")}, **kw)


# ---------------------------------------------------------------------------
# cache file
# ---------------------------------------------------------------------------


def save_calibration(path: os.PathLike, samples: Samples, model: CostModel, *,
                     device: Device = "cuda", world: int = 1) -> pathlib.Path:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    payload = {**backend_stamp(device, world), **model.to_json(),
               "samples": {op: [[float(x), float(y)] for x, y in pts]
                           for op, pts in samples.items()}}
    tmp = p.with_suffix(p.suffix + ".tmp")
    tmp.write_text(json.dumps(payload, indent=1) + "\n")
    tmp.replace(p)  # atomic: a concurrent 'auto' load never sees a torn file
    return p


def load_calibration(path: os.PathLike,
                     log: Optional[Callable[[str], None]] = None, *,
                     device: Device = "cuda", world: int = 1) -> Optional[CostModel]:
    """Load a cached calibration; ``None`` when missing, corrupt, or stamped
    for another backend, package, device type, format or world (a mismatch
    must force a refit; a file without ``world`` was timed at world 1)."""
    p = pathlib.Path(path)
    if not p.exists():
        return None
    try:
        data = json.loads(p.read_text())
    except (json.JSONDecodeError, OSError):
        if log:
            log(f"calibration file {p} unreadable; re-calibrating")
        return None
    stamp = {"world": 1, **backend_stamp(device, world)}
    got = {k: data.get(k, 1 if k == "world" else None) for k in stamp}
    if got != stamp:
        if log:
            log(f"calibration stamp mismatch at {p} (file {got}, "
                f"process {stamp}); re-calibrating")
        return None
    try:
        model = CostModel.from_json(data)
    except (KeyError, ValueError, TypeError) as e:
        if log:
            log(f"calibration file {p} invalid ({e}); re-calibrating")
        return None
    return model


def load_samples(path: os.PathLike) -> Optional[Samples]:
    """Raw grid points persisted next to the fit (for residual reporting)."""
    p = pathlib.Path(path)
    if not p.exists():
        return None
    try:
        data = json.loads(p.read_text())
        return {op: [(float(x), float(y)) for x, y in pts]
                for op, pts in data.get("samples", {}).items()}
    except (json.JSONDecodeError, OSError, ValueError, TypeError):
        return None


def get_cost_model(mode: str, path: Optional[os.PathLike] = None, *,
                   grid: str = "small",
                   log: Optional[Callable[[str], None]] = None,
                   device: Device = "cuda",
                   group: Optional[Group] = None) -> Optional[CostModel]:
    """Launcher entry point for ``--calibrate {auto,force,off}``.

    ``off`` returns ``None`` (the constant model). ``auto`` loads the cached,
    stamped file when valid, else benches on ``device`` and writes it.
    ``force`` always re-benches. ``path=None`` uses ``DEFAULT_CALIB_PATH``.
    Past world 1 every rank of ``group`` calls it together and gets the same
    model (the module docstring); ``log`` is called on rank 0 only.
    """
    if mode == "off":
        return None
    if mode not in ("auto", "force"):
        raise ValueError(f"--calibrate must be auto/force/off, got {mode!r}")
    grp = WORLD1 if group is None else group
    say = log if log is not None and grp.rank == 0 else None
    p = pathlib.Path(path) if path else pathlib.Path(DEFAULT_CALIB_PATH)
    if mode == "auto":
        model = (load_calibration(p, log=say, device=device, world=grp.world)
                 if grp.rank == 0 else None)
        model = ckpt_broadcast_object(model, grp)  # rank 0's choice: reuse or bench
        if model is not None:
            if say:
                say(f"loaded calibration from {p} "
                    f"(backend={model.backend}, interpret={model.interpret})")
            return model
    samples = run_calibration(grid, log=say, device=device, group=grp)
    model = fit_cost_model(samples, device=device, world=grp.world)
    if grp.rank == 0:
        save_calibration(p, samples, model, device=device, world=grp.world)
    if say:
        say(f"wrote calibration to {p} (backend={model.backend})")
    return model
