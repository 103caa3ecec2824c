"""One process per rank: the port's counterpart of ``repro.dist.compat``.

The reference runs one SPMD program under ``shard_map`` and names its mesh
axes wherever a collective runs; every collective there spans the whole
mesh. The port runs one process per rank instead, and a ``Group`` (this
rank, the world size, the ``torch.distributed`` process group) goes where
the reference passes ``axes``. Rank ``r`` is the reference's
``lax.axis_index(axes)``, row-major over the mesh (``launch.mesh``).

The four collectives the reference uses, with its semantics:

``all_to_all_tiled``   ``lax.all_to_all(x, axes, 0, 0, tiled=True)``: dim 0
                       splits into ``world`` equal blocks, block ``p`` goes to
                       rank ``p``, and the received blocks concatenate in rank
                       order (``dist.all_to_all_single``);
``psum``               ``lax.psum``: the sum over ranks, floats added in rank
                       order as XLA adds them;
``all_gather_tiled``   ``lax.all_gather(x, axes, tiled=True)``: every rank's
                       ``x`` concatenated on dim 0 in rank order;
``axis_index``         the rank.

At world 1 (``WORLD1``, the group every entry point takes when it is given
none) each collective returns its input untouched, so the single-rank path
runs exactly what it ran before this module existed.

The backend rule (``backend_for``):

* NCCL when every rank has a card of its own (rank ``r`` on ``cuda:r``);
* gloo on the CPU;
* gloo on CUDA tensors when ranks share a card: NCCL refuses two ranks on
  one device.

gloo moves CUDA tensors through host memory itself. On PyTorch 2.11 (CUDA
12.8) on an H100, ``scripts/torch_gloo_probe.py`` found ``all_reduce``,
``all_to_all_single``, ``all_gather``, ``all_gather_into_tensor`` and
``broadcast`` all taking CUDA tensors of float32, int32, uint8, float16 and
bfloat16 from ranks sharing the card, their results ready for the next
kernel on the current stream, so no wrapper stages through a host buffer of
its own. A payload of another dtype (``bool``, the float8
types) rides as its bytes; it is never cast, so the wire carries exactly
the payload. Nothing here swaps the backend or the device after a failure:
a collective that fails raises.

``traffic`` counts the bytes each collective sends from this rank
(``reset_traffic``/``traffic_snapshot``; a psum counts ``2 (W-1)/W`` of
its tensor, what a ring all-reduce sends), which the chip check reports a
step at a time.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist


class Group(NamedTuple):
    """A rank's view of the world: its rank, the world size and the process
    group every collective runs over (``None`` at world 1)."""

    rank: int
    world: int
    pg: Any = None
    backend: str = "none"


WORLD1 = Group(0, 1, None, "none")


def resolve_group(world: int, group: Optional[Group]) -> Group:
    """The group an entry point built for ``world`` runs over: ``WORLD1``
    when no group is given at world 1; a ``ValueError`` when ``world > 1``
    comes without a group of that world (one process per rank: the caller
    starts the ranks with ``spawn_ranks`` or ``init_ranks``)."""
    world = int(world)
    if group is None:
        if world != 1:
            raise ValueError(
                f"world={world} needs a repro_torch.dist.Group of world {world} "
                "(one process per rank: start the ranks with "
                "repro_torch.dist.spawn_ranks or init_ranks and pass group=)")
        return WORLD1
    if int(group.world) != world:
        raise ValueError(f"world={world} but the group given has world {group.world} "
                         f"(rank {group.rank})")
    return group


def axis_index(group: Group) -> int:
    """``lax.axis_index(axes)``: this rank."""
    return int(group.rank)


# ---------------------------------------------------------------------------
# wire accounting
# ---------------------------------------------------------------------------

traffic: Dict[str, int] = {"all_to_all": 0, "psum": 0, "all_gather": 0}


def reset_traffic() -> None:
    for k in traffic:
        traffic[k] = 0


def traffic_snapshot() -> Dict[str, int]:
    return dict(traffic)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

# dtypes gloo and NCCL move as they are; any other payload rides as bytes
_NATIVE = (torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int8,
           torch.uint8, torch.int32, torch.int64)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the backend moves it: itself where the dtype is native, else
    its bytes (``bool`` and the float8 types are one byte an element)."""
    x = x.contiguous()
    if x.dtype in _NATIVE:
        return x
    if x.element_size() != 1:
        raise TypeError(f"no wire format for {x.dtype}")
    return x.view(torch.uint8)


def _unwire(y: torch.Tensor, like: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    return (y if like.dtype in _NATIVE else y.view(like.dtype)).reshape(shape)


def _a2a(w: torch.Tensor, group: Group) -> torch.Tensor:
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group.pg)
    return out


def _gather(w: torch.Tensor, group: Group) -> torch.Tensor:
    out = torch.empty((group.world,) + tuple(w.shape), dtype=w.dtype, device=w.device)
    dist.all_gather(list(out.unbind(0)), w, group=group.pg)
    return out


def all_to_all_tiled(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``lax.all_to_all(x, axes, split_axis=0, concat_axis=0, tiled=True)``:
    ``x``'s dim 0 (a multiple of ``world``) splits into ``world`` blocks,
    block ``p`` goes to rank ``p``, and block ``q`` of the result came from
    rank ``q``."""
    if group.world == 1:
        return x
    if x.shape[0] % group.world:
        raise ValueError(f"all_to_all of {x.shape[0]} rows over {group.world} ranks")
    w = _wire(x)
    traffic["all_to_all"] += w.numel() * w.element_size() * (group.world - 1) // group.world
    return _unwire(_a2a(w, group), x, x.shape)


def psum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``lax.psum(x, axes)``: the elementwise sum over ranks, the same bits
    on every rank (a new tensor; ``x`` is left as it is).

    Floating point adds in rank order from zero, ``((0 + x_0) + x_1) +
    ...``, as XLA's all-reduce does, so the sum is bitwise the reference's: a
    reduce-scatter (each rank receives every rank's slice of its chunk,
    one all_to_all), the ordered sum of that chunk, and an all_gather of
    the chunks, which moves what a ring all-reduce moves. Integers take
    ``dist.all_reduce``, exact in any order."""
    if group.world == 1:
        return x
    if x.dtype not in _NATIVE:
        raise TypeError(f"psum of {x.dtype}: sum a native dtype")
    wld = group.world
    traffic["psum"] += 2 * x.numel() * x.element_size() * (wld - 1) // wld
    if not x.is_floating_point():
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group.pg)
        return y
    n = x.numel()
    per = -(-n // wld)
    buf = torch.zeros(wld * per, dtype=x.dtype, device=x.device)
    buf[:n] = x.reshape(-1)
    parts = _a2a(buf, group).reshape(wld, per)   # row p: rank p's share of my chunk
    acc = torch.zeros_like(parts[0])   # from +0.0, as XLA's: -0.0 sums to +0.0
    for p in range(wld):
        acc += parts[p]
    return _gather(acc, group).reshape(-1)[:n].reshape(x.shape)


def all_gather_tiled(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``lax.all_gather(x, axes, tiled=True)``: every rank's ``x``
    concatenated on dim 0 in rank order."""
    if group.world == 1:
        return x
    w = _wire(x)
    traffic["all_gather"] += w.numel() * w.element_size() * (group.world - 1)
    shape = (group.world * x.shape[0],) + tuple(x.shape[1:])
    return _unwire(_gather(w, group), x, shape)


def barrier(group: Group) -> None:
    if group.world > 1:
        dist.barrier(group=group.pg)


# ---------------------------------------------------------------------------
# starting the ranks
# ---------------------------------------------------------------------------


def backend_for(device: Any, world: int) -> str:
    """The backend rule of the module docstring: ``'nccl'`` when the device
    is CUDA and the host has a card for every rank, else ``'gloo'``."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= int(world):
        return "nccl"
    return "gloo"


def rank_device(device: Any, group: Group) -> torch.device:
    """The device rank ``group.rank`` computes on: ``cuda:rank`` under NCCL,
    the one card every rank shares under gloo, or the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", group.rank if group.backend == "nccl" else 0)


def init_ranks(rank: int, world: int, store_path: str, backend: str) -> Group:
    """Join the process group as ``rank`` of ``world`` through a
    ``FileStore`` at ``store_path`` (no port, so parallel runs on one host
    cannot collide) and return this rank's ``Group``."""
    store = dist.FileStore(store_path, int(world))
    dist.init_process_group(backend, store=store, rank=int(rank), world_size=int(world))
    if backend == "nccl":
        torch.cuda.set_device(int(rank))
    return Group(int(rank), int(world), dist.group.WORLD, backend)


def _rank_main(rank: int, fn: Callable, world: int, store_path: str, backend: str,
               out_dir: str, threads: Optional[int], args: tuple) -> None:
    if threads is not None:
        torch.set_num_threads(int(threads))
    group = init_ranks(rank, world, store_path, backend)
    try:
        result = fn(group, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        barrier(group)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, *args, device: Any = "cpu",
                threads: Optional[int] = None, workdir: Optional[str] = None
                ) -> List[Any]:
    """Run ``fn(group, *args)`` in ``world`` fresh processes (the ``spawn``
    start method), one a rank, joined through a ``FileStore`` under
    ``workdir`` (a new temporary directory by default), and return the
    ranks' results in rank order (each must be something ``torch.save``
    can write). The backend follows ``backend_for(device, world)``. The
    children inherit this process's environment, ``PYTHONHASHSEED``
    included (``core.features.agree_salts`` checks the ranks agree). A
    failing rank makes this raise, after every rank has ended."""
    import torch.multiprocessing as mp

    backend = backend_for(device, world)
    own = workdir is None
    d = tempfile.mkdtemp(prefix="ranks_") if own else workdir
    try:
        mp.start_processes(_rank_main, args=(fn, int(world), os.path.join(d, "store"),
                                             backend, d, threads, args),
                           nprocs=int(world), start_method="spawn", join=True)
        return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                for r in range(int(world))]
    finally:
        if own:
            import shutil
            shutil.rmtree(d, ignore_errors=True)
