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
its tensor, what a ring all-reduce sends; ``rows`` the bytes ``send_rows``
sends in a reshard), which the chip check reports a step at a time.

What the runtime needs past world 1, where the reference decides once in
its one process and the port's ranks must decide alike:

* ``agree`` all_gathers a few small ints from every rank over the step's
  group (a failure class, a verdict, a step); every rank then computes the
  same decision from the same list. It runs on the thread that runs the
  steps, as every collective of the step's group does.
* a gate: ``Group.gate`` holds, while armed (``arm_gate``), the agreement
  the next collective of the step's group runs before it moves any bytes.
  A supervisor arms it before a step, so a rank that fails before the
  step's first collective (a fault injected before the step, a bad batch,
  an error in packing) meets the other ranks in that agreement from its
  error handler instead of leaving them blocked in the step's collective.
* a second process group, ``Group.ckpt_pg`` (gloo, host tensors), made by
  ``init_ranks`` on every rank for checkpoint traffic: a checkpoint is
  written on a background thread while the step's collectives go on, and
  two threads must never issue collectives on one group. The
  ``ckpt_*`` helpers below move a checkpoint's bytes and verdicts on it.
* a timeout on both groups (``PG_TIMEOUT_S``): a collective that a rank
  never joins (the rank died, or failed inside the step after its first
  collective) raises ``CollectiveFailure`` on the others when it expires,
  and the run ends; nothing retries past a failed collective.

What a change of world needs (``runtime.elastic``): the processes
``init_ranks`` started form the *root* group (``root_group``); the live
world is the group of its first ``W`` ranks (``sub_group``, the
counterpart of the reference's ``make_submesh``: a step group on the
run's backend, its own gloo ``ckpt_pg`` and a fresh gate), and every
process of the root, in the world or not, makes each sub-group with the
others, in the same order. A process outside the live world (a spare
before a scale-up names it, a rank that left after a scale-down) holds no
state and waits in ``next_event`` for the live ranks' next ``announce``:
a key of the ``FileStore`` the ranks joined through, polled, so no
collective timeout cuts the wait. Rows move between processes with
``send_rows``/``recv_rows`` on the root's ``ckpt_pg`` (gloo, host bytes).
"""
from __future__ import annotations

import atexit
import datetime
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist


PG_TIMEOUT_S = 600.0  # the process groups' timeout (init_ranks)


class CollectiveFailure(RuntimeError):
    """A collective raised (a peer died, a timeout expired, the ranks'
    collectives did not match). The group is no longer usable: nothing
    agrees or retries after it."""


class Gate:
    """The one-shot agreement the next collective of a step's group runs
    first (``arm_gate``); owned by the group, used from the thread that
    runs the steps."""

    def __init__(self):
        self.fn: Optional[Callable[[], None]] = None

    def take(self) -> Optional[Callable[[], None]]:
        fn, self.fn = self.fn, None
        return fn


class Group(NamedTuple):
    """A rank's view of the world: its rank, the world size, the process
    group every collective runs over (``None`` at world 1), its backend,
    the checkpoint traffic's gloo group and the step group's gate (both
    made by ``init_ranks``)."""

    rank: int
    world: int
    pg: Any = None
    backend: str = "none"
    ckpt_pg: Any = None
    gate: Optional[Gate] = None


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

traffic: Dict[str, int] = {"all_to_all": 0, "psum": 0, "all_gather": 0, "rows": 0}


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


def _call(fn: Callable, *args, **kwargs):
    """``fn`` (a ``torch.distributed`` call); its error as
    ``CollectiveFailure``."""
    try:
        return fn(*args, **kwargs)
    except RuntimeError as e:
        raise CollectiveFailure(f"{fn.__name__} failed: {e}") from e


def _enter(group: Group) -> None:
    """Run the agreement armed on the group's gate, if any, before the
    collective."""
    fn = group.gate.take() if group.gate is not None else None
    if fn is not None:
        fn()


def _a2a(w: torch.Tensor, group: Group) -> torch.Tensor:
    out = torch.empty_like(w)
    _call(dist.all_to_all_single, out, w, group=group.pg)
    return out


def _gather(w: torch.Tensor, group: Group) -> torch.Tensor:
    out = torch.empty((group.world,) + tuple(w.shape), dtype=w.dtype, device=w.device)
    _call(dist.all_gather, list(out.unbind(0)), w, group=group.pg)
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
    _enter(group)
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
    _enter(group)
    wld = group.world
    traffic["psum"] += 2 * x.numel() * x.element_size() * (wld - 1) // wld
    if not x.is_floating_point():
        y = x.contiguous().clone()
        _call(dist.all_reduce, y, op=dist.ReduceOp.SUM, group=group.pg)
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
    _enter(group)
    w = _wire(x)
    traffic["all_gather"] += w.numel() * w.element_size() * (group.world - 1)
    shape = (group.world * x.shape[0],) + tuple(x.shape[1:])
    return _unwire(_gather(w, group), x, shape)


def barrier(group: Group) -> None:
    if group.world > 1:
        _enter(group)
        _call(dist.barrier, group=group.pg)


# ---------------------------------------------------------------------------
# agreement (the step's group, the steps' thread)
# ---------------------------------------------------------------------------


def agree(values: Sequence[int], group: Group) -> List[List[int]]:
    """Every rank's ``values`` (the same count of small ints on each), in
    rank order: one all_gather over the step's group, which passes the gate
    first as every collective of the group does (the gate's own agreement
    finds it disarmed). At world 1, ``[values]``."""
    vals = [int(v) for v in values]
    if group.world == 1:
        return [vals]
    _enter(group)
    dev = torch.device("cuda", torch.cuda.current_device()) if group.backend == "nccl" else "cpu"
    mine = torch.tensor(vals, dtype=torch.int64, device=dev)
    out = torch.empty((group.world, len(vals)), dtype=torch.int64, device=dev)
    _call(dist.all_gather, list(out.unbind(0)), mine, group=group.pg)
    return out.cpu().tolist()


def arm_gate(group: Group, fn: Optional[Callable[[], None]]) -> None:
    """Arm (``fn``) or disarm (``None``) the group's gate: the next
    collective of the step's group calls ``fn`` first, once."""
    if group.gate is not None:
        group.gate.fn = fn


def take_gate(group: Group) -> Optional[Callable[[], None]]:
    """The armed agreement, disarmed (``None`` if none is armed)."""
    return group.gate.take() if group.gate is not None else None


# ---------------------------------------------------------------------------
# checkpoint traffic (Group.ckpt_pg: gloo, host tensors, any one thread at a
# time: a checkpoint's writer thread, or the main thread when no write is
# in flight)
# ---------------------------------------------------------------------------


def ckpt_gather_objects(obj: Any, group: Group) -> List[Any]:
    """Every rank's ``obj`` (picklable), in rank order."""
    if group.world == 1:
        return [obj]
    out: List[Any] = [None] * group.world
    _call(dist.all_gather_object, out, obj, group=group.ckpt_pg)
    return out


def ckpt_broadcast_object(obj: Any, group: Group, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` on every rank."""
    if group.world == 1:
        return obj
    box = [obj]
    _call(dist.broadcast_object_list, box, src=src, group=group.ckpt_pg)
    return box[0]


def ckpt_broadcast_bytes(buf: torch.Tensor, group: Group, src: int) -> torch.Tensor:
    """``buf`` (uint8 on the host, the same size on every rank) filled with
    rank ``src``'s."""
    if group.world > 1:
        _call(dist.broadcast, buf, src=src, group=group.ckpt_pg)
    return buf


def ckpt_send_bytes(buf: torch.Tensor, dst: int, group: Group, tag: int = 0) -> None:
    _call(dist.send, buf, dst=dst, group=group.ckpt_pg, tag=tag)


def ckpt_recv_bytes(buf: torch.Tensor, src: int, group: Group, tag: int = 0) -> torch.Tensor:
    _call(dist.recv, buf, src=src, group=group.ckpt_pg, tag=tag)
    return buf


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


_ROOT: Dict[str, Any] = {"group": None, "store": None, "events": 0}


def init_ranks(rank: int, world: int, store_path: str, backend: str) -> Group:
    """Join the process group as ``rank`` of ``world`` through a
    ``FileStore`` at ``store_path`` (no port, so parallel runs on one host
    cannot collide), make the checkpoint traffic's gloo group beside it
    (both with a timeout of ``PG_TIMEOUT_S``) and return this rank's
    ``Group``, which is also this process's ``root_group``."""
    store = dist.FileStore(store_path, int(world))
    timeout = datetime.timedelta(seconds=PG_TIMEOUT_S)
    dist.init_process_group(backend, store=store, rank=int(rank), world_size=int(world),
                            timeout=timeout)
    if backend == "nccl":
        torch.cuda.set_device(int(rank))
    ckpt_pg = dist.new_group(backend="gloo", timeout=timeout)
    atexit.register(_leave_together, ckpt_pg)
    group = Group(int(rank), int(world), dist.group.WORLD, backend, ckpt_pg, Gate())
    _ROOT.update(group=group, store=store, events=0)
    return group


def root_group() -> Group:
    """The group of every process ``init_ranks`` started (``WORLD1`` in a
    process that started none)."""
    return _ROOT["group"] if _ROOT["group"] is not None and dist.is_initialized() else WORLD1


def sub_group(world: int, root: Optional[Group] = None) -> Optional[Group]:
    """The group of the first ``world`` ranks of ``root`` (default
    ``root_group()``): its step group on the root's backend, its own gloo
    ``ckpt_pg`` and a fresh gate, on its members; ``None`` on the other
    processes. Every process of ``root`` calls it, in the same order, as
    ``torch.distributed.new_group`` requires. The whole root is the root
    with a fresh gate; one rank is a group of world 1 (no process group)."""
    root = root_group() if root is None else root
    world = int(world)
    if not 1 <= world <= root.world:
        raise ValueError(f"a world of {world} ranks out of the {root.world} started")
    if world == root.world:
        return root._replace(gate=Gate())
    if world == 1:
        return Group(0, 1, None, "none", None, Gate()) if root.rank == 0 else None
    timeout = datetime.timedelta(seconds=PG_TIMEOUT_S)
    ranks = list(range(world))
    pg = dist.new_group(ranks=ranks, backend=root.backend, timeout=timeout)
    ckpt_pg = dist.new_group(ranks=ranks, backend="gloo", timeout=timeout)
    if root.rank >= world:
        return None
    return Group(root.rank, world, pg, root.backend, ckpt_pg, Gate())


EVENT_POLL_S = 0.05  # how often a waiting process looks for the next event


def announce(event: Dict[str, Any], root: Optional[Group] = None) -> None:
    """Publish ``event`` (a JSON-able dict) as the run's next event to the
    processes waiting in ``next_event``; every live rank calls it (rank 0
    writes it), so every process counts the same events."""
    import json

    root = root_group() if root is None else root
    n = _ROOT["events"]
    _ROOT["events"] = n + 1
    if root.world > 1 and root.rank == 0:
        _ROOT["store"].set(f"repro_torch/event/{n}", json.dumps(event))


def next_event(root: Optional[Group] = None) -> Dict[str, Any]:
    """The run's next event, waited for as long as it takes (a ``FileStore``
    key polled every ``EVENT_POLL_S``: no collective timeout applies)."""
    import json

    root = root_group() if root is None else root
    if root.world == 1:
        raise RuntimeError("next_event: no other process can announce one at world 1")
    n = _ROOT["events"]
    key = f"repro_torch/event/{n}"
    store = _ROOT["store"]
    while not store.check([key]):
        time.sleep(EVENT_POLL_S)
    _ROOT["events"] = n + 1
    return json.loads(store.get(key).decode())


def send_rows(x: torch.Tensor, dst: int, root: Group, tag: int) -> None:
    """``x``'s bytes to rank ``dst`` of ``root`` on its ``ckpt_pg`` (a card's
    tensor staged through one host copy)."""
    b = x.contiguous().reshape(-1).view(torch.uint8)
    if b.device.type != "cpu":
        b = b.cpu()
    traffic["rows"] += b.numel()
    _call(dist.send, b, dst=dst, group=root.ckpt_pg, tag=tag)


def recv_rows(x: torch.Tensor, src: int, root: Group, tag: int) -> None:
    """Rank ``src``'s ``send_rows`` into ``x`` (contiguous), in place."""
    b = x.reshape(-1).view(torch.uint8)
    if b.device.type == "cpu":
        _call(dist.recv, b, src=src, group=root.ckpt_pg, tag=tag)
        return
    buf = torch.empty(b.shape, dtype=torch.uint8)
    _call(dist.recv, buf, src=src, group=root.ckpt_pg, tag=tag)
    b.copy_(buf)


EXIT_WAIT_S = 30.0  # how long a rank ending with its groups still up waits for the others


def _leave_together(ckpt_pg) -> None:
    """At exit with the groups still up: meet the other ranks, then destroy
    the groups. A rank whose peer closed its connections first could abort
    in gloo's teardown (seen on the CPU, about one process pair in fifty);
    a rank that never comes is waited for ``EXIT_WAIT_S`` seconds."""
    if not dist.is_initialized():
        return
    try:
        dist.monitored_barrier(group=ckpt_pg, timeout=datetime.timedelta(seconds=EXIT_WAIT_S))
    except (RuntimeError, ValueError):
        pass  # a peer is gone, or the group was replaced: nothing to wait for
    dist.destroy_process_group()


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
                threads: Optional[int] = None, workdir: Optional[str] = None,
                deadline_s: Optional[float] = None) -> List[Any]:
    """Run ``fn(group, *args)`` in ``world`` fresh processes (the ``spawn``
    start method), one a rank, joined through a ``FileStore`` under
    ``workdir`` (a new temporary directory by default), and return the
    ranks' results in rank order (each must be something ``torch.save``
    can write). The backend follows ``backend_for(device, world)``. The
    children inherit
    this process's environment, ``PYTHONHASHSEED`` included
    (``core.features.agree_salts`` checks the ranks agree). A failing rank
    makes this raise once it has ended, the others stopped. With
    ``deadline_s``, ranks still running that many seconds after the start
    are stopped and this raises ``TimeoutError``."""
    import torch.multiprocessing as mp

    backend = backend_for(device, world)
    own = workdir is None
    d = tempfile.mkdtemp(prefix="ranks_") if own else workdir
    try:
        ctx = mp.start_processes(_rank_main, args=(fn, int(world), os.path.join(d, "store"),
                                                   backend, d, threads, args),
                                 nprocs=int(world), start_method="spawn", join=False)
        end = None if deadline_s is None else time.monotonic() + float(deadline_s)
        while not ctx.join(timeout=1.0):
            if end is not None and time.monotonic() > end:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                        p.join()
                raise TimeoutError(f"{world} ranks still running after {deadline_s} s: "
                                   "stopped")
        return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                for r in range(int(world))]
    finally:
        if own:
            import shutil
            shutil.rmtree(d, ignore_errors=True)
