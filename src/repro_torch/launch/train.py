"""Training launcher of the PyTorch port: PICASSO hybrid training of deepfm,
dcn-v2, sasrec or mind, on one card or on ``--devices`` ranks.

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm \\
      --steps 50 --global-batch 256
  PYTHONPATH=src python -m repro_torch.launch.train --arch dcn-v2 \\
      --steps 50 --global-batch 256
  PYTHONPATH=src python -m repro_torch.launch.train --arch dcn-v2 --smoke \\
      --device cpu --steps 3 --global-batch 32 --log-every 1
  PYTHONPATH=src python -m repro_torch.launch.train --arch sasrec \\
      --steps 50 --global-batch 256
  PYTHONPATH=src python -m repro_torch.launch.train --arch mind --smoke \\
      --device cpu --steps 3 --global-batch 32 --log-every 1
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm \\
      --global-batch 256 --strategy picasso_narrow --narrow-dim 4 \\
      --l2-budget 2147483648
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm \\
      --global-batch 256 --grad-compress topk
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm \\
      --global-batch 256 --no-packing --strategy mixed
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm --smoke \\
      --device cpu --steps 30 --global-batch 32 --ckpt-dir /tmp/ck \\
      --ckpt-every 5 --guard --chaos nan@7,nan@8,crash@13,ckpt@20
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm --smoke \\
      --device cpu --global-batch 32 --stream --segment-steps 5 \\
      --stream-segments 3 --ckpt-dir /tmp/ck --publish-dir /tmp/pub
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm --smoke \\
      --device cpu --devices 4 --mesh 2x2 --global-batch 64 --stream \\
      --segment-steps 2 --stream-segments 3 --ckpt-dir /tmp/ck4 \\
      --publish-dir /tmp/pub4 --reshard-to 2x1 --reshard-at 2 --chaos torn@4
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm \\
      --global-batch 256 --strategy picasso_narrow --narrow-dim 4 \\
      --l2-budget 2147483648 --pin-l2
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm \\
      --global-batch 256 --no-packing --strategy auto --calibrate auto
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm --smoke \
      --device cpu --devices 4 --mesh 2x2 --steps 3 --global-batch 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm --smoke \
      --device cpu --devices 4 --mesh 2x2 --steps 30 --global-batch 64 \
      --ckpt-dir /tmp/ck4 --ckpt-every 5 --guard --chaos nan@7,nan@8,crash@13,ckpt@20
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm --smoke \
      --device cpu --devices 4 --mesh 2x2 --steps 6 --global-batch 64 \
      --reshard-to 2x1 --reshard-at 3 --ckpt-dir /tmp/ck42

Runs on ``cuda`` unless ``--device cpu`` is given; without a GPU it raises.
The plan is the reference launcher's: hot tier budget ``1<<24`` bytes with
``--smoke`` and ``1<<30`` without, a flush every 20 steps after 10 warm-up
steps. ``--strategy mixed``/``auto`` compiles a per-group assignment before
the state is made and prints it: on the constant cost model, or with
``--calibrate auto|force`` on curves measured on this device
(``repro_torch.perf``, cached in ``--calib-file``), whose replans then also
feed the step times back (``Replanner.observe_timing``). ``--pin-l2``
places the L2 tiers and the narrow masters in pinned host memory, where the
kernels read and write them over the bus (``TrainConfig.pin_l2``), and
prints the bytes pinned.

Runtime flags, wired as the reference's launcher wires them: ``--ckpt-dir``
(with ``--ckpt-every``) runs the loop under the ``Supervisor`` and resumes
from the newest verified checkpoint, its plan revision first; ``--guard``
rejects anomalous steps (``AnomalyGuard`` judging the journaling step);
``--chaos`` injects faults; ``--stream`` runs segments that checkpoint and,
with ``--publish-dir``, publish a delta a ``repro_torch.launch.serve
--reload-dir`` process picks up; ``--replan-iters`` replans from the live
FCounter and migrates the state. Checkpoints and deltas record the packing
salts; a resume under other salts raises (``PYTHONHASHSEED``).

``--devices N`` and ``--mesh AxB`` have the reference's meaning: ``world =
prod(mesh)`` ranks (``--mesh`` defaults to ``Nx1``), each training on
``global_batch // world`` samples of every batch. The port runs one process
per rank: this process fixes ``PYTHONHASHSEED`` (its own value, else 0) so
the ranks pack alike, spawns them (``dist.spawn_ranks``), and rank 0 prints
the lines a world-1 run prints. The backend is NCCL when every rank has a
card of its own, else gloo (on the CPU, or on CUDA tensors when the ranks
share one card); the first line names it. ``--ckpt-dir``, ``--guard`` and
``--chaos`` run at any world: every rank runs the ``Supervisor``, the
ranks write one checkpoint together (the reference's files at the same
mesh) and agree on every rollback; a resume reads a checkpoint written by
either package, at this world or, through ``runtime.elastic.restore_elastic``,
at another. Rank 0 prints the launcher's lines; each rank logs its warnings
with its rank.

``--reshard-to AxB`` (with ``--reshard-at``) changes the world mid-run, as
the reference's ``do_reshard``: at that step the plan is recut, the live
state moves to the new world's ranks exactly (``runtime.elastic.reshard_live``),
the step (and the ``Supervisor``, which writes a checkpoint at the new world
there) is rebuilt on the new group, and the run goes on. The launcher starts
``max(world, new world)`` processes: those past the live world are spares
until the reshard names them, and the ranks a scale-down leaves free their
state and wait for the run's end (``--devices`` counts them all).

``--stream`` runs at any world: the ranks checkpoint together and publish
one delta together at every segment boundary (``--publish-dir``; after the
checkpoint's writer thread, since both use the group's ``ckpt_pg``), a resume restores the newest checkpoint at its own world
(``restore_verified``, quarantining a corrupt one) or at another
(``restore_elastic``), and ``--reshard-to`` is applied at the first segment
boundary at or past ``--reshard-at``: the ranks it drops leave the stream,
the spares it names join for the segments that remain, and the stream's
checkpointer is rebuilt on the new group. ``torn@`` tears a delta once
every rank's rows are in and before ``LATEST`` names it, from rank 0. The flags that wait for ROADMAP Queue 1
item 6.3b refuse past world 1 with ``NotImplementedError`` (``--reshard-to``
takes a run past world 1): ``--replan-iters``, ``--pin-l2``,
``--calibrate``.
"""
import argparse


def main(argv=None):
    from repro_torch.engine import AUTO_NAMES, available_strategies

    names = available_strategies()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="deepfm", help="deepfm | dcn-v2 | sasrec | mind")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized tables)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=256)
    ap.add_argument("--strategy", default="picasso", choices=names + AUTO_NAMES,
                    help="EmbeddingEngine lookup strategy: one of "
                         f"{', '.join(names)} (broadcast to every packed "
                         f"group), or {'/'.join(AUTO_NAMES)} for the "
                         "per-group cost-model assignment")
    ap.add_argument("--fused-kernels", default="auto", choices=("auto", "on", "off"),
                    help="CUDA kernels: 'auto' for tensors on the card, 'on' "
                         "forces them (raises on the CPU), 'off' forces the "
                         "plain PyTorch versions")
    ap.add_argument("--l2-budget", type=int, default=0, metavar="BYTES",
                    help="L2 cache tier budget in bytes (0 disables; >0 budgets "
                         "an L2 tier behind the hot tier, used by picasso_l2 and "
                         "picasso_narrow; in device memory, or in pinned host "
                         "memory with --pin-l2)")
    ap.add_argument("--narrow-dim", type=int, default=0, metavar="D",
                    help="narrow master width for picasso_narrow (0 disables): "
                         "cold ids are stored and routed at this width and "
                         "projected up at lookup, hot ids stay full-width in "
                         "the tiers")
    ap.add_argument("--pin-l2", action="store_true",
                    help="place the L2 tier leaves (and narrow masters) in "
                         "pinned host memory, read and written in place by the "
                         "kernels over the bus and kept there across steps, "
                         "flushes and replans (a no-op where torch has no CUDA)")
    ap.add_argument("--calibrate", default="off", choices=("auto", "force", "off"),
                    help="measured cost model for mixed/auto assignment and "
                         "replanning: 'auto' loads the stamped calibration file "
                         "(--calib-file) or microbenches the priced ops once and "
                         "writes it, 'force' always re-benches, 'off' keeps the "
                         "constant model (the default)")
    ap.add_argument("--calib-file", default="", metavar="PATH",
                    help="calibration cache for --calibrate (default: "
                         "~/.cache/repro_torch/calibration.json); reused only "
                         "when its stamp matches this process")
    ap.add_argument("--grad-compress", default="none", choices=("none", "fp16", "topk"),
                    help="wire compression of the routed sparse-gradient "
                         "payload (the transposed-Shuffle all_to_all and the "
                         "PS/allgather_rows gradient all_gather): 'fp16' = "
                         "per-row amax-scaled float16 cast, 'topk' = per-row "
                         "magnitude top-(D/4) sparsification, 'none' keeps "
                         "training bitwise-exact")
    ap.add_argument("--overlap", default="auto", choices=("off", "on", "auto"),
                    help="software-pipelined train step: 'on' issues the "
                         "sparse lookup of micro-batch i+1 behind a handoff "
                         "while the dense stage of i runs, 'off' keeps the "
                         "plain loop, 'auto' overlaps whenever the step has "
                         ">1 micro-batch; numerics are identical either way")
    ap.add_argument("--no-cache", action="store_true",
                    help="no HybridHash hot tier (the plan budgets none)")
    ap.add_argument("--no-packing", action="store_true",
                    help="one packed group per table (no D-Packing)")
    ap.add_argument("--no-interleave", action="store_true",
                    help="one K-Interleaving wave of every packed group")
    ap.add_argument("--n-micro", type=int, default=None,
                    help="D-Interleaving micro-batches per step (default: planned)")
    ap.add_argument("--learnable", action="store_true",
                    help="synthetic stream with a learnable CTR signal "
                         "(default: random labels)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--lr-emb", type=float, default=0.05)
    ap.add_argument("--lr-dense", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the batch stream")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where tables and compute live (default cuda; cpu "
                         "only when asked)")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory: run under the Supervisor "
                         "(restore + replay on a transient failure) and resume "
                         "from the newest verified checkpoint")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--guard", action="store_true",
                    help="numeric anomaly guard: a NaN/Inf loss or a grad-norm "
                         "spike (EMA threshold) rejects the step (its rows "
                         "restored from a journal, the batch skipped, the event "
                         "logged); K consecutive rejections roll back to the "
                         "last verified checkpoint")
    ap.add_argument("--chaos", default="", metavar="SPEC",
                    help="deterministic fault injection: comma-separated "
                         "kind@step tokens, kinds nan (poison batch), crash "
                         "(raise at step), ckpt (corrupt the newest checkpoint "
                         "on disk), torn (tear the published delta); e.g. "
                         "'nan@7,crash@13,ckpt@20,torn@45'")
    ap.add_argument("--stream", action="store_true",
                    help="streaming driver: --stream-segments segments of "
                         "--segment-steps (ignoring --steps), a checkpoint and "
                         "a published delta at every segment boundary")
    ap.add_argument("--segment-steps", type=int, default=20, metavar="N")
    ap.add_argument("--stream-segments", type=int, default=3, metavar="K")
    ap.add_argument("--publish-dir", default="", metavar="DIR",
                    help="streaming mode: publish the serveable state (emb + "
                         "dense) here at every segment boundary, with an atomic "
                         "LATEST pointer that repro_torch.launch.serve "
                         "--reload-dir picks up without restart")
    ap.add_argument("--replan-iters", type=int, default=0, metavar="N",
                    help="every N steps harvest the live FCounter, recompile "
                         "the tier budgets (and a mixed/auto assignment) and "
                         "migrate the state to the new plan revision (0: off)")
    ap.add_argument("--replan-hot-bytes", type=int, default=None, metavar="BYTES",
                    help="hot-tier byte envelope of replan re-budgets (default: "
                         "the plan's)")
    ap.add_argument("--replan-l2-bytes", type=int, default=None, metavar="BYTES",
                    help="L2 byte envelope of replan re-budgets (default: the "
                         "plan's)")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks to run (one process each; 0: one rank, or the "
                         "--mesh size)")
    ap.add_argument("--mesh", default="", metavar="AxB",
                    help="mesh shape, e.g. 2x2 or 4 (default: --devices x 1); "
                         "world = its product")
    ap.add_argument("--reshard-to", default="", metavar="AxB",
                    help="elastic reshard target mesh, e.g. 2x1 or 4: at "
                         "--reshard-at the run recuts the plan for the new world, "
                         "moves the live state exactly (every master row, Adagrad "
                         "slot and FCounter bitwise), rebuilds the step and goes on "
                         "on the first prod(MESH) ranks; max(world, new world) "
                         "processes are started")
    ap.add_argument("--reshard-at", type=int, default=0, metavar="STEP",
                    help="step at which to apply --reshard-to")
    args = ap.parse_args(argv)
    if args.replan_iters < 0:
        ap.error("--replan-iters must be >= 0 (0 disables replanning)")
    if args.reshard_at and not args.reshard_to:
        ap.error("--reshard-at needs --reshard-to")
    from repro_torch.launch.mesh import mesh_world, parse_mesh

    try:
        # with --reshard-to, --devices counts every process (the spares too)
        shape = parse_mesh(args.mesh, 0 if args.reshard_to and args.mesh else args.devices)
        procs = mesh_world(shape)
        if args.reshard_to:
            procs = max(procs, mesh_world(parse_mesh(args.reshard_to)))
            if args.devices and args.devices != procs:
                raise ValueError(f"--devices {args.devices}: --mesh {args.mesh or shape[0]} "
                                 f"and --reshard-to {args.reshard_to} need {procs} ranks")
    except ValueError as e:
        ap.error(str(e))
    launch_ranks("train", args, shape, _train, waiting={
        "--replan-iters": bool(args.replan_iters), "--pin-l2": args.pin_l2,
        "--calibrate": args.calibrate != "off"}, procs=procs)


def launch_ranks(tag: str, args, shape, body, waiting, procs: int = 0) -> None:
    """Run ``body(group, args, shape)`` on ``procs`` ranks (default: the
    world ``prod(shape)``): in this process when that is 1, else in one
    spawned process a rank. Past one rank the flags in ``waiting`` that are
    set refuse first, and ``PYTHONHASHSEED`` is fixed before the spawn."""
    import os

    from repro_torch.dist.compat import WORLD1, backend_for, spawn_ranks
    from repro_torch.launch.mesh import describe, mesh_world

    world = mesh_world(shape)
    procs = max(procs, world)
    if procs == 1:
        return body(WORLD1, args, shape)
    on = [flag for flag, set_ in waiting.items() if set_]
    if on:
        raise NotImplementedError(
            f"{', '.join(on)} on {procs} ranks: the rest of the runtime past world 1 is "
            "ROADMAP Queue 1 item 6.3b (the replanner, --pin-l2 and --calibrate wait for "
            "it)")
    seed = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = seed if seed is not None else "0"
    print(f"[{tag}] world={world} mesh={describe(shape)} "
          f"backend={backend_for(args.device, procs)} "
          f"PYTHONHASHSEED={os.environ['PYTHONHASHSEED']}"
          f"{' (this process)' if seed is not None else ' (set by the launcher)'}"
          f"{f' processes={procs}' if procs != world else ''}",
          flush=True)
    spawn_ranks(body, procs, args, shape, device=args.device)


def _train(root, args, shape) -> None:
    """One process of the training run (the whole run at world 1). ``root``
    is every process started; the live world is its first ``prod(shape)``
    ranks, and with ``--reshard-to`` the others wait until the reshard."""
    import logging
    import time

    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.core.features import agree_salts
    from repro_torch.core.packing import make_plan
    from repro_torch.data.pipeline import Prefetcher, ReplayableStream
    from repro_torch.data.synthetic import batch_stream
    from repro_torch.dist import compat
    from repro_torch.embedding.state import pin_to_host, warn_pin_l2_limits
    from repro_torch.engine import maybe_compile, resolve_assignment
    from repro_torch.kernels.host_memory import pinned_bytes
    from repro_torch.models.wdl import WDLModel
    from repro_torch.runtime import (AnomalyGuard, ChaosController, Replanner,
                                     apply_plan_meta, parse_fault_plan, plan_meta,
                                     publish_state, run_stream)
    from repro_torch.runtime.elastic import (end_run, make_submesh, parse_mesh_shape,
                                             reshard_live, restore_elastic, wait_for_reshard)
    from repro_torch.train.checkpoint import (AsyncCheckpointer, latest_step,
                                              load_checkpoint_meta, load_checkpoint_salts,
                                              restore_verified)
    from repro_torch.train.fault_tolerance import Supervisor
    from repro_torch.train.train_step import TrainConfig, init_state, make_train_step
    from repro_torch.dist.compat import rank_device
    from repro_torch.launch.mesh import describe, mesh_world

    to = parse_mesh_shape(args.reshard_to) if args.reshard_to else None
    world = mesh_world(shape)
    # the live world: every process makes the group, in the same order
    group = make_submesh(shape, group=root) if to is not None else root
    lead = root.rank == 0  # rank 0 is in every world

    def say(*a, **kw):
        if lead:
            print(*a, **kw)

    # recovery events (rollbacks, quarantines) are the operator's window into
    # the fault-tolerance subsystem; past world 1 each rank logs its own
    logging.basicConfig(format=(f"[rank {root.rank}] " if root.world > 1 else "")
                        + "[%(name)s] %(levelname)s: %(message)s")
    logging.getLogger("repro_torch").setLevel(logging.INFO)

    device = rank_device(resolve_device(args.device), root)
    cost_model = None
    if args.calibrate != "off":
        from repro_torch.perf import get_cost_model
        cost_model = get_cost_model(
            args.calibrate, args.calib_file or None,
            grid="tiny" if args.smoke else "small", device=device,
            log=lambda s: print(f"[train] calib {s}", flush=True))
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.global_batch % world:
        raise SystemExit(f"--global-batch {args.global_batch} does not split over "
                         f"{world} ranks")
    plan = make_plan(cfg, world=world, per_device_batch=args.global_batch // world,
                     enable_packing=not args.no_packing,
                     enable_cache=not args.no_cache, n_micro=args.n_micro,
                     hot_bytes=1 << 24 if args.smoke else 1 << 30,
                     l2_bytes=args.l2_budget, narrow_dim=args.narrow_dim or None,
                     flush_iters=20, warmup_iters=10,
                     mesh_shape=shape if world > 1 else (1, 1))
    salts = agree_salts(plan, group) if group is not None else None
    meta = None
    if args.ckpt_dir and group is not None and latest_step(args.ckpt_dir, group) is not None:
        # a checkpointed run may have replanned: revise the structural plan
        # back to the checkpointed revision before the state is shaped
        meta = load_checkpoint_meta(args.ckpt_dir, group=group)
        if meta is not None:
            plan = apply_plan_meta(plan, meta)
            say(f"[train] resumed plan rev {plan.rev} from checkpoint meta "
                f"(strategy: {sorted(set(plan.strategy.values()))})")
        if load_checkpoint_salts(args.ckpt_dir, group=group) is None:
            say(f"[train] checkpoint under {args.ckpt_dir} records no packing salts "
                "(written by the reference); restoring it unchecked", flush=True)
    if plan.strategy:
        # the plan carries the checkpointed assignment: every engine follows it
        strategy = "mixed"
    else:
        # record the assignment before init_state: a compiled mix or a
        # 'picasso_narrow' broadcast gates the master widths the state is
        # sized by; training issues plan.microbatch ids a step
        strategy = maybe_compile(plan, args.strategy, use_cache=not args.no_cache,
                                 cost_model=cost_model,
                                 log=lambda s: say(f"[train] {s}"))
        resolve_assignment(plan, strategy, world=world, use_cache=not args.no_cache)

    guard = None
    if args.guard:
        guard = AnomalyGuard(log=lambda s: say(f"[train] {s}", flush=True), group=group)
    chaos = None
    if args.chaos:
        chaos = ChaosController(parse_fault_plan(args.chaos), group=group)
        say(f"[train] chaos plan armed: {args.chaos}", flush=True)

    def wrap_timed(fn):
        """Measured-vs-predicted feedback: time each step (ended by a
        synchronize on the card) and feed the wall time to the Replanner.
        Only wrapped when a calibrated cost model is live: the per-step sync
        it costs is what the feedback loop needs to be honest."""
        if cost_model is None:
            return fn

        def timed(state, batch):
            t0 = time.perf_counter()
            out = fn(state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            if replanner is not None:
                replanner.observe_timing((time.perf_counter() - t0) * 1e6)
            return out
        return timed

    def build_step(plan):
        """(Re)build the step against a plan revision (and the live group);
        the guard (if armed) judges the fresh step and keeps its EMA and
        event history."""
        model = WDLModel(cfg, plan)
        tcfg = TrainConfig(strategy="mixed" if plan.strategy else strategy,
                           use_cache=not args.no_cache,
                           use_interleave=not args.no_interleave, overlap=args.overlap,
                           use_fused_kernels=args.fused_kernels,
                           grad_compress=args.grad_compress, pin_l2=args.pin_l2,
                           lr_emb=args.lr_emb, lr_dense=args.lr_dense)
        # a judged step journals the rows it writes so it can reject itself
        raw = make_train_step(model, plan, args.global_batch, tcfg, device, group=group)
        return model, tcfg, wrap_timed(guard.rebind(raw) if guard is not None else raw)

    # the positional factory gives the Supervisor an exact rewind after a
    # rollback (ReplayableStream.seek)
    stream = ReplayableStream(lambda start: Prefetcher(
        batch_stream(cfg, args.global_batch, seed=args.seed, learnable=args.learnable,
                     start=start), depth=2))
    if chaos is not None:
        stream = chaos.wrap_stream(stream)
    # active_ckpt: the checkpointer chaos ckpt@ targets; ckpt: the stream's
    replanner = sup = active_ckpt = ckpt = None
    reshard_pending = to is not None

    def on_metrics(step, m):
        if replanner is not None:
            replanner.observe(m)
        if step % args.log_every == 0:
            tiers = "".join(f" {k.split('/')[1]}={int(m[k])}" for k in
                            ("cache_hits/l1", "cache_hits/l2") if k in m)
            say(f"  step {step:5d} loss={float(m['loss']):.4f} "
                f"hits={int(m['cache_hits'])} ovf={int(m['overflow'])}{tiers}",
                flush=True)
        if chaos is not None:
            if args.ckpt_dir:
                chaos.after_checkpoint(step, args.ckpt_dir, active_ckpt)
            # raised inside the Supervisor's loop (or run_stream's), a crash@
            # fault drives the real recovery path of either driver
            chaos.injector(step)

    def join(state, step):
        """Every rank of a new world, right after the reshard: the salts
        agreed, the guard's history and the step rebuilt on the new group,
        and (``--ckpt-dir``) a Supervisor on it that writes the durable
        checkpoint at the new world, as the reference does; under
        ``--stream`` the stream's checkpointer on the new group instead (the
        next boundary writes at the new world, as the reference's stream
        does)."""
        nonlocal salts, model, tcfg, step_fn, sup, active_ckpt, ckpt
        salts = agree_salts(plan, group)
        if guard is not None:
            guard.group = group
            kept = compat.ckpt_broadcast_object(
                (guard.ema, guard.accepted, guard.rejected, guard.consecutive,
                 guard.events), group)
            guard.ema, guard.accepted, guard.rejected, guard.consecutive, guard.events = kept
        if chaos is not None:
            chaos.group = group
        model, tcfg, step_fn = build_step(plan)
        stream.seek(step)
        if args.ckpt_dir and args.stream:
            ckpt = active_ckpt = AsyncCheckpointer(args.ckpt_dir, salts=salts, group=group)
        elif args.ckpt_dir:
            sup = Supervisor(args.ckpt_dir, ckpt_every=args.ckpt_every, salts=salts,
                             group=group)
            active_ckpt = sup.ckpt
            sup.meta = plan_meta(plan)
            # durable, world-consistent restore point: a later failure must
            # restore the new rows and the new world's meta
            sup.ckpt.save(step, state, meta=sup.meta)
            sup.ckpt.wait()

    def do_reshard(state, step, seg=None):
        """The live ranks' reshard to --reshard-to at ``step`` (one-shot;
        under ``--stream`` at the end of segment ``seg``, which the event a
        spare joins by carries): the state moves to the new world's ranks;
        ``None`` on a rank that leaves it."""
        nonlocal plan, group, world, reshard_pending
        reshard_pending = False  # applied (or a no-op): never fires again
        new_world = mesh_world(to)
        if new_world == world:
            return state
        if args.global_batch % new_world:
            raise SystemExit(f"[train] --reshard-to {args.reshard_to}: global batch "
                             f"{args.global_batch} not divisible by new world {new_world}")
        say(f"[train] reshard world {world} -> {new_world} (mesh {describe(to)}) at step "
            f"{step}", flush=True)
        plan, state, group = reshard_live(plan, state, new_world,
                                          args.global_batch // new_world, group=group,
                                          mesh_shape=to,
                                          note={"step": step, **({} if seg is None
                                                                 else {"seg": seg})})
        world = new_world
        if group is not None:
            join(state, step)
        return state

    def next_boundary(step):
        """Next replan/reshard step strictly after ``step``."""
        ri = args.replan_iters
        b = min(args.steps, (step // ri + 1) * ri) if ri else args.steps
        if reshard_pending and step < args.reshard_at:
            b = min(b, args.reshard_at)
        return b

    def do_replan(state, step):
        """Harvest + recompile; on a real change, migrate + rebuild the step.
        Returns (state, migrated?)."""
        nonlocal plan, model, tcfg, step_fn
        out = replanner.maybe_replan(state, step=step)
        if out is None:
            return state, False
        plan, state = out  # migrated under --pin-l2's placement (Replanner(pin_l2=))
        model, tcfg, step_fn = build_step(plan)
        if args.pin_l2:
            print(f"[train] pin-l2: {pinned_bytes()} bytes pinned", flush=True)
        return state, True

    start, first_seg = 0, 1
    if group is None:
        # a spare: no state until the reshard names this rank
        ev = wait_for_reshard(root)
        if ev is None:
            return  # the run ended without it
        reshard_pending = False
        plan, state, group = reshard_live(
            apply_plan_meta(plan, ev["meta"]), None, ev["world"],
            args.global_batch // ev["world"], mesh_shape=ev["mesh_shape"], device=device)
        world, start = ev["world"], ev["step"]
        first_seg = ev.get("seg", 0) + 1  # a stream's: the segments that remain
        if group is None:  # not named: nothing to do but wait for the end
            wait_for_reshard(root)
            return
        join(state, start)
    else:
        model, tcfg, step_fn = build_step(plan)
        state = init_state(model, plan,
                           torch.Generator(device=device).manual_seed(args.seed), device,
                           group=group)
        if args.pin_l2:
            # placed once here: the flushes, the journal, restores and the
            # replanner's migration keep it, and the step checks it
            warn_pin_l2_limits()  # one-time: the no-op notice where torch has no CUDA
            state = pin_to_host(state, plan)
            print(f"[train] pin-l2: {pinned_bytes()} bytes pinned", flush=True)
        if args.replan_iters:
            replanner = Replanner(plan, strategy=args.strategy,
                                  hot_bytes=args.replan_hot_bytes,
                                  l2_bytes=args.replan_l2_bytes,
                                  use_cache=not args.no_cache,
                                  cache_update=tcfg.cache_update, cost_model=cost_model,
                                  pin_l2=args.pin_l2,
                                  log=lambda s: print(f"[train] replan {s}", flush=True))
        mesh = f" mesh={describe(shape)} backend={group.backend}" if world > 1 else ""
        say(f"[train] {cfg.name}: {len(plan.groups)} packed groups, "
            f"micro={plan.microbatch}, ilv={len(plan.interleave)} waves, world={world},"
            f"{mesh} device={device}, plan rev={plan.rev}")
        if args.ckpt_dir and args.stream:
            ckpt = active_ckpt = AsyncCheckpointer(args.ckpt_dir, salts=salts, group=group)
            if latest_step(args.ckpt_dir, group) is not None:
                if meta is not None and int(meta.get("world", world)) != world:
                    # written at another world: the exact recut, as the
                    # reference's stream resumes
                    state, start = restore_elastic(
                        args.ckpt_dir, plan, state, group=group,
                        log=lambda s: say(f"[train] elastic {s}", flush=True))
                else:
                    state, start = restore_verified(
                        args.ckpt_dir, state, group=group,
                        log=lambda s: say(f"[train] {s}", flush=True))
                stream.seek(start)  # resume replays from the exact batch index
                say(f"[train] stream resumed at step {start}", flush=True)
        elif args.ckpt_dir:
            sup = Supervisor(args.ckpt_dir, ckpt_every=args.ckpt_every, salts=salts,
                             group=group)
            active_ckpt = sup.ckpt
            # the plan sidecar rides every checkpoint: it records the world
            # the state was written at (the elastic restore reads it) and,
            # after a replan, the revision a resume must shape its template by
            sup.meta = plan_meta(plan)
            if meta is not None and int(meta.get("world", world)) != world:
                # written at another world: the exact recut, not the template
                state, start = restore_elastic(
                    args.ckpt_dir, plan, state, group=group,
                    log=lambda s: say(f"[train] elastic {s}", flush=True))
            else:
                state, start = sup.maybe_restore(state)
            stream.seek(start)  # resume replays from the exact batch index

    try:
        step = start
        if args.stream:
            # segments over the unbounded stream (--steps is ignored); each
            # boundary checkpoints, publishes and may reshard
            publisher = None
            if args.publish_dir:
                def publisher(step, state):
                    # torn@ tears the delta before LATEST names it
                    tear = (None if chaos is None else
                            lambda: chaos.after_publish(step, args.publish_dir))
                    publish_state(args.publish_dir, step, state, meta=plan_meta(plan),
                                  salts=salts, group=group, before_latest=tear)
                    say(f"[stream] published step {step} -> {args.publish_dir}",
                        flush=True)

            def on_segment(seg, step, state):
                if not (reshard_pending and step >= args.reshard_at):
                    return None
                if ckpt is not None:
                    ckpt.wait()  # the rows move on the root's ckpt_pg
                state = do_reshard(state, step, seg)
                return state, step_fn, stream, ckpt

            state, last = run_stream(
                state, step_fn, stream, segment_steps=args.segment_steps,
                n_segments=args.stream_segments, start_step=start, first_segment=first_seg,
                checkpointer=ckpt, meta_fn=lambda: plan_meta(plan), publisher=publisher,
                on_metrics=on_metrics, on_segment=on_segment,
                log=lambda s: say(s, flush=True))
            if ckpt is not None:
                ckpt.wait()
            say(f"[train] stream done at step {last} (world={world})")
        elif sup is not None:
            while step < args.steps:
                seg_end = next_boundary(step)
                state = sup.run(state, step_fn, stream, seg_end, start_step=step,
                                on_metrics=on_metrics)
                step = seg_end
                if reshard_pending and step >= args.reshard_at and step < args.steps:
                    state = do_reshard(state, step)
                    if state is None:
                        break  # this rank left the world
                if replanner is not None and step < args.steps:
                    state, migrated = do_replan(state, step)
                    if migrated:
                        # a plan-consistent restore point: a later failure
                        # must not restore pre-migration tier shapes
                        sup.meta = plan_meta(plan)
                        sup.ckpt.save(step, state, meta=sup.meta)
                        sup.ckpt.wait()
        else:
            it = iter(stream)
            while step < args.steps:
                try:
                    batch = next(it)
                except StopIteration:  # the stream ended or stalled: finish
                    break
                state, m = step_fn(state, batch)
                step += 1
                on_metrics(step, m)
                if reshard_pending and step >= args.reshard_at and step < args.steps:
                    state = do_reshard(state, step)
                    if state is None:
                        break  # this rank left the world
                    it = iter(stream)
                if (replanner is not None and step % args.replan_iters == 0
                        and step < args.steps):
                    state, _ = do_replan(state, step)
    except BaseException as e:
        if ckpt is not None:
            # a joint write in flight ends on every rank (they fail alike at
            # a crash@ step) before this rank leaves
            try:
                ckpt.wait()
            except Exception:  # noqa: BLE001 — the run's own error is raised below
                pass
        if to is not None and group is not None:
            end_run(ok=False, why=f"{type(e).__name__}: {e}", root=root)
        raise
    finally:
        stream.close()
    if to is not None:
        if group is None:  # left the world: hold nothing, wait for the run's end
            del state
            if device.type == "cuda":
                torch.cuda.empty_cache()
            if wait_for_reshard(root) is not None:
                raise RuntimeError("a second reshard: the launcher makes one")
            return
        end_run(root=root)
    if args.stream:
        return
    if replanner is not None:
        n_mig = sum(1 for e in replanner.events if e.migrated)
        print(f"[train] replans: {len(replanner.events)} attempted, {n_mig} migrated, "
              f"final plan rev={plan.rev}")
    if guard is not None:
        say(f"[train] guard: {guard.accepted} accepted, {guard.rejected} rejected")
    say("[train] done")


if __name__ == "__main__":
    main()
