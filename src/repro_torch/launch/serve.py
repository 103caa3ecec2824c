"""Serving launcher of the PyTorch port: batched scoring of deepfm, dcn-v2,
sasrec or mind, or two-tower retrieval of sasrec or mind, on one card or on
``--devices`` ranks.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepfm --smoke \\
      --batch 512 --n-requests 10
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dcn-v2 \\
      --batch 512 --n-requests 10
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dcn-v2 --smoke \\
      --device cpu --n-requests 3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepfm --batch 512 \\
      --strategy picasso_narrow --narrow-dim 4 --l2-budget 2147483648
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepfm --batch 512 \\
      --no-packing --strategy mixed
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepfm --batch 512 \\
      --strategy picasso_narrow --narrow-dim 4 --l2-budget 2147483648 --pin-l2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepfm --batch 512 \\
      --no-packing --strategy auto --calibrate auto

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepfm --smoke \\
      --device cpu --n-requests 6 --reload-dir /tmp/pub --chaos torn@3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch sasrec --batch 512
  PYTHONPATH=src python -m repro_torch.launch.serve --arch sasrec --smoke \\
      --device cpu --retrieval
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mind --retrieval \\
      --n-candidates 1048576 --score-chunk 65536
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepfm --smoke \
      --device cpu --devices 4 --mesh 2x2 --batch 64 --n-requests 3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepfm --smoke \\
      --device cpu --devices 4 --mesh 2x2 --batch 64 --n-requests 3 \\
      --reload-dir /tmp/pub4

Runs on ``cuda`` unless ``--device cpu`` is given; without a GPU it raises.
``--strategy mixed``/``auto`` compiles a per-group assignment at the
serving batch before the state is made and prints it: on the constant cost
model, or with ``--calibrate auto|force`` on curves measured on this device
(``repro_torch.perf``, cached in ``--calib-file``). ``--pin-l2`` places the
L2 tier leaves in pinned host memory (``embedding.state.pin_l2_to_host``,
the reference serve launcher's placement), which the kernels read over the
bus, and prints the bytes pinned. ``--reload-dir`` follows a streaming trainer's published deltas
(``repro_torch.launch.train --stream --publish-dir``): the serve state is
shaped by the published plan revision, and before each request the server
polls for a new delta and loads it in place once every leaf has passed its
checksum; a delta published at another world is recut onto this server's
plan (``runtime.stream.load_published``); a torn or corrupt delta, or one of
another plan revision, is skipped and the last good state keeps serving. A delta packed under other table salts raises
(``PYTHONHASHSEED``). ``--chaos torn@i`` tears the newest delta before
request ``i``. Past world 1 rank 0 reads the published plan and ``LATEST``
for every rank, the ranks agree on each poll's step (one small agreement a
request) and load the delta together, each its rows (a delta of another
world each its new cut of the stored rows), or all keep their last good
state; rank 0 tears a delta between two agreements and prints every line.

``--retrieval`` (sasrec, mind) plans as the reference's launcher does (one
user, no hot tier, exact capacities, a ``mixed``/``auto`` assignment
compiled at the candidate tower's proxy batch), scores ``arange(n) % vocab``
as the candidates' packed rows and prints the top 10 ids and scores. With
``--smoke`` its weights are drawn as the reference's
``init_state(PRNGKey(seed))`` draws them, on the host. The reference's
launcher has no seed and draws ``PRNGKey(0)``, so at the default ``--seed
0`` a smoke retrieval prints what ``repro.launch.serve --retrieval`` prints
under the same ``PYTHONHASHSEED``. Every other run draws its weights from a
generator on the device.

``--devices N``/``--mesh AxB`` serve on ``world = prod(mesh)`` ranks, one
process each, as ``repro_torch.launch.train`` runs them (its docstring):
each rank scores ``batch // world`` samples of every request, retrieval
ranks score ``n // world`` candidates each and merge their top-k; rank 0
prints. ``--pin-l2`` and ``--calibrate`` refuse at world > 1 (ROADMAP Queue 1
item 6.3b).
"""
import argparse


def main(argv=None):
    from repro_torch.engine import AUTO_NAMES, available_strategies

    names = available_strategies()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="deepfm", help="deepfm | dcn-v2 | sasrec | mind")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized tables)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--n-requests", type=int, default=10)
    ap.add_argument("--strategy", default="picasso", choices=names + AUTO_NAMES,
                    help="EmbeddingEngine lookup strategy: one of "
                         f"{', '.join(names)} (broadcast to every packed "
                         f"group), or {'/'.join(AUTO_NAMES)} for the "
                         "per-group cost-model assignment")
    ap.add_argument("--no-packing", action="store_true",
                    help="one packed group per table (no D-Packing)")
    ap.add_argument("--l2-budget", type=int, default=0, metavar="BYTES",
                    help="L2 cache tier budget in bytes (0 disables; >0 budgets "
                         "an L2 tier behind the hot tier, used by picasso_l2 and "
                         "picasso_narrow; in device memory, or in pinned host "
                         "memory with --pin-l2)")
    ap.add_argument("--narrow-dim", type=int, default=0, metavar="D",
                    help="narrow master width for picasso_narrow (0 disables): "
                         "cold ids are stored at D columns and up-projected at "
                         "lookup, hot ids stay full-width in the tiers")
    ap.add_argument("--pin-l2", action="store_true",
                    help="place the L2 tier leaves in pinned host memory, read "
                         "by the kernels over the bus (pin_l2_to_host; a no-op "
                         "where torch has no CUDA)")
    ap.add_argument("--calibrate", default="off", choices=("auto", "force", "off"),
                    help="measured cost model for the mixed/auto assignment: "
                         "'auto' loads the stamped calibration file "
                         "(--calib-file) or benches once and writes it, 'force' "
                         "always re-benches, 'off' (default) keeps the constant "
                         "model")
    ap.add_argument("--calib-file", default="", metavar="PATH",
                    help="calibration cache for --calibrate (default: "
                         "~/.cache/repro_torch/calibration.json); reused only "
                         "when its stamp matches this process")
    ap.add_argument("--fused-kernels", default="auto", choices=("auto", "on", "off"),
                    help="CUDA kernels: 'auto' for tensors on the card, 'on' "
                         "forces them (raises on the CPU), 'off' forces the "
                         "plain PyTorch versions")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where tables and compute live (default cuda; cpu "
                         "only when asked)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights (with --smoke --retrieval "
                         "drawn as the reference's PRNGKey(seed) draws them) and "
                         "the request stream")
    ap.add_argument("--retrieval", action="store_true",
                    help="two-tower retrieval (sasrec, mind): top-10 of the "
                         "candidates for one user")
    ap.add_argument("--candidates", type=int, default=65536)
    ap.add_argument("--n-candidates", type=int, default=None, metavar="N",
                    help="retrieval candidate count (falls back to --candidates)")
    ap.add_argument("--score-chunk", type=int, default=0, metavar="C",
                    help="retrieval: score the candidates in chunks of C (a "
                         "streaming top-k; the candidate engine's capacity and "
                         "memory scale with C); 0 scores them in one chunk")
    ap.add_argument("--reload-dir", default="", metavar="DIR",
                    help="pick up model deltas a streaming trainer publishes "
                         "(repro_torch.launch.train --stream --publish-dir DIR): "
                         "before each request, poll DIR/LATEST and load the emb + "
                         "dense state in place, no restart")
    ap.add_argument("--chaos", default="", metavar="SPEC",
                    help="fault injection for the reload path: 'torn@i' tears "
                         "the newest published delta on disk before request i "
                         "(needs --reload-dir); the server must keep answering "
                         "from its last good state")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks to run (one process each; 0: one rank, or the "
                         "--mesh size)")
    ap.add_argument("--mesh", default="", metavar="AxB",
                    help="mesh shape, e.g. 2x2 or 4 (default: --devices x 1); "
                         "world = its product")
    args = ap.parse_args(argv)
    if args.chaos and not args.reload_dir:
        ap.error("--chaos needs --reload-dir (faults target published deltas)")
    if args.retrieval and (args.reload_dir or args.l2_budget):
        ap.error("--retrieval runs uncached from a fresh state: no --reload-dir "
                 "or --l2-budget")
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.launch.train import launch_ranks

    try:
        shape = parse_mesh(args.mesh, args.devices)
    except ValueError as e:
        ap.error(str(e))
    launch_ranks("serve", args, shape, _serve, waiting={
        "--pin-l2": args.pin_l2, "--calibrate": args.calibrate != "off"})


def _serve(group, args, shape) -> None:
    """One rank of the serving run (the whole run at world 1)."""
    import time

    import numpy as np
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.core.features import agree_salts
    from repro_torch.core.packing import make_plan
    from repro_torch.data.synthetic import make_batch
    from repro_torch.dist.compat import all_gather_tiled, rank_device
    from repro_torch.engine import maybe_compile, resolve_assignment
    from repro_torch.launch.mesh import describe
    from repro_torch.models.wdl import WDLModel
    from repro_torch.serve.serve_step import ServeConfig, init_state, make_serve_step

    world, lead = group.world, group.rank == 0

    def say(*a, **kw):
        if lead:
            print(*a, **kw)

    device = rank_device(resolve_device(args.device), group)
    cost_model = None
    if args.calibrate != "off":
        from repro_torch.perf import get_cost_model
        cost_model = get_cost_model(
            args.calibrate, args.calib_file or None,
            grid="tiny" if args.smoke else "small", device=device,
            log=lambda s: print(f"[serve] calib {s}", flush=True))
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.retrieval:
        return retrieve(args, cfg, device, cost_model, group, shape)
    if args.batch % world:
        raise SystemExit(f"--batch {args.batch} does not split over {world} ranks")
    rng = torch.Generator(device=device).manual_seed(args.seed)
    plan = make_plan(cfg, world=world, per_device_batch=args.batch // world,
                     l2_bytes=args.l2_budget, narrow_dim=args.narrow_dim or None,
                     enable_packing=not args.no_packing,
                     mesh_shape=shape if world > 1 else (1, 1))
    agree_salts(plan, group)  # every rank packs alike, or all raise
    if world > 1:
        say(f"[serve] {cfg.name}: world={world} mesh={describe(shape)} "
            f"backend={group.backend} device={device}", flush=True)
    if args.reload_dir:
        # shape the serve state by the published plan revision (tier budgets,
        # strategy, narrow widths) so published deltas load as they are
        from repro_torch.runtime import apply_plan_meta
        from repro_torch.train.checkpoint import load_checkpoint_meta

        pub_meta = load_checkpoint_meta(args.reload_dir, group=group)  # rank 0's reading
        if pub_meta is not None:
            plan = apply_plan_meta(plan, pub_meta)
            say(f"[serve] following published plan rev {plan.rev} from "
                f"{args.reload_dir}")
    if plan.strategy:
        strategy = "mixed"  # the published assignment
    else:
        # record the assignment before init_state: a compiled mix or a
        # 'picasso_narrow' broadcast gates the master widths the state is
        # sized by; serving has no micro pipeline, so the cost model sees
        # the batch
        strategy = maybe_compile(plan, args.strategy, per_device_batch=args.batch // world,
                                 cost_model=cost_model,
                                 log=lambda s: say(f"[serve] {s}"))
        resolve_assignment(plan, strategy, world=world)
    model = WDLModel(cfg, plan)
    state = init_state(model, plan, rng, device, group=group)
    if args.pin_l2:
        from repro_torch.embedding.state import pin_l2_to_host, warn_pin_l2_limits
        from repro_torch.kernels.host_memory import pinned_bytes

        warn_pin_l2_limits()  # one-time: the no-op notice where torch has no CUDA
        state = pin_l2_to_host(state)
        print(f"[serve] pin-l2: {pinned_bytes()} bytes pinned", flush=True)
    scfg = ServeConfig(strategy=strategy, use_fused_kernels=args.fused_kernels)
    serve = make_serve_step(model, plan, args.batch, scfg, device, group=group)
    poller = torn = None
    if args.reload_dir:
        # degraded-mode pickup: a torn, corrupt or pruned delta is skipped with
        # capped backoff and the server keeps its last good state
        from repro_torch.runtime import PublishPoller, parse_fault_plan
        from repro_torch.runtime.chaos import tear_published_together

        # past world 1 the ranks agree on every poll's step and verdict
        poller = PublishPoller(args.reload_dir, plan=plan, group=group,
                               log=lambda s: say(s, flush=True))
        if args.chaos:
            torn, fired = parse_fault_plan(args.chaos).torn_publish, set()
    rng = np.random.default_rng(args.seed)
    lat = []
    for i in range(args.n_requests):
        if torn is not None and i in torn and i not in fired:
            fired.add(i)
            say(f"[serve] chaos: tearing published delta before request {i}", flush=True)
            tear_published_together(args.reload_dir, group)
        if poller is not None:
            out = poller.poll({"emb": state["emb"], "dense": state["dense"]})
            if out is not None:
                loaded, s_pub = out
                state = {**state, **loaded}
                say(f"[serve] reloaded published step {s_pub} from {args.reload_dir}",
                    flush=True)
        b = make_batch(cfg, args.batch, rng)
        t0 = time.perf_counter()
        probs = serve(state, b)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        lat.append(time.perf_counter() - t0)
        if poller is not None:  # which delta served the request, and what it gave
            whole = all_gather_tiled(probs, group)  # the whole request, rank-major
            head = " ".join(f"{float(p):.7f}" for p in whole.reshape(-1)[:4])
            say(f"[serve] request {i}: step {poller.last_step} "
                f"mean_prob={float(whole.mean()):.9f} probs[:4]={head}", flush=True)
    lat = np.array(lat[1:] or lat) * 1e3
    probs = all_gather_tiled(probs, group)  # the whole request, rank-major
    say(f"[serve] {args.arch} B={args.batch}: p50={np.percentile(lat, 50):.1f}ms "
        f"p99={np.percentile(lat, 99):.1f}ms mean_prob={float(probs.mean()):.3f}")


def retrieve(args, cfg, device, cost_model=None, group=None, shape=(1, 1)) -> None:
    """``--retrieval``: the reference launcher's retrieval plan (one user,
    no hot tier, exact capacities), the user from ``make_batch(cfg, 1,
    default_rng(1))``, candidates ``arange(n) % vocab`` (``n`` rounded down
    to a multiple of the world, as the reference's launcher does) and the
    top 10."""
    import numpy as np
    import torch

    from repro_torch.core.features import agree_salts, field_index
    from repro_torch.core.jax_random import prng_key
    from repro_torch.dist.compat import resolve_group
    from repro_torch.core.packing import make_plan
    from repro_torch.data.synthetic import make_batch
    from repro_torch.engine import maybe_compile, resolve_assignment
    from repro_torch.models.wdl import WDLModel
    from repro_torch.serve.serve_step import ServeConfig, init_state, make_retrieval_step

    item_field = next((f.name for f in cfg.fields if f.pooling == "none" and f.max_len > 1),
                      None)
    if item_field is None:
        raise SystemExit(f"--retrieval needs a two-tower arch (sasrec, mind), not {args.arch}")
    group = resolve_group(1, None) if group is None else group
    world = group.world
    plan = make_plan(cfg, world=world, per_device_batch=1, enable_cache=False,
                     exact_capacity=True, narrow_dim=args.narrow_dim or None,
                     enable_packing=not args.no_packing,
                     mesh_shape=shape if world > 1 else None)
    agree_salts(plan, group)
    nc = ((args.n_candidates or args.candidates) // world) * world
    # the candidate tower dominates the lookups: the cost model sees a score
    # chunk's worth of item-group samples, not the one-user batch
    ips = plan.group(field_index(plan)[item_field].gid).ids_per_sample
    local = nc // world
    proxy_batch = max(1, min(args.score_chunk or local, local) // max(ips, 1))
    strategy = maybe_compile(plan, args.strategy, per_device_batch=proxy_batch,
                             use_cache=False, cost_model=cost_model,
                             log=(lambda s: print(f"[serve] {s}")) if group.rank == 0
                             else None)
    resolve_assignment(plan, strategy, world=world, use_cache=False)
    model = WDLModel(cfg, plan)
    # smoke tables are small enough to draw the reference's numbers on the host
    rng = (prng_key(args.seed) if args.smoke
           else torch.Generator(device=device).manual_seed(args.seed))
    state = init_state(model, plan, rng, device, group=group)
    step = make_retrieval_step(model, plan, nc, top_k=10,
                               scfg=ServeConfig(strategy=strategy, use_cache=False,
                                                use_fused_kernels=args.fused_kernels),
                               score_chunk=args.score_chunk, device=device, group=group)
    user = make_batch(cfg, 1, np.random.default_rng(1))
    cand = torch.arange(nc, dtype=torch.int32, device=device) % cfg.fields[0].vocab
    scores, ids = step(state, user, cand)
    if group.rank == 0:
        print("top-10:", ids.cpu().numpy(), np.round(scores.cpu().numpy(), 3))


if __name__ == "__main__":
    main()
