"""Training launcher of the PyTorch port: PICASSO hybrid training of deepfm
or dcn-v2 on one card (world 1).

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm \\
      --steps 50 --global-batch 256
  PYTHONPATH=src python -m repro_torch.launch.train --arch dcn-v2 \\
      --steps 50 --global-batch 256
  PYTHONPATH=src python -m repro_torch.launch.train --arch dcn-v2 --smoke \\
      --device cpu --steps 3 --global-batch 32 --log-every 1
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm \\
      --global-batch 256 --strategy picasso_narrow --narrow-dim 4 \\
      --l2-budget 2147483648
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm \\
      --global-batch 256 --grad-compress topk
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm \\
      --global-batch 256 --no-packing --strategy mixed

Runs on ``cuda`` unless ``--device cpu`` is given; without a GPU it raises.
The plan is the reference launcher's: hot tier budget ``1<<24`` bytes with
``--smoke`` and ``1<<30`` without, a flush every 20 steps after 10 warm-up
steps. ``--strategy mixed``/``auto`` compiles a per-group assignment with
the constant cost model before the state is made and prints it.
"""
import argparse


def main(argv=None):
    from repro_torch.engine import AUTO_NAMES, available_strategies

    names = available_strategies()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="deepfm", help="deepfm | dcn-v2")
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
                         "picasso_narrow; the port keeps it in device memory)")
    ap.add_argument("--narrow-dim", type=int, default=0, metavar="D",
                    help="narrow master width for picasso_narrow (0 disables): "
                         "cold ids are stored and routed at this width and "
                         "projected up at lookup, hot ids stay full-width in "
                         "the tiers")
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
    args = ap.parse_args(argv)

    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.core.packing import make_plan
    from repro_torch.data.pipeline import Prefetcher, ReplayableStream
    from repro_torch.data.synthetic import batch_stream
    from repro_torch.engine import maybe_compile, resolve_assignment
    from repro_torch.models.wdl import WDLModel
    from repro_torch.train.train_step import TrainConfig, init_state, make_train_step

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    plan = make_plan(cfg, world=1, per_device_batch=args.global_batch,
                     enable_packing=not args.no_packing,
                     enable_cache=not args.no_cache, n_micro=args.n_micro,
                     hot_bytes=1 << 24 if args.smoke else 1 << 30,
                     l2_bytes=args.l2_budget, narrow_dim=args.narrow_dim or None,
                     flush_iters=20, warmup_iters=10)
    # record the assignment before init_state: a compiled mix or a
    # 'picasso_narrow' broadcast gates the master widths the state is sized
    # by; training issues plan.microbatch ids a step (per_device_batch=None)
    strategy = maybe_compile(plan, args.strategy, use_cache=not args.no_cache,
                             log=lambda s: print(f"[train] {s}"))
    resolve_assignment(plan, strategy, use_cache=not args.no_cache)
    model = WDLModel(cfg, plan)
    tcfg = TrainConfig(strategy=strategy, use_cache=not args.no_cache,
                       use_interleave=not args.no_interleave, overlap=args.overlap,
                       use_fused_kernels=args.fused_kernels,
                       grad_compress=args.grad_compress,
                       lr_emb=args.lr_emb, lr_dense=args.lr_dense)
    step_fn = make_train_step(model, plan, args.global_batch, tcfg, device)
    state = init_state(model, plan, torch.Generator(device=device).manual_seed(args.seed),
                       device)
    print(f"[train] {cfg.name}: {len(plan.groups)} packed groups, "
          f"micro={plan.microbatch}, ilv={len(plan.interleave)} waves, world=1, "
          f"device={device}")

    stream = ReplayableStream(lambda start: Prefetcher(
        batch_stream(cfg, args.global_batch, seed=args.seed, learnable=args.learnable,
                     start=start), depth=2))
    try:
        for i in range(1, args.steps + 1):
            try:
                batch = next(stream)
            except StopIteration:  # the stream ended or stalled: finish
                break
            state, m = step_fn(state, batch)
            if i % args.log_every == 0:
                tiers = "".join(f" {k.split('/')[1]}={int(m[k])}" for k in
                                ("cache_hits/l1", "cache_hits/l2") if k in m)
                print(f"  step {i:5d} loss={float(m['loss']):.4f} "
                      f"hits={int(m['cache_hits'])} ovf={int(m['overflow'])}{tiers}",
                      flush=True)
    finally:
        stream.close()
    print("[train] done")


if __name__ == "__main__":
    main()
