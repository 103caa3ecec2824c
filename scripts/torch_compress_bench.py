#!/usr/bin/env python3
"""Times the port's ``fp16_compress`` and ``topk_compress`` on the card at
every training path's shape, at bulk and on edge shapes, beside their plain
versions and the PyTorch calls that compute the same functions; checks each
against its plain version and records digests of its outputs, so two
versions can be held bit for bit against each other.

    python3 scripts/torch_compress_bench.py [--src DIR] [--tag NAME]
        [--against TAG] [--max-ops N] [--sweep]

Shapes: every training path's bucket rows (``chip_smoke.grad_rows``:
deepfm m = 15,976, D = 10, k = 2; dcn-v2 m = 10,652, D = 16, k = 4; the
narrow d = 4, k = 1; DLRM's narrow d = 32, k = 8), bulk (m = 4,089,448,
D = 10), the edges m = 1, 3, 7, 9 and 4,089,449, D = 1, 3, 6, 8, 9, 12, 129
and 1,600 (past the staged tiles of both kernels), k = D (3, 8 and 10), and ``g`` a
view 4, 8 and 12 bytes off 16; then edge rows at D = 10 and 16: all-zero
rows, rows tied at their maximum with mixed signs, NaN rows (two NaNs of
different payloads in one row among them), +-inf, -0.0 and ratios that
round to float16 subnormals. Each result is first held bitwise to its plain
version and to a repeat, its digest recorded, then timed with
``chip_smoke.cuda_ms`` (CUDA events, device only, median of 30) beside the
plain version and the PyTorch calls ``chip_smoke.py`` times (``amax``,
``clamp_min``, division, ``half``; ``topk`` of ``|g|`` then ``gather``). A
one-element fill is timed the same way, as the floor of such a timing.

``torch.profiler`` traces one call of each kernel at deepfm's shape
(``--max-ops N`` fails the run if a call makes more than N device
operations) and five full-width deepfm training steps under
``--grad-compress fp16`` and ``topk`` each (the device us a step of each of
the port's kernels). ``--sweep`` also times, at the path shapes, at bulk
and at m = 1, D = 1, 3, 6, 8, 9, 12 and 129, each kernel under the other
launch plans it takes (staged tiles of 8-512 rows by 32-512 threads, and
direct blocks of 64-256 rows), each output first held bitwise to the
plan's; the plans' constants and their choice between staging and direct
reads come from it.

``--src DIR`` takes ``repro_torch`` from another checkout's ``src`` (an
earlier version of the kernels), so two versions can be timed in turns in
one call on one card. ``--against TAG`` then requires every digest both runs
recorded to be equal, and the two runs to have recorded the same cases.
Prints one JSON line a measurement and writes them all to
``results/compress_bench_<tag>.json`` (git-ignored). It re-runs itself under
``PYTHONHASHSEED=0``, as ``chip_smoke.py`` does. Needs one CUDA card and
about 25 GB of its memory (the traced deepfm state).
"""
import argparse
import json
import os
import sys
from pathlib import Path

from torch_probe_segment_bench import device_events, digest, trace_call

ROOT = Path(__file__).resolve().parent.parent

# (label, arch whose bucket rows at its training batch, or None for bulk)
PATH_CASES = [("deepfm train", "deepfm-topk"), ("dcn-v2 train", "dcn-v2"),
              ("narrow train", "deepfm-narrow"), ("dlrm-narrow train", "dlrm-narrow"),
              ("bulk", None)]
# (label, m, D, k (0: topk_k(D)), offset floats of g): edge shapes of
# ordinary rows
EDGE_SHAPES = [("m=1", 1, 10, 0, 0), ("m=3", 3, 10, 0, 0), ("m=7", 7, 10, 0, 0),
               ("m=9", 9, 10, 0, 0), ("m=4089449", 4_089_449, 10, 0, 0),
               ("D=1", 100_000, 1, 0, 0), ("D=3", 100_000, 3, 0, 0),
               ("D=6", 15_976, 6, 0, 0), ("D=8", 15_976, 8, 0, 0), ("D=9", 15_976, 9, 0, 0),
               ("D=12", 15_976, 12, 0, 0),
               ("D=129", 20_000, 129, 0, 0), ("D=1600 direct", 1_000, 1_600, 0, 0),
               ("k=D=3", 10_000, 3, 3, 0), ("k=D=8", 10_000, 8, 8, 0),
               ("k=D=10", 10_000, 10, 10, 0), ("g off 4 bytes", 15_976, 10, 0, 1),
               ("g off 8 bytes", 15_976, 10, 0, 2), ("g off 12 bytes", 15_976, 10, 0, 3)]
# the edge shapes --sweep times under every plan: the widths around the
# plans' choice between staging and direct reads
SWEPT_EDGES = ("m=1", "D=1", "D=3", "D=6", "D=8", "D=9", "D=12", "D=129")
# (label, m, D): edge rows
EDGE_ROWS = [("edge rows D=10", 50_000, 10), ("edge rows D=16", 50_000, 16),
             ("edge rows D=10 off 4 bytes", 50_000, 10)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this")
    ap.add_argument("--against", default=None)
    ap.add_argument("--max-ops", type=int, default=None)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    # repro_torch from --src first: chip_smoke's own imports then find it
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.kernels import build, ops, ref
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    if not torch.cuda.is_available():
        sys.exit("torch_compress_bench: needs a CUDA card")
    stamp = cs.card_stamp()
    build.build_all()
    planned = hasattr(ops, "fp16_compress_plan")  # this version launches from plans
    sms = ops.sm_count(cs.DEV) if planned else None
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    rows, digests, failed = [], {}, []

    def held(ok, what):  # every shape runs; the run fails at its end
        if not ok:
            failed.append(what)
            print(f"FAILED: {what}", flush=True)

    def emit(row):
        row = {"tag": args.tag, "card": stamp, **row}
        rows.append(row)
        print(json.dumps(row), flush=True)

    def case(label, g, k, sweep=False, trace=False):
        """Both kernels on ``g``: held, digested, timed."""
        for row in (fp16_row(torch, ops, ref, build, cs, digests, held, label, g, sms,
                             sweep),
                    topk_row(torch, ops, ref, build, cs, digests, held, label, g, k, sms,
                             sweep)):
            if trace:
                name = row["kernel"]
                call = ((lambda: ops.compress_fp16(g)) if name == "fp16_compress"
                        else (lambda: ops.compress_topk(g, k)))
                row["device_ops"] = tr = trace_call(torch, cs, call)
                if args.max_ops is not None:
                    held(tr["per_call"] <= args.max_ops,
                         f"{name} makes {tr['per_call']} device operations a call")
            emit(row)

    one = torch.zeros((1,), device=cs.DEV)
    emit({"kernel": "floor", "shape": "one-element fill",
          "ms": cs.cuda_ms(lambda: one.fill_(1.0))})

    for label, arch in PATH_CASES:
        a = cs.ARCHS[arch or "deepfm-topk"]
        # deterministic: a tied row may draw one column twice with two signs
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            g = cs.grad_rows(cs.BULK_B if arch is None else cs.TRAIN_B, gen, a)
        finally:
            torch.use_deterministic_algorithms(False)
        case(label, g, cs.gcomp.topk_k(g.shape[1]), sweep=args.sweep,
             trace=label == "deepfm train")
        del g
    for label, m, d, k, off in EDGE_SHAPES:
        buf = torch.randn((m * d + off,), device=cs.DEV, generator=gen)
        case(label, buf[off:].view(m, d), k or cs.gcomp.topk_k(d),
             sweep=args.sweep and label in SWEPT_EDGES)
        del buf
    for label, m, d in EDGE_ROWS:
        off = 1 if "off" in label else 0
        g = edge_rows(torch, cs, gen, m, d, off)
        case(label, g, cs.gcomp.topk_k(d))
        del g
    torch.cuda.empty_cache()

    # five full-width deepfm training steps under each compression mode
    for arch in cs.COMPRESSED:
        emit({"kernel": f"{arch} train steps", **trace_compressed_steps(torch, cs, arch)})

    out_dir = ROOT / "results"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"compress_bench_{args.tag}.json").write_text(
        json.dumps({"rows": rows, "digests": digests}, indent=1))
    if args.against:
        other = json.loads((out_dir / f"compress_bench_{args.against}.json").read_text())
        common = [k for k in digests if k in other["digests"]]
        differ = [k for k in common if other["digests"][k] != digests[k]]
        emit({"against": args.against, "compared": len(common), "differ": differ,
              "only_here": [k for k in digests if k not in other["digests"]],
              "only_there": [k for k in other["digests"] if k not in digests]})
        held(not differ and len(common) == len(digests) == len(other["digests"]),
             f"outputs differ from {args.against}'s: {differ}")
    cs.check(not failed, "; ".join(failed))


def edge_rows(torch, cs, gen, m, d, off):
    """``m`` rows of width ``d`` (a view ``off`` floats into its buffer):
    of every 16 rows, 6 all zero, one tied at its maximum in up to three
    columns with mixed signs, one all one magnitude with mixed signs, one
    of entries down to 1e-8 of the row max at row scales 1e-6 to 1e3
    (float16 subnormals once scaled), one with a NaN and one with two NaNs
    of different payloads, one with +inf and -inf, one with -0.0 entries,
    one all -0.0, the rest normal."""
    buf = torch.randn((m * d + off,), device=cs.DEV, generator=gen)
    g = buf[off:].view(m, d)
    kind = torch.arange(m, device=cs.DEV) % 16
    rnd = lambda *shape: torch.rand(shape, device=cs.DEV, generator=gen)  # noqa: E731
    col = lambda: torch.randint(0, d, (m,), device=cs.DEV, generator=gen)  # noqa: E731
    rows = torch.arange(m, device=cs.DEV)
    sign = torch.where(rnd(m, d) < 0.5, -1.0, 1.0)
    top = g.abs().amax(1, keepdim=True)
    tied = torch.where(rnd(m, d) < 3.0 / d, top * sign, g)
    tied[rows, col()] = top[:, 0]
    g.copy_(torch.where((kind == 6)[:, None], tied, g))
    g.copy_(torch.where((kind == 7)[:, None], 1.5 * sign, g))
    tiny = g * 10.0 ** (-8.0 * rnd(m, d)) * 10.0 ** (9.0 * rnd(m, 1) - 6.0)
    g.copy_(torch.where((kind == 8)[:, None], tiny, g))
    bits = g.view(torch.int32)
    c1, c2 = col(), col()
    nan1 = torch.tensor(0x7FC00001, dtype=torch.int32, device=cs.DEV)
    nan2 = torch.tensor(0xFFC12345 - (1 << 32), dtype=torch.int32, device=cs.DEV)
    for k, cols, val in ((9, c1, nan1), (10, c1, nan1), (10, c2, nan2)):
        at = rows[kind == k]
        bits[at, cols[at]] = val
    at = rows[kind == 11]
    g[at, c1[at]] = float("inf")
    g[at, c2[at]] = -float("inf")  # where c2 is c1, the row holds only -inf
    at = rows[kind == 12]
    g[at, c1[at]] = -0.0
    g[at, c2[at]] = -0.0
    g[kind == 13] = -0.0
    g[kind < 6] = 0.0
    return g


def fp16_row(torch, ops, ref, build, cs, digests, held, label, g, sms, sweep) -> dict:
    """One ``fp16_compress`` case: held bitwise to the plain version and to
    a repeat, its digest recorded, timed beside the plain version and the
    ``amax`` chain."""
    m, d = g.shape
    key = f"fp16_compress {label}"
    call = lambda: ops.compress_fp16(g)  # noqa: E731
    got, again = call(), call()
    exp = ref.fp16_compress_ref(g)
    torch.cuda.synchronize(cs.DEV)
    held(cs.same_bits(got[0], exp[0]) and cs.same_bits(got[1], exp[1]),
         f"{key} bitwise the plain version")
    held(cs.same_bits(got[0], again[0]) and cs.same_bits(got[1], again[1]), f"{key} repeats")
    digests[key] = digest(*got)

    def lib():  # amax, clamp_min, div, half: four calls, timed together
        return (g / g.abs().amax(1, keepdim=True).clamp_min(1e-30)).half()

    b_ms, b_by = cs.bound(m * d * (4 + 2) + m * 4, 3 * m * d)
    row = {"kernel": "fp16_compress", "shape": label, "m": m, "d": d,
           "g_offset_bytes": g.data_ptr() % 16, "digest": digests[key],
           "ms": cs.cuda_ms(call), "plain_ms": cs.cuda_ms(lambda: ref.fp16_compress_ref(g)),
           "library_ms": cs.cuda_ms(lib), "bound_ms": b_ms, "bound_by": b_by}
    if sms is not None:
        row["plan"] = ops.fp16_compress_plan(m, d, sms)
        if sweep:
            row["plan_ms"] = sweep_plans(torch, ops, build, cs, "fp16_compress", g, 0, got)
    return row


def topk_row(torch, ops, ref, build, cs, digests, held, label, g, k, sms, sweep) -> dict:
    """One ``topk_compress`` case: held bitwise to the plain version and to
    a repeat, its digest recorded, timed beside the plain version and
    ``topk`` then ``gather``."""
    m, d = g.shape
    key = f"topk_compress {label}"
    call = lambda: ops.compress_topk(g, k)  # noqa: E731
    got, again = call(), call()
    exp = ref.topk_compress_ref(g, k)
    torch.cuda.synchronize(cs.DEV)
    held(cs.same_bits(got[0], exp[0]) and cs.same_bits(got[1], exp[1]),
         f"{key} bitwise the plain version")
    held(cs.same_bits(got[0], again[0]) and cs.same_bits(got[1], again[1]), f"{key} repeats")
    digests[key] = digest(*got)
    mag = g.abs()

    def lib():  # topk then gather: two calls, timed together (ties in any order)
        return torch.gather(g, 1, torch.topk(mag, k, dim=1).indices)

    b_ms, b_by = cs.bound(m * d * 4 + m * k * 8, m * k * d)
    row = {"kernel": "topk_compress", "shape": label, "m": m, "d": d, "k": k,
           "g_offset_bytes": g.data_ptr() % 16, "digest": digests[key],
           "ms": cs.cuda_ms(call), "plain_ms": cs.cuda_ms(lambda: ref.topk_compress_ref(g, k)),
           "library_ms": cs.cuda_ms(lib), "bound_ms": b_ms, "bound_by": b_by}
    if sms is not None:
        row["plan"] = ops.topk_compress_plan(m, d, k, sms)
        if sweep:
            row["plan_ms"] = sweep_plans(torch, ops, build, cs, "topk_compress", g, k, got)
    return row


def sweep_plans(torch, ops, build, cs, name, g, k, want) -> dict:
    """Device ms of the kernel alone at its plan and at each staged tile of
    8-512 rows that fits its shared memory, by 32-512 threads, and direct,
    each output first held bitwise to the plan's. Keys are
    ``rows/threads/staged``."""
    m, d = g.shape
    outs = [torch.empty_like(t) for t in want]
    launch = build.launcher(name)
    row_bytes = 4 * d + (4 if k == 0 else 8 * k)
    plan = (ops.fp16_compress_plan(m, d, ops.sm_count(cs.DEV)) if k == 0
            else ops.topk_compress_plan(m, d, k, ops.sm_count(cs.DEV)))
    plans = [plan] + [(rows, threads, 1) for rows in (8, 16, 32, 64, 96, 120, 128, 256, 512)
                      for threads in (32, 64, 128, 256, 512)
                      if rows * row_bytes + 12 <= ops.ROW_SMEM_BYTES and rows <= max(8, 2 * m)]
    plans += [(threads, threads, 0) for threads in (64, 128, 256)]
    times = {}
    for rows, threads, staged in plans:
        def run(rows=rows, threads=threads, staged=staged):
            extra = (m, d) if k == 0 else (m, d, k)
            rc = launch(g.data_ptr(), *(t.data_ptr() for t in outs), *extra, rows, threads,
                        staged, torch.cuda.current_stream().cuda_stream)
            cs.check(rc == 0, f"{name} plan {rows}/{threads}/{staged}: cudaError {rc}")

        run()
        torch.cuda.synchronize(cs.DEV)
        cs.check(all(cs.same_bits(o, w) for o, w in zip(outs, want)),
                 f"{name} plan {rows}/{threads}/{staged} bitwise")
        times[f"{rows}/{threads}/{staged}"] = cs.cuda_ms(run)
    return times


def trace_compressed_steps(torch, cs, arch: str, steps: int = 5) -> dict:
    """Full-width deepfm training under the arch's ``--grad-compress`` on
    the train launcher's plan: steps 1-5 untraced, 6-10 traced (no flush
    among them): device operations and ms a step, and the device us a step
    of each of the port's kernels."""
    a = cs.ARCHS[arch]
    cfg, plan = cs.arch_plan(a, cs.TRAIN_B, train=True)
    model = cs.WDLModel(cfg, plan)
    state = cs.ts.init_state(model, plan, torch.Generator(device=cs.DEV).manual_seed(cs.SEED),
                             cs.DEV)
    step = cs.ts.make_train_step(model, plan, cs.TRAIN_B,
                                 cs.ts.TrainConfig(strategy=a.strategy,
                                                   grad_compress=a.grad_compress), cs.DEV)
    stream = cs.batch_stream(cfg, cs.TRAIN_B, seed=cs.SEED)
    batches = [next(stream) for _ in range(2 * steps)]
    for b in batches[:steps]:
        state, _ = step(state, b)
    torch.cuda.synchronize(cs.DEV)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for b in batches[steps:]:
            state, _ = step(state, b)
        torch.cuda.synchronize(cs.DEV)
    dev = device_events(torch, prof)
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    out = {"steps": steps, "device_ops_per_step": len(dev) / steps,
           "device_ms_per_step": sum(e.time_range.elapsed_us() for e in dev) / steps / 1e3,
           "port_kernel_us_per_step": {k: v * 1e3 / steps
                                       for k, v in cs.port_kernels(by_name).items()}}
    del state, step
    torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    # the packing salt hashes table names: a fixed seed makes the plans (and
    # so the cases' bucket capacities) alike in every run
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    main()
