#!/usr/bin/env python3
"""Times the port's ``fm_interaction_bwd`` and ``topk_decompress`` on the
card at every path shape, at bulk and on edge shapes, beside their plain
versions and the PyTorch calls that compute the same functions; checks each
against its plain version and records digests of its outputs, so two
versions can be held bit for bit against each other.

    python3 scripts/torch_fmbwd_topk_bench.py [--src DIR] [--tag NAME]
        [--against TAG] [--max-ops N] [--sweep]

Shapes: ``fm_interaction_bwd`` at deepfm's training batch (B = 256, F = 39,
D = 10; every deepfm path trains at it), at B = 512, at bulk (B = 65,536)
and on the edges B = 1, 37 and 65,537, F = D = 1, D = 3, 33 and 129, an
80,000-byte sample (past the staged plan) and ``fields`` a view 4 bytes off
a 16-byte boundary, each timed beside the autograd of
``chip_smoke.fm_chain``. ``topk_decompress`` at the training paths' bucket
rows (``chip_smoke.grad_rows``: deepfm m = 15,976, D = 10, k = 2; dcn-v2's
D = 16, k = 4; the narrow d = 4, k = 1), at bulk (m = 4,089,448) and on the
edges m = 1, 3 and 4,089,449, D = 1, k = D = 3, D = 129 with k = 8, D =
3,100 (a tile of four rows past 48 KB), columns -1, D and 2^31 - 1, a
column repeated in a row (the later entry wins), NaN and -0.0 values, and
``vals``/``idx`` views 4 and 8 bytes off 16, each timed beside ``zeros``
then ``scatter_``. Each result is first held to its plain version
(``fm_interaction_bwd`` within 1e-5 of scale; ``topk_decompress`` bitwise
the plain version run on the host, whose scatter sets in order, so the
later of two entries wins) and to a bitwise repeat, then timed with
``chip_smoke.cuda_ms`` (CUDA events, device only, median of 30). A
one-element fill is timed the same way, as the floor of such a timing.

At deepfm's training shape ``fm_interaction_bwd`` is also timed with the
fields cold (a 256 MB write before each call evicts the 50 MB L2) and right
after the forward ``fm_interaction`` read them, and five full-width deepfm
training steps are traced (``torch_probe_segment_bench.trace_steps``: the
device us a step of each of the port's kernels), so the kernel's time in a
step can be set beside its time alone. ``torch.profiler`` traces one call
of each kernel at its path shape (``--max-ops N`` fails the run if a call
makes more than N device operations). ``--sweep`` also times, at the path
shapes and at bulk, each kernel under the other launch plans it takes
(samples a block and threads; rows a tile and threads), each output first
held bitwise to the plan's.

``--src DIR`` takes ``repro_torch`` from another checkout's ``src`` (an
earlier version of the kernels), so two versions can be timed in turns in
one call on one card. ``--against TAG`` then requires every digest both runs
recorded to be equal. Prints one JSON line a measurement and writes them
all to ``results/fmbwd_topk_bench_<tag>.json`` (git-ignored). It re-runs
itself under ``PYTHONHASHSEED=0``, as ``chip_smoke.py`` does. Needs one
CUDA card and about 25 GB of its memory (the traced deepfm state).
"""
import argparse
import json
import os
import sys
from pathlib import Path

from torch_probe_segment_bench import digest, trace_call, trace_steps

ROOT = Path(__file__).resolve().parent.parent

# (label, B, F, D, offset floats of fields): the paths' batches, bulk, edges
FMB_SHAPES = [("deepfm train", 256, 39, 10, 0), ("B=512", 512, 39, 10, 0),
              ("bulk", 65_536, 39, 10, 0), ("B=1", 1, 39, 10, 0), ("B=37", 37, 39, 10, 0),
              ("B=65537", 65_537, 39, 10, 0), ("F=1 D=1", 512, 1, 1, 0),
              ("D=3", 333, 7, 3, 0), ("D=33", 512, 39, 33, 0), ("D=129", 512, 39, 129, 0),
              ("unstaged", 64, 100, 200, 0), ("fields off 16 bytes", 256, 39, 10, 1)]
# (label, m, D, k, edge entries, offset floats of vals, of idx): the edges
TD_EDGES = [("m=1", 1, 10, 2, False, 0, 0), ("m=3 D=129", 3, 129, 8, False, 0, 0),
            ("m=4089449", 4_089_449, 10, 2, False, 0, 0), ("D=1", 100_000, 1, 1, False, 0, 0),
            ("k=D=3", 10_000, 3, 3, False, 0, 0), ("D=129 k=8", 10_000, 129, 8, False, 0, 0),
            ("D=3100", 1_000, 3_100, 8, False, 0, 0),
            ("edge entries D=10", 50_000, 10, 2, True, 0, 0),
            ("edge entries D=16", 50_000, 16, 4, True, 0, 0),
            ("views off 16 bytes", 15_976, 10, 2, True, 1, 2)]
COLD_BYTES = 256 << 20  # written before each cold call: five times the L2


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
        sys.exit("torch_fmbwd_topk_bench: needs a CUDA card")
    stamp = cs.card_stamp()
    build.build_all()
    planned = hasattr(ops, "fm_bwd_plan")  # this version launches from the plans
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

    def ops_check(row, name, call):
        row["device_ops"] = trace = trace_call(torch, cs, call)
        if args.max_ops is not None:
            held(trace["per_call"] <= args.max_ops,
                 f"{name} makes {trace['per_call']} device operations a call")

    one = torch.zeros((1,), device=cs.DEV)
    emit({"kernel": "floor", "shape": "one-element fill",
          "ms": cs.cuda_ms(lambda: one.fill_(1.0))})

    # ------------------------------------------------ fm interaction bwd
    for label, b, f, d, off in FMB_SHAPES:
        x = (torch.randn((b * f * d + off,), device=cs.DEV, generator=gen) * 0.3)[off:]
        x = x.view(b, f, d)
        g = torch.randn((b, 1), device=cs.DEV, generator=gen)
        call = lambda: ops.fm_interaction_bwd(x, g)  # noqa: E731
        got, again = call(), call()
        exp = ref.fm_interaction_bwd_ref(x, g)
        torch.cuda.synchronize(cs.DEV)
        key = f"fm_interaction_bwd {label}"
        err = cs.max_err(got, exp) / cs.scale_of(exp)
        held(err <= cs.TOL, f"{key} err {err}")
        held(cs.same_bits(got, again), f"{key} repeats")
        digests[key] = digest(got)
        leaf = x.detach().clone().requires_grad_(True)
        chain_out = cs.fm_chain(leaf)

        def lib():  # the chain's autograd
            return torch.autograd.grad(chain_out, leaf, g, retain_graph=True)[0]

        b_ms, b_by = cs.bound(2 * x.numel() * 4 + b * 4, 3 * x.numel())
        row = {"kernel": "fm_interaction_bwd", "shape": label, "b": b, "f": f, "d": d,
               "fields_offset_bytes": x.data_ptr() % 16, "err_of_scale": err,
               "digest": digests[key], "ms": cs.cuda_ms(call),
               "plain_ms": cs.cuda_ms(lambda: ref.fm_interaction_bwd_ref(x, g)),
               "library_ms": cs.cuda_ms(lib), "bound_ms": b_ms, "bound_by": b_by}
        if planned:
            row["plan"] = ops.fm_bwd_plan(b, f, d, sms)
            if args.sweep and label in ("deepfm train", "B=512", "bulk", "B=1", "B=37",
                                        "F=1 D=1", "D=3", "D=33"):
                row["plan_ms"] = sweep_fm_bwd(torch, ops, build, cs, x, g, got)
        if label == "deepfm train":
            ops_check(row, "fm_interaction_bwd", call)
            cold = torch.empty((COLD_BYTES // 4,), device=cs.DEV)
            row["cold_ms"] = cold_ms(torch, cs, call, lambda: cold.fill_(1.0))
            row["after_forward_ms"] = cold_ms(torch, cs, call, lambda: ops.fm_interaction(x))
            del cold
        emit(row)
        del x, g, got, again, exp, leaf, chain_out
    torch.cuda.empty_cache()

    # ---------------------------------------------------- topk decompress
    cases = [("deepfm-topk train", "deepfm-topk", cs.TRAIN_B),
             ("dcn-v2 train", "dcn-v2", cs.TRAIN_B),
             ("narrow train", "deepfm-narrow", cs.TRAIN_B), ("bulk", "deepfm-topk", cs.BULK_B)]
    for label, arch, b in cases:
        # deterministic: a tied row may draw one column twice with two signs
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            grads = cs.grad_rows(b, gen, cs.ARCHS[arch])
        finally:
            torch.use_deterministic_algorithms(False)
        vals, idx = ref.topk_compress_ref(grads, cs.gcomp.topk_k(grads.shape[1]))
        del grads
        emit(topk_row(torch, ops, ref, build, cs, digests, held, label, vals, idx,
                      cs.ARCHS[arch].master_dim, sms, args.sweep,
                      ops_check if label == "deepfm-topk train" else None))
        del vals, idx
    for label, m, d, k, edge, voff, ioff in TD_EDGES:
        vals, idx = topk_edge_case(torch, cs, gen, m, d, k, edge, voff, ioff)
        emit(topk_row(torch, ops, ref, build, cs, digests, held, label, vals, idx, d,
                      sms, False, None))
        del vals, idx
    torch.cuda.empty_cache()

    # five full-width deepfm training steps: the kernels' device us a step
    emit({"kernel": "deepfm train steps", **trace_steps(torch, cs)})

    out_dir = ROOT / "results"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"fmbwd_topk_bench_{args.tag}.json").write_text(
        json.dumps({"rows": rows, "digests": digests}, indent=1))
    if args.against:
        other = json.loads((out_dir / f"fmbwd_topk_bench_{args.against}.json").read_text())
        common = [k for k in digests if k in other["digests"]]
        differ = [k for k in common if other["digests"][k] != digests[k]]
        emit({"against": args.against, "compared": len(common), "differ": differ,
              "only_here": [k for k in digests if k not in other["digests"]],
              "only_there": [k for k in other["digests"] if k not in digests]})
        held(not differ and len(common) == len(digests) == len(other["digests"]),
             f"outputs differ from {args.against}'s: {differ}")
    cs.check(not failed, "; ".join(failed))


def cold_ms(torch, cs, fn, before, iters: int = 30) -> float:
    """Median device ms of ``fn`` with ``before`` run ahead of each start
    event (outside the timing), after the usual device spin."""
    for _ in range(3):
        before()
        fn()
    torch.cuda.synchronize(cs.DEV)
    events = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        before()
        torch.cuda._sleep(cs.SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize(cs.DEV)
    return float(sorted(s.elapsed_time(e) for s, e in events)[iters // 2])


def topk_edge_case(torch, cs, gen, m, d, k, edge, voff, ioff):
    """``m`` compressed rows of ``k`` distinct-or-not columns in [0, D) and
    normal values; with ``edge``, an eighth of the rows take a column -1,
    D or 2^31 - 1, an eighth repeat their first column, an eighth a NaN and
    an eighth a -0.0. ``vals`` and ``idx`` start ``voff`` and ``ioff``
    floats into their buffers (a view off 16 bytes)."""
    vals = torch.randn((m * k + voff,), device=cs.DEV, generator=gen)[voff:].view(m, k)
    idx = torch.randint(0, d, (m * k + ioff,), device=cs.DEV, generator=gen,
                        dtype=torch.int32)[ioff:].view(m, k)
    if edge:
        kind = torch.randint(0, 8, (m,), device=cs.DEV, generator=gen)
        bad = torch.tensor([-1, d, 2 ** 31 - 1], device=cs.DEV, dtype=torch.int32)
        pick = torch.randint(0, 3, (m,), device=cs.DEV, generator=gen)
        idx[:, 0] = torch.where(kind == 0, bad[pick], idx[:, 0])
        if k > 1:
            idx[:, 1] = torch.where(kind == 1, idx[:, 0], idx[:, 1])
        vals[:, 0] = torch.where(kind == 2, torch.full_like(vals[:, 0], float("nan")),
                                 vals[:, 0])
        vals[:, k - 1] = torch.where(kind == 3, torch.full_like(vals[:, 0], -0.0),
                                     vals[:, k - 1])
    return vals, idx


def topk_row(torch, ops, ref, build, cs, digests, held, label, vals, idx, d, sms, sweep,
             ops_check) -> dict:
    """One ``topk_decompress`` case: held bitwise to the plain version run
    on the host and to a repeat, its digest recorded, timed beside the
    plain version and ``zeros`` then ``scatter_`` on the card."""
    m, k = vals.shape
    key = f"topk_decompress {label}"
    call = lambda: ops.decompress_topk(vals, idx, d)  # noqa: E731
    got, again = call(), call()
    exp = ref.topk_decompress_ref(vals.cpu(), idx.cpu(), d)
    torch.cuda.synchronize(cs.DEV)
    held(cs.same_bits(got.cpu(), exp), f"{key} bitwise the plain version")
    held(cs.same_bits(got, again), f"{key} repeats")
    digests[key] = digest(got)
    kept = int(((idx >= 0) & (idx < d)).sum())
    col = torch.where((idx >= 0) & (idx < d), idx, d).long()

    def lib():  # zeros, then scatter: two calls, timed together
        return torch.zeros((m, d + 1), device=cs.DEV).scatter_(1, col, vals)

    b_ms, b_by = cs.bound(m * k * 8 + m * d * 4, m * k)
    row = {"kernel": "topk_decompress", "shape": label, "m": m, "d": d, "k": k,
           "kept": kept, "vals_offset_bytes": vals.data_ptr() % 16,
           "idx_offset_bytes": idx.data_ptr() % 16,
           "digest": digests[key], "ms": cs.cuda_ms(call),
           "plain_ms": cs.cuda_ms(lambda: ref.topk_decompress_ref(vals, idx, d)),
           "library_ms": cs.cuda_ms(lib), "bound_ms": b_ms, "bound_by": b_by}
    if sms is not None:
        row["plan"] = ops.topk_decompress_plan(m, d, sms)
        if sweep:
            row["plan_ms"] = sweep_topk(torch, ops, build, cs, vals, idx, d, got)
    if ops_check is not None:
        ops_check(row, "topk_decompress", call)
    return row


def sweep_fm_bwd(torch, ops, build, cs, x, g, want) -> dict:
    """Device ms of the backward kernel alone at other samples a block and
    threads than its plan's, staged and direct (a thread a column), each
    output first held bitwise to the plan's. Keys are
    ``spb/threads/staged``."""
    b, f, d = x.shape
    out = torch.empty_like(want)
    launch = build.launcher("fm_interaction_bwd")
    plans = [(spb, threads, 1) for spb in (1, 2, 3, 4, 6, 8, 10, 16, 32, 64)
             for threads in (32, 64, 96, 128, 160, 256, 512)
             if 4 * (spb * (f * d + d + 1) + 3) <= ops.FM_SMEM_BYTES and spb <= min(b, threads)]
    plans += [(spb, threads, 0) for spb in (1, 2, 4, 8, 16, 32, 64)
              for threads in (32, 64, 128, 256) if spb <= b]
    times = {}
    for spb, threads, staged in plans:
        def run(spb=spb, threads=threads, staged=staged):
            rc = launch(x.data_ptr(), g.data_ptr(), out.data_ptr(), b, f, d, spb, threads,
                        staged, torch.cuda.current_stream().cuda_stream)
            cs.check(rc == 0, f"fm_interaction_bwd plan {spb}/{threads}/{staged}: "
                              f"cudaError {rc}")

        run()
        torch.cuda.synchronize(cs.DEV)
        cs.check(cs.same_bits(out, want),
                 f"fm_interaction_bwd plan {spb}/{threads}/{staged} bitwise")
        times[f"{spb}/{threads}/{staged}"] = cs.cuda_ms(run)
    return times


def sweep_topk(torch, ops, build, cs, vals, idx, d, want) -> dict:
    """Device ms of the decompression kernel alone at each tile of 4-512
    rows that fits 48 KB and each thread count, each output first held
    bitwise to the plan's. Keys are ``rows/threads``."""
    m, k = vals.shape
    out = torch.empty_like(want)
    launch = build.launcher("topk_decompress")
    times = {}
    for tile in (16, 32, 64, 128, 256, 512):
        if tile * d * 4 > ops.TD_SMEM_BYTES:
            continue
        for threads in (32, 64, 128, 256, 512):
            def run(tile=tile, threads=threads):
                rc = launch(vals.data_ptr(), idx.data_ptr(), out.data_ptr(), m, d, k, tile,
                            threads, torch.cuda.current_stream().cuda_stream)
                cs.check(rc == 0, f"topk_decompress plan {tile}/{threads}: cudaError {rc}")

            run()
            torch.cuda.synchronize(cs.DEV)
            cs.check(cs.same_bits(out, want), f"topk_decompress plan {tile}/{threads} bitwise")
            times[f"{tile}/{threads}"] = cs.cuda_ms(run)
    return times


if __name__ == "__main__":
    # the packing salt hashes table names: a fixed seed makes the plans (and
    # so the cases' bucket capacities) alike in every run
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    main()
