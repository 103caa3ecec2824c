#!/usr/bin/env python3
"""Times the port's ``fp16_decompress`` and ``gather_project_grad`` on the
card at every path shape, at bulk and on edge inputs, beside their plain
versions and a PyTorch call; checks each against its plain version and
records digests of its outputs, so two versions can be held bit for bit
against each other.

    python3 scripts/torch_fp16dec_projgrad_bench.py [--src DIR] [--tag NAME]
        [--against TAG] [--max-fp16-ops N] [--max-grad-ops N] [--sweep]

``fp16_decompress`` on every training path's bucket rows compressed by the
plain ``fp16_compress`` (``chip_smoke.grad_rows``: deepfm m = 15,976, D =
10; dcn-v2 m = 10,652, D = 16; the narrow d = 4; DLRM's narrow d = 32), at
bulk (m = 4,089,448, D = 10), at m * D = 1-17 (D = 1, 2, 3 and one row),
with q a view 2, 4, 8 and 12 bytes off 16 and the output 4, 8 and 12 bytes
off 16 (the launcher called directly for those), and on edge payloads
(``chip_smoke.fp16_edge_payload``: half NaNs of several payloads and both
signs, +-inf, -0.0, float16 subnormals, zero rows); each held bitwise to
the plain version and to a repeat. ``torch.mul(q, s)`` is its PyTorch call.

``gather_project_grad`` on ``chip_smoke.project_case`` at the narrow deepfm
training and serving shapes (n = 9,984 and 19,968, d = 4, D = 10, not-kept
positions on slot m - 1), at DLRM's widths (d = 32, D = 128, n = 6,656 and
13,312) and at bulk (n = 2,555,904), and on
``chip_smoke.PROJECT_GRAD_EDGES``: n = 0, m = 1, every position on one slot
(a list far past what the kernel sorts in shared memory), runs of 32 and 33
and of 128 and 129 (one past the lists it sorts at one lane and at four
lanes a slot), slots outside [0, m) among kept positions, d = 1, d = 256
(D = 48), d * D = 12,288 (d = 96, D = 128), odd widths, DLRM's widths, and
g_wide 4 bytes off 16; each held to 1e-5 of scale of the plain version with
empty slots exactly +0.0, and to a bitwise repeat.

Times: ``chip_smoke.cuda_ms`` (CUDA events, device only, median of 30),
beside the bound; a one-element fill is timed the same way, as the floor of
such a timing. ``torch.profiler`` traces one call of each kernel at its
path shape, and of ``gather_project_grad`` at bulk (``--max-fp16-ops`` and
``--max-grad-ops`` fail the run if a call makes more device operations, or
a sort), and five full-width deepfm training steps under
``--grad-compress fp16`` (each port kernel's device us a step).
``--sweep`` also times, at the path shapes and at bulk, each kernel under
the other launch plans
(``fp16_decompress``: 32-512 threads a block by 1, 2 or 4 quads a thread or
512-2,048 threads an SM; ``gather_project_grad``: every lane count the
kernel takes, 32-256 threads, and scalar row loads), each output first held
bitwise to the plan's.

``--src DIR`` takes ``repro_torch`` from another checkout's ``src`` (an
earlier version of the kernels), so two versions can be timed in turns in
one call on one card; a version without the plans is timed at its own
launch. ``--against TAG`` then requires every digest both runs recorded to
be equal and the two runs to have recorded the same cases. Prints one JSON
line a measurement and writes them all to
``results/fp16dec_projgrad_bench_<tag>.json`` (git-ignored). It re-runs
itself under ``PYTHONHASHSEED=0``, as ``chip_smoke.py`` does. Needs one
CUDA card and about 25 GB of its memory (the traced deepfm state)."""
import argparse
import json
import os
import sys
from pathlib import Path

from torch_compress_bench import trace_compressed_steps
from torch_probe_segment_bench import digest, trace_call

ROOT = Path(__file__).resolve().parent.parent

# (label, arch whose bucket rows at its training batch, or None for bulk)
FP16_PATHS = [("deepfm-fp16 train", "deepfm-fp16"), ("dcn-v2 train", "dcn-v2"),
              ("narrow train", "deepfm-narrow"), ("dlrm-narrow train", "dlrm-narrow"),
              ("bulk", None)]
# (m, D) of the m * D = 1-17 edges: D = 1, 2, 3 and one row of each width
FP16_SMALL = sorted({(md // d, d) for md in range(1, 18) for d in (1, 2, 3, md)
                     if md % d == 0})
# (q offset bytes, out offset bytes) of the views
FP16_VIEWS = [(2, 0), (4, 0), (8, 0), (12, 0), (0, 4), (0, 8), (0, 12), (2, 12), (6, 4)]
# (label, arch, batch) of gather_project_grad's path shapes
GPG_PATHS = [("narrow train", "deepfm-narrow", "TRAIN_B"),
             ("narrow serve", "deepfm-narrow", "SERVE_B"),
             ("dlrm-narrow train", "dlrm-narrow", "TRAIN_B"),
             ("dlrm-narrow serve", "dlrm-narrow", "SERVE_B"),
             ("bulk", "deepfm-narrow", "BULK_B")]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this")
    ap.add_argument("--against", default=None)
    ap.add_argument("--max-fp16-ops", type=int, default=None)
    ap.add_argument("--max-grad-ops", type=int, default=None)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    # repro_torch from --src first: chip_smoke's own imports then find it
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.kernels import build, ops, ref
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    if not torch.cuda.is_available():
        sys.exit("torch_fp16dec_projgrad_bench: needs a CUDA card")
    stamp = cs.card_stamp()
    build.build_all()
    for name in ("fp16_decompress", "gather_project_grad"):  # registers of a fresh build
        print(f"[build] {name}: " + "; ".join(cs.ptxas_usage(build.BUILD_LOG.get(name, ""))),
              flush=True)
    planned = hasattr(ops, "fp16_decompress_plan")  # this version launches from plans
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    rows, digests, failed = [], {}, []

    def held(ok, what):  # every case runs; the run fails at its end
        if not ok:
            failed.append(what)
            print(f"FAILED: {what}", flush=True)

    def emit(row):
        row = {"tag": args.tag, "card": stamp, **row}
        rows.append(row)
        print(json.dumps(row), flush=True)

    one = torch.zeros((1,), device=cs.DEV)
    emit({"kernel": "floor", "shape": "one-element fill",
          "ms": cs.cuda_ms(lambda: one.fill_(1.0))})

    def max_ops(tr, limit, name):
        if limit is not None:
            held(tr["per_call"] <= limit and not tr["sort_ops"],
                 f"{name} makes {tr['per_call']} device operations a call, "
                 f"{tr['sort_ops']} of them sorts")

    # ---------------------------------------------------- fp16 decompress
    fp16 = dict(torch=torch, ops=ops, ref=ref, build=build, cs=cs, digests=digests,
                held=held, planned=planned)
    for label, arch in FP16_PATHS:
        a = cs.ARCHS[arch or "deepfm-fp16"]
        # deterministic: a tied row may draw one column twice with two signs
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            g = cs.grad_rows(cs.BULK_B if arch is None else cs.TRAIN_B, gen, a)
        finally:
            torch.use_deterministic_algorithms(False)
        q, s = ref.fp16_compress_ref(g)
        del g
        row = fp16_row(label, q, s, timed=True, sweep=args.sweep, **fp16)
        if label == "deepfm-fp16 train":
            row["device_ops"] = tr = trace_call(torch, cs, lambda: ops.decompress_fp16(q, s))
            max_ops(tr, args.max_fp16_ops, "fp16_decompress")
        emit(row)
        del q, s
    for m, d in FP16_SMALL:
        q, s = cs.fp16_edge_payload(gen, m, d)
        emit(fp16_row(f"m={m} D={d}", q, s, timed=m * d in (1, 17), sweep=False, **fp16))
    for m, d in ((15_976, 10), (10_652, 32), (1_001, 3)):
        q, s = cs.fp16_edge_payload(gen, m, d)
        emit(fp16_row(f"edge payloads m={m} D={d}", q, s, timed=d == 10, sweep=False, **fp16))
        for qoff, ooff in FP16_VIEWS:
            qv = cs.view_off_16(q, qoff) if qoff else q
            emit(fp16_row(f"edge payloads m={m} D={d} q off {qoff} out off {ooff}", qv, s,
                          timed=d == 10 and qoff in (2, 4) and ooff == 0, sweep=False,
                          out_off=ooff, **fp16))
    torch.cuda.empty_cache()

    # ------------------------------------------------ gather project grad
    grad = dict(torch=torch, ops=ops, ref=ref, build=build, cs=cs, digests=digests,
                held=held, planned=planned)
    for label, arch, batch in GPG_PATHS:
        case = cs.project_case(getattr(cs, batch), gen, cs.ARCHS[arch])
        back, idx, kept, proj, g_wide, g_narrow = case
        row = grad_row(label, g_wide, g_narrow, idx, kept, proj, back.shape[0], timed=True,
                       sweep=args.sweep, **grad)
        if label in ("narrow train", "bulk"):
            m = back.shape[0]
            row["device_ops"] = tr = trace_call(
                torch, cs, lambda: ops.gather_project_grad(g_wide, g_narrow, idx, kept, proj, m))
            max_ops(tr, args.max_grad_ops, "gather_project_grad")
        emit(row)
        del back, idx, kept, proj, g_wide, g_narrow, case
    for m, n, nd, d, layout, off in cs.PROJECT_GRAD_EDGES:
        g_wide, g_narrow, idx, kept, proj = cs.project_edge_case(gen, m, n, nd, d, layout, off)
        label = cs.project_edge_label(m, n, nd, d, layout, off)
        emit(grad_row(label, g_wide, g_narrow, idx, kept, proj, m,
                      timed=layout in ("one slot", "runs", "long runs", "outside") or off > 0,
                      sweep=False,
                      **grad))
    torch.cuda.empty_cache()

    emit({"kernel": "deepfm-fp16 train steps",
          **trace_compressed_steps(torch, cs, "deepfm-fp16")})

    out_dir = ROOT / "results"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"fp16dec_projgrad_bench_{args.tag}.json").write_text(
        json.dumps({"rows": rows, "digests": digests}, indent=1))
    if args.against:
        other = json.loads(
            (out_dir / f"fp16dec_projgrad_bench_{args.against}.json").read_text())
        common = [k for k in digests if k in other["digests"]]
        differ = [k for k in common if other["digests"][k] != digests[k]]
        emit({"against": args.against, "compared": len(common), "differ": differ,
              "only_here": [k for k in digests if k not in other["digests"]],
              "only_there": [k for k in other["digests"] if k not in digests]})
        held(not differ and len(common) == len(digests) == len(other["digests"]),
             f"outputs differ from {args.against}'s: {differ}")
    cs.check(not failed, "; ".join(failed))


def fp16_row(label, q, s, *, timed, sweep, torch, ops, ref, build, cs, digests, held,
             planned, out_off: int = 0) -> dict:
    """One ``fp16_decompress`` case: held bitwise to the plain version and
    to a repeat, its digest recorded; where ``timed``, timed beside the
    plain version and ``torch.mul``. ``out_off`` > 0 calls the launcher
    on an output view that many bytes off 16."""
    m, d = q.shape
    key = f"fp16_decompress {label}"
    if out_off:
        out = cs.view_off_16(torch.empty((m, d), device=cs.DEV), out_off)
        launch = build.launcher("fp16_decompress")
        plan = ops.fp16_decompress_plan(m, d, ops.sm_count(cs.DEV)) if planned else ()

        def call():
            rc = launch(q.data_ptr(), s.data_ptr(), out.data_ptr(), m * d, d, *plan,
                        torch.cuda.current_stream().cuda_stream)
            cs.check(rc == 0, f"{key}: cudaError {rc}")
            return out
    else:
        def call():
            return ops.decompress_fp16(q, s)
    got = call().clone()
    again = call()
    exp = ref.fp16_decompress_ref(q, s)
    torch.cuda.synchronize(cs.DEV)
    held(cs.same_bits(got, exp), f"{key} bitwise the plain version")
    held(cs.same_bits(got, again), f"{key} repeats")
    digests[key] = digest(got)
    row = {"kernel": "fp16_decompress", "shape": label, "m": m, "d": d,
           "q_offset_bytes": q.data_ptr() % 16, "out_offset_bytes": out_off,
           "digest": digests[key]}
    if planned:
        row["plan"] = ops.fp16_decompress_plan(m, d, ops.sm_count(cs.DEV))
    if timed:
        b_ms, b_by = cs.bound(m * d * (2 + 4) + m * 4, m * d)
        row.update({"ms": cs.cuda_ms(call),
                    "plain_ms": cs.cuda_ms(lambda: ref.fp16_decompress_ref(q, s)),
                    "library_ms": cs.cuda_ms(lambda: torch.mul(q, s)),
                    "bound_ms": b_ms, "bound_by": b_by})
    if sweep and planned:
        row["plan_ms"] = sweep_fp16(torch, ops, build, cs, q, s, got)
    return row


def sweep_fp16(torch, ops, build, cs, q, s, want) -> dict:
    """Device ms of the kernel alone at 32-512 threads a block by blocks
    for 1, 2 or 4 quads a thread, and capped at 512-2,048 threads an SM
    ("blocks/threads"), each output first held bitwise to the plan's."""
    m, d = q.shape
    sms = ops.sm_count(cs.DEV)
    quads = max(1, -(-m * d // 4))
    out = torch.empty_like(want)
    launch = build.launcher("fp16_decompress")
    plans = {ops.fp16_decompress_plan(m, d, sms)}
    for threads in (32, 64, 128, 256, 512):
        for rounds in (1, 2, 4):
            plans.add((-(-quads // (threads * rounds)), threads))
        for per_sm in (512, 1024, 2048):
            if per_sm >= threads:
                plans.add((min(-(-quads // threads), sms * (per_sm // threads)), threads))
    times = {}
    for blocks, threads in sorted(plans):
        def run(blocks=blocks, threads=threads):
            rc = launch(q.data_ptr(), s.data_ptr(), out.data_ptr(), m * d, d, blocks, threads,
                        torch.cuda.current_stream().cuda_stream)
            cs.check(rc == 0, f"fp16_decompress plan {blocks}/{threads}: cudaError {rc}")

        run()
        torch.cuda.synchronize(cs.DEV)
        cs.check(cs.same_bits(out, want), f"fp16_decompress plan {blocks}/{threads} bitwise")
        times[f"{blocks}/{threads}"] = cs.cuda_ms(run)
    return times


def grad_row(label, g_wide, g_narrow, idx, kept, proj, m, *, timed, sweep, torch, ops, ref,
             build, cs, digests, held, planned) -> dict:
    """One ``gather_project_grad`` case: held to 1e-5 of scale of the plain
    version with empty slots exactly +0.0, and to a bitwise repeat, its
    digest recorded; where ``timed``, timed beside the plain version."""
    n, (nd, d) = idx.shape[0], proj.shape
    key = f"gather_project_grad {label}"

    def call():
        return ops.gather_project_grad(g_wide, g_narrow, idx, kept, proj, m)

    got, again = call(), call()
    exp = ref.gather_project_grad_ref(g_wide, g_narrow, idx, kept, proj, m)
    torch.cuda.synchronize(cs.DEV)
    ok = kept & (idx >= 0) & (idx < m)
    touched = torch.zeros((m,), dtype=torch.bool, device=cs.DEV)
    touched[idx[ok].long()] = True
    err = cs.max_err(got, exp) / cs.scale_of(exp)
    held(err <= cs.TOL, f"{key} err {err} of scale")
    held(cs.same_bits(got[~touched], torch.zeros_like(got[~touched])),
         f"{key} empty slots exactly +0.0")
    held(cs.same_bits(got, again), f"{key} repeats")
    digests[key] = digest(got)
    runs = torch.bincount(idx[ok].long(), minlength=m) if m else torch.zeros(0)
    n_kept = int(ok.sum())
    row = {"kernel": "gather_project_grad", "shape": label, "n": n, "m": m, "narrow_d": nd,
           "d": d, "kept": n_kept, "longest_run": int(runs.max()) if runs.numel() else 0,
           "empty_slots": int((~touched).sum()), "g_wide_offset_bytes": g_wide.data_ptr() % 16,
           "err_of_scale": err, "digest": digests[key]}
    if planned:
        row["plan"] = ops.gather_project_grad_plan(m, nd, d, ops.sm_count(cs.DEV),
                                                   ops._alignment(g_wide))
    if timed:
        b_ms, b_by = cs.bound(n * (4 + 1) + n_kept * (d + nd) * 4 + nd * d * 4 + m * nd * 4,
                              n_kept * nd * (2 * d + 2))
        row.update({"ms": cs.cuda_ms(call),
                    "plain_ms": cs.cuda_ms(lambda: ref.gather_project_grad_ref(
                        g_wide, g_narrow, idx, kept, proj, m)),
                    "bound_ms": b_ms, "bound_by": b_by})
    if sweep and planned:
        row["plan_ms"] = sweep_grad(torch, ops, build, cs, g_wide, g_narrow, idx, kept, proj,
                                    m, got)
    return row


def sweep_grad(torch, ops, build, cs, g_wide, g_narrow, idx, kept, proj, m, want) -> dict:
    """Device ms of the three operations alone at every lane count the
    kernel takes (1-32, at most 8 outputs a lane), by 32-256 threads, with
    the plan's row loads and scalar ones ("lanes/cw/threads"), each output
    first held bitwise to the plan's."""
    n, (nd, d) = idx.shape[0], proj.shape
    _, cw0, _ = ops.gather_project_grad_plan(m, nd, d, ops.sm_count(cs.DEV),
                                             ops._alignment(g_wide))
    out = torch.empty_like(want)
    scratch = torch.empty((m + n,), dtype=torch.int32, device=cs.DEV)
    launch = build.launcher("gather_project_grad")
    times = {}
    for lanes in (1, 2, 4, 8, 16, 32):
        for cw in sorted({cw0, 1}):
            for threads in (32, 64, 128, 256):
                if nd > 8 * lanes:
                    continue

                def run(lanes=lanes, cw=cw, threads=threads):
                    rc = launch(g_wide.data_ptr(), g_narrow.data_ptr(), proj.data_ptr(),
                                idx.data_ptr(), kept.data_ptr(), scratch.data_ptr(),
                                out.data_ptr(), n, m, nd, d, lanes, cw, threads,
                                torch.cuda.current_stream().cuda_stream)
                    cs.check(rc == 0, f"gather_project_grad {lanes}/{cw}/{threads}: "
                                      f"cudaError {rc}")

                run()
                torch.cuda.synchronize(cs.DEV)
                cs.check(cs.same_bits(out, want),
                         f"gather_project_grad {lanes}/{cw}/{threads} bitwise the plan's")
                times[f"{lanes}/{cw}/{threads}"] = cs.cuda_ms(run)
    return times

if __name__ == "__main__":
    # the packing salt hashes table names: a fixed seed makes the plans (and
    # so the cases' bucket capacities) alike in every run
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    main()
