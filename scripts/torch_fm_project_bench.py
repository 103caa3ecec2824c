#!/usr/bin/env python3
"""Times the port's ``fm_interaction`` and ``gather_project`` on the card at
every path shape, at bulk and on edge shapes, beside their plain versions
and the PyTorch calls that compute the same functions; checks each against
its plain version and records digests of its outputs, so two versions can
be held bit for bit against each other.

    python3 scripts/torch_fm_project_bench.py [--src DIR] [--tag NAME]
        [--against TAG] [--max-ops N] [--sweep]

Shapes: ``fm_interaction`` at deepfm's serving and training batches (B =
512, 256; F = 39, D = 10), at bulk (B = 65,536) and on the edges B = 1,
37 and 65,537, F = 1, D = 1, 3, 33 and 129 and a 80,000-byte sample (read
unstaged), each timed beside ``chip_smoke.fm_chain`` (sum, square,
subtract, sum). ``gather_project`` at the narrow deepfm plan's serving and
training shapes (n = 19,968 and 9,984; d = 4, D = 10), at DLRM's (n =
13,312 and 6,656; d = 32, D = 128), at bulk (n = 2,555,904) and on edges
(n = 1; n = 1,001 at d = 3, D = 7, no multiple of a tile; DLRM's widths at
n = 333; D = 1; ``back`` a view 4 bytes off a 16-byte boundary; d = 96,
D = 8, which the first kernel's 48 KB refused), with ``chip_smoke``'s case
(60 % kept, an eighth of them sharing a slot, the rest at the drop slot)
or, on the edges, indices out of range on both sides; each timed beside
``F.embedding * kept`` then ``@ proj``. Each result is first held to its
plain version (1e-5 of scale; not-kept positions exactly 0) and to a
bitwise repeat, then timed with ``chip_smoke.cuda_ms`` (CUDA events,
device only, median of 30). A one-element fill is timed the same way, as
the floor of such a timing. ``torch.profiler`` traces one call of each
kernel at its serving shape (``--max-ops N`` fails the run if a call makes
more than N device operations). ``--sweep`` also times, at every path
shape and at bulk, each kernel under the other launch plans it takes
(samples a block and threads; positions a tile and positions a product
lane), each output first held bitwise to the plan's.

``--src DIR`` takes ``repro_torch`` from another checkout's ``src`` (an
earlier version of the kernels), so two versions can be timed in turns in
one call on one card. ``--against TAG`` then requires every digest both runs
recorded to be equal (bitwise the same outputs on the same inputs); a shape
the earlier version refuses is recorded as refused. Prints one JSON line a
measurement and writes them all to ``results/fm_project_bench_<tag>.json``
(git-ignored). It re-runs itself under ``PYTHONHASHSEED=0``, as
``chip_smoke.py`` does. Needs one CUDA card and about 2 GB of its memory.
"""
import argparse
import json
import os
import sys
from pathlib import Path

from torch_probe_segment_bench import digest, trace_call

ROOT = Path(__file__).resolve().parent.parent

# (label, B, F, D): the paths' batches, bulk, then the edges
FM_SHAPES = [("deepfm serve", 512, 39, 10), ("deepfm train", 256, 39, 10),
             ("bulk", 65_536, 39, 10), ("B=1", 1, 39, 10), ("B=37", 37, 39, 10),
             ("B=65537", 65_537, 39, 10), ("F=1 D=1", 512, 1, 1), ("D=3", 333, 7, 3),
             ("D=33", 512, 39, 33), ("D=129", 512, 39, 129), ("unstaged", 64, 100, 200)]
# (label, n, m, d, D, offset floats of back): the edges of gather_project
GP_EDGES = [("n=1", 1, 5, 4, 10, 0), ("n=1001 d=3 D=7", 1_001, 700, 3, 7, 0),
            ("dlrm widths n=333", 333, 500, 32, 128, 0), ("D=1", 400, 300, 32, 1, 0),
            ("back off 16 bytes", 4_000, 3_000, 4, 10, 1),
            ("d=96 D=8", 5_000, 4_000, 96, 8, 0)]


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
    import torch.nn.functional as F
    from repro_torch.kernels import build, ops, ref
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    if not torch.cuda.is_available():
        sys.exit("torch_fm_project_bench: needs a CUDA card")
    stamp = cs.card_stamp()
    build.build_all()
    planned = hasattr(ops, "fm_plan")  # this version launches from the plans
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

    # ------------------------------------------------------ fm interaction
    for label, b, f, d in FM_SHAPES:
        x = torch.randn((b, f, d), device=cs.DEV, generator=gen) * 0.3
        call = lambda: ops.fm_interaction(x)  # noqa: E731
        got, again = call(), call()
        exp = ref.fm_interaction_ref(x)
        torch.cuda.synchronize(cs.DEV)
        key = f"fm_interaction {label}"
        err = cs.max_err(got, exp) / cs.scale_of(exp)
        held(err <= cs.TOL, f"{key} err {err}")
        held(cs.same_bits(got, again), f"{key} repeats")
        digests[key] = digest(got)
        b_ms, b_by = cs.bound(x.numel() * 4 + b * 4, b * d * (3 * f + 3))
        row = {"kernel": "fm_interaction", "shape": label, "b": b, "f": f, "d": d,
               "err_of_scale": err, "digest": digests[key], "ms": cs.cuda_ms(call),
               "plain_ms": cs.cuda_ms(lambda: ref.fm_interaction_ref(x)),
               "library_ms": cs.cuda_ms(lambda: cs.fm_chain(x)), "bound_ms": b_ms,
               "bound_by": b_by}
        if planned:
            row["plan"] = ops.fm_plan(b, f, d, sms)
            if args.sweep and label in ("deepfm serve", "deepfm train", "bulk", "unstaged"):
                row["plan_ms"] = sweep_fm(torch, ops, build, cs, x, got)
        if label == "deepfm serve":
            ops_check(row, "fm_interaction", call)
        emit(row)
        del x, got, again, exp
    torch.cuda.empty_cache()

    # ------------------------------------------------------ gather project
    narrow, dl = cs.ARCHS["deepfm-narrow"], cs.ARCHS["dlrm-narrow"]
    cases = [("narrow serve", narrow, cs.SERVE_B), ("narrow train", narrow, cs.TRAIN_B),
             ("dlrm serve", dl, cs.SERVE_B), ("dlrm train", dl, cs.TRAIN_B),
             ("bulk", narrow, cs.BULK_B)]
    for label, a, b in cases:
        back, idx, kept, proj, _, _ = cs.project_case(b, gen, a)
        emit(project_row(torch, F, ops, ref, build, cs, digests, held, label, back, idx,
                         kept, proj, sms, args.sweep,
                         ops_check if label == "narrow serve" else None))
        del back, idx, kept, proj
    for label, n, m, nd, d, off in GP_EDGES:
        back = torch.randn((m * nd + off,), device=cs.DEV, generator=gen)[off:].view(m, nd)
        idx = torch.randint(-2, m + 2, (n,), device=cs.DEV, generator=gen).to(torch.int32)
        kept = torch.rand((n,), device=cs.DEV, generator=gen) < 0.7
        proj = torch.randn((nd, d), device=cs.DEV, generator=gen) / nd ** 0.5
        emit(project_row(torch, F, ops, ref, build, cs, digests, held, label, back, idx,
                         kept, proj, sms, False, None))
    torch.cuda.empty_cache()

    out_dir = ROOT / "results"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"fm_project_bench_{args.tag}.json").write_text(
        json.dumps({"rows": rows, "digests": digests}, indent=1))
    if args.against:
        other = json.loads((out_dir / f"fm_project_bench_{args.against}.json").read_text())
        common = [k for k in digests if k in other["digests"]]
        differ = [k for k in common if other["digests"][k] != digests[k]]
        emit({"against": args.against, "compared": len(common), "differ": differ,
              "only_here": [k for k in digests if k not in other["digests"]],
              "only_there": [k for k in other["digests"] if k not in digests]})
        held(not differ, f"outputs differ from {args.against}'s: {differ}")
    cs.check(not failed, "; ".join(failed))


def project_row(torch, F, ops, ref, build, cs, digests, held, label, back, idx, kept, proj,
                sms, sweep, ops_check) -> dict:
    """One ``gather_project`` case: held to the plain version (1e-5 of
    scale, not-kept positions exactly 0) and to a bitwise repeat, its
    digests recorded, timed beside the plain version and the two-call chain;
    a shape this version refuses is recorded as refused."""
    (m, nd), n, d = back.shape, idx.shape[0], proj.shape[1]
    key = f"gather_project {label}"
    row = {"kernel": "gather_project", "shape": label, "n": n, "m": m, "narrow_d": nd, "d": d}
    call = lambda: ops.gather_project(back, idx, kept, proj)  # noqa: E731
    try:
        got = call()
    except ValueError as e:
        return {**row, "refused": str(e)}
    again = call()
    exp = ref.gather_project_ref(back, idx, kept, proj)
    torch.cuda.synchronize(cs.DEV)
    err = max(cs.max_err(x, y) / cs.scale_of(y) for x, y in zip(got, exp))
    ok = kept & (idx >= 0) & (idx < m)
    held(err <= cs.TOL, f"{key} err {err}")
    held(bool((got[0][~ok] == 0).all() and (got[1][~ok] == 0).all()),
         f"{key} not-kept positions exactly 0")
    held(all(cs.same_bits(x, y) for x, y in zip(got, again)), f"{key} repeats")
    digests[key] = digest(*got)
    n_ok = int(ok.sum())
    b_ms, b_by = cs.bound(n * (4 + 1) + n_ok * nd * 4 + nd * d * 4 + n * (d + nd) * 4,
                          2 * n_ok * nd * d)
    safe = torch.where(ok, idx, torch.zeros_like(idx)).long()

    def lib():  # two calls, timed together
        return (F.embedding(safe, back) * ok[:, None]) @ proj

    row.update({"kept": n_ok, "err_of_scale": err, "digest": digests[key],
                "ms": cs.cuda_ms(call),
                "plain_ms": cs.cuda_ms(lambda: ref.gather_project_ref(back, idx, kept, proj)),
                "library_ms": cs.cuda_ms(lib), "bound_ms": b_ms, "bound_by": b_by})
    if sms is not None:
        row["plan"] = ops.gather_project_plan(n, nd, d, sms, ops._alignment(back))
        if sweep:
            row["plan_ms"] = sweep_project(torch, ops, build, cs, back, idx, kept, proj, got,
                                           row["plan"])
    if ops_check is not None:
        ops_check(row, "gather_project", call)
    return row


def sweep_fm(torch, ops, build, cs, x, want) -> dict:
    """Device ms of the forward kernel alone at other samples a block and
    threads than its plan's (staged, or unstaged where the plan is), each
    output first held bitwise to the plan's. Keys are ``spb/threads``."""
    b, f, d = x.shape
    staged = ops.fm_plan(b, f, d, ops.sm_count(cs.DEV))[2]
    out = torch.empty_like(want)
    launch = build.launcher("fm_interaction")
    times = {}
    for spb in (1, 2, 3, 4, 6, 8, 10, 16, 32):
        if (staged and 4 * (spb * f * d + 3) > ops.FM_SMEM_BYTES) or spb > b:
            continue
        for threads in (32, 64, 128, 256):
            if threads > 32 * spb or (not staged and threads != 32 * spb):
                continue

            def run(spb=spb, threads=threads):
                rc = launch(x.data_ptr(), out.data_ptr(), b, f, d, spb, threads, staged,
                            torch.cuda.current_stream().cuda_stream)
                cs.check(rc == 0, f"fm_interaction plan {spb}/{threads}: cudaError {rc}")

            run()
            torch.cuda.synchronize(cs.DEV)
            cs.check(cs.same_bits(out, want), f"fm_interaction plan {spb}/{threads} bitwise")
            times[f"{spb}/{threads}"] = cs.cuda_ms(run)
    return times


def sweep_project(torch, ops, build, cs, back, idx, kept, proj, want, plan) -> dict:
    """Device ms of the kernel alone at each tile of 16-256 positions and
    each 1, 2, 4, 8 positions a product lane (the plan's vectors and
    threads), each output first held bitwise to the plan's. Keys are
    ``tile/rows``."""
    (m, nd), n, d = back.shape, idx.shape[0], proj.shape[1]
    w, cw, _, threads, _ = plan
    wide, narrow = torch.empty_like(want[0]), torch.empty_like(want[1])
    launch = build.launcher("gather_project")
    times = {}
    for tile in (16, 32, 64, 128, 256):
        if ops.gather_project_smem(nd, d, tile) > ops.GP_SMEM_BYTES:
            continue
        for rows in (1, 2, 4, 8):
            def run(tile=tile, rows=rows):
                rc = launch(back.data_ptr(), idx.data_ptr(), kept.data_ptr(), proj.data_ptr(),
                            wide.data_ptr(), narrow.data_ptr(), m, n, nd, d, w, cw, rows,
                            threads, tile, torch.cuda.current_stream().cuda_stream)
                cs.check(rc == 0, f"gather_project plan {tile}/{rows}: cudaError {rc}")

            run()
            torch.cuda.synchronize(cs.DEV)
            cs.check(cs.same_bits(wide, want[0]) and cs.same_bits(narrow, want[1]),
                     f"gather_project plan {tile}/{rows} bitwise")
            times[f"{tile}/{rows}"] = cs.cuda_ms(run)
    return times


if __name__ == "__main__":
    # the packing salt hashes table names: a fixed seed makes the DLRM and
    # narrow plans (and so the cases' bucket capacities) alike in every run
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    main()
