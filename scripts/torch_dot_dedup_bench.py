#!/usr/bin/env python3
"""Times the port's ``dot_interaction``, its backward ``dot_interaction_bwd``
and ``dedup_adagrad`` on the card at their paths' shapes and at bulk,
beside their plain versions and, for the dot kernels, the PyTorch chain
that computes the same function; checks each against its plain version and
records digests of its outputs, so two versions can be held bit for bit
against each other.

    python3 scripts/torch_dot_dedup_bench.py [--src DIR] [--tag NAME] [--against TAG]
                                             [--max-dedup-ops N] [--sweep]

Shapes: both dot kernels at F = 27, D = 128 (DLRM) with B = 256
(training), 512 (serving) and 65,536 (bulk) and at the bench config's
D = 16, each timed beside its chain (``bmm``, then the triangle gather;
zeros, the triangle scatter, the transpose added, ``bmm``); the forward
also at its plan's boundaries (``chip_smoke.DOT_FWD_F`` x ``DOT_FWD_D`` x
``DOT_FWD_B``) and the backward on ``chip_smoke.DOT_EDGES``;
``dedup_adagrad`` at each call a training step makes
(``chip_smoke.dedup_shape``): deepfm's master (m = 15,976, d = 10), the
narrow d = 4 master and its D = 10 L2 tier, DLRM's d = 32 master and its
D = 128 L2 tier, and deepfm's at bulk (m = 4,089,448), each on a full-size
table with chip_smoke's case (a quarter duplicates, a tenth invalid) and
with distinct rows (the path's case at world 1), plus the skewed case
(rows repeated 1,000, 33 and 2 times). Each result is first held to its
plain version (1e-5 of scale) and to a bitwise repeat, then timed with
``chip_smoke.cuda_ms`` (CUDA events, device only, median of 30). One
``dedup_adagrad`` call at deepfm's shape, and one at bulk, is traced with
``torch.profiler``: every device operation of the call, with its time, is
printed, and the count and the absence of a sort are recorded
(``--max-dedup-ops N`` fails the run if a call makes more than N, or a
sort). ``--sweep`` also times the forward at the three full-width batches
under other plans than ``ops.dot_fwd_plan``'s (tile side, samples a
buffer, buffers, threads), each bitwise the plan's output.

``--src DIR`` takes ``repro_torch`` from another checkout's ``src`` (an
earlier version of the kernels), so two versions can be timed in turns in
one call on one card. ``--against TAG`` then requires every output digest
to equal the one recorded under ``results/dot_dedup_bench_<TAG>.json``
(bitwise the same outputs on the same inputs). Prints one JSON line a
measurement and writes them all to ``results/dot_dedup_bench_<tag>.json``
(git-ignored). Needs one CUDA card and about 30 GB of its memory.
"""
import argparse
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this")
    ap.add_argument("--against", default=None)
    ap.add_argument("--max-dedup-ops", type=int, default=None)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    # repro_torch from --src first: chip_smoke's own imports then find it
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.kernels import build, ops, ref
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    if not torch.cuda.is_available():
        sys.exit("torch_dot_dedup_bench: needs a CUDA card")
    stamp = cs.card_stamp()
    build.build_all()
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

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    # ------------------------------------------------------- dot forward
    dl = cs.ARCHS["dlrm-narrow"]
    f_full = dl.n_fields + 1
    fwd = {"train": (cs.TRAIN_B, f_full, dl.dim), "serve": (cs.SERVE_B, f_full, dl.dim),
           "bulk": (cs.BULK_B, f_full, dl.dim), "bench D=16": (cs.TRAIN_B, f_full, 16)}
    fwd.update({f"plan {b}x{f}x{d}": (b, f, d) for f in cs.DOT_FWD_F for d in cs.DOT_FWD_D
                for b in cs.DOT_FWD_B})
    for label, (b, f, d) in fwd.items():
        x, _ = cs.dot_case(b, gen, f, d)
        got, again = ops.dot_interaction(x), ops.dot_interaction(x)
        exp = ref.dot_interaction_ref(x)
        torch.cuda.synchronize(cs.DEV)
        err = cs.max_err(got, exp) / cs.scale_of(exp)
        key = f"dot_interaction {label}"
        held(err <= cs.TOL, f"{key} err {err}")
        held(cs.same_bits(got, again), f"{key} repeats")
        digests[key] = digest(got)
        p = f * (f - 1) // 2
        iu, ju = torch.triu_indices(f, f, 1, device=cs.DEV)
        b_ms, b_by = cs.bound((b * f * d + b * p) * 4, 2 * b * p * d)
        row = {"kernel": "dot_interaction", "shape": label, "b": b, "f": f, "d": d,
               "err_of_scale": err, "digest": digests[key], "bound_ms": b_ms,
               "bound_by": b_by}
        if hasattr(ops, "dot_fwd_plan"):
            row["plan"] = ops.dot_fwd_plan(b, f, d)
        if not label.startswith("plan"):
            row.update({"ms": cs.cuda_ms(lambda: ops.dot_interaction(x)),
                        "plain_ms": cs.cuda_ms(lambda: ref.dot_interaction_ref(x)),
                        "library_ms": cs.cuda_ms(
                            lambda: torch.bmm(x, x.transpose(1, 2))[:, iu, ju])})
            if args.sweep and label != "bench D=16":
                row["plan_ms"] = sweep_fwd(torch, ops, build, cs, x, got)
        emit(row)
        del x, got, again, exp
    torch.cuda.empty_cache()

    # ------------------------------------------------------ dot backward
    shapes = {"train": (cs.TRAIN_B, f_full, dl.dim), "serve": (cs.SERVE_B, f_full, dl.dim),
              "bulk": (cs.BULK_B, f_full, dl.dim), "bench D=16": (cs.TRAIN_B, f_full, 16)}
    shapes.update({f"edge {b}x{f}x{d}": (b, f, d) for b, f, d in cs.DOT_EDGES})
    for label, (b, f, d) in shapes.items():
        x, g = cs.dot_case(b, gen, f, d)
        got, again = ops.dot_interaction_bwd(x, g), ops.dot_interaction_bwd(x, g)
        exp = ref.dot_interaction_bwd_ref(x, g)
        torch.cuda.synchronize(cs.DEV)
        err = cs.max_err(got, exp) / cs.scale_of(exp)
        held(err <= cs.TOL, f"dot_interaction_bwd {label} err {err}")
        held(cs.same_bits(got, again), f"dot_interaction_bwd {label} repeats")
        key = f"dot_interaction_bwd {label}"
        digests[key] = digest(got)
        p = f * (f - 1) // 2
        iu, ju = torch.triu_indices(f, f, 1, device=cs.DEV)

        def lib():  # zeros, the triangle scatter, add the transpose, bmm
            gz = torch.zeros((b, f, f), device=cs.DEV)
            gz[:, iu, ju] = g
            return torch.bmm(gz + gz.transpose(1, 2), x)

        b_ms, b_by = cs.bound((2 * b * f * d + b * p) * 4, 2 * b * f * (f - 1) * d)
        timed = label in ("train", "serve", "bulk", "bench D=16")
        emit({"kernel": "dot_interaction_bwd", "shape": label, "b": b, "f": f, "d": d,
              "err_of_scale": err, "digest": digests[key],
              "ms": cs.cuda_ms(lambda: ops.dot_interaction_bwd(x, g)) if timed else None,
              "plain_ms": cs.cuda_ms(lambda: ref.dot_interaction_bwd_ref(x, g))
              if timed else None,
              "library_ms": cs.cuda_ms(lib) if timed else None,
              "bound_ms": b_ms, "bound_by": b_by})
        del x, g, got, again, exp

    # ---------------------------------------------------- dedup adagrad
    narrow, deepfm = cs.ARCHS["deepfm-narrow"], cs.ARCHS["deepfm"]
    cases = [("deepfm master", deepfm, cs.TRAIN_B, False), ("deepfm bulk", deepfm, cs.BULK_B, False),
             ("narrow master", narrow, cs.TRAIN_B, False),
             ("narrow L2 tier", narrow, cs.TRAIN_B, True),
             ("dlrm master", dl, cs.TRAIN_B, False), ("dlrm L2 tier", dl, cs.TRAIN_B, True)]
    for label, a, b, tier in cases:
        m, n_rows, d = cs.dedup_shape(b, a, tier)
        w = torch.randn((n_rows, d), device=cs.DEV, generator=gen)
        acc = torch.rand((n_rows, 1), device=cs.DEV, generator=gen)
        kinds = ["quarter duplicates", "distinct"] + (["skewed"] if label == "deepfm master"
                                                      else [])
        for kind in kinds:
            idx, g, valid = cs.dedup_case(m, n_rows, d, gen, skew=kind == "skewed")
            if kind == "distinct":  # the path's case: distinct kept rows
                idx = torch.randperm(n_rows, device=cs.DEV, generator=gen)[:m].to(torch.int32)
                idx = torch.where(valid, idx, torch.zeros_like(idx))
            touched = torch.unique(idx[valid]).long()
            w0, acc0 = w[touched].clone(), acc[touched].clone()
            # the plain version on a compact copy of the touched rows (the
            # same positions in the same order name the same compact rows)
            local = torch.searchsorted(touched, idx.long()).clamp_(max=touched.numel() - 1)
            keep = valid & (touched[local] == idx.long())
            wp, accp = w0.clone(), acc0.clone()
            ref.dedup_adagrad_ref(wp, accp, local.to(torch.int32), g, keep, cs.LR, cs.EPS)
            ops.dedup_adagrad(w, acc, idx, g, valid, cs.LR, cs.EPS)
            first = (w[touched].clone(), acc[touched].clone())
            w[touched], acc[touched] = w0, acc0
            ops.dedup_adagrad(w, acc, idx, g, valid, cs.LR, cs.EPS)
            torch.cuda.synchronize(cs.DEV)
            # w to its scale; acc to w's (chip_smoke's bar), or to its own
            # where a row summed from 1,000 positions takes it to about 1,000
            err = cs.max_err(first[0], wp) / cs.scale_of(wp)
            err_acc = cs.max_err(first[1], accp) / cs.scale_of(
                accp if kind == "skewed" else wp)
            held(max(err, err_acc) <= cs.TOL, f"dedup_adagrad {label} {kind} err {err}, "
                 f"acc {err_acc}")
            held(cs.same_bits(w[touched], first[0]) and cs.same_bits(acc[touched], first[1]),
                 f"dedup_adagrad {label} {kind} repeats")
            key = f"dedup_adagrad {label} {kind}"
            digests[key] = digest(*first)
            u = touched.numel()
            b_ms, b_by = cs.bound(m * (4 + 1 + d * 4) + u * (d * 4 + 4) * 2,
                                  m * d + u * (3 * d + 4))
            row = {"kernel": "dedup_adagrad", "shape": label, "case": kind, "m": m,
                   "rows": n_rows, "d": d, "touched_rows": u, "err_of_scale": err,
                   "acc_err_of_scale": err_acc,
                   "digest": digests[key],
                   "ms": cs.cuda_ms(lambda: ops.dedup_adagrad(w, acc, idx, g, valid, cs.LR,
                                                              cs.EPS)),
                   "plain_ms": cs.cuda_ms(lambda: ref.dedup_adagrad_ref(
                       w, acc, idx, g, valid, cs.LR, cs.EPS)),
                   "bound_ms": b_ms, "bound_by": b_by}
            if label in ("deepfm master", "deepfm bulk") and kind == "quarter duplicates":
                row["device_ops"] = trace = trace_dedup(torch, ops, w, acc, idx, g, valid, cs)
                if args.max_dedup_ops is not None:
                    held(trace["per_call"] <= args.max_dedup_ops and not trace["sort_ops"],
                         f"dedup_adagrad makes {trace['per_call']} device operations a "
                         f"call, {trace['sort_ops']} of them sorts")
            emit(row)
            w[touched], acc[touched] = w0, acc0
        del w, acc
        torch.cuda.empty_cache()

    out_dir = ROOT / "results"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"dot_dedup_bench_{args.tag}.json").write_text(
        json.dumps({"rows": rows, "digests": digests}, indent=1))
    if args.against:
        other = json.loads((out_dir / f"dot_dedup_bench_{args.against}.json").read_text())
        differ = [k for k, v in digests.items() if other["digests"].get(k) != v]
        emit({"against": args.against, "compared": len(digests), "differ": differ})
        held(not differ, f"outputs differ from {args.against}'s: {differ}")
    cs.check(not failed, "; ".join(failed))


def sweep_fwd(torch, ops, build, cs, x, want) -> dict:
    """Device ms of the forward kernel alone under other plans than its
    own: tile side 2 and 4, one or several samples a ring buffer, two or
    three buffers, 32-256 threads; each output first held bitwise to the
    plan's. Keys are ``spb/stages/threads/tile``."""
    b, f, d = x.shape
    out = torch.empty_like(want)
    launch = build.launcher("dot_interaction")
    times = {}
    for spb, stages in ((1, 3), (1, 2), (7, 2)):
        smem = ops.dot_fwd_smem(f, d, spb, stages)
        if smem > ops.DOT_SMEM_BYTES or spb > max(1, b // ops.DOT_MIN_GROUPS):
            continue
        for tile in (2, 4):
            for threads in (32, 64, 128, 256):
                plan = (spb, stages, threads, smem, tile)

                def run(plan=plan):
                    rc = launch(x.data_ptr(), out.data_ptr(), b, f, d, *plan,
                                torch.cuda.current_stream().cuda_stream)
                    cs.check(rc == 0, f"dot_interaction plan {plan}: cudaError {rc}")

                run()
                torch.cuda.synchronize(cs.DEV)
                cs.check(cs.same_bits(out, want), f"dot_interaction plan {plan} bitwise")
                times[f"{spb}/{stages}/{threads}/{tile}"] = cs.cuda_ms(run)
    return times


def trace_dedup(torch, ops, w, acc, idx, g, valid, cs) -> dict:
    """Every device operation of one ``dedup_adagrad`` call (median of ten
    traced calls), in order, with its device time; fails if one is a
    sort."""
    calls = 10
    ops.dedup_adagrad(w, acc, idx, g, valid, cs.LR, cs.EPS)
    torch.cuda.synchronize(cs.DEV)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ops.dedup_adagrad(w, acc, idx, g, valid, cs.LR, cs.EPS)
        torch.cuda.synchronize(cs.DEV)
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev.sort(key=lambda e: e.time_range.start)
    per_call = len(dev) / calls
    first = dev[: len(dev) // calls]
    ops_list = [{"name": e.name[:120], "us": e.time_range.elapsed_us()} for e in first]
    sorts = [e.name for e in dev if "sort" in e.name.lower()]
    return {"per_call": per_call, "first_call": ops_list, "sort_ops": len(sorts),
            "device_us_per_call": sum(e.time_range.elapsed_us() for e in dev) / calls}


if __name__ == "__main__":
    main()
