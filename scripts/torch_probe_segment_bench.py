#!/usr/bin/env python3
"""Times the port's ``tier_probe``, ``segment_grad`` and ``gather_pool`` on
the card at every path shape and at bulk, beside their plain versions and
PyTorch yardsticks; checks each against its plain version and records
digests of its outputs, so two versions can be held bit for bit against
each other. Also traces one call of each redesigned kernel, and traces
full-width deepfm training steps.

    python3 scripts/torch_probe_segment_bench.py [--src DIR] [--tag NAME]
        [--against TAG] [--max-segment-ops N] [--max-pool-ops N] [--sweep]

Shapes: ``segment_grad`` at deepfm's training shape (n = 9,984, D = 10),
dcn-v2's (n = 6,656, D = 16), DLRM's (n = 6,656, D = 128) and at bulk
(n = 2,555,904, D = 10), each with uniform ids (``chip_smoke.segment_case``:
runs of about 2) and with the arch's own zipf (a = 1.2) batch packed as the
path packs it (runs of up to 200 positions, 52,393 at bulk); it is called
as the engine calls it, along the forward unique's stable sort, where the
version takes one (an earlier version sorts in every call). ``gather_pool``
at every path's serving and training shape (deepfm D = 10, n = 19,968 and
9,984; dcn-v2 D = 16 and DLRM D = 128, n = 13,312 and 6,656; one position
a bag) and at bulk, each timed, and on ``chip_smoke.POOL_LAYOUTS`` (runs of
1-200 positions with empty bags among them and at the tail, a run across
tiles, a seg past n_bags, n = 1) at each of ``chip_smoke.POOL_EDGE_D``.
``tier_probe`` at deepfm's 4.19 M-key L1 (serving n = 19,968 and training
n = 9,984), dcn-v2's L1 (D = 16), the narrow 48.8 M-key L2 (D = 10), DLRM's
2.08 M-key L1 (serving and training) and 4.16 M-key L2 (D = 128), at bulk,
and on ``chip_smoke``'s edge cases. Each result is first held to its plain
version (``tier_probe`` bitwise; ``segment_grad`` and ``gather_pool`` to
1e-5 of scale, their unused slots and bags exactly 0) and to a bitwise
repeat, then timed with ``chip_smoke.cuda_ms`` (CUDA events, device only,
median of 30). A one-element fill is timed the same way, as the floor of
such a timing. ``torch.profiler`` traces one ``segment_grad`` call at
deepfm's zipf shape, one ``gather_pool`` and one ``tier_probe`` call at
deepfm's serving shape, each operation with its device time
(``--max-segment-ops N`` fails the run if that ``segment_grad`` call makes
more than N device operations or a sort, ``--max-pool-ops N`` if the
``gather_pool`` call makes more than N or allocates more than its output),
and five full-width deepfm training steps (device operations a step, sorts
among them, device ms a step). ``--sweep`` also times every tile of
``segment_grad`` and every lane count of ``tier_probe`` at each shape.

``--src DIR`` takes ``repro_torch`` from another checkout's ``src`` (an
earlier version of the kernels), so two versions can be timed in turns in
one call on one card. ``--against TAG`` then requires every output digest
to equal the one recorded under ``results/probe_segment_bench_<TAG>.json``.
Prints one JSON line a measurement and writes them all to
``results/probe_segment_bench_<tag>.json`` (git-ignored). Needs one CUDA
card and about 20 GB of its memory.
"""
import argparse
import hashlib
import json
import math
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this")
    ap.add_argument("--against", default=None)
    ap.add_argument("--max-segment-ops", type=int, default=None)
    ap.add_argument("--max-pool-ops", type=int, default=None)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    # repro_torch from --src first: chip_smoke's own imports then find it
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.kernels import build, ops, ref
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    if not torch.cuda.is_available():
        sys.exit("torch_probe_segment_bench: needs a CUDA card")
    stamp = cs.card_stamp()
    build.build_all()
    # a version that takes the forward's sort has the launch plans
    carried = hasattr(ops, "segment_grad_plan")
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

    # the least a timed call can measure: one single-element fill kernel
    one = torch.zeros((1,), device=cs.DEV)
    emit({"kernel": "floor", "shape": "one-element fill",
          "ms": cs.cuda_ms(lambda: one.fill_(1.0))})

    # ------------------------------------------------------ segment grad
    deepfm, dcn, dl = cs.ARCHS["deepfm"], cs.ARCHS["dcn-v2"], cs.ARCHS["dlrm-narrow"]
    for label, a, b in (("deepfm train", deepfm, cs.TRAIN_B), ("dcn-v2 train", dcn, cs.TRAIN_B),
                        ("dlrm train", dl, cs.TRAIN_B), ("bulk", deepfm, cs.BULK_B)):
        for case in ("uniform", "zipf"):
            g_bags, seg, w, u = cs.segment_case(b, gen, a, zipf=case == "zipf")
            n, d, inv = seg.shape[0], a.dim, u.inv
            sorted_inv, order = torch.sort(inv, stable=True)
            kw = dict(order=order, sorted_inv=sorted_inv) if carried else {}

            def call():
                return ops.segment_grad(g_bags, seg, w, inv, n, **kw)

            got, again = call(), call()
            exp = ref.segment_grad_ref(g_bags, seg, w, inv, n)
            torch.cuda.synchronize(cs.DEV)
            n_uniq = int(u.n_uniq)
            err = cs.max_err(got, exp) / cs.scale_of(exp)
            key = f"segment_grad {label} {case}"
            held(err <= cs.TOL, f"{key} err {err}")
            held(cs.same_bits(got, again), f"{key} repeats")
            held(bool((got[n_uniq:] == 0).all()), f"{key} unused slots exactly 0")
            digests[key] = digest(got)
            runs = torch.bincount(inv.long())
            # g_bags, seg, w and inv read once, the output written once
            b_ms, b_by = cs.bound(g_bags.numel() * 4 + n * (4 + 4 + 4) + n * d * 4,
                                  2 * n * d)
            row = {"kernel": "segment_grad", "shape": label, "case": case, "n": n, "d": d,
                   "n_uniq": n_uniq, "longest_run": int(runs.max()), "err_of_scale": err,
                   "digest": digests[key], "carried_sort": carried, "ms": cs.cuda_ms(call),
                   "plain_ms": cs.cuda_ms(lambda: ref.segment_grad_ref(g_bags, seg, w, inv,
                                                                      n)),
                   "bound_ms": b_ms, "bound_by": b_by}
            if carried:  # standalone: the wrapper sorts first
                row["sorting_ms"] = cs.cuda_ms(lambda: ops.segment_grad(g_bags, seg, w, inv,
                                                                        n))
                row["plan"] = ops.segment_grad_plan(n, d, ops.sm_count(cs.DEV))
                if args.sweep:
                    row["tile_ms"] = sweep_segment(ops, build, cs, g_bags, seg, w, order,
                                                   sorted_inv, n, d)
            if label == "deepfm train" and case == "zipf":
                row["device_ops"] = trace = trace_call(torch, cs, call)
                if args.max_segment_ops is not None:
                    held(trace["per_call"] <= args.max_segment_ops and not trace["sort_ops"],
                         f"segment_grad makes {trace['per_call']} device operations a "
                         f"call, {trace['sort_ops']} of them sorts")
            emit(row)
            del g_bags, seg, w, u, got, again, exp
        torch.cuda.empty_cache()

    # --------------------------------------------------------- gather pool
    for label, a, b in (("deepfm serve", deepfm, cs.SERVE_B), ("deepfm train", deepfm, cs.TRAIN_B),
                        ("dcn-v2 serve", dcn, cs.SERVE_B), ("dcn-v2 train", dcn, cs.TRAIN_B),
                        ("dlrm serve", dl, cs.SERVE_B), ("dlrm train", dl, cs.TRAIN_B),
                        ("bulk", deepfm, cs.BULK_B)):
        rows_u, inv, w, seg, n = cs.pool_case(b, gen, a)
        emit(pool_row(torch, ops, ref, cs, digests, held, f"gather_pool {label}",
                      rows_u, inv, w, seg, n, timed=True, trace=label == "deepfm serve",
                      max_ops=args.max_pool_ops))
        del rows_u, inv, w, seg
    for kind in cs.POOL_LAYOUTS:
        for d in cs.POOL_EDGE_D:
            case = cs.pool_layout(kind, gen, d)
            emit(pool_row(torch, ops, ref, cs, digests, held, f"gather_pool {kind} D={d}",
                          *case, timed=kind == "runs 1-200" and d in (10, 128)))
    torch.cuda.empty_cache()

    # --------------------------------------------------------- tier probe
    narrow = cs.ARCHS["deepfm-narrow"]
    shapes = [("deepfm L1 serve", deepfm, cs.SERVE_B, False),
              ("deepfm L1 train", deepfm, cs.TRAIN_B, False),
              ("dcn-v2 L1 serve", dcn, cs.SERVE_B, False),
              ("narrow L2 serve", narrow, cs.SERVE_B, True),
              ("dlrm L1 serve", dl, cs.SERVE_B, False), ("dlrm L2 serve", dl, cs.SERVE_B, True),
              ("dlrm L1 train", dl, cs.TRAIN_B, False), ("bulk", deepfm, cs.BULK_B, False)]
    for label, a, b, l2 in shapes:
        args_ = cs.probe_case(b, gen, a, a.l2_rows if l2 else a.hot_rows)
        uniq, uvalid, keys, trows = args_
        got, again = ops.tier_probe(*args_), ops.tier_probe(*args_)
        exp = ref.tier_probe_ref(*args_)
        torch.cuda.synchronize(cs.DEV)
        key = f"tier_probe {label}"
        held(all(cs.same_bits(x, y) for x, y in zip(got, exp)), f"{key} bitwise plain")
        held(all(cs.same_bits(x, y) for x, y in zip(got, again)), f"{key} repeats")
        digests[key] = digest(*got)
        n, h = uniq.shape[0], keys.shape[0]
        n_hit = int(got[0].sum())
        keys_read = min(h, n * (math.ceil(math.log2(h / n)) + 2))
        b_ms, b_by = cs.bound(n * (4 + 1) + keys_read * 4 + n_hit * a.dim * 4
                              + n * (1 + 4 + a.dim * 4), 0)

        def lib():  # searchsorted, then the masked row gather: a chain
            slot = torch.searchsorted(keys, uniq).clamp_(max=h - 1)
            found = (keys[slot] == uniq) & uvalid
            return found, slot, trows[slot].masked_fill_(~found[:, None], 0.0)

        row = {"kernel": "tier_probe", "shape": label, "n": n, "tier_keys": h, "d": a.dim,
               "hits": n_hit, "digest": digests[key],
               "ms": cs.cuda_ms(lambda: ops.tier_probe(*args_)),
               "plain_ms": cs.cuda_ms(lambda: ref.tier_probe_ref(*args_)),
               "library_ms": cs.cuda_ms(lib), "bound_ms": b_ms, "bound_by": b_by}
        if carried:
            row["lanes"] = ops.tier_probe_plan(n, ops.sm_count(cs.DEV))
            if args.sweep:
                row["lanes_ms"] = sweep_probe(ops, build, cs, *args_)
        if label == "deepfm L1 serve":
            row["device_ops"] = trace_call(torch, cs, lambda: ops.tier_probe(*args_))
        emit(row)
        del args_, got, again, exp, keys, trows
        torch.cuda.empty_cache()
    for kind in cs.PROBE_EDGES:
        for n in cs.PROBE_EDGE_N:
            args_ = cs.probe_edge_case(kind, n, gen)
            got, again = ops.tier_probe(*args_), ops.tier_probe(*args_)
            exp = ref.tier_probe_ref(*args_)
            torch.cuda.synchronize(cs.DEV)
            key = f"tier_probe edge {kind} n={n}"
            held(all(cs.same_bits(x, y) for x, y in zip(got, exp)), f"{key} bitwise plain")
            held(all(cs.same_bits(x, y) for x, y in zip(got, again)), f"{key} repeats")
            digests[key] = digest(*got)
    emit({"kernel": "tier_probe", "shape": "edge cases", "cases": len(cs.PROBE_EDGES),
          "n": list(cs.PROBE_EDGE_N)})

    # ------------------------------------------- full-width training steps
    emit({"trace": "deepfm training step", **trace_steps(torch, cs)})

    out_dir = ROOT / "results"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"probe_segment_bench_{args.tag}.json").write_text(
        json.dumps({"rows": rows, "digests": digests}, indent=1))
    if args.against:
        other = json.loads((out_dir / f"probe_segment_bench_{args.against}.json").read_text())
        differ = [k for k, v in digests.items() if other["digests"].get(k) != v]
        emit({"against": args.against, "compared": len(digests), "differ": differ})
        held(not differ, f"outputs differ from {args.against}'s: {differ}")
    cs.check(not failed, "; ".join(failed))


def pool_row(torch, ops, ref, cs, digests, held, key, rows_u, inv, w, seg, n_bags,
             timed=False, trace=False, max_ops=None) -> dict:
    """One ``gather_pool`` case: held to the plain version (1e-5 of scale,
    uncovered bags exactly 0) and to a bitwise repeat, its digest recorded;
    with ``timed`` the kernel, the plain version and ``embedding_bag`` (where
    seg = arange) timed beside the bound; with ``trace`` one call's device
    operations and the tensors it allocates (``max_ops`` fails the run past
    that many operations, or past the one output tensor)."""
    import torch.nn.functional as F
    call = lambda: ops.gather_pool(rows_u, inv, w, seg, n_bags)  # noqa: E731
    got, again = call(), call()
    exp = cs.pool_plain(rows_u, inv, w, seg, n_bags)
    torch.cuda.synchronize(cs.DEV)
    n, d = seg.shape[0], rows_u.shape[1]
    covered = torch.zeros((n_bags,), dtype=torch.bool, device=cs.DEV)
    covered[seg[(seg >= 0) & (seg < n_bags)].long()] = True
    err = cs.max_err(got, exp) / cs.scale_of(exp)
    held(err <= cs.TOL and bool((got[~covered] == 0).all()), f"{key} err {err}")
    held(cs.same_bits(got, again), f"{key} repeats")
    digests[key] = digest(got)
    row = {"kernel": "gather_pool", "shape": key.split(" ", 1)[1], "n": n, "d": d,
           "n_bags": n_bags, "err_of_scale": err, "digest": digests[key]}
    if timed:  # on layouts whose every seg names a bag, as the plain version takes
        b_ms, b_by = cs.pool_bound(rows_u, inv, n, n_bags)
        row.update({"ms": cs.cuda_ms(call),
                    "plain_ms": cs.cuda_ms(lambda: ref.gather_pool_ref(rows_u, inv, w, seg,
                                                                       n_bags)),
                    "bound_ms": b_ms, "bound_by": b_by})
        if n == n_bags and torch.equal(seg, torch.arange(n, device=cs.DEV, dtype=seg.dtype)):
            offsets, inv64 = seg.long(), inv.long()
            row["library_ms"] = cs.cuda_ms(lambda: F.embedding_bag(
                inv64, rows_u, offsets, mode="sum", per_sample_weights=w))
    if trace:
        row["device_ops"] = ops_ = trace_call(torch, cs, call)
        stats = torch.cuda.memory_stats(cs.DEV)["allocation.all.allocated"]
        call()
        row["tensors_allocated"] = allocated = (
            torch.cuda.memory_stats(cs.DEV)["allocation.all.allocated"] - stats)
        if max_ops is not None:
            held(ops_["per_call"] <= max_ops and allocated <= 1,
                 f"gather_pool makes {ops_['per_call']} device operations a call and "
                 f"allocates {allocated} tensors")
    return row


def digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def sweep_segment(ops, build, cs, g_bags, seg, w, order, sorted_inv, n, d) -> dict:
    """Device ms of the kernel alone at each tile its plan could take, and
    at its plan's tile with smaller staging buffers ("tile/chunk")."""
    import torch
    plan_tile, chunk = ops.segment_grad_plan(n, d, ops.sm_count(cs.DEV))
    out = torch.empty((n, d), device=cs.DEV)
    launch = build.launcher("segment_grad")
    times = {}
    for tile, ch in [(t, chunk) for t in (16, 32, 64, 128, 256)] + [
            (plan_tile, c) for c in (256, 512) if plan_tile <= c < chunk]:
        if tile > ch:
            continue

        def run(tile=tile, ch=ch):
            rc = launch(g_bags.data_ptr(), seg.data_ptr(), w.data_ptr(), order.data_ptr(),
                        sorted_inv.data_ptr(), out.data_ptr(), n, n, d, tile, ch,
                        torch.cuda.current_stream().cuda_stream)
            cs.check(rc == 0, f"segment_grad tile {tile} chunk {ch}: cudaError {rc}")

        times[f"{tile}/{ch}"] = cs.cuda_ms(run)
    return times


def sweep_probe(ops, build, cs, uniq, uvalid, keys, rows) -> dict:
    """Device ms of the kernel alone at each lane count (1 is the ranged
    search), each held bitwise to the plan's output first."""
    import torch
    n, (h, d) = uniq.shape[0], rows.shape
    hit = torch.empty((n,), dtype=torch.bool, device=cs.DEV)
    slot = torch.empty((n,), dtype=torch.int32, device=cs.DEV)
    out = torch.empty((n, d), device=cs.DEV)
    launch = build.launcher("tier_probe")
    want = ops.tier_probe(uniq, uvalid, keys, rows)
    times = {}
    for lanes in (1, 2, 4, 8, 16, 32):
        def run(lanes=lanes):
            rc = launch(uniq.data_ptr(), uvalid.data_ptr(), keys.data_ptr(), rows.data_ptr(),
                        hit.data_ptr(), slot.data_ptr(), out.data_ptr(), n, h, d, lanes,
                        torch.cuda.current_stream().cuda_stream)
            cs.check(rc == 0, f"tier_probe lanes {lanes}: cudaError {rc}")

        run()
        cs.check(all(cs.same_bits(x, y) for x, y in zip((hit, slot, out), want)),
                 f"tier_probe at {lanes} lanes bitwise the plan's")
        times[lanes] = cs.cuda_ms(run)
    return times


def device_events(torch, prof):
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev.sort(key=lambda e: e.time_range.start)
    return dev


def trace_call(torch, cs, fn, calls: int = 10) -> dict:
    """Every device operation of one call of ``fn`` (ten traced calls), in
    order, with its device time, and how many of them sort."""
    fn()
    torch.cuda.synchronize(cs.DEV)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(cs.DEV)
    dev = device_events(torch, prof)
    first = dev[: len(dev) // calls]
    return {"per_call": len(dev) / calls,
            "first_call": [{"name": e.name[:120], "us": e.time_range.elapsed_us()}
                           for e in first],
            "sort_ops": sum("sort" in e.name.lower() for e in dev) / calls,
            "device_us_per_call": sum(e.time_range.elapsed_us() for e in dev) / calls}


def trace_steps(torch, cs, steps: int = 5) -> dict:
    """Full-width deepfm training on the train launcher's plan: steps 1-5
    untraced, steps 6-10 traced (no flush among them): device operations a
    step, the sorts among them with their device time, and device ms a
    step."""
    a = cs.ARCHS["deepfm"]
    cfg, plan = cs.arch_plan(a, cs.TRAIN_B, train=True)
    model = cs.WDLModel(cfg, plan)
    state = cs.ts.init_state(model, plan, torch.Generator(device=cs.DEV).manual_seed(cs.SEED),
                             cs.DEV)
    step = cs.ts.make_train_step(model, plan, cs.TRAIN_B,
                                 cs.ts.TrainConfig(strategy=a.strategy), cs.DEV)
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
    sorts = [e for e in dev if "sort" in e.name.lower()]
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    out = {"steps": steps, "device_ops_per_step": len(dev) / steps,
           "sort_ops_per_step": len(sorts) / steps,
           "sort_us_per_step": sum(e.time_range.elapsed_us() for e in sorts) / steps,
           "device_ms_per_step": sum(e.time_range.elapsed_us() for e in dev) / steps / 1e3,
           "port_kernel_us_per_step": {k: v * 1e3 / steps
                                       for k, v in cs.port_kernels(by_name).items()}}
    del state, step
    torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    # the packing salt hashes table names: a fixed seed packs the zipf
    # batches alike in every run, so their digests compare across runs
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    main()
