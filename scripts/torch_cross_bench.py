#!/usr/bin/env python3
"""Times the port's two cross kernels on the card at dcn-v2's shapes, beside
their plain versions and the PyTorch calls that compute the same function.

    python3 scripts/torch_cross_bench.py [--src DIR] [--sweep] [--tag NAME]

Shapes: ``cross_layer`` at B = 512 (serving), 256 (training) and 65,536
(bulk), ``cross_layer_bwd`` at B = 256 and 65,536, all at d = 429. Each
kernel is first held to its plain version (1e-5 of scale) and to a bitwise
repeat, then timed with ``chip_smoke.cuda_ms`` (CUDA events, device only,
median of 30). ``--src DIR`` takes ``repro_torch`` from another checkout's
``src`` (an earlier version of the kernels), so two versions can be timed
in turns in one call on one card. ``--sweep`` also times each cluster size
(1, 2, 4, 8) of each pass (the kernels' C entry points called directly), to check
``ops.cross_plan``'s choice. Prints one JSON line a measurement and writes
them all to ``results/cross_bench_<tag>.json`` (git-ignored). Needs one
CUDA card.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--tag", default="this")
    args = ap.parse_args()
    # repro_torch from --src first: chip_smoke's own imports then find it
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.kernels import build, ops, ref
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    if not torch.cuda.is_available():
        sys.exit("torch_cross_bench: needs a CUDA card")
    stamp = cs.card_stamp()
    build.build_all()
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    d = cs.CROSS_D
    rows = []

    def emit(row):
        row = {"tag": args.tag, "card": stamp, **row}
        rows.append(row)
        print(json.dumps(row), flush=True)

    def held(name, got, again, exp):
        errs = [cs.max_err(k, e) / cs.scale_of(e) for k, e in zip(got, exp)]
        cs.check(max(errs) <= cs.TOL, f"{name} err {errs}")
        cs.check(all(cs.same_bits(p, q) for p, q in zip(got, again)), f"{name} repeats")
        return max(errs)

    for b in (cs.SERVE_B, cs.TRAIN_B, cs.BULK_B):
        x0, x, w, bias, g = cs.cross_case(b, gen)
        fwd = lambda: ops.cross_layer(x0, x, w, bias)  # noqa: E731
        err = held("cross_layer", (fwd(),), (fwd(),), (ref.cross_layer_ref(x0, x, w, bias),))
        emit({"kernel": "cross_layer", "n": b, "err_of_scale": err, "ms": cs.cuda_ms(fwd),
              "plain_ms": cs.cuda_ms(lambda: ref.cross_layer_ref(x0, x, w, bias)),
              "library_ms": cs.cuda_ms(lambda: torch.addcmul(x, x0, torch.addmm(bias, x, w))),
              **cs.cross_bounds(b, d, 1, (3 * b * d + d * d + d) * 4,
                                2 * b * d * d + 3 * b * d)})
        if b == cs.SERVE_B:
            continue
        bwd = lambda: ops.cross_layer_bwd(x0, x, w, bias, g)  # noqa: E731
        err = held("cross_layer_bwd", bwd(), bwd(), ref.cross_layer_bwd_ref(x0, x, w, bias, g))
        leaves = [t.clone().requires_grad_(True) for t in (x0, x, w, bias)]
        out = torch.addcmul(leaves[1], leaves[0], torch.addmm(leaves[3], leaves[1], leaves[2]))
        # the device time of each of its kernels
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                bwd()
            torch.cuda.synchronize()
        split = {k: e.device_time_total / e.count / 1e3 for e in prof.key_averages()
                 for k in ("cross_bwd_dx_kernel", "cross_bwd_dw_kernel", "cross_bwd_reduce_kernel")
                 if k in e.key and e.count}
        emit({"kernel": "cross_layer_bwd", "n": b, "err_of_scale": err, "ms": cs.cuda_ms(bwd),
              "kernel_ms": split,
              "plain_ms": cs.cuda_ms(lambda: ref.cross_layer_bwd_ref(x0, x, w, bias, g)),
              "library_ms": cs.cuda_ms(
                  lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)),
              **cs.cross_bounds(b, d, 3, (5 * b * d + 2 * d * d + 2 * d) * 4,
                                6 * b * d * d + 5 * b * d)})

    if args.sweep:
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        fwd_c, bwd_c = build.launcher("cross_layer"), build.launcher("cross_layer_bwd")
        for b in (cs.SERVE_B, cs.TRAIN_B, cs.BULK_B):
            x0, x, w, bias, g = cs.cross_case(b, gen)
            plan = ops.cross_plan(b, d)
            out = torch.empty_like(x)
            gx0, gx, gw, gb = (torch.empty_like(x), torch.empty_like(x),
                               torch.empty_like(w), torch.empty_like(bias))
            exp_f = ref.cross_layer_ref(x0, x, w, bias)
            exp_b = ref.cross_layer_bwd_ref(x0, x, w, bias, g)
            p = [t.data_ptr() for t in (x0, x, w, bias)]
            for c in (1, 2, 4, 8):
                def f(c=c):
                    cs.check(fwd_c(*p, out.data_ptr(), b, d, c, stream()) == 0, "launch")

                f()
                first = (out.clone(),)
                f()
                emit({"kernel": "cross_layer", "n": b, "cluster": c, "plan": list(plan),
                      "err_of_scale": held("sweep fwd", first, (out,), (exp_f,)),
                      "ms": cs.cuda_ms(f)})
                for which in ("dx", "dw"):
                    cdx, cdw = (c, plan[2]) if which == "dx" else (plan[1], c)
                    if which == "dw" and c > -(-b // ops.CROSS_SLAB):
                        continue  # a rank would have no rows

                    def k(cdx=cdx, cdw=cdw):
                        cs.check(bwd_c(*p, g.data_ptr(), gx0.data_ptr(), gx.data_ptr(),
                                       gw.data_ptr(), gb.data_ptr(), b, d, cdx, cdw,
                                       stream()) == 0, "launch")

                    k()
                    first = tuple(t.clone() for t in (gx0, gx, gw, gb))
                    k()
                    emit({"kernel": "cross_layer_bwd", "n": b, "cluster_dx": cdx,
                          "cluster_dw": cdw, "plan": list(plan),
                          "err_of_scale": held(f"sweep bwd {which}", first,
                                               (gx0, gx, gw, gb), exp_b),
                          "ms": cs.cuda_ms(k)})
    out_dir = ROOT / "results"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"cross_bench_{args.tag}.json").write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
