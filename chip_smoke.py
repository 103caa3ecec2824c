#!/usr/bin/env python3
"""On-card check of the PyTorch port: builds its CUDA kernels, holds each one
against its plain PyTorch version, and serves full-width deepfm on one card.

    python3 chip_smoke.py

Phases, in order (any failure raises and exits non-zero):

1. build every kernel from ``src/repro_torch/kernels/csrc`` with nvcc;
2. run each kernel at the serve path's shape (B = 512) and at a bulk shape
   (B = 65,536) against its plain version on the same inputs: ``hit``/``slot``
   bitwise, rows/bags/FM to max-abs <= 1e-5 of the value scale, miss rows
   and an empty bag exactly 0; time kernel, plain version and, where one
   PyTorch call computes the same function, that call (CUDA events, median
   of 30 after warm-up) beside the byte/op bound;
3. serve full-width deepfm (187,780,711 x 10 table, 4,194,304-row hot tier,
   B = 512) through ``make_serve_step``: 8 warm-up requests feed the
   FCounter, ``engine.flush`` loads the tier, then 300 timed requests with
   the kernel launch counters reset just before and read just after; one
   request with the plain versions must give the same probabilities; a
   deepfm-smoke request served on the card must match the CPU.

Prints, before the last line, the card's name and power limit and one JSON
object of per-kernel numbers; the last line is the JSON device stamp.
Needs one CUDA card and nvcc; it fails without either. It re-runs itself
under ``PYTHONHASHSEED=0``: the packing salt hashes table names, so a fixed
seed makes the served rows, and so the probabilities, repeat run to run.
"""
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config, get_shapes  # noqa: E402
from repro_torch.core import packed_embedding as pe  # noqa: E402
from repro_torch.core.packing import make_plan  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.models.wdl import WDLModel  # noqa: E402
from repro_torch.serve.serve_step import ServeConfig, init_state, make_serve_step  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
TOL = 1e-5
SEED = 0
SPIN_CYCLES = 2_000_000  # ~1 ms at H100 clocks: longer than any timed call's enqueue
# the registry's serve_p99 request (B = 512); the bulk shape is 128x that
SERVE_B = next(s["batch"] for s in get_shapes("deepfm") if s.name == "serve_p99")
BULK_B, N_FIELDS, DIM = 65_536, 39, 10
N_TIMED = 300  # timed requests: enough that p99 is not the maximum
FULL_ROWS, HOT_ROWS = 187_780_711, 4_194_304
DEV = torch.device("cuda", 0)

SOURCES = {
    "tier_probe": ("src/repro_torch/kernels/csrc/tier_probe.cu",
                   "src/repro/kernels/fused_embedding.py:279"),
    "gather_pool": ("src/repro_torch/kernels/csrc/gather_pool.cu",
                    "src/repro/kernels/fused_embedding.py:81"),
    "fm_interaction": ("src/repro_torch/kernels/csrc/fm_interaction.cu",
                       "src/repro/kernels/fm_interaction.py:24"),
}


def check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, iters: int = 30, warmup: int = 5, device_only: bool = True) -> float:
    """Median per-call time of ``fn`` over ``iters`` calls (CUDA events).

    ``device_only``: a ~1 ms device spin is queued before each start event,
    so the host has enqueued ``fn``'s launches before the card reaches them
    and the events bracket device time alone. Without it the events also
    take in the host's Python and launch overhead between them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(DEV)
    events = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize(DEV)
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def bound(nbytes: float, nops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def scale_of(x: torch.Tensor) -> float:
    return max(float(x.abs().max()), 1.0) if x.numel() else 1.0


# ------------------------------------------------------------------ phase 2


def probe_case(b: int, gen: torch.Generator):
    """Sorted unique queries of a B-sample request, about half of them tier
    keys, against a full 4,194,304-key tier over the full table's rows."""
    n = b * N_FIELDS
    stride = FULL_ROWS // HOT_ROWS
    keys = (torch.arange(HOT_ROWS, device=DEV, dtype=torch.int64) * stride
            + torch.randint(0, stride, (HOT_ROWS,), device=DEV, generator=gen)).to(torch.int32)
    rows = torch.randn((HOT_ROWS, DIM), device=DEV, generator=gen)
    half = n // 2
    ids = torch.cat([keys[torch.randint(0, HOT_ROWS, (half,), device=DEV, generator=gen)],
                     torch.randint(0, FULL_ROWS, (n - half,), device=DEV, generator=gen,
                                   dtype=torch.int32)])
    u = pe.fixed_unique(ids.to(torch.int32), sentinel=FULL_ROWS)
    return u.uniq, u.uvalid, keys, rows


def run_tier_probe(b: int, gen: torch.Generator) -> dict:
    uniq, uvalid, keys, rows = probe_case(b, gen)
    hit, slot, out = ops.tier_probe(uniq, uvalid, keys, rows)
    rhit, rslot, rout = ref.tier_probe_ref(uniq, uvalid, keys, rows)
    torch.cuda.synchronize(DEV)
    check(torch.equal(hit, rhit) and torch.equal(slot, rslot), "tier_probe hit/slot bitwise")
    err = max_err(out, rout)
    check(err <= TOL * scale_of(rout), f"tier_probe rows err {err}")
    check(bool((out[~hit] == 0).all()), "tier_probe miss rows exactly 0")
    n, h = uniq.shape[0], keys.shape[0]
    n_hit = int(hit.sum())
    check(n_hit > 0 and n_hit < n, "tier_probe case has hits and misses")
    # the sorted queries share the top of the search tree: past its first
    # log2(n) levels each query walks its own log2(H/n) keys, so the keys
    # the n searches must touch are about n * (log2(H/n) + 2), each read once.
    # The compares are integer work, outside the float32 peak: no ops term.
    keys_read = min(h, n * (math.ceil(math.log2(h / n)) + 2))
    nbytes = n * (4 + 1) + keys_read * 4 + n_hit * DIM * 4 + n * (1 + 4 + DIM * 4)
    b_ms, b_by = bound(nbytes, 0)
    return {"n": n, "hits": n_hit, "max_abs_err": err,
            "ms": cuda_ms(lambda: ops.tier_probe(uniq, uvalid, keys, rows)),
            "call_ms": cuda_ms(lambda: ops.tier_probe(uniq, uvalid, keys, rows),
                               device_only=False),
            "plain_ms": cuda_ms(lambda: ref.tier_probe_ref(uniq, uvalid, keys, rows)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}


def run_gather_pool(b: int, gen: torch.Generator) -> dict:
    """deepfm's packed layout: one bag per (sample, field), seg = arange."""
    n = b * N_FIELDS
    ids = torch.randint(0, max(n // 2, 1), (n,), device=DEV, generator=gen, dtype=torch.int32)
    inv = pe.fixed_unique(ids, sentinel=n).inv
    rows_u = torch.randn((n, DIM), device=DEV, generator=gen)
    w = torch.rand((n,), device=DEV, generator=gen) + 0.5
    seg = torch.arange(n, device=DEV, dtype=torch.int32)
    out = ops.gather_pool(rows_u, inv, w, seg, n)
    rout = ref.gather_pool_ref(rows_u, inv, w, seg, n)
    # an uncovered bag: bag 3's positions move to bag 2
    seg_e = torch.where(seg == 3, torch.full_like(seg, 2), seg)
    out_e = ops.gather_pool(rows_u, inv, w, seg_e, n)
    rout_e = ref.gather_pool_ref(rows_u, inv, w, seg_e, n)
    torch.cuda.synchronize(DEV)
    err = max(max_err(out, rout), max_err(out_e, rout_e))
    check(err <= TOL * scale_of(rout), f"gather_pool err {err}")
    check(bool((out_e[3] == 0).all()), "gather_pool empty bag exactly 0")
    # five trailing bags that no position maps to
    out_t = ops.gather_pool(rows_u, inv, w, seg, n + 5)
    check(torch.equal(out_t[:n], out) and bool((out_t[n:] == 0).all()),
          "gather_pool trailing empty bags exactly 0")
    offsets = torch.searchsorted(seg, torch.arange(n, device=DEV, dtype=torch.int32))
    inv64 = inv.long()
    lib = F.embedding_bag(inv64, rows_u, offsets, mode="sum", per_sample_weights=w)
    check(max_err(lib, rout) <= TOL * scale_of(rout), "embedding_bag yardstick agrees")
    n_ref = int(torch.unique(inv).numel())
    b_ms, b_by = bound(n_ref * DIM * 4 + n * 12 + n * DIM * 4, 2 * n * DIM)
    return {"n": n, "max_abs_err": err,
            "ms": cuda_ms(lambda: ops.gather_pool(rows_u, inv, w, seg, n)),
            "call_ms": cuda_ms(lambda: ops.gather_pool(rows_u, inv, w, seg, n),
                               device_only=False),
            "plain_ms": cuda_ms(lambda: ref.gather_pool_ref(rows_u, inv, w, seg, n)),
            "library_ms": cuda_ms(lambda: F.embedding_bag(
                inv64, rows_u, offsets, mode="sum", per_sample_weights=w)),
            "bound_ms": b_ms, "bound_by": b_by}


def run_fm(b: int, gen: torch.Generator) -> dict:
    x = torch.randn((b, N_FIELDS, DIM), device=DEV, generator=gen) * 0.3
    out, rout = ops.fm_interaction(x), ref.fm_interaction_ref(x)
    torch.cuda.synchronize(DEV)
    err = max_err(out, rout)
    check(err <= TOL * scale_of(rout), f"fm_interaction err {err}")
    b_ms, b_by = bound(x.numel() * 4 + b * 4, b * DIM * (3 * N_FIELDS + 3))
    return {"n": b, "max_abs_err": err,
            "ms": cuda_ms(lambda: ops.fm_interaction(x)),
            "call_ms": cuda_ms(lambda: ops.fm_interaction(x), device_only=False),
            "plain_ms": cuda_ms(lambda: ref.fm_interaction_ref(x)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}


# ------------------------------------------------------------------ phase 3


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):  # EmbeddingState / CacheState
        return type(tree)(*(None if v is None else to_device(v, dev) for v in tree))
    return tree.to(dev)


def warm_tier(serve, state, cfg, rng, n_requests: int):
    """The reference's FCounter warm-up, then one flush loads the L1 tier."""
    for _ in range(n_requests):
        _, ctx = serve.score(state, make_batch(cfg, serve.global_batch, rng))
        for gid, c in ctx.ctxs.items():
            pe.count_frequencies(state["emb"][str(gid)].counts, c)
    state["emb"] = serve.engine.flush(state["emb"])


def hits_of(ctx) -> int:
    return int(sum(int(pe.cache_hit_count(c)) for c in ctx.ctxs.values()))


def serve_full_width() -> dict:
    cfg = get_config("deepfm")
    plan = make_plan(cfg, world=1, per_device_batch=SERVE_B)
    g = plan.groups[0]
    check(len(plan.groups) == 1 and g.rows == FULL_ROWS and plan.cache_rows[0] == HOT_ROWS,
          f"full deepfm plan: {[(x.rows, x.dim) for x in plan.groups]} {plan.cache_rows}")
    model = WDLModel(cfg, plan)
    torch.cuda.reset_peak_memory_stats(DEV)
    t0 = time.perf_counter()
    state = init_state(model, plan, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    torch.cuda.synchronize(DEV)
    init_s = time.perf_counter() - t0
    serve = make_serve_step(model, plan, SERVE_B, ServeConfig(use_fused_kernels="auto"), DEV)
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    warm_tier(serve, state, cfg, rng, 8)
    torch.cuda.synchronize(DEV)
    warm_s = time.perf_counter() - t0
    tier_keys = int((state["emb"]["0"].cache.keys < g.rows).sum())
    batches = [make_batch(cfg, SERVE_B, rng) for _ in range(N_TIMED)]

    ops.reset_launches()
    lat, hits, probs = [], [], None
    for b in batches:
        t0 = time.perf_counter()
        probs, ctx = serve.score(state, b)
        torch.cuda.synchronize(DEV)
        lat.append((time.perf_counter() - t0) * 1e3)
        hits.append(hits_of(ctx))
    launches = dict(ops.launches)

    check(tuple(probs.shape) == (SERVE_B, 1) and bool(torch.isfinite(probs).all()),
          "full-width probabilities finite [B, 1]")
    check(all(v > 0 for v in launches.values()), f"every kernel launched: {launches}")
    check(min(hits) > 0, f"cache hits on every request: {hits}")
    plain = make_serve_step(model, plan, SERVE_B, ServeConfig(use_fused_kernels="off"), DEV)
    p_plain = plain(state, batches[-1])
    torch.cuda.synchronize(DEV)
    err = max_err(probs, p_plain)
    check(err <= TOL, f"kernel vs plain probabilities err {err}")
    breakdown = where_time_goes(serve, state, batches[:10])
    return {"table": [g.rows, g.dim], "hot_rows": plan.cache_rows[0],
            "capacity": plan.capacity[0], "tier_keys_loaded": tier_keys,
            "init_s": init_s, "warmup_and_flush_s": warm_s,
            "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
            "mean_ms": float(np.mean(lat)), "max_ms": float(np.max(lat)),
            "timed_requests": len(lat), "mean_prob": float(probs.mean()),
            "cache_hits_per_request": float(np.mean(hits)),
            "ids_per_request": SERVE_B * N_FIELDS, "launches": launches,
            "plain_vs_kernel_max_abs_err": err,
            "peak_mem_gib": torch.cuda.max_memory_allocated(DEV) / 2**30,
            "where_time_goes": breakdown}


def where_time_goes(serve, state, batches) -> dict:
    """Per-layer host clock (pack -> sparse lookup + pool -> dense), each
    ended by a synchronize, and one profiled window for device time by op."""
    from torch.profiler import ProfilerActivity, profile

    layers = {"pack_ms": [], "sparse_ms": [], "dense_ms": []}
    for b in batches:
        t0 = time.perf_counter()
        packed = serve.pack(b)
        torch.cuda.synchronize(DEV)
        t1 = time.perf_counter()
        pooled, _ = serve.sparse(state, packed)
        torch.cuda.synchronize(DEV)
        t2 = time.perf_counter()
        serve.dense(state, pooled)
        torch.cuda.synchronize(DEV)
        t3 = time.perf_counter()
        for k, v in zip(layers, (t1 - t0, t2 - t1, t3 - t2)):
            layers[k].append(v * 1e3)
    out = {k: float(np.median(v)) for k, v in layers.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches:
            serve(state, b)
        torch.cuda.synchronize(DEV)
    # kernel-level events only: an aten op's device time is its kernels'
    per_kernel = {e.key: e.self_device_time_total / 1e3 / len(batches)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0}
    dev_ms = float(sum(per_kernel.values())) if per_kernel else None
    out["device_ms_per_request"] = dev_ms
    out["kernels_per_request"] = (sum(e.count for e in prof.key_averages()
                                      if e.device_type == torch.autograd.DeviceType.CUDA)
                                  / len(batches))
    out["device_busy_share"] = (dev_ms / (out["pack_ms"] + out["sparse_ms"] + out["dense_ms"])
                                if dev_ms else None)
    out["top_kernels_ms_per_request"] = sorted(
        ((k[:70], v) for k, v in per_kernel.items()), key=lambda kv: -kv[1])[:8]
    return out


def smoke_against_cpu() -> dict:
    """deepfm-smoke with a warm tier: the card's kernel path against the
    CPU's plain path on the same state and request."""
    cfg = get_config("deepfm", smoke=True)
    b = 64
    plan = make_plan(cfg, world=1, per_device_batch=b)
    model = WDLModel(cfg, plan)
    cpu = torch.device("cpu")
    state = init_state(model, plan, torch.Generator().manual_seed(SEED), cpu)
    serve_cpu = make_serve_step(model, plan, b, ServeConfig(), cpu)
    rng = np.random.default_rng(SEED + 1)
    warm_tier(serve_cpu, state, cfg, rng, 4)
    batch = make_batch(cfg, b, rng)
    p_cpu, ctx_cpu = serve_cpu.score(state, batch)
    serve_gpu = make_serve_step(model, plan, b, ServeConfig(use_fused_kernels="on"), DEV)
    p_gpu, ctx_gpu = serve_gpu.score(to_device(state, DEV), batch)
    err = max_err(p_gpu.cpu(), p_cpu)
    check(err <= TOL, f"smoke card vs CPU probabilities err {err}")
    check(hits_of(ctx_gpu) == hits_of(ctx_cpu) > 0, "smoke cache hits equal and > 0")
    return {"max_abs_err": err, "cache_hits": hits_of(ctx_gpu)}


def card_stamp() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an NVIDIA card",
              file=sys.stderr)
        sys.exit(2)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    secs = build.build_all()
    for name in SOURCES:
        build.launcher(name)
        regs = [ln.strip() for ln in build.BUILD_LOG.get(name, "").splitlines()
                if "registers" in ln]
        print(f"[build] {name}: {'; '.join(regs) or 'cached'}", flush=True)
    print(f"[build] {len(SOURCES)} kernels in {secs:.2f}s", flush=True)

    gen = torch.Generator(device=DEV).manual_seed(SEED)
    runners = {"tier_probe": run_tier_probe, "gather_pool": run_gather_pool,
               "fm_interaction": run_fm}
    main_shape = {}
    for name, run in runners.items():
        for label, b in (("serve", SERVE_B), ("bulk", BULK_B)):
            r = run(b, gen)
            print(f"[kernel] {name} {label} " + json.dumps(r), flush=True)
            if label == "serve":
                main_shape[name] = r

    full = serve_full_width()
    print("[serve] deepfm full width " + json.dumps(full), flush=True)
    print(f"[serve] deepfm B={SERVE_B}: p50={full['p50_ms']:.3f}ms "
          f"p99={full['p99_ms']:.3f}ms mean_prob={full['mean_prob']:.4f} "
          f"cache_hits/request={full['cache_hits_per_request']:.1f}", flush=True)
    print("[serve] deepfm-smoke card vs CPU " + json.dumps(smoke_against_cpu()), flush=True)

    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = main_shape[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": full["launches"][name], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(card_stamp(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    main()
