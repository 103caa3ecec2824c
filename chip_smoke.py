#!/usr/bin/env python3
"""On-card check of the PyTorch port: builds its CUDA kernels, holds each one
against its plain PyTorch version, serves and trains full-width deepfm and
full-width dcn-v2 on one card.

    python3 chip_smoke.py

Phases, in order (any failure raises and exits non-zero):

1. build every kernel from ``src/repro_torch/kernels/csrc`` with nvcc (eight
   kernels, one nvcc per source, all at once);
2. run each kernel at its path's shape (serving B = 512, training B = 256)
   and at a bulk shape (B = 65,536) against its plain version on the same
   inputs: ``hit``/``slot`` bitwise, rows/bags/FM/gradients/updated rows/
   cross outputs and all four cross cotangents to max-abs <= 1e-5 of the
   value scale, miss rows, empty bags, unused gradient slots exactly 0,
   rows ``dedup_adagrad`` does not touch bitwise unchanged, the cross
   backward repeating bit for bit; time kernel, plain version and, where
   one PyTorch call computes the same function, that call (CUDA events,
   median of 30 after warm-up) beside the byte/op bound. The embedding
   kernels run again at dcn-v2's D = 16 and n = B x 26 on its table;
3. serve full-width deepfm (187,780,711 x 10 table, 4,194,304-row hot tier,
   B = 512) through ``make_serve_step``: 8 warm-up requests feed the
   FCounter, ``engine.flush`` loads the tier, then 300 timed requests with
   the kernel launch counters reset just before and read just after; one
   request with the plain versions must give the same probabilities; a
   deepfm-smoke request served on the card must match the CPU;
4. train full-width deepfm on the train launcher's plan (B = 256, flush
   every 20 steps after 10) through ``make_train_step``: 30 steps from seed
   0 with the launch counters reset just before and read just after; every
   loss finite, every kernel of the path launched, tier hits on every step
   after the step-20 flush; a second kernel run repeats the first bit for
   bit; the same 30 steps on the plain versions (under deterministic
   algorithms) give the same losses (rtol 1e-4 / atol 1e-5, the JAX
   package's fused-vs-plain bar) and the same hits; then per-stage host
   clock, a profiled window and peak memory; a deepfm-smoke training run on
   the card must match the CPU;
5. free the deepfm states and serve full-width dcn-v2 (187,767,399 x 16
   table, 13 dense features, three cross layers over the 429-wide base,
   MLP 1024-1024-512) as in phase 3: ``cross_layer`` launched 3 times per
   request, tier hits on every request, the plain path's probabilities
   within 1e-5, a dcn-v2-smoke request on the card matching the CPU;
6. train full-width dcn-v2 as in phase 4: ``cross_layer`` and
   ``cross_layer_bwd`` 3 times per step, hits after the flush, the kernel
   path repeating bit for bit, and at steps 1 and 21 one kernel step and
   one plain step from copies of the same state agreeing in loss (rtol
   1e-5) and in every dense gradient (1e-5 of the leaf's largest entry);
   the 30-step kernel vs deterministic-plain loss difference is printed, not
   held to a bar (past the flush it depends on the data, ``PERF.md`` §6);
   a dcn-v2-smoke training run on the card must match the CPU.

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
from typing import Dict, NamedTuple, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config, get_shapes  # noqa: E402
from repro_torch.core import packed_embedding as pe  # noqa: E402
from repro_torch.core.packing import make_plan  # noqa: E402
from repro_torch.data.synthetic import batch_stream, make_batch  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.models.wdl import WDLModel  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402
from repro_torch.serve.serve_step import ServeConfig, init_state, make_serve_step  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
TOL = 1e-5
SEED = 0
SPIN_CYCLES = 2_000_000  # ~1 ms at H100 clocks: longer than any timed call's enqueue
# the registry's serve_p99 request (B = 512); the bulk shape is 128x that
SERVE_B = next(s["batch"] for s in get_shapes("deepfm") if s.name == "serve_p99")
# the train launcher's default --global-batch and its full-width plan
TRAIN_B, TRAIN_STEPS, FLUSH_ITERS, WARMUP_ITERS = 256, 30, 20, 10
BULK_B = 65_536
LR, EPS = 0.05, 1e-8  # TrainConfig's lr_emb and eps
N_TIMED = 300  # timed requests: enough that p99 is not the maximum
CROSS_D = 26 * 16 + 13  # dcn-v2's base: 26 fields at dim 16 + 13 dense features
DEV = torch.device("cuda", 0)


class Arch(NamedTuple):
    """A full-width arch's packed table, the kernel launches of its two
    paths, and how its 30-step training run is held against the plain
    path."""

    name: str
    n_fields: int
    dim: int
    rows: int
    hot_rows: int
    serve_launches: Dict[str, int]  # per request; every other kernel 0
    train_launches: Dict[str, int]  # per step; every other kernel 0
    trajectory_bar: bool            # hold the 30 losses to rtol 1e-4 / atol 1e-5
    shared_state_at: Tuple[int, ...]  # steps preceded by the shared-state check


_EMB = {"tier_probe": 1, "gather_pool": 1}
ARCHS = {
    "deepfm": Arch("deepfm", 39, 10, 187_780_711, 4_194_304,
                   {**_EMB, "fm_interaction": 1},
                   {**_EMB, "fm_interaction": 1, "segment_grad": 1, "dedup_adagrad": 1,
                    "fm_interaction_bwd": 1}, True, ()),
    # three cross layers: three forward and three backward launches
    "dcn-v2": Arch("dcn-v2", 26, 16, 187_767_399, 4_194_304,
                   {**_EMB, "cross_layer": 3},
                   {**_EMB, "cross_layer": 3, "segment_grad": 1, "dedup_adagrad": 1,
                    "cross_layer_bwd": 3}, False, (1, FLUSH_ITERS + 1)),
}

SOURCES = {
    "tier_probe": ("src/repro_torch/kernels/csrc/tier_probe.cu",
                   "src/repro/kernels/fused_embedding.py:279"),
    "gather_pool": ("src/repro_torch/kernels/csrc/gather_pool.cu",
                    "src/repro/kernels/fused_embedding.py:81"),
    "fm_interaction": ("src/repro_torch/kernels/csrc/fm_interaction.cu",
                       "src/repro/kernels/fm_interaction.py:24"),
    "segment_grad": ("src/repro_torch/kernels/csrc/segment_grad.cu",
                     "src/repro/kernels/fused_embedding.py:111"),
    "dedup_adagrad": ("src/repro_torch/kernels/csrc/dedup_adagrad.cu",
                      "src/repro/kernels/fused_embedding.py:194"),
    "fm_interaction_bwd": ("src/repro_torch/kernels/csrc/fm_interaction_bwd.cu",
                           "src/repro/kernels/interaction_bwd.py:43"),
    "cross_layer": ("src/repro_torch/kernels/csrc/cross_layer.cu",
                    "src/repro/kernels/cross_layer.py:30"),
    "cross_layer_bwd": ("src/repro_torch/kernels/csrc/cross_layer_bwd.cu",
                        "src/repro/kernels/interaction_bwd.py:147"),
}
# the arch whose serving or training path each kernel was ported for
PORTED_FOR = {"tier_probe": ("deepfm", "serve"), "gather_pool": ("deepfm", "serve"),
              "fm_interaction": ("deepfm", "serve"), "segment_grad": ("deepfm", "train"),
              "dedup_adagrad": ("deepfm", "train"),
              "fm_interaction_bwd": ("deepfm", "train"),
              "cross_layer": ("dcn-v2", "serve"), "cross_layer_bwd": ("dcn-v2", "train")}


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


def probe_case(b: int, gen: torch.Generator, a: Arch):
    """Sorted unique queries of a B-sample request, about half of them tier
    keys, against a full 4,194,304-key tier over the full table's rows."""
    n = b * a.n_fields
    stride = a.rows // a.hot_rows
    keys = (torch.arange(a.hot_rows, device=DEV, dtype=torch.int64) * stride
            + torch.randint(0, stride, (a.hot_rows,), device=DEV, generator=gen)
            ).to(torch.int32)
    rows = torch.randn((a.hot_rows, a.dim), device=DEV, generator=gen)
    half = n // 2
    ids = torch.cat([keys[torch.randint(0, a.hot_rows, (half,), device=DEV, generator=gen)],
                     torch.randint(0, a.rows, (n - half,), device=DEV, generator=gen,
                                   dtype=torch.int32)])
    u = pe.fixed_unique(ids.to(torch.int32), sentinel=a.rows)
    return u.uniq, u.uvalid, keys, rows


def run_tier_probe(b: int, gen: torch.Generator, a: Arch) -> dict:
    uniq, uvalid, keys, rows = probe_case(b, gen, a)
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
    nbytes = n * (4 + 1) + keys_read * 4 + n_hit * a.dim * 4 + n * (1 + 4 + a.dim * 4)
    b_ms, b_by = bound(nbytes, 0)
    return {"n": n, "hits": n_hit, "max_abs_err": err,
            "ms": cuda_ms(lambda: ops.tier_probe(uniq, uvalid, keys, rows)),
            "call_ms": cuda_ms(lambda: ops.tier_probe(uniq, uvalid, keys, rows),
                               device_only=False),
            "plain_ms": cuda_ms(lambda: ref.tier_probe_ref(uniq, uvalid, keys, rows)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}


def run_gather_pool(b: int, gen: torch.Generator, a: Arch) -> dict:
    """The packed layout of deepfm and dcn-v2: one bag per (sample, field),
    seg = arange."""
    n = b * a.n_fields
    ids = torch.randint(0, max(n // 2, 1), (n,), device=DEV, generator=gen, dtype=torch.int32)
    inv = pe.fixed_unique(ids, sentinel=n).inv
    rows_u = torch.randn((n, a.dim), device=DEV, generator=gen)
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
    b_ms, b_by = bound(n_ref * a.dim * 4 + n * 12 + n * a.dim * 4, 2 * n * a.dim)
    return {"n": n, "max_abs_err": err,
            "ms": cuda_ms(lambda: ops.gather_pool(rows_u, inv, w, seg, n)),
            "call_ms": cuda_ms(lambda: ops.gather_pool(rows_u, inv, w, seg, n),
                               device_only=False),
            "plain_ms": cuda_ms(lambda: ref.gather_pool_ref(rows_u, inv, w, seg, n)),
            "library_ms": cuda_ms(lambda: F.embedding_bag(
                inv64, rows_u, offsets, mode="sum", per_sample_weights=w)),
            "bound_ms": b_ms, "bound_by": b_by}


def run_fm(b: int, gen: torch.Generator, a: Arch) -> dict:
    x = torch.randn((b, a.n_fields, a.dim), device=DEV, generator=gen) * 0.3
    out, rout = ops.fm_interaction(x), ref.fm_interaction_ref(x)
    torch.cuda.synchronize(DEV)
    err = max_err(out, rout)
    check(err <= TOL * scale_of(rout), f"fm_interaction err {err}")
    b_ms, b_by = bound(x.numel() * 4 + b * 4, b * a.dim * (3 * a.n_fields + 3))
    return {"n": b, "max_abs_err": err,
            "ms": cuda_ms(lambda: ops.fm_interaction(x)),
            "call_ms": cuda_ms(lambda: ops.fm_interaction(x), device_only=False),
            "plain_ms": cuda_ms(lambda: ref.fm_interaction_ref(x)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}


def run_segment_grad(b: int, gen: torch.Generator, a: Arch) -> dict:
    """The packed layout (one bag per (sample, field), seg = arange): the bag
    gradients back onto the unique-row slots of a fixed unique."""
    n = b * a.n_fields
    ids = torch.randint(0, max(n // 2, 1), (n,), device=DEV, generator=gen, dtype=torch.int32)
    u = pe.fixed_unique(ids, sentinel=n)
    inv, n_uniq = u.inv, int(u.n_uniq)
    g_bags = torch.randn((n, a.dim), device=DEV, generator=gen)
    w = torch.rand((n,), device=DEV, generator=gen) + 0.5
    seg = torch.arange(n, device=DEV, dtype=torch.int32)
    out = ops.segment_grad(g_bags, seg, w, inv, n)
    rout = ref.segment_grad_ref(g_bags, seg, w, inv, n)
    torch.cuda.synchronize(DEV)
    err = max_err(out, rout)
    check(err <= TOL * scale_of(rout), f"segment_grad err {err}")
    check(n_uniq < n and bool((out[n_uniq:] == 0).all()),
          "segment_grad unused slots exactly 0")
    # the library yardstick: embedding_bag's backward onto its weight
    rows_u = torch.randn((n, a.dim), device=DEV, generator=gen).requires_grad_(True)
    offsets = torch.arange(n, device=DEV)
    lib_out = F.embedding_bag(inv.long(), rows_u, offsets, mode="sum", per_sample_weights=w)

    def lib():
        return torch.autograd.grad(lib_out, rows_u, g_bags, retain_graph=True)[0]

    check(max_err(lib(), rout) <= TOL * scale_of(rout), "embedding_bag backward agrees")
    b_ms, b_by = bound(n * a.dim * 4 + n * 12 + n * a.dim * 4, 2 * n * a.dim)
    return {"n": n, "n_uniq": n_uniq, "max_abs_err": err,
            "ms": cuda_ms(lambda: ops.segment_grad(g_bags, seg, w, inv, n)),
            "call_ms": cuda_ms(lambda: ops.segment_grad(g_bags, seg, w, inv, n),
                               device_only=False),
            "plain_ms": cuda_ms(lambda: ref.segment_grad_ref(g_bags, seg, w, inv, n)),
            "library_ms": cuda_ms(lib), "bound_ms": b_ms, "bound_by": b_by}


_TABLES = {}


def full_tables(gen: torch.Generator, a: Arch):
    """Two identical full-width tables + accumulators of ``a`` (kernel and
    plain version each update one in place), made once for both shapes."""
    if _TABLES.get("arch") != a:
        _TABLES.clear()
        torch.cuda.empty_cache()
        w = torch.randn((a.rows, a.dim), device=DEV, generator=gen)
        acc = torch.rand((a.rows, 1), device=DEV, generator=gen)
        _TABLES.update(arch=a, w_k=w, acc_k=acc, w_p=w.clone(), acc_p=acc.clone())
    return _TABLES


def run_dedup_adagrad(b: int, gen: torch.Generator, a: Arch) -> dict:
    """The miss-gradient update of a B-sample step: m = the plan's bucket
    capacity gradient rows into the arch's full table, a quarter of them
    duplicates of other rows and a tenth invalid slots that point at row 0
    (the clamped ``recv_local`` of an empty bucket slot)."""
    m = make_plan(get_config(a.name), world=1, per_device_batch=b).capacity[0]
    t = full_tables(gen, a)
    w_k, acc_k, w_p, acc_p = t["w_k"], t["acc_k"], t["w_p"], t["acc_p"]
    idx = torch.randint(0, a.rows, (m,), device=DEV, generator=gen, dtype=torch.int32)
    dup = torch.randperm(m, device=DEV, generator=gen)[: m // 4]
    idx[dup] = idx[torch.randint(0, m, (dup.numel(),), device=DEV, generator=gen)]
    valid = torch.rand((m,), device=DEV, generator=gen) >= 0.1
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    g = torch.randn((m, a.dim), device=DEV, generator=gen)
    touched = torch.unique(idx[valid]).long()
    u = touched.numel()
    w_p.copy_(w_k)  # the previous shape's timing moved the two apart
    acc_p.copy_(acc_k)
    w0, acc0 = w_k[touched].clone(), acc_k[touched].clone()
    ops.dedup_adagrad(w_k, acc_k, idx, g, valid, LR, EPS)
    ref.dedup_adagrad_ref(w_p, acc_p, idx, g, valid, LR, EPS)
    torch.cuda.synchronize(DEV)
    err = max(max_err(w_k[touched], w_p[touched]), max_err(acc_k[touched], acc_p[touched]))
    check(err <= TOL * scale_of(w_p[touched]), f"dedup_adagrad touched rows err {err}")
    check(not torch.equal(w_k[touched], w0), "dedup_adagrad moved the touched rows")
    # every other row of the full table: put the touched rows back, then the
    # kernel's table must equal the plain version's bit for bit
    for tw, ta in ((w_k, acc_k), (w_p, acc_p)):
        tw[touched], ta[touched] = w0, acc0
    check(torch.equal(w_k, w_p) and torch.equal(acc_k, acc_p),
          "dedup_adagrad untouched rows bitwise unchanged")
    # inputs once (idx, valid, g), touched rows of w and acc read and written
    nbytes = m * (4 + 1 + a.dim * 4) + u * (a.dim * 4 + 4) * 2
    b_ms, b_by = bound(nbytes, m * a.dim + u * (3 * a.dim + 4))
    return {"m": m, "rows": a.rows, "touched_rows": u, "max_abs_err": err,
            "ms": cuda_ms(lambda: ops.dedup_adagrad(w_k, acc_k, idx, g, valid, LR, EPS)),
            "call_ms": cuda_ms(lambda: ops.dedup_adagrad(w_k, acc_k, idx, g, valid, LR, EPS),
                               device_only=False),
            "plain_ms": cuda_ms(lambda: ref.dedup_adagrad_ref(w_p, acc_p, idx, g, valid,
                                                              LR, EPS)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}


def run_fm_bwd(b: int, gen: torch.Generator, a: Arch) -> dict:
    x = torch.randn((b, a.n_fields, a.dim), device=DEV, generator=gen) * 0.3
    g = torch.randn((b, 1), device=DEV, generator=gen)
    out, rout = ops.fm_interaction_bwd(x, g), ref.fm_interaction_bwd_ref(x, g)
    torch.cuda.synchronize(DEV)
    err = max_err(out, rout)
    check(err <= TOL * scale_of(rout), f"fm_interaction_bwd err {err}")
    b_ms, b_by = bound(2 * x.numel() * 4 + b * 4, 3 * x.numel())
    return {"n": b, "max_abs_err": err,
            "ms": cuda_ms(lambda: ops.fm_interaction_bwd(x, g)),
            "call_ms": cuda_ms(lambda: ops.fm_interaction_bwd(x, g), device_only=False),
            "plain_ms": cuda_ms(lambda: ref.fm_interaction_bwd_ref(x, g)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}


def cross_case(b: int, gen: torch.Generator):
    """dcn-v2's cross layer at batch b: x0, x [b, 429], W [429, 429] at the
    reference's init scale, a bias and a cotangent."""
    d = CROSS_D
    x0 = torch.randn((b, d), device=DEV, generator=gen)
    x = torch.randn((b, d), device=DEV, generator=gen)
    w = torch.randn((d, d), device=DEV, generator=gen) / d ** 0.5
    bias = torch.randn((d,), device=DEV, generator=gen) * 0.1
    g = torch.randn((b, d), device=DEV, generator=gen)
    return x0, x, w, bias, g


def run_cross(b: int, gen: torch.Generator, a: Arch) -> dict:
    x0, x, w, bias, _ = cross_case(b, gen)
    d = CROSS_D
    out, rout = ops.cross_layer(x0, x, w, bias), ref.cross_layer_ref(x0, x, w, bias)
    lib = torch.addcmul(x, x0, torch.addmm(bias, x, w))
    torch.cuda.synchronize(DEV)
    err = max_err(out, rout)
    check(err <= TOL * scale_of(rout), f"cross_layer err {err}")
    check(max_err(lib, rout) <= TOL * scale_of(rout), "addmm + addcmul yardstick agrees")
    b_ms, b_by = bound((3 * b * d + d * d + d) * 4, 2 * b * d * d + 3 * b * d)
    return {"n": b, "d": d, "max_abs_err": err, "max_err_of_scale": err / scale_of(rout),
            "ms": cuda_ms(lambda: ops.cross_layer(x0, x, w, bias)),
            "call_ms": cuda_ms(lambda: ops.cross_layer(x0, x, w, bias), device_only=False),
            "plain_ms": cuda_ms(lambda: ref.cross_layer_ref(x0, x, w, bias)),
            # two calls, timed together: torch.addmm then torch.addcmul
            "library_ms": cuda_ms(lambda: torch.addcmul(x, x0, torch.addmm(bias, x, w))),
            "bound_ms": b_ms, "bound_by": b_by}


def run_cross_bwd(b: int, gen: torch.Generator, a: Arch) -> dict:
    x0, x, w, bias, g = cross_case(b, gen)
    d = CROSS_D
    got = ops.cross_layer_bwd(x0, x, w, bias, g)
    again = ops.cross_layer_bwd(x0, x, w, bias, g)
    exp = ref.cross_layer_bwd_ref(x0, x, w, bias, g)
    # the library yardstick: autograd of addmm + addcmul (three cuBLAS GEMMs)
    leaves = [t.clone().requires_grad_(True) for t in (x0, x, w, bias)]
    lib_out = torch.addcmul(leaves[1], leaves[0], torch.addmm(leaves[3], leaves[1], leaves[2]))

    def lib():
        return torch.autograd.grad(lib_out, leaves, g, retain_graph=True)

    torch.cuda.synchronize(DEV)
    errs = {}  # each cotangent's max-abs error, as a share of its scale
    for name, k, e, lb in zip(("gx0", "gx", "gw", "gb"), got, exp, lib()):
        errs[name] = max_err(k, e) / scale_of(e)
        check(errs[name] <= TOL, f"cross_layer_bwd {name} err {errs[name]} of scale")
        check(max_err(lb, e) <= TOL * scale_of(e), f"autograd yardstick {name} agrees")
    check(all(torch.equal(p, q) for p, q in zip(got, again)),
          "cross_layer_bwd repeats bit for bit")
    b_ms, b_by = bound((5 * b * d + 2 * d * d + 2 * d) * 4, 6 * b * d * d + 5 * b * d)
    return {"n": b, "d": d, "splits": ops.cross_bwd_split(b)[1],
            "max_abs_err": max(max_err(k, e) for k, e in zip(got, exp)),
            "max_err_of_scale": max(errs.values()), "errs_of_scale": errs,
            "ms": cuda_ms(lambda: ops.cross_layer_bwd(x0, x, w, bias, g)),
            "call_ms": cuda_ms(lambda: ops.cross_layer_bwd(x0, x, w, bias, g),
                               device_only=False),
            "plain_ms": cuda_ms(lambda: ref.cross_layer_bwd_ref(x0, x, w, bias, g)),
            "library_ms": cuda_ms(lib), "bound_ms": b_ms, "bound_by": b_by}


# ------------------------------------------------------------------ phase 3


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):  # EmbeddingState / CacheState
        return type(tree)(*(to_device(v, dev) for v in tree))
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def warm_tier(serve, state, cfg, rng, n_requests: int):
    """The reference's FCounter warm-up, then one flush loads the L1 tier."""
    for _ in range(n_requests):
        _, ctx = serve.score(state, make_batch(cfg, serve.global_batch, rng))
        for gid, c in ctx.ctxs.items():
            pe.count_frequencies(state["emb"][str(gid)].counts, c)
    state["emb"] = serve.engine.flush(state["emb"])


def hits_of(ctx) -> int:
    return int(sum(int(pe.cache_hit_count(c)) for c in ctx.ctxs.values()))


def serve_full_width(arch: str) -> dict:
    a = ARCHS[arch]
    cfg = get_config(arch)
    plan = make_plan(cfg, world=1, per_device_batch=SERVE_B)
    g = plan.groups[0]
    check(len(plan.groups) == 1 and (g.rows, g.dim) == (a.rows, a.dim)
          and plan.cache_rows[0] == a.hot_rows,
          f"full {arch} plan: {[(x.rows, x.dim) for x in plan.groups]} {plan.cache_rows}")
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
    check(launches == {n: a.serve_launches.get(n, 0) * N_TIMED for n in launches},
          f"{arch} serving launches per request {a.serve_launches}: {launches}")
    check(min(hits) > 0, f"cache hits on every request: {hits}")
    plain = make_serve_step(model, plan, SERVE_B, ServeConfig(use_fused_kernels="off"), DEV)
    p_plain = plain(state, batches[-1])
    torch.cuda.synchronize(DEV)
    err = max_err(probs, p_plain)
    check(err <= TOL, f"kernel vs plain probabilities err {err}")
    breakdown = where_time_goes(serve, state, batches[:10])
    out = {"arch": arch, "table": [g.rows, g.dim], "hot_rows": plan.cache_rows[0],
           "capacity": plan.capacity[0], "tier_keys_loaded": tier_keys,
           "init_s": init_s, "warmup_and_flush_s": warm_s,
           "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
           "mean_ms": float(np.mean(lat)), "max_ms": float(np.max(lat)),
           "timed_requests": len(lat), "mean_prob": float(probs.mean()),
           "cache_hits_per_request": float(np.mean(hits)),
           "ids_per_request": SERVE_B * a.n_fields, "launches": launches,
           "launches_per_request": {n: v / N_TIMED for n, v in launches.items() if v},
           "plain_vs_kernel_max_abs_err": err,
           "peak_mem_gib": torch.cuda.max_memory_allocated(DEV) / 2**30,
           "where_time_goes": breakdown}
    del state, serve, plain
    torch.cuda.empty_cache()
    return out


def where_time_goes(serve, state, batches) -> dict:
    """Per-layer host clock (pack -> sparse lookup + pool -> dense), each
    ended by a synchronize, and one profiled window for device time by op."""
    from torch.profiler import ProfilerActivity, profile

    layers = {"pack_ms": [], "sparse_ms": [], "dense_ms": []}
    for b in batches:
        t0 = time.perf_counter()
        packed, dense_x = serve.pack(b)
        torch.cuda.synchronize(DEV)
        t1 = time.perf_counter()
        pooled, _ = serve.sparse(state, packed)
        torch.cuda.synchronize(DEV)
        t2 = time.perf_counter()
        serve.dense(state, pooled, dense_x)
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


def smoke_against_cpu(arch: str) -> dict:
    """The arch's smoke config with a warm tier: the card's kernel path
    against the CPU's plain path on the same state and request."""
    cfg = get_config(arch, smoke=True)
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
    ops.reset_launches()
    serve_gpu = make_serve_step(model, plan, b, ServeConfig(use_fused_kernels="on"), DEV)
    p_gpu, ctx_gpu = serve_gpu.score(to_device(state, DEV), batch)
    err = max_err(p_gpu.cpu(), p_cpu)
    check(err <= TOL, f"smoke card vs CPU probabilities err {err}")
    check(hits_of(ctx_gpu) == hits_of(ctx_cpu) > 0, "smoke cache hits equal and > 0")
    check(all(ops.launches[n] > 0 for n in ARCHS[arch].serve_launches),
          f"smoke request on the card went through the kernels: {ops.launches}")
    return {"max_abs_err": err, "cache_hits": hits_of(ctx_gpu)}


# ------------------------------------------------------------------ phase 4


def train_plan(cfg):
    return make_plan(cfg, world=1, per_device_batch=TRAIN_B, hot_bytes=1 << 30,
                     flush_iters=FLUSH_ITERS, warmup_iters=WARMUP_ITERS)


def clone(tree):
    """A copy of a train state whose tensors share no storage with it."""
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):  # EmbeddingState / CacheState
        return type(tree)(*(clone(v) for v in tree))
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def shared_state_check(model, plan, step, state, batch) -> dict:
    """One step on the kernel path and one on the plain path, each from its
    own copy of ``state`` on the same batch: the loss to rtol 1e-5, every
    dense gradient to 1e-5 of its leaf's largest entry. The dense stage's
    outputs are read through a wrapper around ``TrainStep.dense``."""
    plain = ts.make_train_step(model, plan, TRAIN_B,
                               ts.TrainConfig(use_fused_kernels="off"), DEV)
    seen = {}
    for name, st in (("kernel", step), ("plain", plain)):
        def dense(*args, _orig=st.dense, _name=name):
            seen[_name] = _orig(*args)
            return seen[_name]

        st.dense = dense
        try:
            copy = clone(state)
            st(copy, batch)
            del copy
        finally:
            del st.dense
    torch.cuda.synchronize(DEV)
    (lk, gk, pk), (lp, gp, pp) = seen["kernel"], seen["plain"]
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    check(loss_rel <= 1e-5, f"shared-state loss kernel {float(lk)} vs plain {float(lp)}")
    leaf_err = {}
    for path, a, b in zip(leaf_names(gp), tree_leaves(gk), tree_leaves(gp)):
        top = float(b.abs().max())
        leaf_err[path] = max_err(a, b) / top if top > 0 else max_err(a, b)
        check(leaf_err[path] <= TOL, f"shared-state dense gradient {path}: "
              f"{leaf_err[path]} of its largest entry")
    pooled_err = max(max_err(pk[k], pp[k]) / max(float(pp[k].abs().max()), 1e-30)
                     for k in pp)
    torch.cuda.empty_cache()
    return {"loss_kernel": float(lk), "loss_plain": float(lp), "loss_rel_diff": loss_rel,
            "max_dense_grad_rel_err": max(leaf_err.values()),
            "worst_leaf": max(leaf_err, key=leaf_err.get),
            "pooled_grad_rel_err": pooled_err}


def leaf_names(tree, prefix=""):
    """Dotted paths of a nested dict's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in tree for p in leaf_names(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def train_run(arch: str, fused: str, batches, breakdown: bool = False,
              check_at: Tuple[int, ...] = ()) -> dict:
    """30 full-width training steps from seed 0; the state is freed after.
    Before each step in ``check_at`` (1-based) the shared-state check runs on
    copies, outside the timed step, and leaves this run's state alone."""
    cfg = get_config(arch)
    plan = train_plan(cfg)
    model = WDLModel(cfg, plan)
    torch.cuda.reset_peak_memory_stats(DEV)
    state = ts.init_state(model, plan, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    step = ts.make_train_step(model, plan, TRAIN_B,
                              ts.TrainConfig(use_fused_kernels=fused), DEV)
    torch.cuda.synchronize(DEV)
    ops.reset_launches()
    lat, losses, hits, ovf, checks = [], [], [], [], {}
    for i, b in enumerate(batches[:TRAIN_STEPS], start=1):
        if i in check_at:
            checks[i] = shared_state_check(model, plan, step, state, b)
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize(DEV)
        lat.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        hits.append(int(m["cache_hits"]))
        ovf.append(int(m["overflow"]))
    out = {"launches": dict(ops.launches), "lat": lat, "losses": losses, "hits": hits,
           "overflow": ovf, "shared_state_checks": checks}
    if breakdown:
        out["stages"] = train_breakdown(step, state, batches[TRAIN_STEPS:])
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated(DEV) / 2**30
    del state, step
    torch.cuda.empty_cache()
    return out


def train_breakdown(step, state, batches) -> dict:
    """Steps 31-35 under the profiler (device time by kernel), then steps
    36-39 with the clock read after each named stage (each ended by a
    synchronize). None of them flushes: the next flush is step 40."""
    from torch.profiler import ProfilerActivity, profile

    prof_batches, stage_batches = batches[:5], batches[5:9]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in prof_batches:
            step(state, b)
        torch.cuda.synchronize(DEV)
    stages, last = {}, [0.0]

    def mark(name):
        torch.cuda.synchronize(DEV)
        now = time.perf_counter()
        stages.setdefault(name, []).append((now - last[0]) * 1e3)
        last[0] = now

    step.on_stage = mark
    for b in stage_batches:
        last[0] = time.perf_counter()
        step(state, b)
    step.on_stage = None
    out = {f"{k}_ms": float(np.median(v)) for k, v in stages.items()}
    host_ms = sum(out.values())
    per_kernel = {e.key: e.self_device_time_total / 1e3 / len(prof_batches)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0}
    dev_ms = float(sum(per_kernel.values())) if per_kernel else None
    out["host_ms_per_step"] = host_ms
    out["device_ms_per_step"] = dev_ms
    out["kernels_per_step"] = (sum(e.count for e in prof.key_averages()
                                   if e.device_type == torch.autograd.DeviceType.CUDA)
                               / len(prof_batches))
    out["device_busy_share"] = dev_ms / host_ms if dev_ms else None
    out["top_kernels_ms_per_step"] = sorted(
        ((k[:70], v) for k, v in per_kernel.items()), key=lambda kv: -kv[1])[:10]
    return out


def train_full_width(arch: str) -> dict:
    a = ARCHS[arch]
    cfg = get_config(arch)
    plan = train_plan(cfg)
    g = plan.groups[0]
    check(len(plan.groups) == 1 and (g.rows, g.dim) == (a.rows, a.dim)
          and plan.cache_rows[0] == a.hot_rows
          and plan.microbatch == TRAIN_B and len(plan.interleave) == 1,
          f"full {arch} train plan: {g.rows} {plan.cache_rows} {plan.microbatch} "
          f"{plan.interleave}")
    stream = batch_stream(cfg, TRAIN_B, seed=SEED)
    batches = [next(stream) for _ in range(TRAIN_STEPS + 9)]
    k = train_run(arch, "auto", batches, breakdown=True)
    launches = k["launches"]
    check(all(np.isfinite(k["losses"])), f"finite losses: {k['losses']}")
    check(launches == {n: a.train_launches.get(n, 0) * TRAIN_STEPS for n in launches},
          f"{arch} training launches per step {a.train_launches}: {launches}")
    check(min(k["hits"][FLUSH_ITERS:]) > 0 and max(k["hits"][:FLUSH_ITERS]) == 0,
          f"tier hits exactly on the steps after the step-{FLUSH_ITERS} flush: {k['hits']}")
    # the kernels sum in a fixed order, so the kernel path repeats itself;
    # the second run also holds one kernel step against one plain step from
    # a shared state where the arch asks (dcn-v2: before step 1 and before
    # the first step after the flush)
    k2 = train_run(arch, "auto", batches, check_at=a.shared_state_at)
    check(k2["losses"] == k["losses"] and k2["hits"] == k["hits"],
          "a second kernel run repeats the first bit for bit")
    # The plain versions' index_add_ sums with atomics, in an order that can
    # change from run to run, and past the flush this model amplifies any
    # last-bit difference by orders of magnitude within a few steps
    # (scripts/torch_train_divergence.py measures it). Deterministic
    # algorithms fix the plain path's order, so the comparison below holds
    # the kernels against one reproducible plain trajectory.
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        p = train_run(arch, "off", batches)
    finally:
        torch.use_deterministic_algorithms(False)
    check(all(v == 0 for v in p["launches"].values()), f"plain run launched: {p['launches']}")
    diff = np.abs(np.array(k["losses"]) - np.array(p["losses"]))
    if a.trajectory_bar:
        check(np.allclose(k["losses"], p["losses"], rtol=1e-4, atol=1e-5),
              f"kernel vs plain loss trajectory: {k['losses']} vs {p['losses']}")
    check(k["hits"] == p["hits"] and k["overflow"] == p["overflow"],
          "kernel vs plain hits and overflow equal")
    lat = np.array(k["lat"])
    steady = np.array([t for i, t in enumerate(lat, start=1)
                       if i > WARMUP_ITERS and i != FLUSH_ITERS])
    return {"arch": arch, "table": [g.rows, g.dim], "hot_rows": plan.cache_rows[0],
            "capacity": plan.capacity[0], "batch": TRAIN_B, "steps": TRAIN_STEPS,
            "step_p50_ms": float(np.percentile(steady, 50)),
            "step_p99_ms": float(np.percentile(steady, 99)),
            "step_mean_ms": float(steady.mean()), "steady_steps": int(steady.size),
            "samples_per_s": float(TRAIN_B / (steady.mean() / 1e3)),
            "flush_step_ms": float(lat[FLUSH_ITERS - 1]), "first_step_ms": float(lat[0]),
            "plain_step_p50_ms": float(np.percentile(
                [t for i, t in enumerate(p["lat"], start=1)
                 if i > WARMUP_ITERS and i != FLUSH_ITERS], 50)),
            "step_ms": k["lat"], "losses": k["losses"], "plain_losses": p["losses"],
            "max_abs_loss_diff": float(diff.max()),
            "max_rel_loss_diff": float((diff / np.abs(p["losses"])).max()),
            "shared_state_checks": k2["shared_state_checks"], "hits": k["hits"],
            "overflow": k["overflow"], "launches": launches,
            "launches_per_step": {n: v / TRAIN_STEPS for n, v in launches.items() if v},
            "peak_mem_gib": k["peak_mem_gib"], "where_time_goes": k["stages"]}


def train_smoke_against_cpu(arch: str) -> dict:
    """The arch's smoke config with a tiny tier flushed at step 3: 8 steps on
    the card's kernels against 8 on the CPU's plain versions, same state and
    batches."""
    cfg = get_config(arch, smoke=True)
    b = 64
    plan = make_plan(cfg, world=1, per_device_batch=b, hot_bytes=1 << 14, flush_iters=3,
                     warmup_iters=2)
    model = WDLModel(cfg, plan)
    cpu = torch.device("cpu")
    state_cpu, state_gpu = (
        ts.init_state(model, plan, torch.Generator().manual_seed(SEED), cpu) for _ in "ab")
    state_gpu = to_device(state_gpu, DEV)
    step_cpu = ts.make_train_step(model, plan, b, ts.TrainConfig(), cpu)
    step_gpu = ts.make_train_step(model, plan, b, ts.TrainConfig(use_fused_kernels="on"), DEV)
    rng = np.random.default_rng(SEED + 2)
    lc, lg, hc, hg = [], [], [], []
    for _ in range(8):
        batch = make_batch(cfg, b, rng)
        state_gpu, mg = step_gpu(state_gpu, batch)
        state_cpu, mc = step_cpu(state_cpu, batch)
        lg.append(float(mg["loss"]))
        lc.append(float(mc["loss"]))
        hg.append(int(mg["cache_hits"]))
        hc.append(int(mc["cache_hits"]))
    check(np.allclose(lg, lc, rtol=1e-4, atol=1e-5), f"smoke train card vs CPU: {lg} vs {lc}")
    check(hg == hc and min(hg[3:]) > 0, f"smoke train hits equal and > 0 after flush: {hg} {hc}")
    err = max_err(state_gpu["emb"]["0"].w.cpu(), state_cpu["emb"]["0"].w)
    check(err <= 1e-4, f"smoke train table card vs CPU err {err}")
    return {"losses_card": lg, "losses_cpu": lc,
            "max_abs_loss_diff": float(np.max(np.abs(np.array(lg) - np.array(lc)))),
            "table_max_abs_err": err, "hits": hg}


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
    # name -> (runner, arch, path, the path's batch); each also runs at bulk
    runners = {"tier_probe": (run_tier_probe, "deepfm", "serve", SERVE_B),
               "gather_pool": (run_gather_pool, "deepfm", "serve", SERVE_B),
               "fm_interaction": (run_fm, "deepfm", "serve", SERVE_B),
               "segment_grad": (run_segment_grad, "deepfm", "train", TRAIN_B),
               "dedup_adagrad": (run_dedup_adagrad, "deepfm", "train", TRAIN_B),
               "fm_interaction_bwd": (run_fm_bwd, "deepfm", "train", TRAIN_B),
               "cross_layer": (run_cross, "dcn-v2", "serve", SERVE_B),
               "cross_layer_bwd": (run_cross_bwd, "dcn-v2", "train", TRAIN_B)}
    main_shape = {}
    for name, (run, arch, path, main_b) in runners.items():
        for label, b in ((path, main_b), ("bulk", BULK_B)):
            r = run(b, gen, ARCHS[arch])
            print(f"[kernel] {name} {label} " + json.dumps(r), flush=True)
            if label != "bulk":
                main_shape[name] = r
    # the embedding kernels again at dcn-v2's D = 16, n = B x 26, its table
    for name in ("tier_probe", "gather_pool", "segment_grad", "dedup_adagrad"):
        run, _, path, main_b = runners[name]
        r = run(main_b, gen, ARCHS["dcn-v2"])
        print(f"[kernel] {name} dcn-v2 {path} " + json.dumps(r), flush=True)
    _TABLES.clear()
    torch.cuda.empty_cache()

    runs = {}
    for arch in ARCHS:
        full = runs[arch, "serve"] = serve_full_width(arch)
        print(f"[serve] {arch} full width " + json.dumps(full), flush=True)
        print(f"[serve] {arch} B={SERVE_B}: p50={full['p50_ms']:.3f}ms "
              f"p99={full['p99_ms']:.3f}ms mean_prob={full['mean_prob']:.4f} "
              f"cache_hits/request={full['cache_hits_per_request']:.1f}", flush=True)
        print(f"[serve] {arch}-smoke card vs CPU " + json.dumps(smoke_against_cpu(arch)),
              flush=True)

        train = runs[arch, "train"] = train_full_width(arch)
        print(f"[train] {arch} full width " + json.dumps(train), flush=True)
        print(f"[train] {arch} B={TRAIN_B}: step p50={train['step_p50_ms']:.3f}ms "
              f"p99={train['step_p99_ms']:.3f}ms samples/s={train['samples_per_s']:.0f} "
              f"flush step={train['flush_step_ms']:.1f}ms "
              f"kernel vs plain 30-step loss diff={train['max_abs_loss_diff']:.3g}",
              flush=True)
        print(f"[train] {arch}-smoke card vs CPU "
              + json.dumps(train_smoke_against_cpu(arch)), flush=True)
        # free this arch's memory before the next arch's state
        torch.cuda.empty_cache()

    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = main_shape[name]
        # each kernel's launches on the main path it was ported for
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": runs[PORTED_FOR[name]]["launches"][name],
                        "max_abs_err": r["max_abs_err"],
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
