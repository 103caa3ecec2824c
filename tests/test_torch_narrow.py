"""The port's ``picasso_l2`` and ``picasso_narrow`` paths against the
reference on the CPU.

Kernels: the plain ``gather_project``/``gather_project_grad`` and the
autograd backward of ``ops.gather_project`` against ``repro.kernels.ref``,
the Pallas kernels in interpret mode and ``jax.grad`` of the reference's
``ops.gather_project``, to 1e-6 of the value scale (float32 sums of a few
terms in another order). State: the projection init bitwise, ``proj_pinv``
to 1e-6. Sparse path (the reference under ``mesh1``): integer lookup
outputs bitwise, rows to 1e-6; one sparse update per mode to 1e-6; flushes
with keys bitwise and rows to 1e-5 (the narrow write-back solves through
``proj_pinv``); these bars are of the value scale. End to end on
deepfm-smoke: an 8-step trajectory at ``test_torch_train.py``'s bars
(losses rtol 1e-4 / atol 1e-5, hits and integer state bitwise, float state
to 1e-4) and a served request to 1e-5 with equal L1/L2 hits. Port-only:
the degenerate cases are bitwise ``picasso_l2`` / ``picasso``.
"""
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.core import packed_embedding as jpe
from repro.core.assign import apply_assignment as japply_assignment
from repro.core.assign import resolve_assignment as jresolve_assignment
from repro.core.features import pack_group as jpack_group
from repro.core.packing import make_plan as jmake_plan
from repro.data.synthetic import make_batch as jmake_batch
from repro.dist.compat import shard_map
from repro.dist.sharding import batch_specs, emb_specs, replicated, to_named
from repro.embedding.state import _np_proj_kernel as j_np_proj_kernel
from repro.engine import EmbeddingEngine as JEngine
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fused_embedding import (gather_project_grad_pallas,
                                           gather_project_pallas)
from repro.models.wdl import WDLModel as JWDLModel
from repro.serve.serve_step import ServeConfig as JServeConfig
from repro.serve.serve_step import make_serve_step as jmake_serve_step
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import init_state as jinit_state
from repro.train.train_step import make_flush_fn as jmake_flush_fn
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.convert import state_from_jax, train_state_from_jax
from repro_torch.core import packed_embedding as pe
from repro_torch.core.packing import make_plan
from repro_torch.embedding.state import _np_proj_kernel, tier_gates
from repro_torch.engine import EmbeddingEngine, resolve_assignment
from repro_torch.kernels import ops, ref
from repro_torch.models.wdl import WDLModel
from repro_torch.optim import optimizers as topt
from repro_torch.serve.serve_step import ServeConfig, make_serve_step
from repro_torch.train.train_step import (TrainConfig, init_state, make_flush_fn,
                                          make_train_step)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
AXES = ("data", "model")
GB = 64
STEPS = 8
ND = 4
# tests/test_narrow.py's plan: tiny L1, an L2 four times its bytes, a flush
# every 5 steps after 2
PLAN_KW = dict(hot_bytes=1 << 14, l2_bytes=1 << 16, flush_iters=5, warmup_iters=2)
# the last: full DLRM's narrow d = 32 under its D = 128
GRID = [(24, 16, 4, 8), (40, 64, 8, 16), (7, 5, 3, 10), (13, 40, 8, 16), (50, 40, 32, 128)]


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, exp, tol):
    """Max-abs error within ``tol`` of the value scale (the largest entry,
    at least 1): sums of a few float32 terms in another order differ by a
    few ulp of the largest partial sum."""
    exp = np.asarray(exp)
    scale = max(float(np.abs(exp).max()), 1.0) if exp.size else 1.0
    np.testing.assert_allclose(np.asarray(got), exp, atol=tol * scale, rtol=0)


# ------------------------------------------------------------------ kernels


def _project_case(m, n, nd, d, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(m, nd)).astype(f), rng.integers(0, m, n).astype(np.int32),
            rng.random(n) < 0.8, rng.normal(size=(nd, d)).astype(f),
            rng.normal(size=(n, d)).astype(f), rng.normal(size=(n, nd)).astype(f))


@pytest.mark.parametrize("m,n,nd,d", GRID)
def test_gather_project_plain_matches_reference_and_pallas(m, n, nd, d):
    back, idx, kept, proj, _, _ = _project_case(m, n, nd, d, 200 + m)
    wide, narrow = ref.gather_project_ref(_t(back), _t(idx), _t(kept), _t(proj))
    j = [jnp.asarray(x) for x in (back, idx, kept, proj)]
    for ew, en in (jref.gather_project_ref(*j), gather_project_pallas(*j, interpret=True)):
        _close(wide, ew, 1e-6)
        _close(narrow, en, 1e-6)
    assert (wide[~_t(kept)] == 0).all() and (narrow[~_t(kept)] == 0).all()


@pytest.mark.parametrize("m,n,nd,d", GRID)
def test_gather_project_grad_plain_matches_reference_and_pallas(m, n, nd, d):
    _, idx, kept, proj, g_wide, g_narrow = _project_case(m, n, nd, d, 300 + m)
    got = ref.gather_project_grad_ref(_t(g_wide), _t(g_narrow), _t(idx), _t(kept),
                                      _t(proj), m)
    j = [jnp.asarray(x) for x in (g_wide, g_narrow, idx, kept, proj)]
    _close(got, jref.gather_project_grad_ref(*j, m), 1e-6)
    _close(got, gather_project_grad_pallas(*j, m, interpret=True), 1e-6)
    touched = np.zeros(m, bool)
    touched[idx[kept]] = True
    assert (got.numpy()[~touched] == 0).all()
    # the standalone op dispatches to the plain version for CPU tensors
    assert torch.equal(ops.gather_project_grad(_t(g_wide), _t(g_narrow), _t(idx),
                                               _t(kept), _t(proj), m), got)


@pytest.mark.parametrize("m,n,nd,d", GRID)
def test_gather_project_autograd_matches_jax_grad(m, n, nd, d):
    """d/d(back, proj) of ``sum(wide * tw) + sum(narrow * tn)`` through the
    port's autograd against ``jax.grad`` of the reference's custom VJP, the
    Pallas kernels (interpret mode) and the plain chain."""
    back, idx, kept, proj, tw, tn = _project_case(m, n, nd, d, 400 + m)
    b_t, p_t = _t(back).requires_grad_(True), _t(proj).requires_grad_(True)
    wide, narrow = ops.gather_project(b_t, _t(idx), _t(kept), p_t)
    ((wide * _t(tw)).sum() + (narrow * _t(tn)).sum()).backward()

    def loss(fn):
        def f(b, p):
            w, nr = fn(b, p)
            return jnp.sum(w * tw) + jnp.sum(nr * tn)
        return f

    ji, jk = jnp.asarray(idx), jnp.asarray(kept)
    for fn in (lambda b, p: jops.gather_project(b, ji, jk, p, fused=False),
               lambda b, p: jops.gather_project(b, ji, jk, p, fused=True),
               lambda b, p: jref.gather_project_ref(b, ji, jk, p)):
        gb, gp = jax.grad(loss(fn), argnums=(0, 1))(jnp.asarray(back), jnp.asarray(proj))
        _close(b_t.grad, gb, 1e-6)
        _close(p_t.grad, gp, 1e-6)


def test_gather_project_forced_on_cpu_tensors_raise():
    back, idx, kept, proj, gw, gn = (_t(x) for x in _project_case(6, 4, 2, 3, 1))
    with pytest.raises(ValueError, match="CUDA"):
        ops.gather_project(back, idx, kept, proj, fused=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.gather_project_grad(gw, gn, idx, kept, proj, 6, fused=True)


def test_gather_project_wrappers_check_shapes_before_launch(monkeypatch):
    monkeypatch.setattr(ops, "_launch", lambda *a: pytest.fail("launched"))
    back, idx, kept, proj, gw, gn = (_t(x) for x in _project_case(6, 4, 2, 3, 1))
    with pytest.raises(ValueError, match="proj"):
        ops._gather_project_cuda(back, idx, kept, torch.zeros((3, 3)))
    with pytest.raises(ValueError, match="must match"):
        ops._gather_project_cuda(back, idx, kept[:3].clone(), proj)
    with pytest.raises(ValueError, match="kept"):
        ops._gather_project_cuda(back, idx, kept.to(torch.int32), proj)
    # the kernel's limits: proj and one narrow row within 48 KB, at most
    # 256 lanes a narrow row (d / w) and a wide row (D / cw)
    with pytest.raises(ValueError, match="shared memory"):
        ops._gather_project_cuda(torch.zeros((6, 8)), idx, kept, torch.zeros((8, 1600)))
    with pytest.raises(ValueError, match="lanes"):
        ops._gather_project_cuda(back, idx, kept, torch.zeros((2, 1030)))
    with pytest.raises(ValueError, match="lanes"):
        ops._gather_project_cuda(torch.zeros((6, 1028)), idx, kept, torch.zeros((1028, 4)))
    with pytest.raises(ValueError, match="want"):
        ops._gather_project_grad_cuda(gw[:, :2].contiguous(), gn, idx, kept, proj, 6)
    with pytest.raises(ValueError, match="contiguous"):
        ops._gather_project_grad_cuda(gw, torch.zeros((2, 4)).T, idx, kept, proj, 6)


@pytest.mark.parametrize("n,nd,d,plan", [
    (19_968, 4, 10, (4, 2, 4, 256, 128)),    # narrow deepfm serving: 156 blocks
    (9_984, 4, 10, (4, 2, 2, 256, 64)),      # narrow deepfm training: 156 blocks
    (13_312, 32, 128, (4, 4, 8, 256, 64)),   # DLRM serving: 208 blocks
    (6_656, 32, 128, (4, 4, 4, 256, 32)),    # DLRM training: 208 blocks
    (2_555_904, 4, 10, (4, 2, 4, 256, 256)),  # bulk: 51 slots x 4 rows, two rounds
    (1, 4, 10, (4, 2, 1, 256, 16)),          # n = 1
    (1_001, 3, 7, (1, 1, 1, 256, 16)),       # odd widths: scalar lanes
    (40, 32, 1, (4, 1, 1, 256, 16)),         # D = 1
    (5_000, 96, 8, (4, 4, 1, 256, 32)),      # refused by the earlier kernel's 48 KB
    (100, 8, 1024, (4, 4, 8, 256, 16))])     # D = 1,024: one product slot
def test_gather_project_plan_by_hand(n, nd, d, plan):
    """Vectors: 4, 2 or 1 floats a lane, dividing d (gather) and D
    (product). Tiles: the largest power of two <= 256 that gives each of
    an H100's 132 SMs a block (19,968 / 128 = 156; / 256 = 78), at least
    16 for that; one gather batch of four positions a lane (DLRM: 8 lanes
    a row, 32 rows a pass); product slots of 256 // (D / cw) lanes, rows
    of them the least power of two that covers the tile, up to 8, or up to
    4 where a position's product is at most 64 multiply-adds."""
    assert ops.gather_project_plan(n, nd, d, 132) == plan
    assert ops.gather_project_smem(nd, d, plan[4]) <= 48 * 1024


def _gp_mapping(n, nd, d, plan):
    """The kernel's two thread mappings, as its index arithmetic does, over
    the first and last block: per block, how often each (position, lane)
    is gathered, the gather batches a lane runs, how often each (position,
    column vector) is computed, the product rounds a lane runs, and each
    warp's wide-store offsets for each of its rows."""
    w, cw, rows, threads, tile = plan
    g, nc = nd // w, d // cw
    per_pass, slots = threads // g, threads // nc
    blocks = -(-n // tile)
    for blk in sorted({0, blocks - 1}):
        cnt = min(tile, n - blk * tile)
        gathered, computed, batches, rounds, stores = {}, {}, 0, 0, {}
        for t in range(threads):
            gp, j = divmod(t, g)
            if gp < per_pass:
                starts = range(gp, cnt, 4 * per_pass)
                batches = max(batches, len(starts))
                for base in starts:
                    for u in range(4):
                        if base + u * per_pass < cnt:
                            key = (base + u * per_pass, j)
                            gathered[key] = gathered.get(key, 0) + 1
            q, jj = divmod(t, nc)
            if q < slots:
                starts = range(q, cnt, rows * slots)
                rounds = max(rounds, len(starts))
                for base in starts:
                    for r in range(rows):
                        p = base + r * slots
                        if p < cnt:
                            computed[(p, jj)] = computed.get((p, jj), 0) + 1
                            stores.setdefault((t // 32, base - q, r), []).append(
                                p * d + jj * cw)
        yield cnt, gathered, batches, computed, rounds, stores


@pytest.mark.parametrize("n,nd,d", [(19_968, 4, 10), (9_984, 4, 10), (13_312, 32, 128),
                                    (6_656, 32, 128), (2_555_904, 4, 10), (1, 4, 10),
                                    (1_001, 3, 7), (333, 32, 128), (40, 32, 1),
                                    (100, 8, 1024), (77, 10, 33)])
def test_gather_project_plan_covers_each_output_once(n, nd, d):
    """Every narrow vector of the first and last block is gathered once in
    one batch (one dependent chain a position) and every wide vector
    computed once, in the rounds the plan's rows leave (one wherever rows
    cover the tile); the lanes of a warp store a row of positions as one
    contiguous run of ``cw``-float vectors (coalesced without staging),
    also where ``n`` is no multiple of the tile."""
    plan = ops.gather_project_plan(n, nd, d, 132)
    w, cw, rows, threads, tile = plan
    slots = threads // (d // cw)
    for cnt, gathered, batches, computed, rounds, stores in _gp_mapping(n, nd, d, plan):
        assert gathered == {(p, j): 1 for p in range(cnt) for j in range(nd // w)}
        assert computed == {(p, j): 1 for p in range(cnt) for j in range(d // cw)}
        assert batches == 1 and rounds == -(-cnt // (rows * slots))
        assert rounds == 1 or rows == (4 if nd * d <= 64 else 8)
        for offsets in stores.values():
            assert offsets == list(range(offsets[0], offsets[0] + cw * len(offsets), cw))


def test_gather_project_wrapper_hands_the_launcher_its_plan(monkeypatch):
    """The launcher gets the plan at the buffer's own alignment: a view of
    ``back`` 4 bytes off a 16-byte boundary takes scalar narrow lanes; the
    (6, 96) x (96, 8) case the earlier kernel's 48 KB refused launches."""
    seen = []
    monkeypatch.setattr(ops, "_launch", lambda name, *a: seen.append((name, a)))
    monkeypatch.setattr(ops, "sm_count", lambda device: 132)
    idx, kept = torch.zeros(40, dtype=torch.int32), torch.ones(40, dtype=torch.bool)
    back = torch.zeros((6, 4))
    offset = torch.zeros(6 * 4 + 4)[1:25].view(6, 4)
    for b, proj in ((back, torch.zeros((4, 10))), (offset, torch.zeros((4, 10))),
                    (torch.zeros((6, 96)), torch.zeros((96, 8)))):
        align = 16 if b.data_ptr() % 16 == 0 else 4
        ops._gather_project_cuda(b, idx, kept, proj)
        name, args = seen[-1]
        nd, d = proj.shape
        assert name == "gather_project"
        assert args[6:] == (6, 40, nd, d, *ops.gather_project_plan(40, nd, d, 132, align))
    assert seen[1][1][10] == 1  # scalar lanes for the offset view


@pytest.mark.parametrize("m,nd,d,align,plan", [
    (15_976, 4, 10, 16, (4, 2, 128)),     # narrow deepfm training: a lane an output
    (31_952, 4, 10, 16, (4, 2, 128)),     # narrow deepfm serving
    (10_652, 32, 128, 16, (16, 4, 256)),  # DLRM training: 16 lanes fit, float4 rows
    (21_300, 32, 128, 16, (8, 4, 256)),   # DLRM serving: 8 lanes fit
    (4_089_448, 4, 10, 16, (1, 2, 32)),   # bulk: a lane a slot, 32 slots a block
    (15_976, 4, 10, 4, (4, 1, 128)),      # g_wide 4 bytes off 16: scalar rows
    (1, 4, 10, 16, (4, 2, 128)),          # one slot
    (15_976, 1, 10, 16, (1, 2, 32)),      # d = 1
    (15_976, 3, 7, 16, (4, 1, 128)),      # odd widths: d = 3 -> 4 lanes
    (100, 5, 12, 8, (8, 2, 256)),         # an 8-byte-aligned g_wide
    (4_000, 96, 128, 16, (32, 4, 256)),   # d * D = 12,288
    (4_000, 256, 48, 16, (32, 4, 256)),   # d = 256: 32 lanes of 8
    (4_089_448, 256, 48, 16, (32, 4, 256))])  # at least a lane for 8 outputs
def test_gather_project_grad_plan_by_hand(m, nd, d, align, plan):
    """Lanes a slot: d rounded up to a power of two (a lane an output, at
    most 32), halved while m * lanes passes the 2,048 threads each of an
    H100's 132 SMs holds, but not below a lane for 8 outputs; row loads:
    the widest of 4, 2, 1 floats that divides D and whose bytes divide
    g_wide's alignment; threads a block: 32 slots, at most 256."""
    assert ops.gather_project_grad_plan(m, nd, d, 132, align) == plan
    lanes, cw, threads = plan
    assert 1 <= lanes <= 32 and nd <= 8 * lanes and threads == min(256, 32 * lanes)
    assert d % cw == 0 and align % (4 * cw) == 0
    assert m * lanes <= 132 * 2048 or 2 * lanes > min(32, 1 << (nd - 1).bit_length()) // 8


def _grad_lists(idx, kept, m, order, lanes=1):
    """The kernel's grouping, emulated: positions inserted in ``order`` (any
    order the atomics take), each pushed on its slot's list (``next[i] =
    head[slot]; head[slot] = i + 1``; not-kept positions and slots outside
    [0, m) dropped); then a slot group takes its first entry, and where
    that links on, walks at most klist + 1 entries and sorts a list of at
    most klist = min(32 lanes, 128) ascending, or past that scans idx and
    kept in steps of 32 lanes positions, the hits of each step in
    ascending order. Returns the positions of every slot in the order the
    kernel sums them."""
    n, klist = idx.shape[0], min(32 * lanes, 128)
    head, nxt = np.zeros(m, np.int64), np.full(n, -7, np.int64)
    for i in order:
        if kept[i] and 0 <= idx[i] < m:
            nxt[i], head[idx[i]] = head[idx[i]], i + 1
    lists = []
    for j in range(m):
        if head[j] == 0:
            lists.append([])
            continue
        p0 = head[j] - 1
        if nxt[p0] == 0:
            lists.append([p0])
            continue
        buf, p = [p0], nxt[p0]
        while p != 0 and len(buf) <= klist:
            buf.append(p - 1)
            p = nxt[p - 1]
        if len(buf) <= klist:
            lists.append(sorted(buf))
            continue
        got, step = [], 32 * lanes
        for q0 in range(0, n, step):
            hits = [q for q in range(q0, min(q0 + step, n)) if kept[q] and idx[q] == j]
            assert len(hits) <= step
            got += hits
        lists.append(got)
    return lists


def _grad_layout(layout, m, n, seed):
    """Edge lists: "path" (60 % kept, the rest on slot m - 1), "one slot"
    (every position kept on slot m // 2), "runs" and "long runs" (slot 1
    takes exactly 32 or 128 kept positions, slot 2 one more, spread over
    [0, n)), "outside" (kept positions on -1, -2^31, m and 2^31 - 1 among
    in-range ones)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, m, n).astype(np.int32)
    kept = rng.random(n) < 0.6
    if layout == "path":
        idx[~kept] = m - 1
    elif layout == "one slot":
        idx[:], kept[:] = m // 2, True
    elif layout in ("runs", "long runs"):
        run = 32 if layout == "runs" else 128
        idx[(idx == 1) | (idx == 2)] = 0
        at = rng.permutation(n)[:2 * run + 1]
        idx[at[:run]], idx[at[run:]], kept[at] = 1, 2, True
    elif layout == "outside":
        bad = np.array([-1, -2**31, m, 2**31 - 1], np.int32)
        pick = kept & (rng.random(n) < 0.3)
        idx[pick] = bad[rng.integers(0, bad.size, int(pick.sum()))]
    return idx, kept


GRAD_LISTS = [("path", 40, 300), ("one slot", 40, 300), ("runs", 40, 300),
              ("long runs", 40, 300), ("outside", 40, 300), ("path", 1, 50), ("path", 10, 0),
              ("one slot", 3, 1)]


@pytest.mark.parametrize("layout,m,n", GRAD_LISTS)
@pytest.mark.parametrize("order", ["ascending", "descending", "random"])
def test_gather_project_grad_lists_give_the_stable_sort_runs(layout, m, n, order):
    """Whatever order the atomics insert positions in, the emulated
    grouping sums each slot's kept positions in ascending order: the
    earlier kernel's stable-sort runs, the reference's segment_sum order;
    at one lane a slot runs of exactly 32 take the sorted list and 33 the
    scan, at four lanes 128 and 129, and every position on one slot takes
    the scan; not-kept positions and slots outside [0, m) are in no
    list. Summed in that order (fold then add, from +0.0) the lists give
    the plain version's output within 1e-6 of scale, and empty slots are
    exactly +0.0."""
    idx, kept = _grad_layout(layout, m, n, 7 * m + n)
    rng = np.random.default_rng(n)
    ins = {"ascending": np.arange(n), "descending": np.arange(n)[::-1],
           "random": rng.permutation(n)}[order]
    ok = kept & (idx >= 0) & (idx < m)
    order_ = np.argsort(np.where(ok, idx, m), kind="stable")
    want = [[] for _ in range(m)]
    for p in order_:
        if ok[p]:
            want[idx[p]].append(int(p))
    for lanes in (1, 4, 32):
        assert _grad_lists(idx, kept, m, ins, lanes) == want
    if layout.endswith("runs"):
        run = 32 if layout == "runs" else 128
        assert sorted(len(w) for w in want)[-2:] == [run, run + 1]
    nd, d = 3, 7
    g_wide = rng.normal(size=(n, d)).astype(np.float32)
    g_narrow = rng.normal(size=(n, nd)).astype(np.float32)
    proj = rng.normal(size=(nd, d)).astype(np.float32)
    out = np.zeros((m, nd), np.float32)
    for j, ps in enumerate(_grad_lists(idx, kept, m, ins)):
        acc = np.zeros(nd, np.float32)
        for p in ps:
            fold = np.zeros(nd, np.float32)
            for c in range(d):
                fold = fold + g_wide[p, c] * proj[:, c]
            acc = acc + (fold + g_narrow[p])
        out[j] = acc
    exp = ref.gather_project_grad_ref(_t(g_wide), _t(g_narrow), _t(idx), _t(kept), _t(proj), m)
    _close(out, exp, 1e-6)
    empty = np.array([not w for w in want], bool)
    assert (out[empty].view(np.uint32) == 0).all()
    assert (exp.numpy()[empty].view(np.uint32) == 0).all()


@pytest.mark.parametrize("layout,m,n,nd,d", [
    ("path", 40, 80, 32, 128), ("one slot", 40, 80, 32, 128), ("runs", 40, 80, 32, 128),
    ("path", 1, 30, 32, 128), ("path", 12, 0, 32, 128), ("path", 20, 40, 1, 10),
    ("path", 20, 40, 256, 48), ("one slot", 20, 40, 96, 128)])
def test_gather_project_grad_plain_on_edge_lists(layout, m, n, nd, d):
    """At DLRM's widths (d = 32, D = 128) and at d = 1, d = 256 and
    d * D = 12,288, on one-slot lists, runs of 32 and 33, m = 1 and n = 0:
    the plain version against the reference and its Pallas kernel
    (interpret mode) to 1e-6 of scale, empty slots exactly +0.0."""
    idx, kept = _grad_layout(layout, m, n, m + n + nd)
    rng = np.random.default_rng(nd)
    g_wide = rng.normal(size=(n, d)).astype(np.float32)
    g_narrow = rng.normal(size=(n, nd)).astype(np.float32)
    proj = rng.normal(size=(nd, d)).astype(np.float32)
    got = ops.gather_project_grad(_t(g_wide), _t(g_narrow), _t(idx), _t(kept), _t(proj), m)
    j = [jnp.asarray(x) for x in (g_wide, g_narrow, idx, kept, proj)]
    _close(got, jref.gather_project_grad_ref(*j, m), 1e-6)
    _close(got, gather_project_grad_pallas(*j, m, interpret=True), 1e-6)
    touched = np.zeros(m, bool)
    touched[idx[kept]] = True
    assert (got.numpy()[~touched].view(np.uint32) == 0).all()


def test_gather_project_grad_plain_drops_slots_outside_the_buffer():
    """Kept positions on -1, -2^31, m and 2^31 - 1 drop out of the plain
    version as out of the reference's segment_sum, at DLRM's widths; the
    rest of the slots match. (The Pallas kernel assumes in-range slots.)"""
    m, n, nd, d = 40, 120, 32, 128
    idx, kept = _grad_layout("outside", m, n, 5)
    assert (kept & ((idx < 0) | (idx >= m))).sum() > 10
    rng = np.random.default_rng(6)
    g_wide = rng.normal(size=(n, d)).astype(np.float32)
    g_narrow = rng.normal(size=(n, nd)).astype(np.float32)
    proj = rng.normal(size=(nd, d)).astype(np.float32)
    got = ops.gather_project_grad(_t(g_wide), _t(g_narrow), _t(idx), _t(kept), _t(proj), m)
    j = [jnp.asarray(x) for x in (g_wide, g_narrow, idx, kept, proj)]
    _close(got, jref.gather_project_grad_ref(*j, m), 1e-6)
    inside = (idx >= 0) & (idx < m)
    _close(got, ops.gather_project_grad(_t(g_wide), _t(g_narrow), _t(idx),
                                        _t(kept & inside), _t(proj), m), 0.0)


def test_gather_project_grad_wrapper_hands_the_launcher_its_plan(monkeypatch):
    """The launcher gets the inputs, an m + n scratch, the output and the
    plan at g_wide's own alignment (a view 4 bytes off 16 takes scalar row
    loads); m = 0 launches nothing."""
    seen = []
    monkeypatch.setattr(ops, "_launch", lambda name, *a: seen.append((name, a)))
    monkeypatch.setattr(ops, "sm_count", lambda device: 132)
    n, m = 40, 6
    idx, kept = torch.zeros(n, dtype=torch.int32), torch.ones(n, dtype=torch.bool)
    offset = torch.zeros(n * 10 + 1)[1:].view(n, 10)
    for gw, gn, proj in ((torch.zeros((n, 10)), torch.zeros((n, 4)), torch.zeros((4, 10))),
                         (offset, torch.zeros((n, 4)), torch.zeros((4, 10))),
                         (torch.zeros((n, 128)), torch.zeros((n, 96)), torch.zeros((96, 128)))):
        out = ops._gather_project_grad_cuda(gw, gn, idx, kept, proj, m)
        name, args = seen[-1]
        nd, d = proj.shape
        align = 16 if gw.data_ptr() % 16 == 0 else 4
        assert name == "gather_project_grad"
        assert args[:5] == (gw.data_ptr(), gn.data_ptr(), proj.data_ptr(), idx.data_ptr(),
                            kept.data_ptr())
        assert args[6] == out.data_ptr() and out.shape == (m, nd)
        assert args[7:] == (n, m, nd, d, *ops.gather_project_grad_plan(m, nd, d, 132, align))
    assert seen[1][1][12] == 1  # scalar row loads for the offset view
    ops._gather_project_grad_cuda(torch.zeros((n, 10)), torch.zeros((n, 4)), idx, kept,
                                  torch.zeros((4, 10)), 0)
    assert len(seen) == 3


def test_gather_project_grad_wrapper_keeps_its_limits(monkeypatch):
    """The earlier kernel's limits, unchanged: d <= 256, d * D <= 12,288
    floats, n and m below 2^31 - 1, and D > 0."""
    monkeypatch.setattr(ops, "_launch", lambda *a: pytest.fail("launched"))
    idx, kept = torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.bool)
    for nd, d in ((257, 4), (97, 128), (4, 0)):
        with pytest.raises(ValueError, match="exceed"):
            ops._gather_project_grad_cuda(torch.zeros((4, d)), torch.zeros((4, nd)), idx,
                                          kept, torch.zeros((nd, d)), 6)
    with pytest.raises(ValueError, match="exceed"):
        ops._gather_project_grad_cuda(torch.zeros((4, 10)), torch.zeros((4, 4)), idx, kept,
                                      torch.zeros((4, 10)), 2**31 - 1)
    with pytest.raises(ValueError, match="kept"):
        ops._gather_project_grad_cuda(torch.zeros((4, 10)), torch.zeros((4, 4)), idx,
                                      kept.to(torch.int32), torch.zeros((4, 10)), 6)


# -------------------------------------------------------------------- state


@pytest.mark.parametrize("gid,nd,d", [(0, 4, 10), (3, 8, 16), (1, 3, 7)])
def test_proj_init_bitwise_and_pinv(gid, nd, d):
    k = _np_proj_kernel(gid, nd, d)
    np.testing.assert_array_equal(k, j_np_proj_kernel(gid, nd, d))
    rng = np.random.default_rng(gid)
    trained = k + 0.1 * rng.normal(size=k.shape).astype(np.float32)
    for kern in (k, trained):
        _close(pe.proj_pinv(_t(kern)), jpe.proj_pinv(jnp.asarray(kern)), 1e-6)


# -------------------------------------------------------------- sparse path


def _tier_case(seed=5, rows=300, d=10, n=96, h1=16, h2=48):
    """A table, ids and two disjoint sorted tiers (half real keys, half
    sentinels) over ids of the batch."""
    rng = np.random.default_rng(seed)
    f = np.float32
    ids = rng.integers(0, rows, n).astype(np.int32)
    pick = rng.permutation(np.unique(ids))
    keys1 = np.sort(np.concatenate([pick[: h1 // 2], np.full(h1 - h1 // 2, rows)]))
    keys2 = np.sort(np.concatenate([pick[h1 // 2: h1 // 2 + h2 // 2],
                                    np.full(h2 - h2 // 2, rows)]))
    return dict(ids=ids, keys1=keys1.astype(np.int32), keys2=keys2.astype(np.int32),
                rows1=rng.normal(size=(h1, d)).astype(f),
                acc1=np.abs(rng.normal(size=(h1, 1))).astype(f),
                rows2=rng.normal(size=(h2, d)).astype(f),
                acc2=np.abs(rng.normal(size=(h2, 1))).astype(f),
                w=rng.normal(size=(rows, d)).astype(f),
                wn=rng.normal(size=(rows, ND)).astype(f),
                acc=np.abs(rng.normal(size=(rows, 1))).astype(f),
                proj=_np_proj_kernel(0, ND, d),
                g_u=rng.normal(size=(n, d)).astype(f))


_LOOKUP_OUT = ("rows", "uniq", "inv", "hit", "cache_slot", "l2_hit", "l2_slot",
               "send_slot", "overflow", "narrow")


def _jax_lookup(mesh, c, capacity, narrow, fused):
    def f(w, ids, k1, r1, k2, r2, proj):
        if narrow:
            rows, ctx = jpe.mp_lookup_narrow(w, ids, proj=proj, axes=AXES, world=1,
                                             capacity=capacity, hot_keys=k1, hot_rows=r1,
                                             l2_keys=k2, l2_rows=r2, fused=fused)
        else:
            rows, ctx = jpe.mp_lookup(w, ids, axes=AXES, world=1, capacity=capacity,
                                      hot_keys=k1, hot_rows=r1, l2_keys=k2, l2_rows=r2,
                                      fused=fused)
        nr = ctx.narrow_rows if narrow else jnp.zeros((1,))
        return (rows, ctx.uniq, ctx.inv, ctx.hit, ctx.cache_slot, ctx.l2_hit, ctx.l2_slot,
                ctx.routing.send_slot, ctx.routing.overflow, nr)

    g = jax.jit(shard_map(f, mesh=mesh, in_specs=(P(AXES, None),) + (P(),) * 6,
                          out_specs=(P(),) * 10, check_vma=False))
    w = c["wn"] if narrow else c["w"]
    return [np.asarray(x) for x in g(*map(jnp.asarray, (
        w, c["ids"], c["keys1"], c["rows1"], c["keys2"], c["rows2"], c["proj"])))]


def _port_lookup(c, capacity, narrow):
    kw = dict(world=1, capacity=capacity, hot_keys=_t(c["keys1"]), hot_rows=_t(c["rows1"]),
              l2_keys=_t(c["keys2"]), l2_rows=_t(c["rows2"]))
    if narrow:
        return pe.mp_lookup_narrow(_t(c["wn"]), _t(c["ids"]), proj=_t(c["proj"]), **kw)
    return pe.mp_lookup(_t(c["w"]), _t(c["ids"]), **kw)


@pytest.mark.parametrize("narrow,capacity,fused", [(False, 96, False), (False, 20, True),
                                                   (True, 96, False), (True, 20, True)])
def test_l2_and_narrow_lookup_match_reference(mesh1, narrow, capacity, fused):
    c = _tier_case()
    exp = dict(zip(_LOOKUP_OUT, _jax_lookup(mesh1, c, capacity, narrow, fused)))
    rows, ctx = _port_lookup(c, capacity, narrow)
    got = dict(rows=rows, uniq=ctx.uniq, inv=ctx.inv, hit=ctx.hit,
               cache_slot=ctx.cache_slot, l2_hit=ctx.l2_hit, l2_slot=ctx.l2_slot,
               send_slot=ctx.routing.send_slot, overflow=ctx.routing.overflow)
    for k in _LOOKUP_OUT[1:-1]:
        np.testing.assert_array_equal(got[k].numpy(), exp[k], err_msg=k)
    _close(rows, exp["rows"], 1e-6)
    if narrow:
        _close(ctx.narrow_rows, exp["narrow"], 1e-6)
        served = ctx.hit | ctx.l2_hit
        assert (ctx.narrow_rows[served] == 0).all()
    else:
        assert ctx.narrow_rows is None
    assert int(ctx.hit.sum()) > 0 and int(ctx.l2_hit.sum()) > 0
    assert not bool((ctx.hit & ctx.l2_hit).any())
    assert (int(ctx.routing.overflow) > 0) == (capacity < 96)


def _jax_apply(mesh, c, narrow, cache_update, capacity):
    def f(w, acc, ids, k1, r1, a1, k2, r2, a2, proj, g_u):
        cache, l2 = jpe.CacheState(k1, r1, a1), jpe.CacheState(k2, r2, a2)
        kw = dict(axes=AXES, world=1, lr=0.05, cache_update=cache_update)
        if narrow:
            _, ctx = jpe.mp_lookup_narrow(w, ids, proj=proj, axes=AXES, world=1,
                                          capacity=capacity, hot_keys=k1, hot_rows=r1,
                                          l2_keys=k2, l2_rows=r2)
            pstate = jpe.ProjState(proj, jnp.zeros((proj.shape[0], 1), jnp.float32) + 0.5)
            w2, acc2, c2, l22, p2 = jpe.apply_sparse_grads_narrow(
                w, acc, cache, l2, pstate, ctx, g_u, **kw)
            pk, pa = p2
        else:
            _, ctx = jpe.mp_lookup(w, ids, axes=AXES, world=1, capacity=capacity,
                                   hot_keys=k1, hot_rows=r1, l2_keys=k2, l2_rows=r2)
            w2, acc2, c2, l22 = jpe.apply_sparse_grads_l2(w, acc, cache, l2, ctx, g_u, **kw)
            pk = pa = jnp.zeros((1,))
        return w2, acc2, c2.rows, c2.acc, l22.rows, l22.acc, pk, pa

    g = jax.jit(shard_map(
        f, mesh=mesh, in_specs=(P(AXES, None), P(AXES, None)) + (P(),) * 9,
        out_specs=(P(AXES, None), P(AXES, None)) + (P(),) * 6, check_vma=False))
    w = c["wn"] if narrow else c["w"]
    return [np.asarray(x) for x in g(*map(jnp.asarray, (
        w, c["acc"], c["ids"], c["keys1"], c["rows1"], c["acc1"], c["keys2"], c["rows2"],
        c["acc2"], c["proj"], c["g_u"])))]


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("cache_update", ["psum", "stale"])
def test_apply_sparse_grads_l2_and_narrow_match_reference(mesh1, narrow, cache_update):
    """One lookup and one sparse update with hits in both tiers and a bucket
    small enough to overflow."""
    c = _tier_case(seed=7)
    cap = 20
    exp = _jax_apply(mesh1, c, narrow, cache_update, cap)
    w = _t(c["wn"] if narrow else c["w"])
    acc = _t(c["acc"])
    cache = pe.CacheState(_t(c["keys1"]), _t(c["rows1"]), _t(c["acc1"]))
    l2 = pe.CacheState(_t(c["keys2"]), _t(c["rows2"]), _t(c["acc2"]))
    _, ctx = _port_lookup(c, cap, narrow)
    assert int(ctx.routing.overflow) > 0
    assert int(ctx.hit.sum()) > 0 and int(ctx.l2_hit.sum()) > 0
    kw = dict(world=1, lr=0.05, cache_update=cache_update)
    if narrow:
        proj = pe.ProjState(_t(c["proj"]), torch.full((ND, 1), 0.5))
        w2, acc2, c2, l22, p2 = pe.apply_sparse_grads_narrow(w, acc, cache, l2, proj, ctx,
                                                             _t(c["g_u"]), **kw)
        assert p2.kernel is proj.kernel  # updated in place
        _close(p2.kernel, exp[6], 1e-6)
        _close(p2.acc, exp[7], 1e-6)
    else:
        w2, acc2, c2, l22 = pe.apply_sparse_grads_l2(w, acc, cache, l2, ctx, _t(c["g_u"]),
                                                     **kw)
    assert w2 is w and acc2 is acc and c2.rows is cache.rows and l22.rows is l2.rows
    for got, e in zip((w2, acc2, c2.rows, c2.acc, l22.rows, l22.acc), exp[:6]):
        _close(got, e, 1e-6)
    if cache_update == "stale":  # both tiers are read-only between flushes
        np.testing.assert_array_equal(l22.rows.numpy(), c["rows2"])
    else:
        assert not np.array_equal(l22.rows.numpy(), c["rows2"])


def _flush_plans(narrow):
    kw = dict(PLAN_KW, narrow_dim=ND if narrow else None)
    name = "picasso_narrow" if narrow else "picasso_l2"
    jplan = jmake_plan(jget_config("deepfm", smoke=True), 1, 8, **kw)
    plan = make_plan(get_config("deepfm", smoke=True), 1, 8, **kw)
    japply_assignment(jplan, jresolve_assignment(jplan, name))
    resolve_assignment(plan, name)
    return jplan, plan, name


@pytest.mark.parametrize("narrow", [False, True])
def test_two_tier_flush_matches_reference(mesh1, narrow):
    """Two flushes from tied counts; before the second the tiers' rows move
    as training would, so it writes back (through the pseudo-inverse when
    narrow) and carries resident ids' exact rows. Keys and counts bitwise,
    rows within 1e-5."""
    from repro.embedding.state import init_embedding_state as jinit_emb

    jplan, plan, name = _flush_plans(narrow)
    emb = {str(g): s for g, s in jinit_emb(jax.random.PRNGKey(0), jplan).items()}
    rng = np.random.default_rng(0)
    rows = jplan.groups[0].rows
    emb["0"] = emb["0"]._replace(counts=jnp.asarray(rng.integers(0, 4, rows).astype(np.int32)))
    flush = jmake_flush_fn(jplan, mesh1, AXES)
    engine = EmbeddingEngine(plan, 1, strategy=name)
    port, _ = state_from_jax(jax.device_get(emb), {}, plan, "cpu")
    assert (port["0"].proj is not None) == narrow
    for rnd in range(2):
        if rnd:
            jst, st = emb["0"], port["0"]
            new_counts = np.asarray(jst.counts) + rng.integers(0, 4, rows).astype(np.int32)
            b1 = rng.normal(size=jst.cache.rows.shape).astype(np.float32)
            b2 = rng.normal(size=jst.l2.rows.shape).astype(np.float32)
            emb["0"] = jst._replace(
                counts=jnp.asarray(new_counts),
                cache=jst.cache._replace(rows=jst.cache.rows + b1),
                l2=jst.l2._replace(rows=jst.l2.rows + b2))
            port["0"] = st._replace(
                counts=_t(new_counts), cache=st.cache._replace(rows=st.cache.rows + _t(b1)),
                l2=st.l2._replace(rows=st.l2.rows + _t(b2)))
        emb = jax.device_get(flush({"emb": emb})["emb"])
        port = engine.flush(port)
        jst, st = emb["0"], port["0"]
        for tier, jtier in ((st.cache, jst.cache), (st.l2, jst.l2)):
            np.testing.assert_array_equal(tier.keys.numpy(), np.asarray(jtier.keys))
            _close(tier.rows, jtier.rows, 1e-5)
            _close(tier.acc, jtier.acc, 1e-5)
        np.testing.assert_array_equal(st.counts.numpy(), np.asarray(jst.counts))
        _close(st.w, jst.w, 1e-5)
        _close(st.acc, jst.acc, 1e-5)
        k1, k2 = st.cache.keys.numpy(), st.l2.keys.numpy()
        assert (k1 < rows).sum() == plan.cache_rows[0] and (k2 < rows).sum() > 0
        assert not set(k1[k1 < rows]) & set(k2[k2 < rows])


# ----------------------------------------------------------------- end to end


def _narrow_plans(n_micro=None, narrow_dim=ND, name="picasso_narrow"):
    kw = dict(PLAN_KW, n_micro=n_micro, narrow_dim=narrow_dim)
    jplan = jmake_plan(jget_config("deepfm", smoke=True), 1, GB, **kw)
    plan = make_plan(get_config("deepfm", smoke=True), 1, GB, **kw)
    japply_assignment(jplan, jresolve_assignment(jplan, name))
    resolve_assignment(plan, name)
    return jplan, plan


def _tree_close(tree, jtree, tol):
    leaves, jleaves = topt.tree_leaves(tree), jax.tree.leaves(jtree)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        _close(a, b, tol)


@pytest.mark.parametrize("cache_update,n_micro", [("psum", 1), ("stale", 1), ("psum", 2)])
def test_narrow_train_trajectory_matches_reference(mesh1, cache_update, n_micro):
    jcfg = jget_config("deepfm", smoke=True)
    jplan, plan = _narrow_plans(n_micro)
    assert plan.narrow_width(0) == jplan.narrow_width(0) == ND
    jmodel = JWDLModel(jcfg, jplan)
    jstate = jinit_state(jmodel, jplan, jax.random.PRNGKey(0), mesh=mesh1, axes=AXES)
    state = train_state_from_jax(jax.device_get(jstate), plan, "cpu")
    tc = dict(strategy="picasso_narrow", use_fused_kernels="off", cache_update=cache_update)
    jstep, _ = jmake_train_step(jmodel, jplan, mesh1, AXES, GB, JTrainConfig(**tc),
                                donate=False)
    step = make_train_step(WDLModel(get_config("deepfm", smoke=True), plan), plan, GB,
                           TrainConfig(**tc), "cpu")
    assert step.n_micro == n_micro
    keys = ("cache_hits", "cache_hits/l1", "cache_hits/l2", "overflow")
    assert set(keys) <= set(step.engine.metric_keys)
    rng = np.random.default_rng(0)
    jl, tl, jm, tm = [], [], [], []
    for _ in range(STEPS):
        b = jmake_batch(jcfg, GB, rng)
        jstate, jmet = jstep(jstate, jax.device_put(b, to_named(mesh1, batch_specs(b, AXES))))
        state, met = step(state, b)
        jl.append(float(jmet["loss"]))
        tl.append(float(met["loss"]))
        jm.append(tuple(int(jmet[k]) for k in keys))
        tm.append(tuple(int(met[k]) for k in keys))
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-5)
    assert tm == jm
    # the step-5 flush warms both tiers
    assert all(h[1] > 0 and h[2] > 0 for h in tm[5:]) and all(h[0] == 0 for h in tm[:5])

    jfin = jax.device_get(jstate)
    jst, st = jfin["emb"]["0"], state["emb"]["0"]
    assert tuple(st.w.shape) == (plan.groups[0].rows, ND)
    np.testing.assert_array_equal(st.counts.numpy(), np.asarray(jst.counts))
    np.testing.assert_array_equal(st.cache.keys.numpy(), np.asarray(jst.cache.keys))
    np.testing.assert_array_equal(st.l2.keys.numpy(), np.asarray(jst.l2.keys))
    for got, exp in ((st.w, jst.w), (st.acc, jst.acc), (st.cache.rows, jst.cache.rows),
                     (st.cache.acc, jst.cache.acc), (st.l2.rows, jst.l2.rows),
                     (st.l2.acc, jst.l2.acc), (st.proj.kernel, jst.proj.kernel),
                     (st.proj.acc, jst.proj.acc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-4, rtol=0)
    for tree, jtree in ((state["dense"], jfin["dense"]), (state["opt"]["m"], jfin["opt"]["m"]),
                        (state["opt"]["v"], jfin["opt"]["v"])):
        leaves, jleaves = topt.tree_leaves(tree), jax.tree.leaves(jtree)
        for a, b in zip(leaves, jleaves):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)


def _warm_counts(plan, ids):
    """An FCounter whose flush puts some of the batch's distinct ids in L1
    and some in L2, whatever the packing salt: ``k`` batch ids and
    ``H1 - k`` rows outside the batch share the top count, so they are the
    top H1 exactly; ``k`` more batch ids take the second count, which ranks
    them between H1 and H1 + H2; noise adds 1 to random rows, which moves
    neither group across its boundary."""
    h1, h2 = plan.cache_rows[0], plan.l2_rows[0]
    rows = plan.groups[0].rows
    rng = np.random.default_rng(4)
    batch = rng.permutation(np.unique(ids))
    k = min(8, len(batch) // 4, h1, h2)
    others = rng.choice(np.setdiff1d(np.arange(rows), batch), h1 - k, replace=False)
    counts = np.zeros(rows, np.int32)
    counts[batch[:k]] = 5
    counts[others] = 5
    counts[batch[k:2 * k]] = 2
    counts[rng.integers(0, rows, 4096)] += 1
    return counts


def _jax_tier_hits(mesh, jplan, emb, fields):
    engine = JEngine(jplan, AXES, 1, strategy="picasso_narrow", use_fused_kernels="off")

    def f(emb, fields):
        packed = {g.gid: jpack_group(g, fields) for g in jplan.groups}
        _, ctx = engine.forward(emb, packed)
        c = ctx.ctxs[0]
        return jnp.sum(c.hit), jnp.sum(c.l2_hit)

    g = jax.jit(shard_map(f, mesh=mesh, in_specs=(emb_specs(jplan, AXES), replicated(fields)),
                          out_specs=(P(), P()), check_vma=False))
    return tuple(int(x) for x in g(emb, fields))


def test_narrow_smoke_serve_matches_reference(mesh1):
    """deepfm-smoke with a narrow master and both tiers warmed by the
    reference's flush: the port's probabilities within 1e-5 of the
    reference's (fused off and on), L1 and L2 hits equal and non-zero."""
    b = 8
    jcfg, cfg = jget_config("deepfm", smoke=True), get_config("deepfm", smoke=True)
    kw = dict(PLAN_KW, narrow_dim=ND)
    jplan, plan = jmake_plan(jcfg, 1, b, **kw), make_plan(cfg, 1, b, **kw)
    japply_assignment(jplan, jresolve_assignment(jplan, "picasso_narrow"))
    resolve_assignment(plan, "picasso_narrow")
    jmodel, model = JWDLModel(jcfg, jplan), WDLModel(cfg, plan)
    state = jinit_state(jmodel, jplan, jax.random.PRNGKey(0), mesh=mesh1, axes=AXES)
    batch = jmake_batch(jcfg, b, np.random.default_rng(3))
    from repro_torch.core.features import pack_group
    ids = pack_group(plan.groups[0], batch["fields"], "cpu").ids.numpy()
    emb = dict(state["emb"])
    emb["0"] = emb["0"]._replace(counts=jnp.asarray(_warm_counts(plan, ids)))
    state = jmake_flush_fn(jplan, mesh1, AXES)({**state, "emb": emb})
    emb_t, dense_t = state_from_jax(jax.device_get(state["emb"]),
                                    jax.device_get(state["dense"]), plan, "cpu")
    serve = make_serve_step(model, plan, b, ServeConfig(strategy="picasso_narrow"), "cpu")
    probs, ctx = serve.score({"emb": emb_t, "dense": dense_t}, batch)
    c = ctx.ctxs[0]
    hits = (int(c.hit.sum()), int(c.l2_hit.sum()))
    for mode in ("off", "on"):
        jserve = jmake_serve_step(jmodel, jplan, mesh1, AXES, b, scfg=JServeConfig(
            strategy="picasso_narrow", use_fused_kernels=mode))
        np.testing.assert_allclose(probs.numpy(), np.asarray(jserve(state, batch)),
                                   atol=1e-5, rtol=0)
    assert hits == _jax_tier_hits(mesh1, jplan, state["emb"], batch["fields"])
    assert min(hits) > 0


# ----------------------------------------------------------------- port only


def _port_run(plan, strategy, steps=7, **tkw):
    cfg = get_config("deepfm", smoke=True)
    model = WDLModel(cfg, plan)
    state = init_state(model, plan, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(model, plan, GB, TrainConfig(strategy=strategy, **tkw), "cpu")
    rng = np.random.default_rng(1)
    out = []
    for _ in range(steps):
        state, m = step(state, _smoke_batch(cfg, rng))
        out.append((float(m["loss"]), int(m["cache_hits"])))
    return state, out


def _smoke_batch(cfg, rng):
    from repro_torch.data.synthetic import make_batch
    return make_batch(cfg, GB, rng)


def _states_equal(a, b):
    for x, y in zip(topt.tree_leaves(_flat(a)), topt.tree_leaves(_flat(b))):
        assert torch.equal(x, y)


def _flat(state):
    """The train state as nested dicts of tensors (tiers and projection
    spelled out, absent leaves skipped)."""
    emb = {}
    for k, st in state["emb"].items():
        d = {"w": st.w, "acc": st.acc, "counts": st.counts, "cache": st.cache._asdict()}
        if st.l2 is not None:
            d["l2"] = st.l2._asdict()
        if st.proj is not None:
            d["proj"] = st.proj._asdict()
        emb[k] = d
    return {"emb": emb, "dense": state["dense"]}


def test_full_width_narrow_is_bitwise_picasso_l2():
    """``narrow_dim == dim`` records no narrowing: no projection, and a
    'picasso_narrow' run through a flush is bitwise 'picasso_l2'."""
    _, plan_a = _narrow_plans(narrow_dim=None, name="picasso_l2")
    dim = plan_a.groups[0].dim
    _, plan_b = _narrow_plans(narrow_dim=dim)
    assert plan_b.narrow_width(0) == dim
    sa, la = _port_run(plan_a, "picasso_l2")
    sb, lb = _port_run(plan_b, "picasso_narrow")
    assert sb["emb"]["0"].proj is None
    assert la == lb and la[-1][1] > 0
    _states_equal(sa, sb)


def test_engine_rejects_non_narrow_assignment_on_narrow_plan():
    _, plan = _narrow_plans()
    with pytest.raises(ValueError, match="picasso_narrow"):
        EmbeddingEngine(plan, 1, strategy="picasso_l2")
    with pytest.raises(ValueError, match="picasso_narrow"):
        EmbeddingEngine(plan, 1, strategy={0: "ps"})
    # 'mixed' follows the assignment the plan records
    assert EmbeddingEngine(plan, 1, strategy="mixed").assignment == {0: "picasso_narrow"}
    assert EmbeddingEngine(plan, 1, strategy="picasso_narrow").l2_on == {0: True}


@pytest.mark.parametrize("case", ["cold", "use_l2_off", "no_budget"])
def test_l2_cold_or_disabled_is_bitwise_picasso(case):
    """Before its first flush (cold tiers), with ``use_l2=False`` or with no
    L2 budget, 'picasso_l2' pools and updates bitwise like 'picasso'."""
    cfg = get_config("deepfm", smoke=True)
    kw = dict(hot_bytes=1 << 14, flush_iters=50, warmup_iters=2)
    base = make_plan(cfg, 1, GB, **kw)
    plan = make_plan(cfg, 1, GB, l2_bytes=0 if case == "no_budget" else 1 << 16, **kw)
    sa, la = _port_run(base, "picasso", steps=3)
    sb, lb = _port_run(plan, "picasso_l2", steps=3, use_l2=case != "use_l2_off")
    assert la == lb
    sa_emb, sb_emb = sa["emb"]["0"], sb["emb"]["0"]
    for x, y in ((sa_emb.w, sb_emb.w), (sa_emb.acc, sb_emb.acc),
                 (sa_emb.cache.rows, sb_emb.cache.rows)):
        assert torch.equal(x, y)
    for x, y in zip(topt.tree_leaves(sa["dense"]), topt.tree_leaves(sb["dense"])):
        assert torch.equal(x, y)
    assert (sb_emb.l2 is None) == (case == "no_budget")


def test_tier_gates_follow_the_engine():
    _, plan = _narrow_plans()
    for use_cache, use_l2 in ((True, True), (True, False), (False, True)):
        e = EmbeddingEngine(plan, 1, strategy="picasso_narrow", use_cache=use_cache,
                            use_l2=use_l2)
        assert tier_gates(plan, 0, use_cache=use_cache, use_l2=use_l2) == (
            e.cache_on[0], e.l2_on[0])


def test_convert_round_trips_narrow_l2_state(mesh1):
    """A reference narrow + L2 train state (after a flush, so both tiers
    hold keys) carries over leaf for leaf, bitwise."""
    jcfg = jget_config("deepfm", smoke=True)
    jplan, plan = _narrow_plans()
    jmodel = JWDLModel(jcfg, jplan)
    jstate = jinit_state(jmodel, jplan, jax.random.PRNGKey(1), mesh=mesh1, axes=AXES)
    emb = dict(jstate["emb"])
    emb["0"] = emb["0"]._replace(counts=jnp.asarray(
        np.random.default_rng(2).integers(0, 4, jplan.groups[0].rows).astype(np.int32)))
    jstate = jmake_flush_fn(jplan, mesh1, AXES)({**jstate, "emb": emb})
    host = jax.device_get(jstate)
    state = train_state_from_jax(host, plan, "cpu")
    jst, st = host["emb"]["0"], state["emb"]["0"]
    for got, exp in ((st.w, jst.w), (st.acc, jst.acc), (st.counts, jst.counts),
                     *zip(st.cache, jst.cache), *zip(st.l2, jst.l2),
                     *zip(st.proj, jst.proj)):
        assert got.numpy().dtype == np.asarray(exp).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    assert (st.l2.keys < plan.groups[0].rows).any()
    # a wide plan does not take a narrow state
    wide = make_plan(get_config("deepfm", smoke=True), 1, GB, **PLAN_KW)
    with pytest.raises(ValueError, match="does not match"):
        state_from_jax(host["emb"], {}, wide, "cpu")


def test_serve_config_use_l2_false_serves_as_picasso():
    cfg = get_config("deepfm", smoke=True)
    plan = make_plan(cfg, 1, 8, **PLAN_KW)
    model = WDLModel(cfg, plan)
    st = {**init_state(model, plan, torch.Generator().manual_seed(0), "cpu")}
    st["emb"]["0"] = st["emb"]["0"]._replace(counts=torch.arange(
        plan.groups[0].rows, dtype=torch.int32) % 7)
    st["emb"] = make_flush_fn(plan, strategy="picasso_l2")(st)["emb"]
    assert (st["emb"]["0"].l2.keys < plan.groups[0].rows).any()
    batch = _smoke_batch(cfg, np.random.default_rng(5))
    batch = {**batch, "fields": {k: {kk: vv[:8] for kk, vv in v.items()}
                                 for k, v in batch["fields"].items()},
             "labels": batch["labels"][:8]}
    pa, ca = make_serve_step(model, plan, 8, ServeConfig(strategy="picasso"), "cpu").score(
        st, batch)
    off = make_serve_step(model, plan, 8, ServeConfig(strategy="picasso_l2", use_l2=False),
                          "cpu")
    pb, cb = off.score(st, batch)
    assert off.engine.l2_on == {0: False} and cb.ctxs[0].l2_hit is None
    assert torch.equal(pa, pb)
    on = make_serve_step(model, plan, 8, ServeConfig(strategy="picasso_l2"), "cpu")
    assert on.score(st, batch)[1].ctxs[0].l2_hit is not None
    nocache = make_serve_step(model, plan, 8, ServeConfig(strategy="picasso_l2",
                                                          use_cache=False), "cpu")
    assert nocache.engine.cache_on == {0: False} and nocache.engine.l2_on == {0: False}


def test_switched_off_l2_is_not_flushed_over_trained_master_rows(mesh1):
    """ROADMAP Queue 3's setup: deepfm-smoke at GB = 32 with a tiny L1 and
    an L2 budget, ``TrainConfig(use_l2=False)`` and a host flush every 5
    steps through ``make_flush_fn(use_l2=False)``. Between the flushes at
    steps 5 and 10 the ids the reference's step-5 flush loaded into its L2
    tier skip the tier and train as routed misses, in the master, on both
    sides alike. The reference's step-10 flush then writes its never-updated
    tier back over those master rows (each becomes the stale tier row
    narrowed through ``proj_pinv``); the port flushes a switched-off tier as
    the empty tier, so the trained rows stay bit for bit, and carries the
    tier on unchanged."""
    gb = 32
    kw = dict(hot_bytes=1 << 12, l2_bytes=1 << 16, narrow_dim=ND, flush_iters=5,
              warmup_iters=0)
    jcfg, cfg = jget_config("deepfm", smoke=True), get_config("deepfm", smoke=True)
    jplan, plan = jmake_plan(jcfg, 1, gb, **kw), make_plan(cfg, 1, gb, **kw)
    japply_assignment(jplan, jresolve_assignment(jplan, "picasso_narrow"))
    resolve_assignment(plan, "picasso_narrow")
    assert (plan.cache_rows[0], plan.l2_rows[0]) == (jplan.cache_rows[0],
                                                     jplan.l2_rows[0]) == (416, 1488)
    jmodel = JWDLModel(jcfg, jplan)
    jstate = jinit_state(jmodel, jplan, jax.random.PRNGKey(0), mesh=mesh1, axes=AXES)
    state = train_state_from_jax(jax.device_get(jstate), plan, "cpu")
    tc = dict(strategy="picasso_narrow", use_l2=False, flush_in_step=False,
              use_fused_kernels="off")
    jstep, _ = jmake_train_step(jmodel, jplan, mesh1, AXES, gb, JTrainConfig(**tc),
                                donate=False)
    step = make_train_step(WDLModel(cfg, plan), plan, gb, TrainConfig(**tc), "cpu")
    jflush = jmake_flush_fn(jplan, mesh1, AXES, use_l2=False)
    flush = make_flush_fn(plan, use_l2=False)
    rows = plan.groups[0].rows
    empty_l2 = state["emb"]["0"].l2
    rng = np.random.default_rng(0)
    for i in range(1, 11):
        b = jmake_batch(jcfg, gb, rng)
        jstate, _ = jstep(jstate, jax.device_put(b, to_named(mesh1, batch_specs(b, AXES))))
        state, _ = step(state, b)
        if i == 5:
            jstate, state = jflush(jstate), flush(state)
            jst5 = jax.device_get(jstate["emb"]["0"])
    jpre = jax.device_get(jstate["emb"]["0"])
    pre = state["emb"]["0"].w.clone()
    # the same L1 tier, and the same master rows trained since step 5
    np.testing.assert_array_equal(state["emb"]["0"].cache.keys.numpy(),
                                  np.asarray(jpre.cache.keys))
    np.testing.assert_allclose(pre.numpy(), np.asarray(jpre.w), atol=1e-4, rtol=0)
    jstate, state = jflush(jstate), flush(state)
    jpost, post = jax.device_get(jstate["emb"]["0"]), state["emb"]["0"]

    keys = np.asarray(jst5.l2.keys)
    slot = np.nonzero(keys < rows)[0]
    trained = (np.asarray(jpre.w)[keys[slot]] != np.asarray(jst5.w)[keys[slot]]).any(1)
    slot, ids = slot[trained], keys[slot[trained]]
    assert ids.size > 100
    # the reference: each trained row is now its stale tier row, narrowed
    stale = np.asarray(jst5.l2.rows)[slot] @ np.asarray(jpe.proj_pinv(jpre.proj.kernel))
    np.testing.assert_allclose(np.asarray(jpost.w)[ids], stale, atol=1e-5, rtol=0)
    assert np.abs(np.asarray(jpost.w)[ids] - np.asarray(jpre.w)[ids]).max() > 1e-2
    # the port: the flush kept every one of them, and the tier stayed as it was
    assert torch.equal(post.w[torch.as_tensor(ids).long()], pre[torch.as_tensor(ids).long()])
    assert all(torch.equal(a, b) for a, b in zip(post.l2, empty_l2))
    assert bool((post.l2.keys == rows).all())


def test_train_config_accepts_use_l2_false(mesh1):
    """``use_l2=False`` and ``pin_l2=True`` are both accepted; the narrow
    plan's pinned leaves (the master, its accumulator and the L2 tier) are
    the reference's ``emb_shardings(pin_l2=True)``'s."""
    from repro_torch.embedding.state import pinned_leaves
    from test_torch_pin import reference_pinned_leaves

    assert not TrainConfig(use_l2=False).use_l2
    assert TrainConfig(pin_l2=True).pin_l2
    jplan, plan = _narrow_plans()
    assert pinned_leaves(plan) == reference_pinned_leaves(jplan, mesh1) == {
        "0": ("w", "acc", "l2.keys", "l2.rows", "l2.acc")}


@pytest.mark.parametrize("launcher,args,pattern", [
    ("serve", ["--n-requests", "3", "--batch", "32"],
     r"^\[serve\] deepfm B=32: p50=[\d.]+ms p99=[\d.]+ms mean_prob=[\d.]+$"),
    ("train", ["--steps", "25", "--global-batch", "32", "--log-every", "5"],
     r"^  step +25 loss=[\d.]+ hits=[1-9]\d* ovf=\d+ l1=[1-9]\d* l2=\d+$"),
])
def test_launchers_run_narrow_smoke_on_cpu(launcher, args, pattern):
    env = {"PYTHONPATH": str(ROOT / "src")}
    import os
    env = {**os.environ, **env}
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{launcher}", "--arch", "deepfm",
         "--smoke", "--device", "cpu", "--strategy", "picasso_narrow", "--narrow-dim", "4",
         "--l2-budget", "65536", *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert re.search(pattern, out.stdout, re.M), out.stdout
