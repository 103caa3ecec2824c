"""The port's gradient compression (``--grad-compress fp16|topk`` and the
dense ``grad_compression`` modes) against the reference on the CPU.

Kernels: the plain versions in ``repro_torch.kernels.ref`` against
``repro.kernels.ref`` and the Pallas kernels in interpret mode, bit for bit
(payloads and roundtrips), at D = 4, 10, 16 over m = 300 rows (not a
multiple of the Pallas block) with zero rows, tied magnitudes and rows whose
scaled values are float16 subnormals. Where the reference's branches part
(NaN rows, float32-subnormal rows) the test pins what each does. Wrappers:
``optim.grad_compression`` against ``repro.optim.grad_compression`` under
``mesh1``, bitwise. Sparse path: one ``apply_sparse_grads{,_l2,_narrow}``
call per mode, from the same ``g_u``, to 1e-6 of the value scale with the
integer outputs bitwise. End to end: the 8-step deepfm-smoke trajectory of
``tests/test_torch_train.py`` under each routed mode and under the dense
``bf16`` psum, at that file's bars.
"""
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from test_torch_narrow import ND, _close, _port_lookup, _tier_case
from test_torch_serve import ROOT, _env
from test_torch_train import _sparse_case, check_train_trajectory

from repro.core import packed_embedding as jpe
from repro.dist.compat import shard_map
from repro.kernels import ref as jref
from repro.kernels.grad_compress import (fp16_compress_pallas, fp16_decompress_pallas,
                                         topk_compress_pallas, topk_decompress_pallas)
from repro.optim import grad_compression as jgc
from repro_torch.configs import get_config
from repro_torch.core import packed_embedding as pe
from repro_torch.core.packing import make_plan
from repro_torch.engine import EmbeddingEngine
from repro_torch.kernels import ops
from repro_torch.optim import grad_compression as gc

torch.set_num_threads(1)

AXES = ("data", "model")
M = 300  # rows: not a multiple of the Pallas kernels' 256-row block
DIMS = [4, 10, 16]


def _t(x):
    return torch.as_tensor(np.array(x))


def _bits(x):
    """Bit patterns with every NaN made the same one: -0.0 and 0.0 differ,
    NaN equals NaN."""
    a = np.array(x)
    if a.dtype.kind == "f":
        a[np.isnan(a)] = np.nan
        a = a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])
    return a


def _same_bits(got, exp, what=""):
    np.testing.assert_array_equal(_bits(got), _bits(exp), err_msg=what)


def _rows(m, d, seed):
    """Gradient rows as the routed hop sees them: 40 % exactly zero (empty
    bucket slots), a tenth with their largest magnitude repeated (tied,
    mixed signs), a tenth all one magnitude, and a tenth with entries down
    to 1e-8 of the row max (float16 subnormals once scaled) at row scales
    from 1e-6 to 1e3."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(m, d)).astype(np.float32)
    kind = rng.integers(0, 10, m)
    g[kind < 4] = 0.0
    for r in np.nonzero(kind == 4)[0]:
        top = np.abs(g[r]).max()
        cols = rng.choice(d, min(3, d), replace=False)
        g[r, cols] = top * rng.choice([-1.0, 1.0], cols.size)
    g[kind == 5] = rng.choice([-1.5, 1.5], (int((kind == 5).sum()), d))
    tiny = np.nonzero(kind == 6)[0]
    g[tiny] *= 10.0 ** rng.uniform(-8, 0, (tiny.size, d))
    g[tiny] *= 10.0 ** rng.uniform(-6, 3, (tiny.size, 1))
    return g.astype(np.float32), kind


# ------------------------------------------------------------------ kernels


@pytest.mark.parametrize("d", DIMS)
def test_fp16_compress_plain_matches_reference_and_pallas(d):
    g, kind = _rows(M, d, d)
    q, s = ops.compress_fp16(_t(g))
    assert q.dtype == torch.float16 and s.dtype == torch.float32 and s.shape == (M, 1)
    for name, (eq, es) in (("ref", jref.fp16_compress_ref(jnp.asarray(g))),
                           ("pallas", fp16_compress_pallas(jnp.asarray(g), interpret=True))):
        _same_bits(q.numpy(), eq, f"q vs {name}")
        _same_bits(s.numpy(), es, f"scale vs {name}")
    qn = q.numpy()
    assert (np.abs(qn[kind == 6]) < 2.0 ** -14).any() and (qn[kind == 6] != 0).any()
    assert not qn[kind < 4].any() and not s.numpy()[kind < 4].any()


@pytest.mark.parametrize("d", DIMS)
def test_fp16_decompress_plain_matches_reference_and_pallas(d):
    g, kind = _rows(M, d, d + 1)
    jq, js = jref.fp16_compress_ref(jnp.asarray(g))
    out = ops.decompress_fp16(_t(jq), _t(js))
    _same_bits(out.numpy(), jref.fp16_decompress_ref(jq, js), "vs ref")
    _same_bits(out.numpy(), fp16_decompress_pallas(jq, js, interpret=True), "vs pallas")
    _same_bits(out.numpy()[kind < 4], np.zeros((int((kind < 4).sum()), d), np.float32))
    _close(out, g, 2.0 ** -11)  # a float16 ulp of the row max, at most


@pytest.mark.parametrize("d", DIMS)
def test_topk_compress_plain_matches_reference_and_pallas(d):
    g, kind = _rows(M, d, 2 * d)
    k = gc.topk_k(d)
    vals, idx = ops.compress_topk(_t(g), k)
    assert vals.shape == idx.shape == (M, k) and idx.dtype == torch.int32
    for name, (ev, ei) in (("ref", jref.topk_compress_ref(jnp.asarray(g), k)),
                           ("pallas", topk_compress_pallas(jnp.asarray(g), k,
                                                           interpret=True))):
        _same_bits(vals.numpy(), ev, f"vals vs {name}")
        _same_bits(idx.numpy(), ei, f"idx vs {name}")
    # all-tied and zero rows keep the lowest columns
    for rows in (kind == 5, kind < 4):
        np.testing.assert_array_equal(idx.numpy()[rows], np.tile(np.arange(k), (rows.sum(), 1)))


@pytest.mark.parametrize("d", DIMS)
def test_topk_decompress_plain_matches_reference_and_pallas(d):
    g, kind = _rows(M, d, 2 * d + 1)
    k = gc.topk_k(d)
    jv, ji = jref.topk_compress_ref(jnp.asarray(g), k)
    out = ops.decompress_topk(_t(jv), _t(ji), d)
    _same_bits(out.numpy(), jref.topk_decompress_ref(jv, ji, d), "vs ref")
    _same_bits(out.numpy(), topk_decompress_pallas(jv, ji, d, interpret=True), "vs pallas")
    assert not out.numpy()[kind < 4].any()
    assert ((out.numpy() != 0).sum(axis=1)[kind >= 4] == k).all()
    # a column outside [0, d) is dropped, as the reference's scatter drops it
    bad = np.array(ji)
    bad[:, -1] = d
    dropped = ops.decompress_topk(_t(jv), _t(bad), d)
    _same_bits(dropped.numpy(), jref.topk_decompress_ref(jv, jnp.asarray(bad), d))


def test_nan_rows_follow_the_reference_not_the_pallas_topk():
    """A NaN in a row: fp16 turns the whole row NaN (scale NaN) in the
    reference, its Pallas kernel and the port alike. topk: the reference's
    ``lax.top_k`` ranks NaN first and decompresses it; its Pallas kernel
    finds no maximum, emits column D and value 0, and decompresses a zero
    row. The port follows ``lax.top_k`` (its kernel ranks NaN first too)."""
    g = np.array([[1.0, np.nan, -3.0, 2.0, 0.5, 0.25, 4.0, -1.0],
                  [np.nan, 1.0, np.nan, -2.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    q, s = ops.compress_fp16(_t(g))
    jq, js = jref.fp16_compress_ref(jnp.asarray(g))
    pq, ps = fp16_compress_pallas(jnp.asarray(g), interpret=True)
    assert np.isnan(q.numpy()).all() and np.isnan(s.numpy()).all()
    for a, b in ((q.numpy(), jq), (q.numpy(), pq), (s.numpy(), js), (s.numpy(), ps)):
        _same_bits(a, b)
    vals, idx = ops.compress_topk(_t(g), 2)
    jv, ji = jref.topk_compress_ref(jnp.asarray(g), 2)
    _same_bits(vals.numpy(), jv)
    _same_bits(idx.numpy(), ji)
    np.testing.assert_array_equal(idx.numpy(), [[1, 6], [0, 2]])
    pv, pi = topk_compress_pallas(jnp.asarray(g), 2, interpret=True)
    np.testing.assert_array_equal(np.asarray(pi), [[8, 8], [8, 8]])
    assert not np.asarray(pv).any()
    assert not np.asarray(topk_decompress_pallas(pv, pi, 8, interpret=True)).any()
    out = ops.decompress_topk(vals, idx, 8).numpy()
    assert np.isnan(out[0, 1]) and out[0, 6] == 4.0 and np.isnan(out[1, [0, 2]]).all()


def test_f32_subnormal_rows_keep_their_scale_where_xla_cpu_flushes():
    """XLA on the CPU flushes float32 subnormals: a row of them gets scale 0
    from the reference and vals 0 from its Pallas topk, where the port
    (and its CUDA kernels, built without flush-to-zero) keeps them. The
    decompressed fp16 rows agree (the scaled values are far below float16's
    range), the topk columns agree."""
    g = np.array([[1e-39, -3e-40, 2e-41, 0.0], [1.0, -2.0, 0.5, 0.0]], np.float32)
    q, s = ops.compress_fp16(_t(g))
    jq, js = jref.fp16_compress_ref(jnp.asarray(g))
    _same_bits(q.numpy(), jq)
    assert s.numpy()[0, 0] == np.float32(1e-39) and np.asarray(js)[0, 0] == 0.0
    _same_bits(s.numpy()[1], np.asarray(js)[1])
    _same_bits(ops.decompress_fp16(q, s).numpy(), jref.fp16_decompress_ref(jq, js))
    vals, idx = ops.compress_topk(_t(g), 2)
    pv, pi = topk_compress_pallas(jnp.asarray(g), 2, interpret=True)
    _same_bits(idx.numpy(), pi)
    _same_bits(vals.numpy(), jref.topk_compress_ref(jnp.asarray(g), 2)[0])
    assert vals.numpy()[0, 0] == np.float32(1e-39) and np.asarray(pv)[0, 0] == 0.0


@pytest.mark.parametrize("op", ["compress_fp16", "decompress_fp16", "compress_topk",
                                "decompress_topk"])
def test_compression_forced_on_cpu_tensors_raises(op):
    g = torch.ones((3, 8))
    args = {"compress_fp16": (g,), "decompress_fp16": (g.half(), torch.ones((3, 1))),
            "compress_topk": (g, 2),
            "decompress_topk": (torch.ones((3, 2)), torch.zeros((3, 2), dtype=torch.int32),
                                8)}[op]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(ops, op)(*args, fused=True)
    getattr(ops, op)(*args, fused=False)  # the plain version on request


def test_compression_wrappers_check_shapes_before_launch(monkeypatch):
    monkeypatch.setattr(ops, "_launch", lambda *a: pytest.fail("launched"))
    g = torch.ones((3, 8))
    with pytest.raises(ValueError, match="float32"):
        ops._fp16_compress_cuda(g.double())
    with pytest.raises(ValueError, match="width 0"):
        ops._fp16_compress_cuda(torch.ones((3, 0)))
    with pytest.raises(ValueError, match="scale"):
        ops._fp16_decompress_cuda(g.half(), torch.ones((3, 2)))
    with pytest.raises(ValueError, match="contiguous"):
        ops._topk_compress_cuda(torch.ones((8, 3)).T, 2)
    with pytest.raises(ValueError, match="k=9"):
        ops._topk_compress_cuda(g, 9)
    with pytest.raises(ValueError, match="idx"):
        ops._topk_decompress_cuda(torch.ones((3, 2)), torch.zeros((3, 1), dtype=torch.int32),
                                  8)
    with pytest.raises(ValueError, match="int32"):
        ops._topk_decompress_cuda(torch.ones((3, 2)), torch.zeros((3, 2)), 8)


# ----------------------------------------------------------------- wrappers


def _jax_gather(mesh, g, mode, fused):
    f = shard_map(lambda x: jgc.compressed_all_gather(x, AXES, mode=mode, fused=fused),
                  mesh=mesh, in_specs=(P(),), out_specs=P(), check_vma=False)
    return np.asarray(jax.jit(f)(jnp.asarray(g)))


@pytest.mark.parametrize("mode", gc.ROUTED_MODES)
def test_routed_roundtrip_matches_reference(mesh1, mode):
    g, _ = _rows(M, 10, 7)
    payload = gc.compress_rows(_t(g), mode)
    jpayload = jgc.compress_rows(jnp.asarray(g), mode, fused=False)
    if mode == "none":  # the rows themselves travel
        _same_bits(payload.numpy(), jpayload)
    else:
        assert type(payload).__name__ == type(jpayload).__name__
        assert payload._fields == jpayload._fields
        for a, b in zip(payload, jpayload):
            _same_bits(a.numpy(), b)
    out = gc.decompress_rows(payload, 10, mode)
    _same_bits(out.numpy(), jgc.decompress_rows(jpayload, 10, mode, fused=False))
    for fused in (False, True):  # the Pallas branch in interpret mode
        _same_bits(gc.compressed_all_gather(_t(g), 1, mode).numpy(),
                   _jax_gather(mesh1, g, mode, fused), f"all_gather fused={fused}")
    with pytest.raises(ValueError, match="world=2 needs a repro_torch.dist.Group"):
        gc.compressed_all_gather(_t(g), 2, mode)


def test_routed_modes_and_budget_match_reference():
    assert gc.ROUTED_MODES == jgc.ROUTED_MODES and gc.TOPK_FRACTION == jgc.TOPK_FRACTION
    assert [gc.topk_k(d) for d in range(1, 40)] == [jgc.topk_k(d) for d in range(1, 40)]
    for mode in ("none", "fp16", "topk", "bf16", "f8", "int4", ""):
        accepted = mode in jgc.ROUTED_MODES
        if accepted:
            assert gc.validate_routed_mode(mode) == jgc.validate_routed_mode(mode)
        else:
            for fn in (gc.validate_routed_mode, jgc.validate_routed_mode):
                with pytest.raises(ValueError, match="grad_compress"):
                    fn(mode)
            with pytest.raises(ValueError):
                gc.compress_rows(torch.ones((2, 4)), mode)


def _jax_psum(mesh, grads, mode):
    def f(g):
        return jgc.compressed_psum(g, AXES, mode=mode)

    out = jax.jit(shard_map(f, mesh=mesh, in_specs=(P(),), out_specs=(P(), P()),
                            check_vma=False))(jax.tree.map(jnp.asarray, grads))
    return jax.device_get(out)


@pytest.mark.parametrize("mode", ["none", "bf16", "fp16", "f8"])
def test_compressed_psum_matches_reference(mesh1, mode):
    """The dense psum's narrow payload and residual, bit for bit; for f8 the
    values past float8_e4m3fn's range (448) come back NaN as in the
    reference's cast (464 itself rounds to 448)."""
    rng = np.random.default_rng(3)
    sweep = np.concatenate([rng.normal(size=200) * 10.0 ** rng.uniform(-12, 3, 200),
                            [447.0, 448.0, 455.0, 464.0, 464.1, 470.0, 480.0, 500.0,
                             -500.0, 1e6, np.inf, -np.inf, 2.0 ** -9, 2.0 ** -10, 0.0,
                             -0.0, 6e4, 7e4, 1e-8]]).astype(np.float32)
    grads = {"a": {"w": sweep.reshape(-1, 1)}, "b": rng.normal(size=(7,)).astype(np.float32)}
    tgrads = {"a": {"w": _t(grads["a"]["w"])}, "b": _t(grads["b"])}
    summed, res = gc.compressed_psum(tgrads, 1, mode)
    jsum, jres = _jax_psum(mesh1, grads, mode)
    for got, exp in ((summed["a"]["w"], jsum["a"]["w"]), (summed["b"], jsum["b"])):
        assert got.dtype == torch.float32
        _same_bits(got.numpy(), exp)
    if mode == "none":
        assert res is None
        return
    for got, exp in ((res["a"]["w"], jres["a"]["w"]), (res["b"], jres["b"])):
        _same_bits(got.numpy(), exp)
    if mode == "f8":
        nan_at = np.isnan(summed["a"]["w"].numpy()[:, 0])
        assert nan_at[np.abs(sweep) > 464].all() and not nan_at[np.abs(sweep) <= 464].any()
    with pytest.raises(ValueError, match="grad_compression"):
        gc.compressed_psum(tgrads, 1, "int4")
    with pytest.raises(ValueError, match="world=2 needs a repro_torch.dist.Group"):
        gc.compressed_psum(tgrads, 2, mode)


# --------------------------------------------------------------- sparse path


def _jax_apply(mesh, c, variant, cache_update, compress, capacity):
    def f(w, acc, ids, k1, r1, a1, k2, r2, a2, proj, g_u):
        kw = dict(axes=AXES, world=1, lr=0.05, cache_update=cache_update,
                  compress=compress)
        cache, l2 = jpe.CacheState(k1, r1, a1), jpe.CacheState(k2, r2, a2)
        lk = dict(axes=AXES, world=1, capacity=capacity, hot_keys=k1, hot_rows=r1)
        pk = pa = l2r = l2a = jnp.zeros((1,))
        if variant == "narrow":
            _, ctx = jpe.mp_lookup_narrow(w, ids, proj=proj, l2_keys=k2, l2_rows=r2, **lk)
            pstate = jpe.ProjState(proj, jnp.zeros((proj.shape[0], 1), jnp.float32) + 0.5)
            w2, acc2, c2, l22, (pk, pa) = jpe.apply_sparse_grads_narrow(
                w, acc, cache, l2, pstate, ctx, g_u, **kw)
            l2r, l2a = l22.rows, l22.acc
        elif variant == "l2":
            _, ctx = jpe.mp_lookup(w, ids, l2_keys=k2, l2_rows=r2, **lk)
            w2, acc2, c2, l22 = jpe.apply_sparse_grads_l2(w, acc, cache, l2, ctx, g_u, **kw)
            l2r, l2a = l22.rows, l22.acc
        else:
            _, ctx = jpe.mp_lookup(w, ids, **lk)
            w2, acc2, c2 = jpe.apply_sparse_grads(w, acc, cache, ctx, g_u, **kw)
        return (w2, acc2, c2.rows, c2.acc, l2r, l2a, pk, pa, ctx.routing.overflow,
                jnp.sum(ctx.hit))

    g = jax.jit(shard_map(
        f, mesh=mesh, in_specs=(P(AXES, None), P(AXES, None)) + (P(),) * 9,
        out_specs=(P(AXES, None), P(AXES, None)) + (P(),) * 8, check_vma=False))
    w = c["wn"] if variant == "narrow" else c["w"]
    return [np.asarray(x) for x in g(*map(jnp.asarray, (
        w, c["acc"], c["ids"], c["keys1"], c["rows1"], c["acc1"], c["keys2"], c["rows2"],
        c["acc2"], c["proj"], c["g_u"])))]


def _single_tier_case():
    """``test_torch_train``'s sparse case in the two-tier case's layout (its
    L2 arrays are not read by ``apply_sparse_grads``)."""
    w, acc, ids, keys, hot, hot_acc, g_u = _sparse_case()
    c = _tier_case(seed=7)
    c.update(w=w, acc=acc, ids=ids, keys1=keys, rows1=hot, acc1=hot_acc, g_u=g_u)
    return c


@pytest.mark.parametrize("variant", ["single", "l2", "narrow"])
@pytest.mark.parametrize("cache_update", ["psum", "stale"])
@pytest.mark.parametrize("compress", ["fp16", "topk"])
def test_apply_sparse_grads_compressed_matches_reference(mesh1, variant, cache_update,
                                                         compress):
    """One lookup and one sparse update under each routed mode, with tier
    hits and a bucket small enough to overflow, from the same ``g_u``."""
    c = _single_tier_case() if variant == "single" else _tier_case(seed=7)
    cap = 40 if variant == "single" else 20
    exp = _jax_apply(mesh1, c, variant, cache_update, compress, cap)
    w = _t(c["wn"] if variant == "narrow" else c["w"])
    acc = _t(c["acc"])
    w0 = w.clone()
    cache = pe.CacheState(_t(c["keys1"]), _t(c["rows1"]), _t(c["acc1"]))
    l2 = pe.CacheState(_t(c["keys2"]), _t(c["rows2"]), _t(c["acc2"]))
    kw = dict(world=1, lr=0.05, cache_update=cache_update, compress=compress)
    if variant == "single":
        _, ctx = pe.mp_lookup(w, _t(c["ids"]), world=1, capacity=cap,
                              hot_keys=cache.keys, hot_rows=cache.rows)
        got = pe.apply_sparse_grads(w, acc, cache, ctx, _t(c["g_u"]), **kw)
    else:
        _, ctx = _port_lookup(c, cap, variant == "narrow")
        assert int(ctx.l2_hit.sum()) > 0
        if variant == "narrow":
            proj = pe.ProjState(_t(c["proj"]), torch.full((ND, 1), 0.5))
            got = pe.apply_sparse_grads_narrow(w, acc, cache, l2, proj, ctx, _t(c["g_u"]),
                                               **kw)
            _close(got[4].kernel, exp[6], 1e-6)
            _close(got[4].acc, exp[7], 1e-6)
        else:
            got = pe.apply_sparse_grads_l2(w, acc, cache, l2, ctx, _t(c["g_u"]), **kw)
        _close(got[3].rows, exp[4], 1e-6)
        _close(got[3].acc, exp[5], 1e-6)
    assert int(ctx.routing.overflow) == int(exp[8]) > 0
    assert int(ctx.hit.sum()) == int(exp[9]) > 0
    for t, e in zip((got[0], got[1], got[2].rows, got[2].acc), exp[:4]):
        _close(t, e, 1e-6)
    # the compression is lossy: the update is not the uncompressed one
    plain = _jax_apply(mesh1, c, variant, cache_update, "none", cap)
    moved = ~np.all(w.numpy() == w0.numpy(), axis=1)
    assert np.abs(w.numpy()[moved] - plain[0][moved]).max() > 1e-6


def test_engine_validates_and_hands_grad_compress_to_strategies():
    plan = make_plan(get_config("deepfm", smoke=True), 1, 64, l2_bytes=1 << 16,
                     narrow_dim=ND)
    for name in ("picasso", "picasso_l2", "picasso_narrow"):
        eng = EmbeddingEngine(plan, 1, strategy=name, grad_compress="topk")
        assert eng.grad_compress == "topk"
        assert {s.grad_compress for s in eng.strategies.values()} == {"topk"}
    with pytest.raises(ValueError, match="grad_compress"):
        EmbeddingEngine(plan, 1, grad_compress="bf16")


# ----------------------------------------------------------------- end to end


# how far apart the two sides' sums of one gradient entry may land: a few
# float32 ulps (2 in the tie that PYTHONHASHSEED=13 finds)
TIE_ULPS = 4


def _reconcile_topk(g_ref, idx_ref, idx_port):
    """The reference's topk selection ``idx_ref [m, k]`` of its rows
    ``g_ref [m, D]``, with each row where the port kept other columns taken
    over from ``idx_port`` only where that row ties at its k-th kept
    column: more than k of its magnitudes lie at or above the k-th less
    ``TIE_ULPS`` ulps, and the port kept every column above that band and
    only columns in it or above. Returns ``(idx, tied, untied)``: the
    selection for the reference to apply, the rows taken over, and the rows
    whose selections differ without such a tie (left as the reference's, so
    the trajectory check holds them as before)."""
    k = idx_ref.shape[1]
    out = np.array(idx_ref, copy=True)
    tied, untied = [], []
    differ = np.any(np.sort(idx_ref, axis=1) != np.sort(idx_port, axis=1), axis=1)
    for r in np.nonzero(differ)[0]:
        mag = np.abs(g_ref[r])
        t = np.sort(mag)[::-1][k - 1]
        band = TIE_ULPS * np.spacing(t)
        above, near = mag > t + band, np.abs(mag - t) <= band
        kept = idx_port[r]
        if (above.sum() + near.sum() > k and above[kept].sum() == above.sum()
                and bool(np.all(above[kept] | near[kept]))):
            out[r] = kept
            tied.append(int(r))
        else:
            untied.append(int(r))
    return out, tied, untied


class _TieAwareTopk:
    """Hands the port's topk selection of a tied row to the reference.

    An exact magnitude tie at the k-th kept column of a routed row is broken
    toward the lower column on both sides, but the reference sums that row
    in another order, so its two tied values can part by ulps and it keeps
    the other column (deepfm smoke, ``PYTHONHASHSEED=13``, step 2: columns 2
    and 8 at +-0.0398341864). The port records each ``compress_rows`` call
    of its step; the reference's ``compress_rows`` passes its selection
    through a host callback that applies ``_reconcile_topk`` against the
    port's call on the same rows, so a tied row is held to the reference's
    update of the port's own selection and every other row and quantity to
    the reference's own. ``port_hook`` may alter the port's payload (a test
    of the check itself)."""

    def __init__(self, monkeypatch, port_hook=None):
        self.calls, self.tied, self.untied = [], [], []
        port_orig, ref_orig = gc.compress_rows, jgc.compress_rows

        def port(g, mode, fused=None):
            payload = port_orig(g, mode, fused)
            if mode == "topk":
                if port_hook is not None:
                    payload = port_hook(g, payload, len(self.calls))
                self.calls.append((g.numpy().copy(), payload.idx.numpy().copy()))
            return payload

        def ref(g, mode, fused=None):
            payload = ref_orig(g, mode, fused)
            if mode != "topk":
                return payload
            idx = jax.pure_callback(self._reconcile,
                                    jax.ShapeDtypeStruct(payload.idx.shape, jnp.int32),
                                    g, payload.idx)
            return jgc.TopkRows(vals=jnp.take_along_axis(g, idx, axis=-1), idx=idx)

        monkeypatch.setattr(gc, "compress_rows", port)
        monkeypatch.setattr(jgc, "compress_rows", ref)

    def _reconcile(self, g, idx):
        g, idx = np.asarray(g), np.asarray(idx)
        # the port's call on the same rows (last-bit sums apart)
        same = [c for c in self.calls if c[0].shape == g.shape]
        if not same:
            return idx
        _, idx_port = min(same, key=lambda c: float(np.abs(c[0] - g).max()))
        out, tied, untied = _reconcile_topk(g, idx, idx_port)
        self.tied += tied
        self.untied += untied
        return out.astype(np.int32)


def _flip_untied_row(g, payload, call):
    """The port's second topk call keeps, in one row with no tie, its
    smallest column in place of its k-th largest: a wrong selection. The
    row is the untied one with the largest k-th magnitude, so the wrong
    update moves the state past the check's bars whatever the packing salt
    (under PYTHONHASHSEED=17 the first untied row's wrong update stayed
    within them)."""
    if call != 1:
        return payload
    vals, idx = payload.vals.clone(), payload.idx.clone()
    mag = g.abs()
    srt = mag.sort(dim=1, descending=True).values
    k = idx.shape[1]
    clear = (srt[:, k - 1] > 0) & (srt[:, k] < srt[:, k - 1] * 0.5)
    r = int(torch.where(clear, srt[:, k - 1], torch.zeros_like(srt[:, 0])).argmax())
    col = int(mag[r].argmin())
    idx[r, k - 1] = col
    vals[r, k - 1] = g[r, col]
    return gc.TopkRows(vals=vals, idx=idx)


@pytest.mark.parametrize("cache_update", ["psum", "stale"])
@pytest.mark.parametrize("mode", ["fp16", "topk"])
def test_train_trajectory_compressed_matches_reference(mesh1, monkeypatch, mode,
                                                       cache_update):
    # fp16 is held from a shared state each step: its rounding puts the two
    # sides' rows 5e-5 apart, which a ReLU kink can amplify past the state
    # bar over 8 steps under some packing salts (PYTHONHASHSEED 29, 36).
    # topk compounds over the 8 steps with a tie-aware selection
    # (_TieAwareTopk); a row may part from the reference's selection only
    # where the reference's own row ties
    ties = _TieAwareTopk(monkeypatch) if mode == "topk" else None
    check_train_trajectory(mesh1, "deepfm", cache_update, 1, shared_state=mode == "fp16",
                           grad_compress=mode)
    if ties is not None:
        assert ties.calls and not ties.untied


def test_topk_tie_takes_the_port_selection():
    """A row built with an exact magnitude tie at the k-th kept column
    (columns 2 and 8, k = 2) that the reference breaks one way and the
    port the other: the reference takes the port's columns, and its
    decompressed row is then the port's. Untied rows keep the reference's
    selection."""
    d, k = 10, gc.topk_k(10)
    rng = np.random.default_rng(5)
    g = (rng.normal(size=(6, d)) * 0.01).astype(np.float32)
    g[1, 5], g[1, 2], g[1, 8] = 0.5, 0.0398341864, -0.0398341864
    # the reference's own row: the same sums two ulps apart, so it keeps 8
    g_ref = g.copy()
    g_ref[1, 8] = np.nextafter(np.nextafter(g_ref[1, 8], np.float32(-1)), np.float32(-1))
    _, idx_ref = jref.topk_compress_ref(jnp.asarray(g_ref), k)
    vals_p, idx_p = ops.compress_topk(_t(g), k)
    idx_ref = np.asarray(idx_ref)
    assert sorted(idx_ref[1]) == [5, 8] and sorted(idx_p.numpy()[1]) == [2, 5]
    out, tied, untied = _reconcile_topk(g_ref, idx_ref, idx_p.numpy())
    assert tied == [1] and untied == []
    np.testing.assert_array_equal(out[1], idx_p.numpy()[1])
    np.testing.assert_array_equal(np.delete(out, 1, 0), np.delete(idx_ref, 1, 0))
    vals = np.take_along_axis(g_ref, out, axis=1)
    np.testing.assert_allclose(np.asarray(jref.topk_decompress_ref(jnp.asarray(vals),
                                                                   jnp.asarray(out), d)),
                               ops.decompress_topk(vals_p, idx_p, d).numpy(), atol=1e-9,
                               rtol=0)


def test_topk_untied_selection_change_is_not_taken():
    """A port selection that differs where the reference's row has no tie
    (its second column swapped for its smallest) is reported and left as
    the reference's."""
    d, k = 10, gc.topk_k(10)
    g = (np.random.default_rng(6).normal(size=(6, d))).astype(np.float32)
    _, idx_ref = jref.topk_compress_ref(jnp.asarray(g), k)
    idx_ref = np.asarray(idx_ref)
    idx_p = idx_ref.copy()
    idx_p[3, 1] = int(np.abs(g[3]).argmin())
    out, tied, untied = _reconcile_topk(g, idx_ref, idx_p)
    assert tied == [] and untied == [3]
    np.testing.assert_array_equal(out, idx_ref)


def test_tie_aware_trajectory_fails_on_an_untied_selection_change(mesh1, monkeypatch):
    """The whole tie-aware trajectory check still fails when the port keeps
    a wrong column in one untied row at step 2."""
    ties = _TieAwareTopk(monkeypatch, port_hook=_flip_untied_row)
    with pytest.raises(AssertionError):
        check_train_trajectory(mesh1, "deepfm", "psum", 1, grad_compress="topk")
    assert ties.untied


def test_train_trajectory_dense_bf16_psum_matches_reference(mesh1):
    check_train_trajectory(mesh1, "deepfm", "psum", 1, grad_compression="bf16")


def test_train_launcher_runs_grad_compress_topk_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "deepfm", "--smoke",
         "--device", "cpu", "--steps", "3", "--global-batch", "32", "--log-every", "1",
         "--grad-compress", "topk"],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    steps = re.findall(r"^  step +(\d+) loss=([\d.]+) hits=(\d+) ovf=(\d+)$", out.stdout,
                       re.M)
    assert [int(s[0]) for s in steps] == [1, 2, 3], out.stdout
    assert all(np.isfinite(float(s[1])) for s in steps)
    assert out.stdout.rstrip().endswith("[train] done")


# ------------------------------------------------- the decompression kernel


@pytest.mark.parametrize("m,d,plan", [
    (15_976, 10, (64, 64)),        # deepfm-topk training: 250 blocks (128 rows: 125)
    (13_312, 16, (64, 64)),        # a dcn-v2-sized bucket at D = 16
    (15_976, 4, (64, 64)),         # the narrow d = 4
    (4_089_448, 10, (256, 256)),   # bulk: 15,975 tiles of 10 KB
    (1, 10, (4, 32)),              # one row
    (3, 129, (4, 64)),             # three rows at D = 129: 387 floats, a scalar tail
    (100_000, 129, (64, 256)),     # D = 129: 128 rows would pass 48 KB
    (100_000, 1, (256, 256)),      # D = 1
    (50, 3_072, (4, 256)),         # four rows fill 48 KB exactly
    (50, 3_073, (4, 256))])        # not even four rows fit: built in the output
def test_topk_decompress_plan_by_hand(m, d, plan):
    """Rows a tile: the largest power of two from 4 to 256 that gives each
    of an H100's 132 SMs a block where m allows and whose rows * D floats
    fit 48 KB, else 4. Threads: one a row and enough for at most four
    16-byte stores each (64 rows x 129 floats: 516 -> 256), 32 to 256."""
    assert ops.topk_decompress_plan(m, d, 132) == plan
    rows, threads = plan
    assert rows % 4 == 0 and threads % 32 == 0 and 32 <= threads <= 256
    assert -(-m // rows) >= 132 or rows == 4
    assert rows * d * 4 <= 48 * 1024 or rows == 4


def _topk_kernel(vals, idx, d, rows, threads, offsets=(0, 0)):
    """The decompression kernel's index arithmetic and stores, in numpy:
    per tile of ``rows`` rows, zero the tile (whole float4s), set each
    row's in-range columns in ascending j (the column taken as unsigned),
    then write the tile with 16-byte stores and a scalar tail; where four
    rows pass 48 KB, the same steps on the output itself. ``vals`` and
    ``idx`` lie at byte offsets ``offsets`` off 16 (a view). Asserts that
    every 16-byte access is aligned on both sides, every entry lands in its
    own row's slice of the tile, and each output float is written once
    after its tile is built; returns the output."""
    m, k = vals.shape
    staged = rows * d * 4 <= 48 * 1024
    out = np.full(m * d, np.float32(7.0))
    writes = np.zeros(m * d, np.int64)
    for blk in range(-(-m // rows)):
        r0 = blk * rows
        cnt = min(rows, m - r0)
        n = cnt * d
        assert (4 * r0 * d) % 16 == 0  # the tile's base in the output
        tile = np.zeros(4 * (-(-n // 4)) if staged else n, np.float32)
        assert not staged or tile.size <= rows * d
        for r in range(cnt):  # a thread a row, its entries in order
            for j in range(k):
                e = (r0 + r) * k + j
                assert (offsets[0] + 4 * e) % 4 == 0 and (offsets[1] + 4 * e) % 4 == 0
                c = int(np.uint32(idx[r0 + r, j]))
                if c < d:
                    assert r * d <= r * d + c < (r + 1) * d
                    tile[r * d + c] = vals[r0 + r, j]
        if staged:
            for i in range(n // 4):  # shared float4 i to the output's
                assert (16 * i) % 16 == 0 and (4 * (r0 * d + 4 * i)) % 16 == 0
        out[r0 * d: r0 * d + n] = tile[:n]
        writes[r0 * d: r0 * d + n] += 1
    assert (writes == 1).all()
    return out.reshape(m, d)


def _topk_edge_case(m, d, k, seed):
    """Compressed rows with the decompression edges: columns -1, D and
    2^31 - 1, a column repeated in a row, NaN and -0.0 values."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, (m, k)).astype(np.int32)
    vals = rng.normal(size=(m, k)).astype(np.float32)
    kind = rng.integers(0, 8, m)
    bad = np.array([-1, d, 2 ** 31 - 1], np.int32)
    idx[kind == 0, 0] = bad[rng.integers(0, 3, int((kind == 0).sum()))]
    if k > 1:
        idx[kind == 1, 1] = idx[kind == 1, 0]
    vals[kind == 2, 0] = np.nan
    vals[kind == 3, k - 1] = -0.0
    return vals, idx


@pytest.mark.parametrize("m,d,k", [(1, 10, 2), (3, 129, 8), (37, 3, 3), (300, 10, 2),
                                   (300, 16, 4), (300, 4, 1), (70, 1, 1), (9, 3_100, 8)])
@pytest.mark.parametrize("offset", [0, 4, 8, 12])
def test_topk_decompress_tiles_write_each_float_once(m, d, k, offset):
    """The kernel's tiles, emulated, write each output float exactly once
    with every 16-byte access aligned, whatever the alignment of the
    ``vals`` and ``idx`` views (read a float at a time), and give bitwise
    the plain version's output on rows with out-of-range columns, repeated
    columns, NaN and -0.0; at the plan's tiles and at smaller ones."""
    vals, idx = _topk_edge_case(m, d, k, m + d + k)
    want = ops.decompress_topk(_t(vals), _t(idx), d).numpy()
    rows, threads = ops.topk_decompress_plan(m, d, 132)
    for r in {rows, 4}:
        _same_bits(_topk_kernel(vals, idx, d, r, threads, (offset, 12 - offset)), want)


def test_topk_decompress_plain_takes_the_later_entry_and_drops_negatives():
    """A column repeated in a row: the later entry wins (the kernel's
    ascending j and the plain version's scatter alike); a negative column,
    or one at or past D, is dropped."""
    vals = np.array([[1.0, 2.0, 3.0], [4.0, -0.0, 5.0], [6.0, 7.0, 8.0]], np.float32)
    idx = np.array([[1, 1, -1], [2, 2, 4], [-2147483648, 3, 0]], np.int32)
    out = ops.decompress_topk(_t(vals), _t(idx), 4).numpy()
    want = np.array([[0.0, 2.0, 0.0, 0.0], [0.0, 0.0, -0.0, 0.0], [8.0, 0.0, 0.0, 7.0]],
                    np.float32)
    _same_bits(out, want)
    _same_bits(_topk_kernel(vals, idx, 4, 4, 32), want)


def test_topk_decompress_wrapper_hands_the_launcher_its_plan(monkeypatch):
    seen = []
    monkeypatch.setattr(ops, "_launch", lambda name, *a: seen.append((name, a)))
    monkeypatch.setattr(ops, "sm_count", lambda device: 132)
    for m, d, k in ((15_976, 10, 2), (300, 16, 4), (3, 129, 8)):
        vals, idx = torch.zeros((m, k)), torch.zeros((m, k), dtype=torch.int32)
        out = ops._topk_decompress_cuda(vals, idx, d)
        name, args = seen[-1]
        assert name == "topk_decompress" and args[:3] == (vals.data_ptr(), idx.data_ptr(),
                                                          out.data_ptr())
        assert args[3:] == (m, d, k, *ops.topk_decompress_plan(m, d, 132))
        assert out.shape == (m, d) and out.data_ptr() % 16 == 0
    ops._topk_decompress_cuda(torch.zeros((0, 2)), torch.zeros((0, 2), dtype=torch.int32), 10)
    assert len(seen) == 3  # no rows launch nothing


# --------------------------------------------------- the compression kernels


@pytest.mark.parametrize("m,d,plan", [
    (15_976, 10, (120, 160, 1)),       # deepfm-fp16 training: 134 tiles of 120 rows
    (10_652, 16, (80, 160, 1)),        # dcn-v2's bucket at D = 16: 160 groups of 8
    (15_976, 4, (128, 128, 0)),        # the narrow d = 4: direct
    (10_652, 32, (80, 256, 1)),        # DLRM's narrow d = 32: 320 groups of 8
    (4_089_448, 10, (256, 256, 1)),    # bulk: 320 groups
    (1, 10, (8, 32, 1)),               # one row
    (9, 9, (8, 32, 1)),                # two tiles, the second of one row
    (9, 8, (128, 128, 0)),             # under 9 floats a row: direct
    (3, 129, (8, 160, 1)),             # 8 x 129 outputs: 129 groups
    (100_000, 1_534, (8, 256, 1)),     # eight rows of 1,534 fill 48 KB
    (100_000, 1_535, (128, 128, 0))])  # past 48 KB: direct
def test_fp16_compress_plan_by_hand(m, d, plan):
    """Staged from D = 9: rows a tile m // 132 rounded down to a multiple of
    8 (each of an H100's 132 SMs gets a block where m allows), 8 to 256,
    and no more than fit 48 KB at 4 * D + 4 bytes a row (12 of slack);
    threads one a row and one a group of 8 halves (a 16-byte store), 32 to
    256. Narrower rows, or eight rows past 48 KB: direct, 128 rows of a
    thread each."""
    assert ops.fp16_compress_plan(m, d, 132) == plan
    rows, threads, staged = plan
    assert threads % 32 == 0 and 32 <= threads <= 256
    if staged:
        assert rows % 8 == 0 and (-(-m // rows) >= 132 or rows == 8)
        assert 4 * (rows * (d + 1) + 3) <= 48 * 1024
        assert threads >= min(rows, 256)
        assert threads >= -(-rows * d // 8) or threads == 256
    else:
        assert rows == threads == 128


@pytest.mark.parametrize("m,d,k,plan", [
    (15_976, 10, 2, (128, 128, 0)),     # deepfm-topk training: one scan, direct
    (10_652, 16, 4, (128, 128, 0)),     # dcn-v2 at k = 4
    (15_976, 4, 1, (128, 128, 0)),      # the narrow d = 4, k = 1
    (10_652, 32, 8, (128, 128, 0)),     # DLRM's d = 32, k = 8
    (4_089_448, 10, 2, (128, 128, 0)),  # bulk
    (7, 10, 10, (8, 32, 1)),            # k = D = 10: ten passes, staged
    (30, 12, 9, (8, 32, 1)),            # the first k of the passes
    (3, 129, 32, (8, 32, 1)),           # D = 129, k = 32
    (100_000, 129, 32, (56, 64, 1)),    # 56 rows of 772 bytes fit 48 KB
    (4_089_448, 40, 10, (200, 224, 1)),  # bulk at D = 40: 200 rows of 240 bytes fit
    (100_000, 1_023, 255, (8, 32, 1)),  # eight rows of 6,132 bytes: 49,068 with slack
    (100_000, 1_024, 256, (128, 128, 0))])  # past 48 KB: direct
def test_topk_compress_plan_by_hand(m, d, k, plan):
    """Staged only where the kernel makes k passes (k > 8): rows a tile as
    for fp16 at 4 * D + 8 * k bytes a row (the staged floats and the tile's
    vals and idx), a thread a row (32 to 256). The one-scan selection of
    k <= 8, and eight rows past 48 KB: direct, 128 rows of a thread each."""
    assert ops.topk_compress_plan(m, d, k, 132) == plan
    rows, threads, staged = plan
    if staged:
        assert k > 8 and rows % 8 == 0 and (-(-m // rows) >= 132 or rows == 8)
        assert 4 * (rows * (d + 2 * k) + 3) <= 48 * 1024
        assert threads == min(256, max(32, -(-rows // 32) * 32))
    else:
        assert rows == threads == 128


def _scan_start(d, r):
    """``row_scan_start``: the column at which row r of a tile starts."""
    p = min(d & -d, 32)
    return ((r & 31) * p) >> 5


@pytest.mark.parametrize("d", list(range(1, 41)) + [64, 96, 128, 129, 1_024])
@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_row_scan_spreads_a_warp_over_the_banks(d, shift):
    """At every step of the rotated scan the 32 rows of a warp, d floats
    apart in shared memory from a staging buffer shifted by 0-3 floats,
    load from 32 distinct banks; each row visits each column once."""
    for i in range(d):
        banks = {(shift + r * d + (_scan_start(d, r) + i) % d) % 32 for r in range(32)}
        assert len(banks) == 32, (d, i)
    for r in range(32):
        assert sorted((_scan_start(d, r) + i) % d for i in range(d)) == list(range(d))


def _stage(g, r0, cnt, d, goff, buf_bytes, writes):
    """``row_stage_issue`` in numpy: rows [r0, r0 + cnt) of g as the tile's
    one contiguous range of floats, g a view ``goff`` bytes off 16. Returns
    ``(staged floats, byte address in shared memory of the first)``. Asserts
    that every 16-byte copy is aligned on both sides, 4-byte ones are used
    only for the head and the tail, and every float lands once inside the
    buffer of total + 3 floats at ``buf_bytes``."""
    total = cnt * d
    src = goff + 4 * r0 * d
    lead = ((16 - (src & 15)) & 15) >> 2
    head = min(lead, total)
    sm = buf_bytes + 4 * ((4 - head) & 3)
    n4 = (total - head) >> 2
    tail = head + 4 * n4
    flat = g.reshape(-1)[r0 * d: r0 * d + total]
    staged = np.full(total, np.float32(np.nan))
    copied = np.zeros(total, np.int64)
    for e in range(n4):
        at = head + 4 * e
        assert (sm + 4 * at) % 16 == 0 and (src + 4 * at) % 16 == 0
        staged[at: at + 4] = flat[at: at + 4]
        copied[at: at + 4] += 1
    for at in list(range(head)) + list(range(tail, total)):
        staged[at] = flat[at]
        copied[at] += 1
    assert (copied == 1).all() and total - tail < 4 and head < 4
    assert buf_bytes <= sm and sm + 4 * total <= buf_bytes + 4 * (total + 3)
    writes.append(total)
    return staged, sm


def _nan_max(a, b):
    return a if (np.isnan(a) or a > b) else b


def _scan(d, c0):
    """The columns of a scan from c0: c0 .. D-1, then 0 .. c0-1."""
    return list(range(c0, d)) + list(range(c0))


def _row_amax(row, d, c0):
    """``row_amax``: the rotated scan keeping the NaN of the highest
    column."""
    amax, nan, nan_col = np.float32(0.0), np.float32(0.0), -1
    for c in _scan(d, c0):
        a = np.abs(row[c])
        if np.isnan(a):
            if c > nan_col:
                nan_col, nan = c, a
        elif a > amax:
            amax = a
    return nan if nan_col >= 0 else amax


def _scaled(x, den):
    """``scaled``: x / den, a zero over a number returned as it is."""
    if x == 0 and not np.isnan(den):
        return x
    with np.errstate(invalid="ignore"):  # inf / inf, NaN, as the card
        return x / den


def _fp16_compress_kernel(g, rows, threads, goff=0):
    """The staged fp16 compression kernel's index arithmetic, loads and
    stores, in numpy: per tile the staging, a thread a row for the amax and
    divisor (s stored per row), then each thread's groups of 8 outputs with
    row and column stepped (checked against a division each), float4 reads
    of the staged copy where g is aligned, one 16-byte store a group and
    the last tile's scalar tail. Asserts every 16-byte access aligned and
    each output written once; returns ``(q, s)``."""
    m, d = g.shape
    q = np.zeros(m * d, np.float16)
    s = np.zeros(m, np.float32)
    q_writes = np.zeros(m * d, np.int64)
    s_writes = np.zeros(m, np.int64)
    staged_counts = []
    assert rows % 8 == 0
    for blk in range(-(-m // rows)):
        r0 = blk * rows
        cnt = min(rows, m - r0)
        n = cnt * d
        x, x_at = _stage(g, r0, cnt, d, goff, 4 * rows, staged_counts)
        vec = x_at % 16 == 0
        assert vec == (goff == 0)
        den = np.zeros(rows, np.float32)
        for r in range(cnt):
            amax = _row_amax(x[r * d:(r + 1) * d], d, _scan_start(d, r))
            den[r] = _nan_max(amax, np.float32(1e-30))
            s[r0 + r] = amax
            s_writes[r0 + r] += 1
        qt = r0 * d  # the tile's first half
        step = 8 * threads
        drow, dcol = divmod(step, d)
        for t in range(threads):
            e = 8 * t
            row, col = divmod(e, d)
            for _ in range(t, n >> 3, threads):
                if vec:
                    assert (x_at + 4 * e) % 16 == 0 and (x_at + 4 * e + 16) % 16 == 0
                rr, cc = row, col
                out = np.zeros(8, np.float16)
                for i in range(8):
                    assert (rr, cc) == divmod(e + i, d)
                    out[i] = _scaled(x[e + i], den[rr]).astype(np.float16)
                    cc += 1
                    if cc == d:
                        cc, rr = 0, rr + 1
                assert (2 * (qt + e)) % 16 == 0
                q[qt + e: qt + e + 8] = out
                q_writes[qt + e: qt + e + 8] += 1
                e += step
                row += drow
                col += dcol
                if col >= d:
                    col, row = col - d, row + 1
        assert blk == -(-m // rows) - 1 or n % 8 == 0  # only the last tile has a tail
        for t in range(n & 7):
            et = (n & ~7) + t
            q[qt + et] = _scaled(x[et], den[et // d]).astype(np.float16)
            q_writes[qt + et] += 1
    assert (q_writes == 1).all() and (s_writes == 1).all() and sum(staged_counts) == m * d
    return q.reshape(m, d), s.reshape(m, 1)


def _rank_key(x, c):
    """``rank_key``: |x|'s bits (every NaN one value above +inf) above the
    column's 32-bit complement; the larger key ranks first."""
    a = np.abs(np.float32(x))
    hi = 0x7FC00000 if np.isnan(a) else int(np.array(a).view(np.uint32))
    return (hi << 32) | (~c & 0xFFFFFFFF)


def _key_col(key):
    return int(np.array(~key & 0xFFFFFFFF, np.uint32).view(np.int32))


def _topk_select(row, d, k, c0):
    """``topk_row``: for k <= 8 the one-scan insertion of keys into K = 1,
    2, 4 or 8 slots (k rounded up), past 8 the k passes, both from c0."""
    if k <= 8:
        K = 1 if k == 1 else 2 if k == 2 else 4 if k <= 4 else 8
        key = [0] * K
        for c in _scan(d, c0):
            x = _rank_key(row[c], c)
            b = [x > key[j] for j in range(K)]
            for j in range(K - 1, 0, -1):
                key[j] = key[j - 1] if b[j - 1] else (x if b[j] else key[j])
            if b[0]:
                key[0] = x
        cols = [_key_col(key[j]) for j in range(k)]
    else:
        cols, prev = [], (1 << 64) - 1
        for _ in range(k):
            best = 0
            for c in _scan(d, c0):
                x = _rank_key(row[c], c)
                if prev > x > best:
                    best = x
            cols.append(_key_col(best))
            prev = best
    return np.array([row[j] for j in cols], np.float32), np.array(cols, np.int32)


def _topk_compress_kernel(g, k, rows, goff=0):
    """The staged top-k compression kernel in numpy: per tile the staging,
    a thread a row selecting into the tile's [rows, k] vals and idx in
    shared memory, then both written whole with 16-byte stores and the
    last tile's scalar tail. Asserts every 16-byte access
    aligned and each output written once; returns ``(vals, idx)``."""
    m, d = g.shape
    vals = np.zeros(m * k, np.float32)
    idx = np.zeros(m * k, np.int32)
    writes = np.zeros((2, m * k), np.int64)
    staged_counts = []
    assert rows % 8 == 0
    for blk in range(-(-m // rows)):
        r0 = blk * rows
        cnt = min(rows, m - r0)
        x, _ = _stage(g, r0, cnt, d, goff, 8 * rows * k, staged_counts)
        sv = np.zeros(rows * k, np.float32)
        si = np.zeros(rows * k, np.int32)
        for r in range(cnt):
            sv[r * k:(r + 1) * k], si[r * k:(r + 1) * k] = _topk_select(
                x[r * d:(r + 1) * d], d, k, _scan_start(d, r))
        for out, tile, w, sm_at in ((vals, sv, writes[0], 0), (idx, si, writes[1], 4 * rows * k)):
            n = cnt * k
            for i in range(n >> 2):  # shared uint4 i to the output's
                assert (sm_at + 16 * i) % 16 == 0 and (4 * (r0 * k + 4 * i)) % 16 == 0
                out[r0 * k + 4 * i: r0 * k + 4 * i + 4] = tile[4 * i: 4 * i + 4]
                w[r0 * k + 4 * i: r0 * k + 4 * i + 4] += 1
            assert blk == -(-m // rows) - 1 or n % 4 == 0
            for t in range(n & 3):
                out[r0 * k + (n & ~3) + t] = tile[(n & ~3) + t]
                w[r0 * k + (n & ~3) + t] += 1
    assert (writes == 1).all() and sum(staged_counts) == m * d
    return vals.reshape(m, k), idx.reshape(m, k)


def _edge_rows(m, d, seed):
    """``_rows`` plus the edges: NaN rows (one of them with two NaNs of
    different payloads), +-inf, -0.0 entries, all -0.0 rows."""
    g, kind = _rows(m, d, seed)
    rng = np.random.default_rng(seed + 1)
    bits = g.view(np.uint32)
    for r in range(m):
        e = rng.integers(0, 16)
        c = rng.integers(0, d, 2)
        if e == 0:
            bits[r, c[0]] = 0x7FC00001
            bits[r, c[1]] = 0xFFC12345  # when the columns differ, two payloads
        elif e == 1:
            g[r, c[0]] = np.inf
            g[r, c[1]] = -np.inf
        elif e == 2:
            g[r, c] = -0.0
        elif e == 3:
            g[r] = -0.0
    return g, kind


# (m, D): the path widths at small m, D = 1, 3, 129, odd m, one tile short of 8 rows
KERNEL_SHAPES = [(300, 10), (37, 16), (300, 4), (41, 32), (1, 10), (9, 3), (19, 1), (7, 129)]


def _fp16_direct(g):
    """The direct fp16 kernel: a thread a row, its amax scanned from column
    0, its halves divided in place."""
    m, d = g.shape
    q = np.zeros((m, d), np.float16)
    s = np.zeros((m, 1), np.float32)
    for r in range(m):
        s[r, 0] = amax = _row_amax(g[r], d, 0)
        den = _nan_max(amax, np.float32(1e-30))
        for c in range(d):
            q[r, c] = _scaled(g[r, c], den).astype(np.float16)
    return q, s


@pytest.mark.parametrize("m,d", KERNEL_SHAPES)
@pytest.mark.parametrize("goff", [0, 4, 8, 12])
def test_fp16_compress_tiles_write_each_half_once(m, d, goff):
    """The fp16 kernel's staged tiles, emulated, stage g with aligned
    16-byte copies whatever the view's offset, write each half and each
    scale once with aligned 16-byte stores, and give bitwise
    ``ops.compress_fp16`` on the CPU (zero rows, ties, float16-subnormal
    ratios, NaN, +-inf, -0.0), at the plan's tile where it stages and at
    the smallest; the direct route (narrow rows) gives the same bits."""
    g, _ = _edge_rows(m, d, 7 * m + d)
    q, s = ops.compress_fp16(_t(g))
    rows, threads, staged = ops.fp16_compress_plan(m, d, 132)
    assert staged == (d >= 9)
    for r, th in {(rows, threads) if staged else (8, 32), (8, 32)}:
        eq, es = _fp16_compress_kernel(g, r, th, goff)
        _same_bits(eq, q.numpy(), f"q rows={r}")
        _same_bits(es, s.numpy(), f"s rows={r}")
    eq, es = _fp16_direct(g)
    _same_bits(eq, q.numpy(), "q direct")
    _same_bits(es, s.numpy(), "s direct")


@pytest.mark.parametrize("d", [3, 10, 16])
def test_fp16_rotated_amax_keeps_the_last_nan_payload(d):
    """The rotated amax scan keeps the bits the ascending nan_max scan of
    the earlier kernel kept: the largest magnitude, or |NaN| of the highest
    column, payload and all, from every start column."""
    rng = np.random.default_rng(d)
    for _ in range(200):
        row = rng.normal(size=d).astype(np.float32)
        bits = row.view(np.uint32)
        for c in rng.choice(d, rng.integers(0, min(d, 3) + 1), replace=False):
            bits[c] = rng.choice([0x7FC00000, 0xFFC00000]) | rng.integers(1, 1 << 22)
        want = np.float32(0.0)
        for c in range(d):
            want = _nan_max(np.abs(row[c]), want)
        for c0 in range(d):
            got = _row_amax(row, d, c0)
            assert np.array(got).view(np.uint32) == np.array(want).view(np.uint32)


@pytest.mark.parametrize("m,d,k", [(300, 10, 2), (37, 16, 4), (300, 4, 1), (41, 32, 8),
                                   (1, 10, 2), (9, 3, 3), (19, 1, 1), (7, 129, 32),
                                   (30, 10, 10), (30, 8, 8), (30, 12, 5), (30, 12, 9)])
@pytest.mark.parametrize("goff", [0, 4, 8, 12])
def test_topk_compress_tiles_write_each_entry_once(m, d, k, goff):
    """The top-k kernel's staged tiles, emulated (insertion for k <= 8 with
    k = 3 and 5 rounded up to 4 and 8 slots, the passes past 8), stage g
    with aligned copies whatever the view's offset, write each entry once
    with aligned 16-byte stores, and give bitwise ``ops.compress_topk`` on
    the CPU, ties, NaN, +-inf and -0.0 included, at the plan's tile where
    it stages and at the smallest; the direct route (a thread a row from
    column 0) gives the same bits."""
    g, _ = _edge_rows(m, d, 5 * m + d + k)
    vals, idx = ops.compress_topk(_t(g), k)
    rows, _, staged = ops.topk_compress_plan(m, d, k, 132)
    assert staged == (k > 8)
    for r in {rows if staged else 8, 8}:
        ev, ei = _topk_compress_kernel(g, k, r, goff)
        _same_bits(ev, vals.numpy(), f"vals rows={r}")
        _same_bits(ei, idx.numpy(), f"idx rows={r}")
    direct = [_topk_select(g[r], d, k, 0) for r in range(m)]
    _same_bits(np.stack([v for v, _ in direct]), vals.numpy(), "vals direct")
    _same_bits(np.stack([i for _, i in direct]), idx.numpy(), "idx direct")


@pytest.mark.parametrize("d", [4, 10, 16])
def test_topk_emulation_matches_pallas_on_tied_and_nan_rows(d):
    """The emulated kernel against ``topk_compress_pallas`` in interpret
    mode, bitwise, on rows tied at their maximum with mixed signs, all-tied
    rows and zero rows; on NaN rows against ``lax.top_k`` (the reference's
    plain version), where the Pallas kernel finds no maximum and emits
    column D (pinned in ``test_nan_rows_follow_the_reference_not_the_pallas_topk``)."""
    g, kind = _rows(M, d, 3 * d)
    k = gc.topk_k(d)
    tied = (kind == 4) | (kind == 5) | (kind < 4)
    ev, ei = _topk_compress_kernel(g, k, 8)
    pv, pi = topk_compress_pallas(jnp.asarray(g), k, interpret=True)
    _same_bits(ev[tied], np.asarray(pv)[tied], "vals vs pallas on tied rows")
    _same_bits(ei[tied], np.asarray(pi)[tied], "idx vs pallas on tied rows")
    _same_bits(ev, np.asarray(pv), "vals vs pallas")
    _same_bits(ei, np.asarray(pi), "idx vs pallas")
    nan = g.copy()
    rng = np.random.default_rng(d)
    rows = rng.choice(M, 40, replace=False)
    nan[rows, rng.integers(0, d, 40)] = np.nan
    nan[rows[:20], rng.integers(0, d, 20)] = np.nan  # some rows hold two
    ev, ei = _topk_compress_kernel(nan, k, 8)
    jv, ji = jref.topk_compress_ref(jnp.asarray(nan), k)
    _same_bits(ev, jv, "vals vs lax.top_k with NaN rows")
    _same_bits(ei, ji, "idx vs lax.top_k with NaN rows")
    assert (np.asarray(topk_compress_pallas(jnp.asarray(nan), k, interpret=True)[1])[rows]
            == d).all()


def _hand_over(monkeypatch):
    seen = []
    monkeypatch.setattr(ops, "_launch", lambda name, *a: seen.append((name, a)))
    monkeypatch.setattr(ops, "sm_count", lambda device: 132)
    return seen


@pytest.mark.parametrize("m,d", [(15_976, 10), (300, 16), (15_976, 4), (3, 129), (5, 1_600)])
def test_fp16_compress_wrapper_hands_the_launcher_its_plan(monkeypatch, m, d):
    seen = _hand_over(monkeypatch)
    g = torch.zeros((m, d))
    q, s = ops._fp16_compress_cuda(g)
    (name, args), = seen
    assert name == "fp16_compress" and args[:3] == (g.data_ptr(), q.data_ptr(), s.data_ptr())
    assert args[3:] == (m, d, *ops.fp16_compress_plan(m, d, 132))
    assert q.shape == (m, d) and s.shape == (m, 1) and q.data_ptr() % 16 == 0
    ops._fp16_compress_cuda(torch.zeros((0, d)))
    assert len(seen) == 1  # no rows launch nothing


@pytest.mark.parametrize("m,d,k", [(15_976, 10, 2), (300, 16, 4), (7, 10, 10), (3, 129, 32),
                                   (5, 1_600, 400)])
def test_topk_compress_wrapper_hands_the_launcher_its_plan(monkeypatch, m, d, k):
    seen = _hand_over(monkeypatch)
    g = torch.zeros((m, d))
    vals, idx = ops._topk_compress_cuda(g, k)
    (name, args), = seen
    assert name == "topk_compress" and args[:3] == (g.data_ptr(), vals.data_ptr(),
                                                    idx.data_ptr())
    assert args[3:] == (m, d, k, *ops.topk_compress_plan(m, d, k, 132))
    assert vals.data_ptr() % 16 == 0 and idx.data_ptr() % 16 == 0
    ops._topk_compress_cuda(torch.zeros((0, d)), k)
    assert len(seen) == 1  # no rows launch nothing


# ------------------------------------------------- the fp16 decompression kernel


@pytest.mark.parametrize("m,d,plan", [
    (15_976, 10, (157, 256)),       # deepfm-fp16 training: 39,940 quads
    (10_652, 16, (167, 256)),       # dcn-v2's bucket at D = 16
    (15_976, 4, (63, 256)),         # the narrow d = 4: 15,976 quads
    (10_652, 32, (333, 256)),       # DLRM's narrow d = 32
    (4_089_448, 10, (19_969, 256)),  # bulk: two quads a thread
    (1, 1, (1, 256)),               # one element
    (3, 3, (1, 256)),               # m * D = 9: three quads
    (132 * 2048, 4, (1_056, 256)),  # every quad resident: one round
    (132 * 2048 + 1, 4, (529, 256)),  # one quad past: two rounds
    (2_000_000_000, 3, (2_929_688, 256))])  # m * D past 2^32
def test_fp16_decompress_plan_by_hand(m, d, plan):
    """Blocks of 256 threads, a thread a quad of 4 outputs, or two where the
    ceil(m * D / 4) quads pass the 2,048 threads each of an H100's 132 SMs
    holds at once."""
    assert ops.fp16_decompress_plan(m, d, 132) == plan
    blocks, threads = plan
    quads = -(-m * d // 4)
    rounds = 1 if quads <= 132 * 2048 else 2
    assert threads == 256 and blocks == -(-quads // (256 * rounds)) < 2**31


def _fast_div(x, d):
    """The kernel's x // d for 0 <= x < 2^31: a multiply-high by
    ceil(2^p / d), p = 31 + ceil(log2 d), shifted by p - 32."""
    if d == 1:
        return x
    p = 31 + (d - 1).bit_length()
    return ((x * (((1 << p) + d - 1) // d)) >> 32) >> (p - 32)


def test_fp16_decompress_fast_division_is_exact():
    """The multiply-high division equals x // d for every D a row can have
    up to 2^31 - 1 at the offsets that stress it (0, d - 1, d, multiples of
    d and their neighbours, 2^31 - 1), and on random offsets."""
    rng = np.random.default_rng(0)
    ds = list(range(1, 300)) + [2**k + o for k in range(9, 31) for o in (-1, 0, 1)
                                if 0 < 2**k + o < 2**31]
    for d in ds:
        xs = {0, d - 1, d, 2**31 - 1} | {q * d + o for q in (1, 2, 3, (2**31 - 1) // d)
                                         for o in (-1, 0, 1)}
        xs |= set(rng.integers(0, 2**31, 64).tolist())
        for x in xs:
            if 0 <= x < 2**31:
                assert _fast_div(x, d) == x // d, (x, d)


@np.errstate(invalid="ignore")  # inf * 0 of a zero row gives its NaN
def _fp16_decompress_kernel(q, s, blocks, threads, qoff=0, ooff=0):
    """The decompression kernel's launcher and index arithmetic, in numpy:
    ``q`` (halves) at ``qoff`` bytes off 16 and the output at ``ooff``; a
    scalar head up to out's 16-byte boundary and a scalar tail, quads of 4
    outputs in between, quad t, t + T, ... a thread (T threads), its first
    row from the multiply-high division (32-bit offsets) and then stepped by
    the host's quotient and remainder of the grid's stride. Asserts that
    every 16-byte store is aligned, every q load is aligned to its width,
    every quad's row and column are right, and each output is written once;
    returns the output."""
    m, d = q.shape
    n = m * d
    qf, sf = q.reshape(-1).astype(np.float32), s.reshape(-1)
    out = np.full(n, np.float32(7.0))
    writes = np.zeros(n, np.int64)

    def put(e, x):
        out[e] = x
        writes[e] += 1

    e0 = min(n, ((16 - ooff % 16) % 16) // 4)
    quads = (n - e0) // 4
    qa = (qoff + 2 * e0) % 8
    qw = 8 if qa == 0 else (4 if qa % 4 == 0 else 2)
    total = blocks * threads
    assert n + 8 * total < 2**31  # the 32-bit route
    r_step, c_step = divmod(4 * total, d)
    tail0 = e0 + 4 * quads

    def scales(r, c):
        if d >= 4:  # two rows at most: both read, the right one taken
            s0, s1 = sf[r], sf[min(r + 1, m - 1)]
            return [s0 if c + k < d else s1 for k in range(4)]
        out_ = []
        for _ in range(4):
            out_.append(sf[r])
            c += 1
            if c == d:
                c, r = 0, r + 1
        return out_

    for t in range(total):
        if t < quads:
            e = e0 + 4 * t
            r = _fast_div(e, d)
            c = e - r * d
            while True:
                assert (ooff + 4 * e) % 16 == 0 and (qoff + 2 * e) % qw == 0
                assert divmod(e, d) == (r, c)
                for k, sc in enumerate(scales(r, c)):
                    put(e + k, qf[e + k] * sc)
                e += 4 * total
                if e >= tail0:
                    break
                r, c = r + r_step, c + c_step
                if c >= d:
                    c, r = c - d, r + 1
        if t < e0:
            put(t, qf[t] * sf[t // d])
        if t < n - tail0:
            put(tail0 + t, qf[tail0 + t] * sf[(tail0 + t) // d])
    assert (writes == 1).all()
    return out.reshape(m, d)


def _fp16_edge_payload(m, d, seed):
    """Compressed rows with the decompression edges: half NaNs of several
    payloads and both signs, +-inf, -0.0, float16 subnormals, zero rows
    (scale 0), and scales from 1e-6 to 1e3."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1, 1, (m, d)).astype(np.float16)
    bits = q.view(np.uint16)
    pick = rng.random((m, d))
    special = np.array([0x7C01, 0xFE00, 0x7FFF, 0x7C00, 0xFC00, 0x8000, 0x0001, 0x83FF],
                       np.uint16)
    at = pick < 0.2
    bits[at] = special[rng.integers(0, special.size, int(at.sum()))]
    s = (10.0 ** rng.uniform(-6, 3, (m, 1))).astype(np.float32)
    zero = rng.random(m) < 0.3
    q[zero], s[zero] = 0, 0
    return q, s


@pytest.mark.parametrize("md", list(range(1, 18)))
@pytest.mark.parametrize("qoff,ooff", [(0, 0), (2, 0), (4, 4), (8, 8), (12, 12), (6, 4),
                                       (0, 12)])
def test_fp16_decompress_quads_write_each_float_once(md, qoff, ooff):
    """m * D of 1-17 at D = 1, 2, 3 and m * D itself (one row), with q
    and the output off 16 bytes: the emulated kernel writes each float once
    through aligned accesses and gives bitwise the plain version's output,
    at the plan's grid and at one warp (grid-stride)."""
    for d in sorted({1, 2, 3, md} & set(range(1, md + 1))):
        if md % d:
            continue
        q, s = _fp16_edge_payload(md // d, d, 31 * md + d)
        want = ops.decompress_fp16(_t(q), _t(s)).numpy()
        for blocks, threads in {ops.fp16_decompress_plan(md // d, d, 132), (1, 32)}:
            got = _fp16_decompress_kernel(q, s, blocks, threads, qoff, ooff)
            _same_bits(got, want, f"D={d} grid={blocks}x{threads}")


@pytest.mark.parametrize("m,d", [(300, 10), (37, 16), (300, 4), (41, 32), (100, 3),
                                 (250, 1), (7, 129)])
@pytest.mark.parametrize("qoff,ooff", [(0, 0), (2, 4), (12, 8)])
def test_fp16_decompress_quads_on_edge_payloads(m, d, qoff, ooff):
    """At path-like widths (deepfm D = 10, dcn-v2 16, the narrow 4, DLRM's
    32) and D = 1, 3 and 129, on NaN payloads, +-inf, -0.0, float16
    subnormals and zero rows, at a small grid so that every thread takes
    several rounds: bitwise the plain version's output."""
    q, s = _fp16_edge_payload(m, d, m + d)
    want = ops.decompress_fp16(_t(q), _t(s)).numpy()
    assert not want[s[:, 0] == 0].any()
    for blocks, threads in ((1, 32), (3, 32), (2, 64)):
        _same_bits(_fp16_decompress_kernel(q, s, blocks, threads, qoff, ooff), want)


@pytest.mark.parametrize("d", [32, 128])
def test_fp16_decompress_plain_matches_reference_and_pallas_at_dlrm_widths(d):
    """DLRM's narrow d = 32 and its D = 128, on edge payloads: the plain
    version bitwise the reference and its Pallas kernel (interpret mode)."""
    q, s = _fp16_edge_payload(M, d, d)
    out = ops.decompress_fp16(_t(q), _t(s)).numpy()
    jq, js = jnp.asarray(q), jnp.asarray(s)
    _same_bits(out, jref.fp16_decompress_ref(jq, js), "vs ref")
    _same_bits(out, fp16_decompress_pallas(jq, js, interpret=True), "vs pallas")


@pytest.mark.parametrize("m,d", [(15_976, 10), (300, 16), (15_976, 4), (3, 129), (1, 1)])
def test_fp16_decompress_wrapper_hands_the_launcher_its_plan(monkeypatch, m, d):
    seen = _hand_over(monkeypatch)
    q, s = torch.zeros((m, d), dtype=torch.float16), torch.zeros((m, 1))
    out = ops._fp16_decompress_cuda(q, s)
    (name, args), = seen
    assert name == "fp16_decompress" and args[:3] == (q.data_ptr(), s.data_ptr(),
                                                      out.data_ptr())
    assert args[3:] == (m * d, d, *ops.fp16_decompress_plan(m, d, 132))
    assert out.shape == (m, d) and out.dtype == torch.float32
    ops._fp16_decompress_cuda(torch.zeros((0, d), dtype=torch.float16), torch.zeros((0, 1)))
    ops._fp16_decompress_cuda(torch.zeros((m, 0), dtype=torch.float16), torch.zeros((m, 1)))
    assert len(seen) == 1  # no elements launch nothing


def test_fp16_decompress_wrapper_errors_before_launch(monkeypatch):
    monkeypatch.setattr(ops, "_launch", lambda *a: pytest.fail("launched"))
    q, s = torch.zeros((3, 8), dtype=torch.float16), torch.ones((3, 1))
    with pytest.raises(ValueError, match="float16"):
        ops._fp16_decompress_cuda(q.float(), s)
    with pytest.raises(ValueError, match="float32"):
        ops._fp16_decompress_cuda(q, s.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops._fp16_decompress_cuda(torch.zeros((8, 3), dtype=torch.float16).T, s)
    with pytest.raises(ValueError, match="scale"):
        ops._fp16_decompress_cuda(q, torch.ones((4, 1)))
    with pytest.raises(ValueError, match="2-d"):
        ops._fp16_decompress_cuda(q.view(-1), s)
