"""World > 1 on the CPU: the port's collectives, compressed wires, lookups,
mesh and salts at 4 gloo ranks against the reference on 4 forced host
devices (mesh 2x2).

The port runs as 4 processes (``repro_torch.dist.spawn_ranks``, one thread
each, a ``FileStore`` under a temporary directory); the reference runs in a
subprocess with ``--xla_force_host_platform_device_count=4``, the pattern of
``tests/test_distributed.py``. Both read the same numpy inputs and run
under one ``PYTHONHASHSEED``. Each side runs once for the whole module
(module fixtures) and the tests read its results. Rank ``r`` is the
reference's ``lax.axis_index(("data", "model"))``, row-major over the mesh,
so results concatenate rank-major on both sides.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import dist as rdist
from repro_torch.core import packed_embedding as pe
from repro_torch.core.features import SaltMismatch
from repro_torch.launch import mesh as rmesh
from repro_torch.optim import grad_compression as gc

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
W = 4
HASH_SEED = "0"
MODES = ("fp16", "topk")
DENSE_MODES = ("bf16", "fp16", "f8")

REF_HEADER = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P
from repro.dist.compat import shard_map
from repro.launch.mesh import make_test_mesh
mesh = make_test_mesh(2, 2)
AXES = ("data", "model")
W = 4
inp = pickle.load(open(sys.argv[1], "rb"))
out = {}


def spec(x):
    return P(AXES, *([None] * (np.ndim(x) - 1)))


def per_rank(f, *xs):
    '''Run f on each rank's block of the rank-major inputs; every output
    gets a leading rank axis, so the result is [W, ...] in rank order.'''
    def g(*blocks):
        res = f(*blocks)
        return jax.tree.map(lambda y: jnp.asarray(y)[None], res)
    h = jax.jit(shard_map(g, mesh=mesh, in_specs=tuple(spec(x) for x in xs),
                          out_specs=P(AXES), check_vma=False))
    return jax.tree.map(np.asarray, h(*[jnp.asarray(x) for x in xs]))
"""


def ref_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["PYTHONHASHSEED"] = HASH_SEED
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def run_reference(body: str, inputs, tmp: Path, timeout: int = 600):
    """Run ``REF_HEADER + body`` in a subprocess on 4 forced host devices;
    the body fills ``out``, which comes back as a dict."""
    src, inp, res = tmp / "ref.py", tmp / "ref_in.pkl", tmp / "ref_out.pkl"
    src.write_text(REF_HEADER + textwrap.dedent(body)
                   + f"\npickle.dump(out, open({str(res)!r}, 'wb'))\n")
    with open(inp, "wb") as f:
        pickle.dump(inputs, f)
    proc = subprocess.run([sys.executable, str(src), str(inp)], capture_output=True,
                          text=True, env=ref_env(), timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(res, "rb") as f:
        return pickle.load(f)


def start_reference(body: str, inputs, tmp: Path, timeout: int = 600, **consts):
    """``run_reference`` started in the background, so the port's ranks can
    run beside it: returns a function that waits for the subprocess and
    returns its ``out``. ``consts`` become the script's module constants."""
    src, inp, res = tmp / "ref.py", tmp / "ref_in.pkl", tmp / "ref_out.pkl"
    head = "".join(f"{k} = {v!r}\n" for k, v in consts.items())
    src.write_text(REF_HEADER + head + textwrap.dedent(body)
                   + f"\npickle.dump(out, open({str(res)!r}, 'wb'))\n")
    with open(inp, "wb") as f:
        pickle.dump(inputs, f)
    proc = subprocess.Popen([sys.executable, str(src), str(inp)], stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True, env=ref_env())

    def collect():
        try:
            _, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
        assert proc.returncode == 0, err[-4000:]
        with open(res, "rb") as f:
            return pickle.load(f)

    return collect


def run_port(fn, *args, tmp: Path, deadline_s: float = 900):
    """``fn(group, *args)`` on 4 gloo ranks (one thread each) under the
    module's ``PYTHONHASHSEED``; the ranks' results in rank order. Ranks
    still running after ``deadline_s`` are stopped and the call fails, so a
    hang fails the test instead of stalling the suite."""
    old = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = HASH_SEED
    try:
        d = tmp / "ranks"
        d.mkdir(exist_ok=True)
        return rdist.spawn_ranks(fn, W, *args, threads=1, workdir=str(d),
                                 deadline_s=deadline_s)
    finally:
        if old is None:
            os.environ.pop("PYTHONHASHSEED", None)
        else:
            os.environ["PYTHONHASHSEED"] = old


def blocks(x: np.ndarray, r: int) -> np.ndarray:
    """Rank ``r``'s block of a rank-major array."""
    n = x.shape[0] // W
    return x[r * n:(r + 1) * n]


def same_bits(got: np.ndarray, exp: np.ndarray, what: str = "") -> None:
    """Bitwise equality (-0.0 and 0.0 differ), every NaN counted the same
    one, as ``tests/test_torch_compress.py`` compares."""
    got, exp = np.array(got), np.array(exp)
    assert got.shape == exp.shape and got.dtype == exp.dtype, (what, got.shape, exp.shape,
                                                               got.dtype, exp.dtype)
    if got.dtype.kind == "f":
        got[np.isnan(got)] = np.nan
        exp[np.isnan(exp)] = np.nan
    assert got.tobytes() == exp.tobytes(), what


# ---------------------------------------------------------------- the inputs
def _inputs():
    rng = np.random.default_rng(7)
    g = rng.normal(size=(W * 12, 10)).astype(np.float32)
    g[::5] = 0.0                                   # empty bucket slots
    g[3, :4] = 2.5                                 # a topk tie in a row
    g[7] *= 1e-6                                   # fp16-subnormal ratios
    x = rng.normal(size=(W * 8, 3)).astype(np.float32)
    x[2::8] = -0.0                                 # a psum of negative zeros
    d = (rng.normal(size=(W * 5, 7)) * np.array([1, 1e-3, 1e3, 300, 500, 1, 1],
                                                np.float32)).astype(np.float32)
    d[1::5] = -0.0
    return {
        "x": x,
        "xi": rng.integers(-50, 50, size=(W * 8,)).astype(np.int32),
        "g": g,
        "d": d,
    }


REF_BODY = """
from repro.core import packed_embedding as pe
from repro.optim import grad_compression as gc

def colls(x, xi):
    return {"a2a": lax.all_to_all(x, AXES, 0, 0, tiled=True),
            "a2a_i": lax.all_to_all(xi, AXES, 0, 0, tiled=True),
            "psum": lax.psum(x, AXES), "psum_i": lax.psum(xi, AXES),
            "gather": lax.all_gather(x, AXES, tiled=True),
            "gather_i": lax.all_gather(xi, AXES, tiled=True),
            "rank": lax.axis_index(AXES).astype(jnp.int32)}
out["colls"] = per_rank(colls, inp["x"], inp["xi"])
for mode in ("fp16", "topk"):
    def wire(g, mode=mode):
        payload = gc.compress_rows(g, mode, fused=False)
        moved = jax.tree.map(lambda x: lax.all_to_all(x, AXES, 0, 0, tiled=True), payload)
        return {"payload": tuple(moved),
                "a2a": pe._compressed_a2a_rows(g, AXES, W, 3, mode, False),
                "gather": gc.compressed_all_gather(g, AXES, mode, fused=False)}
    out[mode] = per_rank(wire, inp["g"])
for mode in ("bf16", "fp16", "f8"):
    out["psum_" + mode] = per_rank(
        lambda d, mode=mode: gc.compressed_psum({"a": d}, AXES, mode)[0]["a"], inp["d"])
out["psum_none"] = per_rank(lambda d: gc.compressed_psum({"a": d}, AXES, "none")[0]["a"],
                            inp["d"])
"""


def _port_collectives(group, inp):
    r = group.rank
    t = {k: torch.as_tensor(blocks(v, r)) for k, v in inp.items()}
    out = {"colls": {
        "a2a": rdist.all_to_all_tiled(t["x"], group),
        "a2a_i": rdist.all_to_all_tiled(t["xi"], group),
        "psum": rdist.psum(t["x"], group), "psum_i": rdist.psum(t["xi"], group),
        "gather": rdist.all_gather_tiled(t["x"], group),
        "gather_i": rdist.all_gather_tiled(t["xi"], group),
        "rank": torch.tensor(rdist.axis_index(group), dtype=torch.int32)}}
    for mode in MODES:
        payload = gc.compress_rows(t["g"], mode)
        out[mode] = {"payload": tuple(rdist.all_to_all_tiled(x, group) for x in payload),
                     "a2a": pe._compressed_a2a_rows(t["g"], mode, None, group),
                     "gather": gc.compressed_all_gather(t["g"], W, mode, group=group)}
    for mode in DENSE_MODES + ("none",):
        out["psum_" + mode] = gc.compressed_psum({"a": t["d"]}, W, mode, group=group)[0]["a"]
    out["traffic"] = rdist.traffic_snapshot()
    return _numpy(out)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_numpy(v) for v in tree)
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def _stack(results, *path):
    """The ranks' values at ``path``, stacked rank-major (the reference's
    ``[W, ...]`` layout)."""
    vals = []
    for res in results:
        for p in path:
            res = res[p]
        vals.append(res)
    return np.stack(vals)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    inp = _inputs()
    ref = run_reference(REF_BODY, inp, tmp)
    port = run_port(_port_collectives, inp, tmp=tmp)
    return inp, ref, port


@pytest.mark.parametrize("name", ["a2a", "a2a_i", "psum", "psum_i", "gather", "gather_i",
                                  "rank"])
def test_collectives_are_bitwise_the_lax_ones(both, name):
    """``all_to_all_tiled``, ``psum``, ``all_gather_tiled`` and
    ``axis_index`` give the ``lax`` collectives' bits, float32 and int32."""
    _, ref, port = both
    same_bits(_stack(port, "colls", name), ref["colls"][name], name)


def test_collective_semantics_against_numpy(both):
    """The tiled layouts themselves, from the inputs: block ``p`` of rank
    ``q``'s all_to_all input lands as block ``q`` of rank ``p``'s output;
    the gather is the whole rank-major input on every rank."""
    inp, _, port = both
    x = inp["x"].reshape(W, W, 2, 3)          # [src rank, dst block, rows, D]
    got = _stack(port, "colls", "a2a").reshape(W, W, 2, 3)
    np.testing.assert_array_equal(got, x.transpose(1, 0, 2, 3))
    for r in range(W):
        np.testing.assert_array_equal(port[r]["colls"]["gather"], inp["x"])
        np.testing.assert_array_equal(port[r]["colls"]["psum_i"],
                                      inp["xi"].reshape(W, 8).sum(0))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("what", ["payload", "a2a", "gather"])
def test_routed_compression_is_bitwise_on_the_wire(both, mode, what):
    """The fp16 and topk payloads after the all_to_all (the bytes the wire
    carried), the decompressed routed rows, and the compressed all_gather,
    bitwise the reference's at world 4 (zero rows, a magnitude tie and
    fp16-subnormal ratios included)."""
    _, ref, port = both
    if what == "payload":
        for i, exp in enumerate(ref[mode]["payload"]):
            same_bits(_stack(port, mode, "payload", i), exp, f"{mode} leaf {i}")
    else:
        same_bits(_stack(port, mode, what), ref[mode][what], f"{mode}/{what}")


@pytest.mark.parametrize("mode", DENSE_MODES + ("none",))
def test_compressed_psum_at_world_4(both, mode):
    """The dense psum at world 4, bitwise the reference's on every rank:
    ``'none'`` is the plain psum (floats added in rank order); the narrow
    modes move the narrow payload (all_gathered in its dtype) and sum it in
    rank order, rounding as the reference's narrow all-reduce rounds (f8's
    overflow NaNs included)."""
    _, ref, port = both
    got = _stack(port, "psum_" + mode)
    for r in range(1, W):
        same_bits(got[r], got[0], f"replica {r}")
    same_bits(got, ref["psum_" + mode], mode)


def test_traffic_counts_the_bytes_sent(both):
    _, _, port = both
    t = port[0]["traffic"]
    assert t["all_to_all"] > 0 and t["psum"] > 0 and t["all_gather"] > 0


# ---------------------------------------------------------------- lookups
def _port_lookup(group, table, ids, cap):
    rps = table.shape[0] // W
    lo = group.rank * rps
    rows, ctx = pe.mp_lookup(torch.as_tensor(table[lo:lo + rps]),
                             torch.as_tensor(ids[group.rank]), world=W, capacity=cap,
                             group=group)
    return (rows[ctx.inv.long()].numpy(), int(ctx.routing.overflow),
            ctx.recv_valid.numpy())


@pytest.mark.parametrize("cap", [24, 3])
def test_mp_lookup_world4_exact_against_numpy(tmp_path, cap):
    """``mp_lookup`` on 4 ranks: every kept id's row is bitwise the numpy
    gather of the whole table; at capacity 3 of 24 the overflow drops
    exactly the ids past each bucket (their rows exactly zero), and the
    owners received rows from the other ranks."""
    rng = np.random.default_rng(0)
    rps, d, n = 16, 5, 24
    table = rng.normal(size=(rps * W, d)).astype(np.float32)
    ids = rng.integers(0, rps * W, size=(W, n)).astype(np.int32)
    res = run_port(_port_lookup, table, ids, cap, tmp=tmp_path)
    for r, (rows, overflow, recv_valid) in enumerate(res):
        u = np.unique(ids[r])
        owner = u // rps
        pos = np.array([np.sum(owner[:i] == owner[i]) for i in range(len(u))])
        kept = set(u[pos < cap].tolist())
        assert overflow == int(np.sum(pos >= cap))
        for i, x in enumerate(ids[r]):
            exp = table[x] if int(x) in kept else np.zeros(d, np.float32)
            np.testing.assert_array_equal(rows[i], exp)
        others = [p for p in range(W) if p != r]
        assert recv_valid[others].any()
    if cap == 24:
        assert all(o == 0 for _, o, _ in res)


# ---------------------------------------------------------------- salts
SALT_CHILD = """
import sys
sys.path.insert(0, {src!r})
from repro_torch.configs import get_config
from repro_torch.core.features import SaltMismatch, agree_salts
from repro_torch.core.packing import make_plan
from repro_torch.dist.compat import init_ranks
rank = int(sys.argv[1])
g = init_ranks(rank, 2, sys.argv[2], "gloo")
plan = make_plan(get_config("deepfm", smoke=True), world=2, per_device_batch=8)
try:
    agree_salts(plan, g)
    print("AGREED")
except SaltMismatch as e:
    print("MISMATCH", e)
"""


def _two_ranks(tmp_path, seeds):
    code = SALT_CHILD.format(src=str(ROOT / "src"))
    store = str(tmp_path / "store")
    procs = []
    for rank, seed in enumerate(seeds):
        env = dict(os.environ, PYTHONHASHSEED=seed)
        procs.append(subprocess.Popen([sys.executable, "-c", code, str(rank), store],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for _, e in outs]
    return [o for o, _ in outs]


def test_ranks_with_differing_salts_raise(tmp_path):
    """Two ranks started under different ``PYTHONHASHSEED`` values compute
    other packing salts: ``agree_salts`` raises ``SaltMismatch`` (naming
    ``PYTHONHASHSEED``) on both."""
    outs = _two_ranks(tmp_path, ("0", "1"))
    assert all(o.startswith("MISMATCH") and "PYTHONHASHSEED" in o for o in outs), outs


def test_ranks_under_one_hash_seed_agree(tmp_path):
    outs = _two_ranks(tmp_path, ("3", "3"))
    assert all(o.strip() == "AGREED" for o in outs), outs


def test_salt_mismatch_is_the_checkpoint_error():
    from repro_torch.train import checkpoint as ck

    assert ck.SaltMismatch is SaltMismatch and issubclass(SaltMismatch, ValueError)


# ---------------------------------------------------------------- groups, mesh
def test_group_contract():
    """At world 1 no group is needed and every collective is the identity
    (the same tensor object); past world 1 a missing or mismatched group
    raises ``ValueError``."""
    g = rdist.resolve_group(1, None)
    x = torch.arange(6.0).reshape(3, 2)
    assert g is rdist.WORLD1
    for f in (rdist.all_to_all_tiled, rdist.psum, rdist.all_gather_tiled):
        assert f(x, g) is x
    with pytest.raises(ValueError, match="world=4 needs a repro_torch.dist.Group"):
        rdist.resolve_group(4, None)
    with pytest.raises(ValueError, match="world=4 but the group given has world 2"):
        rdist.resolve_group(4, rdist.Group(1, 2))


@pytest.mark.parametrize("spec,devices,shape", [("2x2", 4, (2, 2)), ("4x2", 0, (4, 2)),
                                                ("4", 0, (4,)), ("", 4, (4, 1)),
                                                ("", 0, (1, 1))])
def test_parse_mesh(spec, devices, shape):
    assert rmesh.parse_mesh(spec, devices) == shape
    assert rmesh.mesh_world(shape) == int(np.prod(shape))


def test_parse_mesh_rejects_a_mismatch():
    with pytest.raises(ValueError, match="--devices"):
        rmesh.parse_mesh("2x2", 8)
    with pytest.raises(ValueError):
        rmesh.parse_mesh("0x2")


def test_rank_coords_are_row_major():
    """``lax.axis_index(("data", "model"))`` numbers a 2x2 mesh row-major."""
    assert [rmesh.rank_coords(r, (2, 2)) for r in range(4)] == [(0, 0), (0, 1), (1, 0),
                                                                 (1, 1)]
    assert rmesh.rank_coords(5, (4, 2)) == (2, 1)


def test_backend_rule():
    assert rdist.backend_for("cpu", 4) == "gloo"
    n = torch.cuda.device_count()
    assert rdist.backend_for("cuda", n + 1) == "gloo"
