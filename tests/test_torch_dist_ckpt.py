"""Checkpoints at world 4 on the CPU (4 gloo ranks) against the reference's
on 4 forced host devices (mesh 2x2): one file a logical leaf, every rank's
rows of a row-sharded leaf in rank order.

- The reference trains deepfm-smoke (``picasso_l2``: both tiers, global
  batch 64) 4 steps past the step-3 flush and checkpoints it with zstd and
  without; its manifests record no salts. The port restores each at world
  4, every rank's leaves bitwise the reference's rows and replicas, trains
  2 more steps and checkpoints with zstd and without; the reference
  restores each at mesh 2x2 with the step's shardings, every leaf bitwise
  the port's.
- A checkpoint written at world 1 raises ``WorldMismatch`` naming ROADMAP
  Queue 1 item 6.2 on every rank.
- A world-4 save is atomic: with one rank's rows slowed, ``step_<n>``
  appears only after that rank's rows are in.
- A byte flipped in one rank's rows of a row-sharded leaf: every rank finds
  the checksum wrong, the step is quarantined once, and every rank falls
  back to the same earlier step.
"""
import os
import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data.synthetic import make_batch as jmake_batch
from test_torch_dist import W, run_port, run_reference
from test_torch_dist_faults import _np_leaves

torch.set_num_threads(1)

GB = 64
STRATEGY = "picasso_l2"
PLAN_KW = dict(hot_bytes=1 << 14, l2_bytes=1 << 16, flush_iters=3, warmup_iters=2,
               mesh_shape=(2, 2))
REF_STEPS, PORT_STEPS = 4, 2
CODECS = ("zst", "npy")
SLOW_RANK, SLOW_S = 3, 1.0

REF_HEAD = """
from repro.configs import get_config
from repro.core.packing import make_plan
from repro.dist.sharding import batch_specs, to_named
from repro.models.wdl import WDLModel
from repro.runtime import plan_meta
from repro.train import checkpoint as ck
from repro.train.train_step import TrainConfig, init_state, make_train_step
GB = inp["GB"]
cfg = get_config("deepfm", smoke=True)
plan = make_plan(cfg, W, GB // W, **inp["plan_kw"])
model = WDLModel(cfg, plan)
step, sspecs = make_train_step(model, plan, mesh, AXES, GB,
                               TrainConfig(strategy=inp["strategy"], use_fused_kernels="off"),
                               donate=False)
shardings = to_named(mesh, sspecs)
zstd = ck.zstandard


def leaves(st):
    return {k: np.asarray(v) for k, v in ck._flatten(jax.device_get(st)).items()}
"""

REF_WRITE = REF_HEAD + """
state = init_state(model, plan, jax.random.PRNGKey(0), mesh=mesh, axes=AXES)
for b in inp["batches"]:
    state, _ = step(state, jax.device_put(b, to_named(mesh, batch_specs(b, AXES))))
host = jax.device_get(state)
for codec, d in inp["dirs"].items():
    ck.zstandard = zstd if codec == "zst" else None
    ck.save_checkpoint(d, inp["step"], host, meta=plan_meta(plan))
out["leaves"] = leaves(host)
out["l2_keys"] = int(sum(int((np.asarray(s.l2.keys) < g.rows).sum())
                         for g, s in zip(plan.groups, host["emb"].values())))
"""

REF_READ = REF_HEAD + """
template = init_state(model, plan, jax.random.PRNGKey(7), mesh=mesh, axes=AXES)
for codec, d in inp["dirs"].items():
    restored, s = ck.restore_checkpoint(d, template, shardings=shardings)
    out[codec] = {"leaves": leaves(restored), "step": s, "meta": ck.load_checkpoint_meta(d),
                  "sharded_as_the_step": all(
                      x.sharding == y for x, y in zip(jax.tree.leaves(restored),
                                                      jax.tree.leaves(shardings)))}
"""


def _port_ckpt(group, batches, ref_dirs, port_dirs, root):
    from repro_torch.configs import get_config
    from repro_torch.core.features import table_salts
    from repro_torch.core.packing import make_plan
    from repro_torch.engine import resolve_assignment
    from repro_torch.models.wdl import WDLModel
    from repro_torch.runtime import plan_meta
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.train_step import TrainConfig, init_state, make_train_step

    cfg = get_config("deepfm", smoke=True)
    plan = make_plan(cfg, W, GB // W, **PLAN_KW)
    resolve_assignment(plan, STRATEGY, world=W)
    model = WDLModel(cfg, plan)
    step = make_train_step(model, plan, GB, TrainConfig(strategy=STRATEGY,
                                                        use_fused_kernels="off"),
                           "cpu", group=group)
    zstd = ck.zstandard

    def template(seed):
        return init_state(model, plan, torch.Generator().manual_seed(seed), "cpu", group=group)

    out = {}
    # the reference's checkpoints restore here; this rank's trained state goes out
    for codec in CODECS:
        ck.zstandard = zstd if codec == "zst" else None
        salts = ck.load_checkpoint_salts(ref_dirs[codec], group=group)
        state, s = ck.restore_checkpoint(ref_dirs[codec], template(5), group=group)
        got = {"salts": salts, "step": s, "restored": _np_leaves(state)}
        for b in batches:
            state, _ = step(state, b)
        ck.save_checkpoint(port_dirs[codec], s + len(batches), state, meta=plan_meta(plan),
                           salts=table_salts(plan), group=group)
        got["trained"] = _np_leaves(state)
        out[codec] = got
    ck.zstandard = None  # the rest on .npy leaves: each rank's rows in place

    # another world's checkpoint: rank 0 writes one at world 1
    plan1 = make_plan(cfg, 1, GB, **{**PLAN_KW, "mesh_shape": (1, 1)})
    d1 = os.path.join(root, "world1")
    if group.rank == 0:
        st1 = init_state(WDLModel(cfg, plan1), plan1, torch.Generator().manual_seed(0), "cpu")
        ck.save_checkpoint(d1, 1, st1, meta=plan_meta(plan1))
    ck.available_steps(d1, group)  # every rank waits for rank 0's listing
    try:
        ck.restore_checkpoint(d1, template(5), group=group)
        out["world1"] = None
    except ck.WorldMismatch as e:
        out["world1"] = str(e)

    # atomicity: one rank's rows slowed; rank 0 watches for the step directory
    d2 = Path(root, "atomic")
    seen, stop = {}, threading.Event()
    if group.rank == SLOW_RANK:
        real = ck._write_rows

        def slow(*a, **k):
            time.sleep(SLOW_S)
            res = real(*a, **k)
            seen["rows_in"] = time.monotonic()
            return res

        ck._write_rows = slow
    if group.rank == 0:
        def watch():
            while True:  # a last look once the save has returned
                if (d2 / "step_00000001").exists():
                    seen["appeared"] = time.monotonic()
                    seen["manifest"] = (d2 / "step_00000001" / "manifest.json").exists()
                    return
                if stop.is_set():
                    return
                time.sleep(0.001)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
    state = template(0)
    ck.save_checkpoint(str(d2), 1, state, group=group)
    stop.set()
    if group.rank == 0:
        watcher.join(timeout=10)
    if group.rank == SLOW_RANK:
        ck._write_rows = real
    out["atomic"] = seen

    # a byte flipped in rank 2's rows of the master: quarantined once, step 1 back
    for _ in range(2):
        state, _ = step(state, batches[0])
    ck.save_checkpoint(str(d2), 2, state, group=group)
    if group.rank == 0:
        f = d2 / "step_00000002" / "emb__0__w.npy"
        with open(f, "r+b") as fh:
            _, _, _, hlen = ck._npy_head(fh)
            rows, d = plan.groups[0].rows, plan.groups[0].dim
            fh.seek(hlen + (rows // W * 2 + rows // W // 2) * d * 4)
            b = fh.read(1)
            fh.seek(-1, 1)
            fh.write(bytes([b[0] ^ 0xFF]))
    ck.available_steps(str(d2), group)  # after the flip, on every rank
    restored, s = ck.restore_verified(str(d2), template(9), group=group)
    out["quarantine"] = {"step": s, "dirs": sorted(p.name for p in d2.iterdir()),
                         "restored": _np_leaves(restored)}
    out["step1"] = _np_leaves(template(0))
    return out


def _logical(port, key, name):
    """One logical leaf from the ranks: rows in rank order, else rank 0's."""
    if re.fullmatch(r"emb/\d+/(w|acc|counts)", name):
        return np.concatenate([p[key][name] if isinstance(key, str) else
                               p[key[0]][key[1]][name] for p in port])
    return port[0][key][name] if isinstance(key, str) else port[0][key[0]][key[1]][name]


def _bits(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape,
                                                       b.shape)
    assert a.tobytes() == b.tobytes(), what


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_ckpt")
    cfg = jget_config("deepfm", smoke=True)
    rng = np.random.default_rng(0)
    batches = [jmake_batch(cfg, GB, rng) for _ in range(REF_STEPS + PORT_STEPS)]
    ref_dirs = {c: str(tmp / f"ref_{c}") for c in CODECS}
    port_dirs = {c: str(tmp / f"port_{c}") for c in CODECS}
    common = {"GB": GB, "plan_kw": PLAN_KW, "strategy": STRATEGY}
    ref = run_reference(REF_WRITE, {**common, "batches": batches[:REF_STEPS],
                                    "dirs": ref_dirs, "step": REF_STEPS}, tmp, timeout=900)
    port = run_port(_port_ckpt, batches[REF_STEPS:], ref_dirs, port_dirs, str(tmp),
                    tmp=tmp, deadline_s=600)
    back = run_reference(REF_READ, {**common, "dirs": port_dirs}, tmp, timeout=900)
    return ref, port, back, ref_dirs, port_dirs


@pytest.mark.parametrize("codec", CODECS)
def test_reference_checkpoint_restores_at_world_4_bitwise(runs, codec):
    """Every rank's rows of each row-sharded leaf and every replicated leaf
    bitwise the reference's mesh-2x2 state; no salts recorded, so the
    restore runs unchecked; the L2 tier held keys."""
    ref, port, _, ref_dirs, _ = runs
    assert ref["l2_keys"] > 0
    suffix = ".npy.zst" if codec == "zst" else ".npy"
    assert (Path(ref_dirs[codec]) / "step_00000004" / f"emb__0__w{suffix}").exists()
    for r, p in enumerate(port):
        assert p[codec]["salts"] is None and p[codec]["step"] == REF_STEPS, r
    rps = None
    for name, exp in ref["leaves"].items():
        if re.fullmatch(r"emb/\d+/(w|acc|counts)", name):
            rps = exp.shape[0] // W
            for r, p in enumerate(port):
                _bits(p[codec]["restored"][name], exp[r * rps:(r + 1) * rps], (name, r))
        else:
            for r, p in enumerate(port):
                _bits(p[codec]["restored"][name], exp, (name, r))
    assert rps is not None and sorted(port[0][codec]["restored"]) == sorted(ref["leaves"])


@pytest.mark.parametrize("codec", CODECS)
def test_port_checkpoint_restores_in_the_reference_bitwise(runs, codec):
    """The reference restores the port's world-4 checkpoint at mesh 2x2 onto
    its step's shardings: every leaf bitwise the port's live state (rows in
    rank order), the meta the port's ``plan_meta``."""
    _, port, back, _, port_dirs = runs
    got = back[codec]
    assert got["step"] == REF_STEPS + PORT_STEPS and got["sharded_as_the_step"]
    assert got["meta"]["world"] == W and got["meta"]["mesh_shape"] == [2, 2]
    assert sorted(got["leaves"]) == sorted(port[0][codec]["trained"])
    for name, leaf in got["leaves"].items():
        _bits(_logical(port, (codec, "trained"), name), leaf, name)
    suffix = ".npy.zst" if codec == "zst" else ".npy"
    d = Path(port_dirs[codec]) / f"step_{REF_STEPS + PORT_STEPS:08d}"
    assert (d / f"emb__0__w{suffix}").exists() and not list(Path(port_dirs[codec]).glob(".tmp_*"))


def test_another_worlds_checkpoint_raises_on_every_rank(runs):
    _, port, _, _, _ = runs
    for r, p in enumerate(port):
        msg = p["world1"]
        assert msg is not None and "different world size" in msg and "item 6.2" in msg, (r, msg)


def test_world_4_save_appears_only_with_every_ranks_rows(runs):
    _, port, _, _, _ = runs
    seen0, slow = port[0]["atomic"], port[SLOW_RANK]["atomic"]
    assert seen0.get("manifest") and slow["rows_in"] <= seen0["appeared"], (seen0, slow)


def test_corrupt_rows_of_one_rank_quarantine_once_and_every_rank_falls_back(runs):
    _, port, _, _, _ = runs
    for r, p in enumerate(port):
        q = p["quarantine"]
        assert q["step"] == 1, r
        assert q["dirs"] == ["step_00000001", "step_00000002.corrupt"], (r, q["dirs"])
        assert sorted(q["restored"]) == sorted(p["step1"])
        for name, leaf in p["step1"].items():
            _bits(q["restored"][name], leaf, (name, r))


@pytest.mark.parametrize("la,lb", [(0, 0), (1, 0), (0, 7), (13, 1), (1000, 777),
                                   (4096, 65_537)])
def test_crc32_combine_is_zlibs(la, lb):
    """The crc32 of ``a + b`` from the parts' crcs, as the ranks' parts of a
    row-sharded file combine."""
    import zlib

    from repro_torch.train.checkpoint import crc32_combine

    rng = np.random.default_rng(la + lb)
    a, b = rng.bytes(la), rng.bytes(lb)
    assert crc32_combine(zlib.crc32(a), zlib.crc32(b), lb) == zlib.crc32(a + b)


def test_train_launcher_resumes_the_reference_launchers_world_4_checkpoint(tmp_path):
    """``repro.launch.train --devices 4 --mesh 2x2`` checkpoints step 5; the
    port's launcher at the same mesh resumes from it (its manifest records
    no salts) and prints the step-6 loss the reference's own resume
    prints."""
    import shutil
    import subprocess
    import sys

    from test_torch_dist import HASH_SEED, ROOT, ref_env

    flags = ["--arch", "deepfm", "--smoke", "--global-batch", str(GB), "--devices", "4",
             "--mesh", "2x2", "--ckpt-every", "5", "--log-every", "1"]

    def run(module, d, steps, *extra, env=None):
        proc = subprocess.run([sys.executable, "-m", f"{module}.launch.train", *flags, *extra,
                               "--steps", str(steps), "--ckpt-dir", str(d)],
                              capture_output=True, text=True, timeout=600,
                              env=env or ref_env())
        assert proc.returncode == 0, proc.stderr[-3000:]
        return proc

    run("repro", tmp_path / "a", 5)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    port_env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PYTHONHASHSEED=HASH_SEED,
                    OMP_NUM_THREADS="1")
    port = run("repro_torch", tmp_path / "a", 6, "--device", "cpu", env=port_env)
    ref = run("repro", tmp_path / "b", 6)
    assert "records no packing salts" in port.stdout
    assert "restored checkpoint at step 5" in port.stderr
    pat = r"^  step +6 loss=(\S+) .*$"
    assert re.findall(pat, port.stdout, re.M) == re.findall(pat, ref.stdout, re.M) != []
