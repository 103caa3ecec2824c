"""The Supervisor, the anomaly guard and chaos at world 4 on the CPU: 4 gloo
ranks against the reference on 4 forced host devices (mesh 2x2).

- The supervised run: deepfm-smoke (global batch 64) through
  ``nan@7,nan@8,crash@13,ckpt@20`` with checkpoints every 5 steps, the guard
  and ``ChaosController`` on every rank. It ends bitwise at a clean world-4
  run over the batches it kept; its guard events (step, kind, consecutive
  count, threshold, EMA), rollbacks and quarantine equal the reference's
  same run, and its state meets the PR 12 bars against the reference's
  (both start from the reference's state). Then both walk the checkpoints
  from step 15, which ``ckpt@20`` tore: quarantined once, both fall back to
  step 10.
- A transient fault raised on rank 2 alone before step 7 rolls all four
  ranks back to step 5, and the run ends bitwise at the clean run.
- A fatal fault on rank 1 alone ends the launcher's spawn non-zero within
  the time stated below, every rank's error agreed, no hang.
- The train launcher at ``--devices 4 --mesh 2x2 --ckpt-dir --guard
  --chaos``, run to step 15 and then again to step 20 in the same
  directory, resumes at step 15 and prints the losses one uninterrupted
  run to step 20 prints.

Every spawn has a deadline (``run_port``), every subprocess a timeout.
"""
import itertools
import os
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_dist import HASH_SEED, ROOT, W, run_port, run_reference

torch.set_num_threads(1)

GB = 64
STEPS = 25
CKPT_EVERY = 5
KEEP = STEPS // CKPT_EVERY + 1   # every checkpoint stays, the torn one too
SMOKE_CHAOS = "nan@7,nan@8,crash@13,ckpt@20"
NAN = (7, 8)
SEED = 3                         # the batch stream's
PLAN_KW = dict(hot_bytes=1 << 14, flush_iters=5, warmup_iters=2, mesh_shape=(2, 2))
ONE_STEPS, ONE_AT, ONE_RANK = 12, 7, 2
FATAL_WITHIN_S = 120             # the fatal fault's bound on the spawn's exit

REF_BODY = """
from pathlib import Path
from repro.configs import get_config
from repro.core.packing import make_plan
from repro.data.pipeline import ReplayableStream
from repro.data.synthetic import batch_stream
from repro.dist.sharding import batch_specs, to_named
from repro.models.wdl import WDLModel
from repro.runtime.chaos import ChaosController, parse_fault_plan
from repro.runtime.guard import AnomalyGuard
from repro.train import checkpoint as ck
from repro.train.fault_tolerance import Supervisor
from repro.train.train_step import TrainConfig, init_state, make_train_step


def leaves(st):
    return {k: np.asarray(v) for k, v in ck._flatten(jax.device_get(st)).items()}


GB = inp["GB"]
cfg = get_config("deepfm", smoke=True)
plan = make_plan(cfg, W, GB // W, **inp["plan_kw"])
model = WDLModel(cfg, plan)
state = init_state(model, plan, jax.random.PRNGKey(0), mesh=mesh, axes=AXES)
host = jax.device_get(state)
out["init"] = {"emb": {k: {f: (None if getattr(s, f) is None else
                              (tuple(np.asarray(x) for x in getattr(s, f))
                               if f in ("cache", "l2", "proj") else np.asarray(getattr(s, f))))
                          for f in s._fields} for k, s in host["emb"].items()},
               "dense": host["dense"], "opt": host["opt"], "step": np.asarray(host["step"])}
step, sspecs = make_train_step(model, plan, mesh, AXES, GB,
                               TrainConfig(use_fused_kernels="off"), donate=False)
shardings = to_named(mesh, sspecs)
guard = AnomalyGuard(step)


def make(s):
    for b in batch_stream(cfg, GB, seed=inp["seed"], start=s):
        yield jax.device_put(b, to_named(mesh, batch_specs(b, AXES)))


d = inp["dir"]
sup = Supervisor(d, ckpt_every=inp["every"], max_retries=3, backoff_s=0.0,
                 keep=inp["keep"], shardings=shardings)
ctl = ChaosController(parse_fault_plan(inp["chaos"]))
stream = ctl.wrap_stream(ReplayableStream(make))


def on_metrics(i, m):
    ctl.after_checkpoint(i, d, sup.ckpt)
    ctl.injector(i)


final = sup.run(state, guard, stream, inp["steps"], on_metrics=on_metrics)
out["final"] = leaves(final)
out["events"] = [(e.step, e.kind, e.consecutive, float(e.threshold)) for e in guard.events]
out["ema"] = None if guard.ema is None else float(guard.ema)
out["accepted"], out["failures"] = guard.accepted, sup.total_failures
out["fired"] = sorted(ctl.fired)
_, s = ck.restore_verified(d, jax.tree.map(lambda x: x, final), step=15, shardings=shardings)
out["fallback"] = s
out["quarantined"] = sorted(p.name for p in Path(d).glob("step_*.corrupt"))
"""


def _ns_state(st):
    return {**st, "emb": {k: types.SimpleNamespace(**v) for k, v in st["emb"].items()}}


def _np_leaves(state):
    """Every leaf as numpy, by its checkpoint name; the host step counter as
    the checkpoint stores it (int32)."""
    from repro_torch.train import checkpoint as ck

    return {k: (v.numpy().copy() if isinstance(v, torch.Tensor)
                else np.asarray(v, dtype=ck._np_dtype(v)))
            for k, v in ck._flatten(state).items()}


def _same(a, b) -> bool:
    return sorted(a) == sorted(b) and all(a[k].dtype == b[k].dtype and
                                          a[k].tobytes() == b[k].tobytes() for k in a)


def _port_runs(group, ref_init, root):
    from repro_torch.configs import get_config
    from repro_torch.convert import train_state_from_jax
    from repro_torch.core.features import agree_salts
    from repro_torch.core.packing import make_plan
    from repro_torch.data.pipeline import ReplayableStream
    from repro_torch.data.synthetic import batch_stream
    from repro_torch.models.wdl import WDLModel
    from repro_torch.runtime.chaos import ChaosController, ChaosFailure, parse_fault_plan
    from repro_torch.runtime.guard import AnomalyGuard
    from repro_torch.train.checkpoint import restore_verified
    from repro_torch.train.fault_tolerance import Supervisor
    from repro_torch.train.train_step import TrainConfig, make_train_step

    cfg = get_config("deepfm", smoke=True)
    plan = make_plan(cfg, W, GB // W, **PLAN_KW)
    model = WDLModel(cfg, plan)
    salts = agree_salts(plan, group)
    tcfg = TrainConfig(use_fused_kernels="off")

    def fresh():
        return train_state_from_jax(_ns_state(ref_init), plan, "cpu", group=group)

    def stream():
        return ReplayableStream(lambda s: batch_stream(cfg, GB, seed=SEED, start=s))

    def clean(n, skip=()):
        step, state = make_train_step(model, plan, GB, tcfg, "cpu", group=group), fresh()
        for i, b in enumerate(batch_stream(cfg, GB, seed=SEED)):
            if i >= n:
                return state
            if i not in skip:
                state, _ = step(state, b)

    out = {}
    # the supervised, guarded chaos run
    d = os.path.join(root, "chaos")
    guard = AnomalyGuard(make_train_step(model, plan, GB, tcfg, "cpu", group=group),
                         group=group)
    sup = Supervisor(d, ckpt_every=CKPT_EVERY, backoff_s=0.0, keep=KEEP, salts=salts,
                     group=group)
    ctl = ChaosController(parse_fault_plan(SMOKE_CHAOS), group=group)

    def on_metrics(i, m):
        ctl.after_checkpoint(i, d, sup.ckpt)
        ctl.injector(i)

    final = sup.run(fresh(), guard, ctl.wrap_stream(stream()), STEPS, on_metrics=on_metrics)
    out["final"] = _np_leaves(final)
    out["events"] = [(e.step, e.kind, e.consecutive, float(e.threshold))
                     for e in guard.events]
    out["ema"] = guard.ema
    out["accepted"], out["failures"] = guard.accepted, sup.total_failures
    out["fired"] = sorted(ctl.fired)
    _, out["fallback"] = restore_verified(d, fresh(), step=15, group=group)
    out["quarantined"] = sorted(p.name for p in Path(d).glob("step_*.corrupt"))
    out["clean"] = _same(_np_leaves(clean(STEPS, NAN)), out["final"])

    # a transient fault on one rank only, before a step
    fired = []

    def inject(i):
        if group.rank == ONE_RANK and i == ONE_AT and not fired:
            fired.append(i)
            raise ChaosFailure(f"injected crash on rank {group.rank} before step {i}")

    sup1 = Supervisor(os.path.join(root, "one"), ckpt_every=CKPT_EVERY, backoff_s=0.0,
                      salts=salts, group=group)
    one = sup1.run(fresh(), make_train_step(model, plan, GB, tcfg, "cpu", group=group),
                   stream(), ONE_STEPS, fail_injector=inject)
    out["one"] = {"failures": sup1.total_failures, "step": one["step"],
                  "clean": _same(_np_leaves(one), _np_leaves(clean(ONE_STEPS)))}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_faults")
    ref = run_reference(REF_BODY, {"GB": GB, "plan_kw": PLAN_KW, "seed": SEED,
                                   "dir": str(tmp / "ref"), "every": CKPT_EVERY, "keep": KEEP,
                                   "chaos": SMOKE_CHAOS, "steps": STEPS}, tmp, timeout=900)
    port = run_port(_port_runs, ref["init"], str(tmp / "port"), tmp=tmp, deadline_s=900)
    return ref, port


def test_supervised_chaos_run_ends_bitwise_at_the_clean_run(runs):
    """Both poisoned batches rejected on every rank, the crash rolled every
    rank back once, the torn checkpoint fired once: every rank's state is
    bitwise the clean run's over the 23 batches the run kept."""
    _, port = runs
    for r, p in enumerate(port):
        assert p["clean"], r
        assert p["fired"] == ["ckpt@20", "crash@13"] and p["failures"] == 1, (r, p["fired"])
        assert [e[1] for e in p["events"]] == ["nonfinite", "nonfinite"], (r, p["events"])
        assert int(p["final"]["step"]) == STEPS - len(NAN)
    for k, v in port[0]["final"].items():  # replicas alike
        if not re.fullmatch(r"emb/\d+/(w|acc|counts)", k):
            assert all(p["final"][k].tobytes() == v.tobytes() for p in port[1:]), k


def test_guard_events_rollbacks_and_quarantine_equal_the_reference(runs):
    ref, port = runs
    for p in port:
        assert [e[:3] for e in p["events"]] == [tuple(e[:3]) for e in ref["events"]]
        np.testing.assert_allclose([e[3] for e in p["events"]],
                                   [e[3] for e in ref["events"]], rtol=1e-5, atol=0)
        assert (p["ema"] is None) == (ref["ema"] is None)
        if ref["ema"] is not None:
            np.testing.assert_allclose(p["ema"], ref["ema"], rtol=1e-5)
        assert (p["accepted"], p["failures"], p["fired"]) == (
            ref["accepted"], ref["failures"], ref["fired"])
        assert p["quarantined"] == ref["quarantined"] == ["step_00000015.corrupt"]
        assert p["fallback"] == ref["fallback"] == 10


def test_supervised_state_meets_the_pr12_bars_against_the_reference(runs):
    """The row-sharded leaves concatenated in rank order, every replicated
    leaf on rank 0: integers bitwise, floats to atol 1e-4."""
    ref, port = runs
    exp = ref["final"]
    assert sorted(port[0]["final"]) == sorted(exp)
    for k, e in exp.items():
        sharded = re.fullmatch(r"emb/\d+/(w|acc|counts)", k) is not None
        got = (np.concatenate([p["final"][k] for p in port]) if sharded
               else port[0]["final"][k])
        assert got.shape == e.shape, k
        if e.dtype.kind == "f":
            np.testing.assert_allclose(got, e, atol=1e-4, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got, e, err_msg=k)


def test_a_transient_fault_on_one_rank_rolls_every_rank_back(runs):
    _, port = runs
    for r, p in enumerate(port):
        assert p["one"]["failures"] == 1 and p["one"]["step"] == ONE_STEPS, (r, p["one"])
        assert p["one"]["clean"], r


# ------------------------------------------------- rejected steps, every rank
STRATEGIES = ("picasso", "hybrid", "ps", "picasso_l2", "picasso_narrow", "mp_nodedup",
              "allgather_rows", "mixed")
_MIX = ("picasso", "ps", "picasso_l2", "allgather_rows", "hybrid", "mp_nodedup")
CASES = [(s, u) for s in STRATEGIES for u in ("psum", "stale")]


def _port_rejections(group):
    """Each case of ``CASES``: two clean steps (the step-2 flush fills the
    tiers), a poisoned step, a clean step, guarded, against the unguarded
    steps over the clean batches; per case, whether the rejected step left
    this rank's every leaf bitwise and the run ended bitwise at the
    unguarded one, and the poisoned step's tier hits."""
    from repro_torch.configs import get_config
    from repro_torch.core.assign import apply_assignment
    from repro_torch.core.packing import make_plan
    from repro_torch.data.synthetic import make_batch
    from repro_torch.engine import resolve_assignment
    from repro_torch.models.wdl import WDLModel
    from repro_torch.runtime.chaos import poison_batch
    from repro_torch.runtime.guard import AnomalyGuard
    from repro_torch.train.train_step import TrainConfig, init_state, make_train_step

    cfg = get_config("deepfm", smoke=True)
    out = {}
    for strategy, update in CASES:
        kw = dict(hot_bytes=1 << 12, l2_bytes=1 << 16, flush_iters=2, warmup_iters=1,
                  n_micro=2, mesh_shape=(2, 2))
        if strategy == "picasso_narrow":
            kw["narrow_dim"] = 4
        if strategy in ("mp_nodedup", "mixed"):
            kw["exact_capacity"] = True
        if strategy == "mixed":
            kw["enable_packing"] = False
        plan = make_plan(cfg, W, GB // W, **kw)
        if strategy == "mixed":
            apply_assignment(plan, {g.gid: _MIX[i % len(_MIX)]
                                    for i, g in enumerate(plan.groups)})
        else:
            resolve_assignment(plan, strategy, world=W)
        model = WDLModel(cfg, plan)
        tcfg = TrainConfig(strategy="mixed" if plan.strategy else strategy,
                           cache_update=update, use_fused_kernels="off")
        plain = make_train_step(model, plan, GB, tcfg, "cpu", group=group)
        guard = AnomalyGuard(make_train_step(model, plan, GB, tcfg, "cpu", group=group),
                             group=group)
        rng = np.random.default_rng(5)
        batches = [make_batch(cfg, GB, rng) for _ in range(3)]
        sa = init_state(model, plan, torch.Generator().manual_seed(0), "cpu", group=group)
        sb = init_state(model, plan, torch.Generator().manual_seed(0), "cpu", group=group)
        for b in batches:
            sa, _ = plain(sa, b)
        for b in batches[:2]:
            sb, _ = guard(sb, b)
        before = _np_leaves(sb)
        sb, m = guard(sb, poison_batch(batches[2]))
        kept = bool(m["rejected"]) and _same(before, _np_leaves(sb))
        hits = int(m["cache_hits"])
        sb, m = guard(sb, batches[2])
        out[strategy, update] = {"kept": kept, "hits": hits,
                                 "end": m["anomalous"] == 0 and _same(_np_leaves(sa),
                                                                      _np_leaves(sb)),
                                 "cached": plain.engine.any_cache}
    return out


@pytest.fixture(scope="module")
def rejections(tmp_path_factory):
    return run_port(_port_rejections, tmp=tmp_path_factory.mktemp("dist_reject"),
                    deadline_s=600)


@pytest.mark.parametrize("strategy,update", CASES)
def test_rejected_step_leaves_every_rank_bitwise(rejections, strategy, update):
    """Each rank journals the rows its writes touch: its own rows of every
    rank's ids and every rank's tier slots, so a rejected step at world 4
    leaves every leaf of every rank bitwise as it was, and the guarded run
    ends bitwise at the unguarded run over the clean batches."""
    for r, res in enumerate(rejections):
        got = res[strategy, update]
        assert got["kept"] and got["end"], (r, got)
        if got["cached"] and update == "psum":
            assert got["hits"] > 0, (r, got)  # the rejected step wrote tier rows


# ---------------------------------------------------------- a fatal fault
def _fatal_body(group, args, shape):
    """A supervised toy loop (one psum a step) where rank 1 alone raises a
    fatal error before step 3; each rank marks what it raised."""
    from repro_torch.dist.compat import psum
    from repro_torch.train.fault_tolerance import Supervisor

    sup = Supervisor(args.ckpt_dir, ckpt_every=2, backoff_s=0.0, group=group)

    def step_fn(state, batch):
        x = psum(state["x"] + batch, group) / group.world
        return {"x": x, "step": state["step"] + 1}, {"loss": x}

    def inject(i):
        if group.rank == 1 and i == 3:
            raise TypeError("injected fatal fault on rank 1")

    try:
        sup.run({"x": torch.zeros(()), "step": 0}, step_fn, itertools.repeat(torch.ones(())),
                10, fail_injector=inject)
    except Exception as e:
        Path(args.ckpt_dir, f"rank{group.rank}.{type(e).__name__}").touch()
        raise


def test_a_fatal_fault_on_one_rank_ends_the_launch_non_zero(tmp_path):
    """``launch_ranks`` (what the train launcher runs past world 1) raises
    within ``FATAL_WITHIN_S`` seconds: rank 1's TypeError is fatal, the
    other ranks learn it from the agreement and raise too, none hangs."""
    from repro_torch.launch.train import launch_ranks

    args = types.SimpleNamespace(device="cpu", ckpt_dir=str(tmp_path))
    old = os.environ.get("PYTHONHASHSEED")
    t0 = time.monotonic()
    try:
        # whichever rank ends first ends the spawn: rank 1 with its own
        # error, another with the agreed verdict
        with pytest.raises(Exception, match="TypeError|PeerFailure"):
            launch_ranks("train", args, (2, 2), _fatal_body, waiting={})
    finally:
        if old is None:
            os.environ.pop("PYTHONHASHSEED", None)
        else:
            os.environ["PYTHONHASHSEED"] = old
    assert time.monotonic() - t0 < FATAL_WITHIN_S
    marks = {p.name for p in tmp_path.glob("rank*.*")}
    assert marks and marks <= {"rank1.TypeError"} | {f"rank{r}.PeerFailure"
                                                     for r in (0, 2, 3)}, marks


# -------------------------------------------------------------- the launcher
def _launch(*flags, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PYTHONHASHSEED=HASH_SEED,
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                           "deepfm", "--smoke", "--device", "cpu", "--devices", "4", "--mesh",
                           "2x2", "--global-batch", str(GB), "--log-every", "5", *flags],
                          capture_output=True, text=True, env=env, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def test_train_launcher_resumes_a_world_4_chaos_run(tmp_path):
    common = ("--ckpt-every", str(CKPT_EVERY), "--guard", "--chaos", SMOKE_CHAOS)
    d = str(tmp_path / "ck")
    first = _launch("--steps", "15", "--ckpt-dir", d, *common)
    second = _launch("--steps", "20", "--ckpt-dir", d, *common)
    whole = _launch("--steps", "20", "--ckpt-dir", str(tmp_path / "whole"), *common)
    assert first.stdout.count("[train] guard: rejected step (nonfinite") == 2
    assert all(f"[rank {r}] [repro_torch.ft] INFO: rolled back to step 10" in first.stderr
               for r in range(W))
    assert all(f"[rank {r}] [repro_torch.ft] INFO: restored checkpoint at step 15"
               in second.stderr for r in range(W))
    lines = re.findall(r"^  step +(\d+) loss=(\S+) .*$", second.stdout, re.M)
    assert [s for s, _ in lines] == ["20"], second.stdout
    assert re.findall(r"^  step +20 loss=(\S+) .*$", whole.stdout, re.M) == [lines[0][1]]
    for out in (first, second, whole):
        assert out.stdout.rstrip().endswith("[train] done")


@pytest.mark.parametrize("codes,verdict", [
    ((0, 0, 0, 0), "OK"), ((0, 2, 0, 0), "TRANSIENT"), ((2, 2, 2, 2), "TRANSIENT"),
    ((0, 3, 2, 0), "FATAL"), ((1, 1, 1, 1), "STOP"), ((1, 0, 1, 1), "FATAL"),
    ((1, 2, 1, 1), "TRANSIENT")])
def test_the_ranks_verdict(codes, verdict):
    """One decision from every rank's outcome: a fatal failure anywhere is
    fatal everywhere, a transient one rolls every rank back, the stream ends
    only where it ends on every rank; ranks at different steps are fatal."""
    from repro_torch.train import fault_tolerance as ft

    assert ft._verdict([(c, 5) for c in codes]) == getattr(ft, verdict)
    assert ft._verdict([(0, 5), (0, 6)]) == ft.FATAL


def test_train_launcher_refuses_another_worlds_checkpoint(tmp_path):
    """A world-1 run's checkpoint, resumed at ``--devices 4 --mesh 2x2``: no
    blind re-pad and no refusal any more; every rank restores its rows
    through ``restore_elastic`` (rank 0 prints the reference's line) and the
    run goes on from step 2, its losses the world-1 run's within the
    world-4 bar of ``tests/test_torch_dist_train.py``."""
    d = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PYTHONHASHSEED=HASH_SEED,
               OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "deepfm", "--smoke",
            "--device", "cpu", "--global-batch", str(GB), "--ckpt-every", "2",
            "--log-every", "1"]
    one = subprocess.run(base + ["--steps", "2", "--ckpt-dir", d], capture_output=True,
                         text=True, env=env, timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]
    four = subprocess.run(base + ["--steps", "4", "--devices", "4", "--mesh", "2x2",
                                  "--ckpt-dir", d],
                          capture_output=True, text=True, env=env, timeout=300)
    assert four.returncode == 0, four.stderr[-3000:]
    assert "WorldMismatch" not in four.stderr
    assert ("[train] elastic restored world=1 checkpoint at world=4 (resharded step 2)"
            in four.stdout), four.stdout
    whole = subprocess.run(base + ["--steps", "4", "--ckpt-dir", str(tmp_path / "w1")],
                           capture_output=True, text=True, env=env, timeout=300)
    assert whole.returncode == 0, whole.stderr[-3000:]
    pat = r"^  step +(\d+) loss=(\S+) .*$"
    got = re.findall(pat, four.stdout, re.M)
    want = re.findall(pat, whole.stdout, re.M)[2:]
    assert [s for s, _ in got] == ["3", "4"] == [s for s, _ in want]
    np.testing.assert_allclose([float(x) for _, x in got], [float(x) for _, x in want],
                               atol=2e-4, rtol=0)
