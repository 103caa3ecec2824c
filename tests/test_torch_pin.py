"""``--pin-l2`` in the port (``embedding.state.pinned_leaves``,
``pin_to_host``, ``pin_l2_to_host``, ``TrainConfig(pin_l2=True)``, the
launchers' flag) against the reference.

The placement is held against the reference's
``emb_shardings(plan, mesh, axes, pin_l2=True)``, which builds real
``pinned_host`` memory-kind shardings on this CPU. The reference's own
``--pin-l2`` runs cannot serve as the numeric reference here: JAX 0.9 on the
CPU moves the leaves and then fails the first lookup (``memory_space of all
inputs passed to gather must be the same``), so the port's pinned trajectory
is held to the port's unpinned one bitwise and to the reference without
``--pin-l2`` at the trajectory bars (losses rtol 1e-4 / atol 1e-5,
state 1e-4). Without CUDA the pinning functions return
the state unchanged (what the kernels do with host operands is shown on the
card by ``chip_smoke.py`` phase 16).
"""
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.assign import apply_assignment as japply_assignment
from repro.core.assign import resolve_assignment as jresolve_assignment
from repro.core.packing import make_plan as jmake_plan
from repro.data.synthetic import make_batch as jmake_batch
from repro.dist.sharding import batch_specs, emb_shardings, host_memory_kind, to_named
from repro.models.wdl import WDLModel as JWDLModel
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import init_state as jinit_state
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_jax
from repro_torch.core.assign import apply_assignment, resolve_assignment
from repro_torch.core.packing import make_plan
from repro_torch.data.synthetic import make_batch
from repro_torch.embedding import state as est
from repro_torch.kernels import host_memory, ops
from repro_torch.models.wdl import WDLModel
from repro_torch.optim import optimizers as topt
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.train_step import TrainConfig, init_state, make_train_step
from test_torch_serve import ROOT, _env

AXES = ("data", "model")
GB = 64
STEPS = 8
PLAN_KW = dict(hot_bytes=1 << 14, flush_iters=5, warmup_iters=2)


def _plan_pair(case):
    """(reference plan, port plan) of deepfm-smoke with the case's strategy
    recorded: ``picasso``, ``picasso_l2``, ``picasso_narrow`` with and
    without an L2 budget, or a two-class mix (``mixed``)."""
    kw = dict(PLAN_KW)
    name = case
    if case in ("picasso_l2", "picasso_narrow", "mixed"):
        kw["l2_bytes"] = 1 << 16
    if case.startswith("picasso_narrow"):
        kw["narrow_dim"] = 4
        name = "picasso_narrow"
    plans = (jmake_plan(jget_config("deepfm", smoke=True), 1, GB, **kw),
             make_plan(get_config("deepfm", smoke=True), 1, GB, **kw))
    if case == "mixed":  # unpacked: a class a table, picasso_narrow among them
        kw.update(enable_packing=False, narrow_dim=4)
        plans = (jmake_plan(jget_config("deepfm", smoke=True), 1, GB, **kw),
                 make_plan(get_config("deepfm", smoke=True), 1, GB, **kw))
        gids = sorted(g.gid for g in plans[1].groups)
        spec = {gid: ("picasso_narrow", "picasso_l2", "ps", "picasso")[gid % 4]
                for gid in gids}
        japply_assignment(plans[0], jresolve_assignment(plans[0], dict(spec)))
        apply_assignment(plans[1], resolve_assignment(plans[1], dict(spec)))
        return plans
    japply_assignment(plans[0], jresolve_assignment(plans[0], name))
    resolve_assignment(plans[1], name)
    return plans


def reference_pinned_leaves(jplan, mesh):
    """``{gid: leaf names}`` the reference's ``emb_shardings(pin_l2=True)``
    gives the ``pinned_host`` memory kind."""
    out = {}
    for gid, st in emb_shardings(jplan, mesh, AXES, pin_l2=True).items():
        names = [n for n in ("w", "acc", "counts") if getattr(st, n).memory_kind == "pinned_host"]
        for part in ("cache", "l2", "proj"):
            sub = getattr(st, part)
            if sub is not None:
                names += [f"{part}.{k}" for k in sub._fields
                          if getattr(sub, k).memory_kind == "pinned_host"]
        if names:
            out[gid] = tuple(names)
    return out


@pytest.mark.parametrize("case", ["picasso", "picasso_l2", "picasso_narrow",
                                  "picasso_narrow_no_l2", "mixed"])
def test_pinned_leaves_equal_reference_emb_shardings(mesh1, case):
    assert host_memory_kind() == "pinned_host"  # the reference's placement is real here
    jplan, plan = _plan_pair(case)
    got, want = est.pinned_leaves(plan), reference_pinned_leaves(jplan, mesh1)
    assert got == want
    narrowed = [str(g.gid) for g in plan.groups if plan.narrow_width(g.gid) < g.dim]
    with_l2 = [str(g.gid) for g in plan.groups if plan.l2_rows.get(g.gid, 0) > 0]
    assert bool(narrowed) == case.startswith("picasso_narrow") or case == "mixed"
    assert bool(with_l2) == (case in ("picasso_l2", "picasso_narrow", "mixed"))
    assert sorted(got) == sorted(set(narrowed) | set(with_l2))


def test_pinning_without_cuda_returns_the_state_and_warns_once(monkeypatch, capsys):
    assert not torch.cuda.is_available()
    _, plan = _plan_pair("picasso_narrow")
    model = WDLModel(get_config("deepfm", smoke=True), plan)
    state = init_state(model, plan, torch.Generator().manual_seed(0), "cpu")
    assert not est.l2_pinning_supported()
    assert est.pin_to_host(state, plan) is state
    assert est.pin_l2_to_host(state) is state
    assert est.pin_to_host(state["emb"], plan) is state["emb"]
    monkeypatch.setattr(est, "_PIN_L2_WARNED", False)
    est.warn_pin_l2_limits()
    est.warn_pin_l2_limits()
    out = capsys.readouterr().out
    assert out.count("[pin-l2] warning") == 1
    assert ("this backend exposes no 'pinned_host' memory kind — --pin-l2 is a no-op here "
            "(see the --pin-l2 row in README.md for the flag's documented limits)") in out
    assert host_memory.pinned_bytes() == 0


def test_host_operands_must_lie_in_mapped_pinned_memory():
    """A CPU tensor outside ``pinned_empty``'s buffers is no kernel operand:
    the device pointer lookup refuses it, and so does a wrapper's check."""
    t = torch.zeros((4, 3))
    assert not host_memory.is_mapped(t) and not host_memory.driver_pinned(t)
    with pytest.raises(ValueError, match="mapped pinned memory"):
        host_memory.device_pointer(t, "w")
    with pytest.raises(ValueError, match="dedup_adagrad w: .*mapped pinned memory"):
        ops._expect(t, "dedup_adagrad w", torch.float32, 2, torch.device("cuda"), host=True)
    with pytest.raises(ValueError, match="on cuda"):
        ops._expect(t, "dedup_adagrad idx", torch.float32, 2, torch.device("cuda"))


def test_row_helper_plain_version_is_indexing():
    table = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    idx = torch.tensor([7, 0, 7, 3])
    assert torch.equal(ops.take_rows(table, idx), table[idx])
    ops.put_rows(table, torch.tensor([2, 5]), torch.full((2, 4), -1.0))
    assert (table[[2, 5]] == -1).all() and table[3, 0] == 12
    keys = torch.arange(6, dtype=torch.int32)
    assert torch.equal(ops.take_rows(keys, torch.tensor([5, 1])), keys[[5, 1]])
    assert ops.launches["host_rows"] == 0


def test_restore_fills_the_template_in_place(tmp_path):
    """A restore writes into the template's own tensors (a pinned template
    stays pinned): every returned tensor is the template's."""
    _, plan = _plan_pair("picasso_narrow")
    model = WDLModel(get_config("deepfm", smoke=True), plan)
    state = init_state(model, plan, torch.Generator().manual_seed(0), "cpu")
    save_checkpoint(str(tmp_path), 3, state)
    tmpl = init_state(model, plan, torch.Generator().manual_seed(1), "cpu")
    ptrs = {n: t.data_ptr() for n, t in _leaves(tmpl).items()}
    restored, step = restore_checkpoint(str(tmp_path), tmpl)
    assert step == 3
    got = _leaves(restored)
    assert {n: t.data_ptr() for n, t in got.items()} == ptrs
    for n, t in _leaves(state).items():
        assert torch.equal(got[n], t), n


def _leaves(state):
    from repro_torch.train.checkpoint import _flatten

    return {k: v for k, v in _flatten(state).items() if isinstance(v, torch.Tensor)}


def _queue_card_writes(monkeypatch, state, plan):
    """Stand-ins for the card, on the CPU: the leaves ``pinned_leaves(plan)``
    names count as mapped, and writes queued to them (``pending``) land only
    when the host synchronizes, as a kernel's asynchronous writes over the
    bus do. Returns the queue and the list of synchronize calls."""
    mapped = {getattr(st.l2, n[3:]) if n.startswith("l2.") else getattr(st, n)
              for gid, names in est.pinned_leaves(plan).items()
              for st in [state["emb"][gid]] for n in names}
    ptrs = {t.data_ptr() for t in mapped}
    pending, calls = [], []

    def synchronize(device=None):
        calls.append(device)
        while pending:
            pending.pop(0)()

    monkeypatch.setattr(host_memory, "is_mapped", lambda t: t.data_ptr() in ptrs)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    return mapped, pending, calls


@pytest.mark.parametrize("how", ["save", "snapshot", "restore", "published"])
def test_host_io_of_mapped_leaves_waits_for_the_card(tmp_path, monkeypatch, how):
    """A checkpoint's save and host snapshot read a mapped leaf only after
    the writes queued to it have landed (a save straight after an unguarded
    step holds that step's rows), and a restore or a published delta's load
    writes it only after them (a queued write cannot land over the restored
    rows later)."""
    from repro_torch.runtime.stream import load_published
    from repro_torch.train.checkpoint import host_snapshot

    _, plan = _plan_pair("picasso_narrow")
    model = WDLModel(get_config("deepfm", smoke=True), plan)
    state = init_state(model, plan, torch.Generator().manual_seed(0), "cpu")
    if how in ("save", "snapshot"):
        want = {n: t.clone() for n, t in _leaves(state).items()}
        mapped, pending, calls = _queue_card_writes(monkeypatch, state, plan)
        for t in mapped:
            pending.append(lambda t=t: t.add_(1))
        names = [n for n, t in _leaves(state).items() if any(t is m for m in mapped)]
        for n in names:
            want[n] += 1
        if how == "save":
            save_checkpoint(str(tmp_path), 3, state)
            got, _ = restore_checkpoint(str(tmp_path), init_state(
                model, plan, torch.Generator().manual_seed(1), "cpu"))
        else:
            got = host_snapshot(state)
    else:
        save_checkpoint(str(tmp_path), 3, state)
        want = {n: t.clone() for n, t in _leaves(state).items()}
        tmpl = init_state(model, plan, torch.Generator().manual_seed(1), "cpu")
        mapped, pending, calls = _queue_card_writes(monkeypatch, tmpl, plan)
        for t in mapped:
            pending.append(lambda t=t: t.fill_(float("nan")) if t.is_floating_point()
                           else t.fill_(-7))
        load = restore_checkpoint if how == "restore" else load_published
        got, step = load(str(tmp_path), tmpl)
        assert step == 3
        torch.cuda.synchronize()  # the queue drains now, if not before the writes
    assert mapped and calls and not pending
    got = _leaves(got)
    for n, t in want.items():
        assert torch.equal(got[n], t), n


def test_pinned_trajectory_bitwise_unpinned_and_within_reference_bars(mesh1):
    """Narrow + L2 deepfm-smoke, 8 steps with the flush at step 5: the port
    under ``TrainConfig(pin_l2=True)`` is bitwise the port without it (losses,
    hits, every leaf), and both are within the trajectory bars of the reference
    without ``--pin-l2``, from the reference's initial state."""
    jplan, plan = _plan_pair("picasso_narrow")
    jcfg = jget_config("deepfm", smoke=True)
    jmodel = JWDLModel(jcfg, jplan)
    jstate = jinit_state(jmodel, jplan, jax.random.PRNGKey(0), mesh=mesh1, axes=AXES)
    tc = dict(strategy="picasso_narrow", use_fused_kernels="off")
    jstep, _ = jmake_train_step(jmodel, jplan, mesh1, AXES, GB, JTrainConfig(**tc),
                                donate=False)
    model = WDLModel(get_config("deepfm", smoke=True), plan)
    sides = []
    for pin in (True, False):
        state = train_state_from_jax(jax.device_get(jstate), plan, "cpu")
        step = make_train_step(model, plan, GB, TrainConfig(pin_l2=pin, **tc), "cpu")
        assert step.tcfg.pin_l2 == pin
        sides.append([state, step, [], []])
    keys = ("cache_hits", "cache_hits/l1", "cache_hits/l2", "overflow")
    rng = np.random.default_rng(0)
    jl, jm = [], []
    for _ in range(STEPS):
        b = jmake_batch(jcfg, GB, rng)
        jstate, jmet = jstep(jstate, jax.device_put(b, to_named(mesh1, batch_specs(b, AXES))))
        jl.append(float(jmet["loss"]))
        jm.append(tuple(int(jmet[k]) for k in keys))
        for side in sides:
            side[0], met = side[1](side[0], b)
            side[2].append(float(met["loss"]))
            side[3].append(tuple(int(met[k]) for k in keys))
    (pinned, _, pl, pm), (plain, _, ul, um) = sides
    assert pl == ul and pm == um
    for n, t in _leaves(plain).items():
        assert torch.equal(_leaves(pinned)[n], t), n
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-5)
    assert pm == jm and all(h[2] > 0 for h in pm[5:])
    jfin = jax.device_get(jstate)
    jst, st = jfin["emb"]["0"], pinned["emb"]["0"]
    np.testing.assert_array_equal(st.counts.numpy(), np.asarray(jst.counts))
    np.testing.assert_array_equal(st.l2.keys.numpy(), np.asarray(jst.l2.keys))
    for got, exp in ((st.w, jst.w), (st.acc, jst.acc), (st.cache.rows, jst.cache.rows),
                     (st.l2.rows, jst.l2.rows), (st.l2.acc, jst.l2.acc),
                     (st.proj.kernel, jst.proj.kernel)):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-4, rtol=0)
    for a, b in zip(topt.tree_leaves(pinned["dense"]), jax.tree.leaves(jfin["dense"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)


_STEP = re.compile(r"^  step +\d+ loss=.*$", re.M)


@pytest.mark.parametrize("launcher", ["train", "serve"])
def test_launchers_pin_l2_print_the_same_lines(launcher):
    """Each launcher with ``--pin-l2`` on the CPU warns once that the flag is
    a no-op here and otherwise prints what it prints without the flag (the
    train launcher's step lines, the server's mean probability)."""
    flags = ["--arch", "deepfm", "--smoke", "--device", "cpu", "--strategy",
             "picasso_narrow", "--narrow-dim", "4", "--l2-budget", "65536"]
    extra = (["--steps", "12", "--global-batch", "32", "--log-every", "1"]
             if launcher == "train" else ["--n-requests", "3", "--batch", "32"])
    outs = []
    for pin in (["--pin-l2"], []):
        r = subprocess.run([sys.executable, "-m", f"repro_torch.launch.{launcher}", *flags,
                            *extra, *pin], capture_output=True, text=True, timeout=600,
                           env=_env(PYTHONHASHSEED="0"), cwd=str(ROOT))
        assert r.returncode == 0, r.stderr[-3000:]
        outs.append(r.stdout)
    assert outs[0].count("[pin-l2] warning") == 1 and "[pin-l2]" not in outs[1]
    assert f"[{launcher}] pin-l2: 0 bytes pinned" in outs[0]
    if launcher == "train":
        got, want = _STEP.findall(outs[0]), _STEP.findall(outs[1])
        assert len(want) == 12 and got == want
    else:
        mean = re.compile(r"mean_prob=([\d.]+)$", re.M)
        assert mean.findall(outs[0]) == mean.findall(outs[1]) != []



def test_pinned_step_checks_the_placement_and_never_re_pins(monkeypatch):
    """Under ``pin_l2`` the step only checks the placement: a state whose
    named leaves are not in mapped pinned memory raises before anything
    runs (nothing is moved), and a placed one passes the check."""
    _, plan = _plan_pair("picasso_narrow")
    model = WDLModel(get_config("deepfm", smoke=True), plan)
    state = init_state(model, plan, torch.Generator().manual_seed(0), "cpu")
    before = {n: t.clone() for n, t in _leaves(state).items()}
    step = make_train_step(model, plan, GB, TrainConfig(strategy="picasso_narrow",
                                                        pin_l2=True), "cpu")
    monkeypatch.setattr(est, "l2_pinning_supported", lambda: True)
    monkeypatch.setattr(host_memory, "pinned_like", lambda t: pytest.fail("re-pinned"))
    batch = make_batch(get_config("deepfm", smoke=True), GB, np.random.default_rng(0))
    with pytest.raises(RuntimeError, match=r"--pin-l2: .*g0\.w on cpu.*g0\.l2\.acc"):
        step(state, batch)
    for n, t in _leaves(state).items():
        assert torch.equal(t, before[n]), n
    mapped, _, _ = _queue_card_writes(monkeypatch, state, plan)
    est.check_pinned(state, plan)  # every named leaf mapped: passes
    assert len(mapped) == 5
