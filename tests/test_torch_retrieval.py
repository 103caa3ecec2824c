"""The port's two-tower retrieval against the reference on the CPU.

sasrec-smoke and mind-smoke, on the reference's retrieval plan (one user,
no hot tier, exact capacities) and the reference's state from PRNGKey(0):
the port's ``make_retrieval_step`` returns the reference's top-k ids bit for
bit and its scores to 1e-5; chunked scoring (chunks of 32 and 48, the
second ragged) returns the unchunked result; candidate ids are rows of the
packed item table as they are; exact ties keep the earlier candidate, as
``lax.top_k`` does. The serve launcher's ``--retrieval`` prints the
reference launcher's top-10 ids, and under ``--strategy auto`` its
assignment too; the train launcher trains mind.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.packing import make_plan as jmake_plan
from repro.data.synthetic import make_batch as jmake_batch
from repro.models.wdl import WDLModel as JWDLModel
from repro.serve.serve_step import make_retrieval_step as jmake_retrieval_step
from repro.train.train_step import init_state as jinit_state
from repro_torch.configs import get_config
from repro_torch.convert import state_from_jax
from repro_torch.core.packing import make_plan
from repro_torch.engine import EmbeddingEngine
from repro_torch.models.wdl import WDLModel
from repro_torch.serve.serve_step import make_retrieval_step

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
AXES = ("data", "model")
NC = 256


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _setup(mesh1, arch, edit=None):
    """Both sides' model, plan and state (the reference's, converted), the
    user batch and the candidates ``arange(NC) % item vocab``; ``edit(w)``
    rewrites the reference's item table (numpy) before both sides take it."""
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    kw = dict(world=1, per_device_batch=1, enable_cache=False, exact_capacity=True)
    jplan, plan = jmake_plan(jcfg, **kw), make_plan(cfg, **kw)
    jmodel, model = JWDLModel(jcfg, jplan), WDLModel(cfg, plan)
    jstate = jax.device_get(jinit_state(jmodel, jplan, jax.random.PRNGKey(0)))
    if edit is not None:
        w = np.array(jstate["emb"]["0"].w)
        edit(w)
        jstate["emb"]["0"] = jstate["emb"]["0"]._replace(w=w)
    emb, dense = state_from_jax(jstate["emb"], jstate["dense"], plan, "cpu")
    user = jmake_batch(jcfg, 1, np.random.default_rng(1))
    cand = np.arange(NC, dtype=np.int32) % jcfg.fields[0].vocab
    return (jmodel, jplan, jax.tree.map(jnp.asarray, jstate)), \
        (model, plan, {"emb": emb, "dense": dense}), user, cand


def _reference(mesh1, ref, user, cand, **kw):
    jmodel, jplan, jstate = ref
    sv, ids = jmake_retrieval_step(jmodel, jplan, mesh1, AXES, NC, **kw)(
        jstate, user, jnp.asarray(cand))
    return np.asarray(sv), np.asarray(ids)


def _port(port, user, cand, **kw):
    model, plan, state = port
    sv, ids = make_retrieval_step(model, plan, NC, device="cpu", **kw)(
        state, user, torch.as_tensor(cand))
    return sv.numpy(), ids.numpy()


@pytest.mark.parametrize("arch", ["sasrec", "mind"])
def test_retrieval_matches_reference(mesh1, arch):
    ref, port, user, cand = _setup(mesh1, arch)
    jsv, jids = _reference(mesh1, ref, user, cand, top_k=10)
    sv, ids = _port(port, user, cand, top_k=10)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(sv, jsv, rtol=0, atol=1e-5)
    assert np.all(np.diff(sv) <= 0)


@pytest.mark.parametrize("arch", ["sasrec", "mind"])
@pytest.mark.parametrize("chunk", [32, 48])
def test_chunked_retrieval_is_the_unchunked_result(mesh1, arch, chunk):
    """Chunks of 32 (8 merges) and of 48 (a ragged last chunk, padded with
    the first id at -inf) return exactly what one chunk returns; the
    candidate engine's capacity is the chunk's."""
    _, port, user, cand = _setup(mesh1, arch)
    full = _port(port, user, cand, top_k=10)
    model, plan, _ = port
    step = make_retrieval_step(model, plan, NC, top_k=10, score_chunk=chunk, device="cpu")
    gid = step.gid
    assert step.cand_engine.strategies[gid].capacity[gid] == \
        max(plan.capacity[gid], chunk) < NC
    got = step(port[2], user, torch.as_tensor(cand))
    np.testing.assert_array_equal(got[1].numpy(), full[1])
    np.testing.assert_array_equal(got[0].numpy(), full[0])


@pytest.mark.parametrize("arch", ["sasrec", "mind"])
def test_candidate_ids_are_packed_rows(mesh1, arch):
    """A candidate id is a row of the item group's packed table, read as it
    is (no scramble, salt or table offset, as the reference reads it): the
    scores are ``max_k <w[c], user_k>`` over those rows."""
    _, port, user, cand = _setup(mesh1, arch)
    model, plan, state = port
    step = make_retrieval_step(model, plan, NC, top_k=NC, device="cpu")
    u = step.user(state, user)
    exp = torch.amax(state["emb"]["0"].w[torch.as_tensor(cand).long()] @ u.T, dim=-1)
    sv, ids = step(state, user, torch.as_tensor(cand))
    order = torch.sort(exp, descending=True, stable=True).indices
    np.testing.assert_array_equal(ids.numpy(), cand[order.numpy()])
    torch.testing.assert_close(sv, exp[order], rtol=0, atol=0)


def test_exact_ties_keep_the_earlier_candidate(mesh1):
    """Rows 77 and 200 made copies of row 5: over every candidate (top_k =
    NC) both sides rank the three tied scores 5, 77, 200 next to each other,
    unchunked and in chunks of 48 (77 and 200 in other chunks than 5)."""
    def edit(w):
        w[77] = w[200] = w[5]

    ref, port, user, cand = _setup(mesh1, "sasrec", edit)
    jsv, jids = _reference(mesh1, ref, user, cand, top_k=NC, score_chunk=48)
    for chunk in (None, 48):
        sv, ids = _port(port, user, cand, top_k=NC, score_chunk=chunk)
        at = int(np.flatnonzero(ids == 5)[0])
        assert list(ids[at:at + 3]) == [5, 77, 200] and sv[at] == sv[at + 1] == sv[at + 2]
        np.testing.assert_array_equal(ids, jids)


def test_top_k_beyond_the_candidates_returns_them_all(mesh1):
    _, port, user, cand = _setup(mesh1, "mind")
    model, plan, state = port
    step = make_retrieval_step(model, plan, 20, top_k=100, score_chunk=8, device="cpu")
    sv, ids = step(state, user, torch.as_tensor(cand[:20]))
    assert sorted(ids.tolist()) == sorted(cand[:20].tolist())
    assert torch.isfinite(sv).all()


def test_engine_capacity_override():
    cfg = get_config("sasrec", smoke=True)
    plan = make_plan(cfg, 1, 8)
    assert EmbeddingEngine(plan, 1).strategies[0].capacity == plan.capacity
    eng = EmbeddingEngine(plan, 1, capacity={0: 12345})
    assert eng.strategies[0].capacity == {0: 12345} and plan.capacity[0] != 12345


def test_serve_launcher_retrieval_prints_the_reference_top10():
    """``--retrieval`` at smoke size draws the reference's weights
    (``PRNGKey(0)``'s draws), so under one PYTHONHASHSEED it prints the reference
    launcher's top-10 ids."""
    outs = []
    for mod, extra in (("repro_torch.launch.serve", ["--device", "cpu"]),
                       ("repro.launch.serve", [])):
        out = subprocess.run([sys.executable, "-m", mod, "--arch", "sasrec", "--smoke",
                              "--retrieval", "--candidates", "4096", *extra],
                             capture_output=True, text=True, timeout=300,
                             env=_env(PYTHONHASHSEED="0", JAX_PLATFORMS="cpu"),
                             cwd=str(ROOT))
        assert out.returncode == 0, out.stderr
        m = re.search(r"^top-10: \[([\d\s]+)\]", out.stdout, re.M)
        assert m, out.stdout
        outs.append([int(x) for x in m.group(1).split()])
    assert len(outs[0]) == 10 and outs[0] == outs[1]


@pytest.mark.parametrize("arch", ["sasrec", "mind"])
def test_serve_launcher_retrieval_auto_prints_the_reference_mix(arch):
    """``--retrieval --strategy auto`` compiles the assignment at the
    reference's proxy batch (a score chunk's worth of item-group samples), so
    it prints the reference launcher's assignment, ``ids/shard`` included,
    and its top-10 ids."""
    outs = []
    for mod, extra in (("repro_torch.launch.serve", ["--device", "cpu"]),
                       ("repro.launch.serve", [])):
        out = subprocess.run([sys.executable, "-m", mod, "--arch", arch, "--smoke",
                              "--retrieval", "--candidates", "4096", "--strategy", "auto",
                              *extra],
                             capture_output=True, text=True, timeout=300,
                             env=_env(PYTHONHASHSEED="0", JAX_PLATFORMS="cpu"),
                             cwd=str(ROOT))
        assert out.returncode == 0, out.stderr
        mix = re.search(r"^\[serve\] strategy assignment .*\n((?:  g\d+: .*\n)+)",
                        out.stdout, re.M)
        top = re.search(r"^top-10: \[([\d\s]+)\]", out.stdout, re.M)
        assert mix and top, out.stdout
        outs.append((mix.group(1), top.group(1).split()))
    assert "ids/shard=" in outs[0][0] and outs[0] == outs[1]


def test_train_launcher_trains_mind_smoke_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "mind", "--smoke",
         "--device", "cpu", "--steps", "3", "--global-batch", "16", "--log-every", "1"],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert re.search(r"^  step +3 loss=[\d.]+ hits=\d+ ovf=\d+$", out.stdout, re.M), out.stdout


def test_retrieval_defaults_to_cuda(monkeypatch):
    """Without a card, ``make_retrieval_step`` and the launcher's
    ``--retrieval`` raise unless the CPU is asked for."""
    from repro_torch.launch import serve as serve_launcher

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("sasrec", smoke=True)
    plan = make_plan(cfg, world=1, per_device_batch=1, enable_cache=False,
                     exact_capacity=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_retrieval_step(WDLModel(cfg, plan), plan, NC, top_k=10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_launcher.main(["--arch", "sasrec", "--smoke", "--retrieval"])
