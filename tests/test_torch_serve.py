"""The port's serving path end to end against the reference on the CPU, its
launcher, and the guards that keep the port free of JAX and of ``repro``.

End to end: deepfm-smoke (and dcn-v2-smoke, from ``test_torch_dcn.py``),
the reference's state on ``mesh1`` with a warm (flushed) hot tier, carried
over by ``state_from_jax``; the port's
probabilities must match the reference's ``make_serve_step`` to 1e-5 with
the reference's fused kernels off and on (interpret mode), and the number
of tier hits must be equal and non-zero.
"""
import json
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
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.core.features import pack_group as jpack_group
from repro.core.packing import make_plan as jmake_plan
from repro.data.synthetic import make_batch as jmake_batch
from repro.dist.compat import shard_map
from repro.dist.sharding import emb_specs, replicated
from repro.engine import EmbeddingEngine as JEngine
from repro.models.wdl import WDLModel as JWDLModel
from repro.serve.serve_step import ServeConfig as JServeConfig
from repro.serve.serve_step import make_serve_step as jmake_serve_step
from repro.train.train_step import init_state as jinit_state
from repro.train.train_step import make_flush_fn
import repro_torch
from repro_torch.configs import get_config
from repro_torch.convert import state_from_jax
from repro_torch.core.features import pack_group
from repro_torch.core.packing import make_plan
from repro_torch.launch import serve as serve_launcher
from repro_torch.models.wdl import WDLModel
from repro_torch.serve.serve_step import ServeConfig, make_serve_step

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
AXES = ("data", "model")
B = 8


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _jax_hits(mesh, jplan, emb, fields):
    engine = JEngine(jplan, AXES, 1, use_fused_kernels="off")

    def f(emb, fields):
        packed = {g.gid: jpack_group(g, fields) for g in jplan.groups}
        _, ctx = engine.forward(emb, packed)
        return sum(jnp.sum(c.hit) for c in ctx.ctxs.values())

    g = jax.jit(shard_map(f, mesh=mesh, in_specs=(emb_specs(jplan, AXES), replicated(fields)),
                          out_specs=P(), check_vma=False))
    return int(g(emb, fields))


def test_deepfm_smoke_serve_matches_reference(mesh1):
    check_smoke_serve(mesh1, "deepfm")


def check_smoke_serve(mesh1, arch):
    """The end-to-end serving check for one smoke arch
    (``tests/test_torch_dcn.py`` runs it for dcn-v2)."""
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jplan, plan = jmake_plan(jcfg, 1, B), make_plan(cfg, 1, B)
    jmodel, model = JWDLModel(jcfg, jplan), WDLModel(cfg, plan)
    state = jinit_state(jmodel, jplan, jax.random.PRNGKey(0), mesh=mesh1, axes=AXES)
    batch = jmake_batch(jcfg, B, np.random.default_rng(3))
    # warm the FCounter on half of this request's packed ids (with ties),
    # then let the reference's flush load the hot tier
    ids = pack_group(plan.groups[0], batch["fields"], "cpu").ids.numpy()
    counts = np.zeros(plan.groups[0].rows, np.int32)
    counts[ids[::2]] = 3
    counts[np.random.default_rng(4).integers(0, len(counts), 4096)] += 1
    emb = dict(state["emb"])
    emb["0"] = emb["0"]._replace(counts=jnp.asarray(counts))
    state = make_flush_fn(jplan, mesh1, AXES)({**state, "emb": emb})
    emb_np, dense_np = jax.device_get(state["emb"]), jax.device_get(state["dense"])

    emb_t, dense_t = state_from_jax(emb_np, dense_np, plan, "cpu")
    probs, ctx = make_serve_step(model, plan, B, ServeConfig(), "cpu").score(
        {"emb": emb_t, "dense": dense_t}, batch)
    hits = int(sum(int(c.hit.sum()) for c in ctx.ctxs.values()))
    assert probs.shape == (B, 1)
    for mode in ("off", "on"):
        jserve = jmake_serve_step(jmodel, jplan, mesh1, AXES, B,
                                  scfg=JServeConfig(use_fused_kernels=mode))
        np.testing.assert_allclose(probs.numpy(), np.asarray(jserve(state, batch)),
                                   atol=1e-5, rtol=0)
    assert hits == _jax_hits(mesh1, jplan, state["emb"], batch["fields"]) > 0


def test_launcher_serves_smoke_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "deepfm", "--smoke",
         "--device", "cpu", "--n-requests", "3", "--batch", "32"],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert re.search(r"\[serve\] deepfm B=32: p50=[\d.]+ms p99=[\d.]+ms mean_prob=[\d.]+",
                     out.stdout), out.stdout


def test_launcher_help_exits_zero(capsys):
    with pytest.raises(SystemExit) as exc:
        serve_launcher.main(["--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--arch", "--smoke", "--batch", "--n-requests", "--strategy",
                 "--fused-kernels", "--device", "--seed", "--no-packing"):
        assert flag in out


def test_launcher_without_cuda_raises_and_does_not_fall_back(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_launcher.main(["--smoke", "--n-requests", "1"])
    assert "[serve]" not in capsys.readouterr().out


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("deepfm", smoke=True)
    plan = make_plan(cfg, 1, B)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_serve_step(WDLModel(cfg, plan), plan, B)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.resolve_device()
    assert repro_torch.resolve_device("cpu").type == "cpu"


_GUARD = r"""
import importlib, importlib.util, json, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
from repro_torch.launch import serve, train
serve.main(["--smoke", "--device", "cpu", "--n-requests", "1", "--batch", "8"])
train.main(["--smoke", "--device", "cpu", "--steps", "1", "--global-batch", "8",
            "--log-every", "1"])
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
try:
    mod.main()
    code = 0
except SystemExit as e:
    code = e.code
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"bad": bad, "chip_smoke_exit": code}))
"""


def test_port_imports_no_jax_and_no_repro():
    """Every port module, both launchers (one CPU request, one CPU training
    step), and chip_smoke up to its first CUDA call run without putting jax
    or repro into sys.modules; chip_smoke exits non-zero and prints no
    result where there is no card."""
    out = subprocess.run([sys.executable, "-c", _GUARD, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         env=_env(CUDA_VISIBLE_DEVICES=""), cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert "  step     1 loss=" in out.stdout and "[train] done" in out.stdout
    assert res["chip_smoke_exit"] not in (0, None)
    assert '"ok"' not in out.stdout


def test_port_sources_never_import_jax_or_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert offenders == []
