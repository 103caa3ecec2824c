"""The port's checkpoints (``repro_torch.train.checkpoint``) against the
reference's on the CPU, case by case after ``tests/test_checkpoint.py``.

Checkpoints are interchangeable: a deepfm-smoke train state (two tiers,
trained past a flush) checkpointed by the reference restores in the port
bitwise equal to ``convert.train_state_from_jax`` of the same state, and one
checkpointed by the port restores in the reference bitwise, with zstd and
without (the module's ``zstandard`` patched to ``None`` on either side).
Leaves stream in row chunks: the plain ``.npy`` file is bitwise what
``np.save`` writes. ``AsyncCheckpointer.save`` snapshots before it returns:
an in-place step right after it does not reach the checkpoint.
"""
import io

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.packing import make_plan as jmake_plan
from repro.data.synthetic import make_batch as jmake_batch
from repro.dist.sharding import batch_specs, to_named
from repro.models.wdl import WDLModel as JWDLModel
from repro.train import checkpoint as jck
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import init_state as jinit_state
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_jax
from repro_torch.core.features import table_salts
from repro_torch.core.packed_embedding import CacheState
from repro_torch.core.packing import make_plan
from repro_torch.data.synthetic import make_batch
from repro_torch.models.wdl import WDLModel
from repro_torch.train import checkpoint as ck
from repro_torch.train.checkpoint import (AsyncCheckpointer, latest_step, load_checkpoint_meta,
                                          load_checkpoint_salts, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.fault_tolerance import Supervisor
from repro_torch.train.train_step import TrainConfig, init_state, make_train_step

torch.set_num_threads(1)

AXES = ("data", "model")
GB = 32


def _state(rows=16):
    return {
        "emb": {"0": {"w": torch.arange(rows * 4, dtype=torch.float32).reshape(rows, 4),
                      "cache": CacheState(torch.arange(4, dtype=torch.int32),
                                          torch.ones((4, 4)), torch.zeros((4, 1)))}},
        "dense": {"l0": {"w": torch.ones((3, 3)), "b": torch.zeros((3,))}},
        "step": 7,
    }


def _blank(rows=16):
    return {
        "emb": {"0": {"w": torch.zeros((rows, 4)),
                      "cache": CacheState(torch.zeros(4, dtype=torch.int32),
                                          torch.zeros((4, 4)), torch.ones((4, 1)))}},
        "dense": {"l0": {"w": torch.zeros((3, 3)), "b": torch.ones((3,))}},
        "step": 0,
    }


def _equal(a, b):
    la, lb = sorted(ck._flatten(a).items()), sorted(ck._flatten(b).items())
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert x == y, k


@pytest.fixture(params=["zstd", "npy"])
def codec(request, monkeypatch):
    """Both leaf formats: the module's zstandard where it imports, and plain
    ``.npy`` with it patched out (as on a host without zstandard)."""
    if request.param == "zstd":
        if ck.zstandard is None:
            pytest.skip("zstandard is not installed")
    else:
        monkeypatch.setattr(ck, "zstandard", None)
        monkeypatch.setattr(jck, "zstandard", None)
    return request.param


def test_roundtrip_exact(tmp_path, codec):
    s = _state()
    save_checkpoint(str(tmp_path), 7, s)
    t = _blank()
    w_obj = t["emb"]["0"]["w"]
    r, step = restore_checkpoint(str(tmp_path), t)
    assert step == 7 and r["step"] == 7 and isinstance(r["step"], int)
    _equal(s, r)
    assert r["emb"]["0"]["w"] is w_obj  # filled in place
    suffix = ".npy.zst" if codec == "zstd" else ".npy"
    assert (tmp_path / "step_00000007" / f"emb__0__w{suffix}").exists()


def test_streamed_leaf_is_np_save_bytes(tmp_path, monkeypatch):
    """Row chunks of 4 KiB: the plain leaf file is bitwise ``np.save``'s and
    restores by chunks; the step leaf is the reference's 0-d int32."""
    monkeypatch.setattr(ck, "zstandard", None)
    monkeypatch.setattr(ck, "CHUNK_BYTES", 4096)
    w = torch.randn((1000, 10), generator=torch.Generator().manual_seed(1))
    save_checkpoint(str(tmp_path), 3, {"w": w, "step": 3})
    d = tmp_path / "step_00000003"
    buf = io.BytesIO()
    np.save(buf, w.numpy())
    assert (d / "w.npy").read_bytes() == buf.getvalue()
    st = np.load(d / "step.npy")
    assert st.dtype == np.int32 and st.shape == () and int(st) == 3
    r, _ = restore_checkpoint(str(tmp_path), {"w": torch.zeros((1000, 10)), "step": 0})
    assert torch.equal(r["w"], w) and r["step"] == 3


def test_zst_leaf_without_zstandard_is_corrupt(tmp_path, monkeypatch):
    if ck.zstandard is None:
        pytest.skip("zstandard is not installed")
    save_checkpoint(str(tmp_path), 1, _state())
    monkeypatch.setattr(ck, "zstandard", None)
    with pytest.raises(ck.CheckpointCorrupt, match="zstandard"):
        restore_checkpoint(str(tmp_path), _blank())


def test_world_mismatch_keep_and_repad(tmp_path):
    """A row-count mismatch raises (the elastic restore is ROADMAP Queue 1
    item 6); 'keep' hands back the stored rows, 'repad' zero-extends or
    truncates into the template."""
    save_checkpoint(str(tmp_path), 1, _state(rows=16))
    with pytest.raises(NotImplementedError, match="different world size.*item 6"):
        restore_checkpoint(str(tmp_path), _blank(rows=24))
    r, _ = restore_checkpoint(str(tmp_path), _blank(rows=24), on_row_mismatch="keep")
    assert tuple(r["emb"]["0"]["w"].shape) == (16, 4)
    r, _ = restore_checkpoint(str(tmp_path), _blank(rows=24), on_row_mismatch="repad")
    w = r["emb"]["0"]["w"]
    assert tuple(w.shape) == (24, 4)
    assert torch.equal(w[:16], torch.arange(64, dtype=torch.float32).reshape(16, 4))
    assert not w[16:].any()
    r, _ = restore_checkpoint(str(tmp_path), _blank(rows=8), on_row_mismatch="repad")
    assert tuple(r["emb"]["0"]["w"].shape) == (8, 4)
    with pytest.raises(ValueError, match="on_row_mismatch"):
        restore_checkpoint(str(tmp_path), _blank(rows=8), on_row_mismatch="bogus")


def test_keep_gc(tmp_path):
    for i in range(5):
        save_checkpoint(str(tmp_path), i, _state(), keep=2)
    assert latest_step(str(tmp_path)) == 4
    steps = sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("step_"))
    assert len(steps) == 2


def test_async_checkpointer(tmp_path):
    ck_ = AsyncCheckpointer(str(tmp_path))
    ck_.save(3, _state())
    ck_.wait()
    assert latest_step(str(tmp_path)) == 3


def test_meta_and_salts_sidecars_roundtrip(tmp_path):
    meta = {"plan_rev": 2, "cache_rows": {"0": 16}, "strategy": {"0": "ps"}}
    salts = {"cat_0": -1}  # no table salt is negative: a mismatch
    save_checkpoint(str(tmp_path), 1, _state())
    save_checkpoint(str(tmp_path), 2, _state(), meta=meta)
    assert load_checkpoint_meta(str(tmp_path), step=1) is None
    assert load_checkpoint_meta(str(tmp_path), step=2) == meta
    assert load_checkpoint_meta(str(tmp_path)) == meta
    assert load_checkpoint_salts(str(tmp_path)) is None
    ck_ = AsyncCheckpointer(str(tmp_path), salts=salts)
    ck_.save(3, _state(), meta=meta)
    ck_.wait()
    assert load_checkpoint_meta(str(tmp_path)) == meta
    assert load_checkpoint_salts(str(tmp_path)) == salts
    r, step = restore_checkpoint(str(tmp_path), _blank(), step=2)
    assert step == 2
    with pytest.raises(ck.SaltMismatch, match="PYTHONHASHSEED"):
        restore_checkpoint(str(tmp_path), _blank(), step=3)


def test_supervisor_failure_resume(tmp_path):
    state = {"x": torch.zeros(()), "step": 0}

    def step_fn(s, batch):
        return {"x": s["x"] + batch, "step": s["step"] + 1}, {"loss": s["x"]}

    def batches():
        while True:
            yield torch.tensor(1.0)

    fails = {"armed": True}

    def inject(step):
        if step == 5 and fails["armed"]:
            fails["armed"] = False
            raise RuntimeError("simulated node failure")

    sup = Supervisor(str(tmp_path), ckpt_every=2, max_retries=2, backoff_s=0.0)
    out = sup.run(state, step_fn, batches(), n_steps=8, fail_injector=inject)
    assert out["step"] == 8
    assert sup.total_failures == 1
    assert sup.failures == 0
    sup.ckpt.wait()
    assert latest_step(str(tmp_path)) == 8


def test_async_save_snapshots_before_an_in_place_step(tmp_path):
    """``save`` returns after a host snapshot: a deepfm-smoke step that
    updates the tables in place right after it leaves the checkpoint at the
    state before that step."""
    cfg = get_config("deepfm", smoke=True)
    plan = make_plan(cfg, 1, GB, hot_bytes=1 << 12, flush_iters=2, warmup_iters=1)
    model = WDLModel(cfg, plan)
    state = init_state(model, plan, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(model, plan, GB, TrainConfig(), "cpu")
    rng = np.random.default_rng(3)
    for _ in range(2):
        state, _ = step(state, make_batch(cfg, GB, rng))
    before = ck.host_snapshot(state)
    ckp = AsyncCheckpointer(str(tmp_path), salts=table_salts(plan))
    ckp.save(2, state)
    state, _ = step(state, make_batch(cfg, GB, rng))  # in place, at once
    ckp.wait()
    assert not torch.equal(state["emb"]["0"].w, before["emb"]["0"].w)
    template = init_state(model, plan, torch.Generator().manual_seed(9), "cpu")
    restored, s = restore_checkpoint(str(tmp_path), template)
    assert s == 2
    _equal(restored, before)


# ------------------------------------------- interchangeable with repro


@pytest.fixture(scope="module")
def jtrained(mesh1):
    """deepfm-smoke under picasso_l2 with both tiers, 4 steps past the
    step-3 flush, fetched to the host, and its two plans."""
    kw = dict(hot_bytes=1 << 14, l2_bytes=1 << 16, flush_iters=3, warmup_iters=2)
    jcfg = jget_config("deepfm", smoke=True)
    jplan = jmake_plan(jcfg, 1, GB, **kw)
    plan = make_plan(get_config("deepfm", smoke=True), 1, GB, **kw)
    jmodel = JWDLModel(jcfg, jplan)
    jstate = jinit_state(jmodel, jplan, jax.random.PRNGKey(0), mesh=mesh1, axes=AXES)
    jstep, _ = jmake_train_step(jmodel, jplan, mesh1, AXES, GB,
                                JTrainConfig(strategy="picasso_l2", use_fused_kernels="off"),
                                donate=False)
    rng = np.random.default_rng(0)
    for _ in range(4):
        b = jmake_batch(jcfg, GB, rng)
        jstate, _ = jstep(jstate, jax.device_put(b, to_named(mesh1, batch_specs(b, AXES))))
    assert int(np.asarray(jstate["emb"]["0"].l2.keys < plan.groups[0].rows).sum()) > 0
    return jax.device_get(jstate), jplan, plan, jmodel


def _template(plan, seed=5):
    return init_state(WDLModel(get_config("deepfm", smoke=True), plan), plan,
                      torch.Generator().manual_seed(seed), "cpu")


def test_reference_checkpoint_restores_in_the_port(jtrained, tmp_path, codec):
    jstate, jplan, plan, _ = jtrained
    jck.save_checkpoint(str(tmp_path), 4, jstate, meta={"plan_rev": 0})
    assert load_checkpoint_salts(str(tmp_path)) is None  # restores unchecked
    restored, s = restore_checkpoint(str(tmp_path), _template(plan))
    assert s == 4 and restored["step"] == 4
    _equal(restored, train_state_from_jax(jstate, plan, "cpu"))


def test_port_checkpoint_restores_in_the_reference(mesh1, jtrained, tmp_path, codec):
    jstate, jplan, plan, jmodel = jtrained
    state = train_state_from_jax(jstate, plan, "cpu")
    save_checkpoint(str(tmp_path), 4, state, meta={"plan_rev": 0}, salts=table_salts(plan))
    template = jinit_state(jmodel, jplan, jax.random.PRNGKey(7), mesh=mesh1, axes=AXES)
    restored, s = jck.restore_checkpoint(str(tmp_path), template)
    assert s == 4
    la, lb = jax.tree.leaves(jax.device_get(restored)), jax.tree.leaves(jstate)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert jck.load_checkpoint_meta(str(tmp_path)) == {"plan_rev": 0}


def test_restore_continues_training_bitwise(tmp_path):
    """Train 3 steps, checkpoint, train 2; a fresh process's view (a new
    template) restored from the checkpoint trains the same 2 steps to the
    same bits."""
    cfg = get_config("deepfm", smoke=True)
    plan = make_plan(cfg, 1, GB, hot_bytes=1 << 12, flush_iters=2, warmup_iters=1)
    model = WDLModel(cfg, plan)
    step = make_train_step(model, plan, GB, TrainConfig(), "cpu")
    rng = np.random.default_rng(6)
    batches = [make_batch(cfg, GB, rng) for _ in range(5)]
    state = init_state(model, plan, torch.Generator().manual_seed(0), "cpu")
    for b in batches[:3]:
        state, _ = step(state, b)
    save_checkpoint(str(tmp_path), 3, state, salts=table_salts(plan))
    for b in batches[3:]:
        state, _ = step(state, b)
    resumed, s = restore_checkpoint(str(tmp_path), _template(plan, seed=8))
    assert s == 3 and resumed["step"] == 3
    step2 = make_train_step(model, plan, GB, TrainConfig(), "cpu")
    for b in batches[3:]:
        resumed, _ = step2(resumed, b)
    _equal(resumed, state)
