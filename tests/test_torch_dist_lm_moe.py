"""mixtral-smoke's train step (top-2 of 4 experts, tensor-parallel over
``F``, sliding window 16) past world 1 on the CPU, against the reference
on 4 forced host devices: the harness and bars of
``tests/test_torch_dist_lm.py``.

With ``moe_shard`` off the dispatch is global (every data rank's normed
tokens gathered, one dispatch, the rank's rows kept), so the losses are
the world-1 losses; with it on and more than one data shard each data
rank's tokens are one group with its own capacity (the reference's
``_moe_exec``), so the loss parts from world 1, as the reference's does.
At mesh 1x4 ``moe_shard`` changes nothing (one data shard).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.layers import transformer as JT

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import cells as tcells
from repro_torch.optim import optimizers as topt

from test_torch_dist_lm import case_id, check_case, lm_inputs, run_both
from test_torch_lm import TOL

torch.set_num_threads(1)

ARCH = "mixtral-8x22b"
CASES = [(ARCH, (2, 2), "fsdp", False), (ARCH, (1, 4), "zero1", False),
         (ARCH, (4, 1), "zero1", False), (ARCH, (2, 2), "fsdp", True),
         (ARCH, (4, 1), "zero1", True)]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("dist_lm_moe"), (ARCH,), CASES)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_moe_train_step_matches_reference(both, case):
    check_case(*both, case)


@pytest.mark.parametrize("mesh", [(2, 2), (4, 1)])
def test_moe_shard_parts_from_world_1_as_the_reference(both, mesh):
    """The first loss: with ``moe_shard`` off both sides equal the port's
    world-1 step; with it on both part from it by more than 1e-4 (the
    reference measured 6.0569868 at 2x2 and 6.0424128 at 4x1 against
    6.0563469), and agree with each other."""
    ref, port = both
    params0, toks = lm_inputs((ARCH,))[ARCH]
    cfg = get_config(ARCH, smoke=True)
    p = lm_params_from_jax(params0, "cpu")
    step = tcells.make_lm_train_step(cfg, attn_chunk=8, loss_chunk=8)
    _, _, w1 = step(p, topt.adam_init(p), torch.from_numpy(toks[0]).long())
    w1 = float(w1)
    off = [c for c in CASES if c[1] == mesh and not c[3]]
    on = [c for c in CASES if c[1] == mesh and c[3]]
    for case in off:
        np.testing.assert_allclose(port[0][case]["losses"][0], w1, rtol=TOL)
    for case in on:
        assert abs(ref[case]["losses"][0] - w1) > 1e-4
        assert abs(port[0][case]["losses"][0] - w1) > 1e-4
        np.testing.assert_allclose(port[0][case]["losses"][0], ref[case]["losses"][0],
                                   rtol=TOL)


def test_world1_token_groups_match_reference(both):
    """``lm_loss(moe_groups=2)`` at world 1 against the reference's
    ``lm_loss(moe_exec=(2, None))``, and the port's 2x2 ``moe_shard`` loss
    against it: each data rank's tokens are one of the two groups."""
    _, port = both
    jcfg = jget_config(ARCH, smoke=True)
    params0, toks = lm_inputs((ARCH,))[ARCH]
    ref = float(JT.lm_loss(jcfg, jax.tree.map(jnp.asarray, params0), jnp.asarray(toks[0]),
                           attn_chunk=8, loss_chunk=8, moe_exec=(2, None)))
    cfg = get_config(ARCH, smoke=True)
    got = float(tcells.lm_loss_fn(cfg, 8, 8, moe_groups=2)(lm_params_from_jax(params0, "cpu"),
                                                           torch.from_numpy(toks[0]).long()))
    assert abs(got - ref) <= TOL * abs(ref)
    np.testing.assert_allclose(port[0][(ARCH, (2, 2), "fsdp", True)]["losses"][0], got,
                               rtol=TOL)
