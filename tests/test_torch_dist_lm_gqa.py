"""mistral-nemo-smoke's train step (GQA: 4 query heads over 2 K/V heads)
past world 1 on the CPU, against the reference on 4 forced host devices
at meshes 2x2, 1x4 (each model rank's K/V columns half a head, gathered
over ``"model"``) and 4x1, under ``'fsdp'`` and ``'zero1'``: the harness
and bars of ``tests/test_torch_dist_lm.py``.
"""
import pytest
import torch

from test_torch_dist_lm import MESHES, MODES, case_id, check_case, run_both

torch.set_num_threads(1)

ARCHS = ("mistral-nemo-12b",)
CASES = [(a, m, mode, False) for a in ARCHS for m in MESHES for mode in MODES]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("dist_lm_gqa"), ARCHS, CASES)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_gqa_train_step_matches_reference(both, case):
    check_case(*both, case)
