"""The port's LM family against the reference on the CPU, part 1: the
registry of every arch, RoPE, grouped, chunked, sliding-window and decode
attention, the weights drawn from a ``JaxKey`` and carried over by
``convert.lm_params_from_jax``, the decode cell's ring slot, and Adam/LAMB
on bfloat16 leaves. ``test_torch_lm_model.py`` holds forward, loss,
prefill and decode, ``test_torch_lm_train.py`` the gradients and training
steps (three files, so each runs in well under a minute alone).

Every case runs the same numpy inputs, made from a seed, through the
reference's function and the port's. Bars (the model files state theirs):

* attention and RoPE within 1e-6 of the reference output's largest entry;
* float32 weights from a ``JaxKey`` within 2e-6; bfloat16 weights within one
  bfloat16 ulp of each value plus 1e-5 of the largest entry (a float32 draw
  a few ulps off can round to the other neighbour; measured: 1.95e-3 on
  MoE values of about 0.25); carried over from the reference, bitwise;
* Adam and LAMB on bfloat16 leaves bitwise the reference's eager update.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_shapes as jget_shapes
from repro.configs import list_archs as jlist_archs
from repro.configs import skipped_shapes as jskipped_shapes
from repro.launch import cells as jcells
from repro.layers import attention as JA
from repro.layers import transformer as JT
from repro.optim import optimizers as jopt
from repro_torch.configs import get_config, get_shapes, list_archs, skipped_shapes
from repro_torch.convert import lm_params_from_jax, opt_state_from_jax
from repro_torch.core.jax_random import prng_key
from repro_torch.launch import cells as tcells
from repro_torch.layers import attention as TA
from repro_torch.layers import transformer as TT
from repro_torch.optim import optimizers as topt

torch.set_num_threads(1)

TOL = 1e-5
LMS = ("stablelm-1.6b", "mistral-nemo-12b", "yi-34b", "phi3.5-moe-42b-a6.6b",
       "mixtral-8x22b")
# the four distinct smoke models: yi-34b's is mistral-nemo-12b's at another theta
SMOKE_LMS = ("stablelm-1.6b", "mistral-nemo-12b", "phi3.5-moe-42b-a6.6b", "mixtral-8x22b")
BF16_ULP = 2.0 ** -7   # bfloat16 keeps 8 significant bits


def _t(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _err(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(float(np.abs(ref).max()), 1e-30))


def _within_bf16_ulp(got, ref) -> bool:
    """Each value within one bfloat16 ulp of the reference's, plus 1e-5 of
    the largest entry (the float32 error before the cast)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return bool(np.all(np.abs(got - ref) <= BF16_ULP * np.abs(ref) + TOL * np.abs(ref).max()))


def _cfgs(arch: str, dtype: str = "float32"):
    return (dataclasses.replace(jget_config(arch, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_list_archs_equals_reference():
    assert list_archs() == jlist_archs()
    assert len(list_archs()) == 10


@pytest.mark.parametrize("arch", jlist_archs())
def test_arch_configs_and_shapes_equal_reference(arch):
    for smoke in (False, True):
        j, t = jget_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
        assert type(t).__name__ == type(j).__name__
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.kind == j.kind
        if j.kind == "lm":
            assert t.head_dim == j.head_dim
            assert t.param_count() == j.param_count()
            assert t.active_param_count() == j.active_param_count()
    for inc in (False, True):
        assert ([(s.name, s.kind, s.dims) for s in get_shapes(arch, include_skipped=inc)]
                == [(s.name, s.kind, s.dims) for s in jget_shapes(arch, include_skipped=inc)])
    assert skipped_shapes(arch) == jskipped_shapes(arch)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

RNG = np.random.default_rng(0)


def _qkv(b, s, h, g, hd, seed=0):
    r = np.random.default_rng(seed)
    return tuple(r.normal(size=sh).astype(np.float32)
                 for sh in ((b, s, h, hd), (b, s, g, hd), (b, s, g, hd)))


@pytest.mark.parametrize("pos_2d", [False, True])
def test_rope_matches_reference(pos_2d):
    x = np.random.default_rng(1).normal(size=(2, 40, 3, 16)).astype(np.float32)
    pos = np.arange(40) * 37 + 5
    if pos_2d:
        pos = np.stack([pos, pos[::-1]])
    ref = JA.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = TA.apply_rope(_t(x), _t(pos), 1e6)
    assert _err(_np(got), ref) <= 1e-6
    np.testing.assert_array_equal(_np(TA.rope_freqs(16, 1e4)), np.asarray(JA.rope_freqs(16, 1e4)))


@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_matches_reference(masked):
    q, k, v = _qkv(2, 12, 4, 2, 8, seed=2)
    mask = None
    if masked:
        mask = np.random.default_rng(3).random((2, 1, 1, 12, 12)) < 0.7
        mask[..., 0] = True
    ref = JA._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   None if mask is None else jnp.asarray(mask))
    got = TA._sdpa(_t(q), _t(k), _t(v), None if mask is None else _t(mask))
    assert _err(_np(got), ref) <= 1e-6


_jchunked = jax.jit(JA.chunked_causal_attention, static_argnames=("chunk", "window"))


@pytest.mark.parametrize("chunk,window,s", [(4, None, 32), (8, None, 32), (32, None, 32),
                                            (8, 4, 32), (8, 8, 32), (8, 16, 32),
                                            (8, None, 36), (8, 12, 36), (16, 20, 64)])
def test_chunked_attention_matches_reference(chunk, window, s):
    q, k, v = _qkv(2, s, 4, 2, 8, seed=s + chunk)
    ref = _jchunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=chunk,
                    window=window)
    got = TA.chunked_causal_attention(_t(q), _t(k), _t(v), chunk=chunk, window=window)
    assert _err(_np(got), ref) <= 1e-6


@pytest.mark.parametrize("length,window", [(16, None), (9, None), ((5, 16), None),
                                           (16, 6), ((12, 3), 4)])
def test_decode_attention_matches_reference(length, window):
    q, k, v = _qkv(2, 16, 4, 2, 8, seed=7)
    ln = np.asarray(length, np.int32)
    ref = JA.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(ln), window=window)
    got = TA.decode_attention(_t(q[:, :1]), _t(k), _t(v), _t(ln), window=window)
    assert _err(_np(got), ref) <= 1e-6


def test_decode_attention_reads_a_bf16_cache_as_the_reference():
    q, k, v = _qkv(2, 16, 4, 2, 8, seed=8)
    kb, vb = k.astype(ml_dtypes.bfloat16), v.astype(ml_dtypes.bfloat16)
    ref = JA.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(kb), jnp.asarray(vb),
                              jnp.int32(11))
    got = TA.decode_attention(_t(q[:, :1]), _t(kb), _t(vb), 11)
    assert got.dtype == torch.bfloat16 and str(ref.dtype) == "bfloat16"
    assert _within_bf16_ulp(_np(got), ref)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

_JAX_PARAMS = {}


def _jax_params(jc):
    key = (jc.name, jc.dtype)
    if key not in _JAX_PARAMS:
        _JAX_PARAMS[key] = jax.device_get(JT.init_lm_params(jc, jax.random.PRNGKey(0)))
    return _JAX_PARAMS[key]


def _tokens(jc, b=2, s=32, seed=1):
    return np.random.default_rng(seed).integers(0, jc.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LMS)
def test_init_from_jax_key_matches_reference(arch, dtype):
    jc, tc = _cfgs(arch, dtype)
    jl = jax.tree.leaves(_jax_params(jc))
    tl = topt.tree_leaves(TT.init_lm_params(tc, prng_key(0), "cpu"))
    assert len(tl) == len(jl)
    conv = topt.tree_leaves(lm_params_from_jax(_jax_params(jc), "cpu"))
    for a, b, c in zip(tl, jl, conv):
        assert str(a.dtype).split(".")[-1] == str(b.dtype) and c.dtype == a.dtype
        np.testing.assert_array_equal(_np(c), np.asarray(b, np.float32))
        if a.dtype == torch.float32:
            assert float(np.abs(_np(a) - np.asarray(b)).max()) <= 2e-6
        else:
            assert _within_bf16_ulp(_np(a), np.asarray(b, np.float32))
    # emb is float32 whatever the storage dtype, as the reference's is
    assert tl[0].dtype == torch.float32 and str(jl[0].dtype) == "float32"


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "stablelm-1.6b"])
def test_decode_ring_slot_matches_reference(arch):
    """The decode cell's cache length and write slot (the reference's
    ``build_lm_cell``: ``min(seq, swa_window)``, ``length % cache_len``)."""
    for smoke in (False, True):
        cfg, jcfg = get_config(arch, smoke=smoke), jget_config(arch, smoke=smoke)
        for seq in (16, 4096, 32768, 524288):
            n = tcells.decode_cache_len(cfg, seq)
            assert n == (min(seq, jcfg.swa_window) if jcfg.swa_window else seq)
            for length in (0, 5, n - 1, n, 3 * n + 7):
                assert tcells.ring_slot(length, n) == length % n
                assert int(tcells.ring_slot(torch.tensor(length), n)) == length % n


# ---------------------------------------------------------------------------
# Adam and LAMB on bfloat16 leaves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lr", [1e-4, 1e-3])
@pytest.mark.parametrize("name", ["adam", "lamb"])
def test_bf16_optimizer_is_bitwise_reference(name, lr):
    """Moments and leaves after 1 and 3 updates bitwise the reference's
    (eager) update: weak Python constants in the leaf's dtype, the step in
    float32, the leaf cast back. The float32 leaf beside it keeps
    ``test_torch_train.py``'s bar (1e-6): the bias corrections' ``b1 ** t``
    may differ in the last bit."""
    rng = np.random.default_rng(0)
    params = {"w": (rng.normal(size=65536) * 0.02).astype(ml_dtypes.bfloat16),
              "f": (rng.normal(size=(64, 8)) * 0.02).astype(np.float32)}
    jp, tp = jax.tree.map(jnp.asarray, params), {k: _t(v) for k, v in params.items()}
    js, ts = jopt.adam_init(jp), topt.adam_init(tp)
    jupd, tupd = getattr(jopt, f"{name}_update"), topt.OPTIMIZERS[name]
    for i in range(3):
        grads = {"w": (rng.normal(size=65536) * 1e-3).astype(ml_dtypes.bfloat16),
                 "f": (rng.normal(size=(64, 8)) * 1e-3).astype(np.float32)}
        jp, js = jupd(jp, jax.tree.map(jnp.asarray, grads), js, lr)
        tp, ts = tupd(tp, {k: _t(v) for k, v in grads.items()}, ts, lr)
        if i in (0, 2):
            for t_tree, j_tree in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
                assert t_tree["w"].dtype == torch.bfloat16
                np.testing.assert_array_equal(t_tree["w"].view(torch.int16).numpy(),
                                              np.asarray(j_tree["w"]).view(np.int16))
                np.testing.assert_allclose(t_tree["f"].numpy(), np.asarray(j_tree["f"]),
                                           atol=1e-6, rtol=1e-6)
