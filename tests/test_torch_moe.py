"""The port's top-k MoE (``layers/moe.py``) against the reference on the CPU:
the dispatch's integer state, its gates and buffer, the combine, the whole
``moe_ffn`` with and without capacity drops, in one group and in four, and
its gradient.

Every case runs the same numpy inputs, made from a seed, through the
reference's function and the port's. Bars:

* ``order``, ``slot``, ``tok``, ``kept`` and the capacity bitwise, ties
  included: a zero router makes every probability equal, and the reference's
  ``lax.top_k`` gives the lower expert first, as the port's stable sort does;
* gates, the dispatched buffer and the combine within 1e-6 of the largest
  entry;
* ``moe_ffn`` within 1e-6 of the largest entry (measured: at most 2.9e-7);
* its gradients (x, the router and the three expert weights) within 1e-5 of
  each one's largest entry (measured: at most 3.2e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import moe as JM
from repro_torch.layers import moe as TM

from test_torch_lm import _err

torch.set_num_threads(1)

_jdispatch = jax.jit(JM.moe_dispatch, static_argnums=(2, 3, 4))
_jffn = jax.jit(JM.moe_ffn, static_argnames=("top_k", "capacity_factor", "groups"))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _weights(n, d, f, e, seed, zero_router=False):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, d)).astype(np.float32)
    rw = (np.zeros((d, e), np.float32) if zero_router
          else r.normal(size=(d, e)).astype(np.float32))
    w1 = (r.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32)
    w3 = (r.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32)
    w2 = (r.normal(size=(e, f, d)) / np.sqrt(f)).astype(np.float32)
    return x, rw, w1, w2, w3


CASES = [  # n, d, f, e, k, capacity factor, zero router
    (32, 16, 32, 4, 2, 2.0, False),
    (64, 8, 16, 8, 2, 4.0, False),
    (16, 8, 8, 4, 1, 4.0, False),
    (64, 8, 16, 4, 2, 1.0, False),    # drops
    (64, 8, 16, 4, 2, 1.0, True),     # every probability tied: heavy drops
    (40, 8, 16, 8, 2, 1.25, True),
    (100, 12, 24, 8, 2, 1.25, False),
]


@pytest.mark.parametrize("n,d,f,e,k,cf,zero", CASES)
def test_dispatch_and_combine_match_reference(n, d, f, e, k, cf, zero):
    x, rw, *_ = _weights(n, d, f, e, seed=n + e, zero_router=zero)
    logits = x @ rw
    jxe, (jorder, jslot, jtok, jkept), jgate, jcap = _jdispatch(
        jnp.asarray(x), jnp.asarray(logits), e, k, cf)
    txe, (order, slot, tok, kept), gate, cap = TM.moe_dispatch(_t(x), _t(logits), e, k, cf)
    assert cap == jcap
    for got, ref in ((order, jorder), (slot, jslot), (tok, jtok), (kept, jkept)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert _err(gate.numpy(), jgate) <= 1e-6
    assert _err(txe.numpy(), jxe) <= 1e-6
    if zero:
        assert not bool(kept.all())  # the tied router drops past capacity
    ye = np.random.default_rng(1).normal(size=(e, cap, d)).astype(np.float32)
    ref = JM.moe_combine(jnp.asarray(ye), (jorder, jslot, jtok, jkept), jgate, n, k)
    got = TM.moe_combine(_t(ye), (order, slot, tok, kept), gate, n, k)
    assert _err(got.numpy(), ref) <= 1e-6


def test_top_k_breaks_ties_toward_the_lower_index():
    p = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4], [0.3, 0.2, 0.3, 0.2]],
                 np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(p), 2)
    tv, ti = TM.top_k_lower_first(_t(p), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), [[0, 1], [1, 3], [0, 2]])


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("n,d,f,e,k,cf,zero", CASES)
def test_moe_ffn_matches_reference(n, d, f, e, k, cf, zero, groups):
    x, rw, w1, w2, w3 = _weights(n, d, f, e, seed=2 * n + e, zero_router=zero)
    ref = _jffn(*(jnp.asarray(a) for a in (x, rw, w1, w2, w3)), top_k=k,
                capacity_factor=cf, groups=groups)
    got = TM.moe_ffn(*(_t(a) for a in (x, rw, w1, w2, w3)), k, capacity_factor=cf,
                     groups=groups)
    assert _err(got.numpy(), ref) <= 1e-6


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("cf", [1.0, 4.0])
def test_moe_ffn_gradient_matches_reference(cf, groups):
    n, d, f, e, k = 64, 8, 16, 4, 2
    args = _weights(n, d, f, e, seed=5)
    cot = np.random.default_rng(6).normal(size=(n, d)).astype(np.float32)

    def jloss(*a):
        return jnp.sum(JM.moe_ffn(*a, k, capacity_factor=cf, groups=groups) * cot)

    refs = jax.grad(jloss, argnums=tuple(range(5)))(*(jnp.asarray(a) for a in args))
    leaves = [_t(a).requires_grad_(True) for a in args]
    out = TM.moe_ffn(*leaves, k, capacity_factor=cf, groups=groups)
    grads = torch.autograd.grad((out * _t(cot)).sum(), leaves)
    for got, ref in zip(grads, refs):
        assert _err(got.numpy(), ref) <= 1e-5
