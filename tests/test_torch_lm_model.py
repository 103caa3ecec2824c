"""The port's LM family against the reference on the CPU, part 2: forward,
loss (``loss_chunk`` 0 and 8, ``remat`` on and off), prefill and decode
(into a cache of the config's dtype, at its fill and past its end, where
XLA clamps the write) of the four distinct smoke models (yi-34b's is
mistral-nemo-12b's at another RoPE theta), at float32 and at bfloat16
storage, from the reference's weights (``convert.lm_params_from_jax``).

Bars:

* logits, losses, prefill and its cache within 1e-5 of the largest entry
  (the loss relative), at float32 and at bfloat16 storage alike, since the
  reference computes in float32 there too (``emb`` is float32; measured: at
  most 1.6e-6);
* decode at float32 within 1e-5; at bfloat16 storage the logits within one
  bfloat16 ulp of the largest entry (2^-7): decode reads the bfloat16
  cache, so its attention output and the product with ``wo`` are bfloat16
  and a rounding flip there reaches the logits (measured over the five
  archs, token seeds 1-3 and fills 32 and 45: at most 3.1e-3, yi-34b;
  5.1e-4 phi3.5-moe; the others below 1e-6);
* the bfloat16 cache after decode within one bfloat16 ulp of each value plus
  1e-5 of the largest entry (the cast of a float32 ``k``/``v`` may round
  the other way; measured: 5.3e-4 of the largest entry on one value, and a
  value of 1.4e-5, left of cancellation, 2.4e-7 off).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import transformer as JT
from repro_torch.convert import lm_params_from_jax
from repro_torch.layers import transformer as TT

from test_torch_lm import (BF16_ULP, SMOKE_LMS, TOL, _cfgs, _err, _jax_params, _np, _t,
                           _tokens, _within_bf16_ulp)

torch.set_num_threads(1)

# the reference's entry points jitted once a config (decode's fill traced)
_STATIC = ("cfg", "attn_chunk", "loss_chunk")
_jforward = jax.jit(JT.lm_forward, static_argnames=_STATIC[:2])
_jloss = jax.jit(JT.lm_loss, static_argnames=_STATIC)
_jprefill = jax.jit(JT.lm_prefill, static_argnames=_STATIC[:2])
_jdecode = jax.jit(JT.lm_decode_step, static_argnames=_STATIC[:1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SMOKE_LMS)
def test_lm_paths_match_reference(arch, dtype):
    """Forward, loss (loss_chunk 0 and 8, remat on and off), prefill and
    decode (into a cache of cfg.dtype, at the fill and past the end, where
    XLA clamps the write)."""
    jc, tc = _cfgs(arch, dtype)
    jp = _jax_params(jc)
    tp = lm_params_from_jax(jp, "cpu")
    toks = _tokens(jc)
    jt, tt = jnp.asarray(toks), _t(toks).long()
    ref = _jforward(jc, jp, jt, attn_chunk=8)
    got = TT.lm_forward(tc, tp, tt, attn_chunk=8)
    assert got.dtype == torch.float32 and _err(_np(got), ref) <= TOL
    for lc in (0, 8):
        lj = float(_jloss(jc, jp, jt, attn_chunk=8, loss_chunk=lc))
        for remat in (False, True):
            lt = TT.lm_loss(tc, tp, tt, attn_chunk=8, loss_chunk=lc, remat=remat)
            assert lt.dtype == torch.float32 and abs(float(lt) - lj) <= TOL * abs(lj)
    jlg, jcache = _jprefill(jc, jp, jt, attn_chunk=8)
    tlg, tcache = TT.lm_prefill(tc, tp, tt, attn_chunk=8)
    assert _err(_np(tlg), jlg) <= TOL
    assert tcache.k.dtype == torch.float32 and str(jcache.k.dtype) == "float32"
    for a, b in zip(tcache, jcache):
        assert _err(_np(a), b) <= TOL
    # decode into a cache of 40 (cfg.dtype), the first 32 positions prefilled
    jc40 = jax.tree.map(lambda c, n: c.at[:, :, :32].set(n.astype(c.dtype)),
                        JT.init_kv_cache(jc, 2, 40), jcache)
    tc40 = TT.init_kv_cache(tc, 2, 40, "cpu")
    assert tc40.k.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    for dst, src in zip(tc40, tcache):
        dst[:, :, :32] = src.to(dst.dtype)
    nxt = toks[:, -1:]
    for length in (32, 45):  # 45: XLA clamps the write to position 39
        jlg2, jnew = _jdecode(jc, jp, jc40, jnp.asarray(nxt), jnp.int32(length))
        cache = TT.KVCache(tc40.k.clone(), tc40.v.clone())
        tlg2, tnew = TT.lm_decode_step(tc, tp, cache, _t(nxt).long(), length)
        assert tnew.k.data_ptr() == cache.k.data_ptr()   # written in place
        assert _err(_np(tlg2), jlg2) <= (TOL if dtype == "float32" else BF16_ULP)
        for a, b in zip(tnew, jnew):
            assert a.dtype == tc40.k.dtype
            if dtype == "float32":
                assert _err(_np(a), b) <= TOL
            else:
                assert _within_bf16_ulp(_np(a), np.asarray(b, np.float32))
