"""JAX's threefry random numbers, recomputed with numpy on the host.

The reference draws two kinds of random numbers the port must repeat:

* ``capsule_routing`` starts from ``jax.random.normal(PRNGKey(17), (B, K,
  L))`` on every call, a constant of the model (``layers.interactions``
  keeps it on the device, one draw per shape);
* ``init_state(PRNGKey(seed))`` draws every weight from a tree of split
  keys. ``rng_split``/``rng_fold_in``/``rng_normal`` let one initialiser
  take either a ``JaxKey`` (the reference's draws, on the host: small
  shapes) or a ``torch.Generator`` (sequential draws on the device, in the
  same order: full width).

The numbers follow JAX with ``jax_threefry_partitionable`` on (the default
from JAX 0.5): ``bits(key, shape)`` is ``x0 ^ x1`` of threefry-2x32 over the
key with counters ``(0, arange(n))``, bit for bit; ``split(key, n)`` is the
pair ``(x0[i], x1[i])`` of the same hash, and ``fold_in(key, d)`` its hash
of ``(0, d)``. ``normal`` maps the bits to a float32 uniform on
``(-1, 1)`` exactly as ``jax.random.uniform`` does and takes XLA's float32
``ErfInv`` polynomial (Giles' single-precision approximation): within a few
float32 ulps of ``jax.random.normal``, whose own ``erf_inv`` is that
polynomial as XLA compiles it. Plain ``uint32`` arithmetic wraps as the
hash needs.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
# XLA's ErfInv32 coefficients, for w < 5 and for w >= 5
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


class JaxKey(NamedTuple):
    """A threefry key: the two uint32 words of ``jax.random.key_data``."""

    k0: int
    k1: int


def prng_key(seed: int) -> JaxKey:
    """``jax.random.PRNGKey(seed)`` for a seed in ``[0, 2**31)``."""
    return JaxKey(0, int(seed) & 0xFFFFFFFF)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: JaxKey, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 (20 rounds) of the counter pairs ``(x0, x1)``."""
    ks = (np.uint32(key.k0), np.uint32(key.k1))
    ks = ks + (ks[0] ^ ks[1] ^ _PARITY,)
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _hash_iota(key: JaxKey, n: int, start: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    return threefry2x32(key, np.zeros(n, np.uint32),
                        np.arange(start, start + n, dtype=np.int64).astype(np.uint32))


def split(key: JaxKey, n: int = 2) -> List[JaxKey]:
    """``jax.random.split(key, n)``."""
    x0, x1 = _hash_iota(key, n)
    return [JaxKey(int(a), int(b)) for a, b in zip(x0, x1)]


def fold_in(key: JaxKey, data: int) -> JaxKey:
    """``jax.random.fold_in(key, data)``."""
    x0, x1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return JaxKey(int(x0[0]), int(x1[0]))


def bits(key: JaxKey, shape: Sequence[int], rows: Optional[Tuple[int, int]] = None
         ) -> np.ndarray:
    """``jax.random.bits(key, shape)`` (uint32), bit for bit; with ``rows``
    ``(lo, hi)`` only those rows of it (each element's counter is its flat
    index, so a slice is drawn alone)."""
    shape = tuple(int(s) for s in shape)
    lo, hi = (0, shape[0]) if rows is None else rows
    per = int(np.prod(shape[1:], dtype=np.int64))
    x0, x1 = _hash_iota(key, (hi - lo) * per, lo * per)
    return (x0 ^ x1).reshape((hi - lo,) + shape[1:])


def _erfinv32(x: np.ndarray) -> np.ndarray:
    w = -np.log1p(-x * x)
    small = w < np.float32(5)
    w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3)).astype(np.float32)
    p = np.where(small, np.float32(_ERFINV_SMALL[0]), np.float32(_ERFINV_LARGE[0]))
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = (np.where(small, np.float32(a), np.float32(b)) + p * w).astype(np.float32)
    # |x| < 1 here: the uniform below never reaches -1 or 1, so XLA's
    # +-1 -> +-inf edge case never arises
    return (p * x).astype(np.float32)


def normal(key: JaxKey, shape: Sequence[int], rows: Optional[Tuple[int, int]] = None
           ) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32 (rows ``[lo, hi)`` of it
    with ``rows``)."""
    b = bits(key, shape, rows)
    f = ((b >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    # uniform(lo, 1): (1 - lo) rounds to 2 in float32
    u = np.maximum(lo, f * np.float32(2) + lo)
    return (np.float32(np.sqrt(2)) * _erfinv32(u)).astype(np.float32)


_ON_DEVICE: Dict[Tuple[JaxKey, Tuple[int, ...], str], torch.Tensor] = {}


def normal_on(key: JaxKey, shape: Sequence[int], device: torch.device) -> torch.Tensor:
    """``normal(key, shape)`` as a float32 tensor on ``device``, drawn once
    per key, shape and device and kept (a constant of the model)."""
    k = (key, tuple(int(s) for s in shape), str(device))
    if k not in _ON_DEVICE:
        _ON_DEVICE[k] = torch.from_numpy(normal(key, shape)).to(device)
    return _ON_DEVICE[k]


# ---------------------------------------------------------------------------
# one initialiser for both kinds of randomness
# ---------------------------------------------------------------------------

Rng = Union[torch.Generator, JaxKey]


def rng_split(rng: Rng, n: int) -> List[Rng]:
    """``split`` of a ``JaxKey``; a generator stands for all its children
    (they draw from it in turn)."""
    return split(rng, n) if isinstance(rng, JaxKey) else [rng] * n


def rng_fold_in(rng: Rng, data: int) -> Rng:
    return fold_in(rng, data) if isinstance(rng, JaxKey) else rng


def rng_normal(rng: Rng, shape: Sequence[int], device: torch.device,
               dtype=torch.float32, rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """A standard normal draw of ``shape`` on ``device``: the reference's
    from a ``JaxKey`` (computed on the host), else from the generator (which
    lives on ``device``). ``rows`` ``(lo, hi)`` returns only those rows of
    the same draw: a ``JaxKey`` computes just them; a generator, whose
    numbers are not addressable by position, draws the whole tensor (so it
    advances as far as the whole draw would) and keeps the slice."""
    if isinstance(rng, JaxKey):
        return torch.from_numpy(normal(rng, shape, rows)).to(device, dtype)
    full = torch.randn(tuple(shape), generator=rng, dtype=dtype, device=device)
    if rows is None:
        return full
    part = full[rows[0]:rows[1]].clone()
    del full
    return part
