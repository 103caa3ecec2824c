"""ID scrambling for shard load-balance (``repro.core.hashing`` in torch).

A fixed bijective affine scramble per table spreads the zipf head uniformly
over row blocks while keeping per-row frequency skew. The reference computes
``(ids * a + salt) % vocab`` in uint32, so the product and the sum both wrap
mod 2^32 before the fold. Torch has no uint32 arithmetic, so the port
computes in int64 and masks after each step: with ids < 2^31 and a < 2^32
the product fits in int64, and ``& 0xFFFFFFFF`` is the uint32 wrap.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

_KNUTH = 2654435761  # odd => bijective mod 2^k; good mixing constant
_U32 = 0xFFFFFFFF

IntOrTensor = Union[int, torch.Tensor]


def _coprime_mult(vocab: int) -> int:
    """A multiplier coprime with ``vocab`` (bijective affine map mod vocab)."""
    a = _KNUTH % vocab
    if a == 0:
        a = 1
    while np.gcd(a, vocab) != 1:
        a += 1
    return int(a)


def affine_u32(ids: torch.Tensor, a: IntOrTensor, salt: IntOrTensor,
               vocab: IntOrTensor) -> torch.Tensor:
    """``((ids * a) mod 2^32 + salt) mod 2^32 mod vocab`` on int64 ``ids``.
    ``a``/``salt``/``vocab`` may be per-column int64 tensors that broadcast
    against ``ids`` (``pack_group`` scrambles all of a group's fields in one
    pass that way)."""
    return ((((ids * a) & _U32) + salt) & _U32) % vocab


def scramble(ids: torch.Tensor, vocab: int, salt: int = 0) -> torch.Tensor:
    """Affine scramble of int32 ids into ``[0, vocab)``, bitwise equal to the
    reference's uint32 hashing trick."""
    return affine_u32(ids.to(torch.int64), _coprime_mult(vocab), salt,
                      vocab).to(torch.int32)
