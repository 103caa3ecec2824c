"""Synthetic skewed WDL batches (paper §II-B, Fig. 3), a numpy copy of
``repro.data.synthetic.make_batch``/``zipf_ids``/``batch_stream``: the same
seed gives the same batch on both sides. The batch stays a numpy dict until
``core.features.pack_group`` moves it to the device.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import WDLConfig


def zipf_ids(rng: np.random.Generator, vocab: int, size, a: float = 1.2) -> np.ndarray:
    """Bounded zipf sampler via inverse-CDF power approximation."""
    u = rng.random(size)
    # id ~ floor(vocab * u^{1/(a-1)}) gives a heavy head at small ids
    expo = 1.0 / max(a - 1.0, 0.05)
    ids = np.floor(vocab * np.power(u, expo)).astype(np.int64)
    return np.clip(ids, 0, vocab - 1).astype(np.int32)


def make_batch(cfg: WDLConfig, batch: int, rng: Optional[np.random.Generator] = None,
               zipf_a: float = 1.2, seed: int = 0, learnable: bool = False) -> Dict:
    rng = rng or np.random.default_rng(seed)
    fields = {}
    for f in cfg.fields:
        if f.name == "pos":  # positional field: ids are positions
            ids = np.tile(np.arange(f.max_len, dtype=np.int32), (batch, 1))
            w = np.ones((batch, f.max_len), np.float32)
        else:
            ids = zipf_ids(rng, f.vocab, (batch, f.max_len), zipf_a)
            if f.max_len > 1:
                # variable-length multi-hot: valid length uniform in [1, L]
                lens = rng.integers(1, f.max_len + 1, size=(batch, 1))
                w = (np.arange(f.max_len)[None, :] < lens).astype(np.float32)
                ids = np.where(w > 0, ids, 0).astype(np.int32)
            else:
                w = np.ones((batch, 1), np.float32)
        fields[f.name] = {"ids": ids, "weights": w}
    if learnable:
        # deterministic function of the categorical ids -> a model CAN fit it
        acc = np.zeros(batch, np.int64)
        for f in cfg.fields[: min(4, len(cfg.fields))]:
            acc = acc + fields[f.name]["ids"][:, 0].astype(np.int64)
        labels = (acc % 2).astype(np.float32)
    else:
        labels = rng.integers(0, 2, size=(batch,)).astype(np.float32)
    out = {"fields": fields, "labels": labels}
    if cfg.n_dense > 0:
        out["dense"] = rng.normal(size=(batch, cfg.n_dense)).astype(np.float32)
    return out


def batch_stream(cfg: WDLConfig, batch: int, seed: int = 0, zipf_a: float = 1.2,
                 learnable: bool = False, start: int = 0) -> Iterator[Dict]:
    """Infinite batch stream, seekable in O(1): batch ``i`` is generated from
    ``SeedSequence((seed, i))`` independent of every other batch, so a stream
    opened at ``start=i`` yields exactly what the original stream yielded at
    position ``i``."""
    i = start
    while True:
        rng = np.random.default_rng(np.random.SeedSequence((seed, i)))
        yield make_batch(cfg, batch, rng, zipf_a, learnable=learnable)
        i += 1
