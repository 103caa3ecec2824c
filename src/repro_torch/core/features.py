"""D-Packing of the input batch (paper Fig. 7a -> 7b), ``repro.core.features``
in torch.

Turns the per-field numpy batch dict {field: ids [B, L], weights [B, L]}
into one packed (ids, weights, seg) triple per PackedGroup on the device.
Scrambling + table offsets map raw per-table IDs into the packed global row
space. All of a group's fields are scrambled in one pass over a ``[B, L]``
matrix with per-column constants, so a group costs three host-to-device
copies whatever its field count. ``dense_features`` moves the batch's
numeric features to the device beside them, and ``seq_masks`` the validity
masks of the sequence fields.

The packing salt is the reference's ``hash(table) % 10007``, and Python
salts ``str`` hashes per process (``PYTHONHASHSEED``). One process per
rank must agree on it, or a raw id would pack to another row on each rank:
``agree_salts`` gathers every rank's salts once at start-up and raises
``SaltMismatch`` on a difference, and the launchers fix ``PYTHONHASHSEED``
before they spawn the ranks.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.hashing import _coprime_mult, affine_u32
from repro_torch.core.packing import PackedGroup, PicassoPlan


class PackedBatch(NamedTuple):
    ids: torch.Tensor      # [B * ids_per_sample] int32
    weights: torch.Tensor  # [B * ids_per_sample] float32
    seg: torch.Tensor      # [B * ids_per_sample] int32 bag index in [0, B*n_bags)
    n_bags: int            # per sample


class FieldView(NamedTuple):
    gid: int
    bag_offset: int
    n_bags: int
    dim: int


def field_index(plan: PicassoPlan) -> Dict[str, FieldView]:
    out = {}
    for g in plan.groups:
        for s in g.slots:
            out[s.field.name] = FieldView(g.gid, s.bag_offset, s.n_bags, g.dim)
    return out


def table_salt(table: str) -> int:
    """The per-table packing salt, ``hash(table) % 10007`` exactly as in the
    reference. Python salts ``str`` hashes per process (``PYTHONHASHSEED``),
    so a raw id packs to the same row only in processes that agree on it;
    checkpoint and publication manifests record these salts
    (``table_salts``) and restores compare them (``train.checkpoint``)."""
    return hash(table) % 10007


def table_salts(plan: PicassoPlan) -> Dict[str, int]:
    """``{table: salt}`` for every table the plan packs."""
    return {t.name: table_salt(t.name) for g in plan.groups for t in g.tables}


class SaltMismatch(ValueError):
    """Packing salts that differ from this process's: a checkpoint or a
    published delta packed under another ``PYTHONHASHSEED``, or ranks of
    one world that do not agree on it."""


def agree_salts(plan: PicassoPlan, group: Any) -> Dict[str, int]:
    """This rank's ``table_salts(plan)``, once every rank of ``group`` (a
    ``dist.Group``) is known to compute the same: the salts are
    all_gathered and a rank that differs from rank 0 makes every rank raise
    ``SaltMismatch`` naming ``PYTHONHASHSEED``. At world 1 there is nothing
    to compare."""
    salts = table_salts(plan)
    if group.world == 1:
        return salts
    from repro_torch.dist.compat import all_gather_tiled

    names = sorted(salts)
    dev = "cuda" if group.backend == "nccl" else "cpu"  # NCCL moves card tensors only
    mine = torch.tensor([salts[n] for n in names], dtype=torch.int64, device=dev)
    every = all_gather_tiled(mine, group).reshape(group.world, len(names))
    bad = [r for r in range(group.world) if not torch.equal(every[r], every[0])]
    if bad:
        raise SaltMismatch(
            f"ranks {bad} pack tables under other salts than rank 0 "
            f"(rank {group.rank}: {dict(zip(names, mine.tolist()))}); start every rank "
            "under one PYTHONHASHSEED (the launchers set it before they spawn the ranks)")
    return salts


def pack_group(group: PackedGroup, batch: Dict[str, Dict[str, np.ndarray]],
               device: Union[str, torch.device]) -> PackedBatch:
    """Build the packed ID tensor for one group on ``device``.

    The per-table salt is ``table_salt``'s, exactly the reference's; packed
    ids agree with the reference only inside one process or across
    processes that share ``PYTHONHASHSEED`` (see ROADMAP Queue 3)."""
    raw_l, w_l = [], []
    cols = []  # per packed column: (mult, salt, vocab, row offset, bag)
    for s in group.slots:
        f = s.field
        raw_l.append(np.asarray(batch[f.name]["ids"], np.int32))       # [B, L]
        w = np.asarray(batch[f.name]["weights"], np.float32)            # [B, L]
        if f.pooling == "mean":
            denom = np.clip(w.sum(axis=1, keepdims=True), 1e-9, None)
            w = (w / denom).astype(np.float32)
        w_l.append(w)
        table = next(t for t in group.tables if t.name == s.table)
        const = (_coprime_mult(table.vocab), table_salt(s.table), table.vocab,
                 group.table_offsets[s.table])
        for j in range(f.max_len):
            bag = s.bag_offset + (j if f.pooling == "none" else 0)
            cols.append(const + (bag,))
    raw = np.concatenate(raw_l, axis=1)
    b = raw.shape[0]
    c = torch.as_tensor(np.asarray(cols, np.int64).T).to(device)        # [5, L]
    ids64 = torch.as_tensor(raw).to(device).to(torch.int64)
    ids = (affine_u32(ids64, c[0], c[1], c[2]) + c[3]).to(torch.int32)
    weights = torch.as_tensor(np.concatenate(w_l, axis=1)).to(device)
    seg = (torch.arange(b, device=device, dtype=torch.int64)[:, None] * group.n_bags
           + c[4][None, :]).to(torch.int32)
    return PackedBatch(ids=ids.reshape(-1), weights=weights.reshape(-1),
                       seg=seg.reshape(-1), n_bags=group.n_bags)


def dense_features(cfg: Any, batch: Dict, device: Union[str, torch.device]
                   ) -> Optional[torch.Tensor]:
    """The batch's ``dense [B, n_dense]`` float32 features on ``device``, or
    ``None`` when the config has none."""
    if cfg.n_dense <= 0:
        return None
    return torch.as_tensor(np.asarray(batch["dense"], np.float32)).to(device)


MASK_PREFIX = "mask/"  # a sequence field's mask in a flat side dict


def mask_key(name: str) -> str:
    """The key of field ``name``'s validity mask in a step's side dict."""
    return MASK_PREFIX + name


def seq_masks(cfg: Any, batch: Dict, device: Union[str, torch.device]
              ) -> Dict[str, torch.Tensor]:
    """``{mask_key(name): weights > 0}`` ``[B, L]`` bool on ``device`` for
    every sequence field (``pooling == 'none'``), the reference's
    ``field_mask``, from one host-to-device copy of their weights. Flat, one
    tensor a field, so a micro-batch slices each with ``v[lo:hi]``."""
    seq = [f for f in cfg.fields if f.pooling == "none"]
    if not seq:
        return {}
    w = np.concatenate([np.asarray(batch["fields"][f.name]["weights"], np.float32)
                        for f in seq], axis=1)
    valid = torch.as_tensor(w).to(device) > 0
    return dict(zip((mask_key(f.name) for f in seq),
                    torch.split(valid, [f.max_len for f in seq], dim=1)))


def pack_batch(cfg: Any, plan: PicassoPlan, batch: Dict, device: Union[str, torch.device]
               ) -> Tuple[Dict[int, PackedBatch], Dict[str, torch.Tensor]]:
    """A step's device inputs: one ``PackedBatch`` per group, and the side
    tensors the model reads (``dense`` when the config has dense features,
    the sequence masks under ``mask_key``)."""
    packed = {g.gid: pack_group(g, batch["fields"], device) for g in plan.groups}
    side = seq_masks(cfg, batch, device)
    dense_x = dense_features(cfg, batch, device)
    if dense_x is not None:
        side["dense"] = dense_x
    return packed, side
