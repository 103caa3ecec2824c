"""Plain PyTorch versions of the serve-path kernels (``repro.kernels.ref`` in
torch). The CPU runs these; ``chip_smoke.py`` holds each CUDA kernel against
them on the card. They repeat the kernels' arithmetic and are no yardstick
of speed."""
from __future__ import annotations

from typing import Optional

import torch


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor, seg: torch.Tensor,
                      n_bags: int, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    rows = table[ids.long()]
    if weights is not None:
        rows = rows * weights[:, None].to(rows.dtype)
    out = torch.zeros((n_bags, table.shape[1]), dtype=table.dtype, device=table.device)
    return out.index_add_(0, seg.long(), rows)


def gather_pool_ref(rows_u: torch.Tensor, inv: torch.Tensor, weights: torch.Tensor,
                    seg: torch.Tensor, n_bags: int) -> torch.Tensor:
    """Unfused SegmentReduction: materializes the [n, D] per-id intermediate."""
    per_id = rows_u[inv.long()] * weights[:, None].to(rows_u.dtype)
    out = torch.zeros((n_bags, rows_u.shape[1]), dtype=rows_u.dtype,
                      device=rows_u.device)
    return out.index_add_(0, seg.long(), per_id)


def tier_probe_ref(uniq: torch.Tensor, uvalid: torch.Tensor, keys: torch.Tensor,
                   rows: torch.Tensor):
    """searchsorted + take + where chain of ``cache_probe`` plus the hit-row
    gather; miss rows are exact zeros (the kernel's contract)."""
    p = torch.searchsorted(keys, uniq)
    slot = p.clamp(0, keys.shape[0] - 1)
    hit = (keys[slot] == uniq) & uvalid
    out = torch.where(hit[:, None], rows[slot],
                      torch.zeros((1, rows.shape[1]), dtype=rows.dtype, device=rows.device))
    return hit, slot.to(torch.int32), out


def fm_interaction_ref(fields: torch.Tensor) -> torch.Tensor:
    """[B, F, D] -> [B, 1]: 0.5 * sum_d ((sum_f v)^2 - sum_f v^2)."""
    s = fields.sum(dim=1)
    ss = (fields * fields).sum(dim=1)
    return 0.5 * (s * s - ss).sum(dim=-1, keepdim=True)
