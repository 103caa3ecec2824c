"""Plain PyTorch versions of the port's kernels (``repro.kernels.ref`` in
torch). The CPU runs these; ``chip_smoke.py`` holds each CUDA kernel against
them on the card. They repeat the kernels' arithmetic and are no yardstick
of speed.

TF32 is switched off here as in ``layers/mlp``: the plain projection
products (``gather_project_ref``) run on the card in the kernels' checks,
and TF32's three decimal digits would miss their 1e-5 bar by about 1e-3.
"""
from __future__ import annotations

from typing import Optional

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


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


def segment_grad_ref(g_bags: torch.Tensor, seg: torch.Tensor, weights: torch.Tensor,
                     inv: torch.Tensor, n_rows: int, order: Optional[torch.Tensor] = None,
                     sorted_inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transpose of ``gather_pool_ref``: per-position bag-grad gather scaled
    by the pooling weight, scattered back onto the unique-row slots. With
    the forward's permutation (``order``, ``sorted_inv = inv[order]``) the
    positions are taken in sorted order, each slot's in ascending original
    position, as the kernel adds them."""
    if order is not None:
        seg, weights, inv = seg[order], weights[order], sorted_inv
    per_id = g_bags[seg.long()] * weights[:, None].to(g_bags.dtype)
    out = torch.zeros((n_rows, g_bags.shape[1]), dtype=g_bags.dtype,
                      device=g_bags.device)
    return out.index_add_(0, inv.long(), per_id)


def dedup_adagrad_ref(w: torch.Tensor, acc: torch.Tensor, idx: torch.Tensor,
                      g: torch.Tensor, valid: torch.Tensor, lr: float, eps: float):
    """Sum duplicate row grads, then row-wise adagrad on touched rows only
    (the reference's argsort/segment_sum/scatter chain). Updates ``w`` and
    ``acc`` in place, as the kernel does, and returns them. Invalid entries
    and indices outside ``[0, rows)`` are dropped."""
    rows = w.shape[0]
    m = idx.shape[0]
    keep = valid & (idx >= 0) & (idx < rows)
    sidx = torch.where(keep, idx, torch.full_like(idx, rows)).to(torch.int32)
    si, order = torch.sort(sidx, stable=True)
    sg = g[order]
    first = torch.ones((m,), dtype=torch.bool, device=idx.device)
    first[1:] = si[1:] != si[:-1]
    slot = torch.cumsum(first, 0) - 1
    uidx = torch.full((m,), rows, dtype=torch.int64, device=idx.device)
    uidx[slot] = si.long()
    gsum = torch.zeros_like(sg).index_add_(0, slot, sg)
    gsq = (gsum * gsum).mean(dim=-1, keepdim=True)
    live = uidx < rows
    urow = uidx[live]
    acc_new = acc[urow] + gsq[live]
    upd = lr * gsum[live] / torch.sqrt(acc_new + eps)
    w.index_add_(0, urow, -upd.to(w.dtype))
    acc[urow] = acc_new.to(acc.dtype)
    return w, acc


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


def take_rows_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (the ``host_rows`` gather)."""
    return table[idx.long()]


def put_rows_ref(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> None:
    """``table[idx] = rows`` in place (the ``host_rows`` scatter)."""
    table[idx.long()] = rows


def _routed(idx: torch.Tensor, kept: torch.Tensor, m: int) -> torch.Tensor:
    """The kernels' ``ok`` condition: kept and a slot inside ``[0, m)``."""
    return kept & (idx >= 0) & (idx < m)


def gather_project_ref(back: torch.Tensor, idx: torch.Tensor, kept: torch.Tensor,
                       proj: torch.Tensor):
    """Unfused narrow-row stitch: gather ``[n, d]`` narrow rows out of the
    routed-back buffer, zero the positions that are not kept (or point
    outside it), and project up through the ``[d, D]`` map. Returns ``(wide
    [n, D], narrow [n, d])``; ``narrow`` is the residual of the projection's
    gradient."""
    m = back.shape[0]
    ok = _routed(idx, kept, m)
    narrow = back[idx.long().clamp(0, max(m - 1, 0))] * ok[:, None].to(back.dtype)
    return narrow @ proj, narrow


def gather_project_grad_ref(g_wide: torch.Tensor, g_narrow: torch.Tensor,
                            idx: torch.Tensor, kept: torch.Tensor, proj: torch.Tensor,
                            m: int) -> torch.Tensor:
    """Transpose of ``gather_project_ref`` w.r.t. ``back``: fold the wide
    cotangent back through ``proj`` and sum onto the routed-buffer slots.
    Positions that are not kept add into a drop row past the buffer."""
    ok = _routed(idx, kept, m)
    per = g_wide @ proj.T + g_narrow
    dst = torch.where(ok, idx.long(), torch.full_like(idx, m, dtype=torch.long))
    out = torch.zeros((m + 1, proj.shape[0]), dtype=g_wide.dtype, device=g_wide.device)
    return out.index_add_(0, dst, per)[:m]


def fm_interaction_ref(fields: torch.Tensor) -> torch.Tensor:
    """[B, F, D] -> [B, 1]: 0.5 * sum_d ((sum_f v)^2 - sum_f v^2)."""
    s = fields.sum(dim=1)
    ss = (fields * fields).sum(dim=1)
    return 0.5 * (s * s - ss).sum(dim=-1, keepdim=True)


def fm_interaction_bwd_ref(fields: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """d/dfields of ``fm_interaction_ref``: ``g[b] * (sum_f v - v)``."""
    s = fields.sum(dim=1, keepdim=True)              # [B, 1, D]
    return g[:, :, None] * (s - fields)              # g: [B, 1]


def dot_interaction_ref(fields: torch.Tensor) -> torch.Tensor:
    """[B, F, D] -> [B, F*(F-1)/2] upper-triangle pairwise dots, in
    ``np.triu_indices(F, k=1)`` order (row-major, as ``torch.triu_indices``)."""
    f = fields.shape[1]
    z = torch.bmm(fields, fields.transpose(1, 2))
    iu, ju = torch.triu_indices(f, f, 1, device=fields.device)
    return z[:, iu, ju]


def dot_interaction_bwd_ref(fields: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """d/dfields of ``dot_interaction_ref``: scatter the upper-triangle
    cotangent into gZ and apply ``(gZ + gZ^T) @ x``."""
    b, f, _ = fields.shape
    iu, ju = torch.triu_indices(f, f, 1, device=fields.device)
    gz = torch.zeros((b, f, f), dtype=g.dtype, device=g.device)
    gz[:, iu, ju] = g
    return torch.bmm(gz + gz.transpose(1, 2), fields)


# ---------------------------------------------------------------------------
# routed-gradient wire compression (grad_compress modes; the collective
# wrappers live in repro_torch.optim.grad_compression)
# ---------------------------------------------------------------------------


def fp16_compress_ref(g: torch.Tensor):
    """Per-row amax scaling + cast: ``(q float16 in [-1, 1], scale float32)``.

    All-zero rows compress to exact zeros (scale 0), so padded bucket slots
    survive the roundtrip bitwise. ``amax`` and ``clamp_min`` propagate NaN:
    a row holding a NaN compresses to an all-NaN row and scale NaN. The
    division is a true division and the cast rounds to nearest even."""
    scale = g.abs().amax(dim=-1, keepdim=True).to(torch.float32)
    q = (g / scale.clamp_min(1e-30)).to(torch.float16)
    return q, scale


def fp16_decompress_ref(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def topk_compress_ref(g: torch.Tensor, k: int):
    """Keep the k largest-magnitude entries per row: ``(vals, idx int32)``,
    descending, ties toward the lower column (``lax.top_k``'s order; a
    stable descending sort, since ``torch.topk`` promises no tie order). A
    NaN counts as larger than any number, as in ``lax.top_k``."""
    _, idx = torch.sort(g.abs(), dim=-1, descending=True, stable=True)
    idx = idx[:, :k]
    return torch.gather(g, 1, idx), idx.to(torch.int32)


def topk_decompress_ref(vals: torch.Tensor, idx: torch.Tensor, d: int) -> torch.Tensor:
    """Set ``vals`` at ``idx`` in a zero ``[m, d]`` block (the reference's
    ``.at[].set``); columns outside ``[0, d)`` are dropped, as its scatter
    drops them. The columns of a row are distinct, as compress gives them."""
    m = vals.shape[0]
    col = idx.long()
    col = torch.where((col >= 0) & (col < d), col, torch.full_like(col, d))
    out = torch.zeros((m, d + 1), dtype=vals.dtype, device=vals.device)
    return out.scatter_(1, col, vals)[:, :d].contiguous()


def cross_layer_ref(x0: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """DCN-v2: x0 * (x @ w + b) + x."""
    return x0 * (x @ w + b) + x


def cross_layer_bwd_ref(x0: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor, g: torch.Tensor):
    """d/d(x0, x, w, b) of ``cross_layer_ref`` (recomputes z = x@w + b)."""
    z = x @ w + b
    gz = g * x0
    gx0 = g * z
    gx = gz @ w.T + g
    gw = x.T @ gz
    gb = gz.sum(dim=0)
    return gx0, gx, gw, gb


# ---- the cross kernels' 3xTF32 arithmetic, emulated for the CPU tests ----


def tf32_split(a: torch.Tensor):
    """``(big, small)`` as the cross kernels feed them to the tensor cores:
    ``big`` is ``a`` rounded to nearest, ties away from zero, to tf32's
    10-bit mantissa (``cvt.rna.tf32.f32``'s rounding), ``small`` is ``a -
    big`` as the tensor core reads it, truncated to tf32. Integer operations
    on the float32 bit pattern: add half the unit of the 13 dropped bits,
    then clear them (for ``small`` only clear them)."""
    mask = ~0x1FFF
    big = ((a.contiguous().view(torch.int32) + 0x1000) & mask).view(torch.float32)
    small = ((a - big).contiguous().view(torch.int32) & mask).view(torch.float32)
    return big, small


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor, ranges) -> torch.Tensor:
    """``a @ b`` as the cross kernels compute it: the contraction cut into
    ``ranges`` (a cluster's ranks, ``ops.cross_ranges``), each part in
    3xTF32 (small_a·big_b + big_a·small_b + big_a·big_b, float32), the parts
    summed in rank order. Tensor cores sum a k-step in their own order, so
    this emulates the precision, not the bits."""
    out = None
    for lo, hi in ranges:
        ab, as_ = tf32_split(a[:, lo:hi])
        bb, bs = tf32_split(b[lo:hi])
        part = as_ @ bb + ab @ bs + ab @ bb
        out = part if out is None else out + part
    return out


# ---- the dedup kernels' grouping, emulated for the CPU tests ----


def dedup_adagrad_hashed(w: torch.Tensor, acc: torch.Tensor, idx: torch.Tensor,
                         g: torch.Tensor, valid: torch.Tensor, lr: float, eps: float,
                         cap: Optional[int] = None, seed: int = 0):
    """``dedup_adagrad_ref`` with its duplicates grouped the way the CUDA
    kernels group them (``csrc/dedup_adagrad.cu``), for the tests: each kept
    position, in the order its atomics land (a shuffle from ``seed``),
    inserts its row into a linear-probing table of ``cap`` slots (default
    the kernel's, the least power of two >= 2m; a tiny power of two makes
    probes collide) from the same multiplicative hash, and pushes itself
    onto its slot's list; the position that filled the slot owns the row.
    Each owner's list, if it holds at most 32 positions, is sorted
    ascending, else its row's positions are found by an ascending scan of
    ``idx``; the rows are summed in that order from +0.0. The Adagrad step
    is ``dedup_adagrad_ref``'s. Updates ``w`` and ``acc`` in place."""
    rows, m = w.shape[0], idx.shape[0]
    cap = cap or 1 << max(2 * m - 1, 1).bit_length()
    shift = 33 - cap.bit_length()
    ids, ok = idx.tolist(), valid.tolist()
    kept = [ok[j] and 0 <= ids[j] < rows for j in range(m)]
    if cap & (cap - 1) or cap <= len({ids[j] for j in range(m) if kept[j]}):
        raise ValueError(f"cap {cap}: a power of two above the distinct kept rows")
    key, head, nxt, owner = [0] * cap, [0] * cap, [0] * m, {}
    arrival = torch.randperm(m, generator=torch.Generator().manual_seed(seed)).tolist()
    for j in arrival:
        if not kept[j]:
            continue
        s = ((ids[j] * 2654435769) & 0xFFFFFFFF) >> shift
        while key[s] not in (0, ids[j] + 1):
            s = (s + 1) & (cap - 1)
        if key[s] == 0:
            key[s], owner[j] = ids[j] + 1, s
        nxt[j], head[s] = head[s], j + 1
    urow, gsum = [], []
    for s in sorted(owner.values(), key=lambda s: key[s]):
        row, pos, p = key[s] - 1, [], head[s]
        while p:
            pos.append(p - 1)
            p = nxt[p - 1]
        if len(pos) > 32:
            pos = [q for q in range(m) if kept[q] and ids[q] == row]
        total = torch.zeros_like(g[0])
        for q in sorted(pos):
            total = total + g[q]
        urow.append(row)
        gsum.append(total)
    if not urow:
        return w, acc
    urow = torch.tensor(urow, dtype=torch.int64, device=w.device)
    gsum = torch.stack(gsum)
    gsq = (gsum * gsum).mean(dim=-1, keepdim=True)
    acc_new = acc[urow] + gsq
    upd = lr * gsum / torch.sqrt(acc_new + eps)
    w.index_add_(0, urow, -upd.to(w.dtype))
    acc[urow] = acc_new.to(acc.dtype)
    return w, acc
