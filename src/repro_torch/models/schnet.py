"""SchNet [arXiv:1706.08566], the continuous-filter convolution GNN
(``repro.models.schnet`` in torch).

Message passing from plain scatter primitives (no sparse formats):
rbf(d_ij) -> filter MLP -> m_ij = x_src * W_ij -> a sum into dst
(``index_add_`` into zeros, the reference's ``segment_sum``). The
reference's ``axes`` becomes ``group``: past world 1 each rank holds a
block of the edge arrays and the whole node arrays, and each interaction's
partial node sum is psum'd (``dist.spmd.psum_psum``: ``lax.psum`` under
``shard_map(check_vma=False)``, whose transpose is a psum too, so the
step's pmean of the gradients gives the world-1 gradient).
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import SchNetConfig
from repro_torch.core.jax_random import Rng, rng_normal, rng_split
from repro_torch.dist.compat import Group
from repro_torch.dist.spmd import psum_psum
from repro_torch.layers.mlp import init_linear, linear

_LOG2 = float(np.float32(np.log(2.0)))  # a numpy float64: float32 in JAX


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): ``max(x, 0) +
    log1p(exp(-|x|))``, with its JVP's gradient ``exp(x - out)``, so it is
    0.5 at ``x = 0`` exactly (autograd of the formula gives 1 there, and a
    zero bias makes exact zeros common)."""

    @staticmethod
    def forward(ctx, x):
        out = torch.where(torch.isnan(x), x,
                          torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x))))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        finite = (torch.where(torch.isinf(x), 0.0, x), torch.where(torch.isinf(out), 0.0, out))
        return g * torch.exp(finite[0] - finite[1])


def ssp(x: torch.Tensor) -> torch.Tensor:
    """Shifted softplus (SchNet's activation)."""
    return _Softplus.apply(x) - _LOG2


def rbf_centers(n_rbf: int, cutoff: float) -> np.ndarray:
    """``jnp.linspace(0.0, cutoff, n_rbf)`` bit for bit, as XLA computes it:
    ``start * (1 - step) + stop * step`` with ``step = iota / (n - 1)``, whose
    division XLA turns into a product by the float32 reciprocal and
    reassociates, so with ``start = 0`` each center is ``i * (cutoff * (1 /
    (n - 1)))`` in float32; then ``cutoff``. Computed on the host, where no
    compiler contracts it further (``torch.linspace`` differs in 124 of 300)."""
    if n_rbf == 1:
        return np.zeros(1, np.float32)
    recip = np.float32(1) / np.float32(n_rbf - 1)
    stop = np.float32(cutoff)
    out = np.arange(n_rbf - 1, dtype=np.float32) * (stop * recip)
    return np.concatenate([out, [stop]]).astype(np.float32)


def rbf_expand(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    centers = torch.from_numpy(rbf_centers(n_rbf, cutoff)).to(dist.device)
    gamma = 10.0 / cutoff
    return torch.exp(-gamma * (dist[:, None] - centers[None, :]) ** 2)


def init_schnet(cfg: SchNetConfig, rng: Rng, device: Union[str, torch.device],
                d_feat: int = 0) -> Dict:
    """The reference's weights from a ``JaxKey``, or draws of the same
    shapes from a generator."""
    device = torch.device(device)
    ks = rng_split(rng, 4 + 6 * cfg.n_interactions)
    d = cfg.d_hidden
    p: Dict = {}
    if d_feat > 0:
        p["proj"] = init_linear(ks[0], d_feat, d, device)
    else:
        p["species"] = rng_normal(ks[0], (cfg.n_species, d), device) * 0.1
    for i in range(cfg.n_interactions):
        k = ks[4 + 6 * i: 10 + 6 * i]
        p[f"int{i}"] = {
            "filt1": init_linear(k[0], cfg.n_rbf, d, device),
            "filt2": init_linear(k[1], d, d, device),
            "in": init_linear(k[2], d, d, device),
            "out1": init_linear(k[3], d, d, device),
            "out2": init_linear(k[4], d, d, device),
        }
    p["energy1"] = init_linear(ks[1], d, d // 2, device)
    p["energy2"] = init_linear(ks[2], d // 2, 1, device)
    return p


def _segment_sum(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype,
                       device=data.device).index_add_(0, ids, data)


def interaction_block(p: Dict, x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                      rbf: torch.Tensor, edge_w: torch.Tensor, n_nodes: int,
                      group: Optional[Group] = None) -> torch.Tensor:
    """One cfconv + atom-wise block. With ``group`` past world 1 the edge
    arrays are this rank's block and the node sum is psum'd."""
    w = linear(p["filt2"], ssp(linear(p["filt1"], rbf)))            # [E, d]
    m = linear(p["in"], x)[src] * w * edge_w[:, None]                # gather + modulate
    agg = _segment_sum(m, dst, n_nodes)                              # scatter-add
    if group is not None:
        agg = psum_psum(agg, group)                                  # combine edge shards
    v = linear(p["out2"], ssp(linear(p["out1"], agg)))
    return x + v


def schnet_forward(cfg: SchNetConfig, p: Dict, nodes: torch.Tensor, src: torch.Tensor,
                   dst: torch.Tensor, dist: torch.Tensor, edge_w: torch.Tensor,
                   group: Optional[Group] = None) -> torch.Tensor:
    """nodes: [N, d_feat] float or [N] integer species; returns per-node energy [N]."""
    if nodes.dtype in (torch.int32, torch.int64):
        x = p["species"][nodes]
    else:
        x = linear(p["proj"], nodes)
    rbf = rbf_expand(dist, cfg.n_rbf, cfg.cutoff)
    n = x.shape[0]
    for i in range(cfg.n_interactions):
        x = interaction_block(p[f"int{i}"], x, src, dst, rbf, edge_w, n, group)
    e = linear(p["energy2"], ssp(linear(p["energy1"], x)))
    return e[:, 0]


def schnet_loss(cfg: SchNetConfig, p: Dict, batch: Dict,
                group: Optional[Group] = None) -> torch.Tensor:
    """Per-node (or per-graph, when ``graph_ids`` is given) energy MSE,
    weighted by ``node_w`` when the batch has it."""
    e = schnet_forward(cfg, p, batch["nodes"], batch["src"], batch["dst"],
                       batch["dist"], batch["edge_w"], group=group)
    if "graph_ids" in batch:
        e = _segment_sum(e, batch["graph_ids"], batch["target"].shape[0])
    err = (e - batch["target"]) ** 2
    if "node_w" in batch:
        err = err * batch["node_w"]
        return err.sum() / torch.clamp(batch["node_w"].sum(), min=1.0)
    return err.mean()
