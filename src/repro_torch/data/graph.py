"""Graph data: synthetic power-law graphs, a *real* neighbor sampler for
minibatch training (fanout sampling over CSR), and batched molecule graphs
(a copy of ``repro.data.graph``: NumPy, so every array is the reference's
bit for bit)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def synthetic_graph(n_nodes: int, n_edges: int, d_feat: int, seed: int = 0,
                    with_feat: bool = True) -> Dict[str, np.ndarray]:
    """Power-law-ish random graph + CSR, small enough to materialize."""
    rng = np.random.default_rng(seed)
    # preferential-attachment-flavoured endpoints (zipf head)
    u = rng.random(n_edges)
    src = np.clip((n_nodes * u ** 2.0).astype(np.int64), 0, n_nodes - 1)
    dst = rng.integers(0, n_nodes, n_edges)
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    out = {
        "src": src.astype(np.int32), "dst": dst.astype(np.int32),
        "indptr": indptr, "indices": dst.astype(np.int32),
        "dist": rng.uniform(0.5, 9.5, n_edges).astype(np.float32),
        "target": rng.normal(size=n_nodes).astype(np.float32),
    }
    if with_feat:
        out["nodes"] = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    else:
        out["nodes"] = rng.integers(0, 90, n_nodes).astype(np.int32)
    return out


def sample_neighbors(graph: Dict[str, np.ndarray], seeds: np.ndarray,
                     fanouts: Tuple[int, ...], rng: np.random.Generator
                     ) -> Dict[str, np.ndarray]:
    """Layer-wise fanout sampling (GraphSAGE style) over CSR.

    Returns a padded subgraph: relabelled nodes, edge list (src, dst) with
    edge weights 0 on padding, seed mask for the loss.
    """
    indptr, indices = graph["indptr"], graph["indices"]
    frontier = np.unique(seeds)
    all_src, all_dst = [], []
    nodes = [frontier]
    for f in fanouts:
        deg = indptr[frontier + 1] - indptr[frontier]
        # sample up to f neighbors per frontier node
        offs = rng.integers(0, np.maximum(deg, 1)[:, None], size=(len(frontier), f))
        has = deg > 0
        nbr = indices[np.minimum(indptr[frontier, None] + offs,
                                 np.maximum(indptr[frontier + 1, None] - 1, 0))]
        src_rep = np.repeat(frontier, f).reshape(len(frontier), f)
        keep = np.broadcast_to(has[:, None], nbr.shape)
        all_src.append(nbr[keep])       # messages flow neighbor -> node
        all_dst.append(src_rep[keep])
        frontier = np.unique(nbr[keep])
        nodes.append(frontier)
    node_ids = np.unique(np.concatenate(nodes))
    relabel = {int(g): i for i, g in enumerate(node_ids)}
    src = np.array([relabel[int(s)] for s in np.concatenate(all_src)], np.int32)
    dst = np.array([relabel[int(d)] for d in np.concatenate(all_dst)], np.int32)
    seed_local = np.array([relabel[int(s)] for s in np.unique(seeds)], np.int32)
    return {"node_ids": node_ids.astype(np.int32), "src": src, "dst": dst,
            "seeds_local": seed_local}


def pad_subgraph(sub: Dict[str, np.ndarray], graph: Dict[str, np.ndarray],
                 max_nodes: int, max_edges: int) -> Dict[str, np.ndarray]:
    """Static-shape padding for jit: node/edge arrays padded with weight 0."""
    n, e = len(sub["node_ids"]), len(sub["src"])
    n_c, e_c = min(n, max_nodes), min(e, max_edges)
    nodes_src = graph["nodes"][sub["node_ids"][:n_c]]
    if nodes_src.ndim == 1:
        nodes = np.zeros(max_nodes, nodes_src.dtype)
        nodes[:n_c] = nodes_src
    else:
        nodes = np.zeros((max_nodes, nodes_src.shape[1]), nodes_src.dtype)
        nodes[:n_c] = nodes_src
    out = {
        "nodes": nodes,
        "src": np.zeros(max_edges, np.int32), "dst": np.zeros(max_edges, np.int32),
        "dist": np.zeros(max_edges, np.float32),
        "edge_w": np.zeros(max_edges, np.float32),
        "target": np.zeros(max_nodes, np.float32),
        "node_w": np.zeros(max_nodes, np.float32),
    }
    out["src"][:e_c] = sub["src"][:e_c]
    out["dst"][:e_c] = sub["dst"][:e_c]
    out["dist"][:e_c] = np.random.default_rng(0).uniform(0.5, 9.5, e_c).astype(np.float32)
    out["edge_w"][:e_c] = 1.0
    out["target"][:n_c] = graph["target"][sub["node_ids"][:n_c]]
    seeds = sub["seeds_local"][sub["seeds_local"] < max_nodes]
    out["node_w"][seeds] = 1.0
    return out


def molecule_batch(batch: int, n_nodes: int, n_edges: int, seed: int = 0) -> Dict:
    """Batched small graphs (flat arrays + graph_ids)."""
    rng = np.random.default_rng(seed)
    tot_n, tot_e = batch * n_nodes, batch * n_edges
    off = (np.arange(batch, dtype=np.int32) * n_nodes)[:, None]
    src = (rng.integers(0, n_nodes, (batch, n_edges)) + off).reshape(-1)
    dst = (rng.integers(0, n_nodes, (batch, n_edges)) + off).reshape(-1)
    return {
        "nodes": rng.integers(0, 90, tot_n).astype(np.int32),
        "src": src.astype(np.int32), "dst": dst.astype(np.int32),
        "dist": rng.uniform(0.5, 9.5, tot_e).astype(np.float32),
        "edge_w": np.ones(tot_e, np.float32),
        "graph_ids": np.repeat(np.arange(batch, dtype=np.int32), n_nodes),
        "target": rng.normal(size=batch).astype(np.float32),
    }
