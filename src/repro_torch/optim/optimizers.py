"""Dense-parameter optimizers (``repro.optim.optimizers`` in torch): SGD,
Adam and LAMB over the plain nested parameter dicts of ``WDLModel``.

Sparse embedding rows use the row-wise Adagrad of the engine
(``kernels.ops.dedup_adagrad``). The arithmetic is the reference's, term by
term and in its order (``lr * (m / c1) / (sqrt(v / c2) + eps)`` with the
step ``t`` an int32 and the bias corrections in float32), so a run matches
the reference step for step; ``torch.optim.Adam`` orders it differently.
The updates are functional: they return new tensors.

On a bfloat16 or float16 leaf the types follow JAX's promotion: a Python
constant (``b1``, ``1 - b2``, ``lr * wd``) is weakly typed and takes the
leaf's dtype (``weak_scalar``), so the moments are products and sums in that
dtype; the float32 bias corrections promote the step to float32, and only
the updated leaf is cast back. On float32 leaves both rules are the plain
arithmetic, bit for bit.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

_FLOAT = (torch.float32, torch.bfloat16, torch.float16)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``jax.tree.map`` over nested dicts of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like: Any, leaves: List[torch.Tensor]) -> Any:
    """Inverse of ``tree_leaves`` for a tree shaped like ``like``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(like)


def adam_init(params: Any) -> Dict:
    device = tree_leaves(params)[0].device
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "t": torch.zeros((), dtype=torch.int32, device=device)}


def weak_scalar(x: float, dtype: torch.dtype) -> float:
    """A weakly typed Python constant as JAX sees it beside a ``dtype``
    array: rounded to that dtype."""
    return float(torch.tensor(x, dtype=dtype)) if dtype.is_floating_point else x


def _float32(x: torch.Tensor) -> torch.Tensor:
    """``x`` promoted against a float32 array (bfloat16 and float16 widen)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _adam_moments(opt, grads, b1, b2):
    m = tree_map(lambda m, g: (weak_scalar(b1, m.dtype) * m
                               + weak_scalar(1 - b1, g.dtype) * g), opt["m"], grads)
    v = tree_map(lambda v, g: (weak_scalar(b2, v.dtype) * v
                               + weak_scalar(1 - b2, g.dtype) * g * g), opt["v"], grads)
    return m, v


def _bias_corrections(t: torch.Tensor, b1: float, b2: float):
    tf = t.to(torch.float32)
    return 1 - b1 ** tf, 1 - b2 ** tf


def adam_update(params: Any, grads: Any, opt: Dict, lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8, wd: float = 0.0
                ) -> Tuple[Any, Dict]:
    t = opt["t"] + 1
    m, v = _adam_moments(opt, grads, b1, b2)
    c1, c2 = _bias_corrections(t, b1, b2)

    def upd(p, m, v):
        if p.dtype not in _FLOAT:
            return p
        step = lr * (_float32(m) / c1) / (torch.sqrt(_float32(v) / c2) + eps)
        if wd:
            step = step + weak_scalar(lr * wd, p.dtype) * p
        return (p - step).to(p.dtype)

    return tree_map(upd, params, m, v), {"m": m, "v": v, "t": t}


def lamb_update(params: Any, grads: Any, opt: Dict, lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-6, wd: float = 0.01
                ) -> Tuple[Any, Dict]:
    t = opt["t"] + 1
    m, v = _adam_moments(opt, grads, b1, b2)
    c1, c2 = _bias_corrections(t, b1, b2)

    def upd(p, m, v):
        if p.dtype not in _FLOAT:
            return p
        r = ((_float32(m) / c1) / (torch.sqrt(_float32(v) / c2) + eps)
             + weak_scalar(wd, p.dtype) * p)
        pn = torch.linalg.norm(p.to(torch.float32))
        rn = torch.linalg.norm(r.to(torch.float32))
        trust = torch.where((pn > 0) & (rn > 0), pn / rn, torch.ones_like(pn))
        return (p - lr * trust * r).to(p.dtype)

    return tree_map(upd, params, m, v), {"m": m, "v": v, "t": t}


def sgd_update(params: Any, grads: Any, opt: Dict, lr: float) -> Tuple[Any, Dict]:
    return tree_map(lambda p, g: (p - lr * g).to(p.dtype), params, grads), opt


OPTIMIZERS: Dict[str, Callable] = {"adam": adam_update, "lamb": lamb_update,
                                   "sgd": sgd_update}
