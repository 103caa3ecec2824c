"""The collectives GSPMD inserts into the reference's sharded side
workloads, written out as ``torch.autograd.Function``s over one mesh
axis's ``Group`` (``compat.axis_groups``).

The reference writes its LM once over whole arrays and lets GSPMD
partition it by ``lm_param_specs``, and its SchNet psums partial node sums
under ``shard_map``. The port runs one process per rank, so each
collective that GSPMD would insert, with the transpose that JAX's autodiff
gives it, is written out here. These have no counterpart in ``repro``'s
source; they stand for what its compiler inserts:

``copy_to``      identity forward, psum backward (Megatron's ``f``: a
                 replicated activation entering a column-parallel product);
``reduce_from``  psum forward, identity backward (Megatron's ``g``: the
                 partial sums of a row-parallel product);
``psum_psum``    psum forward and backward: ``lax.psum`` under
                 ``shard_map(check_vma=False)``, whose transpose is a psum
                 again (SchNet's node sums; the step's pmean of the
                 gradients then gives the world-1 gradient);
``gather_dim``   all-gather along a dim forward, reduce-scatter backward
                 (an FSDP gather of a parameter shard over ``"data"``, a
                 gather of K/V columns over ``"model"``, of tokens over
                 ``"data"``).

At world 1 each is the identity. Every sum is ``compat.psum``'s (rank
order, from zero).
"""
from __future__ import annotations

import torch

from repro_torch.dist.compat import Group, all_gather_tiled, psum, reduce_scatter_tiled


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PsumPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.group), None


def gather_along(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (no
    autograd)."""
    if group.world == 1:
        return x
    return all_gather_tiled(x.movedim(dim, 0), group).movedim(0, dim)


def scatter_sum_along(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """The sum over ranks of ``x``, this rank's block along ``dim`` (no
    autograd)."""
    if group.world == 1:
        return x
    return reduce_scatter_tiled(x.movedim(dim, 0), group).movedim(0, dim)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather_along(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return scatter_sum_along(g, ctx.group, ctx.dim), None, None


def copy_to(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group.world == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group.world == 1 else _ReduceFrom.apply(x, group)


def psum_psum(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group.world == 1 else _PsumPsum.apply(x, group)


def gather_dim(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    return x if group.world == 1 else _GatherDim.apply(x, group, dim % x.dim())

