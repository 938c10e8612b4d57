"""Named collective wrappers over one mesh axis's process group.

The JAX package's are ``jax.lax`` collectives inside ``shard_map``; here
each rank calls them itself (``torch.distributed``: NCCL on the cards,
gloo on the CPU). ``axis`` is the process group of one mesh axis
(``mesh.axis_group(mesh, "sp")``); None is the default group. These
wrappers exist so call sites name their intent (and so the halo/expert
layers read like the algorithms they implement).

Gradients. A rank's loss is its own term of a sum over the ranks (the
loss of the whole job is the sum of what every rank computes), and the
backward passes below are the transposes that make each rank's
gradients those of that sum, as JAX's transposes of the collectives do:

- ``all_reduce_sum``: y = Σ_r x_r on every rank; dx_r = Σ_r' dy_r'
  (``all_reduce_sum`` of the cotangents): every rank's y fed its own
  loss term. GPipe's output sum carries a gradient this way.
- ``all_gather``: y = concat_r x_r on every rank; dx_r = Σ_r' dy_r'[r's
  block] (``reduce_scatter_sum`` of the cotangents).
- ``ring_shift``: rank i's block goes to i+shift; its transpose sends the
  cotangent back, ``ring_shift(g, -shift)`` (ppermute's transpose). The
  halo ring's carries and GPipe's hops carry gradients this way.

The z-norm statistics go through ``all_reduce_sum`` too, but nothing
upstream of them requires a gradient.

A backward pass meets the other ranks' in these transposes, so every
rank must record the same collectives in the same order: a per-rank
program runs the same operations on every rank and makes its
rank-dependent choices with selects (``torch.where`` on a rank test), as
one ``shard_map`` program would, and its inputs require a gradient on
every rank or on none (``gpipe.py`` is written so).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# the single-tensor gather and reduce-scatter took new names in later
# torch releases (the old ones warn there); same arguments either way
_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def axis_size(axis=None) -> int:
    return dist.get_world_size(axis)


def axis_index(axis=None) -> int:
    """This rank's index along the axis (``jax.lax.axis_index``)."""
    return dist.get_rank(axis)


# The reductions and gathers go through the backend at every axis size,
# one included (a one-card job still runs its collectives through NCCL);
# only the ring shift, whose send and receive would be to itself, stays
# local at size 1, as ``ppermute`` with the permutation [(0, 0)] does.


def _all_reduce(x: torch.Tensor, axis) -> torch.Tensor:
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=axis)
    return out


def _all_gather(x: torch.Tensor, axis) -> torch.Tensor:
    n = axis_size(axis)
    x = x.detach().contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _GATHER(out, x, group=axis)
    return out


def _reduce_scatter(x: torch.Tensor, axis) -> torch.Tensor:
    n = axis_size(axis)
    x = x.detach().contiguous()
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter_sum: dim 0 ({x.shape[0]}) not divisible by {n}")
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _REDUCE_SCATTER(out, x, op=dist.ReduceOp.SUM, group=axis)
    return out


def _ring_shift(x: torch.Tensor, axis, shift: int) -> torch.Tensor:
    n = axis_size(axis)
    if n == 1 or shift % n == 0:
        return x.detach().clone()
    i = axis_index(axis)
    to = dist.get_global_rank(axis, (i + shift) % n) if axis is not None else (i + shift) % n
    frm = dist.get_global_rank(axis, (i - shift) % n) if axis is not None else (i - shift) % n
    x = x.detach().contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, to, axis), dist.P2POp(dist.irecv, out, frm, axis)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.axis), None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return _ring_shift(x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _ring_shift(g, ctx.axis, -ctx.shift), None, None


def all_reduce_sum(x: torch.Tensor, axis=None) -> torch.Tensor:
    return _AllReduceSum.apply(x, axis)


def all_gather(x: torch.Tensor, axis=None, *, tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` concatenated on dim 0 in rank order (``tiled``),
    or stacked on a new leading axis."""
    out = _AllGather.apply(x, axis)
    return out if tiled else out.reshape((axis_size(axis),) + tuple(x.shape))


def reduce_scatter_sum(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Σ over the ranks of ``x``, of which rank i keeps block i of dim 0."""
    return _reduce_scatter(x, axis)


def ring_shift(x: torch.Tensor, axis=None, shift: int = 1) -> torch.Tensor:
    """Rotate shards around the ring: rank i's block goes to i+shift (one
    send and one receive a rank, posted together). At axis size 1 the
    block stays where it is."""
    if axis_size(axis) == 1:
        return x
    return _RingShift.apply(x, axis, shift)


def all_to_all(x: torch.Tensor, axis, split_axis: int, concat_axis: int) -> torch.Tensor:
    """Ulysses-style resharding between node-sharded and feature-sharded
    layouts (SURVEY §2.3 P6): ``x`` split into axis-size blocks along
    ``split_axis``, block j sent to rank j, the blocks received
    concatenated along ``concat_axis`` in rank order."""
    n = axis_size(axis)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} ({x.shape[split_axis]}) not divisible by {n}")
    blocks = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    out = torch.empty_like(blocks)
    dist.all_to_all_single(out, blocks, group=axis)
    return torch.cat(list(out), dim=concat_axis)


def nodes_to_features(h_local: torch.Tensor, axis) -> torch.Tensor:
    """[n_loc, F] node-sharded → [N, F/D] feature-sharded, one all-to-all
    (the P6 reshard between a halo/ring layer, which wants whole feature
    rows per node block, and a TP dense layer, which wants whole node
    columns per feature block). F must divide by the axis size."""
    return all_to_all(h_local, axis, split_axis=1, concat_axis=0)


def features_to_nodes(h_local: torch.Tensor, axis) -> torch.Tensor:
    """Inverse of nodes_to_features: [N, F/D] → [n_loc, F]."""
    return all_to_all(h_local, axis, split_axis=0, concat_axis=1)
