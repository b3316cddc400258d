"""The collectives of the data-parallel loss and of tensor parallelism.

The JAX package needs none of this: its train step is one SPMD program over
the GLOBAL batch, and GSPMD derives the collectives. The loss of this model
family is not a mean of per-row terms (the kurtosis of a union is not the
mean of the kurtoses), so averaging per-rank losses or per-rank gradients,
as plain DDP does, would take another step. Here every cross-batch statistic
is taken over all ranks' rows:

  * small tensors are gathered (``gather_rows``): z, mean and logvar (B x L;
    2 MB on the flagship), so that each rank runs the moments kernels on the
    whole batch, as GSPMD does around the custom call it cannot partition,
    with the bits of one device;
  * large tensors are reduced (``global_sum``): image-space partial sums
    (per-pixel sums, then centered sums), never a gathered image batch;
  * ``r_min`` / ``r_max`` are a MIN and a MAX with no gradient.

The backward of ``gather_rows`` keeps this rank's rows of the upstream
gradient, and that of ``global_sum`` passes it on: no collective in the
backward. That is exact when every consumer of a gathered or summed value is
computed alike on every rank, so that its gradient is the same everywhere;
the losses keep to that (a centered sum takes the global mean detached: the
gradient of a population variance through its own mean is zero). Each rank's
parameter gradients are then its share, and they are SUMMED over the data
axis (``sum_gradients``), not averaged.

Tensor parallelism (``tp.py``) adds the two Megatron operators: the input of
a column-sharded Dense is copied into the model group (identity forward,
summed backward), and its output is gathered along the features (backward:
this rank's columns).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group-rank order (no
    autograd). Every rank passes a tensor of the same shape."""
    n = dist.get_world_size(group)
    t = t.contiguous()
    if dim == 0:
        out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather(list(out.chunk(n)), t, group=group)
        return out
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def rank_slice(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` (a view), for a group whose
    size divides it."""
    n = dist.get_world_size(group)
    size = t.shape[dim] // n
    return t.narrow(dim, dist.get_rank(group) * size, size)


def gather_blocks_(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Fill ``t`` in place with every rank's block of it along ``dim`` (each
    rank's own block is current in its ``t``); one block-sized copy and one
    buffer of ``t``'s size are the only temporaries."""
    n = dist.get_world_size(group)
    size = t.shape[dim] // n
    mine = rank_slice(t, dim, group).contiguous()
    buf = torch.empty((n,) + tuple(mine.shape), dtype=t.dtype, device=t.device)
    dist.all_gather(list(buf.unbind(0)), mine, group=group)
    for i in range(n):
        t.narrow(dim, i * size, size).copy_(buf[i])
    return t


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(t, dim, group)

    @staticmethod
    def backward(ctx, gout):
        return rank_slice(gout, ctx.dim, ctx.group).contiguous(), None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, gout):
        return gout, None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, gout):
        gout = gout.clone()
        dist.all_reduce(gout, group=ctx.group)
        return gout, None


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of ``t`` (dim 0), in rank order; its gradient is
    this rank's rows of the upstream one."""
    return _Gather.apply(t, 0, group)


def gather_features(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's columns of ``t`` (last dim), in rank order; its gradient
    is this rank's columns of the upstream one (a column-sharded Dense's
    output)."""
    return _Gather.apply(t, t.dim() - 1, group)


def global_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum of every rank's ``t``; its gradient passes on
    unchanged."""
    return _Sum.apply(t, group)


def copy_into_group(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` itself (the same on every rank of the group); its gradient is
    the sum of the ranks' (the input of a column-sharded Dense)."""
    return _CopyIn.apply(t, group)


def global_min(t: torch.Tensor, group) -> torch.Tensor:
    """The smallest of every rank's 0-dim ``t``, without gradient."""
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MIN, group=group)
    return out


def global_max(t: torch.Tensor, group) -> torch.Tensor:
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def sum_gradients(grads: Sequence[torch.Tensor], group,
                  bucket_bytes: int = 32 << 20) -> List[torch.Tensor]:
    """Sum each gradient over the group, in place: tensors of at least
    ``bucket_bytes`` one by one, the smaller ones packed into flat buckets of
    one dtype (one collective a bucket instead of one a bias); every
    collective is started before the first is waited for."""
    grads = list(grads)
    works, buckets = [], []
    small: dict = {}
    for g in grads:
        if g.numel() * g.element_size() >= bucket_bytes:
            works.append(dist.all_reduce(g, group=group, async_op=True))
        else:
            small.setdefault(g.dtype, []).append(g)
    for members in small.values():
        bucket, size = [], 0
        for g in members + [None]:
            if g is None or (bucket and size + g.numel() * g.element_size() > bucket_bytes):
                flat = torch.cat([b.reshape(-1) for b in bucket])
                works.append(dist.all_reduce(flat, group=group, async_op=True))
                buckets.append((flat, bucket))
                bucket, size = [], 0
            if g is not None:
                bucket.append(g)
                size += g.numel() * g.element_size()
    for w in works:
        w.wait()
    for flat, members in buckets:
        offset = 0
        for g in members:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
    return grads
