"""The collectives of data, sequence, parameter and tensor parallelism,
written out (the JAX package leaves them to GSPMD; the reference has a
differentiable NCCL all-gather, CT_CLIP/ct_clip/distributed.py).

The gradient rule.  JAX differentiates one global scalar and GSPMD inserts
the transposes of its collectives.  The port gets the same gradient so:

1. every rank computes the whole global loss, from gathered (or summed)
   tensors, so every rank holds the same loss;
2. the backward of a gather is a reduce-scatter with SUM, and of a sum
   over ranks an all-reduce with SUM: each rank's rows receive the
   cotangents of every rank's copy of the loss, W times the cotangent of
   one copy in a group of W;
3. every parameter's gradient is then averaged over the group
   (``average_gradients``).

Through its own rows a parameter thus gets (1/W)·W·∂L/∂rows, and through
what every rank computes alike (the temperature, a text tower on
replicated inputs) (1/W)·W copies of ∂L/∂θ: the gradient of the one
global scalar, as in JAX.  A term that is a mean over samples needs no
collective: each rank takes the mean over its own rows and the average of
the gradients is the gradient of the global mean (equal rows per rank).
The reference's AllGather returns only the local slice in its backward,
which suits a loss that each rank computes on its own rows and averages;
under rule 3 it would give the gathered path 1/W of its gradient and the
rest not, so the port does not use it.

Tensor parallelism (the model group, core/mesh.py) has two conjugate
functions: ``copy_to_group`` (identity forward, a sum of the cotangents
over the group backward) before a sharded product's input, and
``reduce_from_group`` (a sum of the ranks' partial outputs forward,
identity backward) after it.  Both sum in fp32 and round once.  Parameter
sharding (the fsdp group) gathers a flat shard into the full parameter
with ``gather_shard``, whose backward reduce-scatters the gradient.

With no group (None) every function here is the identity, or a no-op.
The NCCL group takes the fused all-gather and reduce-scatter; gloo, the
CPU backend, has no reduce-scatter, so there a gather's backward is an
all-reduce of the whole cotangent and a slice.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Sequence

import torch
import torch.distributed as dist


def world(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' x stacked along dim 0 in rank order (not differentiable;
    every rank's x has the same shape)."""
    x = x.contiguous()
    if _nccl(group):
        out = x.new_empty((world(group) * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    parts = [torch.empty_like(x) for _ in range(world(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def _sum_scatter(g: torch.Tensor, group) -> torch.Tensor:
    """This rank's rows of the sum over ranks of g (W·b rows)."""
    g = g.contiguous()
    b = g.shape[0] // world(group)
    if _nccl(group):
        out = g.new_empty((b, *g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, group=group)
        return out
    g = g.clone()
    dist.all_reduce(g, group=group)
    r = rank(group)
    return g[r * b:(r + 1) * b]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum_scatter(g, ctx.group), None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Differentiable all-gather of equal shards along ``dim`` in rank
    order; its backward is a reduce-scatter with SUM (rule 2)."""
    if group is None:
        return x
    x = x.movedim(dim, 0)
    return _AllGather.apply(x, group).movedim(0, dim)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over ranks; its backward is the same sum of the
    cotangents (rule 2)."""
    return x if group is None else _AllReduceSum.apply(x, group)


def _ring_peers(group):
    """(global rank of rank + 1, global rank of rank − 1) in the group."""
    w, r = world(group), rank(group)
    return (dist.get_global_rank(group, (r + 1) % w),
            dist.get_global_rank(group, (r - 1) % w))


def _shift(tensors: Sequence[torch.Tensor], group, forward: bool):
    """Send each tensor to the next rank and receive the previous rank's
    (``forward``), or the other way round."""
    nxt, prv = _ring_peers(group)
    to, frm = (nxt, prv) if forward else (prv, nxt)
    tensors = [t.contiguous() for t in tensors]
    out = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, out):
        ops.append(dist.P2POp(dist.isend, t, to, group))
        ops.append(dist.P2POp(dist.irecv, o, frm, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(_shift(tensors, group, forward=True))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_shift(grads, ctx.group, forward=False))


def ring_permute(tensors: Sequence[torch.Tensor], group):
    """Each rank's tensors go to rank + 1 and it receives rank − 1's
    (``jax.lax.ppermute`` with perm i → i + 1); the backward sends the
    cotangents the other way.  Returns a tuple."""
    if world(group) == 1:
        return tuple(tensors)
    return _RingPermute.apply(group, *tensors)


def average_gradients(params: Iterable[torch.nn.Parameter], group,
                      n: Optional[int] = None) -> None:
    """Average every parameter's ``.grad`` over the group (rule 3): one
    all-reduce of a flat buffer per dtype, divided by ``n`` (the group's
    size by default; parallel/sharding.py passes the batch group's, whose
    fsdp ranks' sums the reduce-scatter already took).  Every parameter
    must have a gradient (the optimizer fills the missing ones with zeros
    first)."""
    n = world(group) if n is None else n
    if group is None:
        if n != 1:
            for p in params:
                p.grad /= n
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat /= n
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def mean_over_ranks(metrics: Dict[str, torch.Tensor],
                    group) -> Dict[str, torch.Tensor]:
    """0-dim metric tensors averaged over the group, in one all-reduce (no
    host read).  A value that every rank holds alike stays as it is (up to
    the rounding of W·x / W); a per-rank mean becomes the global mean."""
    if group is None or not metrics:
        return metrics
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(flat, group=group)
    flat /= world(group)
    return {k: flat[i] for i, k in enumerate(keys)}


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over ranks (in place; not differentiable)."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def gather_objects(obj, group) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    if group is None:
        return [obj]
    out = [None] * world(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def _sum32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ranks of x, taken in fp32 and rounded once to x's
    dtype (a new tensor)."""
    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum32(g, ctx.group), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; backward, the cotangents summed over the group
    (the input of a product sharded over the model group: each rank's
    cotangent holds its slice's part)."""
    return x if group is None else _CopyToGroup.apply(x, group)


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' partial outputs summed over the group in fp32, rounded
    once to x's dtype; backward, the identity (every rank holds the whole
    cotangent)."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def gather_dim(x: torch.Tensor, group, dim: int, sizes: Sequence[int]
               ) -> torch.Tensor:
    """The ranks' x joined along ``dim`` in rank order, rank r's holding
    ``sizes[r]`` entries there (not differentiable; uneven sizes are padded
    for the gather and cut after it)."""
    if group is None:
        return x
    x = x.movedim(dim, 0)
    top = max(sizes)
    if x.shape[0] < top:
        x = torch.cat([x, x.new_zeros((top - x.shape[0], *x.shape[1:]))])
    parts = gather_rows(x, group).split(top)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)]).movedim(0, dim)


class _GatherShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, group, shape):
        ctx.group = group
        numel = math.prod(shape)
        ctx.numel = numel
        return gather_rows(shard, group)[:numel].view(shape)

    @staticmethod
    def backward(ctx, g):
        flat = g.new_zeros(world(ctx.group) * (-(-ctx.numel
                                                   // world(ctx.group))))
        flat[:ctx.numel] = g.reshape(-1)
        return _sum_scatter(flat, ctx.group), None, None


def gather_shard(shard: torch.Tensor, group, shape) -> torch.Tensor:
    """The full parameter of ``shape`` from the ranks' flat shards (each
    ceil(numel / W) long, the last padded); backward, the gradient summed
    over the ranks and cut to this rank's shard (a reduce-scatter)."""
    return _GatherShard.apply(shard, group, tuple(shape))
