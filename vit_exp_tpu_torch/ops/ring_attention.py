"""Ring attention, sequence-parallel attention over a process group
(counterpart of vit_exp_tpu/ops/ring_attention.py).

Each rank holds one shard of the tokens (q, k and v of shape (b, h,
n_local, d)).  It attends its q shard to its own kv shard, then passes the
kv pair to rank + 1 and takes rank − 1's (``parallel/collectives.py::
ring_permute``), R − 1 times in a ring of R ranks, so rank r meets the kv
shards r, r − 1, …, r − R + 1 in that order.  Each chunk is the
online-softmax kernel K15 with lse (``flash_attention_online(...,
return_lse=True)``, the JAX ``flash_attention_with_lse``), or its plain
twin on the CPU and with ``use_kernel=False``; the chunks' partial results
combine exactly by the log-sum-exp identity (``merge_lse``):

    lse = logaddexp(lse, lse_i),  out = out·exp(lse_old − lse) + out_i·exp(lse_i − lse)

in fp32.  ``merge_nulls`` adds kv that live outside the ring (the tower's
null kv, which every shard sees once) by the same identity.  The whole is
differentiable: each chunk's backward is the flash_bwd.cu pair with the lse
cotangent (δ − glse), the permute's backward sends the kv cotangents back
round the ring, and the merges are plain torch, as JAX keeps them outside
its kernels.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Tuple

import torch

from vit_exp_tpu_torch.ops.flash_attention import flash_attention_online
from vit_exp_tpu_torch.parallel.collectives import ring_permute, world


def merge_lse(out: torch.Tensor, lse: torch.Tensor, out_i: torch.Tensor,
              lse_i: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of the union of two disjoint key sets from each one's
    (out, lse); out in fp32, lse (b, h, n)."""
    new = torch.logaddexp(lse, lse_i)
    out = (out.float() * torch.exp(lse - new)[..., None]
           + out_i.float() * torch.exp(lse_i - new)[..., None])
    return out, new


def merge_nulls(out: torch.Tensor, lse: torch.Tensor, q: torch.Tensor,
                nk: torch.Tensor, nv: torch.Tensor, scale: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Add the per-head null kv (nk, nv: (h, n_null, d)) to (out, lse) of q
    (b, h, n, d) by the log-sum-exp identity, in fp32 (the JAX ring
    branch's order: the null logits, their logsumexp, then one merge)."""
    logits = torch.einsum("bhid,hjd->bhij", q.float(), nk.float()) * scale
    new = torch.logaddexp(lse, torch.logsumexp(logits, dim=-1))
    p = torch.exp(logits - new[..., None])
    out = (out.float() * torch.exp(lse - new)[..., None]
           + torch.einsum("bhij,hjd->bhid", p, nv.float()))
    return out, new


def ring_chunks(q: torch.Tensor,
                kv_shards: Iterable[Tuple[torch.Tensor, torch.Tensor]], *,
                scale: float, use_kernel: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q against each (k, v) of ``kv_shards`` in turn, one K15-with-lse
    chunk each, merged in that order: (out fp32, lse)."""
    out = lse = None
    for k, v in kv_shards:
        o_i, lse_i = flash_attention_online(q, k, v, scale=scale,
                                            use_kernel=use_kernel,
                                            return_lse=True)
        if out is None:
            out, lse = o_i.float(), lse_i
        else:
            out, lse = merge_lse(out, lse, o_i, lse_i)
    return out, lse


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group, scale: Optional[float] = None,
                   use_kernel: bool = True, return_lse: bool = False):
    """Softmax attention of the local q shard over the keys of every rank
    of ``group``: q, k, v (b, h, n_local, d), the output in q's dtype and,
    with ``return_lse``, the global lse (b, h, n_local) fp32."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])

    def shards():
        kv = (k, v)
        yield kv
        for _ in range(world(group) - 1):
            kv = ring_permute(kv, group)
            yield kv

    out, lse = ring_chunks(q, shards(), scale=scale, use_kernel=use_kernel)
    out = out.to(q.dtype)
    return (out, lse) if return_lse else out
