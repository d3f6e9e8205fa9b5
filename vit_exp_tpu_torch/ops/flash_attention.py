"""Static-max attention forward with null kv (counterpart of the serving
forward in vit_exp_tpu/ops/flash_attention.py).

Cosine attention bounds every logit: q and k rows are unit-norm times learned
per-dim scales, so q·k·scale ≤ B = scale·max|q_scale|·max|k_scale|.  With B
subtracted once there is no running max to keep:
    out = Σ exp(q·k·scale − B)·v / Σ exp(q·k·scale − B)  over [nulls ++ kv].
The probabilities are rounded to the input dtype before both sums, as the
TPU kernel's bf16 p·[v | 1] product does.

Kernel K1 (``attention_static``) replaces
vit_exp_tpu/ops/flash_attention.py::_fwd_kernel_static (``_flash_fwd_static``,
via ``_flash_core_static``).  CUDA C++, csrc/flash_static.cu.  With head dim
32 the two products per logit are cheap next to the exp and the per-logit
shared-memory traffic: at 13,824 tokens and 32 (batch · head) rows it is 6.1
G logits per layer, bound by the exp unit and by how often each logit is
touched.  One block owns 64 queries of one (batch, head); four warps each
hold 16 of them.  The block walks the keys in tiles of 64 staged in shared
memory: S = QKᵀ on tensor cores, p = bf16(exp(S·scale − B)) with the row sum
l kept in registers, O += P·V on tensor cores.  The nulls seed O and l before
the walk; O/l is written once at the end.  Ragged q and kv tails are masked,
and q/k/v/out are read and written through strides, so the (b, n, h·d)
projection output is used in place and the output lands in the (b, n, h·d)
layout the out-projection reads.  B arrives as a device pointer: the forward
never synchronises with the host.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from vit_exp_tpu_torch.ops import _build

HEAD_DIM = 32
MAX_NULL = 8


def attention_static_plain(q, k, v, nk, nv, bound, scale: float):
    """Plain version of K1.  q: (b, h, nq, d); k/v: (b, h, nkv, d); nk/nv:
    (h, n_null, d) or None; bound: 0-dim fp32 tensor.  fp32 arithmetic,
    p rounded to q.dtype; processed in query chunks to bound memory."""
    b, h, nq, d = q.shape
    nkv = k.shape[2]
    kf, vf = k.float(), v.float()
    out = torch.empty((b, nq, h, d), device=q.device, dtype=q.dtype)
    chunk = max(1, (1 << 27) // (b * h * max(nkv, 1)))
    bound = bound.float()
    for s in range(0, nq, chunk):
        qs = q[:, :, s:s + chunk].float()
        p = torch.exp(qs @ kf.transpose(-1, -2) * scale - bound)
        p = p.to(q.dtype).float()
        acc = p @ vf
        l = p.sum(dim=-1, keepdim=True)
        if nk is not None and nk.shape[1]:
            p0 = torch.exp(qs @ nk.float().transpose(-1, -2)[None] * scale
                           - bound).to(q.dtype).float()
            acc = acc + p0 @ nv.float()[None]
            l = l + p0.sum(dim=-1, keepdim=True)
        out[:, s:s + chunk] = (acc / l).to(q.dtype).transpose(1, 2)
    return out.transpose(1, 2)


def _row_strides(t: torch.Tensor, name: str):
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"attention_static kernel: {name} needs a contiguous "
                         f"head dim and 16-byte aligned rows, got strides "
                         f"{t.stride()}")
    return t.stride()[:3]


def attention_static(q, k, v, nk, nv, bound, scale: float):
    """Kernel K1 on CUDA tensors, the plain version on CPU tensors.
    Returns (b, h, nq, d), laid out in memory as (b, nq, h, d)."""
    if q.device.type == "cpu":
        return attention_static_plain(q, k, v, nk, nv, bound, scale)
    b, h, nq, d = q.shape
    nkv = k.shape[2]
    n_null = 0 if nk is None else nk.shape[1]
    if nk is None:
        nk = nv = torch.zeros((h, 1, d), device=q.device, dtype=q.dtype)
    _build.require_cuda("attention_static", q, k, v, nk, nv, bound)
    if any(t.dtype != torch.bfloat16 for t in (q, k, v, nk, nv)):
        raise ValueError("attention_static kernel takes bf16 q, k, v and nulls")
    if (d != HEAD_DIM or n_null > MAX_NULL or k.shape != v.shape
            or k.shape[:2] != (b, h) or k.shape[3] != d
            or nk.shape != nv.shape or nk.shape[::2] != (h, d)):
        raise ValueError(f"attention_static kernel takes head dim {HEAD_DIM}, "
                         f"at most {MAX_NULL} nulls and matching shapes; got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, nulls {tuple(nk.shape)}")
    nk, nv = nk.contiguous(), nv.contiguous()
    bound = bound.float().reshape(())
    out = torch.empty((b, nq, h, d), device=q.device, dtype=q.dtype)
    out_bhnd = out.transpose(1, 2)
    strides = [s for t, name in ((q, "q"), (k, "k"), (v, "v"),
                                 (out_bhnd, "out"))
               for s in _row_strides(t, name)]
    _build.launch("vit_flash_static_fwd",
                  *(t.data_ptr() for t in (q, k, v, nk, nv, bound, out)),
                  *strides,
                  b, h, nq, nkv, n_null, float(scale))
    attention_static.launches += 1
    return out_bhnd


attention_static.launches = 0


def flash_attention(q, k, v, *, logit_bound: torch.Tensor,
                    scale: Optional[float] = None,
                    null_k: Optional[torch.Tensor] = None,
                    null_v: Optional[torch.Tensor] = None,
                    use_kernel: bool = True):
    """Static-max softmax over [null_kv ++ kv] of (q kᵀ · scale), weighted
    sum of v.  q/k/v: (b, h, n, d); null_k/null_v: (h, n_null, d);
    logit_bound: 0-dim fp32 tensor bounding every logit."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    fn = attention_static if use_kernel else attention_static_plain
    nk = None if null_k is None else null_k.to(k.dtype)
    nv = None if null_v is None else null_v.to(v.dtype)
    return fn(q, k, v, nk, nv, logit_bound, scale)
