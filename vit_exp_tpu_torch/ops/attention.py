"""Cosine-similarity attention (counterpart of vit_exp_tpu/ops/attention.py,
``impl="pallas"``), differentiable.

  1. null key/value pairs (learned, per head) join the keys;
  2. q and k — the null k too — are l2-normalised along the head dim;
  3. q/k are multiplied by learned per-dim scales;
  4. softmax(q kᵀ · scale) over [nulls ++ kv], weighted sum of v.

``scale=None`` is 1/√d_head, the convention production checkpoints use.
``static_max`` is the JAX switch of the same name.  True (the port's
default, its first route) is the static-max kernel K1: the logits are
bounded by the cosine structure and the nulls seed its accumulator.  False
(the JAX package's training default, attn_impl="pallas") prepends the nulls
to k/v and runs the online-softmax kernel K15.
``ring_group`` is the JAX ``impl="ring"`` (sequence parallelism): q, k
and v are this rank's token shard, the attention runs round the group
(ops/ring_attention.py, K15 with lse per chunk, whatever ``static_max``
says), and the nulls stay out of the ring: each shard merges them once by
the log-sum-exp identity, in fp32.
``xla=True`` is the JAX ``impl="xla"``, plain torch ops and the only route
that takes a ``mask`` (True = attend) or an ``attn_bias``: the nulls are
concatenated to k/v (the mask padded with True and the bias with 0 on their
columns), the logits are fp32 q·kᵀ·scale plus the bias, masked with the
fp32 minimum, an fp32 softmax, and the probabilities cast to v's dtype
before P·V.  The legacy generative stack (models/ctvit.py, maskgit.py) runs
it, as its JAX modules run impl="xla".
``quantized=True`` is the int8 serving path (the JAX ``quantized=True`` of
``cosine_attention`` and ``cosine_attention_packed``): int8 QKᵀ through
``attention_static_int8``, forward only; k is quantized at one scale over
the batch, and ``k_amax_reduce`` (ops/flash_attention.py::quantize_qk)
widens that batch to the ranks' or cards' whole batch.  It refuses a scale with
scale·1.5² > 4.8, as the JAX package does: q and k land on the int8 grid
before the multiplication by the scale, and exp amplifies the error.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from vit_exp_tpu_torch.ops import _build
from vit_exp_tpu_torch.ops.flash_attention import (attention_static_int8,
                                                   attention_static_int8_plain,
                                                   flash_attention,
                                                   flash_attention_online,
                                                   quantize_qk)
from vit_exp_tpu_torch.ops.ring_attention import merge_nulls, ring_attention


def l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalise the last axis (norm clamped below at eps), fp32 norm."""
    n = x.float().square().sum(dim=-1, keepdim=True).sqrt()
    return (x / n.clamp_min(eps).to(x.dtype)).to(x.dtype)


def logit_bound(q_scale: Optional[torch.Tensor],
                k_scale: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """B = scale·max|q_scale|·max|k_scale| as a 0-dim fp32 device tensor
    (no host read, so the forward never synchronises).  Detached: softmax is
    invariant to the shift, so B carries no gradient (the JAX package gives
    it a zero cotangent)."""
    one = torch.ones((), dtype=torch.float32)
    bq = one if q_scale is None else q_scale.detach().float().abs().amax()
    bk = one if k_scale is None else k_scale.detach().float().abs().amax()
    return (bq * bk) * scale


def alibi_slopes(heads: int) -> torch.Tensor:
    """ALiBi per-head slopes: the geometric series 2^(-8/n)… for a power-of-2
    head count, the interleaved fallback otherwise."""

    def pow2(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * start ** i for i in range(n)]

    if math.log2(heads).is_integer():
        s = pow2(heads)
    else:
        closest = 2 ** math.floor(math.log2(heads))
        s = pow2(closest) + pow2(2 * closest)[0::2][: heads - closest]
    return torch.tensor(s, dtype=torch.float32)


def alibi_bias(heads: int, n_q: int, n_kv: int) -> torch.Tensor:
    """(heads, n_q, n_kv) additive bias −|j − i|·slope_h, the queries aligned
    to the last n_q key positions; pass it as ``attn_bias`` (xla=True)."""
    i = torch.arange(n_kv - n_q, n_kv)
    j = torch.arange(n_kv)
    dist = -(j[None, :] - i[:, None]).abs().float()
    return alibi_slopes(heads)[:, None, None] * dist[None]


def xla_attention(q, k, v, scale: float, mask=None,
                  attn_bias=None) -> torch.Tensor:
    """softmax(q·kᵀ·scale + bias, masked) · v with fp32 logits and softmax;
    the probabilities in v's dtype, P·V one GEMM in v's dtype (which sums
    in fp32 and rounds once, as JAX's einsum with an fp32 result cast back
    does, without an fp32 copy of P for the backward)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if attn_bias is not None:
        logits = logits + attn_bias.float()
    if mask is not None:
        logits = logits.masked_fill(~mask.bool(),
                                    torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def cosine_attention(q, k, v, *, null_k=None, null_v=None, q_scale=None,
                     k_scale=None, scale: Optional[float] = None,
                     use_kernel: bool = True, static_max: bool = True,
                     quantized: bool = False, ring_group=None,
                     k_amax_reduce=None, mask=None, attn_bias=None,
                     xla: bool = False) -> torch.Tensor:
    """q, k, v: (b, h, n, d); null_k/null_v: (h, n_null, d); q_scale/k_scale:
    (d,); mask: broadcastable to (b, h, n_q, n_kv), True = attend; attn_bias:
    broadcastable to the logits over the real keys.  Returns (b, h, n, d).
    Only ``xla=True`` takes a mask or a bias (the JAX "pallas" and "ring"
    impls refuse them too): another route raises."""
    if xla:
        if quantized or ring_group is not None:
            raise ValueError("xla=True is the plain float route: no int8, "
                             "no ring")
        return _xla_cosine_attention(q, k, v, null_k, null_v, q_scale,
                                     k_scale, scale, mask, attn_bias)
    if mask is not None or attn_bias is not None:
        raise NotImplementedError("only xla=True takes a mask or a bias")
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if ring_group is not None and quantized:
        raise ValueError("the int8 attention does not run over a ring")
    if quantized:
        if not static_max:
            raise ValueError("quantized=True is only implemented with "
                             "static_max=True")
        return _int8_attention(q, k, v, null_k, null_v, q_scale, k_scale,
                               scale, use_kernel, k_amax_reduce)
    nk = nv = None
    if null_k is not None:
        nk = l2norm(null_k.to(k.dtype))
        if k_scale is not None:
            nk = nk * k_scale.to(nk.dtype)
        nv = null_v.to(v.dtype)
    q = l2norm(q)
    k = l2norm(k)
    if q_scale is not None:
        q = q * q_scale.to(q.dtype)
    if k_scale is not None:
        k = k * k_scale.to(k.dtype)
    if ring_group is not None:
        out, lse = ring_attention(q, k, v, group=ring_group, scale=scale,
                                  use_kernel=use_kernel, return_lse=True)
        if nk is not None:
            out, _ = merge_nulls(out, lse, q, nk, nv, scale)
        return out.to(v.dtype)
    if not static_max:
        return flash_attention_online(q, k, v, scale=scale, null_k=nk,
                                      null_v=nv, use_kernel=use_kernel)
    bound = logit_bound(q_scale, k_scale, scale).to(q.device)
    return flash_attention(q, k, v, logit_bound=bound, scale=scale,
                           null_k=nk, null_v=nv, use_kernel=use_kernel)


def _int8_attention(q, k, v, null_k, null_v, q_scale, k_scale, scale: float,
                    use_kernel: bool, k_amax_reduce=None) -> torch.Tensor:
    """The prologue of the JAX ``cosine_attention_packed`` (null k
    normalised in fp32), then the int8 attention kernel or its plain twin;
    the output in q.dtype."""
    if scale * 1.5 ** 2 > 4.8:
        raise ValueError(
            f"quantized=True requires the SDPA scale convention (scale=None "
            f"→ 1/√d); scale={scale} amplifies int8 quantization error "
            f"beyond the validated envelope")
    _build.refuse_grad("int8 attention", q, k, v, null_k, null_v, q_scale,
                       k_scale, why="the int8 path is for serving and has "
                                    "no backward")
    nk = nv = None
    if null_k is not None:
        nk = l2norm(null_k.float())
        if k_scale is not None:
            nk = nk * k_scale.float()
        nv = null_v.to(v.dtype)
    q, k = l2norm(q), l2norm(k)
    if q_scale is not None:
        q = q * q_scale.to(q.dtype)
    if k_scale is not None:
        k = k * k_scale.to(k.dtype)
    bound = logit_bound(q_scale, k_scale, scale).to(q.device)
    q8, k8, qe, qn = quantize_qk(q, k, scale, k_amax_reduce)
    fn = attention_static_int8 if use_kernel else attention_static_int8_plain
    return fn(q8, k8, v, qe, qn, nk, nv, bound).to(q.dtype)


def _xla_cosine_attention(q, k, v, null_k, null_v, q_scale, k_scale, scale,
                          mask, attn_bias) -> torch.Tensor:
    """The JAX ``cosine_attention(impl="xla")``: the null k normalised and
    scaled as a real key, concatenated in front of k/v."""
    b, h, _, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    n_null = 0 if null_k is None else null_k.shape[1]
    q, k = l2norm(q), l2norm(k)
    if q_scale is not None:
        q = q * q_scale.to(q.dtype)
    if k_scale is not None:
        k = k * k_scale.to(k.dtype)
    if n_null:
        nk = l2norm(null_k.to(k.dtype))
        if k_scale is not None:
            nk = nk * k_scale.to(nk.dtype)
        k = torch.cat([nk.expand(b, h, n_null, d), k], dim=2)
        v = torch.cat([null_v.to(v.dtype).expand(b, h, n_null, d), v], dim=2)
        if mask is not None:
            mask = torch.nn.functional.pad(mask.bool(), (n_null, 0),
                                           value=True)
        if attn_bias is not None:
            attn_bias = torch.nn.functional.pad(attn_bias, (n_null, 0))
    return xla_attention(q, k, v, scale, mask, attn_bias)


def cosine_attention_packed(q, k, v, heads: int, *, null_k=None, null_v=None,
                            q_scale=None, k_scale=None,
                            scale: Optional[float] = None,
                            quantized: bool = False, use_kernel: bool = True,
                            k_amax_reduce=None) -> torch.Tensor:
    """The serving front of the JAX ``cosine_attention_packed`` on the
    packed head layout: q/k/v (b, n, heads·d), as the projections emit them,
    → (b, n, heads·d).  ``v`` may be the combined (b, n, 2·heads·d) kv of a
    fused projection, whose v half is the tail.  Static-max semantics (K1,
    or the int8 attention with ``quantized``) over strided head views: the
    port's kernels read those views in place, so no other kernel exists
    for this layout."""
    b, n, hd = q.shape
    if hd % heads:
        raise ValueError(f"width {hd} is not a multiple of {heads} heads")
    d = hd // heads
    if v.shape[-1] != hd:
        if v.shape[-1] != 2 * hd:
            raise ValueError(f"combined kv width {v.shape[-1]} != "
                             f"2·heads·d ({2 * hd})")
        v = v[..., hd:]

    def heads_first(t):
        return t.reshape(b, t.shape[1], heads, d).transpose(1, 2)

    out = cosine_attention(
        heads_first(q), heads_first(k), heads_first(v), null_k=null_k,
        null_v=null_v, q_scale=q_scale, k_scale=k_scale, scale=scale,
        use_kernel=use_kernel, static_max=True, quantized=quantized,
        k_amax_reduce=k_amax_reduce)
    return out.transpose(1, 2).reshape(b, n, hd)
