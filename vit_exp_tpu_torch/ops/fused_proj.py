"""Fused attention-prologue projection (counterpart of ``_core`` in
vit_exp_tpu/ops/fused_proj.py):
q = ScaleLayerNorm_γ(x) @ Wq and kv = x @ Wkv in one packed product.

Self-attention k/v project from the PRE-LayerNorm x; only q sees the normed
x.  With γ folded into Wq (W'q = γ⊙Wq):
    LN_γ(x) @ Wq = inv · (x @ W'q − μ · colsum(W'q))
so one product t = x @ [W'q | Wkv] plus a per-row correction of the q
columns gives both.  μ and inv come from plain torch.  The colsum is taken
over the folded Wq after its cast to the compute dtype, i.e. over the
weights the product really multiplies.

Kernel K3 (``ln_qkv``) replaces vit_exp_tpu/ops/fused_proj.py::_fwd_kernel
(``_fwd_impl``).  CUDA C++, csrc/ln_qkv.cu.  A (M, 768) × (768, 768) product
at M = 55,296: tensor-core bound (65 GFLOP) with 85 MB of x read once per
column tile.  The design is a tiled tensor-core GEMM (64 × 64 output tiles,
k-slices staged through shared memory, fp32 accumulate) whose epilogue
applies the LayerNorm correction to the q columns only, so the normalised x
never reaches device memory.

``LNQKVFn`` makes it differentiable; its backward is plain torch, as the JAX
package's is (``_core_bwd``).  Training keeps the unfused projections
(``fuse_qkv=False``), so this backward only has to be right.
"""

from __future__ import annotations

import torch

from vit_exp_tpu_torch.ops import _build
from vit_exp_tpu_torch.core.precision import acc_dtype
from vit_exp_tpu_torch.ops.geglu_ff import ln_stats


def ln_qkv_plain(x2, mu, inv, wf, c, fq: int):
    """Plain version of K3.  x2: (M, K); mu/inv: (M, 1) fp32; wf: (K, F)
    = [W'q | Wkv]; c: (F,) fp32 colsums (0 on kv columns); the first fq
    columns are q.  fp32 arithmetic, output in x2.dtype."""
    acc_t = acc_dtype(x2.dtype)
    t = x2.to(wf.dtype).to(acc_t) @ wf.to(acc_t)
    q = inv * (t[:, :fq] - mu * c[:fq].to(acc_t))
    return torch.cat([q, t[:, fq:]], dim=1).to(x2.dtype)


def ln_qkv(x2, mu, inv, wf, c, fq: int):
    """Kernel K3 on CUDA tensors, the plain version on CPU tensors."""
    if x2.device.type == "cpu":
        return ln_qkv_plain(x2, mu, inv, wf, c, fq)
    _build.require_cuda("ln_qkv", x2, mu, inv, wf, c)
    M, K = x2.shape
    F = wf.shape[1]
    if x2.dtype != torch.bfloat16 or wf.dtype != torch.bfloat16:
        raise ValueError("ln_qkv kernel takes bf16 x and W")
    if (K % 32 or F % 64 or wf.shape[0] != K or c.numel() != F
            or mu.numel() != M or inv.numel() != M or not 0 <= fq <= F):
        raise ValueError(f"ln_qkv kernel takes K % 32 == 0, F % 64 == 0 and "
                         f"matching shapes; got x {tuple(x2.shape)}, W "
                         f"{tuple(wf.shape)}, c {tuple(c.shape)}, fq {fq}")
    x2, wf = x2.contiguous(), wf.contiguous()
    mu, inv, c = (t.float().contiguous() for t in (mu, inv, c))
    out = torch.empty((M, F), device=x2.device, dtype=x2.dtype)
    _build.launch("vit_ln_qkv_fwd",
                  *(t.data_ptr() for t in (x2, mu, inv, wf, c, out)), M, K, F, fq)
    ln_qkv.launches += 1
    return out


ln_qkv.launches = 0


def qkv_weights(gamma, wq, wkv, dtype):
    """[γ⊙Wq | Wkv] in dtype and the per-column constants c (colsum of the
    cast folded Wq on q columns, 0 on kv columns)."""
    acc_t = acc_dtype(dtype)
    wqf = wq.to(acc_t) * gamma.to(acc_t)[:, None]
    wf = torch.cat([wqf.to(dtype), wkv.to(dtype)], dim=1)
    c = torch.cat([wqf.to(dtype).to(acc_t).sum(dim=0),
                   torch.zeros(wkv.shape[1], device=wq.device, dtype=acc_t)])
    return wf, c


class LNQKVFn(torch.autograd.Function):
    """Differentiable fused LN + qkv projection (counterpart of the JAX
    ``_core`` custom VJP): K3 (or its plain version) forward, the plain
    backward of q = (x̂·γ)@Wq with x̂ = (x − μ)·inv and kv = x@Wkv."""

    @staticmethod
    def forward(ctx, x2, gamma, wq, wkv, eps, use_kernel):
        mu, inv = ln_stats(x2, eps)
        wf, c = qkv_weights(gamma, wq, wkv, x2.dtype)
        ctx.eps = eps
        ctx.save_for_backward(x2, gamma, wq, wkv)
        fwd = ln_qkv if use_kernel else ln_qkv_plain
        return fwd(x2, mu, inv, wf, c, wq.shape[1])

    @staticmethod
    def backward(ctx, dout):
        x2, gamma, wq, wkv = ctx.saved_tensors
        fq = wq.shape[1]
        mu, inv = ln_stats(x2, ctx.eps)
        acc_t = acc_dtype(x2.dtype)
        xf = x2.to(acc_t)
        xn = (xf - mu) * inv
        g32 = gamma.to(acc_t)
        do = dout.to(acc_t)
        do_q, do_kv = do[:, :fq], do[:, fq:]
        dwq = (xn * g32).t() @ do_q
        dwqp = do_q @ wq.to(acc_t).t()
        dgamma = (dwqp * xn).sum(dim=0)
        dxn = dwqp * g32
        m1 = dxn.mean(dim=-1, keepdim=True)
        m2 = (dxn * xn).mean(dim=-1, keepdim=True)
        dx = inv * (dxn - m1 - xn * m2) + do_kv @ wkv.to(acc_t).t()
        dwkv = xf.t() @ do_kv
        return (dx.to(x2.dtype), dgamma.to(gamma.dtype), dwq.to(wq.dtype),
                dwkv.to(wkv.dtype), None, None)


def fused_ln_qkv(x: torch.Tensor, gamma, wq, wkv, *, eps: float = 1e-5,
                 use_kernel: bool = True):
    """q = ScaleLayerNorm_γ(x) @ Wq, kv = x @ Wkv, differentiable.
    x: (..., M, D); wq: (D, Fq); wkv: (D, Fkv) (in, out).  Returns (q, kv)
    in x.dtype."""
    shape = x.shape
    out = LNQKVFn.apply(x.reshape(-1, shape[-1]), gamma, wq, wkv, eps,
                        use_kernel)
    out = out.reshape(shape[:-1] + (out.shape[-1],))
    return out[..., :wq.shape[1]], out[..., wq.shape[1]:]
