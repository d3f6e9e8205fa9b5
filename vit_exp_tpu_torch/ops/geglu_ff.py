"""Fused GEGLU feed-forward (counterpart of vit_exp_tpu/ops/geglu_ff.py,
forward only): LN(γ, β) → x@W1 → GEGLU → @W2, minus the residual.

The LayerNorm statistics (μ, 1/σ) come from plain torch, as XLA computes them
in JAX; γ folds into W1 (W1' = γ⊙W1) and β contributes a constant row
d1 = β@W1.

Kernel K2 (``geglu_ff``) replaces vit_exp_tpu/ops/geglu_ff.py::_ff_kernel
(``_ff_fwd_impl``).  CUDA C++, csrc/geglu_ff.cu.  Per token it does 2·768·4096
+ 2·2048·768 multiply-adds, so at 55,296 tokens it is bound by tensor-core
throughput, and by the bytes of the (tokens, 4096) intermediate if that ever
reached device memory (453 MB at batch 4).  The design keeps it on chip: one
block owns 32 tokens; it normalises them into shared memory once, then walks
the inner dimension in chunks of 64 — h = x̂@W1' for the val and gate columns
of the chunk (tensor-core mma, fp32 accumulate), + d1, rounded to bf16, GELU
(erf) times val, rounded to bf16 — and accumulates act@W2 for the chunk into
the block's 32 × 768 fp32 output tile, which stays in registers across the
whole walk.  Rounding points follow the TPU kernel: x̂, h and act are bf16.
"""

from __future__ import annotations

import torch

from vit_exp_tpu_torch.ops import _build


def ln_stats(x2: torch.Tensor, eps: float):
    """fp32 LayerNorm statistics of x2: (M, D) → (μ, inv), each (M, 1)."""
    x32 = x2.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return mu, torch.rsqrt(var + eps)


def geglu_ff_plain(x2, mu, inv, w1p, d1, w2):
    """Plain version of K2.  x2: (M, D); mu/inv: (M, 1) fp32; w1p: (D, 2I)
    [val | gate] with γ folded in; d1: (2I,) fp32; w2: (I, D).  fp32
    arithmetic, rounded to x2.dtype where the kernel rounds."""
    inner = w1p.shape[1] // 2
    xn = ((x2.float() - mu) * inv).to(w1p.dtype).float()
    h = (xn @ w1p.float() + d1.float()).to(x2.dtype)
    val, gate = h[:, :inner], h[:, inner:].float()
    gelu = 0.5 * gate * (1.0 + torch.erf(gate * (2.0 ** -0.5)))
    act = gelu.to(val.dtype) * val
    return (act.float() @ w2.float()).to(x2.dtype)


def geglu_ff(x2, mu, inv, w1p, d1, w2):
    """Kernel K2 on CUDA tensors, the plain version on CPU tensors."""
    if x2.device.type == "cpu":
        return geglu_ff_plain(x2, mu, inv, w1p, d1, w2)
    _build.require_cuda("geglu_ff", x2, mu, inv, w1p, d1, w2)
    M, D = x2.shape
    I2 = w1p.shape[1]
    if any(t.dtype != torch.bfloat16 for t in (x2, w1p, w2)):
        raise ValueError("geglu_ff kernel takes bf16 x, W1 and W2")
    if (D != 768 or I2 % 128 or w1p.shape[0] != D
            or w2.shape != (I2 // 2, D) or d1.numel() != I2
            or mu.numel() != M or inv.numel() != M):
        raise ValueError(f"geglu_ff kernel takes D = 768, 2I a multiple of 128 "
                         f"and matching shapes; got x {tuple(x2.shape)}, W1 "
                         f"{tuple(w1p.shape)}, W2 {tuple(w2.shape)}, d1 "
                         f"{tuple(d1.shape)}, mu/inv {mu.numel()}/{inv.numel()}")
    x2, w1p, w2 = x2.contiguous(), w1p.contiguous(), w2.contiguous()
    mu, inv = mu.float().contiguous(), inv.float().contiguous()
    d1 = d1.float().contiguous()
    out = torch.empty_like(x2)
    _build.launch("vit_geglu_ff_fwd",
                  *(t.data_ptr() for t in (x2, mu, inv, w1p, d1, w2, out)),
                  M, D, I2)
    geglu_ff.launches += 1
    return out


geglu_ff.launches = 0


def fused_geglu_ff(x: torch.Tensor, gamma, beta, w1, w2, *, eps: float = 1e-5,
                   use_kernel: bool = True) -> torch.Tensor:
    """LN(γ, β) → x@w1 → GEGLU → @w2 for x: (..., D).

    w1: (D, 2I) laid out [val | gate]; w2: (I, D), both (in, out).  Returns
    the FF output in x.dtype; the caller adds the residual."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    mu, inv = ln_stats(x2, eps)
    w1p = (w1.float() * gamma.float()[:, None]).to(x2.dtype)
    d1 = beta.float() @ w1.float()
    fn = geglu_ff if use_kernel else geglu_ff_plain
    return fn(x2, mu, inv, w1p, d1, w2.to(x2.dtype)).reshape(shape)
