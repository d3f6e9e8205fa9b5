"""3D patch extraction and the fused patch embedding (counterpart of
vit_exp_tpu/ops/patches.py).

- ``patchify_3d``: 'b c (t pt) (h p1) (w p2) -> b t h w (c pt p1 p2)'.
- ``fused_patch_embed``: patchify → LayerNorm(γ, β) → Linear(W, b) as one
  strided convolution plus per-patch fix-ups, never building the patch
  tensor:  [(x−μ)·inv ⊙ γ + β] @ W + b = (x @ (γ⊙W) − μ·colsum(γ⊙W))·inv
  + (β@W + b).  The strided product is ``F.conv2d`` in fp32 (the JAX
  package's ``_conv_f32`` accumulates in fp32 too); the per-patch Σx / Σx²
  statistics are kernel K4, ``patch_stats``.

Kernel K4 (``patch_stats``) replaces vit_exp_tpu/ops/patches.py::_stats_kernel
(``_patch_stats_pallas``).  It is written in CUDA C++
(csrc/patch_stats.cu) so the port builds one library with one toolchain.  It
is one memory-bound pass over the bf16 video (442 MB at batch 4, no
tensor-core work): each block reduces one row of patches, threads walk
neighbouring columns so every load is coalesced, column sums are combined
per patch in shared memory.  x² is rounded to the input dtype before it is
summed, as the TPU kernel does.  ``PatchStatsFn`` makes it differentiable
with the plain backward of the JAX custom VJP (patches.py:129-140); the
training path never runs it, since the video carries no gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vit_exp_tpu_torch.core.precision import acc_dtype
from vit_exp_tpu_torch.ops import _build


def patchify_3d(video: torch.Tensor, pt: int, p1: int, p2: int) -> torch.Tensor:
    """(b, c, T, H, W) → (b, t, h, w, c*pt*p1*p2), feature order (c, pt, p1, p2)."""
    b, c, T, H, W = video.shape
    t, h, w = T // pt, H // p1, W // p2
    x = video.reshape(b, c, t, pt, h, p1, w, p2)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, t, h, w, c * pt * p1 * p2)


def patch_stats_plain(x: torch.Tensor, p1: int, p2: int):
    """Plain version of K4.  x: (bt, cpt, H, W) → (μ, Σx²), each (bt, hs, ws)
    fp32; x² is rounded to x.dtype before the sum."""
    bt, cpt, H, W = x.shape
    hs, ws = H // p1, W // p2
    acc_t = acc_dtype(x.dtype)
    xf = x.to(acc_t)
    x2 = (xf * xf).to(x.dtype).to(acc_t)

    def psum(v):
        return v.reshape(bt, cpt, hs, p1, ws, p2).sum(dim=(1, 3, 5))

    return psum(xf) / (cpt * p1 * p2), psum(x2)


def patch_stats(x: torch.Tensor, p1: int, p2: int):
    """Per-patch mean and Σx² of x: (bt, cpt, H, W).  Kernel K4 on a CUDA
    tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return patch_stats_plain(x, p1, p2)
    _build.require_cuda("patch_stats", x)
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("patch_stats kernel takes a contiguous bf16 tensor")
    bt, cpt, H, W = x.shape
    if H % p1 or W % p2:
        raise ValueError(f"({H}, {W}) is not a multiple of ({p1}, {p2})")
    hs, ws = H // p1, W // p2
    mu = torch.empty((bt, hs, ws), device=x.device, dtype=torch.float32)
    sq = torch.empty_like(mu)
    _build.launch("vit_patch_stats_fwd", x.data_ptr(), mu.data_ptr(),
                  sq.data_ptr(), bt, cpt, H, W, p1, p2)
    patch_stats.launches += 1
    return mu, sq


patch_stats.launches = 0


class PatchStatsFn(torch.autograd.Function):
    """Differentiable patch statistics: K4 (or its plain version) forward;
    dx = up(dμ)/n + 2·x·up(dΣx²), up() broadcasting a patch value over its
    (cpt, p1, p2) window."""

    @staticmethod
    def forward(ctx, x, p1, p2, use_kernel):
        ctx.p = (p1, p2)
        ctx.save_for_backward(x)
        return (patch_stats if use_kernel else patch_stats_plain)(x, p1, p2)

    @staticmethod
    def backward(ctx, dmu, dsq):
        (x,) = ctx.saved_tensors
        p1, p2 = ctx.p
        n = x.shape[1] * p1 * p2

        def up(g):   # (bt, hs, ws) → (bt, 1, H, W)
            return g.repeat_interleave(p1, dim=1).repeat_interleave(
                p2, dim=2)[:, None]

        acc_t = acc_dtype(x.dtype)
        dx = torch.zeros(x.shape, device=x.device, dtype=acc_t)
        if dmu is not None:
            dx = dx + up(dmu.to(acc_t)) / n
        if dsq is not None:
            dx = dx + 2.0 * x.to(acc_t) * up(dsq.to(acc_t))
        return dx.to(x.dtype), None, None, None


def _conv_f32(x: torch.Tensor, kc: torch.Tensor, stride) -> torch.Tensor:
    """Strided conv with fp32 accumulation: fp32 operands holding the
    compute-dtype values, with TF32 off (cuDNN would otherwise round the
    operands to 10 mantissa bits)."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        return F.conv2d(x.float(), kc.float(), stride=stride)


def fused_patch_embed(video: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, kernel: torch.Tensor,
                      bias: torch.Tensor, pt: int, p1: int, p2: int, *,
                      eps: float = 1e-5,
                      compute_dtype: torch.dtype = torch.bfloat16,
                      use_kernel: bool = True) -> torch.Tensor:
    """patchify_3d(video) |> LN(γ, β) |> Linear(kernel, bias) without the
    patch tensor.

    video: (b, c, T, H, W); gamma/beta: (c*pt*p1*p2,) in feature order
    (c, pt, p1, p2); kernel: (c*pt*p1*p2, D) (in, out); bias: (D,).
    Returns (b, t, h, w, D) in compute_dtype.  ``use_kernel=False`` takes
    K4's plain version on any device."""
    b, c, T, H, W = video.shape
    t = T // pt
    D = kernel.shape[1]
    n = c * pt * p1 * p2

    kf = kernel.float() * gamma.float()[:, None]
    csum = kf.sum(dim=0)
    dvec = beta.float() @ kernel.float() + bias.float()
    kc = kf.reshape(c * pt, p1, p2, D).permute(3, 0, 1, 2)   # (D, cpt, p1, p2)

    x = video.reshape(b, c, t, pt, H, W)
    if c != 1:
        x = x.transpose(1, 2)
    x = x.reshape(b * t, c * pt, H, W).to(compute_dtype).contiguous()

    mu, sq = PatchStatsFn.apply(x, p1, p2, use_kernel)
    mu, sq = mu[..., None], sq[..., None]                      # (bt, h, w, 1)
    y = _conv_f32(x, kc.to(compute_dtype), (p1, p2)).permute(0, 2, 3, 1)

    var = torch.clamp(sq / n - mu * mu, min=0.0)
    inv = torch.rsqrt(var + eps)
    tokens = (y - mu * csum) * inv + dvec
    return tokens.reshape(b, t, tokens.shape[1], tokens.shape[2], D).to(
        compute_dtype)
