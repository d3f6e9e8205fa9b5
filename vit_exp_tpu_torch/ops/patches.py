"""3D patch extraction and the fused patch embedding (counterpart of
vit_exp_tpu/ops/patches.py).

- ``patchify_3d``: 'b c (t pt) (h p1) (w p2) -> b t h w (c pt p1 p2)'.
- ``unpatchify_heads``: a segmentation head's per-token output back to
  voxels, (b, d, w, h, p_d·p_w·p_h·C) → (b, C, D, W, H).
- ``fused_patch_embed``: patchify → LayerNorm(γ, β) → Linear(W, b) without
  the patch tensor:  [(x−μ)·inv ⊙ γ + β] @ W + b = (x @ (γ⊙W) −
  μ·colsum(γ⊙W))·inv + (β@W + b).  The weight preparation (kf = γ⊙W, its
  colsum csum, dvec = β@W + b, kc = kf in the compute dtype) is plain
  torch, as the JAX package keeps it outside its kernel; the rest is one
  kernel, ``patch_embed``.

Kernel ``patch_embed`` replaces vit_exp_tpu/ops/patches.py::_stats_kernel
(K4, ``_patch_stats_pallas``) together with the strided product
``_conv_f32`` and the fix-ups of ``fused_patch_embed`` beside it.  CUDA
C++, csrc/patch_embed.cu: an implicit GEMM (tokens × D × n) on Hopper's
``wgmma`` with fp32 accumulators, kc read by TMA (multicast to a cluster
of two token tiles), each token's patch-row pieces copied straight into
the swizzled operand tile; it takes the patch statistics from the same
operand fragments on the tensor cores (x² rounded to the input dtype
before it is summed, as the TPU kernel does) and applies the LayerNorm
fix-up in its epilogue.  At batch 4 it is bound by the 340 GFLOP of the
product.  Its plain twin ``patch_embed_plain`` is the
statistics, ``F.conv2d`` with fp32 accumulation and the fp32 fix-ups,
rounded once.

``PatchEmbedFn`` makes it differentiable in kc, csum and dvec (the video
carries no gradient) with an explicit backward that never re-runs the
product: ddvec = Σ g, dcsum = −Σ μ·inv·g, and dkc the weight gradient of
the strided product for the cotangent g·inv, cast to the compute dtype
first, as JAX's ``_conv_f32_bwd`` does.
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


def unpatchify_heads(tokens: torch.Tensor, p_d: int, p_w: int,
                     p_h: int) -> torch.Tensor:
    """(b, d, w, h, p_d*p_w*p_h*C) head output → (b, C, D, W, H) voxel
    logits: the inverse of the reference's ``view(b, d, w, h, p_d, p_w, p_h,
    -1).permute(0, 7, 1, 4, 2, 5, 3, 6)``.  The head's feature axis is laid
    out as (p_d, p_w, p_h, C)."""
    b, d, w, h, f = tokens.shape
    c = f // (p_d * p_w * p_h)
    x = tokens.reshape(b, d, w, h, p_d, p_w, p_h, c)
    x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(b, c, d * p_d, w * p_w, h * p_h)


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


def _conv_f32(x: torch.Tensor, kc: torch.Tensor, stride) -> torch.Tensor:
    """Strided conv with fp32 (fp64 for fp64) accumulation: operands in the
    accumulation dtype holding the compute-dtype values, with TF32 off
    (cuDNN would otherwise round the operands to 10 mantissa bits)."""
    acc_t = acc_dtype(x.dtype)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        return F.conv2d(x.to(acc_t), kc.to(acc_t), stride=stride)


def patch_embed_plain(x: torch.Tensor, kc: torch.Tensor, csum: torch.Tensor,
                      dvec: torch.Tensor, p1: int, p2: int, eps: float):
    """Plain version of ``patch_embed``.  x: (bt, cpt, H, W); kc: (D,
    cpt·p1·p2) in x.dtype, feature order (cpt, p1, p2); csum, dvec: (D,)
    fp32.  Returns (tokens (bt, H/p1, W/p2, D) in x.dtype, μ, Σx²), the
    statistics as ``patch_stats_plain``'s, the tokens
    (y − μ·csum)·inv + dvec in fp32 with y the strided product."""
    bt, cpt, H, W = x.shape
    n = cpt * p1 * p2
    mu, sq = patch_stats_plain(x, p1, p2)
    y = _conv_f32(x, kc.reshape(-1, cpt, p1, p2), (p1, p2)).permute(0, 2, 3, 1)
    inv = _inv(mu, sq, n, eps)
    tokens = (y - mu[..., None] * csum) * inv[..., None] + dvec
    return tokens.to(x.dtype), mu, sq


def _inv(mu, sq, n: int, eps: float):
    """rsqrt(max(Σx²/n − μ², 0) + eps): the patch LayerNorm's 1/σ."""
    return torch.rsqrt(torch.clamp(sq / n - mu * mu, min=0.0) + eps)


def patch_embed_check(x: torch.Tensor, kc: torch.Tensor, p1: int, p2: int):
    """Raise unless the kernel takes these operands (before any launch)."""
    bt, cpt, H, W = x.shape
    D = kc.shape[0]
    if x.dtype != torch.bfloat16 or kc.dtype != torch.bfloat16:
        raise ValueError(f"patch_embed kernel takes bf16 x and kc; got "
                         f"{x.dtype}, {kc.dtype}")
    if kc.shape != (D, cpt * p1 * p2):
        raise ValueError(f"patch_embed: kc {tuple(kc.shape)} is not (D, "
                         f"{cpt * p1 * p2})")
    if not _build.lib().vit_patch_embed_check(bt, cpt, H, W, p1, p2, D):
        raise ValueError(
            f"patch_embed kernel does not take x {tuple(x.shape)}, p1 {p1}, "
            f"p2 {p2}, D {D}: it needs H % p1 == W % p2 == 0, an even p2, "
            f"CPT·p1·p2 % 8 == 0, D % 16 == 0 and fewer than 2^31 tokens")


def patch_embed(x: torch.Tensor, kc: torch.Tensor, csum: torch.Tensor,
                dvec: torch.Tensor, p1: int, p2: int, eps: float):
    """The fused patch embedding on CUDA tensors (one launch), its plain
    version on CPU tensors.  Arguments and results as
    ``patch_embed_plain``'s; on the card x and kc are bf16."""
    if x.device.type == "cpu":
        return patch_embed_plain(x, kc, csum, dvec, p1, p2, eps)
    _build.require_cuda("patch_embed", x, kc, csum, dvec)
    patch_embed_check(x, kc, p1, p2)
    bt, cpt, H, W = x.shape
    D = kc.shape[0]
    x, kc = x.contiguous(), kc.contiguous()
    csum, dvec = csum.float().contiguous(), dvec.float().contiguous()
    out = torch.empty((bt, H // p1, W // p2, D), device=x.device,
                      dtype=torch.bfloat16)
    mu = torch.empty((bt, H // p1, W // p2), device=x.device,
                     dtype=torch.float32)
    sq = torch.empty_like(mu)
    _build.launch("vit_patch_embed_fwd",
                  *(t.data_ptr() for t in (x, kc, csum, dvec, out, mu, sq)),
                  bt, cpt, H, W, p1, p2, D, float(eps))
    patch_embed.launches += 1
    return out, mu, sq


patch_embed.launches = 0


class PatchEmbedFn(torch.autograd.Function):
    """Differentiable patch embedding: ``patch_embed`` (or its plain
    version) forward on (x, kc, csum, dvec); backward with g = dtokens in
    the accumulation dtype: ddvec = Σ g, dcsum = −Σ (g·inv)·μ, dkc = the
    weight gradient of the strided product for g·inv cast to x.dtype (bf16
    operands, fp32 sums, a result in x.dtype).  x gets no gradient."""

    @staticmethod
    def forward(ctx, x, kc, csum, dvec, p1, p2, eps, use_kernel):
        fwd = patch_embed if use_kernel else patch_embed_plain
        tokens, mu, sq = fwd(x, kc, csum, dvec, p1, p2, eps)
        ctx.cfg = (p1, p2, eps, kc.shape)
        ctx.save_for_backward(x, mu, sq)
        return tokens

    @staticmethod
    def backward(ctx, dtokens):
        x, mu, sq = ctx.saved_tensors
        p1, p2, eps, kc_shape = ctx.cfg
        cpt = x.shape[1]
        acc_t = acc_dtype(x.dtype)
        g = dtokens.to(acc_t)
        inv = _inv(mu.to(acc_t), sq.to(acc_t), cpt * p1 * p2, eps)[..., None]
        gi = g * inv                       # the cotangent of y − μ·csum
        ddvec = g.sum(dim=(0, 1, 2))
        dcsum = -(gi * mu.to(acc_t)[..., None]).sum(dim=(0, 1, 2))
        gy = gi.permute(0, 3, 1, 2).to(x.dtype)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False, allow_tf32=False):
            dkc = torch.nn.grad.conv2d_weight(
                x, (kc_shape[0], cpt, p1, p2), gy, stride=(p1, p2))
        return (None, dkc.reshape(kc_shape).to(x.dtype), dcsum, ddvec,
                None, None, None, None)


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
    the plain version on any device."""
    b, c, T, H, W = video.shape
    t = T // pt
    D = kernel.shape[1]

    kf = kernel.float() * gamma.float()[:, None]
    csum = kf.sum(dim=0)
    dvec = beta.float() @ kernel.float() + bias.float()
    kc = kf.t().to(compute_dtype)          # (D, c·pt·p1·p2)

    x = video.reshape(b, c, t, pt, H, W)
    if c != 1:
        x = x.transpose(1, 2)
    x = x.reshape(b * t, c * pt, H, W).to(compute_dtype).contiguous()

    tokens = PatchEmbedFn.apply(x, kc, csum, dvec, p1, p2, eps, use_kernel)
    return tokens.reshape(b, t, tokens.shape[1], tokens.shape[2], D)
