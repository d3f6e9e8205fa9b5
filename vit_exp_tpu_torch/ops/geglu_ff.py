"""Fused GEGLU feed-forward, forward and backward (counterpart of
``_ff_core`` in vit_exp_tpu/ops/geglu_ff.py): LN(γ, β) → x@W1 → GEGLU → @W2,
minus the residual.

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

Kernel K8 (``geglu_ff_bwd``) replaces vit_exp_tpu/ops/geglu_ff.py::
_ff_bwd_kernel (``_ff_bwd_impl``).  CUDA C++, csrc/geglu_ff_bwd.cu, in two
phases: ``geglu_ff_bwd_tokens`` (per 32-token tile: recompute y and h,
dact = dO@W2ᵀ, the GEGLU derivative, dy = dh@W1ᵀ in registers, the LayerNorm
backward → dx, and per-tile dγ/dβ partials; dh, act and y go to device
memory) and ``geglu_ff_bwd_weights`` (dW1 = yᵀdh and dW2 = actᵀdO as
split-K tensor-core GEMMs over tokens, partials summed in a fixed order, and
the same sum over the dγ/dβ partials).  Its rounding follows the TPU
backward, not the forward: y = bf16(x̂·γ + β), h = y@W1 in fp32 with no
bf16 round, gelu'(g) = Φ(g) + g·φ(g), dh and act bf16.
``GEGLUFeedForwardFn`` is the ``torch.autograd.Function`` that ties K2 and
K8 together; it saves what the JAX VJP saves: x, μ, inv, γ, β, W1, W2.

The int8 serving path (W8A8: per-output-channel int8 weights, per-token
int8 activations) keeps its one definition of the int8 envelope here, as
the JAX package does: ``quantize_per_channel`` and ``quant_rows`` round half
to even, clip to ±127 and divide by the scale max(amax, 1e-8)/127.
Kernel K11 (``geglu_ff_int8``) replaces vit_exp_tpu/ops/geglu_ff.py::
_ff_int8_kernel (``fused_geglu_ff_int8``).  CUDA C++, csrc/geglu_ff_int8.cu.
It does K2's 522 G multiply-adds as int8 products (int32 sums): bound by
the int8 tensor cores, and by the L2 reads of the 4.7 MB of int8 weights
that every token tile streams.  Its rounding points differ from K2's:
y = x̂·γ + β stays fp32 and is quantized per token, h = acc·s_y·s_W1
stays fp32, act = gelu_erf(gate)·val stays fp32 and is quantized per
token over its whole 2048-wide row, so the second product starts only
once a tile's act rows are complete; the output is rounded once.  Serving
only: no backward, and it raises on inputs that require grad.
"""

from __future__ import annotations

import torch

from vit_exp_tpu_torch.core.precision import acc_dtype
from vit_exp_tpu_torch.ops import _build

INV_SQRT_2PI = 0.3989422804014327


def ln_stats(x2: torch.Tensor, eps: float):
    """fp32 LayerNorm statistics of x2: (M, D) → (μ, inv), each (M, 1)."""
    x32 = x2.to(acc_dtype(x2.dtype))
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return mu, torch.rsqrt(var + eps)


def geglu_ff_plain(x2, mu, inv, w1p, d1, w2):
    """Plain version of K2.  x2: (M, D); mu/inv: (M, 1) fp32; w1p: (D, 2I)
    [val | gate] with γ folded in; d1: (2I,) fp32; w2: (I, D).  fp32
    arithmetic, rounded to x2.dtype where the kernel rounds."""
    inner = w1p.shape[1] // 2
    acc_t = acc_dtype(x2.dtype)
    xn = ((x2.to(acc_t) - mu) * inv).to(w1p.dtype).to(acc_t)
    h = (xn @ w1p.to(acc_t) + d1.to(acc_t)).to(x2.dtype)
    val, gate = h[:, :inner], h[:, inner:].to(acc_t)
    gelu = 0.5 * gate * (1.0 + torch.erf(gate * (2.0 ** -0.5)))
    act = gelu.to(val.dtype) * val
    return (act.to(acc_t) @ w2.to(acc_t)).to(x2.dtype)


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


# ---------------------------------------------------------------------------
# int8 serving path (W8A8)
# ---------------------------------------------------------------------------


def quantize_per_channel(w: torch.Tensor):
    """Symmetric per-output-channel int8: w ≈ w8 · scale[None, :].  Returns
    (w8 int8, scale fp32 (F,))."""
    wf = w.float()
    scale = wf.abs().amax(dim=0).clamp_min(1e-8) / 127.0
    return torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8), scale


def quant_rows(y: torch.Tensor):
    """(..., d) → (int8 codes, per-row scale (..., 1) fp32): symmetric row
    quantization, amax/127 with a 1e-8 floor, round half to even."""
    y = y.float()
    s = y.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.clamp(torch.round(y / s), -127, 127).to(torch.int8), s


def int8_matmul(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """The int32 product a8 @ b8 of two int8 matrices, as fp32 (the int32
    value rounded once, as the kernels convert it).  Summed in fp64, where
    every partial sum is an integer below 2⁵³ and so exact."""
    return (a8.double() @ b8.double()).float()


def k16_layout(w8: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 → (K/16, N, 16): for each 16-deep slice of the rows, each
    column's 16 codes contiguous.  The int8 kernels load their weight
    fragments (16 columns × 16 rows = 256 contiguous bytes) from this
    layout, which keeps every fragment 32-byte aligned."""
    K, N = w8.shape
    return w8.reshape(K // 16, 16, N).transpose(1, 2).contiguous()


def geglu_ff_int8_plain(x2, mu, inv, gamma, beta, w1q, s1, w2q, s2):
    """Plain version of K11.  x2: (M, D); mu/inv: (M, 1) fp32; gamma/beta:
    (D,); w1q: (D, 2I) int8 [val | gate] with scales s1 (2I,); w2q: (I, D)
    int8 with scales s2 (D,).  fp32 arithmetic with K11's rounding points;
    the output in x2.dtype."""
    inner = w1q.shape[1] // 2
    xn = (x2.float() - mu) * inv
    y = xn * gamma.float() + beta.float()
    yq, ys = quant_rows(y)
    h = int8_matmul(yq, w1q) * ys * s1
    val, gate = h[:, :inner], h[:, inner:]
    act = 0.5 * gate * (1.0 + torch.erf(gate * (2.0 ** -0.5))) * val
    aq, as_ = quant_rows(act)
    return (int8_matmul(aq, w2q) * as_ * s2).to(x2.dtype)


def geglu_ff_int8(x2, mu, inv, gamma, beta, w1q, s1, w2q, s2):
    """Kernel K11 on CUDA tensors, the plain version on CPU tensors."""
    if x2.device.type == "cpu":
        return geglu_ff_int8_plain(x2, mu, inv, gamma, beta, w1q, s1, w2q, s2)
    _build.require_cuda("geglu_ff_int8", x2, mu, inv, gamma, beta, w1q, s1,
                        w2q, s2)
    M, D = x2.shape
    I2 = w1q.shape[1]
    if (x2.dtype != torch.bfloat16 or w1q.dtype != torch.int8
            or w2q.dtype != torch.int8):
        raise ValueError("geglu_ff_int8 kernel takes bf16 x and int8 W1, W2")
    if (D != 768 or I2 % 32 or I2 > 4096 or w1q.shape[0] != D
            or w2q.shape != (I2 // 2, D) or s1.numel() != I2
            or s2.numel() != D or gamma.numel() != D or beta.numel() != D
            or mu.numel() != M or inv.numel() != M):
        raise ValueError(f"geglu_ff_int8 kernel takes D = 768, 2I a multiple "
                         f"of 32 up to 4096 and matching shapes; got x "
                         f"{tuple(x2.shape)}, W1 {tuple(w1q.shape)}, W2 "
                         f"{tuple(w2q.shape)}")
    x2 = x2.contiguous()
    mu, inv, gamma, beta, s1, s2 = (t.float().contiguous() for t in
                                    (mu, inv, gamma, beta, s1, s2))
    w1c, w2c = k16_layout(w1q), k16_layout(w2q)
    out = torch.empty_like(x2)
    _build.launch("vit_geglu_ff_int8_fwd",
                  *(t.data_ptr() for t in (x2, mu, inv, gamma, beta, w1c, s1,
                                           w2c, s2, out)), M, D, I2)
    geglu_ff_int8.launches += 1
    return out


geglu_ff_int8.launches = 0


def fused_geglu_ff_int8(x: torch.Tensor, gamma, beta, w1, w2, *,
                        eps: float = 1e-5,
                        use_kernel: bool = True) -> torch.Tensor:
    """Serving-only W8A8 ``fused_geglu_ff`` (counterpart of the JAX
    ``fused_geglu_ff_int8``): the weights are quantized per output channel
    on every call (checkpoint layout preserved), the activations per token
    inside K11.  x: (..., D); w1: (D, 2I) [val | gate]; w2: (I, D).
    Raises when autograd would record the call."""
    _build.refuse_grad("fused_geglu_ff_int8", x, gamma, beta, w1, w2,
                       why="the int8 path is for serving and has no backward")
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    mu, inv = ln_stats(x2, eps)
    w1q, s1 = quantize_per_channel(w1)
    w2q, s2 = quantize_per_channel(w2)
    fn = geglu_ff_int8 if use_kernel else geglu_ff_int8_plain
    return fn(x2, mu, inv, gamma, beta, w1q, s1, w2q, s2).reshape(shape)


def geglu_ff_bwd_tokens_plain(x2, mu, inv, gamma, beta, w1, w2, dout,
                              chunk: int = 4096):
    """Plain version of K8's token phase.  x2, dout: (M, D); mu/inv: (M, 1)
    fp32; gamma/beta: (D,); w1: (D, 2I) [val | gate]; w2: (I, D).  Returns
    dx, dh (M, 2I), act (M, I) and y (M, D) in x2.dtype, and dγ/dβ partial
    sums (one row per chunk of tokens); fp32 arithmetic in token chunks,
    rounded to x2.dtype where K8 rounds."""
    cdt, acc_t = x2.dtype, acc_dtype(x2.dtype)
    M, inner = x2.shape[0], w1.shape[1] // 2
    w1c, w2c = w1.to(cdt).to(acc_t), w2.to(cdt).to(acc_t)
    g32, b32 = gamma.to(acc_t), beta.to(acc_t)
    dx, y = torch.empty_like(x2), torch.empty_like(x2)
    dh = torch.empty((M, 2 * inner), device=x2.device, dtype=cdt)
    act = torch.empty((M, inner), device=x2.device, dtype=cdt)
    n_chunks = -(-M // chunk)
    dgp = torch.empty((n_chunks, x2.shape[1]), device=x2.device, dtype=acc_t)
    dbp = torch.empty_like(dgp)
    for i, s in enumerate(range(0, M, chunk)):
        sl = slice(s, s + chunk)
        xn = (x2[sl].to(acc_t) - mu[sl]) * inv[sl]
        y[sl] = (xn * g32 + b32).to(cdt)
        h = y[sl].to(acc_t) @ w1c
        val, gate = h[:, :inner], h[:, inner:]
        cdf = 0.5 * (1.0 + torch.erf(gate * (2.0 ** -0.5)))
        gelu = gate * cdf
        dact = dout[sl].to(cdt).to(acc_t) @ w2c.t()
        pdf = torch.exp(-0.5 * gate * gate) * INV_SQRT_2PI
        dh[sl] = torch.cat([dact * gelu, dact * val * (cdf + gate * pdf)],
                           dim=1).to(cdt)
        act[sl] = (gelu * val).to(cdt)
        dy = dh[sl].to(acc_t) @ w1c.t()
        dgp[i] = (dy * xn).sum(dim=0)
        dbp[i] = dy.sum(dim=0)
        dxn = dy * g32
        m1 = dxn.mean(dim=-1, keepdim=True)
        m2 = (dxn * xn).mean(dim=-1, keepdim=True)
        dx[sl] = (inv[sl] * (dxn - m1 - xn * m2)).to(cdt)
    return dx, dh, act, y, dgp, dbp


def geglu_ff_bwd_weights_plain(y, dh, act, dout, dgp, dbp):
    """Plain version of K8's weight phase: (yᵀdh, actᵀdO, Σ dγ partials,
    Σ dβ partials) in fp32."""
    acc_t = acc_dtype(y.dtype)
    return (y.to(acc_t).t() @ dh.to(acc_t),
            act.to(acc_t).t() @ dout.to(y.dtype).to(acc_t),
            dgp.sum(dim=0), dbp.sum(dim=0))


def geglu_ff_bwd_plain(x2, mu, inv, gamma, beta, w1, w2, dout):
    """Plain version of K8, both phases: dx in x2.dtype and dW1, dW2, dγ,
    dβ in fp32."""
    dx, dh, act, y, dgp, dbp = geglu_ff_bwd_tokens_plain(
        x2, mu, inv, gamma, beta, w1, w2, dout)
    return (dx,) + geglu_ff_bwd_weights_plain(y, dh, act, dout, dgp, dbp)


def geglu_ff_bwd_tokens(x2, mu, inv, gamma, beta, w1c, w2c, dout):
    """K8's token phase on CUDA tensors, its plain version on CPU tensors:
    (dx, dh, act, y, dγ partials, dβ partials); w1c/w2c are W1/W2 in
    x2.dtype."""
    if x2.device.type == "cpu":
        return geglu_ff_bwd_tokens_plain(x2, mu, inv, gamma, beta, w1c, w2c,
                                         dout)
    _build.require_cuda("geglu_ff_bwd_tokens", x2, mu, inv, gamma, beta, w1c,
                        w2c, dout)
    M, D = x2.shape
    I2 = w1c.shape[1]
    if any(t.dtype != torch.bfloat16 for t in (x2, w1c, w2c, dout)):
        raise ValueError("geglu_ff_bwd kernel takes bf16 x, W1, W2 and dout")
    if (D != 768 or I2 % 128 or w1c.shape[0] != D or w2c.shape != (I2 // 2, D)
            or dout.shape != x2.shape or gamma.numel() != D
            or beta.numel() != D or mu.numel() != M or inv.numel() != M):
        raise ValueError(f"geglu_ff_bwd kernel takes D = 768, 2I a multiple of "
                         f"128 and matching shapes; got x {tuple(x2.shape)}, "
                         f"W1 {tuple(w1c.shape)}, W2 {tuple(w2c.shape)}, dout "
                         f"{tuple(dout.shape)}")
    x2, dout = x2.contiguous(), dout.contiguous()
    w1c, w2c = w1c.contiguous(), w2c.contiguous()
    mu, inv, gamma, beta = (t.float().contiguous() for t in (mu, inv, gamma,
                                                               beta))
    dx = torch.empty_like(x2)
    dh = torch.empty((M, I2), device=x2.device, dtype=x2.dtype)
    act = torch.empty((M, I2 // 2), device=x2.device, dtype=x2.dtype)
    y = torch.empty_like(x2)
    tiles = -(-M // 32)
    dgp = torch.empty((tiles, D), device=x2.device, dtype=torch.float32)
    dbp = torch.empty_like(dgp)
    _build.launch("vit_geglu_ff_bwd_tokens",
                  *(t.data_ptr() for t in (x2, mu, inv, gamma, beta, w1c, w2c,
                                           dout, dx, dh, act, y, dgp, dbp)),
                  M, D, I2)
    geglu_ff_bwd_tokens.launches += 1
    return dx, dh, act, y, dgp, dbp


geglu_ff_bwd_tokens.launches = 0


def _sum_rows(part: torch.Tensor) -> torch.Tensor:
    out = torch.empty(part.shape[1:], device=part.device, dtype=torch.float32)
    _build.launch("vit_sum_rows", part.data_ptr(), out.data_ptr(),
                  part.shape[0], out.numel())
    return out


def _wgrad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """aᵀ b (a: (M, P), b: (M, Q), bf16) in fp32: split-K partials over
    token segments, summed in order."""
    M, P = a.shape
    Q = b.shape[1]
    tiles = (P // 64) * (Q // 64)
    # about 16 blocks per SM of the 132 in flight, segments a multiple of 32
    splits = max(1, min(-(-2112 // tiles), -(-M // 32)))
    seg = -(-M // (32 * splits)) * 32
    splits = -(-M // seg)
    part = torch.empty((splits, P, Q), device=a.device, dtype=torch.float32)
    _build.launch("vit_wgrad", a.data_ptr(), b.data_ptr(), part.data_ptr(),
                  M, P, Q, a.stride(0), b.stride(0), splits, seg)
    return _sum_rows(part)


def geglu_ff_bwd_weights(y, dh, act, dout, dgp, dbp):
    """K8's weight phase on CUDA tensors, its plain version on CPU tensors:
    (dW1, dW2, dγ, dβ) in fp32."""
    if y.device.type == "cpu":
        return geglu_ff_bwd_weights_plain(y, dh, act, dout, dgp, dbp)
    _build.require_cuda("geglu_ff_bwd_weights", y, dh, act, dout, dgp, dbp)
    for t in (y, dh, act, dout):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.shape[1] % 64:
            raise ValueError("geglu_ff_bwd_weights kernel takes contiguous "
                             "bf16 operands with widths a multiple of 64")
    dw1 = _wgrad(y, dh)
    dw2 = _wgrad(act, dout.contiguous())
    dg, db = _sum_rows(dgp.contiguous()), _sum_rows(dbp.contiguous())
    geglu_ff_bwd_weights.launches += 1
    return dw1, dw2, dg, db


geglu_ff_bwd_weights.launches = 0


def geglu_ff_bwd(x2, mu, inv, gamma, beta, w1, w2, dout):
    """Kernel K8 (both phases) on CUDA tensors, the plain version on CPU
    tensors.  Returns dx, dW1, dW2, dγ, dβ."""
    dout = dout.to(x2.dtype)
    dx, dh, act, y, dgp, dbp = geglu_ff_bwd_tokens(
        x2, mu, inv, gamma, beta, w1.to(x2.dtype), w2.to(x2.dtype), dout)
    dw1, dw2, dg, db = geglu_ff_bwd_weights(y, dh, act, dout, dgp, dbp)
    return dx, dw1, dw2, dg, db


class GEGLUFeedForwardFn(torch.autograd.Function):
    """Differentiable fused GEGLU FF (counterpart of the JAX ``_ff_core``
    custom VJP): K2 forward and K8 backward, or their plain versions when
    use_kernel is False or the tensors lie on the CPU."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, w1, w2, eps, use_kernel):
        mu, inv = ln_stats(x2, eps)
        acc_t = acc_dtype(x2.dtype)
        w1p = (w1.to(acc_t) * gamma.to(acc_t)[:, None]).to(x2.dtype)
        d1 = beta.to(acc_t) @ w1.to(acc_t)
        fwd = geglu_ff if use_kernel else geglu_ff_plain
        ctx.use_kernel = use_kernel
        ctx.save_for_backward(x2, mu, inv, gamma, beta, w1, w2)
        return fwd(x2, mu, inv, w1p, d1, w2.to(x2.dtype))

    @staticmethod
    def backward(ctx, g):
        x2, mu, inv, gamma, beta, w1, w2 = ctx.saved_tensors
        bwd = geglu_ff_bwd if ctx.use_kernel else geglu_ff_bwd_plain
        dx, dw1, dw2, dg, db = bwd(x2, mu, inv, gamma, beta, w1, w2, g)
        return (dx.to(x2.dtype), dg.to(gamma.dtype), db.to(beta.dtype),
                dw1.to(w1.dtype), dw2.to(w2.dtype), None, None)


def fused_geglu_ff(x: torch.Tensor, gamma, beta, w1, w2, *, eps: float = 1e-5,
                   use_kernel: bool = True) -> torch.Tensor:
    """LN(γ, β) → x@w1 → GEGLU → @w2 for x: (..., D), differentiable.

    w1: (D, 2I) laid out [val | gate]; w2: (I, D), both (in, out).  Returns
    the FF output in x.dtype; the caller adds the residual."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    return GEGLUFeedForwardFn.apply(x2, gamma, beta, w1, w2, eps,
                                    use_kernel).reshape(shape)
