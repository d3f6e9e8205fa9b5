"""Fused GEGLU feed-forward, forward and backward (counterpart of
``_ff_core`` in vit_exp_tpu/ops/geglu_ff.py): LN(γ, β) → x@W1 → GEGLU → @W2,
minus the residual.

The LayerNorm statistics (μ, 1/σ) come from plain torch, as XLA computes them
in JAX; γ folds into W1 (W1' = γ⊙W1) and β contributes a constant row
d1 = β@W1.

Kernel K2 (``geglu_ff``) replaces vit_exp_tpu/ops/geglu_ff.py::_ff_kernel
(``_ff_fwd_impl``).  CUDA C++, csrc/geglu_ff.cu: per token 2·D·2I + 2·I·D
multiply-adds (522 GFLOP at 55,296 tokens, D 768, 2I 4096), so it is bound
by tensor-core throughput.  The TPU kernel keeps each block's (tokens, 2I)
intermediate in VMEM; no Hopper SM holds a useful token tile of it, so K2
is three stages, the two products on the wgmma mainloop of
csrc/gemm_wgmma.cuh (TMA, an mbarrier ring, a producer warp and two
consumer warpgroups, a persistent grid), each a kernel with its plain twin
here (composed by ``geglu_ff``; ``geglu_ff_plain`` stays
the one-pass oracle): ``geglu_ff_x`` (x̂ = bf16((x − μ)·inv)),
``geglu_ff_h`` (h = x̂@W1' + d1 for a tile of tokens × inner columns, val
and gate in one lane's registers, the GEGLU on them → act in bf16; h never
reaches device memory) and ``geglu_ff_o`` (out = act@W2).  Rounding points
follow the TPU kernel: x̂, h, gelu and act are bf16.  D and 2I multiples of
16 (rows of 16-byte pieces), any M.

Kernel K8 (``geglu_ff_bwd``) replaces vit_exp_tpu/ops/geglu_ff.py::
_ff_bwd_kernel (``_ff_bwd_impl``).  CUDA C++, csrc/geglu_ff_bwd.cu: a chain
of tensor-core GEMMs with fused epilogues on the wgmma mainloop of
csrc/gemm_wgmma.cuh, each stage a kernel with its plain twin here (composed
by ``geglu_ff_bwd`` and ``geglu_ff_bwd_plain``).  Token phase:
``geglu_bwd_y`` (y = bf16(x̂·γ + β)),
``geglu_bwd_dh`` (dact = dO@W2ᵀ, val and gate = y@W1 for a tile of tokens
× inner columns in registers, the GEGLU derivative on them → dh, act),
``geglu_bwd_dy`` (dy = dh@W1ᵀ, fp32) and ``geglu_bwd_dx`` (the LayerNorm
backward → dx, and per-block dγ/dβ partials).  Weight phase:
``wgrad_partials`` (dW1 = yᵀdh and dW2 =
actᵀdO as split-K GEMMs over token segments, planned by ``wgrad_plan``)
and ``sum_rows`` (the partials summed in a fixed order, as are the dγ/dβ
partials).  Its rounding follows the TPU backward, not the forward: y =
bf16(x̂·γ + β), h = y@W1 in fp32 with no bf16 round, gelu'(g) = Φ(g) +
g·φ(g), dh and act bf16, dy fp32.  D is read from the operands: a multiple
of 16 up to K8_MAX_D; 2I a multiple of 16; any M.
``GEGLUFeedForwardFn`` is the ``torch.autograd.Function`` that ties K2 and
K8 together; it saves what the JAX VJP saves: x, μ, inv, γ, β, W1, W2.

The int8 serving path (W8A8: per-output-channel int8 weights, per-token
int8 activations) keeps its one definition of the int8 envelope here, as
the JAX package does: ``quantize_per_channel`` and ``quant_rows`` round half
to even, clip to ±127 and divide by the scale max(amax, 1e-8)/127.
Kernel K11 (``geglu_ff_int8``) replaces vit_exp_tpu/ops/geglu_ff.py::
_ff_int8_kernel (``fused_geglu_ff_int8``).  CUDA C++, csrc/geglu_ff_int8.cu.
It does K2's 522 G multiply-adds as int8 products (int32 sums): bound by
the int8 tensor cores.  Its rounding points differ from K2's: y = x̂·γ + β
stays fp32 and is quantized per token, h = acc·s_y·s_W1 stays fp32, act =
gelu_erf(gate)·val stays fp32 and is quantized per token over its whole
I-wide row, so the second product starts only once every column of a
token's act is known; the output is rounded once.  Four stages, the two
products on the int8 form of the Hopper mainloop of csrc/gemm_wgmma.cuh
(TMA loads, wgmma m64nNk32 s8), each a kernel with its plain twin here
(composed by ``geglu_ff_int8``; ``geglu_ff_int8_plain`` stays the one-pass
oracle): ``geglu_ff_int8_y`` (y → codes y8 and scale s_y),
``geglu_ff_int8_h`` (act in fp32 through device memory, and each token's
amax per AMAX_TILE columns), ``geglu_ff_int8_q`` (s_a from the partials,
codes a8) and ``geglu_ff_int8_o`` (a8@W2 · s_a · s_W2).  The int8 operands
are index-major (8-bit wgmma has no transpose): the weights go in
transposed, W1ᵀ (2I, D) and W2ᵀ (D, I), made per call next to the per-call
quantization.  D and 2I multiples of 16;
the stages' int8 rows of a8 need I a multiple of 16, so where it is not,
``geglu_ff_int8`` zero-pads the val and gate columns of W1 and the rows of
W2 to the next one (exact: a zero column's act is 0, which moves neither
s_a nor the product).  Serving only: no backward, and it raises on inputs
that require grad.
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


def _check_bf16(name, *tensors):
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError(f"{name} kernel takes bf16 operands, got "
                         f"{[t.dtype for t in tensors]}")


# K2's stages on the card (csrc/geglu_ff.cu): x̂, then act, then out.  Each
# has its plain twin; composed, the twins give geglu_ff_plain's bits.
FF_WIDTH_STEP = 16   # D and 2I of K2, K8 and K11 are multiples of it
K11_INNER_STEP = 16  # I of K11's stages: a8's int8 rows in 16-byte pieces


def _check_ff_widths(name, D, I2):
    if D < FF_WIDTH_STEP or D % FF_WIDTH_STEP or I2 < FF_WIDTH_STEP \
            or I2 % FF_WIDTH_STEP:
        raise ValueError(f"{name} kernel takes D and 2I multiples of "
                         f"{FF_WIDTH_STEP}; got D {D}, 2I {I2}")


def _check_k11_inner(name, inner):
    if inner % K11_INNER_STEP:
        raise ValueError(f"{name} kernel takes I a multiple of "
                         f"{K11_INNER_STEP} (geglu_ff_int8 pads it); got I "
                         f"{inner}")


def _check_ln_rows(name, x2, mu, inv):
    if x2.dim() != 2 or x2.shape[0] < 1 or mu.numel() != x2.shape[0] \
            or inv.numel() != x2.shape[0]:
        raise ValueError(f"{name} kernel takes (M ≥ 1, D) rows and one μ and "
                         f"inv per row; got x {tuple(x2.shape)}, mu/inv "
                         f"{mu.numel()}/{inv.numel()}")


def _check_k2(x2, mu, inv, w1p, d1, w2):
    """Raise unless K2's three kernels take these operands."""
    _check_bf16("geglu_ff", x2, w1p, w2)
    _check_ln_rows("geglu_ff", x2, mu, inv)
    D, I2 = x2.shape[1], w1p.shape[1]
    _check_ff_widths("geglu_ff", D, I2)
    if w1p.shape[0] != D or w2.shape != (I2 // 2, D) or d1.numel() != I2:
        raise ValueError(f"geglu_ff kernel takes W1' (D, 2I), W2 (I, D) and "
                         f"d1 (2I,); got x {tuple(x2.shape)}, W1 "
                         f"{tuple(w1p.shape)}, W2 {tuple(w2.shape)}, d1 "
                         f"{tuple(d1.shape)}")


def geglu_ff_x_plain(x2, mu, inv):
    """Plain version of K2's row pass: x̂ = (x − μ)·inv in fp32, rounded to
    x2.dtype."""
    acc_t = acc_dtype(x2.dtype)
    return ((x2.to(acc_t) - mu) * inv).to(x2.dtype)


def geglu_ff_x(x2, mu, inv):
    """K2's row pass on CUDA tensors, its plain version on CPU tensors."""
    if x2.device.type == "cpu":
        return geglu_ff_x_plain(x2, mu, inv)
    _build.require_cuda("geglu_ff_x", x2, mu, inv)
    _check_bf16("geglu_ff_x", x2)
    _check_ln_rows("geglu_ff_x", x2, mu, inv)
    M, D = x2.shape
    _check_ff_widths("geglu_ff_x", D, FF_WIDTH_STEP)
    x2 = x2.contiguous()
    mu, inv = mu.float().contiguous(), inv.float().contiguous()
    xn = torch.empty_like(x2)
    _build.launch("vit_geglu_ff_x", *(t.data_ptr() for t in (x2, mu, inv, xn)),
                  M, D)
    geglu_ff_x.launches += 1
    return xn


geglu_ff_x.launches = 0


def geglu_ff_h_plain(xn, w1p, d1):
    """Plain version of K2's first product with the GEGLU: h = xn@W1' + d1
    in fp32, rounded to xn.dtype; act = bf16(gelu_erf(gate))·val in
    xn.dtype, (M, I).  w1p: (D, 2I) [val | gate]; d1: (2I,) fp32."""
    inner = w1p.shape[1] // 2
    acc_t = acc_dtype(xn.dtype)
    h = (xn.to(acc_t) @ w1p.to(acc_t) + d1.to(acc_t)).to(xn.dtype)
    val, gate = h[:, :inner], h[:, inner:].to(acc_t)
    gelu = 0.5 * gate * (1.0 + torch.erf(gate * (2.0 ** -0.5)))
    return gelu.to(val.dtype) * val


def geglu_ff_h(xn, w1p, d1):
    """K2's first product with the GEGLU in its epilogue on CUDA tensors,
    its plain version on CPU tensors."""
    if xn.device.type == "cpu":
        return geglu_ff_h_plain(xn, w1p, d1)
    _build.require_cuda("geglu_ff_h", xn, w1p, d1)
    _check_bf16("geglu_ff_h", xn, w1p)
    M, D = xn.shape
    I2 = w1p.shape[1]
    _check_ff_widths("geglu_ff_h", D, I2)
    if M < 1 or w1p.shape[0] != D or d1.numel() != I2:
        raise ValueError(f"geglu_ff_h kernel takes x̂ (M ≥ 1, D), W1' (D, 2I) "
                         f"and d1 (2I,); got x̂ {tuple(xn.shape)}, W1 "
                         f"{tuple(w1p.shape)}, d1 {tuple(d1.shape)}")
    xn, w1p, d1 = xn.contiguous(), w1p.contiguous(), d1.float().contiguous()
    act = torch.empty((M, I2 // 2), device=xn.device, dtype=xn.dtype)
    _build.launch("vit_geglu_ff_h", *(t.data_ptr() for t in (xn, w1p, d1, act)),
                  M, D, I2)
    geglu_ff_h.launches += 1
    return act


geglu_ff_h.launches = 0


def geglu_ff_o_plain(act, w2):
    """Plain version of K2's second product: act@W2 in fp32, rounded to
    act.dtype.  act: (M, I); w2: (I, D)."""
    acc_t = acc_dtype(act.dtype)
    return (act.to(acc_t) @ w2.to(acc_t)).to(act.dtype)


def geglu_ff_o(act, w2):
    """K2's second product on CUDA tensors, its plain version on CPU
    tensors."""
    if act.device.type == "cpu":
        return geglu_ff_o_plain(act, w2)
    _build.require_cuda("geglu_ff_o", act, w2)
    _check_bf16("geglu_ff_o", act, w2)
    M, inner = act.shape
    D = w2.shape[1]
    _check_ff_widths("geglu_ff_o", D, 2 * inner)
    if M < 1 or w2.shape[0] != inner:
        raise ValueError(f"geglu_ff_o kernel takes act (M ≥ 1, I) and W2 "
                         f"(I, D); got act {tuple(act.shape)}, W2 "
                         f"{tuple(w2.shape)}")
    act, w2 = act.contiguous(), w2.contiguous()
    out = torch.empty((M, D), device=act.device, dtype=act.dtype)
    _build.launch("vit_geglu_ff_o", act.data_ptr(), w2.data_ptr(),
                  out.data_ptr(), M, D, 2 * inner)
    geglu_ff_o.launches += 1
    return out


geglu_ff_o.launches = 0


def geglu_ff(x2, mu, inv, w1p, d1, w2):
    """Kernel K2 (three kernels: x̂, act, out) on CUDA tensors, the plain
    stages on CPU tensors.  Arguments as ``geglu_ff_plain``'s; on the card
    every operand is checked before the first launch."""
    if x2.device.type != "cpu":
        _check_k2(x2, mu, inv, w1p, d1, w2)
    return geglu_ff_o(geglu_ff_h(geglu_ff_x(x2, mu, inv), w1p, d1), w2)


# ---------------------------------------------------------------------------
# int8 serving path (W8A8)
# ---------------------------------------------------------------------------


def int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-8) / 127 in fp32, one IEEE division on every device (a
    CUDA tensor divided by a Python number is multiplied by its reciprocal
    instead, which can differ in the last bit)."""
    return amax.clamp_min(1e-8) / torch.full((), 127.0, device=amax.device)


def quantize_per_channel(w: torch.Tensor):
    """Symmetric per-output-channel int8: w ≈ w8 · scale[None, :].  Returns
    (w8 int8, scale fp32 (F,))."""
    wf = w.float()
    scale = int8_scale(wf.abs().amax(dim=0))
    return torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8), scale


def quant_rows(y: torch.Tensor):
    """(..., d) → (int8 codes, per-row scale (..., 1) fp32): symmetric row
    quantization, amax/127 with a 1e-8 floor, round half to even."""
    y = y.float()
    s = int8_scale(y.abs().amax(dim=-1, keepdim=True))
    return torch.clamp(torch.round(y / s), -127, 127).to(torch.int8), s


def int8_matmul(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """The int32 product a8 @ b8 of two int8 matrices, as fp32 (the int32
    value rounded once, as the kernels convert it).  Summed in fp64, where
    every partial sum is an integer below 2⁵³ and so exact."""
    return (a8.double() @ b8.double()).float()


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


# K11's stages on the card (csrc/geglu_ff_int8.cu): y8, then act with its
# partial amaxes, then a8, then out.  Each has its plain twin; composed, the
# twins give geglu_ff_int8_plain's bits.
AMAX_TILE = 64   # inner columns of one partial amax (K11h's column tile)


def _check_int8(name, *tensors):
    if any(t.dtype != torch.int8 for t in tensors):
        raise ValueError(f"{name} kernel takes int8 codes, got "
                         f"{[t.dtype for t in tensors]}")


def _check_k11(x2, mu, inv, gamma, beta, w1q, s1, w2q, s2):
    """Raise unless K11's four kernels take these operands."""
    _check_bf16("geglu_ff_int8", x2)
    _check_int8("geglu_ff_int8", w1q, w2q)
    _check_ln_rows("geglu_ff_int8", x2, mu, inv)
    D, I2 = x2.shape[1], w1q.shape[1]
    _check_ff_widths("geglu_ff_int8", D, I2)
    if (w1q.shape[0] != D or w2q.shape != (I2 // 2, D) or s1.numel() != I2
            or s2.numel() != D or gamma.numel() != D or beta.numel() != D):
        raise ValueError(f"geglu_ff_int8 kernel takes W1 (D, 2I), W2 (I, D), "
                         f"their scales and D-wide γ, β; got x "
                         f"{tuple(x2.shape)}, W1 {tuple(w1q.shape)}, W2 "
                         f"{tuple(w2q.shape)}")


def geglu_ff_int8_y_plain(x2, mu, inv, gamma, beta):
    """Plain version of K11's row pass: y = x̂·γ + β in fp32, quantized per
    token: (y8 (M, D) int8, s_y (M, 1) fp32)."""
    xn = (x2.float() - mu) * inv
    return quant_rows(xn * gamma.float() + beta.float())


def geglu_ff_int8_y(x2, mu, inv, gamma, beta):
    """K11's row pass on CUDA tensors, its plain version on CPU tensors."""
    if x2.device.type == "cpu":
        return geglu_ff_int8_y_plain(x2, mu, inv, gamma, beta)
    _build.require_cuda("geglu_ff_int8_y", x2, mu, inv, gamma, beta)
    _check_bf16("geglu_ff_int8_y", x2)
    _check_ln_rows("geglu_ff_int8_y", x2, mu, inv)
    M, D = x2.shape
    _check_ff_widths("geglu_ff_int8_y", D, FF_WIDTH_STEP)
    if gamma.numel() != D or beta.numel() != D:
        raise ValueError(f"geglu_ff_int8_y kernel takes {D} γ and β")
    x2 = x2.contiguous()
    mu, inv, gamma, beta = (t.float().contiguous() for t in (mu, inv, gamma,
                                                               beta))
    y8 = torch.empty((M, D), device=x2.device, dtype=torch.int8)
    sy = torch.empty((M, 1), device=x2.device, dtype=torch.float32)
    _build.launch("vit_geglu_int8_y", *(t.data_ptr() for t in (
        x2, mu, inv, gamma, beta, y8, sy)), M, D)
    geglu_ff_int8_y.launches += 1
    return y8, sy


geglu_ff_int8_y.launches = 0


def amax_partials(act):
    """Each row's amax over each tile of AMAX_TILE columns: (M, ceil(I /
    AMAX_TILE)) fp32, as K11h's epilogue writes it."""
    pad = -act.shape[1] % AMAX_TILE
    return torch.nn.functional.pad(act.abs(), (0, pad)).reshape(
        act.shape[0], -1, AMAX_TILE).amax(dim=-1)


def geglu_ff_int8_h_plain(y8, sy, w1t, s1):
    """Plain version of K11's first product with the GEGLU.  y8: (M, D)
    int8, sy: (M, 1); w1t: (2I, D) int8, W1ᵀ laid out [val | gate], with
    scales s1 (2I,).  h = (y8@W1)·s_y·s_W1 and act = gelu_erf(gate)·val in
    fp32: (act (M, I), its partial amaxes)."""
    inner = w1t.shape[0] // 2
    h = int8_matmul(y8, w1t.t()) * sy * s1
    val, gate = h[:, :inner], h[:, inner:]
    act = 0.5 * gate * (1.0 + torch.erf(gate * (2.0 ** -0.5))) * val
    return act, amax_partials(act)


def geglu_ff_int8_h(y8, sy, w1t, s1):
    """K11's first product with the GEGLU in its epilogue on CUDA tensors,
    its plain version on CPU tensors."""
    if y8.device.type == "cpu":
        return geglu_ff_int8_h_plain(y8, sy, w1t, s1)
    _build.require_cuda("geglu_ff_int8_h", y8, sy, w1t, s1)
    _check_int8("geglu_ff_int8_h", y8, w1t)
    M, D = y8.shape
    I2 = w1t.shape[0]
    _check_ff_widths("geglu_ff_int8_h", D, I2)
    _check_k11_inner("geglu_ff_int8_h", I2 // 2)
    if M < 1 or sy.numel() != M or w1t.shape[1] != D or s1.numel() != I2:
        raise ValueError(f"geglu_ff_int8_h kernel takes y8 (M ≥ 1, D), one "
                         f"s_y per row, W1ᵀ (2I, D) and 2I scales; got y8 "
                         f"{tuple(y8.shape)}, W1ᵀ {tuple(w1t.shape)}")
    y8, w1t = y8.contiguous(), w1t.contiguous()
    sy, s1 = sy.float().contiguous(), s1.float().contiguous()
    inner = I2 // 2
    act = torch.empty((M, inner), device=y8.device, dtype=torch.float32)
    part = torch.empty((M, -(-inner // AMAX_TILE)), device=y8.device,
                       dtype=torch.float32)
    _build.launch("vit_geglu_int8_h", *(t.data_ptr() for t in (
        y8, sy, w1t, s1, act, part)), M, D, I2)
    geglu_ff_int8_h.launches += 1
    return act, part


geglu_ff_int8_h.launches = 0


def geglu_ff_int8_q_plain(act, amax_part):
    """Plain version of K11's act quantizer: s_a from each row's partial
    amaxes (max(amax, 1e-8) / 127), codes round half to even: (a8 (M, I)
    int8, s_a (M, 1) fp32)."""
    s = int8_scale(amax_part.amax(dim=-1, keepdim=True))
    return torch.clamp(torch.round(act / s), -127, 127).to(torch.int8), s


def geglu_ff_int8_q(act, amax_part):
    """K11's act quantizer on CUDA tensors, its plain version on CPU
    tensors."""
    if act.device.type == "cpu":
        return geglu_ff_int8_q_plain(act, amax_part)
    _build.require_cuda("geglu_ff_int8_q", act, amax_part)
    M, inner = act.shape
    _check_ff_widths("geglu_ff_int8_q", FF_WIDTH_STEP, 2 * inner)
    _check_k11_inner("geglu_ff_int8_q", inner)
    if (act.dtype != torch.float32 or amax_part.dtype != torch.float32
            or M < 1 or amax_part.shape != (M, -(-inner // AMAX_TILE))):
        raise ValueError(f"geglu_ff_int8_q kernel takes fp32 act (M ≥ 1, I) "
                         f"and its (M, I / {AMAX_TILE}) fp32 partial amaxes; "
                         f"got {tuple(act.shape)} {act.dtype}, "
                         f"{tuple(amax_part.shape)} {amax_part.dtype}")
    act, amax_part = act.contiguous(), amax_part.contiguous()
    a8 = torch.empty((M, inner), device=act.device, dtype=torch.int8)
    sa = torch.empty((M, 1), device=act.device, dtype=torch.float32)
    _build.launch("vit_geglu_int8_q", *(t.data_ptr() for t in (
        act, amax_part, a8, sa)), M, 2 * inner)
    geglu_ff_int8_q.launches += 1
    return a8, sa


geglu_ff_int8_q.launches = 0


def geglu_ff_int8_o_plain(a8, sa, w2t, s2, dtype=torch.bfloat16):
    """Plain version of K11's second product: (a8@W2)·s_a·s_W2 in fp32,
    rounded once to dtype.  a8: (M, I) int8, sa: (M, 1); w2t: (D, I) int8,
    W2ᵀ, with scales s2 (D,)."""
    return (int8_matmul(a8, w2t.t()) * sa * s2).to(dtype)


def geglu_ff_int8_o(a8, sa, w2t, s2, dtype=torch.bfloat16):
    """K11's second product on CUDA tensors (bf16 out), its plain version
    on CPU tensors."""
    if a8.device.type == "cpu":
        return geglu_ff_int8_o_plain(a8, sa, w2t, s2, dtype)
    _build.require_cuda("geglu_ff_int8_o", a8, sa, w2t, s2)
    _check_int8("geglu_ff_int8_o", a8, w2t)
    M, inner = a8.shape
    D = w2t.shape[0]
    _check_ff_widths("geglu_ff_int8_o", D, 2 * inner)
    _check_k11_inner("geglu_ff_int8_o", inner)
    if (dtype != torch.bfloat16 or M < 1 or sa.numel() != M
            or w2t.shape[1] != inner or s2.numel() != D):
        raise ValueError(f"geglu_ff_int8_o kernel takes a8 (M ≥ 1, I), one "
                         f"s_a per row, W2ᵀ (D, I), D scales and writes bf16; "
                         f"got a8 {tuple(a8.shape)}, W2ᵀ {tuple(w2t.shape)}, "
                         f"{dtype}")
    a8, w2t = a8.contiguous(), w2t.contiguous()
    sa, s2 = sa.float().contiguous(), s2.float().contiguous()
    out = torch.empty((M, D), device=a8.device, dtype=torch.bfloat16)
    _build.launch("vit_geglu_int8_o", *(t.data_ptr() for t in (
        a8, sa, w2t, s2, out)), M, D, 2 * inner)
    geglu_ff_int8_o.launches += 1
    return out


geglu_ff_int8_o.launches = 0


def geglu_ff_int8(x2, mu, inv, gamma, beta, w1q, s1, w2q, s2):
    """Kernel K11 (four kernels: y8, act, a8, out) on CUDA tensors, the
    plain stages on CPU tensors.  Arguments as ``geglu_ff_int8_plain``'s;
    W1 and W2 go to the stages transposed, I zero-padded to a multiple of
    K11_INNER_STEP (``k11_weights``).  On the card every operand is checked
    before the first launch."""
    if x2.device.type != "cpu":
        _check_k11(x2, mu, inv, gamma, beta, w1q, s1, w2q, s2)
    w1t, s1, w2t = k11_weights(w1q, s1, w2q)
    y8, sy = geglu_ff_int8_y(x2, mu, inv, gamma, beta)
    a8, sa = geglu_ff_int8_q(*geglu_ff_int8_h(y8, sy, w1t, s1))
    return geglu_ff_int8_o(a8, sa, w2t, s2, x2.dtype)


def k11_weights(w1q, s1, w2q):
    """K11's weight operands from W1 (D, 2I) [val | gate], its 2I scales
    and W2 (I, D): W1ᵀ (2I', D), 2I' scales and W2ᵀ (D, I'), with I' = I
    rounded up to K11_INNER_STEP.  The transposes are written into buffers
    of that width (the one copy each), the padding as zero val and gate
    rows at scale 1 and zero W2ᵀ columns: the padded act columns are
    exactly 0, so s_a and the output keep their bits."""
    D, i2 = w1q.shape
    inner = i2 // 2
    ip = -(-inner // K11_INNER_STEP) * K11_INNER_STEP
    w1t = w1q.new_empty((2, ip, D))
    w1t[:, :inner] = w1q.t().reshape(2, inner, D)
    w1t[:, inner:] = 0
    s1p = s1.new_ones((2, ip))
    s1p[:, :inner] = s1.reshape(2, inner)
    w2t = w2q.new_empty((D, ip))
    w2t[:, :inner] = w2q.t()
    w2t[:, inner:] = 0
    return w1t.reshape(2 * ip, D), s1p.reshape(2 * ip), w2t


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


# K8's stages on the card (csrc/geglu_ff_bwd.cu).  Token phase: y, then
# dh and act, then dy, then dx with the dγ/dβ partials; weight phase: the
# split-K partials of dW1 and dW2 and their ordered sums, and those of dγ
# and dβ.  Each stage has its plain twin; composed, the twins are
# geglu_ff_bwd_plain.  The width D comes from the operands: a multiple of
# FF_WIDTH_STEP up to K8_MAX_D (dx holds a row in registers); 2I a multiple
# of FF_WIDTH_STEP.
K8_MAX_D = 2048
DX_ROWS = 64         # rows of a dx block: one dγ/dβ partial row each
PLAIN_CHUNK = 4096   # token rows per fp32 product in the plain twins
WGRAD_TILE = 128     # the plan's output tile edge
WGRAD_STEP = 64      # tokens per k step of the weight GEMM
# WGRAD_TILE² tiles a weight GEMM aims for: 4 waves of the kernel's 128 ×
# 256 tiles over 132 SMs
WGRAD_BLOCKS = 1056


def _check_k8_width(name, D):
    if D < FF_WIDTH_STEP or D % FF_WIDTH_STEP or D > K8_MAX_D:
        raise ValueError(f"{name} kernel takes a width D that is a multiple "
                         f"of {FF_WIDTH_STEP} up to {K8_MAX_D}; got D {D}")


def _check_width(name, x2, D):
    """Raise unless x2 is (M ≥ 1, D) rows with D a width K8 takes."""
    _check_k8_width(name, D)
    if x2.dim() != 2 or x2.shape[1] != D or x2.shape[0] < 1:
        raise ValueError(f"{name} kernel takes (M ≥ 1, {D}) rows, got "
                         f"{tuple(x2.shape)}")


def _check_k8(x2, mu, inv, gamma, beta, w1, w2, dout):
    """Raise unless K8's six kernels take these operands (D from W1)."""
    _check_bf16("geglu_ff_bwd", x2)
    D, I2 = w1.shape[0], w1.shape[1]
    _check_width("geglu_ff_bwd", x2, D)
    _check_ln_rows("geglu_ff_bwd", x2, mu, inv)
    if (dout.shape != x2.shape or I2 % 16 or I2 < 16
            or w2.shape != (I2 // 2, D) or gamma.numel() != D
            or beta.numel() != D):
        raise ValueError(f"geglu_ff_bwd kernel takes x and dO (M, D), W1 "
                         f"(D, 2I) with 2I a multiple of 16, W2 (I, D) and D "
                         f"γ and β; got x {tuple(x2.shape)}, dO "
                         f"{tuple(dout.shape)}, W1 {tuple(w1.shape)}, W2 "
                         f"{tuple(w2.shape)}, γ/β {gamma.numel()}/"
                         f"{beta.numel()}")


def geglu_bwd_y_plain(x2, mu, inv, gamma, beta):
    """Plain version of K8's y stage: y = bf16(x̂·γ + β) in x2.dtype."""
    acc_t = acc_dtype(x2.dtype)
    xn = (x2.to(acc_t) - mu) * inv
    return (xn * gamma.to(acc_t) + beta.to(acc_t)).to(x2.dtype)


def geglu_bwd_y(x2, mu, inv, gamma, beta):
    """K8's y stage on CUDA tensors, its plain version on CPU tensors."""
    if x2.device.type == "cpu":
        return geglu_bwd_y_plain(x2, mu, inv, gamma, beta)
    _build.require_cuda("geglu_bwd_y", x2, mu, inv, gamma, beta)
    _check_bf16("geglu_bwd_y", x2)
    D = gamma.numel()
    _check_width("geglu_bwd_y", x2, D)
    M = x2.shape[0]
    x2 = x2.contiguous()
    mu, inv, gamma, beta = (t.float().contiguous() for t in (mu, inv, gamma,
                                                               beta))
    if mu.numel() != M or inv.numel() != M or beta.numel() != D:
        raise ValueError(f"geglu_bwd_y kernel takes one μ and inv per row and "
                         f"{D} γ and β")
    y = torch.empty_like(x2)
    _build.launch("vit_geglu_bwd_y", *(t.data_ptr() for t in (
        x2, mu, inv, gamma, beta, y)), M, D)
    geglu_bwd_y.launches += 1
    return y


geglu_bwd_y.launches = 0


def geglu_bwd_dh_plain(y, dout, w1, w2):
    """Plain version of K8's dh stage.  y, dout: (M, D); w1: (D, 2I) [val |
    gate]; w2: (I, D), all in one dtype.  h = y@W1 and dact = dO@W2ᵀ in
    fp32, then the GEGLU derivative; returns dh (M, 2I) and act (M, I)
    rounded to y.dtype.  fp32 arithmetic in chunks of PLAIN_CHUNK tokens."""
    cdt, acc_t = y.dtype, acc_dtype(y.dtype)
    M, inner = y.shape[0], w1.shape[1] // 2
    w1f, w2f = w1.to(acc_t), w2.to(acc_t)
    dh = torch.empty((M, 2 * inner), device=y.device, dtype=cdt)
    act = torch.empty((M, inner), device=y.device, dtype=cdt)
    for s in range(0, M, PLAIN_CHUNK):
        sl = slice(s, s + PLAIN_CHUNK)
        h = y[sl].to(acc_t) @ w1f
        val, gate = h[:, :inner], h[:, inner:]
        cdf = 0.5 * (1.0 + torch.erf(gate * (2.0 ** -0.5)))
        gelu = gate * cdf
        dact = dout[sl].to(acc_t) @ w2f.t()
        pdf = torch.exp(-0.5 * gate * gate) * INV_SQRT_2PI
        dh[sl] = torch.cat([dact * gelu, dact * val * (cdf + gate * pdf)],
                           dim=1).to(cdt)
        act[sl] = (gelu * val).to(cdt)
    return dh, act


def geglu_bwd_dh(y, dout, w1, w2):
    """K8's dh stage on CUDA tensors, its plain version on CPU tensors."""
    if y.device.type == "cpu":
        return geglu_bwd_dh_plain(y, dout, w1, w2)
    _build.require_cuda("geglu_bwd_dh", y, dout, w1, w2)
    _check_bf16("geglu_bwd_dh", y, dout, w1, w2)
    D, I2 = w1.shape
    _check_width("geglu_bwd_dh", y, D)
    M = y.shape[0]
    if (dout.shape != y.shape or I2 % 16 or I2 < 16
            or w2.shape != (I2 // 2, D)):
        raise ValueError(f"geglu_bwd_dh kernel takes 2I a multiple of 16 and "
                         f"matching shapes; got y {tuple(y.shape)}, dout "
                         f"{tuple(dout.shape)}, W1 {tuple(w1.shape)}, W2 "
                         f"{tuple(w2.shape)}")
    y, dout, w1, w2 = (t.contiguous() for t in (y, dout, w1, w2))
    dh = torch.empty((M, I2), device=y.device, dtype=y.dtype)
    act = torch.empty((M, I2 // 2), device=y.device, dtype=y.dtype)
    _build.launch("vit_geglu_bwd_dh", *(t.data_ptr() for t in (
        y, dout, w1, w2, dh, act)), M, D, I2)
    geglu_bwd_dh.launches += 1
    return dh, act


geglu_bwd_dh.launches = 0


def geglu_bwd_dy_plain(dh, w1):
    """Plain version of K8's dy stage: dy = dh@W1ᵀ in fp32 (M, D)."""
    acc_t = acc_dtype(dh.dtype)
    w1f = w1.to(acc_t)
    dy = torch.empty((dh.shape[0], w1.shape[0]), device=dh.device,
                     dtype=acc_t)
    for s in range(0, dh.shape[0], PLAIN_CHUNK):
        dy[s:s + PLAIN_CHUNK] = dh[s:s + PLAIN_CHUNK].to(acc_t) @ w1f.t()
    return dy


def geglu_bwd_dy(dh, w1):
    """K8's dy stage on CUDA tensors, its plain version on CPU tensors."""
    if dh.device.type == "cpu":
        return geglu_bwd_dy_plain(dh, w1)
    _build.require_cuda("geglu_bwd_dy", dh, w1)
    _check_bf16("geglu_bwd_dy", dh, w1)
    D, I2 = w1.shape
    _check_k8_width("geglu_bwd_dy", D)
    M = dh.shape[0]
    if dh.dim() != 2 or dh.shape[1] != I2 or I2 % 8 or I2 < 8 or M < 1:
        raise ValueError(f"geglu_bwd_dy kernel takes dh (M ≥ 1, 2I) and W1 "
                         f"(D, 2I), 2I a multiple of 8; got dh "
                         f"{tuple(dh.shape)}, W1 {tuple(w1.shape)}")
    dh, w1 = dh.contiguous(), w1.contiguous()
    dy = torch.empty((M, D), device=dh.device, dtype=torch.float32)
    _build.launch("vit_geglu_bwd_dy", dh.data_ptr(), w1.data_ptr(),
                  dy.data_ptr(), M, D, I2)
    geglu_bwd_dy.launches += 1
    return dy


geglu_bwd_dy.launches = 0


def geglu_bwd_dx_plain(x2, mu, inv, gamma, dy):
    """Plain version of K8's dx stage: the LayerNorm backward of dy (fp32,
    (M, D)) → dx in x2.dtype, and the dγ = Σ dy·x̂ and dβ = Σ dy partial
    sums of each block of DX_ROWS rows, (ceil(M / DX_ROWS), D) fp32."""
    acc_t = acc_dtype(x2.dtype)
    M, D = x2.shape
    xn = (x2.to(acc_t) - mu) * inv
    dxn = dy * gamma.to(acc_t)
    m1 = dxn.mean(dim=-1, keepdim=True)
    m2 = (dxn * xn).mean(dim=-1, keepdim=True)
    dx = (inv * (dxn - m1 - xn * m2)).to(x2.dtype)
    pad = -(-M // DX_ROWS) * DX_ROWS - M

    def partials(t):
        return torch.nn.functional.pad(t, (0, 0, 0, pad)).reshape(
            -1, DX_ROWS, D).sum(dim=1)

    return dx, partials(dy * xn), partials(dy)


def geglu_bwd_dx(x2, mu, inv, gamma, dy):
    """K8's dx stage on CUDA tensors, its plain version on CPU tensors."""
    if x2.device.type == "cpu":
        return geglu_bwd_dx_plain(x2, mu, inv, gamma, dy)
    _build.require_cuda("geglu_bwd_dx", x2, mu, inv, gamma, dy)
    _check_bf16("geglu_bwd_dx", x2)
    D = gamma.numel()
    _check_width("geglu_bwd_dx", x2, D)
    M = x2.shape[0]
    if (dy.dtype != torch.float32 or dy.shape != x2.shape or mu.numel() != M
            or inv.numel() != M):
        raise ValueError(f"geglu_bwd_dx kernel takes fp32 dy shaped like x "
                         f"and one μ, inv per row; got x {tuple(x2.shape)}, "
                         f"dy {tuple(dy.shape)} {dy.dtype}")
    x2, dy = x2.contiguous(), dy.contiguous()
    mu, inv, gamma = (t.float().contiguous() for t in (mu, inv, gamma))
    dx = torch.empty_like(x2)
    tiles = -(-M // DX_ROWS)
    dgp = torch.empty((tiles, D), device=x2.device, dtype=torch.float32)
    dbp = torch.empty_like(dgp)
    _build.launch("vit_geglu_bwd_dx", *(t.data_ptr() for t in (
        x2, mu, inv, gamma, dy, dx, dgp, dbp)), M, D)
    geglu_bwd_dx.launches += 1
    return dx, dgp, dbp


geglu_bwd_dx.launches = 0


def wgrad_plan(M: int, P: int, Q: int):
    """Split-K plan of the weight GEMM aᵀb (a: (M, P), b: (M, Q)): (splits,
    seg).  Segment s covers tokens [s·seg, min(M, (s + 1)·seg)); seg is a
    multiple of WGRAD_STEP, every segment holds a token, and together they
    cover [0, M) once, in order.  ``splits`` makes about WGRAD_BLOCKS
    blocks of WGRAD_TILE² output tiles."""
    if M < 1:
        raise ValueError(f"wgrad_plan needs a token, got M = {M}")
    tiles = -(-P // WGRAD_TILE) * -(-Q // WGRAD_TILE)
    splits = max(1, min(-(-WGRAD_BLOCKS // tiles), -(-M // WGRAD_STEP)))
    seg = -(-M // (WGRAD_STEP * splits)) * WGRAD_STEP
    return -(-M // seg), seg


def wgrad_partials_plain(a, b, splits: int, seg: int):
    """Plain version of the weight GEMM: (splits, P, Q) fp32, partial s =
    a[seg s]ᵀ b[seg s]."""
    acc_t = acc_dtype(a.dtype)
    return torch.stack([a[s * seg:(s + 1) * seg].to(acc_t).t()
                        @ b[s * seg:(s + 1) * seg].to(acc_t)
                        for s in range(splits)])


def wgrad_partials(a, b, splits: int, seg: int):
    """The weight GEMM's split-K partials on CUDA tensors, the plain version
    on CPU tensors.  a: (M, P), b: (M, Q) bf16; P, Q and the row pitches
    multiples of 8."""
    if a.device.type == "cpu":
        return wgrad_partials_plain(a, b, splits, seg)
    _build.require_cuda("wgrad_partials", a, b)
    _check_bf16("wgrad_partials", a, b)
    M, P = a.shape
    Q = b.shape[1]
    if (b.shape[0] != M or a.stride(1) != 1 or b.stride(1) != 1
            or P % 8 or Q % 8 or a.stride(0) % 8 or b.stride(0) % 8
            or seg < WGRAD_STEP or seg % WGRAD_STEP
            or not (splits - 1) * seg < M <= splits * seg):
        raise ValueError(f"wgrad kernel takes a (M, P), b (M, Q) with "
                         f"unit-stride rows, P, Q and pitches multiples of "
                         f"8, and a split plan of segments that are "
                         f"multiples of {WGRAD_STEP} covering M; got a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, plan "
                         f"{(splits, seg)}")
    part = torch.empty((splits, P, Q), device=a.device, dtype=torch.float32)
    _build.launch("vit_wgrad", a.data_ptr(), b.data_ptr(), part.data_ptr(),
                  M, P, Q, a.stride(0), b.stride(0), splits, seg)
    wgrad_partials.launches += 1
    return part


wgrad_partials.launches = 0


def sum_rows_plain(part):
    """Plain version of the ordered sum: Σ_s part[s] in fp32."""
    return part.sum(dim=0)


def sum_rows(part):
    """Σ_s part[s], s in order (deterministic), on CUDA tensors; the plain
    version on CPU tensors."""
    if part.device.type == "cpu":
        return sum_rows_plain(part)
    _build.require_cuda("sum_rows", part)
    if part.dtype != torch.float32:
        raise ValueError("sum_rows kernel takes fp32 partials")
    part = part.contiguous()
    out = torch.empty(part.shape[1:], device=part.device, dtype=torch.float32)
    _build.launch("vit_sum_rows", part.data_ptr(), out.data_ptr(),
                  part.shape[0], out.numel())
    sum_rows.launches += 1
    return out


sum_rows.launches = 0


def _ff_bwd(stages, x2, mu, inv, gamma, beta, w1, w2, dout):
    """K8 as the chain of its stages (y, dh, dy, dx, weight partials,
    ordered sums), each given by ``stages``: dx, dW1, dW2, dγ, dβ."""
    y_fn, dh_fn, dy_fn, dx_fn, part_fn, sum_fn = stages
    cdt = x2.dtype
    dout, w1c, w2c = dout.to(cdt), w1.to(cdt), w2.to(cdt)
    y = y_fn(x2, mu, inv, gamma, beta)
    dh, act = dh_fn(y, dout, w1c, w2c)
    dx, dgp, dbp = dx_fn(x2, mu, inv, gamma, dy_fn(dh, w1c))
    dws = [sum_fn(part_fn(a, b, *wgrad_plan(a.shape[0], a.shape[1],
                                            b.shape[1])))
           for a, b in ((y, dh), (act, dout))]
    return (dx, *dws, sum_fn(dgp), sum_fn(dbp))


def geglu_ff_bwd_plain(x2, mu, inv, gamma, beta, w1, w2, dout):
    """Plain version of K8, both phases: the chain of its stages' plain
    twins.  x2, dout: (M, D); mu/inv: (M, 1) fp32; gamma/beta: (D,); w1:
    (D, 2I) [val | gate]; w2: (I, D).  Returns dx in x2.dtype and dW1, dW2,
    dγ, dβ in fp32."""
    return _ff_bwd((geglu_bwd_y_plain, geglu_bwd_dh_plain, geglu_bwd_dy_plain,
                    geglu_bwd_dx_plain, wgrad_partials_plain, sum_rows_plain),
                   x2, mu, inv, gamma, beta, w1, w2, dout)


def geglu_ff_bwd(x2, mu, inv, gamma, beta, w1, w2, dout):
    """Kernel K8 (both phases, six kernels) on CUDA tensors, the plain
    stages on CPU tensors.  Returns dx, dW1, dW2, dγ, dβ.  On the card
    every operand is checked before the first launch."""
    if x2.device.type != "cpu":
        _check_k8(x2, mu, inv, gamma, beta, w1, w2, dout)
    return _ff_bwd((geglu_bwd_y, geglu_bwd_dh, geglu_bwd_dy, geglu_bwd_dx,
                    wgrad_partials, sum_rows),
                   x2, mu, inv, gamma, beta, w1, w2, dout)


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
