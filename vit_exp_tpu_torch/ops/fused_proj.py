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
at M = 55,296: tensor-core bound (65 GFLOP).  One kernel on the Hopper
mainloop of csrc/gemm_wgmma.cuh (TMA loads into an mbarrier ring, wgmma with
fp32 accumulators in registers, 128 × 256 output tiles, a persistent grid)
whose epilogue applies the LayerNorm correction to the q columns only, on
the accumulators, and stores by TMA, so the normalised x never reaches
device memory.

``LNQKVFn`` makes it differentiable; its backward is plain torch, as the JAX
package's is (``_core_bwd``).  Training keeps the unfused projections
(``fuse_qkv=False``), so this backward only has to be right.

The int8 serving path (W8A8, no backward; raises on inputs that require
grad) has two kernels here, CUDA C++ in csrc/ln_qkv_int8.cu:
- ``ln_qkv_int8`` replaces vit_exp_tpu/ops/fused_proj.py::_fwd_int8_kernel
  (K12, ``fused_ln_qkv_int8``) and ::_fwd_int8_kernel_3out (K13,
  ``fused_ln_qkv3_int8``): the two differ only in how many outputs Mosaic
  could write, so the port has one route with three output pointers (no
  kv split is ever copied).  It quantizes the CENTRED input x − μ per token
  (the int8 step then follows the centred std, not |x|), multiplies by
  [γ⊙Wq | Wkv] quantized per output channel (γ folded in before the
  quantization), and writes q = inv·deq and k/v = deq + μ·colsum(Wkv),
  the colsums those of the dequantized weights.  Two stages, each a kernel
  with its plain twin: ``ln_qkv_int8_x`` (the row pass: x8 and s_x) and
  ``ln_qkv_int8_mm`` (x8·W on the int8 wgmma form of gemm_wgmma.cuh, the
  dequantization in the epilogue; W goes in transposed, as Wᵀ: 8-bit wgmma
  reads only index-major operands).  Composed,
  the twins give ``ln_qkv_int8_plain``'s bits.
- ``proj_int8`` replaces ::_proj_int8_kernel (K14, ``int8_proj``), the
  bias-free W8A8 out-projection: per-token activation scales times
  per-channel weight scales.  One kernel: a block owns 128 token rows,
  quantizes them once into shared memory, and streams Wᵀ (transposed per
  call, as for K12/K13) through a cp.async ring into int8 mma.sync
  products (m16n8k32, int32 accumulators in registers) whose epilogue
  dequantizes in the twin's order; its output equals the twin's bits.
At M = 55,296 both are bound by the bytes of x and of the outputs (171 MB
and 113 MB), not by their 65 and 22 G int8 operations.
"""

from __future__ import annotations

import torch

from vit_exp_tpu_torch.ops import _build
from vit_exp_tpu_torch.core.precision import acc_dtype
from vit_exp_tpu_torch.ops.geglu_ff import (int8_matmul, ln_stats, quant_rows,
                                            quantize_per_channel)

# K3's, K12/K13's and K14's widths K and F are multiples of it: rows of
# whole 16-byte pieces (16 int8 codes, two of 8 bf16); the kernels mask the
# tails of their tiles
PROJ_WIDTH_STEP = 16


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
    step = PROJ_WIDTH_STEP
    if (M < 1 or K < step or K % step or F < step or F % step
            or wf.shape[0] != K or c.numel() != F or mu.numel() != M
            or inv.numel() != M or not 0 <= fq <= F):
        raise ValueError(f"ln_qkv kernel takes M ≥ 1, K % {step} == 0, F % "
                         f"{step} == 0 and matching shapes; got x "
                         f"{tuple(x2.shape)}, W {tuple(wf.shape)}, c "
                         f"{tuple(c.shape)}, fq {fq}")
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


# ---------------------------------------------------------------------------
# int8 serving path (W8A8)
# ---------------------------------------------------------------------------

_NO_GRAD = "the int8 path is for serving and has no backward"


def int8_qkv_weights(gamma, wq, wkv):
    """[γ⊙Wq | Wkv] in fp32, quantized per output channel: (w8 (K, F) int8,
    scales (F,), c (F,)) with c the column sums of the dequantized weights
    on the kv columns and 0 on the q columns."""
    wqf = wq.float() * gamma.float()[:, None]
    w8, sc = quantize_per_channel(torch.cat([wqf, wkv.float()], dim=1))
    cols = w8.float().sum(dim=0) * sc
    c = torch.cat([torch.zeros_like(cols[:wq.shape[1]]), cols[wq.shape[1]:]])
    return w8, sc, c


def ln_qkv_int8_plain(x2, mu, inv, w8, sc, c, fq: int, fk: int):
    """Plain version of K12/K13.  x2: (M, K); mu/inv: (M, 1) fp32; w8: (K, F)
    int8 with scales sc (F,); c: (F,) fp32.  Returns q (M, fq), k (M, fk),
    v (M, F − fq − fk) in x2.dtype; fp32 arithmetic."""
    x8, sr = quant_rows(x2.float() - mu)
    deq = int8_matmul(x8, w8) * sr * sc
    q = inv * deq[:, :fq]
    kv = deq[:, fq:] + mu * c[fq:]
    return (q.to(x2.dtype), kv[:, :fk].to(x2.dtype), kv[:, fk:].to(x2.dtype))


def _check_w8a8(name, x2, w8, sc):
    M, K = x2.shape
    F = w8.shape[1]
    step = PROJ_WIDTH_STEP
    if x2.dtype != torch.bfloat16 or w8.dtype != torch.int8:
        raise ValueError(f"{name} kernel takes bf16 x and int8 W")
    if (K < step or K % step or K > 2048 or F < step or F % step
            or w8.shape[0] != K or sc.numel() != F):
        raise ValueError(f"{name} kernel takes K a multiple of {step} up to "
                         f"2048, F a multiple of {step} and matching shapes; "
                         f"got x {tuple(x2.shape)}, W {tuple(w8.shape)}")
    return M, K, F


def _check_k13(x2, mu, inv, w8, sc, c, fq, fk):
    """Raise unless K12/K13's two kernels take these operands."""
    M, K, F = _check_w8a8("ln_qkv_int8", x2, w8, sc)
    if (M < 1 or c.numel() != F or mu.numel() != M
            or inv.numel() != M or not (0 < fq and 0 < fk and fq + fk < F)):
        raise ValueError(f"ln_qkv_int8 kernel: bad x {tuple(x2.shape)}, c "
                         f"{tuple(c.shape)}, mu/inv {mu.numel()}/"
                         f"{inv.numel()}, fq {fq}, fk {fk}")


# K12/K13's stages on the card (csrc/ln_qkv_int8.cu): x8, then the product
# with the dequantization in its epilogue.  Each has its plain twin;
# composed, the twins give ln_qkv_int8_plain's bits.


def ln_qkv_int8_x_plain(x2, mu):
    """Plain version of K12/K13's row pass: x − μ in fp32, quantized per
    token: (x8 (M, K) int8, s_x (M, 1) fp32)."""
    return quant_rows(x2.float() - mu)


def ln_qkv_int8_x(x2, mu):
    """K12/K13's row pass on CUDA tensors, its plain version on CPU
    tensors."""
    if x2.device.type == "cpu":
        return ln_qkv_int8_x_plain(x2, mu)
    _build.require_cuda("ln_qkv_int8_x", x2, mu)
    M, K = x2.shape
    if (x2.dtype != torch.bfloat16 or M < 1 or K < 16 or K % 16 or K > 2048
            or mu.numel() != M):
        raise ValueError(f"ln_qkv_int8_x kernel takes bf16 x (M ≥ 1, K a "
                         f"multiple of 16 up to 2048) and one μ per row; got "
                         f"{tuple(x2.shape)} {x2.dtype}, mu {mu.numel()}")
    x2, mu = x2.contiguous(), mu.float().contiguous()
    x8 = torch.empty((M, K), device=x2.device, dtype=torch.int8)
    sx = torch.empty((M, 1), device=x2.device, dtype=torch.float32)
    _build.launch("vit_ln_qkv_int8_x",
                  *(t.data_ptr() for t in (x2, mu, x8, sx)), M, K)
    ln_qkv_int8_x.launches += 1
    return x8, sx


ln_qkv_int8_x.launches = 0


def ln_qkv_int8_mm_plain(x8, sx, mu, inv, w8t, sc, c, fq: int, fk: int,
                         dtype=torch.bfloat16):
    """Plain version of K12/K13's product: deq = (x8@W)·s_x·s_W in fp32,
    q = inv·deq on the first fq columns, k/v = deq + μ·c on the next fk and
    the rest, each rounded once to dtype.  x8: (M, K) int8, sx/mu/inv:
    (M, 1) fp32; w8t: (F, K) int8, Wᵀ, with scales sc (F,); c: (F,)."""
    deq = int8_matmul(x8, w8t.t()) * sx * sc
    q = inv * deq[:, :fq]
    kv = deq[:, fq:] + mu * c[fq:]
    return q.to(dtype), kv[:, :fk].to(dtype), kv[:, fk:].to(dtype)


# the columns of a tile of K12/K13's product kernel (csrc/ln_qkv_int8.cu,
# MM_COLS) and the chunks its epilogue stores by TMA
K13_TILE_COLS, K13_STORE_CHUNK = 128, 64


def k13_store_routes(f: int, fq: int, fk: int) -> list:
    """How K12/K13's product kernel stores each of its column tiles, as its
    epilogue decides (``tile_by_tma`` in csrc/ln_qkv_int8.cu): "tma" (a
    staging in shared memory, then one TMA store a 64-column chunk, to the
    map of its output) where every chunk of the tile, up to f, holds
    columns of one output whose rows are whole 16-byte units (a width that
    is a multiple of 8), else "registers" (stores straight from the
    accumulators).  The wrapper's outputs are fresh allocations, so their
    pointers are 16-byte aligned, which the kernel's host side checks too.
    At the full width (q, k, v 256 each) every tile goes by TMA; at the
    tiny configs' (fq 32, f 96) the one tile goes from the registers."""
    widths = (fq, fk, f - fq - fk)
    ends = (fq, fq + fk, f)
    routes = []
    for n0 in range(0, f, K13_TILE_COLS):
        tma = True
        for c0 in range(n0, min(n0 + K13_TILE_COLS, f), K13_STORE_CHUNK):
            o = 0 if c0 < fq else 1 if c0 < fq + fk else 2
            tma &= min(c0 + K13_STORE_CHUNK, f) <= ends[o] and widths[o] % 8 == 0
        routes.append("tma" if tma else "registers")
    return routes


def ln_qkv_int8_mm(x8, sx, mu, inv, w8t, sc, c, fq: int, fk: int,
                   dtype=torch.bfloat16):
    """K12/K13's product on CUDA tensors (bf16 out), its plain version on
    CPU tensors."""
    if x8.device.type == "cpu":
        return ln_qkv_int8_mm_plain(x8, sx, mu, inv, w8t, sc, c, fq, fk, dtype)
    _build.require_cuda("ln_qkv_int8_mm", x8, sx, mu, inv, w8t, sc, c)
    M, K = x8.shape
    F = w8t.shape[0]
    if (x8.dtype != torch.int8 or w8t.dtype != torch.int8
            or dtype != torch.bfloat16 or M < 1 or K < 16 or K % 16
            or K > 2048 or F < 16 or F % 16 or w8t.shape[1] != K
            or any(t.numel() != M for t in (sx, mu, inv))
            or sc.numel() != F or c.numel() != F
            or not (0 < fq and 0 < fk and fq + fk < F)):
        raise ValueError(f"ln_qkv_int8_mm kernel takes int8 x8 (M ≥ 1, K a "
                         f"multiple of 16 up to 2048), one s_x, μ and inv per "
                         f"row, int8 Wᵀ (F a multiple of 16, K), F scales "
                         f"and colsums, 0 < fq, 0 < fk, fq + fk < F, and "
                         f"writes bf16; got x8 {tuple(x8.shape)} {x8.dtype}, "
                         f"Wᵀ {tuple(w8t.shape)} {w8t.dtype}, fq {fq}, fk "
                         f"{fk}, {dtype}")
    x8, w8t = x8.contiguous(), w8t.contiguous()
    sx, mu, inv, sc, c = (t.float().contiguous()
                          for t in (sx, mu, inv, sc, c))
    outs = [torch.empty((M, f), device=x8.device, dtype=torch.bfloat16)
            for f in (fq, fk, F - fq - fk)]
    _build.launch("vit_ln_qkv_int8_mm",
                  *(t.data_ptr() for t in (x8, sx, mu, inv, w8t, sc, c,
                                           *outs)), M, K, F, fq, fk)
    ln_qkv_int8_mm.launches += 1
    return tuple(outs)


ln_qkv_int8_mm.launches = 0


def ln_qkv_int8(x2, mu, inv, w8, sc, c, fq: int, fk: int):
    """Kernel K12/K13 (two kernels: x8, then the product) on CUDA tensors,
    the plain stages on CPU tensors.  Arguments as ``ln_qkv_int8_plain``'s;
    W goes to the product transposed.  On the card every operand is checked
    before the first launch."""
    if x2.device.type != "cpu":
        _build.require_cuda("ln_qkv_int8", x2, mu, inv, w8, sc, c)
        _check_k13(x2, mu, inv, w8, sc, c, fq, fk)
    x8, sx = ln_qkv_int8_x(x2, mu)
    return ln_qkv_int8_mm(x8, sx, mu, inv, w8.t().contiguous(), sc, c, fq,
                          fk, x2.dtype)


def fused_ln_qkv_int8(x: torch.Tensor, gamma, wq, wkv, *, eps: float = 1e-5,
                      use_kernel: bool = True):
    """Serving-only W8A8 ``fused_ln_qkv`` (counterpart of the JAX
    ``fused_ln_qkv3_int8``, and of ``fused_ln_qkv_int8`` with its kv split
    into k and v).  x: (..., M, D); wq: (D, Fq); wkv: (D, 2·Fk).  Returns
    q, k, v, each (..., M, F·) in x.dtype."""
    _build.refuse_grad("fused_ln_qkv_int8", x, gamma, wq, wkv, why=_NO_GRAD)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    mu, inv = ln_stats(x2, eps)
    w8, sc, c = int8_qkv_weights(gamma, wq, wkv)
    fn = ln_qkv_int8 if use_kernel else ln_qkv_int8_plain
    outs = fn(x2, mu, inv, w8, sc, c, wq.shape[1], wkv.shape[1] // 2)
    return tuple(t.reshape(shape[:-1] + (t.shape[-1],)) for t in outs)


def proj_int8_plain(x2, w8, sc):
    """Plain version of K14: x2 (M, K) quantized per row, times w8 (K, F)
    int8 with scales sc (F,); fp32 arithmetic, output in x2.dtype."""
    x8, sr = quant_rows(x2)
    return (int8_matmul(x8, w8) * sr * sc).to(x2.dtype)


def proj_int8(x2, w8, sc):
    """Kernel K14 on CUDA tensors, the plain version on CPU tensors.  The
    kernel takes W transposed (F × K: ldmatrix has no .trans for 8-bit
    data) and K up to 1024 (its rows and ring share 227 KB)."""
    if x2.device.type == "cpu":
        return proj_int8_plain(x2, w8, sc)
    _build.require_cuda("proj_int8", x2, w8, sc)
    M, K, F = _check_w8a8("proj_int8", x2, w8, sc)
    if M < 1 or K > 1024:
        raise ValueError(f"proj_int8 kernel takes M ≥ 1 and K up to 1024; "
                         f"got x {tuple(x2.shape)}")
    x2, sc = x2.contiguous(), sc.float().contiguous()
    wt = w8.t().contiguous()
    out = torch.empty((M, F), device=x2.device, dtype=x2.dtype)
    _build.launch("vit_proj_int8_fwd",
                  *(t.data_ptr() for t in (x2, wt, sc, out)), M, K, F)
    proj_int8.launches += 1
    return out


proj_int8.launches = 0


def int8_proj(x: torch.Tensor, w, *, use_kernel: bool = True) -> torch.Tensor:
    """Serving-only W8A8 bias-free projection x @ w (counterpart of the JAX
    ``int8_proj``): w (K, F) quantized per output channel on every call,
    x per token.  Returns (..., F) in x.dtype."""
    _build.refuse_grad("int8_proj", x, w, why=_NO_GRAD)
    shape = x.shape
    w8, sc = quantize_per_channel(w)
    fn = proj_int8 if use_kernel else proj_int8_plain
    out = fn(x.reshape(-1, shape[-1]), w8, sc)
    return out.reshape(shape[:-1] + (out.shape[-1],))
