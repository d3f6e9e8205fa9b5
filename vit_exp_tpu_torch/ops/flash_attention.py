"""Static-max attention with null kv, forward and backward (counterpart of
``_flash_core_static`` in vit_exp_tpu/ops/flash_attention.py), and
online-softmax attention over a concatenated kv (counterpart of
``_flash_core`` with null_strategy="concat").

Cosine attention bounds every logit: q and k rows are unit-norm times learned
per-dim scales, so q·k·scale ≤ B = scale·max|q_scale|·max|k_scale|.  With B
subtracted once there is no running max to keep:
    out = Σ exp(q·k·scale − B)·v / Σ exp(q·k·scale − B)  over [nulls ++ kv].
The probabilities are rounded to the input dtype before both sums, as the
TPU kernel's bf16 p·[v | 1] product does.

Kernel K1 (``attention_static``) replaces
vit_exp_tpu/ops/flash_attention.py::_fwd_kernel_static (``_flash_fwd_static``,
via ``_flash_core_static``), and K15 (``attention_online``, below) replaces
::_fwd_kernel: one CUDA C++ kernel template, csrc/flash_fwd.cu, with two
softmax policies.  With head dim 32 the two products per logit are cheap
next to the exp: at 13,824 tokens and 32 (batch · head) rows it is 6.1 G
logits per layer, bound by the exp unit (≈ 1.5-1.65 ms on an H100) more than
by the products (0.79 ms).  The kernel is built on Hopper's pieces
(csrc/gemm_wgmma.cuh): one block owns 192 queries of one (batch, head); a
producer warp's TMA loads (4-D tensor maps over the strided (b, h, n, d)
views, rows past the end zero-filled) feed K and V in 128-key tiles (64 at
head dim 64) through an ``mbarrier`` ring; three consumer warpgroups of 64
queries take turns at the tensor cores, S = QKᵀ and O += P·V as ``wgmma``
with Q and P as register A operands, so S, p and O never leave registers,
and each consumer's exps run beside its own P·V and the others' products.
p = bf16(exp2(S·scale·log2e − B·log2e)), one FFMA and one ex2 per logit;
the row sum l of the bf16 p comes from the tensor cores (P against a tile
of ones, as the TPU kernel's ones column in v).  The nulls are one 16-key
tile taken before the first kv tile; O/l is written once at the end.  Ragged q and kv tails are
masked, and q/k/v/out are read and written through strides, so the (b, n,
h·d) projection output is used in place and the output lands in the (b, n,
h·d) layout the out-projection reads.  B arrives as a device pointer: the
forward never synchronises with the host.  On request K1 also writes lse =
B + log l (natural log; l summed over the bf16-rounded p, nulls included),
which the backward recomputes p from.  The wrappers check what TMA takes (a
contiguous head dim, 16-byte aligned pointers and strides) and at least
one key.

Head dims.  The kernels are template instances at head dim 16, 32 and 64
(the int8 attention at 32 and 64: its k step is 32 codes); the wrappers
zero-pad any other head dim up to 64 to the next instance
(``kernel_head_dim``, ``pad_head``), as JAX's ``_prep4`` pads d, and drop
the padded output columns: zero columns add nothing to q·k, to the null
logits, to the int8 amax or to P·V.  A head dim above 64 is refused.

The backward replaces vit_exp_tpu/ops/flash_attention.py::_bwd_fused_kernel
(K5, exact tiling) and ::_dq_kernel / ::_dkv_kernel (K6/K7, ragged kv) with
one pair of CUDA C++ kernels, csrc/flash_bwd.cu: ``attention_bwd_dkv`` is
parallel over blocks of 128 keys and ``attention_bwd_dq`` over blocks of
128 queries, each walking the other axis in 64-row tiles (no atomics and a
fixed order, so bit-reproducible).  Both are built on Hopper's pieces
(csrc/gemm_wgmma.cuh): a producer warp's TMA loads (4-D tensor maps over
the strided (b, h, n, d) views, rows past the end zero-filled) into an
``mbarrier`` ring, and two consumer warpgroups of 64 rows whose seven
products are ``wgmma``: S and dP from shared memory, dV, dK and dQ with p
and dS as register A operands, so S, dP, p and dS never leave registers;
p = exp2(S·scale·log2e − lse·log2e), the exps of one warpgroup running
beside the other's products.  At head dim 32 the products and the exps
bound it about equally (design notes in the source).  The kernels read
lse and δ as they are; the wrappers check what TMA takes (a contiguous
head dim, 16-byte aligned pointers and strides).
δ = rowsum(dO·O) and the null-kv terms are plain torch, as
the JAX package keeps them outside its kernels.  ``StaticAttention`` is the
``torch.autograd.Function`` that ties forward and backward together; the
bound B gets no gradient (softmax is invariant to the shift).

Kernel K15 (``attention_online``) replaces
vit_exp_tpu/ops/flash_attention.py::_fwd_kernel (``_flash_fwd``, via
``_flash_core``), the forward of the JAX package's training default
(attn_impl="pallas").  It is K1's kernel template (csrc/flash_fwd.cu) under
its other policy: the nulls are ordinary keys at the front of k/v (nkv =
13,826 at production, so the last 128-key tile holds 2 keys and the rest is
masked), and a running max m (log2 units, a quad reduction per row over a
128-key tile) replaces the bound, with the per-tile correction exp2(m −
m_new) on l and O in registers.  As the TPU kernel does, l sums the fp32 p and only the
P·V operand is p rounded to bf16; lse = m + log l.
``OnlineAttention`` runs it forward and the flash_bwd.cu pair backward over
all nkv keys (the JAX ``_flash_bwd_concat`` route), so the null gradients
are rows [:n_null] of dK/dV, summed over the batch by ``torch.cat``'s own
backward.

Kernel ``attention_static_int8`` replaces vit_exp_tpu/ops/flash_attention.py
::_fwd_kernel_static_int8 (K9, ``_flash_fwd_static_int8``, the transpose
route) and ::_fwd_kernel_static_hp (K10, ``flash_attention_serving_hp``,
the heads-packed route): the two exist because Mosaic needed two layouts;
here one kernel reads q8, k8 and v through strides.  CUDA C++,
csrc/flash_static_int8.cu, K1's register-resident design: S = q8·k8ᵀ by
mma.sync m16n8k32 on the int8 tensor cores into exact int32 (recovered as
a float by one FADD of a biased accumulator), logits = S·qe − B, p =
bf16(exp(·)) through ex2, O += P·V on bf16 tensor cores.  The prologue (``quantize_qk``) stays plain torch, as the JAX
wrapper keeps it in XLA: q is quantized per (b, n, h) row, k with one
global scale (a device tensor, never read by the host), and the scales
fold into qe = s_q·s_k·scale per row; the nulls use the fp32 logits
q8·nk·qn with qn = s_q·scale.  Under the fp32 policy K9 and K10 round
differently; kernel and plain twin follow K10, the production route: p and
v are bf16 for P·V and its row sum, the null probabilities are rounded to
v's dtype for their P·V term but summed in fp32 into l.  Same bound as K1,
the exp unit (the int8 product halves only the cheaper of the two
products).  Serving
only: no backward.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from vit_exp_tpu_torch.core.precision import acc_dtype
from vit_exp_tpu_torch.ops import _build
from vit_exp_tpu_torch.ops.geglu_ff import int8_scale, quant_rows

# the head dims the bf16 attention kernels are built for (csrc/flash_fwd.cu,
# csrc/flash_bwd.cu) and the int8 kernel's (csrc/flash_static_int8.cu: an
# int8 k step is 32 codes); any other head dim up to MAX_HEAD_DIM runs
# zero-padded to the next instance
HEAD_DIMS = (16, 32, 64)
INT8_HEAD_DIMS = (32, 64)
MAX_HEAD_DIM = 64
MAX_NULL = 8


def kernel_head_dim(d: int, instances=HEAD_DIMS) -> int:
    """The kernel instance head dim d runs at: the smallest one ≥ d.
    Raises above MAX_HEAD_DIM, a head dim no kernel takes."""
    for dp in instances:
        if d <= dp:
            return dp
    raise ValueError(f"the attention kernels take head dims up to "
                     f"{MAX_HEAD_DIM}; got {d}")


def pad_head(t: Optional[torch.Tensor], dp: int):
    """t with its last (head) dim zero-padded to dp; t itself when it is
    dp wide already (or None).  Exact for the attention kernels: the zero
    columns add nothing to q·k, to the null logits or to P·V, and the
    output's padded columns, zero, are dropped."""
    if t is None or t.shape[-1] == dp:
        return t
    return F.pad(t, (0, dp - t.shape[-1]))


def attention_static_plain(q, k, v, nk, nv, bound, scale: float,
                           save_lse: bool = False):
    """Plain version of K1.  q: (b, h, nq, d); k/v: (b, h, nkv, d); nk/nv:
    (h, n_null, d) or None; bound: 0-dim fp32 tensor.  fp32 arithmetic,
    p rounded to q.dtype; processed in query chunks to bound memory.
    With ``save_lse`` returns (out, lse), lse = B + log l of shape
    (b, h, nq) in fp32 (fp64 for fp64 inputs)."""
    b, h, nq, d = q.shape
    nkv = k.shape[2]
    acc_t = acc_dtype(q.dtype)
    kf, vf = k.to(acc_t), v.to(acc_t)
    out = torch.empty((b, nq, h, d), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, nq), device=q.device, dtype=acc_t)
    chunk = max(1, (1 << 27) // (b * h * max(nkv, 1)))
    bound = bound.to(acc_t)
    for s in range(0, nq, chunk):
        qs = q[:, :, s:s + chunk].to(acc_t)
        p = torch.exp(qs @ kf.transpose(-1, -2) * scale - bound)
        p = p.to(q.dtype).to(acc_t)
        acc = p @ vf
        l = p.sum(dim=-1, keepdim=True)
        if nk is not None and nk.shape[1]:
            p0 = torch.exp(qs @ nk.to(acc_t).transpose(-1, -2)[None] * scale
                           - bound).to(q.dtype).to(acc_t)
            acc = acc + p0 @ nv.to(acc_t)[None]
            l = l + p0.sum(dim=-1, keepdim=True)
        out[:, s:s + chunk] = (acc / l).to(q.dtype).transpose(1, 2)
        lse[:, :, s:s + chunk] = bound + torch.log(l[..., 0])
    out = out.transpose(1, 2)
    return (out, lse) if save_lse else out


def _row_strides(t: torch.Tensor, name: str):
    per16 = 16 // t.element_size()
    if t.stride(-1) != 1 or any(s % per16 for s in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"attention kernels: {name} needs a contiguous "
                         f"head dim and 16-byte aligned rows, got strides "
                         f"{t.stride()}")
    return t.stride()[:3]


def _check_qkv(q, k, v, what: str):
    b, h, nq, d = q.shape
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"{what} takes bf16 q, k and v")
    if (d > MAX_HEAD_DIM or k.shape != v.shape or k.shape[:2] != (b, h)
            or k.shape[3] != d):
        raise ValueError(f"{what} takes head dims up to {MAX_HEAD_DIM} and "
                         f"matching shapes; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")


def _heads_last_like(t: torch.Tensor) -> torch.Tensor:
    """An empty (b, h, n, d) tensor laid out in memory as (b, n, h, d)."""
    b, h, n, d = t.shape
    return torch.empty((b, n, h, d), device=t.device,
                       dtype=t.dtype).transpose(1, 2)


def attention_static(q, k, v, nk, nv, bound, scale: float,
                     save_lse: bool = False):
    """Kernel K1 on CUDA tensors, the plain version on CPU tensors.
    Returns (b, h, nq, d), laid out in memory as (b, nq, h, d) (a view of
    the kernel's (b, nq, h, D) output where d runs padded to D), and with
    ``save_lse`` also lse (b, h, nq) fp32."""
    if q.device.type == "cpu":
        return attention_static_plain(q, k, v, nk, nv, bound, scale, save_lse)
    b, h, nq, d = q.shape
    nkv = k.shape[2]
    n_null = 0 if nk is None else nk.shape[1]
    if nk is None:
        nk = nv = torch.zeros((h, 1, d), device=q.device, dtype=q.dtype)
    _build.require_cuda("attention_static", q, k, v, nk, nv, bound)
    _check_qkv(q, k, v, "attention_static kernel")
    if nkv < 1:
        raise ValueError("attention_static kernel needs at least one key")
    if (nk.dtype != torch.bfloat16 or nv.dtype != torch.bfloat16
            or n_null > MAX_NULL or nk.shape != nv.shape
            or nk.shape[::2] != (h, d)):
        raise ValueError(f"attention_static kernel takes at most {MAX_NULL} "
                         f"bf16 nulls of shape (h, n_null, d); got "
                         f"{tuple(nk.shape)}")
    dp = kernel_head_dim(d)
    q, k, v, nk, nv = (pad_head(t, dp) for t in (q, k, v, nk, nv))
    nk, nv = nk.contiguous(), nv.contiguous()
    if nk.data_ptr() % 16 or nv.data_ptr() % 16:   # read by TMA
        nk, nv = nk.clone(), nv.clone()
    bound = bound.float().reshape(())
    out = _heads_last_like(q)
    lse = (torch.empty((b, h, nq), device=q.device, dtype=torch.float32)
           if save_lse else None)
    strides = [s for t, name in ((q, "q"), (k, "k"), (v, "v"), (out, "out"))
               for s in _row_strides(t, name)]
    _build.launch("vit_flash_static_fwd",
                  *(t.data_ptr() for t in (q, k, v, nk, nv, bound, out)),
                  None if lse is None else lse.data_ptr(),
                  *strides, b, h, nq, nkv, n_null, dp, float(scale))
    attention_static.launches += 1
    out = out[..., :d]
    return (out, lse) if save_lse else out


attention_static.launches = 0


def attention_bwd_plain(q, k, v, dout, lse, delta, scale: float):
    """Plain version of the backward kernel pair over the given kv (on the
    static route the real kv, whose null terms are ``null_kv_grads``; on
    the online route the concatenated kv).  lse, delta: (b, h, nq) fp32.
    p = exp(q·k·scale − lse), dV = bf16(p)ᵀ dO, dS = p·(dO Vᵀ − δ)·scale
    rounded to q.dtype, dQ = dS K, dK = dSᵀ Q; fp32 arithmetic in query
    chunks, so no (nq, nkv) logit matrix is ever whole."""
    b, h, nq, d = q.shape
    nkv = k.shape[2]
    acc_t = acc_dtype(q.dtype)
    kf, vf = k.to(acc_t), v.to(acc_t)
    dq = _heads_last_like(q)
    dk = torch.zeros((b, h, nkv, d), device=q.device, dtype=acc_t)
    dv = torch.zeros_like(dk)
    chunk = max(1, (1 << 27) // (b * h * max(nkv, 1)))
    for s in range(0, nq, chunk):
        qs = q[:, :, s:s + chunk].to(acc_t)
        dos = dout[:, :, s:s + chunk].to(acc_t)
        p = torch.exp(qs @ kf.transpose(-1, -2) * scale
                      - lse[:, :, s:s + chunk, None])
        dp = dos @ vf.transpose(-1, -2)
        ds = (p * (dp - delta[:, :, s:s + chunk, None]) * scale
              ).to(q.dtype).to(acc_t)
        dv += p.to(dout.dtype).to(acc_t).transpose(-1, -2) @ dos
        dk += ds.transpose(-1, -2) @ qs
        dq[:, :, s:s + chunk] = (ds @ kf).to(q.dtype)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _bwd_strides(q, k, v, dout, grads):
    """The (b, h, n) strides of q, k, v, dout and the gradients, each
    checked: TMA reads q, k, v and dout through 4-D tensor maps (16-byte
    aligned pointers and strides, any stride order, any size), and the
    gradients leave from the registers at 64-bit offsets."""
    return [s for t, name in ((q, "q"), (k, "k"), (v, "v"), (dout, "dout"),
                              *grads)
            for s in _row_strides(t, name)]


def attention_bwd_dkv(q, k, v, dout, lse, delta, scale: float):
    """dK, dV kernel (csrc/flash_bwd.cu) on CUDA tensors, laid out in
    memory as (b, nkv, h, d); the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, dout, lse, delta, scale)[1:]
    _build.require_cuda("attention_bwd_dkv", q, k, v, dout, lse, delta)
    _check_qkv(q, k, v, "attention_bwd_dkv kernel")
    b, h, nq, d = q.shape
    nkv = k.shape[2]
    dp = kernel_head_dim(d)
    q, k, v, dout = (pad_head(t, dp) for t in (q, k, v, dout))
    dk, dv = _heads_last_like(k), _heads_last_like(v)
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    strides = _bwd_strides(q, k, v, dout, ((dk, "dk"), (dv, "dv")))
    _build.launch("vit_flash_bwd_dkv",
                  *(t.data_ptr() for t in (q, k, v, dout, lse, delta, dk, dv)),
                  *strides, b, h, nq, nkv, dp, float(scale))
    attention_bwd_dkv.launches += 1
    return dk[..., :d], dv[..., :d]


attention_bwd_dkv.launches = 0


def attention_bwd_dq(q, k, v, dout, lse, delta, scale: float):
    """dQ kernel (csrc/flash_bwd.cu) on CUDA tensors, laid out in memory
    as (b, nq, h, d); the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, dout, lse, delta, scale)[0]
    _build.require_cuda("attention_bwd_dq", q, k, v, dout, lse, delta)
    _check_qkv(q, k, v, "attention_bwd_dq kernel")
    b, h, nq, d = q.shape
    nkv = k.shape[2]
    dp = kernel_head_dim(d)
    q, k, v, dout = (pad_head(t, dp) for t in (q, k, v, dout))
    dq = _heads_last_like(q)
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    strides = _bwd_strides(q, k, v, dout, ((dq, "dq"),))
    _build.launch("vit_flash_bwd_dq",
                  *(t.data_ptr() for t in (q, k, v, dout, lse, delta, dq)),
                  *strides, b, h, nq, nkv, dp, float(scale))
    attention_bwd_dq.launches += 1
    return dq[..., :d]


attention_bwd_dq.launches = 0


def attention_bwd(q, k, v, dout, lse, delta, scale: float):
    """(dq, dk, dv) over the real kv: the kernel pair on CUDA tensors, the
    plain version on CPU tensors."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, dout, lse, delta, scale)
    if dout.stride(-1) != 1 or any(s % 8 for s in dout.stride()[:3]):
        dout = dout.contiguous()
    dk, dv = attention_bwd_dkv(q, k, v, dout, lse, delta, scale)
    return attention_bwd_dq(q, k, v, dout, lse, delta, scale), dk, dv


def null_kv_grads(q, nk, nv, dout, lse, delta, scale: float):
    """The null-kv terms of the backward in fp32, as the JAX package
    computes them outside its kernels: (dq term (b, h, nq, d), dnk, dnv
    (h, n_null, d)).  The nulls are shared by the batch, so their
    gradients sum over it."""
    acc_t = acc_dtype(q.dtype)
    nkf, nvf = nk.to(acc_t), nv.to(acc_t)
    qf, gf = q.to(acc_t), dout.to(acc_t)
    p = torch.exp(torch.einsum("bhnd,hmd->bhnm", qf, nkf) * scale
                  - lse[..., None])
    dp = torch.einsum("bhnd,hmd->bhnm", gf, nvf)
    ds = p * (dp - delta[..., None]) * scale
    return (torch.einsum("bhnm,hmd->bhnd", ds, nkf),
            torch.einsum("bhnm,bhnd->hmd", ds, qf),
            torch.einsum("bhnm,bhnd->hmd", p, gf))


class StaticAttention(torch.autograd.Function):
    """Differentiable static-max attention (counterpart of the JAX
    ``_flash_core_static`` custom VJP).  Inputs q, k, v (b, h, n, d), nulls
    (h, n_null, d) or None, the bound B (no gradient), scale and
    use_kernel: K1 with lse forward and the flash_bwd.cu pair backward, or
    their plain versions when use_kernel is False or the tensors lie on the
    CPU.  With no gradient to take (serving), K1 runs without lse."""

    @staticmethod
    def forward(ctx, q, k, v, nk, nv, bound, scale, use_kernel):
        fwd = attention_static if use_kernel else attention_static_plain
        if not any(ctx.needs_input_grad[:5]):
            return fwd(q, k, v, nk, nv, bound, scale)
        out, lse = fwd(q, k, v, nk, nv, bound, scale, save_lse=True)
        ctx.scale, ctx.use_kernel = scale, use_kernel
        ctx.has_null = nk is not None and nk.shape[1] > 0
        ctx.save_for_backward(q, k, v, nk, nv, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, nk, nv, out, lse = ctx.saved_tensors
        scale = ctx.scale
        delta = (g.to(lse.dtype) * out.to(lse.dtype)).sum(dim=-1)
        bwd = attention_bwd if ctx.use_kernel else attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, g, lse, delta, scale)
        dnk = dnv = None
        if ctx.has_null:
            dq_null, dnk, dnv = null_kv_grads(q, nk, nv, g, lse, delta, scale)
            dq = (dq.to(dq_null.dtype) + dq_null).to(q.dtype)
            dnk, dnv = dnk.to(nk.dtype), dnv.to(nv.dtype)
        return dq, dk, dv, dnk, dnv, None, None, None


def attention_online_plain(q, k, v, scale: float, save_lse: bool = False):
    """Plain version of K15.  q: (b, h, nq, d); k/v: (b, h, nkv, d), the
    nulls (if any) already among the keys.  fp32 arithmetic in query
    chunks: p = exp(q·k·scale − m) with m the row max, l = Σp in fp32, out
    = (p rounded to v.dtype)·v / l.  With ``save_lse`` returns (out, lse),
    lse = m + log l of shape (b, h, nq) in fp32 (fp64 for fp64 inputs)."""
    b, h, nq, d = q.shape
    nkv = k.shape[2]
    acc_t = acc_dtype(q.dtype)
    kf, vf = k.to(acc_t), v.to(acc_t)
    out = torch.empty((b, nq, h, d), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, nq), device=q.device, dtype=acc_t)
    chunk = max(1, (1 << 27) // (b * h * max(nkv, 1)))
    for s in range(0, nq, chunk):
        logits = q[:, :, s:s + chunk].to(acc_t) @ kf.transpose(-1, -2) * scale
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.exp(logits - m)
        l = p.sum(dim=-1, keepdim=True)
        acc = p.to(v.dtype).to(acc_t) @ vf
        out[:, s:s + chunk] = (acc / l).to(q.dtype).transpose(1, 2)
        lse[:, :, s:s + chunk] = (m + torch.log(l))[..., 0]
    out = out.transpose(1, 2)
    return (out, lse) if save_lse else out


def attention_online(q, k, v, scale: float, save_lse: bool = False):
    """Kernel K15 on CUDA tensors, the plain version on CPU tensors.
    Returns (b, h, nq, d), laid out in memory as (b, nq, h, d) (a view of
    the kernel's (b, nq, h, D) output where d runs padded to D), and with
    ``save_lse`` also lse (b, h, nq) fp32."""
    if q.device.type == "cpu":
        return attention_online_plain(q, k, v, scale, save_lse)
    _build.require_cuda("attention_online", q, k, v)
    _check_qkv(q, k, v, "attention_online kernel")
    b, h, nq, d = q.shape
    nkv = k.shape[2]
    if nkv < 1:
        raise ValueError("attention_online kernel needs at least one key")
    dp = kernel_head_dim(d)
    q, k, v = (pad_head(t, dp) for t in (q, k, v))
    out = _heads_last_like(q)
    lse = (torch.empty((b, h, nq), device=q.device, dtype=torch.float32)
           if save_lse else None)
    strides = [s for t, name in ((q, "q"), (k, "k"), (v, "v"), (out, "out"))
               for s in _row_strides(t, name)]
    _build.launch("vit_flash_online_fwd",
                  *(t.data_ptr() for t in (q, k, v, out)),
                  None if lse is None else lse.data_ptr(),
                  *strides, b, h, nq, nkv, dp, float(scale))
    attention_online.launches += 1
    out = out[..., :d]
    return (out, lse) if save_lse else out


attention_online.launches = 0


class OnlineAttention(torch.autograd.Function):
    """Differentiable online-softmax attention over a concatenated kv
    (counterpart of the JAX ``_flash_core`` custom VJP with
    null_strategy="concat", and of ``_flash_core_lse``).  Inputs q, k, v
    (b, h, n, d), scale, use_kernel and save_lse: K15 with lse forward and
    the flash_bwd.cu pair backward over all nkv keys, or their plain
    versions when use_kernel is False or the tensors lie on the CPU.  With
    ``save_lse`` the output is (out, lse) and both are differentiable: an
    lse cotangent shifts δ (∂lse/∂logits = p).  With no gradient to take
    and no lse asked for, K15 runs without lse."""

    @staticmethod
    def forward(ctx, q, k, v, scale, use_kernel, save_lse):
        fwd = attention_online if use_kernel else attention_online_plain
        if not (save_lse or any(ctx.needs_input_grad[:3])):
            return fwd(q, k, v, scale)
        out, lse = fwd(q, k, v, scale, save_lse=True)
        ctx.scale, ctx.use_kernel = scale, use_kernel
        ctx.save_for_backward(q, k, v, out, lse)
        return (out, lse) if save_lse else out

    @staticmethod
    def backward(ctx, g, glse=None):
        q, k, v, out, lse = ctx.saved_tensors
        delta = (g.to(lse.dtype) * out.to(lse.dtype)).sum(dim=-1)
        if glse is not None:
            delta = delta - glse
        bwd = attention_bwd if ctx.use_kernel else attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, g, lse, delta, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention_online(q, k, v, *, scale: Optional[float] = None,
                           null_k: Optional[torch.Tensor] = None,
                           null_v: Optional[torch.Tensor] = None,
                           use_kernel: bool = True, return_lse: bool = False):
    """Softmax over [null_kv ++ kv] of (q kᵀ · scale) with a running max,
    weighted sum of v (the JAX ``flash_attention`` with
    null_strategy="concat"; with no nulls and ``return_lse`` the JAX
    ``flash_attention_with_lse``).  q/k/v: (b, h, n, d); null_k/null_v:
    (h, n_null, d), cast to k's and v's dtype and prepended to every
    (batch, head): their gradients come back through ``torch.cat`` and sum
    over the batch.  Returns out, or (out, lse) with ``return_lse``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if null_k is not None:
        b = q.shape[0]
        nk = null_k.to(k.dtype)[None].expand(b, -1, -1, -1)
        nv = null_v.to(v.dtype)[None].expand(b, -1, -1, -1)
        k, v = torch.cat([nk, k], dim=2), torch.cat([nv, v], dim=2)
    return OnlineAttention.apply(q, k, v, float(scale), use_kernel, return_lse)


def quantize_qk(q: torch.Tensor, k: torch.Tensor, scale: float,
                amax_reduce=None):
    """The int8 prologue of K10 on (b, h, n, d) q and k: q8 per row, k8 at
    one global scale (a 0-dim device tensor), qe = s_q·s_k·scale and qn =
    s_q·scale, each (b, h, n) fp32.  q8/k8 keep q/k's memory layout.
    ``amax_reduce`` maps k's amax (a 0-dim fp32 device tensor) to the amax
    of the whole batch where this call sees only part of it (a process
    group's ranks, or the cards of one server): JAX takes the scale over
    the global batch under a mesh."""
    q8, qs = quant_rows(q)
    kf = k.float()
    amax = kf.abs().amax()
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    ks = int8_scale(amax)
    k8 = torch.clamp(torch.round(kf / ks), -127, 127).to(torch.int8)
    qs = qs[..., 0]
    return q8, k8, qs * ks * scale, qs * scale


def attention_static_int8_plain(q8, k8, v, qe, qn, nk, nv, bound):
    """Plain version of the int8 attention kernel.  q8: (b, h, nq, d) int8;
    k8: (b, h, nkv, d) int8; v: (b, h, nkv, d); qe/qn: (b, h, nq) fp32; nk:
    (h, n_null, d) fp32 and nv: (h, n_null, d), or None; bound: 0-dim fp32.
    fp32 arithmetic in query chunks, K10's rounding points; returns bf16
    (b, h, nq, d), laid out in memory as (b, nq, h, d)."""
    b, h, nq, d = q8.shape
    nkv = k8.shape[2]
    bf = torch.bfloat16
    kf, vf = k8.float(), v.to(bf).float()
    out = torch.empty((b, nq, h, d), device=q8.device, dtype=bf)
    chunk = max(1, (1 << 27) // (b * h * max(nkv, 1)))
    bound = bound.float()
    for s in range(0, nq, chunk):
        qs = q8[:, :, s:s + chunk].float()
        logits = qs @ kf.transpose(-1, -2) * qe[:, :, s:s + chunk, None]
        p = torch.exp(logits - bound).to(bf).float()
        acc = p @ vf
        l = p.sum(dim=-1, keepdim=True)
        if nk is not None and nk.shape[1]:
            nl = (qs @ nk.float().transpose(-1, -2)[None]
                  * qn[:, :, s:s + chunk, None])
            p0 = torch.exp(nl - bound)
            acc = acc + p0.to(nv.dtype).float() @ nv.float()[None]
            l = l + p0.sum(dim=-1, keepdim=True)
        out[:, s:s + chunk] = (acc / l).to(bf).transpose(1, 2)
    return out.transpose(1, 2)


def attention_static_int8(q8, k8, v, qe, qn, nk, nv, bound):
    """The int8 attention kernel (K9/K10) on CUDA tensors, the plain version
    on CPU tensors.  Returns bf16 (b, h, nq, d), laid out in memory as
    (b, nq, h, d) (a view of (b, nq, h, D) where d runs padded to D)."""
    if q8.device.type == "cpu":
        return attention_static_int8_plain(q8, k8, v, qe, qn, nk, nv, bound)
    b, h, nq, d = q8.shape
    nkv = k8.shape[2]
    n_null = 0 if nk is None else nk.shape[1]
    if nk is None:
        nk = torch.zeros((h, 1, d), device=q8.device)
        nv = torch.zeros((h, 1, d), device=q8.device, dtype=torch.bfloat16)
    _build.require_cuda("attention_static_int8", q8, k8, v, qe, qn, nk, nv,
                        bound)
    if (q8.dtype != torch.int8 or k8.dtype != torch.int8
            or v.dtype != torch.bfloat16 or nk.dtype != torch.float32
            or nv.dtype != torch.bfloat16 or qe.dtype != torch.float32
            or qn.dtype != torch.float32):
        raise ValueError("attention_static_int8 kernel takes int8 q/k, bf16 "
                         "v and null v, fp32 null k, qe and qn")
    if (d > MAX_HEAD_DIM or k8.shape != v.shape or k8.shape[:2] != (b, h)
            or k8.shape[3] != d or qe.shape != (b, h, nq)
            or qn.shape != qe.shape or qn.stride() != qe.stride()
            or n_null > MAX_NULL or nk.shape != nv.shape
            or nk.shape[::2] != (h, d)):
        raise ValueError(f"attention_static_int8 kernel takes head dims up "
                         f"to {MAX_HEAD_DIM}, at most {MAX_NULL} nulls and "
                         f"matching shapes; got q8 {tuple(q8.shape)}, k8 "
                         f"{tuple(k8.shape)}, v {tuple(v.shape)}, qe "
                         f"{tuple(qe.shape)}, nk {tuple(nk.shape)}")
    dp = kernel_head_dim(d, INT8_HEAD_DIMS)
    q8, k8, v, nk, nv = (pad_head(t, dp) for t in (q8, k8, v, nk, nv))
    nk, nv = nk.contiguous(), nv.contiguous()
    bound = bound.float().reshape(())
    out = torch.empty((b, nq, h, dp), device=q8.device,
                      dtype=torch.bfloat16).transpose(1, 2)
    strides = [s for t, name in ((q8, "q8"), (k8, "k8"), (v, "v"),
                                 (out, "out"))
               for s in _row_strides(t, name)]
    _build.launch("vit_flash_static_int8_fwd",
                  *(t.data_ptr() for t in (q8, k8, v, qe, qn, nk, nv, bound,
                                           out)),
                  *strides, *qe.stride(), b, h, nq, nkv, n_null, dp)
    attention_static_int8.launches += 1
    return out[..., :d]


attention_static_int8.launches = 0


def flash_attention(q, k, v, *, logit_bound: torch.Tensor,
                    scale: Optional[float] = None,
                    null_k: Optional[torch.Tensor] = None,
                    null_v: Optional[torch.Tensor] = None,
                    use_kernel: bool = True):
    """Static-max softmax over [null_kv ++ kv] of (q kᵀ · scale), weighted
    sum of v; differentiable in q, k, v and the nulls.  q/k/v: (b, h, n, d);
    null_k/null_v: (h, n_null, d); logit_bound: 0-dim fp32 tensor bounding
    every logit (it gets no gradient)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    nk = None if null_k is None else null_k.to(k.dtype)
    nv = None if null_v is None else null_v.to(v.dtype)
    return StaticAttention.apply(q, k, v, nk, nv, logit_bound, float(scale),
                                 use_kernel)
