"""CPU parity of the attention backward pair's plain twin, the yardstick the
card holds csrc/flash_bwd.cu to, against the JAX package at the kernels'
own head dim 32: the VJP of ``vit_exp_tpu.ops.flash_attention
.flash_attention`` with its Pallas kernels in interpret mode, on the same
seeded numpy inputs, b = 1, h = 2.

- (nq, nkv) = (129, 130) with null_strategy="concat" and 2 nulls: JAX's
  K15 forward and the ragged ``_dq_kernel``/``_dkv_kernel`` pair over 132
  keys in blocks of 64 (a 4-key tail), against the port's
  ``flash_attention_online``;
- (96, 96) with null_strategy="init" and the logit bound: JAX's static
  forward and the exact-tiling ``_bwd_fused_kernel`` (K5) with the null
  terms outside, against the port's ``flash_attention`` (StaticAttention).

Besides, the wrappers' checks of what TMA reads (meta tensors), and the
zero-row identity that lets the dK/dV kernel run without a query mask.

Tolerances, relative L2 per gradient (q, k, v and the nulls): 1e-5 in
fp32, where the two sides differ only in summation order (measured
≤ 3.2e-7); 1e-2 in bf16, where both round p, dS and the outputs to bf16 but
from fp32 sums taken in another order (measured ≤ 1.5e-3; the card tests'
bound for the kernels against this twin).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_exp_tpu.ops import flash_attention as jfa

from vit_exp_tpu_torch.ops import flash_attention as tfa

D, H, N_NULL = 32, 2, 2
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _rel(a, b):
    a = np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(jnp.asarray(b, jnp.float32), np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(nq, nkv, seed, logit_scale):
    """q/k unit-norm times logit_scale, v, nulls (h, 2, d), cotangent."""
    r = np.random.default_rng(seed)
    q = _unit(r.standard_normal((1, H, nq, D))) * np.float32(logit_scale)
    k = _unit(r.standard_normal((1, H, nkv, D))) * np.float32(logit_scale)
    v = r.standard_normal((1, H, nkv, D)).astype(np.float32)
    nk = _unit(r.standard_normal((H, N_NULL, D))) * np.float32(logit_scale)
    nv = r.standard_normal((H, N_NULL, D)).astype(np.float32)
    g = r.standard_normal((1, H, nq, D)).astype(np.float32)
    return q, k, v, nk, nv, g


def _grads(jf, tf, arrays, dtype):
    """(JAX grads, port grads) of q, k, v and the nulls for cotangent
    arrays[-1], every input cast to dtype on both sides."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    *xs, g = arrays
    _, vjp = jax.vjp(jf, *(jnp.asarray(x, jdt) for x in xs))
    ref = vjp(jnp.asarray(g, jdt))
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_() for x in xs]
    tf(*leaves).backward(torch.from_numpy(g).to(tdt))
    return ref, [t.grad for t in leaves]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_twin_matches_jax_concat_ragged(dtype):
    """129 queries, 130 keys and 2 nulls concatenated: the K6/K7 route."""
    scale = 1.0 / math.sqrt(D)
    arrays = _inputs(129, 130, seed=50, logit_scale=3.0)

    def jf(q, k, v, nk, nv):
        return jfa.flash_attention(
            q, k, v, scale=scale, null_k=nk[None], null_v=nv[None],
            null_strategy="concat", block_q=64, block_k=64, interpret=True)

    def tf(q, k, v, nk, nv):
        return tfa.flash_attention_online(q, k, v, scale=scale, null_k=nk,
                                          null_v=nv)

    ref, got = _grads(jax.jit(jf), tf, arrays, dtype)
    tol = TOL[dtype]
    for name, a, r in zip(("q", "k", "v", "null k", "null v"), got, ref):
        assert a.dtype == getattr(torch, dtype) and _rel(a, r) < tol, name


@pytest.mark.parametrize("which", range(4), ids=["q", "k", "v", "dout"])
def test_pair_takes_what_tma_reads(which):
    """The kernels read q, k, v and dO through 4-D TMA tensor maps with
    64-bit strides: rows reaching 2^31 elements pass the wrappers' checks;
    a row stride off 16 bytes (36 bf16) or a head dim that is not
    contiguous, in any one of the four, is refused before any launch."""
    bf = torch.bfloat16
    small = torch.empty((1, 1, 4, D), device="meta", dtype=bf)
    big = torch.empty((1, 1, 2 ** 20, 2 ** 11), device="meta",
                      dtype=bf)[..., :D]
    args = [small] * 4
    args[which] = big
    strides = tfa._bwd_strides(*args, ())
    assert strides[3 * which:3 * which + 3] == [2 ** 31, 2 ** 31, 2 ** 11]
    odd = torch.empty((1, 1, 4, 36), device="meta", dtype=bf)[..., :D]
    cols = torch.empty((1, 1, D, 4), device="meta", dtype=bf).transpose(2, 3)
    for bad in (odd, cols):
        args[which] = bad
        with pytest.raises(ValueError, match="16-byte"):
            tfa._bwd_strides(*args, ())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zero_rows_past_the_ends_add_exact_zeros(dtype):
    """What lets the dK/dV kernel drop its query mask for TMA's zero fill,
    pinned on the plain twin: a q/dO row of zeros with lse = δ = 0 has p = 1
    and dS = 0, so its Pᵀ dO and dSᵀ Q terms are exact zeros; a k/v row of
    zeros adds dS·0 to dQ.  Appending 58 such query rows and 19 such key rows
    leaves every real row's dQ, dK and dV bit for bit as it was."""
    tdt = getattr(torch, dtype)
    nq, nkv, pq, pk = 70, 45, 58, 19
    q, k, v, _, _, g = (torch.from_numpy(x).to(tdt)
                        for x in _inputs(nq, nkv, seed=52, logit_scale=3.0))
    scale = 1.0 / math.sqrt(D)
    out, lse = tfa.attention_online_plain(q, k, v, scale, save_lse=True)
    delta = (g.to(lse.dtype) * out.to(lse.dtype)).sum(-1)
    base = tfa.attention_bwd_plain(q, k, v, g, lse, delta, scale)

    def rows(t, n):
        return torch.cat([t, t.new_zeros(t.shape[:2] + (n,) + t.shape[3:])],
                         dim=2)

    got = tfa.attention_bwd_plain(rows(q, pq), rows(k, pk), rows(v, pk),
                                  rows(g, pq), rows(lse, pq),
                                  rows(delta, pq), scale)
    for a, r, n in zip(got, base, (nq, nkv, nkv)):
        assert torch.equal(a[:, :, :n], r)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_twin_matches_jax_init_exact(dtype):
    """96 queries and keys with 2 nulls kept outside (null_strategy="init",
    the logit bound): JAX's exact-tiling fused backward, K5."""
    scale = 1.0 / math.sqrt(D)
    arrays = _inputs(96, 96, seed=51, logit_scale=1.0)

    def jf(q, k, v, nk, nv):
        return jfa.flash_attention(
            q, k, v, scale=scale, null_k=nk[None], null_v=nv[None],
            null_strategy="init", logit_bound=jnp.float32(scale),
            block_q=32, block_k=32, interpret=True)

    def tf(q, k, v, nk, nv):
        return tfa.flash_attention(q, k, v, logit_bound=torch.tensor(scale),
                                   scale=scale, null_k=nk, null_v=nv)

    ref, got = _grads(jax.jit(jf), tf, arrays, dtype)
    tol = TOL[dtype]
    for name, a, r in zip(("q", "k", "v", "null k", "null v"), got, ref):
        assert a.dtype == getattr(torch, dtype) and _rel(a, r) < tol, name
