"""CPU parity of the port's kernels at the widths the JAX package's kernels
take, through their plain twins (the yardsticks the card holds the CUDA
kernels to), against the JAX package on the same seeded numpy inputs.

- The attention twins at head dims 8, 16, 24 and 64 (the CUDA kernels are
  built at 16, 32 and 64 and take any other head dim up to 64 zero-padded
  to the next one): the static-bound route with its nulls kept outside
  (K1 and the pair) and the concatenated route (K15 and the pair) against
  JAX's ``flash_attention`` with its Pallas kernels in interpret mode,
  forward and ``jax.vjp`` gradients of q, k, v and the nulls, fp32 within
  relative L2 1e-5 (summation order only).
- The padding identity the wrappers rely on: each attention twin (K1 with
  lse, K15 with lse, the backward pair, the int8 attention) at the padded
  head dim, sliced, equals the twin at the true head dim bit for bit in
  fp32 (zero columns add exact zeros to q·k and to P·V).
- The GEMM families' twins at the tiny configs' widths (D 48, 2I 256; K3
  and K12/K13 at K 48, F 96 with fq = fk = 32; K14 at K 32, F 48) against
  JAX in interpret mode, at the tolerances of tests/test_torch_ops.py and
  tests/test_torch_int8.py; K11 at I 136, whose stages run with I
  zero-padded to 144, bit for bit its one-pass twin.
- ``kernel_refusals`` names nothing for any of the repository's 13
  configs, unfused, fused and fused int8.
"""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_exp_tpu.ops import flash_attention as jfa
from vit_exp_tpu.ops import fused_proj as jproj
from vit_exp_tpu.ops import geglu_ff as jff
from vit_exp_tpu_torch.core.config import load_config
from vit_exp_tpu_torch.models.factory import kernel_refusals
from vit_exp_tpu_torch.ops import flash_attention as tfa
from vit_exp_tpu_torch.ops import fused_proj as tproj
from vit_exp_tpu_torch.ops import geglu_ff as tff

ROOT = Path(__file__).resolve().parents[1]
H, N_NULL = 2, 2
HEAD_DIMS = [8, 16, 24, 64]


def _rel(a, b):
    a = np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(jnp.asarray(b, jnp.float32), np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _attn_inputs(seed, nq, nkv, d, logit_scale=2.0):
    """q/k unit-norm times logit_scale, v, nulls (h, 2, d), cotangent."""
    r = np.random.default_rng(seed)
    q = _unit(r.standard_normal((1, H, nq, d))) * np.float32(logit_scale)
    k = _unit(r.standard_normal((1, H, nkv, d))) * np.float32(logit_scale)
    v = r.standard_normal((1, H, nkv, d)).astype(np.float32)
    nk = _unit(r.standard_normal((H, N_NULL, d))) * np.float32(logit_scale)
    nv = r.standard_normal((H, N_NULL, d)).astype(np.float32)
    g = r.standard_normal((1, H, nq, d)).astype(np.float32)
    return q, k, v, nk, nv, g


@pytest.mark.parametrize("route", ["concat", "init"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_attention_twins_match_jax_at_head_dims(d, route):
    """50 queries and keys, 2 nulls: forward and the VJP of q, k, v and the
    nulls, fp32 on both sides, blocks of 32 (a ragged last block)."""
    scale = 1.0 / math.sqrt(d)
    arrays = _attn_inputs(60 + d, 50, 50, d)
    bound = 4.0 * scale   # logit_scale² · scale: bounds every logit

    def jf(q, k, v, nk, nv):
        extra = ({} if route == "concat"
                 else {"logit_bound": jnp.float32(bound)})
        return jfa.flash_attention(
            q, k, v, scale=scale, null_k=nk[None], null_v=nv[None],
            null_strategy=route, block_q=32, block_k=32, interpret=True,
            **extra)

    def tf(q, k, v, nk, nv):
        if route == "concat":
            return tfa.flash_attention_online(q, k, v, scale=scale,
                                              null_k=nk, null_v=nv)
        return tfa.flash_attention(q, k, v, logit_bound=torch.tensor(bound),
                                   scale=scale, null_k=nk, null_v=nv)

    *xs, g = arrays
    out_j, vjp = jax.vjp(jax.jit(jf), *map(jnp.asarray, xs))
    ref = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_() for x in xs]
    out_t = tf(*leaves)
    out_t.backward(torch.from_numpy(g))
    assert out_t.shape == (1, H, 50, d) and _rel(out_t, out_j) < 1e-5
    for name, a, r in zip(("q", "k", "v", "null k", "null v"),
                          (t.grad for t in leaves), ref):
        assert a.shape == r.shape and _rel(a, r) < 1e-5, name


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("d", [8, 24])
def test_padding_to_the_instance_is_exact(d):
    """Each attention twin at the kernel instance's head dim on zero-padded
    operands, sliced to d, gives the twin's bits at d (fp32)."""
    dp = tfa.kernel_head_dim(d)
    q, k, v, nk, nv, g = map(_t, _attn_inputs(70 + d, 40, 37, d))
    scale = 1.0 / math.sqrt(d)
    bound = torch.tensor(4.0 * scale)
    pad = tfa.pad_head
    out, lse = tfa.attention_static_plain(q, k, v, nk, nv, bound, scale,
                                          save_lse=True)
    out_p, lse_p = tfa.attention_static_plain(*(pad(t, dp) for t in (
        q, k, v, nk, nv)), bound, scale, save_lse=True)
    assert out_p.shape[-1] == dp and not out_p[..., d:].any()
    assert torch.equal(out_p[..., :d], out) and torch.equal(lse_p, lse)
    kc, vc = torch.cat([nk[None], k], 2), torch.cat([nv[None], v], 2)
    out, lse = tfa.attention_online_plain(q, kc, vc, scale, save_lse=True)
    out_p, lse_p = tfa.attention_online_plain(
        pad(q, dp), pad(kc, dp), pad(vc, dp), scale, save_lse=True)
    assert torch.equal(out_p[..., :d], out) and torch.equal(lse_p, lse)
    delta = (g * out).sum(-1)
    grads = tfa.attention_bwd_plain(q, kc, vc, g, lse, delta, scale)
    grads_p = tfa.attention_bwd_plain(pad(q, dp), pad(kc, dp), pad(vc, dp),
                                      pad(g, dp), lse, delta, scale)
    for a, b in zip(grads_p, grads):
        assert not a[..., d:].any() and torch.equal(a[..., :d], b)
    d8 = tfa.kernel_head_dim(d, tfa.INT8_HEAD_DIMS)
    q8, k8, qe, qn = tfa.quantize_qk(q, k, scale)
    args = (q8, k8, v, qe, qn, nk, nv, bound)
    out = tfa.attention_static_int8_plain(*args)
    out_p = tfa.attention_static_int8_plain(
        pad(q8, d8), pad(k8, d8), pad(v, d8), qe, qn, pad(nk, d8),
        pad(nv, d8), bound)
    assert torch.equal(out_p[..., :d], out)


def test_instances_and_the_refused_head_dims():
    """Which instance a head dim runs at, and the refusal past 64."""
    assert [tfa.kernel_head_dim(d) for d in (1, 8, 16, 17, 24, 32, 40, 64)] \
        == [16, 16, 16, 32, 32, 32, 64, 64]
    assert [tfa.kernel_head_dim(d, tfa.INT8_HEAD_DIMS)
            for d in (8, 16, 32, 33, 64)] == [32, 32, 32, 64, 64]
    with pytest.raises(ValueError, match="up to 64"):
        tfa.kernel_head_dim(72)
    t = torch.ones(2, 3, 8)
    assert tfa.pad_head(t, 8) is t and tfa.pad_head(None, 16) is None


# the tiny configs' widths
M, D, INNER = 100, 48, 128


def _ff_inputs(seed, m=M, d=D, inner=INNER):
    r = np.random.default_rng(seed)
    x = (r.standard_normal((m, d)) * 2 + 0.3).astype(np.float32)
    gamma = (1 + 0.1 * r.standard_normal(d)).astype(np.float32)
    beta = (0.1 * r.standard_normal(d)).astype(np.float32)
    w1 = (r.standard_normal((d, 2 * inner)) / np.sqrt(d)).astype(np.float32)
    w2 = (r.standard_normal((inner, d)) / np.sqrt(inner)).astype(np.float32)
    return x, gamma, beta, w1, w2


def test_k2_twin_matches_jax_at_the_tiny_widths():
    inputs = _ff_inputs(80)
    x, gamma, beta, w1, w2 = map(jnp.asarray, inputs)
    mu, inv = jff._ln_stats(x, 1e-5)
    ref = jff._ff_fwd_impl(x, mu, inv, gamma, beta, w1, w2, 128, True)
    x, gamma, beta, w1, w2 = map(torch.from_numpy, inputs)
    mu_t, inv_t = tff.ln_stats(x, 1e-5)
    out = tff.geglu_ff(x, mu_t, inv_t, w1 * gamma[:, None], beta @ w1, w2)
    assert out.shape == (M, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_k8_twin_matches_jax_at_the_tiny_widths():
    x, gamma, beta, w1, w2 = _ff_inputs(81)
    mu = x.mean(-1, keepdims=True)
    inv = (1 / np.sqrt(((x - mu) ** 2).mean(-1, keepdims=True) + 1e-5))
    dout = np.random.default_rng(82).standard_normal((M, D)).astype(
        np.float32)
    args = (x, mu.astype(np.float32), inv.astype(np.float32), gamma, beta,
            w1, w2, dout)
    ref = jff._ff_bwd_impl(*map(jnp.asarray, args), 64, True)
    got = tff.geglu_ff_bwd(*(torch.from_numpy(a.copy()) for a in args))
    for name, a, r in zip(("dx", "dW1", "dW2", "dgamma", "dbeta"), got, ref):
        assert a.shape == r.shape and _rel(a, r) < 1e-5, name


@pytest.mark.parametrize("inner", [INNER, 136])
def test_k11_twin_matches_jax_at_the_tiny_widths(inner):
    """I 128, and I 136, which geglu_ff_int8 runs with I zero-padded to a
    multiple of 16 (``k11_weights``: the transposes, padded with zeros at
    scale 1): its output keeps the one-pass twin's bits."""
    inputs = _ff_inputs(83, inner=inner)
    ref = jff.fused_geglu_ff_int8(*map(jnp.asarray, inputs), interpret=True)
    out = tff.fused_geglu_ff_int8(*map(torch.from_numpy, inputs))
    assert out.shape == (M, D) and _rel(out, ref) < 1e-3
    x, gamma, beta, w1, w2 = map(torch.from_numpy, inputs)
    mu, inv = tff.ln_stats(x, 1e-5)
    w1q, s1 = tff.quantize_per_channel(w1)
    w2q, s2 = tff.quantize_per_channel(w2)
    w1t, s1p, w2t = tff.k11_weights(w1q, s1, w2q)
    ip = -(-inner // 16) * 16
    assert w1t.shape == (2 * ip, D) and s1p.shape == (2 * ip,)
    assert w2t.shape == (D, ip) and w2t.is_contiguous()
    for half in (0, 1):
        rows = slice(half * ip, half * ip + inner)
        cols = slice(half * inner, (half + 1) * inner)
        assert torch.equal(w1t[rows], w1q[:, cols].t())
        assert torch.equal(s1p[rows], s1[cols])
        assert not w1t[half * ip + inner:(half + 1) * ip].any()
        assert (s1p[half * ip + inner:(half + 1) * ip] == 1).all()
    assert torch.equal(w2t[:, :inner], w2q.t()) and not w2t[:, inner:].any()
    staged = tff.geglu_ff_int8(x, mu, inv, gamma, beta, w1q, s1, w2q, s2)
    assert torch.equal(staged, tff.geglu_ff_int8_plain(
        x, mu, inv, gamma, beta, w1q, s1, w2q, s2))


def _proj_inputs(seed, m=M, d=D, fq=32, fkv=64):
    r = np.random.default_rng(seed)
    x = (r.standard_normal((m, d)) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * r.standard_normal(d)).astype(np.float32)
    wq = (r.standard_normal((d, fq)) / np.sqrt(d)).astype(np.float32)
    wkv = (r.standard_normal((d, fkv)) / np.sqrt(d)).astype(np.float32)
    return x, gamma, wq, wkv


def test_k3_twin_matches_jax_at_the_tiny_widths():
    inputs = _proj_inputs(84)
    q_j, kv_j = jproj.fused_ln_qkv(*map(jnp.asarray, inputs), interpret=True)
    q_t, kv_t = tproj.fused_ln_qkv(*map(torch.from_numpy, inputs))
    assert q_t.shape == (M, 32) and kv_t.shape == (M, 64)
    np.testing.assert_allclose(q_t.detach().numpy(), np.asarray(q_j),
                               atol=1e-4)
    np.testing.assert_allclose(kv_t.detach().numpy(), np.asarray(kv_j),
                               atol=1e-4)


def test_k12_k13_twin_matches_jax_at_the_tiny_widths():
    """K 48, F 96 with fq = fk = 32: below lane-aligned splits JAX takes
    its two-output form (K12), whose kv the port's route writes as k and
    v."""
    inputs = _proj_inputs(85)
    q_j, kv_j = jproj.fused_ln_qkv_int8(*map(jnp.asarray, inputs),
                                        interpret=True)
    ref = (q_j, kv_j[:, :32], kv_j[:, 32:])
    x, gamma, wq, wkv = map(torch.from_numpy, inputs)
    mu, inv = tff.ln_stats(x, 1e-5)
    w8, sc, c = tproj.int8_qkv_weights(gamma, wq, wkv)
    out = tproj.ln_qkv_int8(x, mu, inv, w8, sc, c, 32, 32)
    for a, b in zip(out, ref):
        assert a.shape == b.shape == (M, 32)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_k14_twin_matches_jax_at_the_tiny_widths():
    """K 32 (4 heads of 8), F 48."""
    r = np.random.default_rng(86)
    x = r.standard_normal((256, 32)).astype(np.float32)
    w = (r.standard_normal((32, 48)) / 6).astype(np.float32)
    ref = jproj.int8_proj(jnp.asarray(x), jnp.asarray(w), interpret=True)
    out = tproj.int8_proj(torch.from_numpy(x), torch.from_numpy(w))
    assert out.shape == (256, 48)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("name", sorted(p.name for p in
                                        (ROOT / "configs").glob("*.yaml")))
def test_no_config_meets_a_kernel_refusal(name):
    arch = load_config(str(ROOT / "configs" / name)).arch
    for fuse_qkv, int8 in ((False, False), (True, False), (True, True)):
        assert kernel_refusals(arch, fuse_qkv=fuse_qkv, int8=int8) == [], \
            (fuse_qkv, int8)


def test_the_refusals_name_each_limit():
    """Widths past the kernels' limits are named with their constraint."""
    from types import SimpleNamespace

    arch = SimpleNamespace(dim=40, heads=4, dim_head=72)
    lines = kernel_refusals(arch, fuse_qkv=True, int8=True)
    assert any("head dims up to 64" in r for r in lines)
    assert any("multiples of 16" in r and "D 40" in r for r in lines)
    assert any(r.startswith("K12/K13") for r in lines)
    assert any(r.startswith("K14") for r in lines)
    assert any(r.startswith("K3") for r in kernel_refusals(arch,
                                                           fuse_qkv=True))
