"""CPU parity of the PyTorch port's ops against the JAX package.

The same inputs, made with numpy from a seed, go through the JAX function
and its counterpart in ``vit_exp_tpu_torch``.  On the CPU each kernel
wrapper of the port takes its plain PyTorch version; on the JAX side the
Pallas kernels run in interpret mode, as the JAX package's own tests run
them.  Tolerances (fp32 unless stated):

- 1e-4 absolute on op outputs of order one: both sides compute in fp32 but
  sum in different orders (blocked matmuls, Pallas block accumulation);
- 0 (bit-exact) for the position table and the patch reshape, which are the
  same numpy/reshape ops.

The patch statistics and the fused patch embedding's kernel twin and
backward are held to JAX in tests/test_torch_patch_embed.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_exp_tpu.ops import attention as jattn
from vit_exp_tpu.ops import flash_attention as jfa
from vit_exp_tpu.ops import fused_proj as jproj
from vit_exp_tpu.ops import geglu_ff as jff
from vit_exp_tpu.ops import patches as jpatch
from vit_exp_tpu.ops import posemb as jpos

from vit_exp_tpu_torch.ops import attention as tattn
from vit_exp_tpu_torch.ops import flash_attention as tfa
from vit_exp_tpu_torch.ops import fused_proj as tproj
from vit_exp_tpu_torch.ops import geglu_ff as tff
from vit_exp_tpu_torch.ops import patches as tpatch
from vit_exp_tpu_torch.ops import posemb as tpos

ATOL = 1e-4


def _rng(seed):
    return np.random.default_rng(seed)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("dim,grid", [(48, (4, 4, 4)), (12, (2, 3, 5)),
                                      (768, (24, 24, 24))])
def test_sincos_pos_embed_bit_exact(dim, grid):
    np.testing.assert_array_equal(tpos.sincos_pos_embed_3d(dim, grid),
                                  jpos.sincos_pos_embed_3d(dim, grid))


@pytest.mark.parametrize("c", [1, 2])
def test_patchify_3d_matches(c):
    v = _rng(0).standard_normal((2, c, 8, 12, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tpatch.patchify_3d(torch.from_numpy(v), 4, 4, 8)),
        np.asarray(jpatch.patchify_3d(jnp.asarray(v), 4, 4, 8)))


def _patch_inputs(seed, c=1, pt=4, p=8, d=48):
    r = _rng(seed)
    n = c * pt * p * p
    video = r.standard_normal((2, c, 2 * pt, 2 * p, 3 * p)).astype(np.float32)
    gamma = (1 + 0.1 * r.standard_normal(n)).astype(np.float32)
    beta = (0.1 * r.standard_normal(n)).astype(np.float32)
    kernel = (r.standard_normal((n, d)) / np.sqrt(n)).astype(np.float32)
    bias = (0.1 * r.standard_normal(d)).astype(np.float32)
    return video, gamma, beta, kernel, bias


@pytest.mark.parametrize("c", [1, 2])
def test_fused_patch_embed_matches_pallas_stats(c):
    video, gamma, beta, kernel, bias = _patch_inputs(2, c=c)
    ref = jpatch.fused_patch_embed(
        *map(jnp.asarray, (video, gamma, beta, kernel, bias)), 4, 8, 8,
        compute_dtype=jnp.float32, stats_impl="pallas")
    out = tpatch.fused_patch_embed(
        *map(torch.from_numpy, (video, gamma, beta, kernel, bias)), 4, 8, 8,
        compute_dtype=torch.float32)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=ATOL)


def test_fused_patch_embed_matches_patchify_ln_dense():
    video, gamma, beta, kernel, bias = _patch_inputs(3)
    x = jpatch.patchify_3d(jnp.asarray(video), 4, 8, 8)
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    ref = ((x - mu) / jnp.sqrt(var + 1e-5) * gamma + beta) @ kernel + bias
    out = tpatch.fused_patch_embed(
        *map(torch.from_numpy, (video, gamma, beta, kernel, bias)), 4, 8, 8,
        compute_dtype=torch.float32)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=ATOL)


def test_ln_stats_matches():
    x = _rng(4).standard_normal((10, 48)).astype(np.float32) * 3 + 1
    mu_j, inv_j = jff._ln_stats(jnp.asarray(x), 1e-5)
    mu_t, inv_t = tff.ln_stats(torch.from_numpy(x), 1e-5)
    np.testing.assert_allclose(_np(mu_t), np.asarray(mu_j), atol=1e-6)
    np.testing.assert_allclose(_np(inv_t), np.asarray(inv_j), rtol=1e-5)


@pytest.mark.parametrize("m", [40, 300])
def test_fused_geglu_ff_k2_matches_pallas(m):
    r = _rng(5)
    d, inner = 48, 32
    x = r.standard_normal((m, d)).astype(np.float32)
    gamma = (1 + 0.1 * r.standard_normal(d)).astype(np.float32)
    beta = (0.1 * r.standard_normal(d)).astype(np.float32)
    w1 = (r.standard_normal((d, 2 * inner)) / np.sqrt(d)).astype(np.float32)
    w2 = (r.standard_normal((inner, d)) / np.sqrt(inner)).astype(np.float32)
    ref = jff.fused_geglu_ff(*map(jnp.asarray, (x, gamma, beta, w1, w2)),
                             interpret=True)
    out = tff.fused_geglu_ff(*map(torch.from_numpy, (x, gamma, beta, w1, w2)))
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("m", [40, 300])
def test_fused_ln_qkv_k3_matches_pallas(m):
    r = _rng(6)
    d, fq = 48, 32
    x = (r.standard_normal((m, d)) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * r.standard_normal(d)).astype(np.float32)
    wq = (r.standard_normal((d, fq)) / np.sqrt(d)).astype(np.float32)
    wkv = (r.standard_normal((d, 2 * fq)) / np.sqrt(d)).astype(np.float32)
    q_j, kv_j = jproj.fused_ln_qkv(*map(jnp.asarray, (x, gamma, wq, wkv)),
                                   interpret=True)
    q_t, kv_t = tproj.fused_ln_qkv(*map(torch.from_numpy, (x, gamma, wq, wkv)))
    np.testing.assert_allclose(_np(q_t), np.asarray(q_j), atol=ATOL)
    np.testing.assert_allclose(_np(kv_t), np.asarray(kv_j), atol=ATOL)


def test_fused_ln_qkv_bf16_rounds_as_pallas():
    """bf16: the same rounding points, so outputs agree to bf16 resolution
    (relative 1e-2: one bf16 ulp is 2⁻⁸ ≈ 4e-3 relative)."""
    r = _rng(7)
    d, fq = 48, 32
    x = r.standard_normal((64, d)).astype(np.float32)
    gamma = (1 + 0.1 * r.standard_normal(d)).astype(np.float32)
    wq = (r.standard_normal((d, fq)) / np.sqrt(d)).astype(np.float32)
    wkv = (r.standard_normal((d, 2 * fq)) / np.sqrt(d)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    q_j, _ = jproj.fused_ln_qkv(jx, *map(jnp.asarray, (gamma, wq, wkv)),
                                interpret=True)
    q_t, _ = tproj.fused_ln_qkv(
        torch.tensor(np.array(jx.astype(jnp.float32))).bfloat16(),
        *map(torch.from_numpy, (gamma, wq, wkv)))
    q_j = np.asarray(q_j.astype(jnp.float32))
    rel = np.linalg.norm(_np(q_t) - q_j) / np.linalg.norm(q_j)
    assert rel < 1e-2, rel


def _attn_inputs(seed, b=2, h=3, n=40, d=8, n_null=2):
    r = _rng(seed)
    q, k, v = (r.standard_normal((b, h, n, d)).astype(np.float32)
               for _ in range(3))
    null_k, null_v = (r.standard_normal((h, n_null, d)).astype(np.float32)
                      for _ in range(2))
    q_scale = (1 + 0.3 * r.standard_normal(d)).astype(np.float32)
    k_scale = (1 + 0.3 * r.standard_normal(d)).astype(np.float32)
    return q, k, v, null_k, null_v, q_scale, k_scale


def test_l2norm_matches():
    x = _rng(8).standard_normal((5, 7)).astype(np.float32)
    x[0] = 0.0   # the eps clamp
    np.testing.assert_allclose(_np(tattn.l2norm(torch.from_numpy(x))),
                               np.asarray(jattn.l2norm(jnp.asarray(x))),
                               atol=1e-7)


# (1, 1): one key and one null, the edges of K1's kv loop and null tile
@pytest.mark.parametrize("n,n_null", [(40, 2), (64, 0), (13, 8), (1, 1)])
def test_flash_attention_k1_matches_pallas_static(n, n_null):
    q, k, v, null_k, null_v, *_ = _attn_inputs(9, n=n, n_null=max(n_null, 1))
    null_k, null_v = null_k[:, :n_null], null_v[:, :n_null]
    qn, kn = (x / np.linalg.norm(x, axis=-1, keepdims=True) for x in (q, k))
    scale = 1.0 / math.sqrt(q.shape[-1])
    bound = np.float32(scale)
    b = q.shape[0]
    jnull = {}
    if n_null:
        jnull = dict(null_k=jnp.broadcast_to(jnp.asarray(null_k)[None],
                                             (b,) + null_k.shape),
                     null_v=jnp.broadcast_to(jnp.asarray(null_v)[None],
                                             (b,) + null_v.shape))
    ref = jfa.flash_attention(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(v), scale=scale,
        logit_bound=jnp.asarray(bound), null_strategy="init",
        interpret=True, **jnull)
    tnull = {}
    if n_null:
        tnull = dict(null_k=torch.from_numpy(null_k),
                     null_v=torch.from_numpy(null_v))
    out = tfa.flash_attention(
        *map(torch.from_numpy, (qn, kn, v)), scale=scale,
        logit_bound=torch.tensor(bound), **tnull)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=ATOL)


def test_cosine_attention_matches_xla():
    q, k, v, null_k, null_v, q_scale, k_scale = _attn_inputs(10)
    ref = jattn.cosine_attention(
        *map(jnp.asarray, (q, k, v)), null_k=jnp.asarray(null_k),
        null_v=jnp.asarray(null_v), q_scale=jnp.asarray(q_scale),
        k_scale=jnp.asarray(k_scale), impl="xla")
    out = tattn.cosine_attention(
        *map(torch.from_numpy, (q, k, v)), null_k=torch.from_numpy(null_k),
        null_v=torch.from_numpy(null_v), q_scale=torch.from_numpy(q_scale),
        k_scale=torch.from_numpy(k_scale))
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=ATOL)


def test_logit_bound_bounds_every_logit():
    q, k, _, null_k, _, q_scale, k_scale = _attn_inputs(11)
    scale = 1.0 / math.sqrt(q.shape[-1])
    bound = tattn.logit_bound(torch.from_numpy(q_scale),
                              torch.from_numpy(k_scale), scale)
    qn = tattn.l2norm(torch.from_numpy(q)) * torch.from_numpy(q_scale)
    kn = tattn.l2norm(torch.from_numpy(k)) * torch.from_numpy(k_scale)
    logits = qn @ kn.transpose(-1, -2) * scale
    assert bound.shape == () and bound.dtype == torch.float32
    assert float(logits.max()) <= float(bound) + 1e-6


def test_wrappers_take_the_plain_path_on_cpu_without_counting():
    """On CPU tensors each kernel wrapper runs its plain version and its
    launch counter does not move."""
    counters = (tfa.attention_static, tff.geglu_ff_x, tff.geglu_ff_h,
                tff.geglu_ff_o, tproj.ln_qkv, tpatch.patch_embed)
    before = [fn.launches for fn in counters]
    r = _rng(12)
    q = torch.from_numpy(r.standard_normal((1, 2, 8, 32)).astype(np.float32))
    nk = torch.zeros(2, 1, 32)
    out = tfa.attention_static(q, q, q, nk, nk, torch.tensor(0.2), 0.2)
    torch.testing.assert_close(
        out, tfa.attention_static_plain(q, q, q, nk, nk, torch.tensor(0.2), 0.2))
    x = torch.randn(16, 48)
    mu, inv = tff.ln_stats(x, 1e-5)
    tff.geglu_ff(x, mu, inv, torch.randn(48, 64), torch.zeros(64),
                 torch.randn(32, 48))
    tproj.ln_qkv(x, mu, inv, torch.randn(48, 96), torch.zeros(96), 32)
    tpatch.patch_embed(torch.randn(2, 4, 16, 16), torch.randn(128, 256),
                       torch.randn(128), torch.randn(128), 8, 8, 1e-5)
    assert [fn.launches for fn in counters] == before == [0] * 6


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    never silently run through the plain version."""
    x = torch.empty(2, 4, 16, 16, device="meta")
    with pytest.raises(ValueError):
        tpatch.patch_embed(x, torch.empty(128, 256, device="meta"),
                           torch.empty(128, device="meta"),
                           torch.empty(128, device="meta"), 8, 8, 1e-5)
