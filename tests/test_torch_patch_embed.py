"""CPU parity of the port's fused patch embedding (``ops/patches.py``:
``patch_embed`` and its plain twin, ``PatchEmbedFn``) against the JAX
package's ``fused_patch_embed`` with ``stats_impl="pallas"``, whose
statistics kernel K4 (``_patch_stats_pallas``) runs in interpret mode.

The same inputs, made with numpy from a seed, go through both; on the CPU
the port's wrapper takes its plain twin.  Tolerances:

- the patch statistics: 1e-5 relative (fp32 sums of the same values in
  another order);
- the tokens under fp32: relative L2 1e-5 (fp32 products summed in another
  order by the two convolutions);
- the tokens under bf16: one bf16 step of each reference value (both sides
  round the same fp32 value, up to summation order, once);
- the gradients of γ, β, W and b under fp32: relative L2 1e-5 (the weight
  gradient of the strided product summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_exp_tpu.ops import patches as jpatch

from vit_exp_tpu_torch.ops import patches as tpatch

# (c, pt, p1, p2): one and two channels, square and non-square patches
SHAPES = [(1, 4, 8, 8), (2, 2, 6, 6), (1, 3, 8, 6), (2, 4, 6, 8)]
D = 64


def _rng(seed):
    return np.random.default_rng(seed)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _inputs(seed, c, pt, p1, p2, d=D):
    """video (2, c, 2·pt, 2·p1, 3·p2) and the LN + Linear weights."""
    r = _rng(seed)
    n = c * pt * p1 * p2
    video = (r.standard_normal((2, c, 2 * pt, 2 * p1, 3 * p2)) + 0.3).astype(
        np.float32)
    gamma = (1 + 0.1 * r.standard_normal(n)).astype(np.float32)
    beta = (0.1 * r.standard_normal(n)).astype(np.float32)
    kernel = (r.standard_normal((n, d)) / np.sqrt(n)).astype(np.float32)
    bias = (0.1 * r.standard_normal(d)).astype(np.float32)
    return video, gamma, beta, kernel, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cpt,p1,p2", [(4, 8, 6), (6, 6, 8)])
def test_patch_stats_k4_matches_pallas(dtype, cpt, p1, p2):
    x = _rng(1).standard_normal((3, cpt, 2 * p1, 4 * p2)).astype(
        np.float32) + 0.5
    jx = jnp.asarray(x, dtype)
    tx = torch.tensor(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    mu_j, sq_j = jpatch._patch_stats_pallas(jx, cpt, p1, p2, True)
    mu_t, sq_t = tpatch.patch_stats_plain(tx, p1, p2)
    np.testing.assert_allclose(_np(mu_t), np.asarray(mu_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np(sq_t), np.asarray(sq_j), rtol=1e-5)


def _jax_embed(args, pt, p1, p2, dtype):
    return jpatch.fused_patch_embed(*map(jnp.asarray, args), pt, p1, p2,
                                    compute_dtype=dtype, stats_impl="pallas")


@pytest.mark.parametrize("c,pt,p1,p2", SHAPES)
def test_patch_embed_plain_matches_pallas_fp32(c, pt, p1, p2):
    args = _inputs(2, c, pt, p1, p2)
    ref = np.asarray(_jax_embed(args, pt, p1, p2, jnp.float32))
    for use_kernel in (False, True):   # the wrapper takes the twin on CPU
        out = tpatch.fused_patch_embed(
            *map(torch.from_numpy, args), pt, p1, p2,
            compute_dtype=torch.float32, use_kernel=use_kernel)
        assert out.shape == ref.shape == (2, 2, 2, 3, D)
        assert _rel(out, ref) < 1e-5


@pytest.mark.parametrize("c,pt,p1,p2", SHAPES)
def test_patch_embed_plain_matches_pallas_bf16(c, pt, p1, p2):
    args = _inputs(3, c, pt, p1, p2)
    ref = np.asarray(_jax_embed(args, pt, p1, p2, jnp.bfloat16).astype(
        jnp.float32))
    out = tpatch.fused_patch_embed(*map(torch.from_numpy, args), pt, p1, p2,
                                   compute_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert (np.abs(_np(out) - ref) <= step).all()


@pytest.mark.parametrize("c,pt,p1,p2", SHAPES)
def test_patch_embed_grads_match_jax(c, pt, p1, p2):
    """γ, β, W and b through PatchEmbedFn's explicit backward against
    jax.grad of JAX's fused_patch_embed (its _conv_f32 VJP casts the
    cotangent to the compute dtype; fp32 here)."""
    video, *params = _inputs(4, c, pt, p1, p2)
    cot = _rng(5).standard_normal((2, 2, 2, 3, D)).astype(np.float32)

    def loss(*p):
        out = jpatch.fused_patch_embed(jnp.asarray(video), *p, pt, p1, p2,
                                       compute_dtype=jnp.float32,
                                       stats_impl="pallas")
        return jnp.sum(out * cot)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, params))
    leaves = [torch.tensor(p).requires_grad_() for p in params]
    out = tpatch.fused_patch_embed(torch.from_numpy(video), *leaves, pt, p1,
                                   p2, compute_dtype=torch.float32)
    out.backward(torch.from_numpy(cot))
    for leaf, g in zip(leaves, ref):
        assert _rel(leaf.grad, g) < 1e-5


def test_patch_embed_backward_passes_gradcheck():
    """PatchEmbedFn's backward in fp64 against finite differences of its
    plain forward, in kc, csum and dvec."""
    r = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 8, 12, dtype=torch.float64, generator=r)
    ins = [torch.randn(5, 3 * 4 * 6, dtype=torch.float64, generator=r) / 8,
           torch.randn(5, dtype=torch.float64, generator=r),
           torch.randn(5, dtype=torch.float64, generator=r)]
    assert torch.autograd.gradcheck(
        lambda kc, cs, dv: tpatch.PatchEmbedFn.apply(x, kc, cs, dv, 4, 6,
                                                     1e-5, False),
        [t.requires_grad_() for t in ins])


def test_patch_embed_backward_does_not_rerun_the_product(monkeypatch):
    """The backward reads the saved statistics: neither the forward nor its
    strided product runs again."""
    video, *params = _inputs(6, 1, 4, 8, 8)
    leaves = [torch.tensor(p).requires_grad_() for p in params]
    out = tpatch.fused_patch_embed(torch.from_numpy(video), *leaves, 4, 8, 8,
                                   compute_dtype=torch.float32)

    def refuse(*args, **kwargs):
        raise AssertionError("the backward re-ran the forward")

    for name in ("_conv_f32", "patch_embed_plain", "patch_embed",
                 "patch_stats_plain"):
        monkeypatch.setattr(tpatch, name, refuse)
    out.sum().backward()
    assert all(t.grad is not None for t in leaves)
