"""CPU parity of the port's online-softmax attention route (K15 and the
backward pair over a concatenated kv) against the JAX package's
attn_impl="pallas" route: ``flash_attention(..., null_strategy="concat")``
and ``flash_attention_with_lse`` with their Pallas kernels in interpret
mode, on the same seeded numpy inputs.  Everything runs in fp32, so the two
sides differ only in summation order (and in where the running max moves,
which fp32 rounding absorbs).  Tolerances, relative L2:

- 1e-5 on the attention output (one softmax-weighted sum, measured ~1e-7);
- 1e-4 on lse and on every gradient, the nulls' included (a chain of fp32
  products and sums in another order, as tests/test_torch_train.py holds
  the static route's gradients);
- the tiny tower at attn_impl="pallas" to the 1e-4 absolute bound that
  tests/test_torch_models.py holds the serving tower to;
- ``remat=True`` against ``remat=False``: the recomputed forward is the
  same arithmetic on the same inputs, so the gradients agree to fp32
  rounding (rtol 1e-6).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from vit_exp_tpu.core.precision import FP32_POLICY as JAX_FP32
from vit_exp_tpu.models.bert import BertConfig as JaxBertConfig
from vit_exp_tpu.models.ctclip import CTCLIP as JaxCTCLIP
from vit_exp_tpu.models.factory import build_ctclip as jax_build_ctclip
from vit_exp_tpu.ops import attention as jattn
from vit_exp_tpu.ops import flash_attention as jfa

from tests.test_torch_models import DIM_LATENT, jax_params
from vit_exp_tpu_torch.core.precision import FP32_POLICY
from vit_exp_tpu_torch.models.bert import BertConfig
from vit_exp_tpu_torch.models.convert import from_jax_params
from vit_exp_tpu_torch.models.ctvit3d import CosineSelfAttention
from vit_exp_tpu_torch.models.factory import build_ctclip
from vit_exp_tpu_torch.ops import attention as tattn
from vit_exp_tpu_torch.ops import flash_attention as tfa

OUT_TOL = 1e-5
GRAD_TOL = 1e-4
BLOCK = 16


def _rel(a, b):
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _case(nq, nkv, n_null, seed):
    """Unit-norm q/k at a logit scale of 3 (so the running max moves),
    v, nulls (h, n_null, d) and the cotangents."""
    r = np.random.default_rng(seed)
    b, h, d = 2, 3, 8
    q = _unit(r.standard_normal((b, h, nq, d))) * np.float32(3.0)
    k = _unit(r.standard_normal((b, h, nkv, d))) * np.float32(3.0)
    v = r.standard_normal((b, h, nkv, d)).astype(np.float32)
    nk = _unit(r.standard_normal((h, max(n_null, 1), d)))[:, :n_null]
    nv = r.standard_normal((h, max(n_null, 1), d)).astype(np.float32)[:, :n_null]
    g = r.standard_normal((b, h, nq, d)).astype(np.float32)
    glse = r.standard_normal((b, h, nq)).astype(np.float32)
    return q, k, v, nk, nv, g, glse, 1.0 / math.sqrt(d)


def _jax_concat(q, k, v, nk, nv, scale):
    """JAX's attn_impl="pallas" attention: nulls broadcast over the batch
    and concatenated in front of k/v."""
    b = q.shape[0]
    nulls = {}
    if nk.shape[1]:
        nulls = dict(null_k=jnp.broadcast_to(nk[None], (b,) + nk.shape),
                     null_v=jnp.broadcast_to(nv[None], (b,) + nv.shape))
    return jfa.flash_attention(q, k, v, scale=scale, null_strategy="concat",
                               block_q=BLOCK, block_k=BLOCK, interpret=True,
                               **nulls)


# (5, 1, 1): one key behind one null; the forward also at (5, 1, 0), one
# key, the shortest kv K15 takes (its gradients in q and k are rounding
# noise: the softmax of one key is constant)
CASES = [(40, 37, 2), (33, 30, 0), (32, 30, 2), (5, 1, 1)]
FWD_CASES = CASES + [(5, 1, 0)]


@pytest.mark.parametrize("nq,nkv,n_null", FWD_CASES)
def test_online_plain_matches_jax_concat_forward(nq, nkv, n_null):
    """out against flash_attention(null_strategy="concat"); lse against
    flash_attention_with_lse over the same concatenated kv."""
    q, k, v, nk, nv, _, _, scale = _case(nq, nkv, n_null, seed=40)
    ref = _jax_concat(*map(jnp.asarray, (q, k, v, nk, nv)), scale)
    b = q.shape[0]
    kc = np.concatenate([np.broadcast_to(nk[None], (b,) + nk.shape), k], 2)
    vc = np.concatenate([np.broadcast_to(nv[None], (b,) + nv.shape), v], 2)
    _, lse_ref = jfa.flash_attention_with_lse(
        *map(jnp.asarray, (q, kc, vc)), scale=scale, block_q=BLOCK,
        block_k=BLOCK, interpret=True)
    out, lse = tfa.flash_attention_online(
        _t(q), _t(k), _t(v), scale=scale,
        null_k=_t(nk) if n_null else None, null_v=_t(nv) if n_null else None,
        return_lse=True)
    assert out.shape == (2, 3, nq, 8) and lse.shape == (2, 3, nq)
    assert _rel(out, ref) < OUT_TOL
    assert _rel(lse, lse_ref) < GRAD_TOL
    plain = tfa.attention_online_plain(_t(q), _t(kc), _t(vc), scale)
    assert torch.equal(tfa.attention_online(_t(q), _t(kc), _t(vc), scale),
                       plain)


@pytest.mark.parametrize("nq,nkv,n_null", CASES)
def test_online_grads_match_jax_flash_core(nq, nkv, n_null):
    """Gradients in q, k, v and the nulls through OnlineAttention's plain
    twins against the VJP of JAX's _flash_core (the _flash_bwd_concat
    route, or K5's fused sweep where the concatenated kv tiles exactly)."""
    q, k, v, nk, nv, g, _, scale = _case(nq, nkv, n_null, seed=41)
    ref, vjp = jax.vjp(lambda *a: _jax_concat(*a, scale),
                       *map(jnp.asarray, (q, k, v, nk, nv)))
    ref_grads = vjp(jnp.asarray(g))
    leaves = [_t(x).requires_grad_() for x in (q, k, v, nk, nv)]
    out = tfa.flash_attention_online(
        *leaves[:3], scale=scale, null_k=leaves[3] if n_null else None,
        null_v=leaves[4] if n_null else None)
    out.backward(_t(g))
    assert _rel(out, ref) < OUT_TOL
    for t, rg in zip(leaves[:3 + 2 * bool(n_null)], ref_grads):
        assert _rel(t.grad, rg) < GRAD_TOL


def test_online_lse_cotangent_matches_flash_attention_with_lse():
    """(out, lse) both differentiable with no nulls, as ring attention will
    call it: an lse cotangent shifts δ, as in the JAX _flash_core_lse."""
    q, k, v, _, _, g, glse, scale = _case(36, 45, 0, seed=42)

    def jf(q, k, v):
        return jfa.flash_attention_with_lse(q, k, v, scale=scale,
                                            block_q=BLOCK, block_k=BLOCK,
                                            interpret=True)

    (ref, lse_ref), vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    ref_grads = vjp((jnp.asarray(g), jnp.asarray(glse)))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out, lse = tfa.flash_attention_online(*leaves, scale=scale,
                                          return_lse=True)
    torch.autograd.backward((out, lse), (_t(g), _t(glse)))
    assert _rel(out, ref) < OUT_TOL and _rel(lse, lse_ref) < GRAD_TOL
    for t, rg in zip(leaves, ref_grads):
        assert _rel(t.grad, rg) < GRAD_TOL


def test_cosine_attention_online_matches_jax_pallas():
    """cosine_attention(static_max=False): the nulls l2-normed and
    k-scaled in k's dtype, prepended, then K15's route; gradients reach the
    q/k scales and the nulls."""
    r = np.random.default_rng(43)
    b, h, n, d = 2, 3, 40, 8
    q, k, v = (r.standard_normal((b, h, n, d)).astype(np.float32)
               for _ in range(3))
    nk, nv = (r.standard_normal((h, 2, d)).astype(np.float32)
              for _ in range(2))
    qs, ks = ((1 + 0.3 * r.standard_normal(d)).astype(np.float32)
              for _ in range(2))
    g = r.standard_normal((b, h, n, d)).astype(np.float32)

    def jf(q, k, v, nk, nv, qs, ks):
        return jattn.cosine_attention(q, k, v, null_k=nk, null_v=nv,
                                      q_scale=qs, k_scale=ks, impl="pallas",
                                      static_max=False)

    ref, vjp = jax.vjp(jax.jit(jf),
                       *map(jnp.asarray, (q, k, v, nk, nv, qs, ks)))
    ref_grads = vjp(jnp.asarray(g))
    leaves = [_t(x).requires_grad_() for x in (q, k, v, nk, nv, qs, ks)]
    out = tattn.cosine_attention(*leaves[:3], null_k=leaves[3],
                                 null_v=leaves[4], q_scale=leaves[5],
                                 k_scale=leaves[6], static_max=False)
    out.backward(_t(g))
    assert _rel(out, ref) < OUT_TOL
    for t, rg in zip(leaves, ref_grads):
        assert _rel(t.grad, rg) < GRAD_TOL


def test_attn_impl_choices():
    assert CosineSelfAttention(16, 2, 8, attn_impl="pallas").static_max is False
    assert CosineSelfAttention(16, 2, 8).static_max is True
    with pytest.raises(ValueError):
        CosineSelfAttention(16, 2, 8, attn_impl="pallas", int8=True)
    with pytest.raises(ValueError):
        CosineSelfAttention(16, 2, 8, attn_impl="xla")
    with pytest.raises(ValueError):
        tattn.cosine_attention(*(torch.zeros(1, 1, 4, 8) for _ in range(3)),
                               static_max=False, quantized=True)


@pytest.fixture(scope="module")
def tiny():
    config = _flagship_config(tiny=True)
    params = jax_params(config, seed=11)
    video = np.random.default_rng(12).standard_normal(
        (2, 1, 16, 32, 32)).astype(np.float32)
    return config, params, video


def _port(config, params, **kw):
    model = build_ctclip(config, BertConfig.tiny(), device="cpu",
                         policy=FP32_POLICY, dim_latent=DIM_LATENT, **kw)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in from_jax_params(params).items()})
    return model


def test_tiny_tower_pallas_matches_jax(tiny):
    config, params, video = tiny
    jmodel = jax_build_ctclip(config, bert_config=JaxBertConfig.tiny(),
                              policy=JAX_FP32, dim_latent=DIM_LATENT,
                              attn_impl="pallas", ff_impl="pallas")
    ref = np.asarray(jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, method=JaxCTCLIP.encode_image_tokens))(
            params, jnp.asarray(video)))
    model = _port(config, params, attn_impl="pallas")
    with torch.no_grad():
        out = model.encode_image_tokens(torch.from_numpy(video))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


def test_remat_gives_the_gradients_of_no_remat(tiny):
    config, params, video = tiny
    cot = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (2, 4, 4, 4, 48)).astype(np.float32))
    grads = []
    for remat in (False, True):
        model = _port(config, params, attn_impl="pallas", remat=remat)
        tower = model.visual_transformer
        tokens = tower(torch.from_numpy(video))
        tokens.backward(cot)
        grads.append({n: p.grad for n, p in tower.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for n, g in grads[0].items():
        assert g is not None and torch.count_nonzero(g) > 0, n
        torch.testing.assert_close(grads[1][n], g, rtol=1e-6, atol=0, msg=n)
