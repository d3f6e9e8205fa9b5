"""CPU parity of the port's legacy CTViT pieces against the JAX package, on
the same numpy inputs and JAX's own parameters (carried across by
models/convert.py), at tiny shapes and the fp32 policy:

- the plain attention route (``xla=True``) with a mask, a bias, nulls and
  a context against JAX ``cosine_attention(impl="xla")`` and the
  cross-attention module: 1e-5 absolute on outputs of order one;
- ALiBi slopes and bias: 1e-7; the packed front against the heads-first
  route on the same tensors: bit for bit;
- PEG and the continuous position bias: 1e-5;
- CTViT encode, quantize (the indices equal) and decode: 1e-5;
- one VQ EMA update (counts, sums, codes) and its straight-through
  gradient: 1e-5;
- the round trip through JAX's ``convert_ctvit_state_dict``: exact.
"""

import functools

import flax.linen as nn_flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_exp_tpu.core.precision import FP32_POLICY as JAX_FP32
from vit_exp_tpu.models import ctvit as jctvit
from vit_exp_tpu.models import vq as jvq
from vit_exp_tpu.models.convert import convert_ctvit_state_dict
from vit_exp_tpu.models.ctvit3d import CosineSelfAttention as JaxAttention
from vit_exp_tpu.ops import attention as jattn

from vit_exp_tpu_torch.core.precision import FP32_POLICY
from vit_exp_tpu_torch.models import ctvit as tctvit
from vit_exp_tpu_torch.models.convert import from_jax_ctvit_variables
from vit_exp_tpu_torch.models.ctvit3d import CosineSelfAttention
from vit_exp_tpu_torch.models.factory import init_parameters_
from vit_exp_tpu_torch.models.vq import VectorQuantize
from vit_exp_tpu_torch.ops import attention as tattn

ATOL = 1e-5
TINY = dict(dim=16, codebook_size=32, image_size=8, patch_size=4,
            temporal_patch_size=2, spatial_depth=1, temporal_depth=1,
            dim_head=4, heads=2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, nn_flax.unbox(tree))


def _t(x):
    return torch.from_numpy(np.array(x))


def _load(module, sd):
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, strict=True)
    return module


def jax_ctvit(video):
    model = jctvit.CTViT(**TINY, policy=JAX_FP32)
    init = jax.jit(functools.partial(model.init, return_encoded_tokens=False,
                                     return_recons=True))
    return model, _np(init(jax.random.PRNGKey(0), jnp.asarray(video)))


def port_ctvit(variables):
    model = tctvit.CTViT(**TINY, policy=FP32_POLICY, device="cpu")
    return _load(model, from_jax_ctvit_variables(variables))


def _video(seed=0, b=2):
    return np.random.default_rng(seed).normal(
        size=(b, 1, 5, 8, 8)).astype(np.float32)


@pytest.mark.parametrize("n_null,masked,biased,cross", [
    (0, False, True, False), (2, True, False, False), (2, True, True, False),
    (3, True, True, True), (0, True, False, True)])
def test_plain_route_matches_jax_xla(n_null, masked, biased, cross):
    r = np.random.default_rng(n_null + 2 * masked + 4 * biased + 8 * cross)
    b, h, n, d = 2, 3, 7, 8
    m = 5 if cross else n

    def f(*shape):
        return r.normal(size=shape).astype(np.float32)

    q, k, v = f(b, h, n, d), f(b, h, m, d), f(b, h, m, d)
    nk, nv = f(h, n_null, d), f(h, n_null, d)
    qs, ks = f(d) + 1.0, f(d) + 1.0
    mask = bias = None
    if masked:
        mask = r.uniform(size=(b, 1, 1, m)) > 0.3
        mask[:, ..., 0] = True
    if biased:
        bias = f(1, h, n, m)
    ref = jattn.cosine_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        null_k=jnp.asarray(nk), null_v=jnp.asarray(nv),
        q_scale=jnp.asarray(qs), k_scale=jnp.asarray(ks), scale=8.0,
        mask=None if mask is None else jnp.asarray(mask),
        attn_bias=None if bias is None else jnp.asarray(bias), impl="xla")
    out = tattn.cosine_attention(
        _t(q), _t(k), _t(v), null_k=_t(nk), null_v=_t(nv), q_scale=_t(qs),
        k_scale=_t(ks), scale=8.0,
        mask=None if mask is None else _t(mask),
        attn_bias=None if bias is None else _t(bias), xla=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    if mask is not None:
        with pytest.raises(NotImplementedError):
            tattn.cosine_attention(_t(q), _t(k), _t(v), mask=_t(mask))


@pytest.mark.parametrize("heads", [8, 6])
def test_alibi_and_the_packed_front(heads):
    np.testing.assert_allclose(tattn.alibi_slopes(heads).numpy(),
                               np.asarray(jattn.alibi_slopes(heads)),
                               atol=1e-7)
    np.testing.assert_allclose(tattn.alibi_bias(heads, 5, 9).numpy(),
                               np.asarray(jattn.alibi_bias(heads, 5, 9)),
                               atol=1e-7)
    r = np.random.default_rng(heads)
    b, n, d = 2, 6, 4
    q, k, v = (_t(r.normal(size=(b, n, heads * d)).astype(np.float32))
               for _ in range(3))
    nk, nv = (_t(r.normal(size=(heads, 2, d)).astype(np.float32))
              for _ in range(2))
    out = tattn.cosine_attention_packed(q, k, torch.cat([k, v], -1), heads,
                                        null_k=nk, null_v=nv)

    def heads_first(t):
        return t.reshape(b, n, heads, d).transpose(1, 2)

    ref = tattn.cosine_attention(heads_first(q), heads_first(k),
                                 heads_first(v), null_k=nk, null_v=nv)
    assert torch.equal(out, ref.transpose(1, 2).reshape(b, n, heads * d))
    # an ALiBi bias on the plain route, against JAX's
    qh, kh, vh = (np.asarray(heads_first(t)) for t in (q, k, v))
    bias = jattn.alibi_bias(heads, n, n)
    ref = jattn.cosine_attention(jnp.asarray(qh), jnp.asarray(kh),
                                 jnp.asarray(vh), attn_bias=bias, impl="xla")
    out = tattn.cosine_attention(_t(qh), _t(kh), _t(vh),
                                 attn_bias=tattn.alibi_bias(heads, n, n),
                                 xla=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_cross_attention_module_matches_jax():
    r = np.random.default_rng(3)
    x = r.normal(size=(2, 6, 16)).astype(np.float32)
    ctx = r.normal(size=(2, 4, 16)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    jmod = JaxAttention(dim=16, heads=2, dim_head=8, policy=JAX_FP32)
    params = _np(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x),
                           context=jnp.asarray(ctx),
                           mask=jnp.asarray(mask)[:, None, None]))["params"]
    ref = jmod.apply({"params": params}, jnp.asarray(x),
                     context=jnp.asarray(ctx),
                     mask=jnp.asarray(mask)[:, None, None])
    from vit_exp_tpu_torch.models.convert import _cosine_attention_state

    mod = CosineSelfAttention(16, 2, 8, policy=FP32_POLICY, use_kernels=False,
                              attn_impl="xla", dim_context=16, device="cpu")
    _load(mod, _cosine_attention_state(params, ""))
    out = mod(_t(x), context=_t(ctx), mask=_t(mask)[:, None, None])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL)
    with pytest.raises(ValueError):
        CosineSelfAttention(16, 2, 8, attn_impl="xla", device="cpu")


@pytest.mark.parametrize("causal", [True, False])
def test_peg_and_position_bias_match_jax(causal):
    r = np.random.default_rng(int(causal))
    b, t, h, w, d = 2, 3, 2, 4, 8
    x = r.normal(size=(b * t, h * w, d)).astype(np.float32)
    jpeg = jctvit.PEG(d, causal=causal, policy=JAX_FP32)
    params = _np(jpeg.init(jax.random.PRNGKey(2), jnp.asarray(x),
                           (b, t, h, w)))["params"]
    ref = jpeg.apply({"params": params}, jnp.asarray(x), (b, t, h, w))
    from vit_exp_tpu_torch.models.convert import _conv_weight

    peg = tctvit.PEG(d, causal=causal, policy=FP32_POLICY, device="cpu")
    _load(peg, {"dsconv.weight": _conv_weight(params["dsconv"]["kernel"]),
                "dsconv.bias": params["dsconv"]["bias"]})
    out = peg(_t(x), (b, t, h, w))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL)
    jcpb = jctvit.ContinuousPositionBias(dim=d, heads=3, policy=JAX_FP32)
    params = _np(jcpb.init(jax.random.PRNGKey(3), h, w))["params"]
    ref = jcpb.apply({"params": params}, h, w)
    from vit_exp_tpu_torch.models.convert import _linear_state

    cpb = tctvit.ContinuousPositionBias(d, 3, policy=FP32_POLICY,
                                        device="cpu")
    sd = {**_linear_state(params["net0"], "net.0.0."),
          **_linear_state(params["net1"], "net.1.0."),
          **_linear_state(params["to_bias"], "net.2.")}
    out = _load(cpb, sd)(h, w)
    assert out.shape == (1, 3, h * w, h * w)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL)


def test_ctvit_encode_quantize_decode_match_jax():
    video = _video()
    jmodel, variables = jax_ctvit(video)
    model = port_ctvit(variables)
    enc_ref = jmodel.apply(variables, jnp.asarray(video))
    enc = model(_t(video))
    assert enc.shape == (2, 3, 2, 2, 16)
    np.testing.assert_allclose(enc.detach().numpy(), np.asarray(enc_ref),
                               atol=ATOL)
    (recon_ref, idx_ref, commit_ref), _ = jmodel.apply(
        variables, jnp.asarray(video), return_encoded_tokens=False,
        return_recons=True, mutable=["codebook"])
    recon, idx, commit = model(_t(video), return_encoded_tokens=False,
                               return_recons=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_allclose(recon.detach().numpy(), np.asarray(recon_ref),
                               atol=ATOL)
    np.testing.assert_allclose(commit.item(), float(commit_ref), atol=ATOL)
    dec_ref = jmodel.apply(variables, idx_ref,
                           method=jctvit.CTViT.decode_from_indices)
    dec = model.decode_from_indices(idx)
    np.testing.assert_allclose(dec.detach().numpy(), np.asarray(dec_ref),
                               atol=ATOL)


def test_vq_ema_update_and_straight_through_match_jax():
    r = np.random.default_rng(5)
    x = r.normal(size=(4, 10, 8)).astype(np.float32)
    jmod = jvq.VectorQuantize(dim=8, codebook_size=16)
    variables = _np(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    (q_ref, idx_ref, commit_ref), new = jmod.apply(
        variables, jnp.asarray(x), update_codebook=True,
        mutable=["codebook"])
    grad_ref = jax.grad(lambda xx: jnp.sum(jmod.apply(
        variables, xx, mutable=["codebook"])[0][0] ** 3))(jnp.asarray(x))
    cb = variables["codebook"]
    vq = VectorQuantize(8, 16, device="cpu")
    vq.load_state_dict({
        "_codebook.embed": _t(cb["codes"]),             # ungrouped layout
        "_codebook.cluster_size": _t(cb["counts"]),
        "_codebook.embed_avg": _t(cb["embed_sum"]),
        "_codebook.initted": torch.ones(())})
    xt = _t(x).requires_grad_(True)
    q, idx, commit = vq(xt, update_codebook=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(q_ref),
                               atol=ATOL)
    np.testing.assert_allclose(commit.item(), float(commit_ref), atol=ATOL)
    new = _np(new)["codebook"]
    for ours, theirs in ((vq.counts, "counts"), (vq.embed_sum, "embed_sum"),
                         (vq.codes, "codes")):
        np.testing.assert_allclose(ours.numpy(), new[theirs], atol=ATOL)
    vq.load_state_dict({"_codebook.embed": _t(cb["codes"])[None],
                        "_codebook.cluster_size": _t(cb["counts"])[None],
                        "_codebook.embed_avg": _t(cb["embed_sum"])[None]})
    (vq(xt)[0] ** 3).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(grad_ref),
                               atol=ATOL)
    rows = vq.codes_from_indices(idx)
    np.testing.assert_allclose(rows.norm(dim=-1).numpy(), 1.0, atol=1e-6)


def test_state_dict_round_trip_through_jax_converter_is_exact():
    model = tctvit.CTViT(**TINY, policy=FP32_POLICY, device="cpu")
    init_parameters_(model, seed=4)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    variables = convert_ctvit_state_dict(sd, spatial_depth=1,
                                         temporal_depth=1)
    back = from_jax_ctvit_variables(variables)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert np.array_equal(back[k], v.numpy()), k
    # a reference state dict: "module." prefixed, with the zero βs and the
    # unused context norms the reference registers
    ref = {"module." + k: v for k, v in sd.items()}
    ref["module.enc_spatial_transformer.norm_out.beta"] = torch.zeros(16)
    ref["module.enc_spatial_transformer.layers.0.1.norm.beta"] = torch.zeros(16)
    ref["module.enc_spatial_transformer.layers.0.1.context_norm.gamma"] = (
        torch.ones(16))
    other = tctvit.CTViT(**TINY, policy=FP32_POLICY, device="cpu")
    other.load_reference(ref)
    assert all(torch.equal(a, b) for a, b in zip(
        other.state_dict().values(), model.state_dict().values()))
    ref["module.something_else"] = torch.zeros(1)
    with pytest.raises(ValueError):
        other.load_reference(ref)
