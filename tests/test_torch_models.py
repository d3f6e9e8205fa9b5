"""CPU parity of the PyTorch port's models against the JAX package.

One JAX CTCLIP at the tiny flagship arch (``__graft_entry__._flagship_config
(tiny=True)``, ``BertConfig.tiny()``) is initialised, every float parameter
is perturbed with seeded noise (so γ, β, the q/k scales and the
temperature are not at their identity init), and the same parameters are
loaded into the port through ``from_jax_params``.  The JAX side runs the
serving configuration (attn_impl="pallas_static", ff_impl="pallas",
fuse_qkv=True, Pallas in interpret mode) under FP32_POLICY; the port runs
the same configuration (``fuse_qkv=True``) with its plain versions on the
CPU under its FP32_POLICY.

Tolerance: 1e-4 absolute on fp32 module outputs of order one (both sides
compute in fp32 and differ only in summation order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship_config
from vit_exp_tpu.core.precision import DEFAULT_POLICY as JAX_BF16
from vit_exp_tpu.core.precision import FP32_POLICY as JAX_FP32
from vit_exp_tpu.models.bert import BertConfig as JaxBertConfig
from vit_exp_tpu.models.convert import export_ctclip_state_dict
from vit_exp_tpu.models.ctclip import CTCLIP as JaxCTCLIP
from vit_exp_tpu.models.factory import build_ctclip as jax_build_ctclip

from vit_exp_tpu_torch.core.precision import DEFAULT_POLICY, FP32_POLICY
from vit_exp_tpu_torch.models.bert import BertConfig
from vit_exp_tpu_torch.models.convert import (OPTIONAL_KEYS, from_jax_params,
                                              load_reference_state_dict,
                                              synthesized_keys)
from vit_exp_tpu_torch.models.factory import build_ctclip

ATOL = 1e-4
DIM_LATENT = 16
TEXT_LEN = 12


POLICIES = {"fp32": (JAX_FP32, FP32_POLICY), "bf16": (JAX_BF16, DEFAULT_POLICY)}


def jax_serving_model(config, policy="fp32"):
    return jax_build_ctclip(
        config, bert_config=JaxBertConfig.tiny(), policy=POLICIES[policy][0],
        dim_latent=DIM_LATENT, attn_impl="pallas_static", ff_impl="pallas",
        fuse_qkv=True)


def jax_params(config, seed=0):
    """Perturbed fp32 params of the tiny JAX CTCLIP, numpy leaves."""
    import flax.linen as nn

    a = config.arch
    init_model = jax_build_ctclip(config, bert_config=JaxBertConfig.tiny(),
                                  policy=JAX_FP32, dim_latent=DIM_LATENT)
    video = jnp.zeros((1, 1, a.temporal_size, a.image_size, a.image_size))
    init = jax.jit(lambda key, v, ids: init_model.init(
        key, v, ids, method=JaxCTCLIP.init_all))
    params = nn.unbox(init(jax.random.PRNGKey(seed), video,
                           jnp.ones((1, TEXT_LEN), jnp.int32)))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + np.float32(0.1) * rng.standard_normal(np.shape(p)).astype(np.float32),
        params)


def port_model(config, params, policy="fp32", fuse_qkv=True, int8=False):
    model = build_ctclip(config, BertConfig.tiny(), device="cpu",
                         policy=POLICIES[policy][1], dim_latent=DIM_LATENT,
                         fuse_qkv=fuse_qkv, int8=int8)
    res = model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in from_jax_params(params).items()})
    assert not res.missing_keys and not res.unexpected_keys
    return model


@pytest.fixture(scope="module")
def setup():
    config = _flagship_config(tiny=True)
    params = jax_params(config)
    return config, params, jax_serving_model(config), port_model(config, params)


def _video(config, b=2, seed=1):
    a = config.arch
    return np.random.default_rng(seed).standard_normal(
        (b, 1, a.temporal_size, a.image_size, a.image_size)).astype(np.float32)


def _ids(seed=2):
    r = np.random.default_rng(seed)
    ids = r.integers(0, 128, (3, TEXT_LEN)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 7:] = 0
    mask[2, 4:] = 0
    return ids, mask


def _apply(model, params, *args, method):
    return np.asarray(model.apply({"params": params}, *args, method=method))


def test_bert_hidden_matches(setup):
    config, params, jmodel, tmodel = setup
    ids, mask = _ids()
    ref = _apply(jmodel, params, jnp.asarray(ids), jnp.asarray(mask),
                 method=JaxCTCLIP.encode_text_hidden)
    with torch.inference_mode():
        out = tmodel.encode_text_hidden(torch.from_numpy(ids).long(),
                                        torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_ctvit3d_tokens_match(setup):
    config, params, jmodel, tmodel = setup
    video = _video(config)
    ref = _apply(jmodel, params, jnp.asarray(video),
                 method=JaxCTCLIP.encode_image_tokens)
    with torch.inference_mode():
        out = tmodel.encode_image_tokens(torch.from_numpy(video))
    assert out.shape == ref.shape == (2, 4, 4, 4, 48)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_ctclip_latents_match(setup):
    config, params, jmodel, tmodel = setup
    video = _video(config, seed=3)
    ids, mask = _ids(4)
    tokens = jmodel.apply({"params": params}, jnp.asarray(video),
                          method=JaxCTCLIP.encode_image_tokens)
    hidden = jmodel.apply({"params": params}, jnp.asarray(ids),
                          jnp.asarray(mask), method=JaxCTCLIP.encode_text_hidden)
    img_ref = _apply(jmodel, params, tokens,
                     method=JaxCTCLIP.image_latents_from_tokens)
    txt_ref = _apply(jmodel, params, hidden,
                     method=JaxCTCLIP.text_latents_from_hidden)
    with torch.inference_mode():
        img = tmodel.image_latents_from_tokens(torch.tensor(np.array(tokens)))
        txt = tmodel.text_latents_from_hidden(torch.tensor(np.array(hidden)))
        scale = float(tmodel.logit_scale())
    np.testing.assert_allclose(img.numpy(), img_ref, atol=1e-5)
    np.testing.assert_allclose(txt.numpy(), txt_ref, atol=1e-5)
    np.testing.assert_allclose(scale, float(np.exp(params["temperature"])),
                               rtol=1e-6)


def test_block_layout_quirks(setup):
    """k/v read the pre-LN x and the null kv split even/odd: zeroing the
    attention LN's γ must leave k/v untouched (only q sees the normed x)."""
    from vit_exp_tpu_torch.ops.fused_proj import fused_ln_qkv

    _, _, _, tmodel = setup
    attn = tmodel.visual_transformer.enc_3D.layers[0]._modules["1"]
    x = torch.randn(1, 5, 48)
    q, kv = fused_ln_qkv(x, torch.zeros(48), attn.to_q.weight.t(),
                         attn.to_kv.weight.t())
    assert torch.count_nonzero(q) == 0
    torch.testing.assert_close(kv, x @ attn.to_kv.weight.t())
    nkv = attn.null_kv.reshape(attn.heads, attn.num_null_kv, 2, attn.dim_head)
    torch.testing.assert_close(nkv[:, :, 0], attn.null_kv[:, 0::2])
    torch.testing.assert_close(nkv[:, :, 1], attn.null_kv[:, 1::2])


@pytest.mark.parametrize("bert_buffers", [False, True])
def test_from_jax_params_agrees_with_export(setup, bert_buffers):
    """Every key the port registers is emitted by the JAX package's export
    with the same value, and loading the export reports exactly the keys
    export synthesizes as unexpected and none missing."""
    config, params, _, _ = setup
    a = config.arch
    exported = export_ctclip_state_dict(
        params, grid=a.grid, heads=a.heads, bert_config=JaxBertConfig.tiny(),
        bert_buffers=bert_buffers)
    mine = from_jax_params(params)
    model = build_ctclip(config, BertConfig.tiny(), device="cpu",
                         policy=FP32_POLICY, dim_latent=DIM_LATENT)
    assert set(mine) == set(model.state_dict())
    for k, val in mine.items():
        np.testing.assert_array_equal(val, exported[k], err_msg=k)
    res = load_reference_state_dict(
        model, {"module." + k: v for k, v in exported.items()})
    assert res.missing_keys == []
    expected = synthesized_keys(model) - (set() if bert_buffers
                                          else OPTIONAL_KEYS)
    assert set(res.unexpected_keys) == expected
    for k, val in model.state_dict().items():
        np.testing.assert_array_equal(val.numpy(), mine[k], err_msg=k)


def test_load_reference_refuses_a_foreign_key(setup):
    config, params, _, _ = setup
    a = config.arch
    exported = export_ctclip_state_dict(params, grid=a.grid, heads=a.heads,
                                        bert_config=JaxBertConfig.tiny())
    model = build_ctclip(config, BertConfig.tiny(), device="cpu",
                         policy=FP32_POLICY, dim_latent=DIM_LATENT)
    with pytest.raises(ValueError):
        load_reference_state_dict(model, {**exported, "stray.weight": 0.0})
    del exported["temperature"]
    with pytest.raises(ValueError):
        load_reference_state_dict(model, exported)


def test_seeded_init_is_deterministic():
    config = _flagship_config(tiny=True)
    a, b, c = (build_ctclip(config, BertConfig.tiny(), device="cpu",
                            dim_latent=DIM_LATENT, seed=seed)
               for seed in (5, 5, 6))
    for (k, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    assert not torch.equal(a.state_dict()["to_text_latent.weight"],
                           c.state_dict()["to_text_latent.weight"])
    assert all(torch.isfinite(v).all() for v in a.state_dict().values())


def test_build_ctclip_defaults_to_the_card():
    """The entry points build on the card unless the caller asks for the
    CPU; without a card the default raises torch's own error and never
    falls back to the CPU."""
    import inspect

    from vit_exp_tpu_torch.models.factory import build_image_encoder

    for fn in (build_ctclip, build_image_encoder):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    config = _flagship_config(tiny=True)
    if torch.cuda.is_available():
        model = build_ctclip(config, BertConfig.tiny(), dim_latent=DIM_LATENT)
        assert {p.device.type for p in model.parameters()} == {"cuda"}
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            build_ctclip(config, BertConfig.tiny(), dim_latent=DIM_LATENT)
