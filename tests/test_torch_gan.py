"""CPU parity of the port's GAN pieces and VGG features against the JAX
package (models/gan.py, models/vgg.py), from JAX's parameters
(models/convert.py), fp32:

- the hinge and BCE losses and the adaptive weight: 1e-6 relative;
- the discriminator at an odd and an even frame size, the gradient
  penalty and its gradient in the discriminator's weights: 1e-5 relative
  (the penalty's weight gradient, a double backward, 1e-4);
- VGG16 features at 224, the resize from 8×8 frames and the perceptual
  term: 1e-5 relative; torchvision's key layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_exp_tpu.models import gan as jgan
from vit_exp_tpu.models import vgg as jvgg

from tests.test_torch_ctvit import _np, _t
from vit_exp_tpu_torch.models import gan as tgan
from vit_exp_tpu_torch.models import vgg as tvgg
from vit_exp_tpu_torch.models.convert import (from_jax_discr_params,
                                              from_jax_vgg_params)


def _close(a, b, rtol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-6), (a, b)


def _discr(params):
    d = tgan.SliceDiscriminator(device="cpu")
    d.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                       from_jax_discr_params(params).items()})
    return d


def test_gan_losses_match_jax():
    r = np.random.default_rng(0)
    fake, real = r.normal(size=(2, 16)).astype(np.float32) * 3
    for name in ("hinge_discr_loss", "bce_discr_loss"):
        _close(getattr(tgan, name)(_t(fake), _t(real)),
               getattr(jgan, name)(jnp.asarray(fake), jnp.asarray(real)),
               1e-6)
    for name in ("hinge_gen_loss", "bce_gen_loss"):
        _close(getattr(tgan, name)(_t(fake)),
               getattr(jgan, name)(jnp.asarray(fake)), 1e-6)
    _close(tgan.adaptive_gen_weight(torch.tensor(3.0), torch.tensor(0.0)),
           jgan.adaptive_gen_weight(3.0, 0.0), 1e-6)


@pytest.mark.parametrize("hw", [(9, 7), (16, 16)])
def test_discriminator_and_gradient_penalty_match_jax(hw):
    r = np.random.default_rng(hw[0])
    frames = r.normal(size=(3, 1) + hw).astype(np.float32)
    jd = jgan.SliceDiscriminator()
    params = _np(jd.init(jax.random.PRNGKey(1), jnp.asarray(frames)))["params"]
    ref = jd.apply({"params": params}, jnp.asarray(frames))
    d = _discr(params)
    _close(d(_t(frames)).detach(), ref)
    gp_ref = jgan.gradient_penalty(
        lambda p, x: jd.apply({"params": p}, x), params, jnp.asarray(frames))
    gp = tgan.gradient_penalty(d, _t(frames))
    _close(gp.detach(), gp_ref)
    # the penalty trains the discriminator: its gradient reaches the weights
    gp.backward()
    g_ref = jax.grad(lambda p: jgan.gradient_penalty(
        lambda pp, x: jd.apply({"params": pp}, x), p,
        jnp.asarray(frames)))(params)
    _close(d.conv0.weight.grad.numpy(),
           from_jax_discr_params(_np(g_ref))["conv0.weight"], 1e-4)


def test_vgg_features_and_perceptual_term_match_jax():
    params = _np(jvgg.random_vgg16_params(jax.random.PRNGKey(0)))
    model = tvgg.VGG16Features(include_classifier=False, device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           from_jax_vgg_params(params).items()})
    r = np.random.default_rng(1)
    x, y = r.normal(size=(2, 2, 1, 8, 8)).astype(np.float32)
    _close(tvgg.resize_frames_224(_t(x)), jvgg._resize_frames_224(
        jnp.asarray(x)))
    ref = jvgg.make_perceptual_fn(params)(jnp.asarray(x), jnp.asarray(y))
    _close(tvgg.make_perceptual_fn(model)(_t(x), _t(y)).detach(), ref)
    # torchvision's vgg16 keys (the last classifier layer is not kept)
    keys = set(tvgg.VGG16Features(True, device="meta").state_dict())
    assert keys == {f"features.{i}.{p}" for i in tvgg.CONV_IDX
                    for p in ("weight", "bias")} | {
        f"classifier.{i}.{p}" for i in (0, 3) for p in ("weight", "bias")}


