"""The port's dense and convolution weights are drawn as the JAX package's
are: flax's ``lecun_normal``, a normal truncated at two of its standard
deviations and rescaled to variance 1/fan_in.

The int8 serving path scales each weight column by its largest |w|, so the
tails of the init set the size of its quantization noise at random
weights: an untruncated normal's column maximum lies near 3.2σ at fan-in
768, the truncated one's at 2.27σ, and its per-channel quantization noise
is about 1.4 times JAX's.  These tests hold the distribution to JAX's own
draws; the plain normal of the same variance must fail the same check.
"""

import math
import types

import jax
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

from vit_exp_tpu_torch.models.bert import BertConfig
from vit_exp_tpu_torch.models.factory import build_ctclip
from vit_exp_tpu_torch.models.layers import ConvParams, Linear

# flax's truncated normal is bounded at 2 / 0.8796 standard deviations
BOUND = 2.0 / 0.87962566103423978
# the two-sample KS statistic at 131,072 draws each: 0.0076 is the 0.1%
# critical value; an untruncated normal reads 0.017
KS_MAX = 0.0076


def _flax_draws(fan_in: int, fan_out: int) -> np.ndarray:
    w = jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(0),
                                           (fan_in, fan_out))
    return np.asarray(w).ravel() * math.sqrt(fan_in)


def _is_flax_lecun_normal(draws: np.ndarray, fan_in: int) -> bool:
    ref = _flax_draws(fan_in, draws.size // fan_in)
    return (np.abs(draws).max() <= BOUND * (1 + 1e-6)
            and abs(draws.std() - 1.0) < 0.01
            and ks_2samp(ref, draws).statistic < KS_MAX)


@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_dense_and_conv_weights_are_flax_lecun_normal(kind):
    gen = torch.Generator().manual_seed(0)
    if kind == "linear":
        m = Linear(256, 512, device="cpu")
    else:   # the patch embedding's shape at a narrow width: fan-in 4,000
        m = ConvParams(32, 1, 10, 20, 20, device="cpu")
    m.reset_parameters(gen)
    fan_in = m.weight[0].numel()
    draws = m.weight.detach().numpy().ravel() * math.sqrt(fan_in)
    assert _is_flax_lecun_normal(draws, fan_in)
    if kind == "conv":
        assert not m.bias.detach().abs().any()
    # the check tells the truncated draw from a plain normal of its variance
    plain = torch.randn(draws.size, generator=gen).numpy()
    assert not _is_flax_lecun_normal(plain, fan_in)


def test_every_dense_weight_of_the_clip_model_is_within_flax_bound():
    arch = dict(dim=48, image_size=32, patch_size=8, temporal_size=16,
                temporal_patch_size=4, transformer_blocks=2, dim_head=8,
                heads=4, channels=1, use_flash_attention=True)
    model = build_ctclip(types.SimpleNamespace(**arch), BertConfig.tiny(),
                         device="cpu", use_kernels=False, seed=0)
    owners = [m for m in model.modules() if isinstance(m, (Linear,
                                                             ConvParams))]
    assert len(owners) > 10
    for m in owners:
        fan_in = m.weight[0].numel()
        w = m.weight.detach().float() * math.sqrt(fan_in)
        assert w.abs().max().item() <= BOUND * (1 + 1e-6)
