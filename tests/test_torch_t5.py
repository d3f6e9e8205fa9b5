"""CPU parity of the port's T5 adapter (models/t5_adapter.py) against the
JAX package's, on the Flax encoder's weights carried into transformers'
torch T5 (skipped without transformers' T5 classes): the states within
1e-5 absolute, the padded positions zero, no gradient.
"""

import flax.linen as nn_flax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


def test_t5_adapter_matches_flax_encoder():
    from vit_exp_tpu_torch.models import t5_adapter

    if not t5_adapter.available():
        pytest.skip("transformers' T5EncoderModel is not installed")
    jt5 = pytest.importorskip("vit_exp_tpu.models.t5_adapter")
    if not jt5.available():
        pytest.skip("transformers' FlaxT5EncoderModel is not installed")
    from transformers.modeling_flax_pytorch_utils import \
        load_flax_weights_in_pytorch_model

    ref_enc = jt5.T5TextEncoder()
    enc = t5_adapter.T5TextEncoder(ref_enc.model.config, device="cpu")
    load_flax_weights_in_pytorch_model(enc.model,
                                       nn_flax.unbox(ref_enc.model.params))
    ids = np.random.default_rng(5).integers(0, 512, (2, 7)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 5:] = 0
    ref, _ = ref_enc(jnp.asarray(ids), jnp.asarray(mask))
    out, m = enc(torch.from_numpy(ids), torch.from_numpy(mask))
    assert enc.ctx_dim == 64 and not out.requires_grad
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    assert torch.all(out[1, 5:] == 0) and torch.equal(m, torch.from_numpy(mask))
