"""CPU parity of the port's MaskGIT stack against the JAX package
(models/maskgit.py, maskgit_pipeline.py, t5_adapter.py and
train/ctvit_trainer.py::MaskGITTrainer), at tiny shapes and the fp32
policy, from JAX's parameters (models/convert.py) and on JAX's draws:

- MaskGit with context and its padding mask, with guidance and with
  cond-drop: 1e-5 absolute on logits of order one; SelfCritic: its
  ``to_pred`` runs at the default bf16 policy in both packages, so 1e-2
  relative (a bf16 rounding) on its scores;
- the training masking on JAX's uniforms: the masked ids and the mask bit
  for bit; the masked CE: 1e-5;
- ``maskgit_sample`` on JAX's gumbel uniforms, with the model's
  confidences and with the critic's (and its noise): the ids equal
(the pipeline and the trainer: tests/test_torch_maskgit_pipeline.py; the
T5 adapter: tests/test_torch_generative_cli.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_exp_tpu.core.precision import FP32_POLICY as JAX_FP32
from vit_exp_tpu.models import maskgit as jmg

from tests.test_torch_ctvit import _np, _t
from vit_exp_tpu_torch.core.precision import FP32_POLICY
from vit_exp_tpu_torch.models import maskgit as tmg
from vit_exp_tpu_torch.models.convert import from_jax_maskgit_params

ATOL = 1e-5
CODES, DIM, SEQ = 32, 16, 16


def jax_maskgit(critic=False, seed=2):
    mg = jmg.MaskGit(num_tokens=CODES, max_seq_len=SEQ, dim=DIM, depth=2,
                     heads=2, dim_head=4, policy=JAX_FP32)
    module = jmg.SelfCritic(net=mg) if critic else mg
    ctx, mask = _context()
    init = jax.jit(module.init)
    params = _np(init(jax.random.PRNGKey(seed), jnp.zeros((2, 12), jnp.int32),
                      context=jnp.asarray(ctx),
                      context_mask=jnp.asarray(mask)))["params"]
    return mg, module, params


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def port_maskgit(params, critic=False):
    mg = tmg.MaskGit(CODES, SEQ, DIM, depth=2, heads=2, dim_head=4,
                     dim_context=DIM, policy=FP32_POLICY, device="cpu")
    module = tmg.SelfCritic(mg, device="cpu") if critic else mg
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                            from_jax_maskgit_params(params, critic).items()})
    return module


def _context(b=2):
    r = np.random.default_rng(7)
    ctx = r.normal(size=(b, 6, DIM)).astype(np.float32)
    mask = np.ones((b, 6), bool)
    mask[1, 4:] = False
    return ctx, mask


def _ids(b=2, n=12, seed=8):
    ids = np.random.default_rng(seed).integers(0, CODES + 1, (b, n))
    return ids.astype(np.int32)


def test_maskgit_guidance_cond_drop_and_critic_match_jax():
    mg, _, params = jax_maskgit()
    ctx, mask = _context()
    ids = _ids()
    kw = dict(context=jnp.asarray(ctx), context_mask=jnp.asarray(mask))
    tkw = dict(context=_t(ctx), context_mask=_t(mask))
    model = port_maskgit(params)
    for drop in (None, np.array([True, False])):
        ref = mg.apply({"params": params}, jnp.asarray(ids),
                       cond_drop_mask=None if drop is None
                       else jnp.asarray(drop), **kw)
        out = model(_t(ids), cond_drop_mask=None if drop is None
                    else _t(drop), **tkw)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   atol=ATOL)
    ref = mg.forward_with_cond_scale({"params": params}, jnp.asarray(ids),
                                     cond_scale=3.0, **kw)
    out = model.forward_with_cond_scale(_t(ids), cond_scale=3.0, **tkw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=3 * ATOL)
    _, critic, cparams = jax_maskgit(critic=True, seed=3)
    ref = critic.apply({"params": cparams}, jnp.asarray(ids), **kw)
    out = port_maskgit(cparams, critic=True)(_t(ids), **tkw)
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-2,
                               atol=1e-2 * float(np.abs(ref).max()))


def _masking_draws(key, b, n):
    t_rng, pos_rng = jax.random.split(key)
    return tmg.MaskingDraws(_t(jax.random.uniform(t_rng, (b,))),
                            _t(jax.random.uniform(pos_rng, (b, n))))


def test_masking_and_loss_match_jax():
    ids = np.random.default_rng(1).integers(0, CODES, (3, 40))
    key = jax.random.PRNGKey(9)
    masked_ref, mask_ref = jmg.maskgit_train_masking(key, jnp.asarray(ids),
                                                     CODES)
    masked, mask = tmg.maskgit_train_masking(
        torch.from_numpy(ids), CODES, draws=_masking_draws(key, 3, 40))
    np.testing.assert_array_equal(masked.numpy(), np.asarray(masked_ref))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_ref))
    logits = np.random.default_rng(2).normal(size=(3, 40, CODES)).astype(
        np.float32)
    ref = jmg.maskgit_loss(jnp.asarray(logits), jnp.asarray(ids), mask_ref)
    out = tmg.maskgit_loss(_t(logits), torch.from_numpy(ids), mask)
    np.testing.assert_allclose(float(out), float(ref), atol=ATOL)


def _sample_draws(key, steps, shape, critic):
    """The draws of JAX's maskgit_sample(key, ...), in its order."""
    out, rng = [], key
    for _ in range(steps):
        rng, g_rng, c_rng = jax.random.split(rng, 3)
        u = jax.random.uniform(g_rng, shape, minval=1e-20, maxval=1.0)
        noise = jax.random.normal(c_rng, shape[:2]) if critic else None
        out.append(tmg.SampleDraws(_t(u), None if noise is None
                                   else _t(noise)))
    return out


@pytest.mark.parametrize("critic", [False, True])
def test_maskgit_sample_ids_equal_jax(critic):
    mg, _, params = jax_maskgit()
    ctx, mask = _context()
    key, steps = jax.random.PRNGKey(11), 4
    kw = dict(batch=2, seq_len=12, steps=steps, cond_scale=3.0,
              temperature=1.0)
    critic_fn = critic_ref = None
    if critic:
        _, jcritic, cparams = jax_maskgit(critic=True, seed=3)
        tcritic = port_maskgit(cparams, critic=True)

        def critic_ref(ids):
            return jcritic.apply({"params": _jnp(cparams)}, ids,
                                 context=jnp.asarray(ctx),
                                 context_mask=jnp.asarray(mask))

        def critic_fn(ids):
            return tcritic(ids, context=_t(ctx), context_mask=_t(mask))

    ref = jmg.maskgit_sample(mg, {"params": _jnp(params)}, key,
                             context=jnp.asarray(ctx),
                             context_mask=jnp.asarray(mask),
                             critic_apply=critic_ref, critic_noise=0.5, **kw)
    with torch.no_grad():
        out = tmg.maskgit_sample(
            port_maskgit(params), context=_t(ctx), context_mask=_t(mask),
            critic=critic_fn, critic_noise=0.5,
            draws=_sample_draws(key, steps, (2, 12, CODES), critic), **kw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out.min() >= 0 and out.max() < CODES
