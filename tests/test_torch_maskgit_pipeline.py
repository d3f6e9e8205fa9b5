"""CPU parity of the port's MaskGIT pipeline and trainer against the JAX
package (models/maskgit_pipeline.py, train/ctvit_trainer.py::
MaskGITTrainer), over the tiny CTViT of tests/test_torch_ctvit.py and the
tiny MaskGit of tests/test_torch_maskgit.py, fp32, from JAX's parameters
and on JAX's draws:

- ``make_video`` (two scenes, the second primed with the first's last
  frame) on JAX's gumbel uniforms: the decoded video within 1e-5 absolute
  (the ids equal: a different id moves a whole patch by order one);
- ``MaskGITTrainer.fit_batch`` on JAX's masking draws: the loss within
  1e-5 relative, the parameters after the step within relative L2 1e-4 per
  tensor (none has a gradient at rounding-noise level here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vit_exp_tpu.models.maskgit_pipeline import MaskGITTransformer as JaxPipe
from vit_exp_tpu.train.ctvit_trainer import MaskGITTrainer as JaxTrainer

from tests.test_torch_ctvit import _np, _t, _video, jax_ctvit, port_ctvit
from tests.test_torch_maskgit import (CODES, DIM, _jnp, _masking_draws,
                                      _sample_draws, jax_maskgit,
                                      port_maskgit)
from vit_exp_tpu_torch.models.convert import from_jax_maskgit_params
from vit_exp_tpu_torch.models.maskgit_pipeline import MaskGITTransformer
from vit_exp_tpu_torch.train.ctvit_trainer import MaskGITTrainer

GRID = (3, 2, 2)


def _pipelines():
    video = _video(b=1)
    jctvit_model, variables = jax_ctvit(video)
    mg, _, params = jax_maskgit()
    table = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (64, DIM)))

    def jax_text(ids, mask):
        return jnp.asarray(table)[ids]

    def port_text(ids, mask):
        return _t(table)[ids.long()]

    jpipe = JaxPipe(jctvit_model, _jnp(variables), mg,
                    {"params": _jnp(params)}, jax_text)
    tpipe = MaskGITTransformer(port_ctvit(variables), port_maskgit(params),
                               port_text)
    return video, jpipe, tpipe


def test_make_video_matches_jax():
    _, jpipe, tpipe = _pipelines()
    ids = np.random.default_rng(3).integers(0, 64, (2, 1, 6))
    masks = np.ones((2, 1, 6), np.int32)
    prompts = [(ids[i], masks[i]) for i in range(2)]
    key, steps = jax.random.PRNGKey(12), 3
    # one jitted program: JAX's pipeline applies its modules eagerly
    ref = jax.jit(lambda k: jpipe.make_video(
        k, [(jnp.asarray(a), jnp.asarray(m)) for a, m in prompts],
        token_grid=GRID, prime_length=1, steps=steps, cond_scale=2.0))(key)
    draws, rng = [], key
    for _ in prompts:
        rng, sub = jax.random.split(rng)
        draws.append(_sample_draws(sub, steps, (1, 12, CODES), False))
    out = tpipe.make_video([(torch.from_numpy(a), torch.from_numpy(m))
                            for a, m in prompts], token_grid=GRID,
                           prime_length=1, steps=steps, cond_scale=2.0,
                           draws=draws)
    assert out.shape == (1, 1, 10, 8, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_maskgit_trainer_fit_batch_matches_jax():
    video, jpipe, tpipe = _pipelines()
    ids = np.random.default_rng(4).integers(0, 64, (1, 6)).astype(np.int32)
    mask = np.ones_like(ids)
    jt = JaxTrainer(jpipe)
    ref = jt.fit_batch(video, ids, mask)
    tt = MaskGITTrainer(tpipe)
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    loss = tt.fit_batch(video, ids, mask, draws=_masking_draws(sub, 1, 12))
    np.testing.assert_allclose(loss, ref, rtol=1e-5)
    theirs = from_jax_maskgit_params(_np(jpipe.maskgit_vars["params"]))
    for name, t in tpipe.maskgit.state_dict().items():
        a, b = t.numpy(), theirs[name]
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b), name
    assert tt.step == 1
