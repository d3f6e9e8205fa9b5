"""CPU parity of the port's VQGAN trainer against the JAX package
(train/ctvit_trainer.py, cli/run_ctvit_recon.py), at tiny shapes and the
fp32 policy, from JAX's parameters (models/convert.py) and on JAX's draws
(the GAN pieces and VGG: tests/test_torch_gan.py):

- ``CTViTTrainer``: 3 generator steps and the discriminator step (with
  the penalty) on JAX's frame picks: every loss term and λ within 1e-5
  relative plus 1e-6 absolute at each step (the generator loss is a mean
  of discriminator logits of order 1e-3 that cancel: its rounding is
  absolute); the generator's parameters, its EMA, the codebook and the
  discriminator after the 3 steps within relative L2 1e-4 per tensor, but
  for the elements whose gradient stays below NOISE at every step
  (rounding noise, which Adam turns into a step of up to lr): those within
  max |Δ| ≤ 2·3·lr;
- save and resume: bit for bit against an unbroken run, and the saved
  EMA CTViT loads strictly where cli/run_ctvit_recon.py reads it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vit_exp_tpu.core.precision import FP32_POLICY as JAX_FP32
from vit_exp_tpu.models import ctvit as jctvit
from vit_exp_tpu.train import ctvit_trainer as jtrainer

from tests.test_torch_ctvit import TINY, _np, port_ctvit
from vit_exp_tpu_torch.core.precision import FP32_POLICY
from vit_exp_tpu_torch.models import ctvit as tctvit
from vit_exp_tpu_torch.models.convert import (from_jax_ctvit_variables,
                                              from_jax_discr_params)
from vit_exp_tpu_torch.models.factory import init_parameters_
from vit_exp_tpu_torch.train import ctvit_trainer as ttrainer

RTOL = 1e-5
LR = 1e-4      # both trainers' default
NOISE = 1e-6


def _close(a, b, rtol=RTOL, atol=0.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-6) + atol, (
        a, b)


def _perc_jax(x, y):
    return jnp.mean(jnp.tanh(x - 0.5 * y) ** 2)


def _perc_torch(x, y):
    return torch.tanh(x - 0.5 * y).square().mean()


def _jax_draws(seed, steps, b, t):
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        rng, r1, r2 = jax.random.split(rng, 3)
        out.append(ttrainer.StepDraws(
            torch.from_numpy(np.array(jax.random.randint(r1, (b,), 0, t))),
            torch.from_numpy(np.array(jax.random.randint(r2, (b,), 0, t)))))
    return out


def _port_trainer(jt, folder, **kw):
    variables = _np({"params": jt.params, "codebook": jt.codebook})
    trainer = ttrainer.CTViTTrainer(
        port_ctvit(variables), perceptual_fn=_perc_torch,
        results_folder=str(folder), sample_every=0, gen_steps_per_discr=3,
        apply_grad_penalty_every=2, **kw)
    trainer.discr.load_state_dict({
        k: torch.from_numpy(np.array(v)) for k, v in
        from_jax_discr_params(_np(jt.discr_params)).items()})
    return trainer


def test_ctvit_trainer_steps_match_jax(tmp_path):
    video = np.random.default_rng(2).uniform(
        0, 1, (2, 1, 5, 8, 8)).astype(np.float32)
    jt = jtrainer.CTViTTrainer(
        jctvit.CTViT(**TINY, policy=JAX_FP32), perceptual_fn=_perc_jax,
        results_folder=str(tmp_path / "jax"), sample_every=0,
        gen_steps_per_discr=3, apply_grad_penalty_every=2, seed=0)
    pt = _port_trainer(jt, tmp_path / "port")
    draws = _jax_draws(0, 3, 2, 5)
    grad_max = {}    # per element, the largest |gradient| over the steps
    for step in range(3):
        ref = jt.train_step(video)
        logs = pt.train_step(video, draws=draws[step])
        assert set(logs) == set(ref)
        for k in ref:
            _close(logs[k], ref[k], atol=1e-6)
        assert ("discr_loss" in ref) == (step == 2)
        for prefix, mod in (("", pt.model), ("discr.", pt.discr)):
            for name, p in mod.named_parameters():
                if p.grad is not None:
                    g = p.grad.abs().numpy()
                    grad_max[prefix + name] = np.maximum(
                        grad_max.get(prefix + name, g), g)
    assert 0 < ref["adaptive_weight"] < 1e4

    def check(ours, theirs, lr, prefix=""):
        for name, t in ours.items():
            a, b = t.numpy(), theirs[name]
            # elements whose gradient is rounding noise at every step (a
            # unit of the position bias whose pre-activations share a sign
            # only shifts every logit of a head alike, which softmax
            # ignores): Adam moves them by up to lr a step either way
            noise = grad_max.get(prefix + name, np.ones_like(a)) < NOISE
            assert np.abs(a - b)[noise].max(initial=0) <= 2 * 3 * lr, name
            a, b = a[~noise], b[~noise]
            assert np.linalg.norm(a - b) <= 1e-4 * max(np.linalg.norm(b),
                                                       1e-6), name

    check(pt.model.state_dict(), from_jax_ctvit_variables(
        _np({"params": jt.params, "codebook": jt.codebook})), LR)
    check(pt.ema_model().state_dict(), from_jax_ctvit_variables(
        _np({"params": jt.ema_params, "codebook": jt.codebook})), LR)
    check(pt.discr.state_dict(), from_jax_discr_params(
        _np(jt.discr_params)), LR * 0.01, "discr.")


def test_ctvit_trainer_save_and_resume(tmp_path):
    def trainer(folder):
        model = tctvit.CTViT(**TINY, policy=FP32_POLICY, device="cpu")
        init_parameters_(model, seed=1)
        return ttrainer.CTViTTrainer(
            model, perceptual_fn=_perc_torch, results_folder=str(folder),
            sample_every=0, seed=3)

    video = torch.rand(1, 1, 5, 8, 8, generator=torch.Generator().manual_seed(4))
    a = trainer(tmp_path / "a")
    logs_a = [a.train_step(video) for _ in range(4)]
    b = trainer(tmp_path / "b")
    for _ in range(2):
        b.train_step(video)
    b.save()
    c = trainer(tmp_path / "b")
    assert c.restore() == 2 and c.step == 2
    logs_c = [c.train_step(video) for _ in range(2)]
    assert logs_c == logs_a[2:]
    for x, y in zip(a.model.state_dict().values(),
                    c.model.state_dict().values()):
        assert torch.equal(x, y)
    # model.pt is the EMA CTViT the recon CLI loads strictly
    from vit_exp_tpu_torch.cli.run_ctvit_recon import load_ctvit

    m = tctvit.CTViT(**TINY, policy=FP32_POLICY, device="cpu")
    load_ctvit(m, str(tmp_path / "b" / "checkpoints"))
    assert all(torch.equal(x, y) for x, y in zip(
        m.state_dict().values(), b.ema_model().state_dict().values()))
