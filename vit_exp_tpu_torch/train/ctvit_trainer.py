"""The CTViT VQGAN-VAE trainer and the MaskGIT trainer (counterpart of
vit_exp_tpu/train/ctvit_trainer.py).

``CTViTTrainer.train_step(video)``:

- a generator step: encode, quantize with the codebook's EMA update inside
  the loss (the quantized tokens come from the codebook before the update),
  decode; loss = recon MSE + commit + perceptual + λ·hinge generator loss
  on one frame per sample, the SAME frame of the reconstruction and of the
  input.  λ = ‖∂perc/∂W‖ / ‖∂gen/∂W‖ over W = to_pixels.0.weight alone
  (the decode trunk held fixed), clamped to 1e4, detached; a frame picked
  at index 0 comes from to_pixels_first_frame and adds nothing to those
  gradients;
- every ``gen_steps_per_discr``-th step ((step+1) % 3 == 0), a
  discriminator step on the UPDATED generator and codebook: the hinge loss
  on fake and real frames at one shared frame index, plus the gradient
  penalty on the real frames when step % apply_grad_penalty_every == 0
  (step counted before the increment);
- the EMA copy of the generator's parameters (decay 0.995).

Optimizers as optax builds them: Adam b1 0.9, b2 0.99 (AdamW with decay on
parameters of ndim ≥ 2 when wd > 0; train/optimizer.py's ``Optimizer`` with
no clipping), the discriminator at lr × discr_lr_mult.  The frame picks
are drawn from ``torch.Generator``s seeded from ``seed``, or handed in
(``draws``).  Sampling and the inference checkpoint use the EMA weights
with the live codebook.

``save()`` writes ``results_folder/checkpoints/ckpt_{step}/`` in the port's
format (train/checkpoint.py): ``model.pt`` is the EMA CTViT state dict
(what cli/run_ctvit_recon.py loads), ``train_state.pt`` everything a resume
needs; ``restore()`` resumes.

``MaskGITTrainer.fit_batch(video, text_ids, text_mask)``: masked-token CE
of MaskGit over the frozen CTViT's indices, optax.adam(lr) (b2 0.999).
"""

from __future__ import annotations

import copy
import os
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from vit_exp_tpu_torch.models.ctvit import CTViT
from vit_exp_tpu_torch.models.gan import (SliceDiscriminator,
                                          adaptive_gen_weight,
                                          gradient_penalty, hinge_discr_loss,
                                          hinge_gen_loss, pick_frames)
from vit_exp_tpu_torch.train.checkpoint import CheckpointManager
from vit_exp_tpu_torch.train.optimizer import AdamWOptax, Optimizer


@torch.no_grad()
def ema_update(ema: torch.nn.Module, model: torch.nn.Module,
               decay: float = 0.995) -> None:
    """ema ← ema·decay + param·(1 − decay), parameter by parameter."""
    for e, p in zip(ema.parameters(), model.parameters()):
        e.copy_(e * decay + p * (1.0 - decay))


class StepDraws(NamedTuple):
    gen_frames: torch.Tensor     # (b,) frame picked in the generator step
    discr_frames: torch.Tensor   # (b,) in the discriminator step


def _grad_norm(g: torch.Tensor) -> torch.Tensor:
    return g.float().square().sum().sqrt()


class CTViTTrainer:
    def __init__(self, model: CTViT, *, lr: float = 1e-4, wd: float = 0.0,
                 discr_lr_mult: float = 0.01, gen_steps_per_discr: int = 3,
                 apply_grad_penalty_every: int = 4,
                 adversarial_weight: float = 1.0, commit_weight: float = 1.0,
                 perceptual_fn: Optional[Callable] = None,
                 use_perceptual: bool = True, perceptual_weight: float = 1.0,
                 vgg=None, results_folder: str = "./results_ctvit",
                 sample_every: int = 1000, save_every: int = 0,
                 seed: int = 0):
        from vit_exp_tpu_torch.models.factory import init_parameters_

        self.model = model
        device = next(model.parameters()).device
        self.device = device
        self.discr = discr = SliceDiscriminator(channels=model.channels,
                                                device=device)
        init_parameters_(discr, seed)
        if perceptual_fn is None and use_perceptual:
            from vit_exp_tpu_torch.models.vgg import (make_perceptual_fn,
                                                      random_vgg16)

            perceptual_fn = make_perceptual_fn(
                vgg if vgg is not None else random_vgg16(seed, device=device))
        self.perceptual_fn = perceptual_fn
        self.gen_steps_per_discr = gen_steps_per_discr
        self.apply_grad_penalty_every = apply_grad_penalty_every
        self.adversarial_weight = adversarial_weight
        self.commit_weight = commit_weight
        self.perceptual_weight = perceptual_weight
        self.sample_every, self.save_every = sample_every, save_every
        self.results_folder = results_folder
        os.makedirs(results_folder, exist_ok=True)
        self.ema = copy.deepcopy(model).requires_grad_(False)
        self.gen_opt = Optimizer(model.parameters(), lr=lr, wd=wd,
                                 max_grad_norm=0.0, warmup_steps=0)
        self.discr_opt = Optimizer(discr.parameters(), lr=lr * discr_lr_mult,
                                   wd=0.0, max_grad_norm=0.0, warmup_steps=0)
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.step = 0

    def draws(self, video: torch.Tensor) -> StepDraws:
        b, t = video.shape[0], video.shape[2]
        g = self.generator
        return StepDraws(
            torch.randint(0, t, (b,), generator=g, device=g.device),
            torch.randint(0, t, (b,), generator=g, device=g.device))

    # -- the two steps ------------------------------------------------------

    def _adaptive_weight(self, trunk, idx, real_frames) -> torch.Tensor:
        """λ from the gradients of the perceptual and generator losses with
        respect to to_pixels.0.weight alone (the trunk held fixed)."""
        w = self.model.to_pixels["0"].weight.detach().requires_grad_(True)
        frames = pick_frames(
            self.model.pixels_from_trunk(trunk.detach(), pixels_weight=w),
            idx)
        (g_perc,) = torch.autograd.grad(
            self.perceptual_fn(frames, real_frames), w, retain_graph=True)
        (g_gen,) = torch.autograd.grad(hinge_gen_loss(self.discr(frames)), w)
        return adaptive_gen_weight(_grad_norm(g_perc),
                                   _grad_norm(g_gen)).detach()

    def gen_step(self, video: torch.Tensor, idx: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
        m = self.model
        self.discr.requires_grad_(False)
        try:
            enc = m.encode_tokens(m.tokens_from_video(video))
            quant, _, commit = m.quantize(enc, update_codebook=True)
            trunk = m.decode_trunk(quant)
            recon = m.pixels_from_trunk(trunk)
            recon_loss = (recon.float() - video.float()).square().mean()
            frames = pick_frames(recon, idx)
            real_frames = pick_frames(video, idx)
            gen_loss = hinge_gen_loss(self.discr(frames))
            zero = torch.zeros((), device=video.device)
            perceptual, adaptive = zero, zero + 1.0
            if self.perceptual_fn is not None:
                perceptual = self.perceptual_fn(frames, real_frames)
                adaptive = self._adaptive_weight(trunk, idx, real_frames)
            loss = (recon_loss + self.commit_weight * commit
                    + self.perceptual_weight * perceptual
                    + self.adversarial_weight * adaptive * gen_loss)
            self.gen_opt.zero_grad()
            loss.backward()
            self.gen_opt.step()
        finally:
            self.discr.requires_grad_(True)
        return {"recon_loss": recon_loss, "commit_loss": commit,
                "gen_loss": gen_loss, "perceptual_loss": perceptual,
                "adaptive_weight": adaptive, "loss": loss}

    def discr_step(self, video: torch.Tensor, idx: torch.Tensor,
                   penalty: bool) -> torch.Tensor:
        with torch.no_grad():
            recon, _, _ = self.model(video, return_encoded_tokens=False,
                                     return_recons=True)
        fake, real = pick_frames(recon, idx), pick_frames(video, idx)
        loss = hinge_discr_loss(self.discr(fake), self.discr(real))
        total = loss
        if penalty:
            total = loss + gradient_penalty(self.discr, real)
        self.discr_opt.zero_grad()
        total.backward()
        self.discr_opt.step()
        return loss

    def train_step(self, video, draws: Optional[StepDraws] = None
                   ) -> Dict[str, float]:
        video = torch.as_tensor(video).to(self.device)
        if draws is None:
            draws = self.draws(video)
        metrics = self.gen_step(video, draws.gen_frames.to(self.device))
        if (self.step + 1) % self.gen_steps_per_discr == 0:
            penalty = (self.apply_grad_penalty_every > 0
                       and self.step % self.apply_grad_penalty_every == 0)
            metrics["discr_loss"] = self.discr_step(
                video, draws.discr_frames.to(self.device), penalty)
        ema_update(self.ema, self.model)
        self.step += 1
        logs = {k: float(v.detach()) for k, v in metrics.items()}
        if self.save_every and self.step % self.save_every == 0:
            self.save()
        if self.sample_every and self.step % self.sample_every == 0:
            recon = self.sample(video[:1])
            np.savez(os.path.join(self.results_folder,
                                  f"recon_{self.step}.npz"),
                     recon[0, 0].float().cpu().numpy())
        return logs

    # -- inference and checkpoints ------------------------------------------

    def ema_model(self) -> CTViT:
        """The EMA weights with the live codebook."""
        self.ema.vq.load_state_dict(self.model.vq.state_dict())
        return self.ema

    @torch.no_grad()
    def sample(self, video: torch.Tensor) -> torch.Tensor:
        recon, _, _ = self.ema_model()(video, return_encoded_tokens=False,
                                       return_recons=True)
        return recon

    def checkpoints(self) -> CheckpointManager:
        return CheckpointManager(os.path.join(self.results_folder,
                                              "checkpoints"))

    def save(self, step: Optional[int] = None) -> None:
        train_state = {
            "model": self.model.state_dict(),
            "discr": self.discr.state_dict(),
            "gen_opt": self.gen_opt.state_dict(),
            "discr_opt": self.discr_opt.state_dict(),
            "step": self.step, "generator": self.generator.get_state()}
        self.checkpoints().save(self.step if step is None else step,
                                self.ema_model().state_dict(), train_state,
                                wait=True)

    def restore(self, step: Optional[int] = None) -> int:
        """Resume from ``ckpt_{step}`` (the latest by default); returns the
        step."""
        mgr = self.checkpoints()
        step = mgr.latest_step() if step is None else step
        state = mgr.restore(step)
        ts = state["train_state"]
        self.model.load_state_dict(ts["model"])
        self.ema.load_state_dict(state["model"])
        self.discr.load_state_dict(ts["discr"])
        self.gen_opt.load_state_dict(ts["gen_opt"])
        self.discr_opt.load_state_dict(ts["discr_opt"])
        self.generator.set_state(ts["generator"])
        self.step = int(ts["step"])
        return step


class MaskGITTrainer:
    """Masked-token CE over frozen-CTViT indices."""

    def __init__(self, pipeline, *, lr: float = 3e-4, seed: int = 0):
        self.pipeline = pipeline
        mg = pipeline.maskgit
        self.opt = AdamWOptax(mg.parameters(), lambda count: lr, 0.0)
        device = next(mg.parameters()).device
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.step = 0

    def fit_batch(self, video, text_ids, text_mask, draws=None) -> float:
        """One Adam step; ``draws`` are the masking's
        (models/maskgit.py::MaskingDraws)."""
        mg = self.pipeline.maskgit
        mg.train()
        loss = self.pipeline.loss(video, text_ids, text_mask, draws=draws,
                                  generator=self.generator)
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        self.step += 1
        return float(loss)

    def save(self, directory: str, step: Optional[int] = None) -> None:
        """MaskGit's weights (``model.pt``) and the optimizer under
        ``directory/ckpt_{step}``; cli/run_maskgit_sample.py loads them."""
        CheckpointManager(directory).save(
            self.step if step is None else step,
            self.pipeline.maskgit.state_dict(),
            {"opt": self.opt.opt.state_dict(), "count": self.opt.count,
             "step": self.step, "generator": self.generator.get_state()},
            wait=True)
