"""The VQGAN-VAE adversarial pieces of CTViT training (counterpart of
vit_exp_tpu/models/gan.py): the hinge and BCE losses, the gradient penalty
on real frames, a 2D convolutional discriminator over frames, and the
adaptive generator-loss weight.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from vit_exp_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from vit_exp_tpu_torch.models.layers import ConvParams, LeakyReLU


def hinge_discr_loss(fake_logits, real_logits):
    return (F.relu(1.0 + fake_logits) + F.relu(1.0 - real_logits)).mean()


def hinge_gen_loss(fake_logits):
    return -fake_logits.mean()


def bce_discr_loss(fake_logits, real_logits):
    return (F.softplus(fake_logits) + F.softplus(-real_logits)).mean()


def bce_gen_loss(fake_logits):
    return F.softplus(-fake_logits).mean()


def gradient_penalty(discr: Callable[[torch.Tensor], torch.Tensor],
                     images: torch.Tensor, weight: float = 10.0
                     ) -> torch.Tensor:
    """weight · E[(‖∇ₓ Σ D(x)‖₂ − 1)²] on the given (real) images, with the
    graph kept so the penalty trains the discriminator; the norm is
    √(Σg² + 1e-12)."""
    images = images.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(discr(images).sum(), images,
                                   create_graph=True)
    norms = torch.sqrt(grads.reshape(grads.shape[0], -1).square().sum(-1)
                       + 1e-12)
    return weight * (norms - 1.0).square().mean()


def _same_pad(size: int, kernel: int, stride: int):
    """flax "SAME" padding of one axis: (low, high); odd sizes pad one
    more at the high end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SliceDiscriminator(nn.Module):
    """Convolutions of kernel 4, stride 2 and flax's SAME padding with
    LeakyReLU(0.1), widths base_dim doubling up to 256, a 1×1 conv to one
    channel, the mean over it: (b, c, H, W) frames → (b,) logits, fp32."""

    def __init__(self, base_dim: int = 16, num_layers: int = 4,
                 channels: int = 1, *, policy: Policy = DEFAULT_POLICY,
                 device=None):
        super().__init__()
        self.num_layers = num_layers
        dim, c_in = base_dim, channels
        for i in range(num_layers):
            self.add_module(f"conv{i}", ConvParams(dim, c_in, 4, 4,
                                                   policy=policy,
                                                   device=device))
            c_in, dim = dim, min(dim * 2, 256)
        self.to_logit = ConvParams(1, c_in, 1, 1, policy=policy,
                                   device=device)
        self.act = LeakyReLU(0.1)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.float()
        for i in range(self.num_layers):
            conv = self._modules[f"conv{i}"]
            ph, pw = (_same_pad(x.shape[2], 4, 2), _same_pad(x.shape[3], 4, 2))
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            x = self.act(F.conv2d(x, conv.weight.float(), conv.bias.float(),
                                  stride=2))
        x = F.conv2d(x, self.to_logit.weight.float(),
                     self.to_logit.bias.float())
        return x.mean(dim=(1, 2, 3))


def adaptive_gen_weight(recon_grad_norm, gen_grad_norm, eps=1e-8,
                        clip_max=1e4):
    """λ = ‖∇ recon‖ / (‖∇ gen‖ + eps), clipped to [0, clip_max]."""
    return (recon_grad_norm / (gen_grad_norm + eps)).clamp(0.0, clip_max)


def pick_frames(video: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(b, c, T, H, W) and idx (b,) → frame idx[i] of each sample
    (b, c, H, W)."""
    return video[torch.arange(video.shape[0], device=video.device), :,
                 idx.to(video.device)]
