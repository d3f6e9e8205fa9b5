"""Visual self-supervision over the image tower (counterpart of
vit_exp_tpu/models/visual_ssl.py): SimSiam or SimCLR on two augmented
views of the batch's volumes.

``random_augment_3d`` is split into its draws (``draw_augment``: two flip
bits and two N(0, 1) numbers a volume, from an explicit generator) and a
pure function of them: flip H, then W, where the bits say, then scale by
1 + 0.1·n₁ and shift by 0.05·n₂, in fp32 (the product and sum of a bf16
volume promote to fp32, as in JAX).  It is plain PyTorch: the JAX package
runs it in plain XLA, not in a kernel.  At full width a view of batch 4 is
a (4, 1, 240, 480, 480) fp32 tensor, 0.88 GB.

The heads (``ProjectionMLP`` 512 → 256, ``PredictionMLP`` 128 → 256: Linear
→ LayerNorm (eps 1e-6, flax's) → ReLU → Linear) run in fp32 on the pooled
tokens, named as the flax modules (fc0, ln0, out / fc1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vit_exp_tpu_torch.core.precision import FP32_POLICY
from vit_exp_tpu_torch.models.layers import BiasLayerNorm, Linear


class AugmentDraws(NamedTuple):
    flips: torch.Tensor   # (b, 2) bool on the host: flip H, flip W
    scale: torch.Tensor   # (b,) N(0, 1)
    shift: torch.Tensor   # (b,) N(0, 1)


def draw_augment(b: int, generator: torch.Generator) -> AugmentDraws:
    """The draws of one view of a batch of b volumes (a host generator)."""
    flips = torch.rand((b, 2), generator=generator) < 0.5
    scale = torch.randn((b,), generator=generator)
    shift = torch.randn((b,), generator=generator)
    return AugmentDraws(flips, scale, shift)


def random_augment_3d(video: torch.Tensor,
                      draws: AugmentDraws) -> torch.Tensor:
    """(b, c, D, H, W) → the augmented view (fp32 or wider)."""
    dtype = torch.promote_types(video.dtype, torch.float32)
    scale = 1.0 + 0.1 * draws.scale.float().to(video.device)
    shift = 0.05 * draws.shift.float().to(video.device)
    out = torch.empty(video.shape, dtype=dtype, device=video.device)
    for i, (fh, fw) in enumerate(draws.flips.tolist()):
        dims = [d for d, f in ((-2, fh), (-1, fw)) if f]
        v = video[i].flip(dims) if dims else video[i]
        torch.add(v * scale[i], shift[i], out=out[i])
    return out


def nt_xent_loss(z1: torch.Tensor, z2: torch.Tensor,
                 temperature: float = 0.1) -> torch.Tensor:
    """SimCLR's NT-Xent: each view's partner is its positive, every other
    of the 2b rows a negative (the diagonal at −inf)."""
    b = z1.shape[0]
    z = torch.cat([z1, z2]).float()
    z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    sim = (z @ z.T) / temperature
    eye = torch.eye(2 * b, dtype=torch.bool, device=z.device)
    sim = sim.masked_fill(eye, float("-inf"))
    targets = torch.cat([torch.arange(b) + b, torch.arange(b)]).to(z.device)
    logp = F.log_softmax(sim, dim=-1)
    return -logp.gather(-1, targets[:, None]).mean()


def simsiam_loss(p1, z1, p2, z2) -> torch.Tensor:
    """Symmetric negative cosine with stop-gradient targets."""

    def d(p, z):
        z = z.detach()
        p = p / torch.linalg.vector_norm(p, dim=-1, keepdim=True)
        z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
        return -(p * z).sum(-1).mean()

    return (d(p1, z2) + d(p2, z1)) / 2


class _MLP(nn.Module):
    """Linear → LayerNorm → ReLU → Linear in fp32; the last Linear takes
    the name ``last`` gives it."""

    def __init__(self, d_in: int, hidden: int, out: int, last: str, *,
                 device=None):
        super().__init__()
        kw = dict(policy=FP32_POLICY, device=device)
        self.fc0 = Linear(d_in, hidden, **kw)
        self.ln0 = BiasLayerNorm(hidden, eps=1e-6, **kw)
        self.last = last
        self.add_module(last, Linear(hidden, out, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.ln0(self.fc0(x.float())))
        return self._modules[self.last](x)


class ProjectionMLP(_MLP):
    def __init__(self, d_in: int, hidden: int = 512, out: int = 256, *,
                 device=None):
        super().__init__(d_in, hidden, out, "out", device=device)


class PredictionMLP(_MLP):
    def __init__(self, d_in: int = 256, hidden: int = 128, out: int = 256, *,
                 device=None):
        super().__init__(d_in, hidden, out, "fc1", device=device)
