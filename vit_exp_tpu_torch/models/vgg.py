"""VGG16 features for the CTViT VQGAN perceptual loss (counterpart of
vit_exp_tpu/models/vgg.py).

``VGG16Features`` is torchvision's vgg16 with its keys: ``features.{i}``
(13 convolutions with ReLU, 5 max-pools), the 7×7 average pool, and with
``include_classifier`` the first two classifier Linears with ReLU
(``classifier.0`` and ``classifier.3``, fc6/fc7: a 4096 vector), so a
torchvision ``vgg16().state_dict()`` loads by name (``strict=False`` drops
the last classifier layer).  Without the classifier (the seeded random
default, ``random_vgg16``) the output is the flattened 512·7·7 pool.
torchvision is not needed: the layers are written out.

``make_perceptual_fn(vgg)`` is the trainer's perceptual term: frames
resized to 224 (bilinear; from a smaller frame this is upsampling, which
matches jax.image.resize; a larger frame is antialiased), grayscale
repeated to 3 channels, the MSE of the two feature vectors.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from vit_exp_tpu_torch.core.precision import FP32_POLICY
from vit_exp_tpu_torch.models.layers import ConvParams, Linear

# torchvision vgg16.features: widths, "M" a 2×2 max-pool; the convolutions
# sit at these indices of the Sequential
CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
       512, 512, 512, "M", 512, 512, 512, "M"]
CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]


class VGG16Features(nn.Module):
    def __init__(self, include_classifier: bool = True, device=None):
        super().__init__()
        kw = dict(policy=FP32_POLICY, device=device)
        layers, c_in = [], 3
        for item in CFG:
            if item == "M":
                layers += [nn.MaxPool2d(2, 2)]
            else:
                layers += [ConvParams(item, c_in, 3, 3, **kw), nn.ReLU()]
                c_in = item
        self.features = nn.Sequential(*layers)
        self.classifier = (nn.Sequential(
            Linear(512 * 7 * 7, 4096, **kw), nn.ReLU(), nn.Identity(),
            Linear(4096, 4096, **kw), nn.ReLU())
            if include_classifier else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (b, 3, H, W), H and W multiples of 32, fp32."""
        x = x.float()
        for m in self.features:
            x = (F.conv2d(x, m.weight, m.bias, padding=1)
                 if isinstance(m, ConvParams) else m(x))
        b, c, h, w = x.shape
        x = x.reshape(b, c, 7, h // 7, 7, w // 7).mean(dim=(3, 5))
        x = x.reshape(b, -1)
        return x if self.classifier is None else self.classifier(x)


def random_vgg16(seed: int = 0, include_classifier: bool = False,
                 device=None) -> VGG16Features:
    """VGG16 features with seeded random weights (lecun normal, zero bias):
    a random-feature perceptual metric."""
    from vit_exp_tpu_torch.models.factory import init_parameters_

    model = VGG16Features(include_classifier, device=device)
    init_parameters_(model, seed)
    return model.requires_grad_(False)


def resize_frames_224(frames: torch.Tensor) -> torch.Tensor:
    """(b, c, H, W) → (b, 3, 224, 224): bilinear, grayscale repeated."""
    h, w = frames.shape[2:]
    x = F.interpolate(frames.float(), size=(224, 224), mode="bilinear",
                      align_corners=False, antialias=h > 224 or w > 224)
    return x.repeat(1, 3, 1, 1) if x.shape[1] == 1 else x


def make_perceptual_fn(vgg: VGG16Features
                       ) -> Callable[[torch.Tensor, torch.Tensor],
                                     torch.Tensor]:
    """perceptual_fn(x, y): the MSE of the VGG features of two frame
    batches."""

    def perceptual_fn(x, y):
        return (vgg(resize_frames_224(x))
                - vgg(resize_frames_224(y))).square().mean()

    return perceptual_fn
