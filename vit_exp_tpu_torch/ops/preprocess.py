"""The CT preprocessing chain (counterpart of vit_exp_tpu/ops/preprocess.py),
as plain torch on the tensor's device and as numpy twins for host loaders.
No Pallas kernel is involved: the JAX package runs this as XLA ops.

Offline (the reference's data_preprocess/preprocess_ctrate_train.py):
HU rescale slope·x + intercept → clip [−1000, 1000] → /1000 in fp32 →
transpose (H, W, D) → (D, H, W) → trilinear resample to the spacing
(z 1.5, x/y 0.75) with align_corners=False.

Runtime (the reference's scripts/data.py ``npz_to_tensor``): a stored
(D, H, W) volume → transpose to (H, W, D) → clip [−1, 1] → map to [0, 1] →
centre crop/pad to (480, 480, 240) with the pad value −1 (in the [0, 1]
space: the reference's quirk, kept) → back to (D, H, W) with a channel
axis, (1, 240, 480, 480).

The resample is separable, three 1-D lerps (exactly trilinear
interpolation), each as the JAX package's ``_axis_lerp``: the source
coordinate (i + 0.5)·in/out − 0.5 in fp32, clamped to the edges.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

TARGET_SPACING = (1.5, 0.75, 0.75)  # (z, x, y)
RUNTIME_TARGET_HWD = (480, 480, 240)


def hu_normalize(img: torch.Tensor, slope: float,
                 intercept: float) -> torch.Tensor:
    """HU rescale and window: clip [−1000, 1000], scaled to [−1, 1] fp32.
    The divisor is a tensor: torch on the card turns a division by a Python
    number into a product with its reciprocal, which can be one bit off."""
    x = img.to(torch.float32) * slope + intercept
    return torch.clamp(x, -1000.0, 1000.0) / torch.tensor(
        1000.0, dtype=torch.float32, device=x.device)


def _axis_lerp(x: torch.Tensor, new_size: int, axis: int) -> torch.Tensor:
    """1-D linear resize along ``axis``, align_corners=False: src =
    (i + 0.5)·in/out − 0.5, clamped to [0, in − 1]."""
    in_size = x.shape[axis]
    if in_size == new_size:
        return x
    src = ((torch.arange(new_size, dtype=torch.float32, device=x.device)
            + 0.5) * (in_size / new_size) - 0.5).clamp(0.0, in_size - 1)
    i0 = torch.floor(src).to(torch.int64)
    i1 = torch.clamp_max(i0 + 1, in_size - 1)
    shape = [1] * x.ndim
    shape[axis] = new_size
    w = (src - i0.to(torch.float32)).reshape(shape)
    return (x.index_select(axis, i0) * (1.0 - w)
            + x.index_select(axis, i1) * w)


def resize_trilinear(x: torch.Tensor, new_shape: Sequence[int]) -> torch.Tensor:
    """Trilinear resize of the last three axes to ``new_shape``."""
    offset = x.ndim - 3
    for i, size in enumerate(new_shape):
        x = _axis_lerp(x, int(size), offset + i)
    return x


def spacing_resample_shape(
    shape_dhw: Sequence[int], current_spacing: Sequence[float],
    target_spacing: Sequence[float] = TARGET_SPACING,
) -> Tuple[int, int, int]:
    """new_shape[i] = int(orig[i]·current/target): truncation, not rounding,
    as the reference's resize_array."""
    return tuple(int(shape_dhw[i] * current_spacing[i] / target_spacing[i])
                 for i in range(3))


def preprocess_offline_volume(img_hwd, *, slope: float, intercept: float,
                              new_shape: Tuple[int, int, int],
                              device="cuda") -> torch.Tensor:
    """The offline stage on ``device`` (the card unless the caller asks for
    another): raw (H, W, D) → normalised (D', H', W') fp32."""
    x = hu_normalize(torch.as_tensor(img_hwd, device=device), slope,
                     intercept)
    return resize_trilinear(x.permute(2, 0, 1), new_shape)


def _center_crop_pad_1d(size: int, target: int) -> Tuple[int, int, int]:
    """(crop start, kept length, pad before) of one axis."""
    start = max((size - target) // 2, 0)
    kept = min(start + target, size) - start
    return start, kept, (target - kept) // 2


def _crop_pad_slices(shape, target):
    src, dst = [], []
    for size, tgt in zip(shape, target):
        start, kept, before = _center_crop_pad_1d(size, tgt)
        src.append(slice(start, start + kept))
        dst.append(slice(before, before + kept))
    return tuple(src), tuple(dst)


def crop_pad_hwd(x_hwd: torch.Tensor,
                 target_hwd: Tuple[int, int, int] = RUNTIME_TARGET_HWD,
                 pad_value: float = -1.0) -> torch.Tensor:
    """Centre crop/pad of (H, W, D) to ``target_hwd``, padded with
    ``pad_value`` (−1, the reference's)."""
    src, dst = _crop_pad_slices(x_hwd.shape, target_hwd)
    out = x_hwd.new_full(tuple(target_hwd), pad_value)
    out[dst] = x_hwd[src]
    return out


def preprocess_runtime_volume(img_dhw, target_hwd: Tuple[int, int, int] =
                              RUNTIME_TARGET_HWD,
                              device="cuda") -> torch.Tensor:
    """The runtime stage on ``device``: a stored (D, H, W) volume →
    (1, 240, 480, 480) fp32."""
    x = torch.as_tensor(img_dhw, device=device).to(torch.float32)
    x = (torch.clamp(x.permute(1, 2, 0), -1.0, 1.0) + 1.0) / 2.0
    return crop_pad_hwd(x, target_hwd, -1.0).permute(2, 0, 1)[None]


def preprocess_runtime_numpy(
    img_dhw: np.ndarray, target_hwd: Tuple[int, int, int] = RUNTIME_TARGET_HWD,
) -> np.ndarray:
    """The numpy twin of ``preprocess_runtime_volume`` for host loaders.
    The crop/pad of (H, W, D) is done on (D, H, W) with the slices
    permuted, and the clip and map only on the kept voxels: the same fp32
    operations on each voxel, without the two transposed copies."""
    d, h, w = img_dhw.shape
    src, dst = _crop_pad_slices((h, w, d), target_hwd)
    out = np.full((target_hwd[2], target_hwd[0], target_hwd[1]), -1.0,
                  dtype=np.float32)
    x = img_dhw[src[2], src[0], src[1]].astype(np.float32)
    np.clip(x, -1.0, 1.0, out=x)
    x += 1.0
    x /= 2.0
    out[dst[2], dst[0], dst[1]] = x
    return out[None]


def preprocess_mask_numpy(
    mask_cdhw: np.ndarray,
    target_dhw: Tuple[int, int, int] = (240, 480, 480),
) -> np.ndarray:
    """The runtime mask crop/pad: (C, D, H, W) → (C, 240, 480, 480) fp32,
    padded with 0 (the reference's npz_mask_to_tensor)."""
    c = mask_cdhw.shape[0]
    out = np.zeros((c,) + tuple(target_dhw), dtype=np.float32)
    src, dst = _crop_pad_slices(mask_cdhw.shape[1:], target_dhw)
    # cast while copying: no fp32 temporary (4.87 GB for 22 classes)
    np.copyto(out[(slice(None),) + dst], mask_cdhw[(slice(None),) + src],
              casting="unsafe")
    return out
