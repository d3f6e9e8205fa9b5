"""Host-side sample loading for the data sets (counterpart of
vit_exp_tpu/data/preprocess_host.py; numpy, the device stage is
ops/preprocess.py).

The npz layout is the reference's offline output: ``arr_0`` of shape
(D, H, W) for volumes and (C, D, H, W) for masks."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from vit_exp_tpu_torch.ops.preprocess import (RUNTIME_TARGET_HWD,
                                              preprocess_mask_numpy,
                                              preprocess_runtime_numpy)


def load_npz_volume(path: str) -> np.ndarray:
    with np.load(path) as data:
        return data["arr_0"]


def runtime_volume(
    img_dhw: np.ndarray, target_hwd: Tuple[int, int, int] = RUNTIME_TARGET_HWD
) -> np.ndarray:
    """A stored (D, H, W) volume → the (1, 240, 480, 480) model input."""
    return preprocess_runtime_numpy(img_dhw, target_hwd)


def runtime_mask(
    mask_cdhw: np.ndarray, target_dhw: Tuple[int, int, int] = (240, 480, 480)
) -> np.ndarray:
    return preprocess_mask_numpy(mask_cdhw, target_dhw)
