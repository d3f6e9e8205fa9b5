"""In-training visual sampling hooks (counterpart of
vit_exp_tpu/eval/vis_hooks.py).

Every ``sample_val_every`` steps the open-vocabulary hook runs
``open_seg_forward`` on the first few volumes of a validation set, takes
each class's similarity map ((cos(voxel embedding, class prompt) + 1) / 2)
and writes three slice grids per class (the downsampled volume, the map,
the downsampled mask) as grayscale PNGs under ``out_dir``.  The JAX package
draws its PNGs through matplotlib; the port writes the same grids with
``utils/vis.py::write_png``.  The model is run in eval mode under
``torch.inference_mode`` and left in the mode it was in.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from vit_exp_tpu_torch.models.ctclip import downsample_stride
from vit_exp_tpu_torch.models.losses import cosine_similarity
from vit_exp_tpu_torch.utils.vis import slice_grid_3d, write_png


def open_seg_grids(model, item: Dict, factor: int) -> Dict[str, np.ndarray]:
    """One item's slice grids: {f"class{c}_{img|sim|gt}": grid}."""
    device = next(model.parameters()).device
    video = torch.as_tensor(np.asarray(item["image"])[None], device=device)
    mask = torch.as_tensor(np.asarray(item["seg_mask"])[None], device=device)
    ids = torch.as_tensor(np.asarray(item["prompt_ids"]), device=device).long()
    pmask = item.get("prompt_mask")
    if pmask is not None:
        pmask = torch.as_tensor(np.asarray(pmask), device=device).long()
    res = model.open_seg_forward(video, ids, pmask, down_factor=factor)
    seg_preds, prompt_logits = res["seg_preds"], res["prompt_logits"]
    mask = downsample_stride(mask, factor)
    # the volume and the mask keep their own dtypes (fp16, uint8), whose
    # arithmetic the grid's normalisation then takes, as in the JAX package
    down_img = downsample_stride(video, factor)[0, 0].cpu().numpy()
    d, w, h = mask.shape[2:]
    out = {}
    for c in range(prompt_logits.shape[1]):
        sim = (cosine_similarity(seg_preds, prompt_logits[:, c][:, None, :])
               + 1.0) / 2.0
        for name, vol in (("img", down_img),
                          ("sim", sim[0].reshape(d, w, h).cpu().numpy()),
                          ("gt", mask[0, c].cpu().numpy())):
            out[f"class{c}_{name}"] = slice_grid_3d(vol)
    return out


def make_open_seg_vis_hook(dataset, *, out_dir: str, n_samples: int = 3,
                           down_factor: Optional[int] = None) -> Callable:
    """Returns hook(model, step) → {f"sample{s}_class{c}_{name}": png
    path}."""

    def hook(model, step: int = 0) -> Dict[str, str]:
        os.makedirs(out_dir, exist_ok=True)
        factor = down_factor or model.clip_arch.open_seg_loss_down_factor
        out: Dict[str, str] = {}
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                for s in range(min(n_samples, len(dataset))):
                    for key, grid in open_seg_grids(model, dataset[s],
                                                    factor).items():
                        path = os.path.join(
                            out_dir, f"step{step}_sample{s}_{key}.png")
                        write_png(path, grid)
                        out[f"sample{s}_{key}"] = path
        finally:
            model.train(was_training)
        return out

    return hook
