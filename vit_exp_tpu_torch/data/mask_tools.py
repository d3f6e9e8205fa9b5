"""Offline mask alignment and integrity tools (counterpart of
vit_exp_tpu/data/mask_tools.py; numpy, with the resize in torch):

- ``align_mask_to_image``: a scan-level mask to its image: the (0, 3, 1, 2)
  reorder, a trilinear resize to the image's shape where they differ
  (``ops/preprocess.py::resize_trilinear`` on ``device``, the card unless
  the caller asks for another), then any nonzero value is foreground;
- ``reorder_mask``: (C, H, W, D) → (C, D, H, W);
- ``flip_mask_by_metadata``: a z flip and an in-plane transpose;
- ``check_npz_tree``: a parallel load test of every npz under a root;
- ``compare_name_sets``: the npz names of an image and a mask tree, set
  against set;
- ``copy_tree_parallel``: a resumable threaded tree copy (data staging).
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch

from vit_exp_tpu_torch.ops.preprocess import resize_trilinear


def _resize_mask_trilinear(mask_cdhw: np.ndarray, target_dhw,
                           device) -> np.ndarray:
    x = torch.as_tensor(np.asarray(mask_cdhw, np.float32), device=device)
    return resize_trilinear(x, target_dhw).cpu().numpy()


def reorder_mask(mask: np.ndarray) -> np.ndarray:
    """(C, H, W, D) → (C, D, H, W)."""
    if mask.ndim != 4:
        raise ValueError(f"a mask is (C, H, W, D); got {mask.shape}")
    return np.transpose(mask, (0, 3, 1, 2))


def align_mask_to_image(mask: np.ndarray,
                        image_shape_dhw: Tuple[int, int, int], *,
                        reorder: bool = True, binarize: bool = True,
                        device="cuda") -> np.ndarray:
    """Scan-level mask → image-aligned (C, D, H, W) float32.  The reorder
    comes first and is unconditional (a cubic mask is transposed too);
    after a resize, any nonzero interpolated value is foreground (not a 0.5
    threshold)."""
    if reorder:
        mask = reorder_mask(mask)
    if mask.shape[1:] != tuple(image_shape_dhw):
        mask = _resize_mask_trilinear(mask, image_shape_dhw, device)
        if binarize:
            mask = (mask != 0).astype(np.float32)
    return mask.astype(np.float32)


def flip_mask_by_metadata(mask: np.ndarray, *, z_flip: bool = False,
                          xy_transpose: bool = False) -> np.ndarray:
    """The orientation fixes the metadata asks for: a flip of the z axis
    and/or a transpose of the in-plane axes."""
    out = mask
    if z_flip:
        out = out[:, ::-1]
    if xy_transpose:
        out = np.transpose(out, (0, 1, 3, 2))
    return np.ascontiguousarray(out)


def check_npz_tree(root: str, workers: int = 8) -> Dict[str, str]:
    """Load-test every npz under ``root``; returns {path: error} of the
    files that fail."""
    paths: List[str] = []
    for dirpath, _, names in os.walk(root):
        paths += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".npz")]

    def check(path):
        try:
            with np.load(path) as d:
                _ = d["arr_0"].shape
            return path, None
        except Exception as e:  # noqa: BLE001 -- every failure is reported
            return path, str(e)

    failures = {}
    with ThreadPoolExecutor(workers) as pool:
        for path, err in pool.map(check, paths):
            if err:
                failures[path] = err
    return failures


def compare_name_sets(img_folder: str, mask_folder: str,
                      strip=lambda name: name) -> Dict[str, List[str]]:
    """The npz basenames (through ``strip``) of two trees: only in the
    images, only in the masks, in both."""

    def names(root):
        out = set()
        for _, _, files in os.walk(root):
            out |= {strip(f) for f in files if f.endswith(".npz")}
        return out

    imgs, masks = names(img_folder), names(mask_folder)
    return {"img_only": sorted(imgs - masks),
            "mask_only": sorted(masks - imgs),
            "common": sorted(imgs & masks)}


def copy_tree_parallel(src_root: str, dst_root: str, workers: int = 8,
                       skip_existing: bool = True) -> int:
    """Copy a tree on a thread pool; returns the number of files copied.
    With ``skip_existing`` a file already there at the same size is left,
    so an interrupted copy resumes."""
    jobs: List[tuple] = []
    for dirpath, _, names in os.walk(src_root):
        rel = os.path.relpath(dirpath, src_root)
        out_dir = os.path.join(dst_root, rel) if rel != "." else dst_root
        os.makedirs(out_dir, exist_ok=True)
        for n in names:
            src, dst = os.path.join(dirpath, n), os.path.join(out_dir, n)
            if (skip_existing and os.path.exists(dst)
                    and os.path.getsize(dst) == os.path.getsize(src)):
                continue
            jobs.append((src, dst))

    def copy(job):
        shutil.copyfile(job[0], job[1])
        return 1

    with ThreadPoolExecutor(workers) as pool:
        return sum(pool.map(copy, jobs))
