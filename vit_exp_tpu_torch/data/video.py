"""Video / NIfTI data of the generative stack (counterpart of
vit_exp_tpu/data/video.py).

- ``VideoTextDataset``: patient/accession/*.nii.gz trees joined to a report
  table (csv or xlsx) by AccessionNo; each volume's metadata JSON gives the
  HU rescale, the manufacturer's slice order ('PNMS' → reversed) and the
  "{age} years old {sex}:" prompt prefix; volumes resampled to (201, 128,
  128) and cut to a frame count ≡ 1 (mod num_frames);
- ``VideoDataset``: unpaired volumes; ``VideoTextSuperresDataset``:
  (lowres, highres, text) triplets over a prior CTViT output tree;
- ``write_nifti``, ``video_to_gif`` / ``video_to_mp4`` (gated on PIL and
  cv2).

numpy only: the resampling weights are this module's own copy, the report
table is read with stdlib ``csv`` or the xlsx reader of data/datasets.py
(no pandas), the volumes with data/nifti.py.  ``read_report_table`` gives
the accession keys the types pandas would infer for a csv column.
"""

from __future__ import annotations

import glob
import gzip
import json
import math
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from vit_exp_tpu_torch.data.datasets import read_csv_rows, read_xlsx_rows
from vit_exp_tpu_torch.data.nifti import read_nifti, read_nifti_shape

_STRIP = str.maketrans("", "", "\"'()")
DEFAULT_TARGET = (201, 128, 128)


def write_nifti(path: str, data: np.ndarray,
                spacing: Tuple[float, ...] = (1.0, 1.0, 1.0)):
    """Minimal NIfTI-1 float32 writer (tensor_to_nifti, data.py:105-125)."""
    data = np.asarray(data, np.float32)
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    dims = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, 16)  # float32
    pix = list(spacing) + [1.0] * (7 - len(spacing))
    struct.pack_into("<8f", hdr, 76, 1.0, *pix)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<h", hdr, 72, 32)  # bitpix
    magic = b"n+1\x00"
    hdr[344:348] = magic
    payload = bytes(hdr) + data.astype("<f4").tobytes(order="F")
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)


def _resample_to(volume_dhw: np.ndarray, target=DEFAULT_TARGET) -> np.ndarray:
    import torch

    from vit_exp_tpu_torch.ops.preprocess import resize_trilinear

    vol = np.ascontiguousarray(volume_dhw, np.float32)
    return resize_trilinear(torch.from_numpy(vol), target).numpy()


def _pil_bilinear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) row-stochastic resampling matrix reproducing PIL's
    antialiased bilinear resize (the torchvision transforms.Resize the
    reference applies per slice, videotextdataset.py:29+111): triangle
    filter whose support scales with the downsample factor, sample centers
    at pixel centers, weights normalized per output pixel."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = filterscale  # bilinear filter support 1.0 × filterscale
    ss = 1.0 / filterscale
    w_mat = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        xs = np.arange(lo, hi)
        w = np.clip(1.0 - np.abs((xs + 0.5 - center) * ss), 0.0, None)
        total = w.sum()
        if total > 0:
            w /= total
        w_mat[i, lo:hi] = w
    return w_mat.astype(np.float32)


def _linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) matrix for torch F.interpolate mode='linear',
    align_corners=False (videotextdataset.py:122 depth axis): source
    coordinate (i+0.5)·scale − 0.5, edge-clamped, NO antialias."""
    scale = n_in / n_out
    w_mat = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        center = max((i + 0.5) * scale - 0.5, 0.0)
        j0 = min(int(center), n_in - 1)
        j1 = min(j0 + 1, n_in - 1)
        frac = center - j0
        w_mat[i, j0] += 1.0 - frac
        w_mat[i, j1] += frac
    return w_mat


def resample_reference(
    volume_dhw: np.ndarray, target=DEFAULT_TARGET
) -> np.ndarray:
    """EXACT reference resample (videotextdataset.py:96-127): per-slice
    PIL antialiased-bilinear resize to target H×W, then trilinear
    F.interpolate to (target_d, H, W) — which, with H/W already at target,
    reduces to non-antialiased linear along depth.  Expressed as three
    separable matrix products (bit-compatible with the PIL+torch pipeline
    to ~1e-6; see tests/test_video_bpe.py oracle test)."""
    vol = np.asarray(volume_dhw, np.float32)
    d_out, h_out, w_out = target
    wh = _pil_bilinear_weights(vol.shape[1], h_out)
    ww = _pil_bilinear_weights(vol.shape[2], w_out)
    # per-slice spatial resize: (d, h, w) → (d, h_out, w_out)
    sp = np.einsum("oh,dhw,pw->dop", wh, vol, ww, optimize=True)
    wd = _linear_weights(vol.shape[0], d_out)
    return np.einsum("od,dhw->ohw", wd, sp, optimize=True)


def load_hu_volume(
    nii_path: str, metadata: Optional[Dict] = None,
    target=DEFAULT_TARGET, resample: str = "reference",
) -> np.ndarray:
    """nii.gz (+ sidecar _metadata.json) → (1, D, H, W) in [-1, 1]
    (nii_img_to_tensor, videotextdataset.py:96-127).

    resample="reference": exact reference semantics — per-slice PIL
    antialiased bilinear + depth-linear (resample_reference).
    resample="trilinear": single fused on-device trilinear (faster, NO
    in-plane antialiasing — measurably different when downsampling)."""
    if metadata is None:
        meta_path = str(nii_path).replace(".nii.gz", "") + "_metadata.json"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                metadata = json.load(f)
        else:
            metadata = {}
    img = read_nifti(nii_path).astype(np.float32)  # (H, W, S)
    slope = int(float(metadata.get("RescaleSlope", 1)))
    intercept = int(float(metadata.get("RescaleIntercept", 0)))
    img = np.clip(slope * img + intercept, -1000, 1000) / 1000.0
    if metadata.get("Manufacturer") == "PNMS":
        img = img[:, :, ::-1]  # reversed slice order quirk
    vol = np.transpose(img, (2, 0, 1))  # (D, H, W)
    if target is not None:
        if resample == "reference":
            vol = resample_reference(vol, target)
        else:
            vol = _resample_to(vol, target)
    return vol[None].astype(np.float32)


def cast_num_frames(video: np.ndarray, frames: int) -> np.ndarray:
    """Crop or edge-repeat the frame axis to EXACTLY `frames` — a fixed-
    shape utility for jit-friendly batching.  NOTE: the reference's
    cast_num_frames (transformer_maskgit data.py:31-38) has different
    semantics — crop to f ≡ 1 (mod frames) for CTViT's first-frame layout
    — implemented here as cast_num_frames_mod1, which is what the
    video datasets apply."""
    d = video.shape[1]
    if d == frames:
        return video
    if d > frames:
        return video[:, :frames]
    pad = np.repeat(video[:, -1:], frames - d, axis=1)
    return np.concatenate([video, pad], axis=1)


def _age_sex_prefix(metadata: Dict) -> str:
    try:
        age = str(metadata["PatientAge"])[:-1].zfill(3)[1:]
    except Exception:
        age = "None"
    sex = str(metadata.get("PatientSex", "None"))
    sex = {"m": "male", "f": "female"}.get(sex.lower(), sex)
    return f"{age} years old {sex}"


class VideoTextDataset:
    def __init__(
        self,
        data_folder: str,
        report_table: str,
        *,
        target=DEFAULT_TARGET,
        num_frames: Optional[int] = None,
        min_slices: int = 100,
        max_slices: int = 600,
    ):
        acc_to_text = read_report_table(report_table)

        self.target = target
        self.num_frames = num_frames
        self.samples: List[Tuple[str, str]] = []
        for patient in sorted(glob.glob(os.path.join(data_folder, "*"))):
            for acc_folder in sorted(glob.glob(os.path.join(patient, "*"))):
                acc = os.path.basename(acc_folder)
                if acc not in acc_to_text:
                    continue
                for nii in sorted(
                    glob.glob(os.path.join(acc_folder, "*.nii.gz"))
                ):
                    # slice-count gate (videotextdataset.py:61-63): skip
                    # scans outside [min_slices, max_slices]; header-only
                    # read, no voxel IO
                    n_slices = read_nifti_shape(nii)[-1]
                    if not (min_slices <= n_slices <= max_slices):
                        continue
                    meta_path = nii.replace(".nii.gz", "") + "_metadata.json"
                    metadata = {}
                    if os.path.exists(meta_path):
                        with open(meta_path) as f:
                            metadata = json.load(f)
                    text = (
                        f"{_age_sex_prefix(metadata)}: {acc_to_text[acc]}"
                    )
                    self.samples.append((nii, text))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict:
        nii, text = self.samples[index]
        video = load_hu_volume(nii, target=self.target)
        if self.num_frames:
            video = cast_num_frames_mod1(video, self.num_frames)
        return {"image": video, "text": text.translate(_STRIP)}


class VideoDataset:
    """Unpaired volumes (data.py:222-313)."""

    def __init__(self, data_folder: str, *, target=DEFAULT_TARGET,
                 num_frames: Optional[int] = None):
        self.paths = sorted(
            glob.glob(os.path.join(data_folder, "**", "*.nii.gz"),
                      recursive=True)
        )
        self.target = target
        self.num_frames = num_frames

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index: int) -> Dict:
        video = load_hu_volume(self.paths[index], target=self.target)
        if self.num_frames:
            video = cast_num_frames_mod1(video, self.num_frames)
        return {"image": video, "data_type": "video"}


def cast_num_frames_mod1(video: np.ndarray, frames: int) -> np.ndarray:
    """Crop the frame axis to f ≡ 1 (mod frames) — CTViT's layout of one
    special first frame + temporal patches of `frames`
    (videotextdatasetsuperres.py:15-22 semantics)."""
    f = video.shape[1]
    r = f % frames
    if r == 1:
        return video
    drop = (frames - 1) if r == 0 else (r - 1)
    return video[:, : f - drop] if drop else video


def default_lowres_path(nii_path: str, lowres_root: str) -> str:
    """The reference pairs each high-res volume with a previously generated
    CTViT reconstruction at {root}/samples.{accession}/{basename}.nii.gz
    (videotextdatasetsuperres.py:63-68)."""
    name = os.path.basename(nii_path)
    acc = os.path.basename(os.path.dirname(nii_path))
    return os.path.join(lowres_root, f"samples.{acc}", name)


class VideoTextSuperresDataset:
    """(lowres, highres, text) triplets for super-resolution training
    (videotextdatasetsuperres.py / videotextdatasettransformersuperres.py /
    videotextdatasetvalidation.py unified):

    - highres: HU volume → [0, 1], trilinear to `target` (default
      (201, 512, 512) per the reference's F.interpolate at :134);
    - lowres: a prior CTViT output volume in [-1, 1] → [0, 1], axes
      permuted (S, W, H) → (D, H, W) (get_lowres_image, :139-146);
    - text: "{age} years old {sex}: {impression}";
    - `sample_list` (txt of volume paths) replaces the tree walk — the
      validation variant's sampled_val.txt (:53-60);
    - frame axes cast to ≡ 1 (mod num_frames) for CTViT temporal patching.
    """

    def __init__(
        self,
        data_folder: str,
        report_table: str,
        lowres_root: str,
        *,
        target=(201, 512, 512),
        num_frames: int = 2,
        sample_list: Optional[str] = None,
        min_slices: int = 100,
        max_slices: int = 600,
    ):
        acc_to_text = read_report_table(report_table)

        self.target = target
        self.num_frames = num_frames
        self.samples: List[Tuple[str, str, str]] = []

        if sample_list is not None:
            with open(sample_list) as f:
                candidates = [ln.strip() for ln in f if ln.strip()]
        else:
            candidates = sorted(
                glob.glob(os.path.join(data_folder, "*", "*", "*.nii.gz"))
            )
        for nii in candidates:
            acc = os.path.basename(os.path.dirname(nii))
            if acc not in acc_to_text:
                continue
            lowres = default_lowres_path(nii, lowres_root)
            if not os.path.exists(lowres):
                continue
            # slice-count gate (videotextdatasetsuperres.py:71: skip
            # shape[-1] < 100 or > 600) — header-only read
            try:
                n_slices = read_nifti_shape(nii)[-1]
            except Exception:
                continue
            if not (min_slices <= n_slices <= max_slices):
                continue
            meta_path = nii.replace(".nii.gz", "") + "_metadata.json"
            metadata = {}
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    metadata = json.load(f)
            text = f"{_age_sex_prefix(metadata)}: {acc_to_text[acc]}"
            self.samples.append((nii, lowres, text))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict:
        nii, lowres_path, text = self.samples[index]
        hi = load_hu_volume(nii, target=self.target)  # (1, D, H, W) [-1, 1]
        hi = (hi + 1.0) / 2.0
        lo = read_nifti(lowres_path).astype(np.float32)  # (H, W, S) [-1, 1]
        lo = np.transpose(lo, (2, 1, 0))[None]  # (1, S, W, H) per reference
        lo = (lo + 1.0) / 2.0
        return {
            "lowres": cast_num_frames_mod1(lo, self.num_frames),
            "image": cast_num_frames_mod1(hi, self.num_frames),
            "text": text.translate(_STRIP),
            "data_type": "videosuperres",
        }


def video_to_gif(video_dhw: np.ndarray, path: str, fps: int = 10):
    """(D, H, W) in [-1, 1] or [0, 1] → animated gif (data.py:129-180)."""
    from PIL import Image

    v = np.asarray(video_dhw, np.float32)
    lo, hi = float(v.min()), float(v.max())
    v8 = ((v - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)
    frames = [Image.fromarray(s) for s in v8]
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)


def video_to_mp4(video_dhw: np.ndarray, path: str, fps: int = 10):
    """(D, H, W) → mp4 via cv2 (data.py:183-219)."""
    import cv2

    v = np.asarray(video_dhw, np.float32)
    lo, hi = float(v.min()), float(v.max())
    v8 = ((v - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)
    h, w = v8.shape[1:]
    writer = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h), isColor=False
    )
    for frame in v8:
        writer.write(frame)
    writer.release()


def _pandas_value(text):
    """A csv cell as pandas infers a numeric column's value: int, then
    float, else the string."""
    for kind in (int, float):
        try:
            return kind(text)
        except (TypeError, ValueError):
            pass
    return text


def read_report_table(path: str) -> Dict:
    """AccessionNo → Impressions of a csv or xlsx report table, keyed as
    pandas keys it: a csv column whose every cell is numeric gives ints (or
    floats), an xlsx cell keeps its own type; a missing impression is
    NaN."""
    if path.endswith(".csv"):
        _, rows = read_csv_rows(path)
        keys = [row["AccessionNo"] for row in rows]
        typed = [_pandas_value(k) for k in keys]
        if all(isinstance(k, (int, float)) for k in typed):
            if any(isinstance(k, float) for k in typed):
                typed = [float(k) for k in typed]
            keys = typed
    else:
        _, rows = read_xlsx_rows(path)
        keys = [row["AccessionNo"] for row in rows]
    return dict(zip(keys, (row.get("Impressions", math.nan) for row in rows)))
