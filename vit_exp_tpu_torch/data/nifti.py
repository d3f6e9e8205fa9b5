"""NIfTI-1 reader (counterpart of vit_exp_tpu/data/nifti.py; stdlib gzip and
numpy, no nibabel).

Reads .nii and .nii.gz volumes as ``nib.load().get_fdata()`` does for the
CT-RATE files the reference preprocesses: little- or big-endian NIfTI-1,
``scl_slope``/``scl_inter`` applied (a slope of 0 or NaN, or a NaN
intercept, means unscaled), the data in the file's (x, y, z) Fortran axis
order.  Data types: uint8, int8, int16, uint16, int32, uint32, float32,
float64.
"""

from __future__ import annotations

import gzip
import math
import struct
from typing import Tuple

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
    64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32,
}


def _open(path):
    return gzip.open(path, "rb") if str(path).endswith(".gz") else open(
        path, "rb")


def _endian(raw: bytes, path) -> str:
    if struct.unpack("<i", raw[:4])[0] == 348:
        return "<"
    if struct.unpack(">i", raw[:4])[0] == 348:
        return ">"
    raise ValueError(f"{path}: not a NIfTI-1 file")


def read_nifti_shape(path: str) -> tuple:
    """The shape from the 348-byte header alone (no voxel is inflated)."""
    with _open(path) as f:
        raw = f.read(348)
    dim = struct.unpack(_endian(raw, path) + "8h", raw[40:56])
    return tuple(dim[1:1 + dim[0]])


def read_nifti(path: str) -> np.ndarray:
    with _open(path) as f:
        raw = f.read()
    endian = _endian(raw, path)
    dim = struct.unpack(endian + "8h", raw[40:56])
    shape = tuple(dim[1:1 + dim[0]])
    datatype = struct.unpack(endian + "h", raw[70:72])[0]
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    vox_offset = int(struct.unpack(endian + "f", raw[108:112])[0])
    scl_slope = struct.unpack(endian + "f", raw[112:116])[0]
    scl_inter = struct.unpack(endian + "f", raw[116:120])[0]

    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
    data = np.frombuffer(raw, dtype=dtype, count=int(np.prod(shape)),
                         offset=vox_offset).reshape(shape, order="F")
    # nibabel's rule: a slope of 0 or NaN leaves the data unscaled, and the
    # intercept is then ignored too
    scaled = scl_slope not in (0.0, 1.0) or scl_inter != 0.0
    if scaled and not (math.isnan(scl_slope) or scl_slope == 0.0
                       or math.isnan(scl_inter)):
        data = data.astype(np.float64) * scl_slope + scl_inter
    return np.asarray(data)


def read_nifti_spacing(path: str) -> Tuple[np.ndarray, Tuple[float, ...]]:
    """(data, the pixdim spacing of each axis)."""
    with _open(path) as f:
        raw = f.read(256)
    endian = _endian(raw, path)
    dim = struct.unpack(endian + "8h", raw[40:56])
    pixdim = struct.unpack(endian + "8f", raw[76:108])
    return read_nifti(path), tuple(float(p) for p in pixdim[1:1 + dim[0]])
