"""Build and bind the hand-written CUDA kernels of ``csrc/``.

The sources have a plain C interface.  On first use they are compiled by
``nvcc`` for sm_90a, one object per file in parallel, linked into one shared
library and loaded with ``ctypes``.  The library lives in ``build/torch_kernels/``
at the root of the checkout (``build/`` is git-ignored) under a name that
carries a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()`` after the launch; :func:`launch` raises when that is
not ``cudaSuccess``.  Pointers and the stream travel as ``c_void_p``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
L = ctypes.c_longlong

# C signature of every entry point (return type is int: a cudaError_t)
SIGNATURES = {
    # q, k, v, nk, nv, bound, out, lse (or null), q/k/v/out strides
    # (b, h, n) ×4, B, H, Nq, Nkv, n_null, head dim, scale, stream
    "vit_flash_static_fwd": [P] * 8 + [L] * 12 + [I] * 6 + [F, P],
    # q, k, v, out, lse (or null), q/k/v/out strides (b, h, n) ×4, B, H, Nq,
    # Nkv, head dim, scale, stream
    "vit_flash_online_fwd": [P] * 5 + [L] * 12 + [I] * 5 + [F, P],
    # q, k, v, dout, lse, delta, dk, dv, q/k/v/dout/dk/dv strides ×6,
    # B, H, Nq, Nkv, head dim, scale, stream
    "vit_flash_bwd_dkv": [P] * 8 + [L] * 18 + [I] * 5 + [F, P],
    # q, k, v, dout, lse, delta, dq, q/k/v/dout/dq strides ×5,
    # B, H, Nq, Nkv, head dim, scale, stream
    "vit_flash_bwd_dq": [P] * 7 + [L] * 15 + [I] * 5 + [F, P],
    # x, mu, inv, gamma, beta, y, M, D, stream
    "vit_geglu_bwd_y": [P] * 6 + [I, I, P],
    # y, dout, w1, w2, dh, act, M, D, I2, stream
    "vit_geglu_bwd_dh": [P] * 6 + [I, I, I, P],
    # dh, w1, dy, M, D, I2, stream
    "vit_geglu_bwd_dy": [P] * 3 + [I, I, I, P],
    # x, mu, inv, gamma, dy, dx, dgamma partials, dbeta partials, M, D,
    # stream
    "vit_geglu_bwd_dx": [P] * 8 + [I, I, P],
    # a, b, partials, M, P, Q, lda, ldb, S, seg, stream
    "vit_wgrad": [P, P, P, I, I, I, I, I, I, I, P],
    # partials, out, S, N, stream
    "vit_sum_rows": [P, P, I, L, P],
    # x, mu, inv, xn, M, D, stream
    "vit_geglu_ff_x": [P] * 4 + [I, I, P],
    # xn, w1p, d1, act, M, D, I2, stream
    "vit_geglu_ff_h": [P] * 4 + [I, I, I, P],
    # act, w2, out, M, D, I2, stream
    "vit_geglu_ff_o": [P] * 3 + [I, I, I, P],
    # x, mu, inv, w, c, out, M, K, F, Fq, stream
    "vit_ln_qkv_fwd": [P, P, P, P, P, P, I, I, I, I, P],
    # x, kc, csum, dvec, out, mu, sq, BT, CPT, H, W, p1, p2, D, eps, stream
    "vit_patch_embed_fwd": [P] * 7 + [I] * 7 + [F, P],
    # BT, CPT, H, W, p1, p2, D (no launch: the shared memory, 0 if refused)
    "vit_patch_embed_check": [I] * 7,
    # q8, k8, v, qe, qn, nk, nv, bound, out, q8/k8/v/out/qe strides
    # (b, h, n) ×5, B, H, Nq, Nkv, n_null, head dim, stream
    "vit_flash_static_int8_fwd": [P] * 9 + [L] * 15 + [I] * 6 + [P],
    # x, mu, inv, gamma, beta, y8, sy, M, D, stream
    "vit_geglu_int8_y": [P] * 7 + [I, I, P],
    # y8, sy, w1t, s1, act, amax partials, M, D, I2, stream
    "vit_geglu_int8_h": [P] * 6 + [I, I, I, P],
    # act, amax partials, a8, sa, M, I2, stream
    "vit_geglu_int8_q": [P] * 4 + [I, I, P],
    # a8, sa, w2t, s2, out, M, D, I2, stream
    "vit_geglu_int8_o": [P] * 5 + [I, I, I, P],
    # x, mu, x8, sx, M, K, stream
    "vit_ln_qkv_int8_x": [P] * 4 + [I, I, P],
    # x8, sx, mu, inv, wt, sc, c, q, k, v, M, K, F, Fq, Fk, stream
    "vit_ln_qkv_int8_mm": [P] * 10 + [I] * 5 + [P],
    # x, wt (F × K), sc, out, M, K, F, stream
    "vit_proj_int8_fwd": [P] * 4 + [I, I, I, P],
}

_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    return BUILD_DIR / f"libvit_kernels_{source_hash()}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _run(cmd):
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{res.stdout}\n{res.stderr}")
    return res.stdout + res.stderr


def build() -> Path:
    """Compile the kernels if no library for the current sources exists;
    return the library's path.  The compiler's output (with ptxas register
    and shared-memory counts) is kept beside it, with the suffix .log."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    work = BUILD_DIR / f"tmp_{os.getpid()}"
    work.mkdir(exist_ok=True)
    cus = sorted(CSRC.glob("*.cu"))
    objs = [work / (p.stem + ".o") for p in cus]
    with concurrent.futures.ThreadPoolExecutor(len(cus)) as pool:
        logs = list(pool.map(
            lambda so: _run([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                             str(so[0]), "-o", str(so[1])]),
            zip(cus, objs)))
    tmp_lib = work / lib_path.name
    logs.append(_run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp_lib),
                      *map(str, objs)]))
    os.replace(tmp_lib, lib_path)
    shutil.rmtree(work, ignore_errors=True)
    lib_path.with_suffix(".log").write_text("\n".join(logs))
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def launch(name: str, *args) -> None:
    """Call entry point ``name`` on PyTorch's current stream; raise if the
    launch was refused."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device: the kernels take
    nothing else, and nothing falls back to the plain version.  Also raise
    when autograd would record the call: a launch writes through raw
    pointers, so its output has no graph; differentiable callers go through
    the ops' ``torch.autograd.Function``s, which launch with grad off."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device, "
                             f"got {t.device} and {dev}")
    refuse_grad(name, *tensors, why="call the op's autograd Function, not "
                                     "the raw kernel wrapper")


def refuse_grad(name: str, *tensors, why: str) -> None:
    """Raise when autograd would record a call on these tensors (None
    entries are skipped): the caller has no backward to offer."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: an input requires grad; {why}")
