"""The native packed-shard reader: ctypes bindings for ``packed_reader.cpp``
(counterpart of vit_exp_tpu/native/__init__.py, with the same C ABI and the
same numpy fallbacks).

The library is built on first use with the system g++ into
``build/native/`` at the root of the checkout (``build/`` is git-ignored),
under a name that carries a hash of the source, the flags and the host's
``-march=native`` target: a checkout copied to another machine builds its
own library instead of loading one compiled for a foreign instruction set.
``available()`` says whether the library loaded, ``build_error()`` why not;
every entry point falls back to numpy without it, so callers never require
it.

The readers issue positional reads on a C++ thread pool and fuse the
fp16/int16 → fp32 conversion, with the GIL released for the call (ctypes
drops it), where a numpy memmap slice faults its pages and casts on one
thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "packed_reader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]

_DTYPE_CODES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float16): 1,
    np.dtype(np.int16): 2,
    np.dtype(np.uint8): 3,
}

_lock = threading.Lock()
_lib = None
_build_error: Optional[str] = None


def _march_native() -> str:
    """The compiler's own reading of -march=native on this host (its cc1plus
    line), or "" when g++ cannot be asked."""
    try:
        probe = subprocess.run(
            ["g++", "-march=native", "-E", "-v", "-", "-o", os.devnull],
            input="", capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return ""
    return next((line for line in probe.stderr.splitlines()
                 if "cc1plus" in line and "-march=" in line), "")


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS + ["-march=native"]).encode())
    h.update(platform.machine().encode())
    h.update(_march_native().encode())
    return BUILD_DIR / f"libpacked_reader_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> Optional[str]:
    """Compile the library to ``path`` unless it is there; returns an error
    string or None.  -march=native vectorizes the conversion loops for this
    host; the build is retried without it for a toolchain that refuses it."""
    if path.exists():
        return None
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        base = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
        proc = subprocess.run(base + ["-march=native"], capture_output=True,
                              text=True, timeout=120)
        if proc.returncode != 0:
            proc = subprocess.run(base, capture_output=True, text=True,
                                  timeout=120)
        if proc.returncode != 0:
            return proc.stderr[:2000]
        os.replace(tmp, path)
        return None
    except (OSError, subprocess.SubprocessError) as e:   # no g++, read-only
        return str(e)


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        path = library_path()
        err = _build(path)
        if err is not None:
            _build_error = err
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            _build_error = str(e)
            return None
        ll = ctypes.c_longlong
        llp = ctypes.POINTER(ll)
        u8p = ctypes.POINTER(ctypes.c_ubyte)
        f32p = ctypes.POINTER(ctypes.c_float)
        intp = ctypes.POINTER(ctypes.c_int)
        lib.vx_read_batch.restype = ctypes.c_int
        lib.vx_read_batch.argtypes = [intp, llp, llp, llp, ll, u8p,
                                      ctypes.c_int]
        lib.vx_convert_f32.restype = ctypes.c_int
        lib.vx_convert_f32.argtypes = [u8p, ctypes.c_int, ll, f32p,
                                       ctypes.c_float, ctypes.c_float,
                                       ctypes.c_int]
        lib.vx_read_convert_f32.restype = ctypes.c_int
        lib.vx_read_convert_f32.argtypes = [intp, llp, llp, ctypes.c_int,
                                            llp, ll, f32p, ctypes.c_float,
                                            ctypes.c_float, u8p, ll,
                                            ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def default_threads() -> int:
    return min(8, os.cpu_count() or 1)


def _as_ll_array(values) -> np.ndarray:
    return np.ascontiguousarray(values, dtype=np.int64)


def _ll_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))


def read_batch(fds, offsets, nbytes, out_offsets, out: np.ndarray,
               threads: Optional[int] = None) -> None:
    """Parallel pread of records (fds[i], offsets[i], nbytes[i]) into the
    uint8 buffer ``out`` at byte positions out_offsets[i]."""
    lib = _load()
    n = len(offsets)
    if n == 0:
        return
    offs = _as_ll_array(offsets)
    sizes = _as_ll_array(nbytes)
    outs = _as_ll_array(out_offsets)
    if lib is None:   # the fallback: sequential os.pread
        for i in range(n):
            data = os.pread(int(fds[i]), int(sizes[i]), int(offs[i]))
            out[int(outs[i]): int(outs[i]) + len(data)] = np.frombuffer(
                data, dtype=np.uint8)
        return
    fda = np.ascontiguousarray(fds, dtype=np.int32)
    rc = lib.vx_read_batch(
        fda.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        _ll_ptr(offs), _ll_ptr(sizes), _ll_ptr(outs),
        ctypes.c_longlong(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.c_int(threads or default_threads()),
    )
    if rc != 0:
        raise OSError(-rc, f"vx_read_batch failed: {os.strerror(-rc)}")


def convert_f32(src: np.ndarray, dst: np.ndarray, *, scale: float = 1.0,
                shift: float = 0.0, threads: Optional[int] = None) -> None:
    """dst[:] = src·scale + shift, elementwise on a thread pool; ``src`` a
    contiguous float32, float16, int16 or uint8 array, ``dst`` float32."""
    code = _DTYPE_CODES.get(src.dtype)
    lib = _load()
    if lib is None or code is None:
        np.multiply(src.astype(np.float32), np.float32(scale), out=dst)
        if shift:
            dst += np.float32(shift)
        return
    rc = lib.vx_convert_f32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.c_int(code), ctypes.c_longlong(src.size),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_float(scale), ctypes.c_float(shift),
        ctypes.c_int(threads or default_threads()),
    )
    if rc != 0:
        raise OSError(-rc, "vx_convert_f32 failed")


def read_convert_f32(fds, offsets, nbytes, src_dtype: np.dtype,
                     out_elem_offsets, dst: np.ndarray, *,
                     scale: float = 1.0, shift: float = 0.0,
                     threads: Optional[int] = None) -> None:
    """Parallel pread with the dtype conversion fused, into the float32
    buffer ``dst`` at element offsets out_elem_offsets[i]."""
    n = len(offsets)
    if n == 0:
        return
    code = _DTYPE_CODES.get(np.dtype(src_dtype))
    lib = _load()
    offs = _as_ll_array(offsets)
    sizes = _as_ll_array(nbytes)
    outs = _as_ll_array(out_elem_offsets)
    if lib is None or code is None:   # no g++, or a dtype the library lacks
        itemsize = np.dtype(src_dtype).itemsize
        for i in range(n):
            raw = os.pread(int(fds[i]), int(sizes[i]), int(offs[i]))
            arr = np.frombuffer(raw, dtype=src_dtype).astype(np.float32)
            if scale != 1.0 or shift != 0.0:
                arr = arr * np.float32(scale) + np.float32(shift)
            lo = int(outs[i])
            dst.reshape(-1)[lo: lo + int(sizes[i]) // itemsize] = arr
        return
    nthreads = max(1, min(threads or default_threads(), n))
    stride = int(max(sizes))
    scratch = np.empty(nthreads * stride, dtype=np.uint8)
    fda = np.ascontiguousarray(fds, dtype=np.int32)
    rc = lib.vx_read_convert_f32(
        fda.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        _ll_ptr(offs), _ll_ptr(sizes), ctypes.c_int(code),
        _ll_ptr(outs), ctypes.c_longlong(n),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_float(scale), ctypes.c_float(shift),
        scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.c_longlong(stride), ctypes.c_int(nthreads),
    )
    if rc != 0:
        raise OSError(-rc, f"vx_read_convert_f32: {os.strerror(-rc)}")
