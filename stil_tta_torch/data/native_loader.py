"""ctypes binding of the native batch gather
(``stil_tta_torch/data/native/loader.cpp``), the port of
``stil_tta_tpu/data/native_loader.py``.

The source is compiled with ``g++`` at first use into
``stil_tta_torch/build/libloader-<digest>.so``; the digest covers the
source, the flags, the compiler's version and the C library, so an
edited source or another machine's build never loads. A failed build
raises with the compiler's output: there is no numpy fallback (the JAX
package falls back to numpy when its build fails; the numbers are the
same either way). Nothing here runs at import time.

:func:`gather_rows` may write into a buffer the caller owns (``out``, a
pinned host tensor's memory through ``tensor.numpy()``), so
:class:`~stil_tta_torch.data.loader.HostStream` copies each batch once
on the host. The call releases the GIL. :func:`gather_rows_plain` and
:func:`gather_rows_scaled_plain` are the numpy versions the tests hold
the native ones to.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

PACKAGE = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).resolve().parent / "native" / "loader.cpp"
BUILD = PACKAGE / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def _compiler() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found is None:
        raise RuntimeError("g++ not found: the native gather of "
                           "stil_tta_torch needs a C++ compiler")
    return found


@functools.cache
def library_path() -> Path:
    """The library's path for this source, these flags, this compiler
    and this C library."""
    cxx = _compiler()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, check=True).stdout
    key = b"".join([SOURCE.read_bytes(), " ".join(CXX_FLAGS).encode(),
                    version.encode(), platform.machine().encode(),
                    " ".join(platform.libc_ver()).encode()])
    return BUILD / f"libloader-{hashlib.sha256(key).hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/loader.cpp`` unless its library exists; returns
    the library's path. Each process compiles to its own temporary file
    and renames it into place."""
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and open the library."""
    lib = ctypes.CDLL(str(build()))
    lib.gather_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int]
    lib.gather_rows.restype = None
    lib.gather_rows_u8_to_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_float, ctypes.c_int]
    lib.gather_rows_u8_to_f32.restype = None
    return lib


def _threads(n_threads: int) -> int:
    return n_threads or min(os.cpu_count() or 1, 8)


def _prepare(src: np.ndarray, idx, out: Optional[np.ndarray], dtype
             ) -> tuple:
    """Checked (idx as int64, out) for a gather of ``src``'s rows."""
    if not src.flags.c_contiguous:
        raise ValueError("the native gather needs a C-contiguous source")
    idx = np.ascontiguousarray(idx, np.int64)
    if idx.ndim != 1:
        raise ValueError(f"idx must be 1-D, got shape {idx.shape}")
    if len(idx) and (idx.min() < 0 or idx.max() >= len(src)):
        raise IndexError(f"row index out of range [0, {len(src)})")
    shape = (len(idx),) + src.shape[1:]
    if out is None:
        out = np.empty(shape, dtype)
    elif (out.shape != shape or out.dtype != dtype
          or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(f"out must be a writable C-contiguous {dtype} "
                         f"array of shape {shape}")
    return idx, out


def gather_rows(src: np.ndarray, idx, out: Optional[np.ndarray] = None,
                n_threads: int = 0) -> np.ndarray:
    """``src[idx]`` for a C-contiguous (possibly memmapped) array, copied
    by native threads into ``out`` (a new array if None); returns it."""
    idx, out = _prepare(src, idx, out, src.dtype)
    row_bytes = int(np.prod(src.shape[1:], dtype=np.int64)) \
        * src.dtype.itemsize
    load().gather_rows(src.ctypes.data, idx.ctypes.data, len(idx),
                       row_bytes, out.ctypes.data, _threads(n_threads))
    return out


def gather_rows_scaled(src: np.ndarray, idx, scale: float = 1.0 / 255.0,
                       out: Optional[np.ndarray] = None,
                       n_threads: int = 0) -> np.ndarray:
    """``src[idx].astype(float32) * scale`` for uint8 rows in one native
    pass; ``TypeError`` for another dtype."""
    if src.dtype != np.uint8:
        raise TypeError(f"gather_rows_scaled reads uint8 rows, not "
                        f"{src.dtype}")
    idx, out = _prepare(src, idx, out, np.dtype(np.float32))
    row_elems = int(np.prod(src.shape[1:], dtype=np.int64))
    load().gather_rows_u8_to_f32(src.ctypes.data, idx.ctypes.data,
                                 len(idx), row_elems, out.ctypes.data,
                                 ctypes.c_float(scale), _threads(n_threads))
    return out


def gather_rows_plain(src: np.ndarray, idx) -> np.ndarray:
    """The numpy version of :func:`gather_rows`."""
    return np.ascontiguousarray(src[np.asarray(idx, np.int64)])


def gather_rows_scaled_plain(src: np.ndarray, idx,
                             scale: float = 1.0 / 255.0) -> np.ndarray:
    """The numpy version of :func:`gather_rows_scaled`."""
    return src[np.asarray(idx, np.int64)].astype(np.float32) \
        * np.float32(scale)
