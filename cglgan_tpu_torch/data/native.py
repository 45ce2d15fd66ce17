"""ctypes binding to the native dataplane (``native/libdataplane.so``).

The port's own binding to the same shared library as
``cglgan_tpu/data/native.py`` (a file read, not an import of that package),
so the ``auto`` glyph backend yields the same bytes as the reference.  As
there, a missing library is built once with the repo Makefile (g++); when
that fails or the file does not load, ``load_library`` returns None and
``auto`` callers take the numpy backend.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "native", "libdataplane.so")


def load_library() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = library_path()
    if not os.path.exists(so):
        try:
            subprocess.run(["make", "-C", os.path.dirname(so)], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:          # built for another libc/arch than this host
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.synth_glyphs.argtypes = [u8p, i64p, ctypes.c_int64, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_uint64]
    lib.synth_glyphs.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def available() -> bool:
    return load_library() is not None


def synth_glyphs(n: int, side: int = 28, num_class: int = 10,
                 seed: int = 20211212) -> Tuple[np.ndarray, np.ndarray]:
    """Native label-sorted glyph dataset (uint8 (n, side, side), int64
    labels).  Raises RuntimeError when the library is unavailable."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native dataplane unavailable")
    out = np.empty((n, side, side), np.uint8)
    labels = np.empty((n,), np.int64)
    rc = lib.synth_glyphs(out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                          n, side, num_class, ctypes.c_uint64(seed))
    if rc != 0:
        raise RuntimeError(f"synth_glyphs failed: {rc}")
    return out, labels
