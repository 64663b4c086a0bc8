"""Native (C++) data-plane acceleration.

The reference's runtime is native C++ for CPU-side reasons (TBB pipeline,
protobuf decode, MKL math — reference: src/mf.h:6-70, src/Makefile). This
rebuild keeps the *data plane* native: a small C++ library (mfdata.cpp) that
parses/writes length-prefixed protobuf block streams and shuffles/bins COO
ratings at memory-bandwidth speed, exposed through ctypes with a pure-Python
fallback (tpu_mf.data.proto). Build it with ``make -C tpu_mf/native``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB = None
_LIB_TRIED = False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    here = os.path.dirname(os.path.abspath(__file__))
    for name in ("libmfdata.so",):
        path = os.path.join(here, name)
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                lib.mfdata_count_frames.restype = ctypes.c_longlong
                lib.mfdata_count_frames.argtypes = [ctypes.c_char_p]
                lib.mfdata_parse_frames.restype = ctypes.c_longlong
                lib.mfdata_parse_frames.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_longlong,
                ]
                lib.mfdata_write_frames.restype = ctypes.c_longlong
                lib.mfdata_write_frames.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_longlong,
                    ctypes.c_int,
                ]
                _LIB = lib
            except OSError:
                _LIB = None
            break
    return _LIB


def available() -> bool:
    return _load() is not None


def parse_frames_native(
    path: str,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Parse a length-prefixed protobuf block stream with the C++ fast path.

    Returns (u, v, r) arrays, or None if the native library is unavailable
    (callers fall back to the pure-Python codec).
    """
    lib = _load()
    if lib is None:
        return None
    n = lib.mfdata_count_frames(path.encode())
    if n < 0:
        raise IOError(f"native frame count failed for {path} (code {n})")
    u = np.empty(n, np.int32)
    v = np.empty(n, np.int32)
    r = np.empty(n, np.float32)
    got = lib.mfdata_parse_frames(
        path.encode(),
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
    )
    if got < 0:
        raise IOError(f"native frame parse failed for {path} (code {got})")
    return u[:got], v[:got], r[:got]


def write_frames_native(
    path: str,
    u: np.ndarray,
    v: np.ndarray,
    r: np.ndarray,
    users_per_block: int = 1000,
) -> bool:
    """Write a block stream with the C++ fast path. Input must be sorted by u.
    Returns False if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return False
    u = np.ascontiguousarray(u, np.int32)
    v = np.ascontiguousarray(v, np.int32)
    r = np.ascontiguousarray(r, np.float32)
    rc = lib.mfdata_write_frames(
        path.encode(),
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(u),
        users_per_block,
    )
    if rc < 0:
        raise IOError(f"native frame write failed for {path} (code {rc})")
    return True
