"""ctypes loader of the host pipeline's C helpers (``native/pvo_native.c``)
for the port, with numpy fallbacks.

The port's own copy of :mod:`pvo_tpu.native`'s ``pair_counts`` (the PQ/VPQ
intersection histogram), ``rgb2id`` and ``id2rgb`` (the panoptic PNG
codec; :mod:`pvo_tpu_torch.utils.io` holds their plain versions). The library is built from the
repo's C source with plain ``cc`` into ``pvo_tpu_torch/native_build/``
(ignored by git), under a name that hashes the source, through a
temporary file renamed into place: concurrent processes never see half a
library, and the JAX package's ``native/libpvo_native.so`` is never
touched. Without a C compiler every call takes its numpy branch, which
gives the same keys and counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "pvo_native.c"
BUILD = Path(__file__).resolve().parent / "native_build"
_LIB = None
_TRIED = False


def library_path():
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD / f"libpvo_native_{digest}.so"


def _load():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        path = library_path()
        if not path.exists():
            BUILD.mkdir(exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
            os.close(fd)
            try:
                subprocess.run(["cc", "-O3", "-shared", "-fPIC", "-o", tmp,
                                str(SOURCE)], check=True,
                               capture_output=True)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(str(path))
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.rgb2id.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                               ctypes.POINTER(ctypes.c_uint32),
                               ctypes.c_long]
        lib.rgb2id.restype = None
        lib.id2rgb.argtypes = [ctypes.POINTER(ctypes.c_uint32),
                               ctypes.POINTER(ctypes.c_uint8),
                               ctypes.c_long]
        lib.id2rgb.restype = None
        lib.pair_counts.argtypes = [i64p, i64p, ctypes.c_long,
                                    ctypes.c_int64, i64p, i64p,
                                    ctypes.c_long]
        lib.pair_counts.restype = ctypes.c_long
        _LIB = lib
    except (OSError, subprocess.CalledProcessError):
        _LIB = None
    return _LIB


def available():
    return _load() is not None


def rgb2id(rgb):
    """Panoptic RGB (H, W, 3) -> uint32 id map (id = R + 256 G + 65536 B)."""
    lib = _load()
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if lib is None or rgb.ndim != 3:
        from pvo_tpu_torch.utils.io import rgb2id as np_impl
        return np_impl(rgb)
    out = np.empty(rgb.shape[:2], np.uint32)
    lib.rgb2id(rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
               out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
               rgb.shape[0] * rgb.shape[1])
    return out


def id2rgb(ids):
    """uint32 id map -> panoptic RGB (..., 3) uint8."""
    lib = _load()
    ids = np.ascontiguousarray(ids, np.uint32)
    if lib is None:
        from pvo_tpu_torch.utils.io import id2rgb as np_impl
        return np_impl(ids)
    out = np.empty(ids.shape + (3,), np.uint8)
    lib.id2rgb(ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
               out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ids.size)
    return out


def _unique_counts(a, b, offset):
    keys, counts = np.unique(a * offset + b, return_counts=True)
    return keys, counts.astype(np.int64)


def pair_counts(a, b, offset=2 ** 30, max_out=1 << 20):
    """Counts of the combined keys a*offset+b. Returns (keys, counts),
    keys ascending."""
    a = np.ascontiguousarray(a, np.int64).reshape(-1)
    b = np.ascontiguousarray(b, np.int64).reshape(-1)
    lib = _load()
    if lib is None:
        return _unique_counts(a, b, offset)
    keys = np.empty(max_out, np.int64)
    counts = np.empty(max_out, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    n = lib.pair_counts(a.ctypes.data_as(i64p), b.ctypes.data_as(i64p),
                        len(a), offset, keys.ctypes.data_as(i64p),
                        counts.ctypes.data_as(i64p), max_out)
    if n < 0:
        return _unique_counts(a, b, offset)
    order = np.argsort(keys[:n])
    return keys[:n][order], counts[:n][order]
