"""ctypes bindings for the native batched WAV decoder (csrc/wavio.cpp).

Counterpart of the JAX package's ``data/native_wavio.py``, with the same
functions and signatures. The library is built at first use by
``ops/_build.py`` (g++ with the JAX package's ``native/Makefile`` flags) into
``build/kernels/libwavio-<digest>.so``. Where it cannot be built or loaded
(no compiler), the callers fall back to the numpy codec in ``audio_io``,
which gives the same samples; that fallback logs one warning. The batch entry
point decodes N files in parallel C++ threads straight into one padded
(N, capacity) float32 matrix. The decoder releases the GIL, so the
extractor's decode threads run in parallel.
"""

from __future__ import annotations

import ctypes
import logging
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops import _build

logger = logging.getLogger(__name__)

_lib = None
_load_attempted = False
_lock = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        try:
            lib = _build.load_library("wavio")
        except (RuntimeError, OSError) as exc:
            logger.warning("native WAV reader unavailable (%s); decoding with the numpy codec", exc)
            return None
        lib.wavio_decode.restype = ctypes.c_long
        lib.wavio_decode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.POINTER(ctypes.c_int),
        ]
        lib.wavio_decode_batch.restype = None
        lib.wavio_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.POINTER(ctypes.c_float),
            ctypes.c_long, ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ]
        _lib = lib
        logger.debug("native wavio loaded: %s", _build.library_path("wavio"))
        return _lib


def available() -> bool:
    return _load() is not None


def decode(path: Path | str, capacity: int) -> Optional[tuple[np.ndarray, int]]:
    """Decode one file to mono float32 (trimmed to its true length). None on
    any failure (the caller falls back to the numpy codec)."""
    lib = _load()
    if lib is None:
        return None
    out = np.zeros(capacity, np.float32)
    rate = ctypes.c_int(0)
    n = lib.wavio_decode(
        str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), capacity, ctypes.byref(rate),
    )
    if n < 0:
        return None
    return out[:n], rate.value


def decode_batch(paths: list[Path | str], capacity: int, n_threads: int = 0):
    """Parallel batch decode -> (waves (N, capacity) f32, lengths (N,),
    rates (N,)); lengths < 0 mark per-file failures. None when the native
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    out = np.zeros((n, capacity), np.float32)
    lengths = np.zeros(n, np.int64)
    rates = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.wavio_decode_batch(
        c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), capacity,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads,
    )
    return out, lengths, rates
