"""ctypes bindings for the native host library (``native/matinv_host.cpp``).

A copy of ``gpu_matrix_inversion_tpu/utils/native.py`` (host-only: the
native library knows no device): native counterparts of the host-side
utilities (matrix generation, residual GEMM -- reference
main_file.cpp:41-52, matrix_multiply.cpp). Reads the same
``native/build/libmatinv_host.so`` and falls back to this package's own
NumPy implementations (``utils/generators``, ``utils/residual``) when it
has not been built (``make -C native``).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native", "build",
    "libmatinv_host.so")

_lib: Optional[ctypes.CDLL] = None


def load() -> Optional[ctypes.CDLL]:
    """Load the native host library, or None when unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.matinv_validate.restype = ctypes.c_int
    lib.matinv_validate.argtypes = [ctypes.c_int, ctypes.c_longlong]
    lib.matinv_hollow_random.restype = None
    lib.matinv_hollow_random.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_uint64,
        ctypes.c_float, ctypes.c_float]
    for name in ("matinv_reference_error", "matinv_relative_residual"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_double
        fn.argtypes = [ctypes.POINTER(ctypes.c_double),
                       ctypes.POINTER(ctypes.c_double), ctypes.c_int]
    _lib = lib
    return lib


def available() -> bool:
    return load() is not None


def hollow_random(n: int, *, seed: int = 0, lo: float = 0.0,
                  hi: float = 100.0) -> np.ndarray:
    """Native hollow random matrix; falls back to the NumPy generator."""
    lib = load()
    if lib is None:
        from gpu_matrix_inversion_tpu_torch.utils.generators import (
            hollow_random_matrix)
        return hollow_random_matrix(n, seed=seed)
    out = np.empty((n, n), dtype=np.float32)
    lib.matinv_hollow_random(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, seed, lo, hi)
    return out


def _norm_call(name: str, inv, a) -> float:
    lib = load()
    inv64 = np.ascontiguousarray(inv, dtype=np.float64)
    a64 = np.ascontiguousarray(a, dtype=np.float64)
    n = a64.shape[-1]
    if lib is None:
        from gpu_matrix_inversion_tpu_torch.utils import residual
        py = {"matinv_reference_error": residual.reference_error_metric,
              "matinv_relative_residual": residual.relative_residual}[name]
        return py(a64, inv64)
    fn = getattr(lib, name)
    return float(fn(inv64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    a64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n))


def reference_error(inv, a) -> float:
    """Native ``sqrt(N) - ||inv @ A||_F`` (reference error column)."""
    return _norm_call("matinv_reference_error", inv, a)


def relative_residual(inv, a) -> float:
    """Native normalized residual ``||inv@A - I||_F / (||A|| ||inv||)``."""
    return _norm_call("matinv_relative_residual", inv, a)
