"""Algorithm dispatch: choose the inversion route for size, batch and dtype.

Port of ``gpu_matrix_inversion_tpu/models/solver.py``. One entry point that
routes to

- ``spec``     plain-torch Gauss-Jordan (executable spec; any device)
- ``fused``    kernel K1, the whole [A|I] system in one launch per batch
               (small N and batched workloads)
- ``blocked``  blocked Gauss-Jordan: kernel K2 per panel + FP32 GEMMs

``auto`` picks by shape with the reference's thresholds, unchanged, so
both packages take the same route on the same input: batched or small
fp32/bf16 matrices go to ``fused``, large ones to ``blocked``, small FP64
ones to ``spec``. The reference's ``lu``, ``cholesky``, ``ns`` and
``sharded`` routes are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from gpu_matrix_inversion_tpu_torch.ops.blocked import blocked_inverse
from gpu_matrix_inversion_tpu_torch.ops.fused import (FUSED_MAX_N,
                                                      fused_inverse)
from gpu_matrix_inversion_tpu_torch.ops.gauss_jordan import (
    gauss_jordan_inverse)

METHODS = ("auto", "spec", "fused", "blocked", "lu", "cholesky", "sharded",
           "ns")
_NOT_PORTED = ("lu", "cholesky", "sharded", "ns")
_BLOCKED_MIN_N = 512
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _resolve(method: str, a: torch.Tensor) -> str:
    """The reference's routing (solver.py:56-68) without its multi-chip
    branch (n >= 32768 with a mesh), which is not ported yet."""
    if method != "auto":
        return method
    n = a.shape[-1]
    fits_fused = n <= FUSED_MAX_N and a.dtype in _KERNEL_DTYPES
    if fits_fused and (a.ndim > 2 or n < _BLOCKED_MIN_N):
        return "fused"
    if a.dtype in _KERNEL_DTYPES or n >= _BLOCKED_MIN_N:
        return "blocked"
    return "spec"


def inverse(a: torch.Tensor, *, method: str = "auto", pivot: bool = True,
            block_size: int | None = None, precision: str | None = None,
            search_bf16: bool | None = None):
    """Invert ``a`` (shape ``(..., n, n)``) on its device; returns
    ``(inverse, ok)``.

    ``ok`` is the singularity flag per the reference's empty-on-singular
    contract (SURVEY.md section 2, C10). ``precision``/``search_bf16``
    apply to the blocked route; the others ignore them.
    """
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    if not isinstance(a, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(a).__name__}")
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected (..., n, n) square matrix, got "
                         f"{tuple(a.shape)}")
    resolved = _resolve(method, a)
    if resolved in _NOT_PORTED:
        raise NotImplementedError(
            f"method={resolved!r} is not ported yet (ROADMAP Queue 1)")
    if resolved == "fused":
        # The reference serves method="fused" on dtypes or sizes the kernel
        # does not take with the spec (solver.py:107-112).
        if a.dtype in _KERNEL_DTYPES and a.shape[-1] <= FUSED_MAX_N:
            return fused_inverse(a, pivot=pivot)
        resolved = "spec"
    if resolved == "blocked":
        kwargs = {}
        if block_size is not None:
            kwargs["block_size"] = block_size
        if precision is not None:
            kwargs["precision"] = precision
        if search_bf16 is not None:
            kwargs["search_bf16"] = search_bf16
        return blocked_inverse(a, pivot=pivot, **kwargs)
    return gauss_jordan_inverse(a, pivot=pivot)
