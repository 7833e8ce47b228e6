"""Algorithm dispatch: choose the inversion route for size, batch and dtype.

Port of ``gpu_matrix_inversion_tpu/models/solver.py``. One entry point that
routes to

- ``spec``     plain-torch Gauss-Jordan (executable spec; any device)
- ``fused``    kernel K1, the whole [A|I] system in one launch per batch
               (small N and batched workloads)
- ``blocked``  blocked Gauss-Jordan: panel kernels (K2, or K3 + K4 on the
               split path) + GEMMs; fp64 through K3's f32-search tier
- ``lu``       LU factorization (K3 + K5) + getri, and :func:`solve`'s
               triangular solves
- ``cholesky`` potrf + potri for SPD input (library calls, as the
               reference calls XLA's primitives); potrf + potrs in
               :func:`solve`
- ``ns``       Newton-Schulz iteration (pivot-free, GEMMs only; well-
               conditioned matrices and warm starts)

``auto`` picks by shape with the reference's thresholds, unchanged, so
both packages take the same route on the same input: batched or small
fp32/bf16 matrices go to ``fused``, large ones to ``blocked``, small FP64
ones to ``spec``; :func:`solve` takes the LU route from n = 512; ``auto``
never picks ``cholesky``. The reference's ``sharded`` route is not ported
yet and raises ``NotImplementedError``. :class:`Inverter` is the
config-driven session object.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpu_matrix_inversion_tpu_torch.models.newton_schulz import (
    newton_schulz_inverse)
from gpu_matrix_inversion_tpu_torch.ops import lu as lu_ops
from gpu_matrix_inversion_tpu_torch.ops.cholesky import (cholesky_factor,
                                                         cholesky_inverse,
                                                         cholesky_solve)
from gpu_matrix_inversion_tpu_torch.ops.blocked import blocked_inverse
from gpu_matrix_inversion_tpu_torch.ops.fused import (FUSED_MAX_N,
                                                      fused_inverse)
from gpu_matrix_inversion_tpu_torch.ops.gauss_jordan import (
    gauss_jordan_inverse)
from gpu_matrix_inversion_tpu_torch.ops.refine import (newton_schulz_refine,
                                                       refine_solve)
from gpu_matrix_inversion_tpu_torch.utils.config import InversionConfig
from gpu_matrix_inversion_tpu_torch.utils.precision import matmul_precision

METHODS = ("auto", "spec", "fused", "blocked", "lu", "cholesky", "sharded",
           "ns")
_NOT_PORTED = ("sharded",)
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


def _symmetrized_lower(a: torch.Tensor) -> torch.Tensor:
    """``tril(a) + tril(a, -1)^T``: the matrix the Cholesky route reads."""
    return torch.tril(a) + torch.tril(a, -1).mT


def inverse(a: torch.Tensor, *, method: str = "auto", pivot: bool = True,
            block_size: int | None = None, precision: str | None = None,
            search_bf16: bool | None = None):
    """Invert ``a`` (shape ``(..., n, n)``) on its device; returns
    ``(inverse, ok)``.

    ``ok`` is the singularity flag per the reference's empty-on-singular
    contract (SURVEY.md section 2, C10). ``precision``/``search_bf16``
    apply to the blocked route; the others ignore them. An empty input
    ((0, n, n), (k, 0, 0), (0, 0)) raises ``ValueError``.
    """
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    if not isinstance(a, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(a).__name__}")
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected (..., n, n) square matrix, got "
                         f"{tuple(a.shape)}")
    if a.numel() == 0:
        # One answer on every device and route (the JAX package raises too;
        # K1's launcher refuses an empty batch).
        raise ValueError(f"empty input {tuple(a.shape)}: nothing to invert")
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
    if resolved == "lu":
        # Blocked getrf + getri where panel GEMMs pay off; the spec's
        # loops for small systems (solver.py:123-129).
        if a.shape[-1] >= 256:
            return lu_ops.lu_inverse_fast(a)
        return lu_ops.lu_inverse(a)
    if resolved == "cholesky":
        return cholesky_inverse(a)
    if resolved == "ns":
        return newton_schulz_inverse(a)
    return gauss_jordan_inverse(a, pivot=pivot)


def solve(a: torch.Tensor, b: torch.Tensor, *, method: str = "auto",
          pivot: bool = True, block_size: int | None = None,
          refine_iters: int = 0):
    """Solve ``A @ x = b`` on ``a``'s device; returns ``(x, ok)``. ``b`` may
    be ``(..., n, k)`` or a single right-hand side ``(..., n)``.

    The LU route (``method="lu"``, or ``"auto"`` from n = 512) factors and
    runs forward/back substitution; the other methods form the explicit
    inverse and multiply. ``refine_iters`` applies iterative refinement
    reusing the factorization or the inverse (O(n^2 k) per iteration).
    ``method="cholesky"`` runs potrf + potrs and never forms the inverse;
    it reads only ``a``'s lower triangle, and refines against that
    triangle symmetrized.
    """
    if not isinstance(a, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(a).__name__}")
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    vec = b.ndim == a.ndim - 1          # a single right-hand side
    if vec:
        b = b[..., None]
    n = a.shape[-1]
    if method == "cholesky":
        low, ok_f = cholesky_factor(a, **({} if block_size is None
                                          else {"block_size": block_size}))
        x, ok = cholesky_solve(low, b)
        ok = ok_f & ok
        if refine_iters > 0:
            # The factor read only a's lower triangle; the residual uses
            # the same matrix, or a junk upper triangle corrupts every
            # correction (solver.py:159-184).
            asym = _symmetrized_lower(a)
            with matmul_precision("highest"):
                for _ in range(refine_iters):
                    x = x + cholesky_solve(low, b - asym @ x)[0]
    elif method == "lu" or (method == "auto" and n >= _BLOCKED_MIN_N):
        if n >= 256:
            kwargs = {} if block_size is None else {"block_size": block_size}
            lu, perm, ok_f = lu_ops.lu_factor_blocked(a, pivot=pivot,
                                                      **kwargs)
            x, ok_s = lu_ops.lu_solve_fast(lu, perm, b)
        else:
            lu, perm, ok_f = lu_ops.lu_factor(a, pivot=pivot)
            x, ok_s = lu_ops.lu_solve(lu, perm, b)
        ok = ok_f & ok_s
        if refine_iters > 0:
            x = refine_solve(a, b, x, lu, perm, iters=refine_iters)
    else:
        inv, ok = inverse(a, method=method, pivot=pivot,
                          block_size=block_size)
        with matmul_precision("highest"):
            x = inv @ b
            for _ in range(refine_iters):
                # Each correction reuses the inverse: one residual GEMM
                # and one apply.
                x = x + inv @ (b - a @ x)
    if refine_iters > 0:
        ok = ok & torch.isfinite(x).all(dim=(-2, -1))
    if vec:
        x = x[..., 0]
    return x, ok


class Inverter:
    """Config-driven inversion session (the reference's compile-time
    ``#define`` variant selection, main_file.cpp:14-18, as a runtime
    object; port of the JAX package's ``Inverter``).

    Example::

        inv = Inverter(dtype="float32", method="blocked", refine_iters=1)
        x, ok = inv.inverse(a)

    A tensor stays on its device; anything else (a numpy array, a list)
    goes to ``device``, the GPU unless the caller asks for ``"cpu"``. The
    reference's ``mesh`` argument waits for the sharded route.
    """

    def __init__(self, config: InversionConfig | None = None, *,
                 device="cuda", **overrides):
        if config is None:
            config = InversionConfig.from_env(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config.validate()
        self.device = device

    def _cast(self, a) -> torch.Tensor:
        dtype = getattr(torch, self.config.dtype)
        if isinstance(a, torch.Tensor):
            return a.to(dtype)
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def inverse(self, a):
        """``(inverse, ok)`` by the configured route; ``refine_iters > 0``
        adds that many Newton-Schulz steps on top of the route's own (the
        blocked route then polishes twice, as in the reference)."""
        cfg = self.config
        a = self._cast(a)
        x, ok = inverse(a, method=cfg.method, pivot=cfg.pivot,
                        block_size=cfg.block_size, precision=cfg.precision,
                        search_bf16=cfg.search_bf16)
        if cfg.refine_iters > 0:
            if cfg.method == "cholesky":
                # The factor read only the lower triangle: refine against
                # the same symmetrized matrix (solver.py:259-269).
                a = _symmetrized_lower(a)
            x = newton_schulz_refine(a, x, iters=cfg.refine_iters)
            ok = ok & torch.isfinite(x).all(dim=(-2, -1))
        return x, ok

    def solve(self, a, b):
        """``(x, ok)`` of ``A x = b`` with the whole session config;
        refinement happens inside :func:`solve`, reusing the factorization
        or the inverse."""
        cfg = self.config
        a = self._cast(a)
        return solve(a, b, method=cfg.method, pivot=cfg.pivot,
                     block_size=cfg.block_size, refine_iters=cfg.refine_iters)
