"""Public flat-vector API: parity with the reference's C++ surface.

Port of ``gpu_matrix_inversion_tpu/api.py``. Reference surface
(``headers.h:7-16``, ``Matlab/mat_inv_32.h:4``):

- ``matrix_inversion_FP32(vector<float>, int)  -> vector<float>``
- ``matrix_inversion_FP64(vector<double>, int) -> vector<double>``
- ``matrix_inversion_no_pivots(vector<double>, int) -> vector<double>``
- ``FP32_bench / FP64_bench / no_pivots_bench   -> Res`` (timings + inverse)
- ``matrix_inv_32`` (the shipped MATLAB-facing library entry point)
- ``matrix_multiply(inverse, A, N) -> double``  (residual check)

Contract: flat row-major vector + matrix order in; inverse as flat numpy
vector out; **empty vector** on any failure -- non-square input, order <= 0,
or a singular matrix (``matrix_inversion_FP32.cpp:11-12``,
``mat_inv_32.cpp:206-215``). Internal failures raise, as in the JAX
package: swallowing them as "singular matrix" misdiagnoses real bugs.

Every function takes ``device`` as a keyword, ``"cuda"`` by default. The
CPU is used only when ``device="cpu"`` is passed; without CUDA the default
raises instead of carrying on elsewhere.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gpu_matrix_inversion_tpu_torch.models import solver
from gpu_matrix_inversion_tpu_torch.utils.precision import matmul_precision
from gpu_matrix_inversion_tpu_torch.utils.res import Res, PhaseTimer
from gpu_matrix_inversion_tpu_torch.utils.residual import (
    reference_error_metric)
from gpu_matrix_inversion_tpu_torch.utils.validation import (
    validate_flat_matrix)


def _to_device(mat: np.ndarray, dtype, device) -> torch.Tensor:
    host = np.ascontiguousarray(mat, dtype=dtype)
    return torch.from_numpy(host).to(device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _invert_flat(flat, order: int, dtype, *, pivot: bool, device,
                 method: str = "auto") -> np.ndarray:
    """Shared flat-vector inversion core; returns flat inverse or empty."""
    mat = validate_flat_matrix(flat, order)
    if mat is None:
        return np.empty(0, dtype=dtype)
    a = _to_device(mat, dtype, device)
    inv, ok = solver.inverse(a, method=method, pivot=pivot)
    if not bool(ok):
        return np.empty(0, dtype=dtype)
    return inv.cpu().numpy().reshape(-1).astype(dtype)


def matrix_inv_32(flat, order: int, *, device="cuda") -> np.ndarray:
    """The shipped product API (reference ``Matlab/mat_inv_32.h:4``):
    FP32, partial pivoting, flat row-major in/out, empty on failure."""
    return _invert_flat(flat, order, np.float32, pivot=True, device=device)


def matrix_inversion_fp32(flat, order: int, *, verbose: bool = False,
                          strict_verify: bool | None = None,
                          device="cuda") -> np.ndarray:
    """Reference ``matrix_inversion_FP32()`` (headers.h:8).

    ``verbose=True`` reproduces the reference's chatty single-shot path
    (device dump at startup, per-phase timing report -- FP32.cpp:304-333,
    :711-723) on top of the same contract, including its identity
    self-check (FP32.cpp:814-835); pass ``strict_verify=False`` to skip
    it."""
    if not verbose:
        return _invert_flat(flat, order, np.float32, pivot=True,
                            device=device)
    import json
    from gpu_matrix_inversion_tpu_torch.utils.profiling import (
        device_info, print_phase_report)
    print("device:", json.dumps(device_info(device)))
    res = _bench(flat, order, np.float32, pivot=True, device=device,
                 strict_verify=(True if strict_verify is None
                                else strict_verify))
    print_phase_report(res, order)
    if not res.ok:
        return np.empty(0, dtype=np.float32)
    return res.inversa32


def matrix_inversion_fp64(flat, order: int, *, device="cuda") -> np.ndarray:
    """Reference ``matrix_inversion_FP64()`` (headers.h:9). n < 512 runs
    the spec; larger n the blocked route's FP64 tiers (K3's f32 search,
    or the logical panel past its reach)."""
    return _invert_flat(flat, order, np.float64, pivot=True, device=device)


def matrix_inversion_no_pivots(flat, order: int, *,
                               device="cuda") -> np.ndarray:
    """Reference ``matrix_inversion_no_pivots()`` (headers.h:10): FP64
    Gauss-Jordan assuming a nonzero diagonal throughout elimination."""
    return _invert_flat(flat, order, np.float64, pivot=False, device=device)


def identity_check_tolerance(order: int, dtype) -> float:
    """Gate of the strict identity self-check: max|A@X - I| at
    1e3 * eps * n (api.py:106-122 of the JAX package, which derives it).
    The reference's check is exact (FP32.cpp:814-835); a blocked GEMM
    algorithm cannot promise exact zeros, and the error grows linearly
    with n."""
    eps = float(np.finfo(dtype).eps)
    return 1e3 * eps * float(order)


def _strict_identity_error(a: torch.Tensor, inv: torch.Tensor) -> float:
    """max elementwise |A @ X - I|, computed on the device in true FP32
    (or FP64) -- the reference's identity self-check promoted to a
    quantitative diagnostic (FP32.cpp:814-835)."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    with matmul_precision("highest"):
        return float((a @ inv - eye).abs().max())


def _bench(flat, order: int, dtype, *, pivot: bool, device,
           strict_verify: bool | None = None) -> Res:
    """Shared bench core: phase-timed inversion returning a ``Res``.

    Phase mapping from the reference's slots (``FP32_bench.cpp:256-443``):
    buffers -> host-to-device transfer; compile -> the first call (kernel
    build on first use, plus warm-up); make_augmented/pivot/row/column ->
    inside total_compute (the kernels replace the reference's 5-kernel x
    N-iteration host loop), filled by ``benchmarks/phases.py`` with
    ``MATINV_DEBUG_PHASES=1``; get_inverted -> readback. Every span ends
    with a device synchronize, so it measures the device work, not its
    enqueue.

    ``strict_verify`` (or env ``MATINV_STRICT_VERIFY=1``) adds the identity
    self-check: max|A@X - I| in ``Res.identity_error``, gating ``ok`` at
    :func:`identity_check_tolerance`.
    """
    if strict_verify is None:
        strict_verify = os.environ.get("MATINV_STRICT_VERIFY") == "1"
    timer = PhaseTimer()
    res = Res()
    mat = validate_flat_matrix(flat, order)
    if mat is None:
        res.ok = False
        res.times = dict(timer.times, total=timer.total())
        return res
    with timer.span("buffers"):
        a = _to_device(mat, dtype, device)
        _sync(device)
    with timer.span("compile"):
        inv, ok = solver.inverse(a, pivot=pivot)
        _sync(device)
    with timer.span("total_compute"):
        inv, ok = solver.inverse(a, pivot=pivot)
        _sync(device)
    ok = bool(ok)
    if strict_verify:
        with timer.span("identity_check"):
            res.identity_error = _strict_identity_error(a, inv)
        ok = ok and (res.identity_error
                     <= identity_check_tolerance(order, dtype))
    with timer.span("get_inverted"):
        out = inv.cpu().numpy().reshape(-1)
    res.ok = ok
    if not res.ok:
        out = np.empty(0, dtype=dtype)
    if dtype == np.float64:
        res.inversa64 = out.astype(np.float64)
    else:
        res.inversa32 = out.astype(np.float32)
    res.times = dict(timer.times, total=timer.total())
    # MATINV_DEBUG_PHASES=1: fill the reference's make_augmented / pivot /
    # row / column slots from benchmarks/phases.py (api.py:196-207 of the
    # JAX package), where `auto` takes the blocked route. It runs after
    # `total` is final and keeps the span-measured total_compute.
    if (os.environ.get("MATINV_DEBUG_PHASES") == "1" and res.ok
            and dtype == np.float32 and order >= 512):
        from gpu_matrix_inversion_tpu_torch.benchmarks.phases import (
            measure_phases)
        phases = measure_phases(order, pivot=pivot, k=2, reps=1,
                                device=device)
        phases.pop("total_compute", None)
        res.times.update(phases)
    return res


def fp32_bench(flat, order: int, *, strict_verify: bool | None = None,
               device="cuda") -> Res:
    """Reference ``FP32_bench()`` (headers.h:13, FP32_bench.cpp:11)."""
    return _bench(flat, order, np.float32, pivot=True, device=device,
                  strict_verify=strict_verify)


def fp64_bench(flat, order: int, *, strict_verify: bool | None = None,
               device="cuda") -> Res:
    """Reference ``FP64_bench()`` (headers.h:14, FP64_bench.cpp:11)."""
    return _bench(flat, order, np.float64, pivot=True, device=device,
                  strict_verify=strict_verify)


def no_pivots_bench(flat, order: int, *, strict_verify: bool | None = None,
                    device="cuda") -> Res:
    """Reference ``matrix_inversion_no_pivots_bench()`` (headers.h:15).

    The crr/copy Res slots of the reference's no-pivot benchmark
    (``..._no_pivots_benchmark.cpp:492-495``) read zero: both stages are
    fused into the kernels here (see ``Res.times_vector``).
    """
    res = _bench(flat, order, np.float64, pivot=False, device=device,
                 strict_verify=strict_verify)
    res.times.setdefault("crr", 0.0)
    res.times.setdefault("copy", 0.0)
    return res


def matrix_multiply(inverse_flat, a_flat, order: int, *,
                    device="cuda") -> float:
    """Verification GEMM + residual (reference ``matrix_multiply.cpp:15``):
    ``sqrt(N) - ||A_inv @ A||_F`` with the product on the device, in true
    FP32 (or FP64 for fp64 inputs, as the reference multiplies in double)."""
    inv = validate_flat_matrix(inverse_flat, order)
    a = validate_flat_matrix(a_flat, order)
    if inv is None or a is None:
        return float("nan")
    dtype = (np.float64 if np.asarray(inv).dtype == np.float64
             else np.float32)
    with matmul_precision("highest"):
        prod = _to_device(inv, dtype, device) @ _to_device(a, dtype, device)
    return reference_error_metric(np.eye(order), prod.cpu().numpy())
