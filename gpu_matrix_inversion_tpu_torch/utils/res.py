"""Phase-timing record: the port's analog of the reference's ``Res`` struct.

A copy of ``gpu_matrix_inversion_tpu/utils/res.py`` (numpy-only; importing
the JAX package's module would run its ``__init__``, which imports JAX).

The reference's benchmark variants accumulate 10-11 phase wall-clock timings
plus the inverse into ``Res {inversa64, times, inversa32}``
(``res_struct.h:4-6``, ``FP32_bench.cpp:256-443``). Phase slots there are:
queue, buffers, compile, makeAugmented, pivot, row, column, totalCompute,
getInverted, total (plus crr/copy for the no-pivot bench).

The phases that survive are: kernel build + warm-up, device transfer,
compute (ended by a device synchronize), readback, total. The ``times`` dict
keys below map onto the reference's slots where a counterpart exists.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class Res:
    """Result + phase timings (reference ``res_struct.h:4-6``)."""

    inversa32: Optional[np.ndarray] = None   # FP32 inverse (flat, row-major)
    inversa64: Optional[np.ndarray] = None   # FP64 inverse (flat, row-major)
    times: Dict[str, float] = dataclasses.field(default_factory=dict)
    ok: bool = True
    # Strict identity self-check (reference FP32.cpp:814-835 re-reads the
    # reduced augmented matrix and verifies the left half is exactly I):
    # max elementwise |A @ X - I| computed on device when the opt-in
    # strict-verify mode runs; None otherwise.
    identity_error: Optional[float] = None

    def times_vector(self, *, no_pivot: bool = False) -> list:
        """Reference-ordered timing vector (FP32_bench.cpp slot order).

        ``no_pivot=True`` appends the crr/copy slots of the no-pivot bench
        (``matrix_inversion_no_pivots_benchmark.cpp:492-495``). On TPU both
        stages are fused into the factor kernel (the diagonal fetch is the
        trivial branch of the pivot search; no column snapshot exists
        because elimination is out-of-place in registers), so the slots
        exist for Res parity and read 0 unless a profiler fills them.
        """
        order = ["queue", "buffers", "compile", "make_augmented", "pivot",
                 "row"]
        if no_pivot:
            order += ["crr", "copy"]
        order += ["column", "total_compute", "get_inverted", "total"]
        return [self.times.get(k, 0.0) for k in order]


class PhaseTimer:
    """Accumulates named wall-clock spans (reference std::chrono spans,
    matrix_inversion_FP32.cpp:256-263)."""

    def __init__(self):
        self.times: Dict[str, float] = {}
        self._start = time.perf_counter()

    def span(self, name: str):
        timer = self

        class _Span:
            def __enter__(self_inner):
                self_inner.t0 = time.perf_counter()
                return self_inner

            def __exit__(self_inner, *exc):
                timer.times[name] = timer.times.get(name, 0.0) + (
                    time.perf_counter() - self_inner.t0)
                return False

        return _Span()

    def total(self) -> float:
        return time.perf_counter() - self._start
