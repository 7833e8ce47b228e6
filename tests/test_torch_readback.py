"""The flat API's readback on ``device="cpu"`` (``api._readback``): the
answer's form, its memory, its bits, the empty-vector cases and
``api.stats()``, for ``matrix_inv_32``, ``matrix_inversion_fp64`` and
``matrix_inversion_no_pivots``, and the three ``*_bench`` calls that share
the path.

A CPU answer is copied once into a fresh array, so it shares no memory
with the caller's input (which the staging step may hand to the route
uncopied) nor with another answer. The card's side (page-locked blocks of
torch's host cache, their reuse, the pageable fall-back) is in
``tests/test_torch_cuda.py``.
"""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gpu_matrix_inversion_tpu_torch import api  # noqa: E402
from gpu_matrix_inversion_tpu_torch.models import solver  # noqa: E402
from gpu_matrix_inversion_tpu_torch.utils.generators import (  # noqa: E402
    hollow_random_matrix)

N = 48
# (flat API, its bench twin, dtype, pivot)
CALLS = {
    "matrix_inv_32": (api.matrix_inv_32, api.fp32_bench, np.float32, True),
    "matrix_inversion_fp64": (api.matrix_inversion_fp64, api.fp64_bench,
                              np.float64, True),
    "matrix_inversion_no_pivots": (api.matrix_inversion_no_pivots,
                                   api.no_pivots_bench, np.float64, False),
}


def _flat(dtype, seed: int) -> np.ndarray:
    """A hollow matrix made diagonally dominant, so the no-pivot route
    answers too, as the flat vector the API takes (already contiguous and
    of the call's dtype, so staging it copies nothing on the CPU)."""
    a = hollow_random_matrix(N, seed=seed, dtype=dtype)
    return (a + 1e4 * np.eye(N, dtype=dtype)).reshape(-1)


@pytest.fixture
def clean_stats():
    api.clear_stats()
    yield
    api.clear_stats()


@pytest.mark.parametrize("name", CALLS)
def test_answer_is_a_flat_writable_vector(name):
    fn, _, dtype, _ = CALLS[name]
    out = fn(_flat(dtype, 1), N, device="cpu")
    assert out.shape == (N * N,) and out.dtype == dtype
    assert out.flags.c_contiguous and out.flags.writeable
    out[0] = 0.0


@pytest.mark.parametrize("name", CALLS)
def test_answer_shares_no_memory(name):
    """Neither with the input nor with another answer held beside it."""
    fn, _, dtype, _ = CALLS[name]
    flat = _flat(dtype, 2)
    first = fn(flat, N, device="cpu")
    second = fn(flat, N, device="cpu")
    assert not np.shares_memory(first, flat)
    assert not np.shares_memory(second, flat)
    assert not np.shares_memory(first, second)
    np.testing.assert_array_equal(first, second)


@pytest.mark.parametrize("name", CALLS)
def test_answer_bits_equal_the_solver(name):
    fn, _, dtype, pivot = CALLS[name]
    flat = _flat(dtype, 3)
    inv, ok = solver.inverse(torch.from_numpy(flat.reshape(N, N)),
                             pivot=pivot)
    assert bool(ok)
    want = inv.numpy().reshape(-1)
    out = fn(flat, N, device="cpu")
    assert out.tobytes() == want.tobytes()


@pytest.mark.parametrize("case", ["order_zero", "non_square", "singular"])
@pytest.mark.parametrize("name", CALLS)
def test_empty_vector_cases_are_unchanged(name, case, clean_stats):
    """A failed validation or a singular matrix returns ``np.empty(0,
    dtype)`` and reads nothing back."""
    fn, _, dtype, _ = CALLS[name]
    flat, order = {"order_zero": (np.ones(4, dtype), 0),
                   "non_square": (np.ones(15, dtype), 4),
                   "singular": (np.ones(16 * 16, dtype), 16)}[case]
    out = fn(flat, order, device="cpu")
    assert out.shape == (0,) and out.dtype == dtype
    assert api.stats() == {"pinned": 0, "pageable": 0}


@pytest.mark.parametrize("name", CALLS)
def test_stats_count_pageable_readbacks_on_the_cpu(name, clean_stats):
    fn, _, dtype, _ = CALLS[name]
    flat = _flat(dtype, 4)
    for k in range(3):
        assert fn(flat, N, device="cpu").size == N * N
        assert api.stats() == {"pinned": 0, "pageable": k + 1}
    api.clear_stats()
    assert api.stats() == {"pinned": 0, "pageable": 0}


@pytest.mark.parametrize("name", CALLS)
def test_bench_reads_back_once_through_the_same_path(name, clean_stats):
    """The bench calls invert twice and read back once; their ``Res``
    holds the flat API's answer, bit for bit, in the call's dtype."""
    fn, bench, dtype, _ = CALLS[name]
    flat = _flat(dtype, 5)
    res = bench(flat, N, device="cpu")
    assert res.ok
    assert api.stats() == {"pinned": 0, "pageable": 1}
    out = res.inversa32 if dtype == np.float32 else res.inversa64
    assert out.dtype == dtype and out.flags.c_contiguous
    assert not np.shares_memory(out, flat)
    assert out.tobytes() == fn(flat, N, device="cpu").tobytes()


def test_stats_lose_no_count_across_threads(clean_stats):
    """Eight threads read back at once, with the interpreter switching
    threads as often as it can: every readback is counted."""
    inv = torch.eye(8)
    calls, threads = 200, 8
    errors = []

    def work():
        try:
            for _ in range(calls):
                api._readback(inv, np.float32)
        except Exception as err:    # reported by the main thread
            errors.append(err)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    assert not errors
    assert api.stats() == {"pinned": 0, "pageable": calls * threads}
