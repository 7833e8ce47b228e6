"""The port's ``check_deterministic`` against the JAX package's, and the
port's routes through it on the CPU (``tests/test_determinism.py``'s cases,
plus ``cholesky``).

On the CPU the perturbation between runs is the reference's dummy NaN
computation; the on-card poisoning (allocator and shared memory) is
exercised by ``tests/test_torch_cuda.py``. Results
compare exactly: both functions return the same ``(identical, max_diff)``
on the same output sequence.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gpu_matrix_inversion_tpu.utils.determinism import (  # noqa: E402
    check_deterministic as jax_check)
from gpu_matrix_inversion_tpu_torch import inverse  # noqa: E402
from gpu_matrix_inversion_tpu_torch.utils import determinism  # noqa: E402
from gpu_matrix_inversion_tpu_torch.utils.determinism import (  # noqa: E402
    check_deterministic)
from gpu_matrix_inversion_tpu_torch.utils.generators import (  # noqa: E402
    hollow_random_matrix)


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, n))
    return (g @ g.T / n + np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("method", ["spec", "fused", "blocked", "lu", "ns",
                                    "cholesky"])
def test_paths_bit_deterministic(method):
    a = hollow_random_matrix(96, seed=95)
    if method == "ns":
        a = a + 96 * np.eye(96, dtype=np.float32)
    if method == "cholesky":
        a = _spd(96, seed=95)
    identical, diff = check_deterministic(
        lambda x: inverse(x, method=method), torch.from_numpy(a), runs=3)
    assert identical, f"{method} drifted by {diff}"


def test_fused_batched_deterministic():
    a = np.stack([hollow_random_matrix(64, seed=s) for s in range(4)])
    identical, diff = check_deterministic(
        lambda x: inverse(x, method="fused"), torch.from_numpy(a), runs=2)
    assert identical, f"batched fused drifted by {diff}"


def _sequence(outputs):
    """A function returning the given outputs in turn."""
    it = iter(outputs)
    return lambda: next(it)


@pytest.mark.parametrize("case", ["float drift", "integer drift", "nan equal",
                                  "bool drift", "same"])
def test_same_verdict_as_jax(case):
    """Both packages' check_deterministic give the same (identical,
    max_diff) on the same output sequence, returned as a tuple of an array
    and a flag."""
    # Multiples of 1/8, so that the drifts below are exact in float32.
    base = (np.random.default_rng(0).integers(-64, 64, (5, 7)) / 8).astype(
        np.float32)
    flag = np.array(True)
    if case == "float drift":
        seq = [(base, flag), (base + 0.5, flag), (base - 0.25, flag)]
    elif case == "integer drift":
        ints = np.arange(6, dtype=np.int32)
        seq = [(ints, flag), (ints, flag), (ints + 1, flag)]
    elif case == "nan equal":
        nan = base.copy()
        nan[1, 2] = np.nan
        seq = [(nan, flag)] * 3
    elif case == "bool drift":
        seq = [(base, flag), (base, np.array(False)), (base, flag)]
    else:
        seq = [(base, flag)] * 3
    want = jax_check(_sequence([tuple(map(np.array, s)) for s in seq]),
                     runs=3)
    got = check_deterministic(_sequence(
        [tuple(torch.from_numpy(np.array(x)) for x in s) for s in seq]),
        runs=3)
    assert got == want
    assert got[0] is (case in ("nan equal", "same"))
    if case in ("integer drift", "bool drift"):
        assert got[1] == float("inf")
    if case == "float drift":
        assert got[1] == 0.5


def test_tuple_list_and_dict_outputs():
    """Leaves of nested tuples, lists and dicts (dicts by sorted key, as
    jax.tree flattens them) all count; one drifting leaf is found."""
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    calls = itertools.count()

    def fn():
        i = next(calls)
        return {"b": (x, [x * 2]), "a": x + (0.125 if i == 2 else 0.0)}

    identical, diff = check_deterministic(fn, runs=3)
    assert not identical and diff == 0.125
    same, diff = check_deterministic(lambda: {"b": (x, [x]), "a": x}, runs=3)
    assert same and diff == 0.0
    assert [t.shape for t in determinism._leaves(
        {"b": (x, [x[0]]), "a": x[:, 0]})] == [(3,), (3, 4), (4,)]


def test_bf16_leaves_compare_exactly():
    """bf16 leaves go to the host as float32 (exact): an ulp of bf16 is
    found."""
    x = torch.ones(8, dtype=torch.bfloat16)
    step = torch.nextafter(x, torch.full_like(x, 2))
    seq = [x, x, step]
    identical, diff = check_deterministic(_sequence(seq), runs=3)
    assert not identical and diff == 2.0 ** -7


def test_device_from_arguments_or_result():
    """The device comes from the tensor arguments, else from the result;
    the CPU then runs the reference's dummy NaN computation between runs."""
    x = torch.ones(3)
    assert determinism._device_of((x,), None) == torch.device("cpu")
    assert determinism._device_of((), (1.0, {"k": x})) == torch.device("cpu")
    runs = []
    ok, _ = check_deterministic(lambda: runs.append(1) or x, runs=4)
    assert ok and len(runs) == 4
