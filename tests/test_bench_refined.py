"""The benchmark's FP32-factor, FP64-refined LU deployment
(``fp64-lu-refined-4096``, cell ``refined4096.device``) on the CPU at small
sizes: the port's ``ops.lu_inverse_refined`` and the benchmark's plain
reference of the same algorithm (``port_bench/reference/refined.py``), each
held to the float64 inverse; the benchmark's generator of ill-conditioned
inputs (``reference/generators/conditioned.py``); the cell run whole; and
the readers of its per-layer metrics on segments built by hand.

Tolerance, with its reason: the deployment promises an FP64-level inverse,
whose relative forward error (Frobenius norm) is a modest multiple of
kappa * eps64 = 2.2e-12 at kappa = 1e4. ``TOL`` = 10 kappa eps64 holds the
sound readings (1.3e-13 at n = 64, 3.2e-13 at n = 256) with 70x or more to
spare, and fails both controls by 100x or more: the polish in float32
(an FP32-level answer, 5e-5 to 1e-4) and one Newton-Schulz step (the FP32
factor's error squared, 2e-9 to 2e-8). At these sizes two steps reach the
FP64 floor; at n = 4096 on an H100 the port's FP32 getri leaves a residual
2.3x the plain reference's, and its two steps stop 28x above the floor
that a third step reaches (relative gap 1.5e-10): the benchmark's limits
are set from those readings.
"""

import math
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gpu_matrix_inversion_tpu_torch import ops  # noqa: E402
from gpu_matrix_inversion_tpu_torch.utils import profiling  # noqa: E402
from port_bench import run  # noqa: E402
from port_bench.core import spec, trace  # noqa: E402
from port_bench.reference import counts, counts_lu, refined  # noqa: E402
from port_bench.reference.generators import conditioned  # noqa: E402

KAPPA = conditioned.KAPPA
TOL = 10 * KAPPA * torch.finfo(torch.float64).eps
CELL = "refined4096.device"

IMPLS = {
    "port": lambda a, iters, rd: ops.lu_inverse_refined(
        a, iters=iters, residual_dtype=rd),
    "reference": lambda a, iters, rd: refined.lu_inverse_refined(
        a, iters=iters, residual_dtype=rd),
}


def _input(n: int, seed: int) -> torch.Tensor:
    return conditioned.device(seed, (n, n), device="cpu")


def _error(impl: str, n: int, seed: int, iters: int = 2,
           rd=torch.float64) -> float:
    """The relative Frobenius gap of ``impl``'s answer from the float64
    inverse; asserts ``ok`` and the answer's dtype."""
    a = _input(n, seed)
    x, ok = IMPLS[impl](a, iters, rd)
    assert bool(ok) and x.dtype == rd
    exact = torch.linalg.inv(a)
    return float(torch.linalg.matrix_norm(x.double() - exact)
                 / torch.linalg.matrix_norm(exact))


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_refined_inverse_is_fp64_level(impl, n, seed):
    assert _error(impl, n, seed) <= TOL


@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_polish_in_float32_fails_the_tolerance(impl, n):
    """The control one precision down: the same two steps in float32 leave
    an FP32-level answer."""
    assert _error(impl, n, 4, rd=torch.float32) > TOL


@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_one_step_fails_the_tolerance(impl, n):
    """The other control: one float64 step squares the FP32 factor's
    error, short of the FP64 level."""
    assert _error(impl, n, 5, iters=1) > TOL


@pytest.mark.parametrize("n", [64, 256])
def test_port_and_reference_agree(n):
    """Both sides of the comparison land in the same FP64 neighbourhood:
    within ``TOL`` of each other, relative."""
    a = _input(n, 6)
    x, _ = ops.lu_inverse_refined(a, iters=2, residual_dtype=torch.float64)
    xr, _ = refined.lu_inverse_refined(a)
    assert float(torch.linalg.matrix_norm(x - xr)
                 / torch.linalg.matrix_norm(xr)) <= TOL


def test_reference_flags_a_singular_matrix():
    """A zero row leaves a zero pivot, as it does in the port."""
    a = _input(32, 7)
    a[5] = 0
    _, ok = refined.lu_inverse_refined(a)
    _, ok_port = ops.lu_inverse_refined(a, residual_dtype=torch.float64)
    assert not bool(ok) and not bool(ok_port)


def test_reference_takes_a_batch():
    a = conditioned.device(8, (3, 32, 32), device="cpu")
    x, ok = refined.lu_inverse_refined(a)
    assert x.shape == a.shape and ok.shape == (3,) and bool(ok.all())
    for j in range(3):
        xj, _ = refined.lu_inverse_refined(a[j])
        assert torch.equal(x[j], xj)


@pytest.mark.parametrize("n", [64, 256])
def test_generator_condition_number(n):
    a = conditioned.device(11, (2, n, n), device="cpu")
    assert a.dtype == torch.float64
    kappa = torch.linalg.cond(a)
    assert torch.all((kappa - KAPPA).abs() <= 0.01 * KAPPA), kappa


def test_generator_repeats_for_a_seed():
    a = conditioned.device(2**31 + 17, (2, 48, 48), device="cpu")
    assert torch.equal(a, conditioned.device(2**31 + 17, (2, 48, 48),
                                             device="cpu"))
    assert not torch.equal(a, conditioned.device(2**31 + 18, (2, 48, 48),
                                                 device="cpu"))
    flat = conditioned.host(2**31 + 17, 2, 48)
    assert [v.shape for v in flat] == [(48 * 48,)] * 2
    assert torch.equal(torch.from_numpy(flat[1].reshape(48, 48)), a[1])


def _small_cell(n: int):
    cell = spec.cell(CELL)
    cell.config = dict(cell.config, n=n)
    cell.traffic = dict(cell.traffic, pool=2, sample=3)
    return cell


def test_cell_is_found_with_its_metrics():
    cell = _small_cell(64)
    assert cell.entry().INPUTS == "device"
    assert [m.name for m in cell.end_to_end] == ["setup_s", "call_ms",
                                                 "call_ms_p95"]
    assert [m.name for m in cell.per_layer] == [
        "lu.factor_roofline", "lu.solve_roofline", "refine.idle_ms",
        "device.idle_pct.refined", "graphs.replay_pct.refined"]
    for m in cell.per_layer:
        assert callable(spec.reader(m.name))


@pytest.mark.parametrize("iters,rd,correct", [
    (2, torch.float64, True),
    (1, torch.float64, False),
    (2, torch.float32, False),
])
def test_cell_runs_whole_under_its_limits(monkeypatch, iters, rd, correct):
    """A run of the cell cut to n = 128 on the CPU: correct as it stands;
    with one step, or the polish in float32, its limits refuse it."""
    if (iters, rd) != (2, torch.float64):
        real = ops.lu_inverse_refined
        monkeypatch.setattr(ops, "lu_inverse_refined",
                            lambda a, **kw: real(a, iters=iters,
                                                 residual_dtype=rd))
    out = run.measure(_small_cell(128), 2**31 + 5, 0.2, False, device="cpu",
                      t_start=time.perf_counter())
    assert out["correct"] is correct, out["checks"]
    assert set(out["metrics"]) == {"setup_s", "call_ms", "call_ms_p95"}


def test_counts_at_the_cell_size():
    n = 4096
    assert counts_lu.order(counts.inverse_flops(n)) == n
    assert counts.bound_s(counts_lu.factor_flops(n),
                          counts_lu.factor_bytes(n)) == pytest.approx(
        6.84e-4, rel=1e-3)
    assert counts.bound_s(counts_lu.solve_flops(n, n),
                          counts_lu.solve_bytes(n, n)) == pytest.approx(
        2.051e-3, rel=1e-3)


def _segment(records, host=(), gaps=(), calls=1, n=4096):
    return trace.Segment(calls, 1.0, 0.5, list(records), {},
                         {"flops": calls * counts.inverse_flops(n),
                          "bytes": calls * counts.inverse_bytes(n, 1, 8),
                          "dtype": "float64"}, list(host), list(gaps))


L4 = "void lu_factor_grid_kernel<float>(float*, int, int)"
L5 = "void lu_solve_kernel<float>(float const*, int const*, float*, int)"
OTHER = [("sm90_xmma_gemm_f64f64_f64f64_f64_nn", 0.5, 0.004),
         ("Memcpy DtoD (Device -> Device)", 0.6, 0.001)]


@pytest.mark.parametrize("metric,records,calls,want", [
    ("lu.factor_roofline", [(L4, 0.0, 0.1785)], 1,
     100 * (2 * 4096 ** 3 / 3 / 67e12) / 0.1785),
    ("lu.factor_roofline", [(L4, 0.0, 0.18), (L4, 1.0, 0.17)], 2,
     100 * (2 * 4096 ** 3 / 3 / 67e12) / 0.175),
    ("lu.solve_roofline", [(L5, 0.2, 0.036)], 1,
     100 * (2 * 4096 ** 3 / 67e12) / 0.036),
    ("lu.solve_roofline", [(L5, 0.2, 0.02), (L5, 0.3, 0.016)], 1,
     100 * (2 * 4096 ** 3 / 67e12) / 0.036),
    ("lu.factor_roofline", [(L5, 0.2, 0.036)], 1, None),
    ("lu.solve_roofline", [(L4, 0.0, 0.1785)], 1, None),
])
def test_lu_roofline_readers(metric, records, calls, want):
    """A share of the kernel's own roofline over its own device seconds,
    n read from the segment's work; None where the kernel did not run."""
    got = spec.reader(metric)(_segment(records + OTHER, calls=calls))
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=1e-12)


# One traced call: the caller's range, the route's three spans, a graph
# replay inside the factor; the first record starts 0.01 s after the first
# launch and the last ends 0.01 s before the wait returns. Idle gaps across
# them.
CALL_HOST = [(trace.CALL, 0.0, 10.0),
             ("matinv::refine.inverse", 1.0, 8.0),
             ("matinv::refine.factor", 1.5, 2.5),
             ("cudaLaunchKernel", 0.19, 0.005),
             ("matinv::graphs.replay", 2.0, 1.0),
             ("cudaGraphLaunch", 2.1, 0.01),
             ("matinv::refine.polish", 5.0, 3.0),
             ("cudaStreamSynchronize", 9.0, 0.61)]
CALL_GAPS = [(1.2, 1.7), (2.2, 2.8), (8.5, 9.5)]
CALL_RECORDS = [(L4, 0.2, 1.0), (L5, 1.7, 0.5), (OTHER[0][0], 2.8, 5.7),
                ("Memcpy DtoH (Device -> Pageable)", 9.5, 0.1)]
# 0.3 s under refine.inverse, 0.2 under refine.factor, 0.5 under
# refine.inverse again; the replay's 0.6 and the caller's 0.5 are not
# the route's.
SPLIT_MS = 1e3 * 1.0


def _drifted(records, c: float, rate: float = 0.0, t0: float = 0.0):
    """``records`` as a device clock reads them that is ``c + rate * (t -
    t0)`` ahead of the host's."""
    return [(n, s + c + rate * (s - t0), d * (1 + rate))
            for n, s, d in records]


def _idle_module():
    return spec.module(spec.ROOT / "port_bench" / "metrics"
                       / "refine.idle_ms.py")


@pytest.mark.parametrize("case,host,records,want", [
    ("split", CALL_HOST, CALL_RECORDS, SPLIT_MS),
    ("no refine span", [h for h in CALL_HOST
                        if not h[0].startswith("matinv::refine.")],
     CALL_RECORDS, None),
    # Records that still start after the launch and end before the wait
    # returns sit where they lie.
    ("early within the lead", CALL_HOST, _drifted(CALL_RECORDS, -0.005),
     SPLIT_MS + 5.0),
    ("late within the lag", CALL_HOST, _drifted(CALL_RECORDS, 0.005),
     SPLIT_MS - 5.0),
    # Out of those bounds: put back so that the lead equals the lag.
    ("before the launch", CALL_HOST, _drifted(CALL_RECORDS, -0.15),
     SPLIT_MS),
    ("before the call", CALL_HOST, _drifted(CALL_RECORDS, -3.0), SPLIT_MS),
    ("past the wait", CALL_HOST, _drifted(CALL_RECORDS, 0.5), SPLIT_MS),
    ("no call range", CALL_HOST[1:], CALL_RECORDS, None),
    ("no record", CALL_HOST, [], None),
])
def test_refine_idle_ms(case, host, records, want):
    """The route's idle ms a call, the records first put on the host's
    clock. The gaps the segment carries are not read: they are cut from
    the records as put back."""
    got = spec.reader("refine.idle_ms")(
        _segment(records, host, CALL_GAPS))
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=1e-9)


def _two_calls(c: float = 0.0, rate: float = 0.0, drop: int | None = None):
    """Two traced calls 10.1 s apart on a device clock ``c + rate * t``
    ahead of the host's, the second call's record ``drop`` lost."""
    host = CALL_HOST + [(n, s + 10.1, d) for n, s, d in CALL_HOST]
    second = [(n, s + 10.1, d) for n, s, d in CALL_RECORDS]
    if drop is not None:
        del second[drop]
    return _segment(_drifted(CALL_RECORDS + second, c, rate, 0.19),
                    host, calls=2)


# The second call without L5 (1.7 to 2.2 s): 0.3 s more under
# refine.factor, the 0.2 s under the replay not the route's.
DROPPED_MS = SPLIT_MS + 1e3 * 0.3 / 2


@pytest.mark.parametrize("c,rate,drop,want", [
    (0.0, 0.0, None, SPLIT_MS),
    # A clock that runs fast or slow, from a sound start or not: one line
    # puts every record back.
    (0.0, -0.0015, None, SPLIT_MS),
    (0.0, 0.0015, None, SPLIT_MS),
    (-2.0, 0.001, None, SPLIT_MS),
    (0.3, -0.0005, None, SPLIT_MS),
    # The profiler lost the second call's L5 record: the calls are cut
    # after their copies to the host.
    (0.0, 0.0, 1, DROPPED_MS),
    (-2.0, 0.001, 1, DROPPED_MS),
])
def test_refine_idle_ms_over_calls(c, rate, drop, want):
    """A call average over a session whose device clock drifts."""
    got = spec.reader("refine.idle_ms")(_two_calls(c, rate, drop))
    assert got == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("shift", [0.0, -0.005, 0.005])
def test_aligned_keeps_records_inside_their_call(shift):
    """Records between their call's first launch and its last wait stay
    exactly where they are."""
    records = _drifted(CALL_RECORDS, shift)
    got = _idle_module().aligned(_segment(records, CALL_HOST))
    assert got == sorted(records, key=lambda r: r[1])


@pytest.mark.parametrize("c,rate", [(-3.0, 0.0), (0.5, 0.0),
                                    (-0.4, 0.0015), (0.0, -0.001)])
def test_aligned_undoes_a_steady_drift(c, rate):
    """Every record, start and length, back where the host's clock has
    it."""
    got = _idle_module().aligned(_two_calls(c, rate))
    want = sorted(_two_calls().records, key=lambda r: r[1])
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got, want):
        assert g[1] == pytest.approx(w[1], abs=1e-9)
        assert g[2] == pytest.approx(w[2], abs=1e-9)


D2H = "Memcpy DtoH (Device -> Pinned)"


@pytest.mark.parametrize("records,calls,want", [
    ([("a", 0, 1), (D2H, 2, 1), ("a", 10, 1), (D2H, 12, 1)], 2,
     [["a", D2H], ["a", D2H]]),
    # One record lost: each call's run ends at its copy to the host.
    ([("a", 0, 1), ("b", 1, 1), (D2H, 2, 1), ("a", 10, 1), (D2H, 12, 1)],
     2, [["a", "b", D2H], ["a", D2H]]),
    # A copy to the host lost too: no cut.
    ([("a", 0, 1), ("b", 1, 1), (D2H, 2, 1), ("a", 10, 1), ("b", 12, 1)],
     2, [["a", "b", D2H, "a", "b"]]),
])
def test_shares_cut_one_run_a_call(records, calls, want):
    got = _idle_module().shares(records, calls)
    assert [[r[0] for r in share] for share in got] == want


def test_refine_idle_split_is_the_programs_arithmetic():
    """The reader's own copy of the split gives what the program's
    ``utils/profiling.idle_by_span`` gives on the same records."""
    got = _idle_module().idle_by_span(CALL_GAPS, CALL_HOST)
    want = profiling.idle_by_span(CALL_GAPS, CALL_HOST)
    assert got.keys() == want.keys()
    for k in want:
        assert math.isclose(got[k], want[k], rel_tol=1e-12)
