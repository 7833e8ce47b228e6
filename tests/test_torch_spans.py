"""The port's profiler spans on the CPU (``utils/profiling.span``): the
layer boundaries a call opens under a ``torch.profiler`` session, nested
on the caller's thread; none entered while no session records; nothing of
them in a graph's key. And the arithmetic that reads them
(``idle_by_span``, ``launch_leads``) on records built by hand.

The card's side (a replay's span around its graph launch, the clock the
spans share with the device records) is in ``tests/test_torch_cuda.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gpu_matrix_inversion_tpu_torch import api, ops  # noqa: E402
from gpu_matrix_inversion_tpu_torch.models import solver  # noqa: E402
from gpu_matrix_inversion_tpu_torch.utils import graphs  # noqa: E402
from gpu_matrix_inversion_tpu_torch.utils import profiling  # noqa: E402
from gpu_matrix_inversion_tpu_torch.utils.generators import (  # noqa: E402
    hollow_random_matrix)

API = ["matinv::api.validate", "matinv::api.stage", "matinv::solver.inverse"]
READ = ["matinv::api.ok", "matinv::api.readback", "matinv::api.convert"]
FUSED = ["matinv::fused.k1", "matinv::fused.gather"]


def _spans(call) -> list:
    """``(name, start, end)`` of the ``matinv::`` ranges one call of
    ``call`` opens under a CPU profiler session, in order of start."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("matinv::")),
                  key=lambda s: (s[1], -s[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _batch(n: int, bsz: int = 3) -> torch.Tensor:
    return torch.from_numpy(np.stack([hollow_random_matrix(n, seed=n + i)
                                      for i in range(bsz)]))


@pytest.mark.parametrize("fn,dtype,route", [
    (api.matrix_inv_32, np.float32, FUSED),
    (api.matrix_inversion_fp64, np.float64, []),        # the spec
    (api.matrix_inversion_no_pivots, np.float64, []),
])
def test_api_spans_nest_around_the_dispatch(fn, dtype, route):
    """The flat API's steps in order, ``solver.inverse`` between staging
    and the first wait, the route's own spans inside it, each API span at
    the top level. The diagonal is made dominant, so that the no-pivot
    route answers too."""
    a = hollow_random_matrix(64, seed=4, dtype=dtype) + 1e4 * np.eye(
        64, dtype=dtype)
    got = _spans(lambda: fn(a.reshape(-1), 64, device="cpu"))
    assert [s[0] for s in got] == API + route + READ
    dispatch = got[2]
    assert all(_inside(s, dispatch) for s in got[3:3 + len(route)])
    top = [s for s in got if s[0].startswith("matinv::api.")] + [dispatch]
    top.sort(key=lambda s: s[1])
    assert all(a[2] <= b[1] for a, b in zip(top, top[1:]))


@pytest.mark.parametrize("case,want", [
    ("singular", API + FUSED + ["matinv::api.ok"]),
    ("not square", ["matinv::api.validate"]),
])
def test_api_spans_stop_where_the_call_returns_empty(case, want):
    """A singular matrix returns empty after the first wait; an input that
    fails validation opens nothing past ``api.validate``."""
    if case == "singular":
        flat, order = np.ones(16 * 16, dtype=np.float32), 16
    else:
        flat, order = np.ones(15, dtype=np.float32), 4
    out = []
    got = _spans(lambda: out.append(api.matrix_inv_32(flat, order,
                                                      device="cpu")))
    assert out[0].size == 0
    assert [s[0] for s in got] == want


@pytest.mark.parametrize("n", [128, 40])
def test_batched_inverse_spans(n):
    """``solver.inverse`` on a CPU batch: ``fused.k1`` (the padding where
    n is no multiple of 128, then K1's twin) and ``fused.gather`` inside
    the dispatch span, in that order."""
    got = _spans(lambda: solver.inverse(_batch(n)))
    assert [s[0] for s in got] == ["matinv::solver.inverse"] + FUSED
    assert all(_inside(s, got[0]) for s in got[1:])
    assert got[1][2] <= got[2][1]


REFINE = ["matinv::refine.inverse", "matinv::refine.factor",
          "matinv::refine.polish"]


def test_refined_route_spans():
    """``ops.lu_inverse_refined`` on the CPU: ``refine.inverse`` over the
    call, ``refine.factor`` (the FP32 cast and getri) then
    ``refine.polish`` (the Newton-Schulz steps) inside it, apart and in
    that order; the compiled calls run eagerly here, so no ``graphs.*``
    span opens."""
    a = torch.from_numpy(hollow_random_matrix(64, seed=9)).double()
    got = _spans(lambda: ops.lu_inverse_refined(
        a, iters=2, residual_dtype=torch.float64))
    assert [s[0] for s in got] == REFINE
    assert all(_inside(s, got[0]) for s in got[1:])
    assert got[1][2] <= got[2][1]


def test_refined_route_answers_alike_traced_or_not():
    """The spans change nothing of the answer: the same bits, ok and
    dtype with a profiler recording and without."""
    from torch.profiler import ProfilerActivity, profile
    a = torch.from_numpy(hollow_random_matrix(48, seed=10)).double()
    x_off, ok_off = ops.lu_inverse_refined(a, residual_dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]):
        x_on, ok_on = ops.lu_inverse_refined(a, residual_dtype=torch.float64)
    assert torch.equal(x_on, x_off) and bool(ok_on) and bool(ok_off)


def test_graph_cache_opens_no_span_on_the_cpu():
    """A compiled route on CPU tensors runs its body eagerly: the graph
    cache's spans belong to calls it serves, so none opens here (nor the
    blocked driver's phase ranges, which need ``phase_ranges()``)."""
    a = torch.from_numpy(hollow_random_matrix(128, seed=8))
    got = _spans(lambda: solver.inverse(a, method="blocked", block_size=64))
    assert [s[0] for s in got] == ["matinv::solver.inverse"]


def test_no_range_without_a_profiler(monkeypatch):
    """While no profiler session records, no ``record_function`` is
    entered: with it made to raise, the flat API, a batch and the blocked
    route still answer; every span is one shared no-op context."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a = hollow_random_matrix(64, seed=5)
    out = api.matrix_inv_32(a.reshape(-1), 64, device="cpu")
    assert out.size == 64 * 64
    _, ok = solver.inverse(_batch(40))
    assert bool(ok.all())
    _, ok = solver.inverse(torch.from_numpy(a), method="blocked",
                           block_size=32)
    assert bool(ok)
    _, ok = ops.lu_inverse_refined(torch.from_numpy(a).double(),
                                   residual_dtype=torch.float64)
    assert bool(ok)
    assert profiling.span("api.stage") is profiling.span("graphs.replay")


def test_span_opens_a_range_only_while_recording():
    """Inside a session the span is a ``record_function`` range of its own;
    after the session, the no-op again."""
    from torch.profiler import ProfilerActivity, profile
    off = profiling.span("x")
    with profile(activities=[ProfilerActivity.CPU]):
        on = profiling.span("x")
    assert isinstance(on, torch.profiler.record_function)
    assert on is not off and profiling.span("x") is off


def test_process_state_ignores_the_profiler():
    """A graph's key holds the process state its body reads; a recording
    profiler is none of it, so a traced call replays the graph an
    untraced one captured."""
    from torch.profiler import ProfilerActivity, profile
    before = graphs.process_state()
    with profile(activities=[ProfilerActivity.CPU]):
        during = graphs.process_state()
    assert during == before == graphs.process_state()


def _host(*spans) -> list:
    """Host records ``(name, start_s, seconds)`` from ``(name, start,
    end)``."""
    return [(name, s, e - s) for name, s, e in spans]


def test_idle_goes_to_the_innermost_span():
    """Nested ranges: an idle interval goes to the innermost one open over
    it, the outer range taking what lies outside its child."""
    host = _host(("matinv::solver.inverse", 0.0, 10.0),
                 ("matinv::graphs.replay", 2.0, 5.0),
                 ("aten::copy_", 2.5, 3.0))
    got = profiling.idle_by_span([(3.0, 4.0), (6.0, 7.0)], host)
    assert got == {"matinv::graphs.replay": 1.0,
                   "matinv::solver.inverse": 1.0}


def test_a_gap_across_two_spans_is_split_at_their_boundary():
    """An interval that crosses from one range into the next (or into
    its parent) is split where the ranges meet; only the part with no
    range open is left out."""
    host = _host(("matinv::api.stage", 1.0, 3.0),
                 ("matinv::solver.inverse", 3.0, 8.0),
                 ("matinv::fused.k1", 4.0, 6.0))
    got = profiling.idle_by_span([(0.0, 3.5), (5.0, 9.0)], host)
    assert got == pytest.approx({"matinv::api.stage": 2.0,
                                 "matinv::solver.inverse": 2.5,
                                 "matinv::fused.k1": 1.0})


def test_idle_under_no_program_span_goes_nowhere():
    """The caller's idle time (no ``matinv::`` range open, whatever other
    host operation is) is in no name."""
    host = _host(("port_bench::call", 0.0, 10.0),
                 ("cudaStreamSynchronize", 6.0, 9.0),
                 ("matinv::solver.inverse", 1.0, 5.0))
    got = profiling.idle_by_span([(4.0, 9.5)], host)
    assert got == {"matinv::solver.inverse": 1.0}


def test_no_program_span_reads_none():
    """Records with no ``matinv::`` range (a program without the spans)
    read None, not zero."""
    host = _host(("port_bench::call", 0.0, 10.0), ("aten::mm", 1.0, 2.0))
    assert profiling.idle_by_span([(3.0, 4.0)], host) is None
    assert profiling.idle_by_span([], _host(("matinv::a", 0, 1))) == {}


def _ev(name, cuda, start, end, id_=0, annotation=False):
    """An event as ``prof.events()`` gives it."""
    from torch.autograd import DeviceType
    return SimpleNamespace(
        name=name, id=id_, is_user_annotation=annotation,
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
        time_range=SimpleNamespace(start=start, end=end))


def test_launch_leads_link_launches_inside_spans():
    """A launch's lead is the start of the first device record with its
    correlation id less its own start, for launches inside a ``matinv::``
    range (a nested range's end does not hide its parent); the ranges'
    own spans on the device timeline and launches outside every range
    count nowhere."""
    events = [
        _ev("matinv::solver.inverse", False, 0, 100),
        _ev("matinv::graphs.key", False, 1, 5),
        _ev("cudaGraphLaunch", False, 20, 30, 7),
        _ev("panel_factor_cluster_kernel", True, 32, 40, 7),
        _ev("sgemm", True, 45, 60, 7),
        _ev("cudaLaunchKernel", False, 150, 151, 8),       # no range
        _ev("spin_kernel", True, 152, 160, 8),
        _ev("matinv::solver.inverse", True, 31, 60, 7, annotation=True),
        _ev("cudaLaunchKernel", False, 70, 71, 9),
        _ev("gather_kernel", True, 74, 80, 9),
    ]
    assert sorted(profiling.launch_leads(events)) == [
        (4, "cudaLaunchKernel", "gather_kernel"),
        (12, "cudaGraphLaunch", "panel_factor_cluster_kernel")]


def test_device_kernels_leave_out_the_spans_device_side(monkeypatch):
    """On a card a range is also drawn on the device timeline, over the
    kernels launched inside it; ``device_kernels`` reads no such row as a
    device operation, or a replayed call under ``graphs.replay`` would
    count its kernels twice."""
    from contextlib import nullcontext
    from torch.autograd import DeviceType

    def row(key, us, annotation=False):
        return SimpleNamespace(key=key, count=1, device_type=DeviceType.CUDA,
                               self_device_time_total=us,
                               is_user_annotation=annotation)
    rows = [row("panel_factor_cluster_kernel", 300.0),
            row("matinv::graphs.replay", 900.0, annotation=True),
            row("matinv::fused.k1", 500.0),      # a build without the flag
            row("sgemm", 600.0)]
    session = SimpleNamespace(key_averages=lambda: rows)
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda **kwargs: nullcontext(session))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    got = profiling.device_kernels(lambda: None)
    assert got == [("sgemm", 1, 0.6), ("panel_factor_cluster_kernel", 1,
                                       0.3)]

