"""The port's host layer on the CPU: ``measure_phases``
(``benchmarks/phases.py``), the ``MATINV_DEBUG_PHASES`` branch of the bench
API, and ``utils/profiling.trace``.

``tests/test_config.py::test_phase_breakdown`` is not mirrored: it drives
the JAX package's stub-differencing profiler at n = 512 in interpret mode.
Here the blocked call runs as it is, its phases marked by profiler ranges,
so the checks are structural: the five slots, non-negative, adding up to
within 5% of ``total_compute``, the kernels landing in the range that
launched them, and the slots landing in ``Res.times_vector()``'s
places.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gpu_matrix_inversion_tpu_torch import api  # noqa: E402
from gpu_matrix_inversion_tpu_torch.benchmarks import phases  # noqa: E402
from gpu_matrix_inversion_tpu_torch.utils import profiling  # noqa: E402
from gpu_matrix_inversion_tpu_torch.utils.generators import (  # noqa: E402
    hollow_random_matrix)

KEYS = {"make_augmented", "pivot", "row", "column", "total_compute"}


@pytest.mark.parametrize("n,block_size", [(256, 128), (200, 64)])
def test_measure_phases_slots(n, block_size):
    """Five keys, non-negative; the pivot search and the rest (``column``)
    take time; the slots add up to within 5% of total_compute. At b = 64,
    n = 200 pads to m = 256 (four panels)."""
    got = phases.measure_phases(n, block_size=block_size, k=2, reps=1,
                                device="cpu")
    assert set(got) == KEYS
    assert all(v >= 0.0 for v in got.values())
    assert got["pivot"] > 0 and got["column"] > 0
    slots = sum(got[k] for k in phases.SLOTS)
    assert abs(slots - got["total_compute"]) <= 0.05 * got["total_compute"]


def test_measure_phases_split_path_fills_row():
    """With a bf16 search (the split path: K3 and K4) the pivot-block
    inverse has its own slot."""
    from gpu_matrix_inversion_tpu_torch.ops import blocked
    a = torch.from_numpy(hollow_random_matrix(128, seed=2))

    def call():
        return blocked.blocked_inverse(a, block_size=64, search_bf16=True,
                                       refine=0)
    got = phases._profile_call(call, 1, torch.device("cpu"))
    assert got["pivot"] > 0 and got["row"] > 0 and got["column"] > 0


def test_slot_times_attributes_kernels_by_launch():
    """On a CUDA device each kernel goes to the range whose span holds its
    runtime launch (matched by correlation id), whether an operator or a
    hand-written kernel's ctypes call launched it; a kernel launched
    outside every range counts in the total only (measure_phases puts it
    in ``column``), and a range's own span on the device timeline counts
    nowhere."""
    from types import SimpleNamespace
    from torch.autograd import DeviceType

    def ev(name, dev, start, end, id_=0, annotation=False):
        return SimpleNamespace(name=name, device_type=dev, id=id_,
                               time_range=SimpleNamespace(start=start,
                                                          end=end),
                               is_user_annotation=annotation,
                               cpu_time_total=end - start)
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [
        ev("matinv::call", cpu, 0, 100),
        ev("matinv::pivot", cpu, 10, 20),
        ev("cudaLaunchKernelExC", cpu, 12, 13, 7),
        ev("panel_factor_cluster_kernel", gpu, 30, 35, 7),
        ev("matinv::row", cpu, 20, 40),
        ev("aten::mm", cpu, 21, 30),
        ev("cuLaunchKernelEx", cpu, 22, 23, 8),
        ev("sgemm", gpu, 40, 52, 8),
        ev("cudaMemsetAsync", cpu, 41, 42, 9),     # outside every range
        ev("Memset", gpu, 60, 61, 9),
        ev("matinv::pivot", gpu, 30, 35, 0, annotation=True),
    ]
    out, total = phases._slot_times(events, cuda=True)
    assert out == {"make_augmented": 0.0, "pivot": 5, "row": 12}
    assert total == 18
    out, total = phases._slot_times(events, cuda=False)
    assert out["pivot"] == 10 and out["row"] == 20 and total == 100


def test_phase_ranges_only_when_on():
    """The driver's ranges exist only while phase ranges are on: outside
    trace() and measure_phases the hot path opens none."""
    from torch.profiler import ProfilerActivity, profile
    from gpu_matrix_inversion_tpu_torch.ops import blocked
    a = torch.from_numpy(hollow_random_matrix(64, seed=3))
    for on in (False, True):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            if on:
                with profiling.phase_ranges():
                    blocked.blocked_inverse(a, block_size=32, refine=0)
            else:
                blocked.blocked_inverse(a, block_size=32, refine=0)
        names = {e.name for e in prof.events()
                 if e.name.startswith("matinv::")}
        assert names == ({"matinv::make_augmented", "matinv::pivot"}
                         if on else set())


def test_bench_debug_phases_fills_slots(monkeypatch):
    """MATINV_DEBUG_PHASES=1 at order 512: measure_phases runs after the
    bench with k=2, reps=1 on the bench's device, its slots fill Res.times
    (total_compute stays the span-measured one), in times_vector's
    places."""
    seen = {}
    real = phases.measure_phases

    def spy(n, **kwargs):
        seen.update(kwargs, n=n)
        return real(n, **kwargs)

    monkeypatch.setattr(phases, "measure_phases", spy)
    monkeypatch.setenv("MATINV_DEBUG_PHASES", "1")
    a = hollow_random_matrix(512, seed=512)
    res = api.fp32_bench(a.reshape(-1), 512, device="cpu")
    assert res.ok
    assert seen == {"n": 512, "pivot": True, "k": 2, "reps": 1,
                    "device": "cpu"}
    for key in phases.SLOTS:
        assert res.times[key] >= 0.0
    assert res.times["pivot"] > 0 and res.times["column"] > 0
    vec = res.times_vector()
    assert vec[3:7] == [res.times[k] for k in ("make_augmented", "pivot",
                                                "row", "column")]
    assert vec[7] == res.times["total_compute"]
    # Below order 512, or without the switch, the slots stay unset.
    monkeypatch.setattr(phases, "measure_phases", None)
    small = api.fp32_bench(a[:64, :64].reshape(-1), 64, device="cpu")
    assert "pivot" not in small.times
    monkeypatch.delenv("MATINV_DEBUG_PHASES")
    assert "pivot" not in api.fp32_bench(a.reshape(-1), 512,
                                         device="cpu").times


def test_trace_writes_cpu_trace(tmp_path):
    """trace(log_dir, device="cpu") writes a Chrome/TensorBoard trace file
    holding the driver's phase ranges."""
    from gpu_matrix_inversion_tpu_torch import inverse
    a = torch.from_numpy(hollow_random_matrix(64, seed=1))
    with profiling.trace(tmp_path, device="cpu"):
        inverse(a, method="blocked", block_size=32)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "matinv::pivot" in names and "matinv::make_augmented" in names
    assert not any(e.get("cat") == "kernel" for e in events)


def test_trace_on_cuda_without_card_raises(tmp_path, monkeypatch):
    """device="cuda" (the default) with no CUDA device raises; nothing is
    recorded on the CPU in its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no such CUDA device"):
        with profiling.trace(tmp_path):
            pass
    with pytest.raises(ValueError):
        with profiling.trace(tmp_path, device="meta"):
            pass
    assert not list(tmp_path.iterdir())


def test_measure_phases_cli(capsys, monkeypatch):
    """The CLI prints the five slots in ms and the reference's 4 N^3 rate;
    it measures on the card (stubbed here)."""
    seen = {}

    def fake(n, **kwargs):
        seen.update(kwargs, n=n)
        return dict(make_augmented=1e-4, pivot=1e-2, row=0.0, column=8e-3,
                    total_compute=0.02)
    monkeypatch.setattr(phases, "measure_phases", fake)
    phases.main(["--n", "128", "--k", "1"])
    out = capsys.readouterr().out
    for key in KEYS:
        assert f"{key}:" in out
    assert "20.000 ms" in out and "0.4" in out.split("gflops(4N^3):")[1]
    assert seen == {"n": 128, "block_size": 128, "precision": "highest",
                    "k": 1}
