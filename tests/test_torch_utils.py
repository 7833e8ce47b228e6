"""The port's copied host utilities give the JAX package's outputs, the
package never imports JAX, and importing it builds no kernel."""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gpu_matrix_inversion_tpu.utils import generators as jgen  # noqa: E402
from gpu_matrix_inversion_tpu.utils import res as jres  # noqa: E402
from gpu_matrix_inversion_tpu.utils import residual as jresid  # noqa: E402
from gpu_matrix_inversion_tpu.utils import validation as jval  # noqa: E402
from gpu_matrix_inversion_tpu_torch.utils import generators as tgen  # noqa: E402,E501
from gpu_matrix_inversion_tpu_torch.utils import res as tres  # noqa: E402
from gpu_matrix_inversion_tpu_torch.utils import residual as tresid  # noqa: E402,E501
from gpu_matrix_inversion_tpu_torch.utils import validation as tval  # noqa: E402,E501

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name,kwargs", [
    ("random_matrix", {}),
    ("random_matrix", {"low": -1.0, "high": 1.0, "dtype": np.float64}),
    ("hollow_random_matrix", {}),
    ("hollow_random_matrix", {"dtype": np.float64}),
    ("well_conditioned_matrix", {}),
    ("ill_conditioned_matrix", {"cond": 1e4}),
])
def test_generators_bit_identical(name, kwargs):
    for n, seed in ((1, 0), (17, 3), (64, 1950)):
        want = getattr(jgen, name)(n, seed=seed, **kwargs)
        got = getattr(tgen, name)(n, seed=seed, **kwargs)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flat,order", [
    ([1.0, 2.0, 3.0, 4.0], 2), ([1.0, 2.0, 3.0, 4.0], 0),
    ([1.0, 2.0, 3.0, 4.0], -1), ([1.0, 2.0, 3.0], 2),
    (np.arange(9.0).reshape(3, 3), 3), ([1.0, 2.0, 3.0, 4.0], 2.0),
    (np.arange(4.0), np.int64(2)),
])
def test_validation_identical(flat, order):
    want = jval.validate_flat_matrix(flat, order)
    got = tval.validate_flat_matrix(flat, order)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)


def test_residuals_identical():
    a = jgen.hollow_random_matrix(32, seed=4).astype(np.float64)
    x = np.linalg.inv(a) + 1e-6
    assert (tresid.relative_residual(a, x)
            == jresid.relative_residual(a, x))
    assert (tresid.reference_error_metric(a, x)
            == jresid.reference_error_metric(a, x))


def test_res_fields_identical():
    want, got = jres.Res(), tres.Res()
    assert ([f.name for f in dataclasses.fields(got)]
            == [f.name for f in dataclasses.fields(want)])
    times = {"buffers": 1.0, "crr": 2.0, "total": 3.0}
    want.times, got.times = dict(times), dict(times)
    for no_pivot in (False, True):
        assert (got.times_vector(no_pivot=no_pivot)
                == want.times_vector(no_pivot=no_pivot))
    timer = tres.PhaseTimer()
    with timer.span("a"):
        pass
    with timer.span("a"):
        pass
    assert set(timer.times) == {"a"} and timer.total() >= timer.times["a"]


def test_port_never_imports_jax():
    """With ``jax`` blocked, the package imports and matrix_inv_32 runs on
    the CPU; no kernel is built (importing never builds)."""
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np
        import gpu_matrix_inversion_tpu_torch as tmi
        from gpu_matrix_inversion_tpu_torch.utils import cuda_build
        a = np.random.default_rng(0).standard_normal((24, 24))
        out = tmi.matrix_inv_32(a.astype(np.float32).reshape(-1), 24,
                                device="cpu")
        assert out.shape == (576,)
        assert not any(m == "jax" or m.startswith("jax.")
                       for m, v in sys.modules.items() if v is not None)
        assert cuda_build._lib is None
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          check=False)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_package_source_has_no_jax_import():
    pkg = REPO / "gpu_matrix_inversion_tpu_torch"
    for path in pkg.rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax")), (
                f"{path}: {line}")


def test_kernel_library_named_by_source_hash(tmp_path, monkeypatch):
    """The build reuses a library only for identical sources: an edited
    source gets another library path."""
    from gpu_matrix_inversion_tpu_torch.utils import cuda_build
    first = cuda_build.library_path()
    assert first.parent == cuda_build.BUILD_DIR
    assert first == cuda_build.library_path()
    for src in cuda_build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    assert cuda_build.library_path() == first
    (tmp_path / "fused_gj.cu").write_text(
        (tmp_path / "fused_gj.cu").read_text() + "\n// edited\n")
    assert cuda_build.library_path() != first


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No toolkit: the build raises instead of anything carrying on."""
    import shutil
    from gpu_matrix_inversion_tpu_torch.utils import cuda_build
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is installed")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build()
    assert not (tmp_path / "build").exists()


def test_device_kernels_raises_when_no_device_time(monkeypatch):
    """A profiled call that ran nothing on a device raises NoDeviceTime (a
    RuntimeError), which measurement scripts may catch to profile again;
    here the call runs on the CPU only (nothing to synchronize)."""
    from gpu_matrix_inversion_tpu_torch.utils import profiling
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    with pytest.raises(profiling.NoDeviceTime):
        profiling.device_kernels(lambda: torch.ones(3) + 1)
    assert issubclass(profiling.NoDeviceTime, RuntimeError)


def test_device_ms_profiles_again_then_reports_not_measured(monkeypatch):
    """device_ms warms up once, then profiles ``iters`` calls in up to
    three sessions; when none saw device time it returns None."""
    from gpu_matrix_inversion_tpu_torch.utils import profiling
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    assert profiling.device_ms(lambda: calls.append(1), iters=2) is None
    assert len(calls) == 1 + 3 * 2


@pytest.mark.parametrize("module", ["", ".ops", ".utils"])
def test_exports_hold_the_jax_lists(module):
    """The port's ``__all__`` lists hold the JAX package's; each name
    resolves."""
    import importlib
    want = importlib.import_module("gpu_matrix_inversion_tpu" + module)
    got = importlib.import_module("gpu_matrix_inversion_tpu_torch" + module)
    assert set(want.__all__) <= set(got.__all__)
    for name in got.__all__:
        assert getattr(got, name) is not None


def test_bracketed_markers_only_on_a_card(monkeypatch):
    """The marker kernels launch only on a CUDA device that exists; their
    records are told apart by name."""
    from gpu_matrix_inversion_tpu_torch.utils import profiling
    launched = []
    monkeypatch.setattr(torch.cuda, "_sleep", launched.append)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with profiling.bracketed("cuda"):
        pass
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with profiling.bracketed("cpu"):
        pass
    assert launched == []
    with profiling.bracketed("cuda"):
        launched.append("body")
    assert launched == [1, "body", 1]
    assert profiling.is_marker("at::cuda::(anonymous namespace)::"
                               "spin_kernel(long)")
    assert not profiling.is_marker("panel_factor_cluster_kernel")
