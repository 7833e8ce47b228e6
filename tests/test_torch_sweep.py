"""The port's sweep CLI (``benchmarks/sweep.py``) on the CPU: the cases of
``tests/test_sweep.py`` with ``device="cpu"``, and ``--resume`` as
``tests/test_config.py::test_sweep_resume`` checks it for the JAX CLI."""

import io

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gpu_matrix_inversion_tpu.benchmarks import sweep as jsweep  # noqa: E402
from gpu_matrix_inversion_tpu_torch.benchmarks.sweep import (  # noqa: E402
    _done_sizes, _spd_matrix, main, reference_sizes, sweep_cuda, sweep_numpy)


def test_reference_ramp_equals_jax():
    # main_file.cpp:73-78: 10 -> 2000 step 10, then step 1000.
    sizes = list(reference_sizes(4000))
    assert sizes == list(jsweep.reference_sizes(4000))
    assert sizes[0] == 10 and sizes[1] == 20
    assert 2000 in sizes and 3000 in sizes and 4000 in sizes
    assert 2010 not in sizes
    assert (list(reference_sizes(16000, coarse_step=500))
            == list(jsweep.reference_sizes(16000, coarse_step=500)))


def test_spd_matrix_equals_jax():
    import numpy as np
    for dtype in (np.float32, np.float64):
        np.testing.assert_array_equal(
            _spd_matrix(33, seed=4, dtype=dtype),
            jsweep._spd_matrix(33, seed=4, dtype=dtype))


def test_numpy_sweep_rows():
    out = io.StringIO()
    sweep_numpy(30, out)
    rows = out.getvalue().strip().splitlines()
    assert len(rows) == 3  # N = 10, 20, 30
    n, t, err, resid = rows[0].split()
    assert int(n) == 10 and float(t) >= 0 and abs(float(err)) < 1e-3


def test_device_sweep_rows():
    out = io.StringIO()
    sweep_cuda(20, out, method="spec", repeat=1, device="cpu")
    rows = out.getvalue().strip().splitlines()
    assert len(rows) == 2
    cols = rows[-1].split()
    assert int(cols[0]) == 20 and len(cols) == 8
    assert float(cols[7]) < 1e-4  # normalized residual column


def test_device_sweep_sharded_method_raises():
    """--method sharded reaches the solver, whose sharded route is not
    ported yet: NotImplementedError, no row."""
    out = io.StringIO()
    with pytest.raises(NotImplementedError):
        sweep_cuda(0, out, method="sharded", repeat=1, sizes=[64],
                   device="cpu")
    assert out.getvalue() == ""


def test_device_sweep_amortized_and_strict_columns():
    out = io.StringIO()
    sweep_cuda(20, out, method="spec", repeat=1, amortize=3,
               strict_verify=True, device="cpu")
    cols = out.getvalue().strip().splitlines()[-1].split()
    assert len(cols) == 10  # amortized per-inversion time, max|AX-I|
    assert float(cols[8]) >= 0.0 and float(cols[9]) < 1e-3


def test_device_sweep_spd_cholesky():
    """--spd generates SPD inputs so --method cholesky sweeps cleanly."""
    out = io.StringIO()
    sweep_cuda(0, out, method="cholesky", repeat=1, sizes=[48, 96],
               spd=True, device="cpu")
    rows = out.getvalue().strip().splitlines()
    assert len(rows) == 2
    for row in rows:
        cols = row.split()
        assert len(cols) == 8
        assert float(cols[7]) < 1e-5  # SPD potri residual tier


def test_device_sweep_fp64_needs_no_switch():
    """FP64 input runs in float64 with no global switch (the JAX CLI turns
    on x64 for --fp64), at FP64 accuracy."""
    import numpy as np
    out = io.StringIO()
    sweep_cuda(0, out, method="auto", repeat=1, sizes=[24],
               dtype=np.float64, device="cpu")
    cols = out.getvalue().strip().split()
    assert int(cols[0]) == 24 and float(cols[7]) < 1e-12


def test_sweep_resume(tmp_path):
    out = tmp_path / "rows.txt"
    main(["--numpy-baseline", "--max-n", "30", "--out", str(out)])
    first = out.read_text().strip().splitlines()
    assert len(first) == 3
    # resume: nothing new below 30, one new row at 40
    main(["--numpy-baseline", "--max-n", "40", "--out", str(out), "--resume"])
    rows = out.read_text().strip().splitlines()
    assert len(rows) == 4
    assert rows[-1].startswith("40 ")
    # the device sweep skips the same sizes
    dev = io.StringIO()
    sweep_cuda(0, dev, method="spec", repeat=1, sizes=[40, 50],
               skip=_done_sizes(str(out)), device="cpu")
    assert [r.split()[0] for r in dev.getvalue().splitlines()] == ["50"]
