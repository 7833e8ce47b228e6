"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a chip and drives the rest of a
run on the CPU at a small size, with ``models.solver.inverse`` (which the
flat API calls too) broken by a fault of ``core/faults.py``: a call that
returns its state unchanged; half of a batch left out, ``ok`` taken over
the rest; an answer altered where it is produced (the largest element of
each inverse negated). (No cell spans chips, so none can leave out an
exchange.) On the card the same faults are read at the cells' own sizes
by ``calibrate.py --faults``."""

import time

import pytest
import torch

from port_bench import run
from port_bench.core import check, faults
from port_bench.reference.generators import hollow
from port_bench.tests.test_bench_run import small_cell

CELLS = [("batched128.b4096", 128, 8), ("single4096.device", 512, None),
         ("single4096.flat", 512, None)]
CASES = [(cell, n, batch, fault) for cell, n, batch in CELLS
         for fault in faults.FAULTS if faults.applies(fault, batch)]


def _run(cell, n, batch):
    return run.measure(small_cell(cell, n, batch), 2**31 + 17, 0.3, False,
                       device="cpu", t_start=time.perf_counter())


@pytest.mark.parametrize("cell,n,batch,fault", CASES,
                         ids=[f"{c[0]}-{c[3]}" for c in CASES])
def test_a_broken_path_is_not_correct(cell, n, batch, fault):
    with faults.planted(fault):
        out = _run(cell, n, batch)
    assert out["correct"] is False
    assert any(c["value"] == "inf" or c["value"] > c["limit"]
               for c in out["checks"].values())


@pytest.mark.parametrize("cell,n,batch", CELLS)
def test_the_sound_path_is_correct(cell, n, batch):
    assert _run(cell, n, batch)["correct"] is True


def test_a_fault_is_removed_after_its_block():
    from gpu_matrix_inversion_tpu_torch.models import solver
    sound = solver.inverse
    with faults.planted("altered"):
        assert solver.inverse is not sound
    assert solver.inverse is sound


@pytest.mark.parametrize("n", [256, 512])
def test_one_wrong_element_shows_in_its_column(n):
    """A typical element of X negated: ``resid`` spreads its error over
    all n columns, ``resid_col`` reads it whole (``2 |x_ij|`` times
    column i of A, over ``||A||_F ||X||_F / sqrt(n)``)."""
    a = hollow.device(n, (n, n), device="cpu").double()
    x = torch.linalg.inv(a).contiguous()
    xref = x.clone()
    flat = x.reshape(-1)
    k = int(flat.abs().argsort()[flat.numel() // 2])
    i, j = divmod(k, n)
    want = (2 * abs(float(x[i, j])) * float(a[:, i].norm()) * n ** 0.5
            / float(a.norm() * x.norm()))
    flat[k] *= -1
    resid, resid_col, _ = check.gaps(a, x, xref)
    assert resid_col == pytest.approx(want, rel=1e-6)
    assert resid_col > 10 * resid
