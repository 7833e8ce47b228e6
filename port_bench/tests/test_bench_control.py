"""The control comes out not correct: the plain reference in the program's
place with its GEMMs one precision down (TF32, emulated), held to each
cell's limits. On the CPU at a small size; on the card (``gpu``) at the
cells' own sizes, with the blocked route's own TF32 path as the control
where the call is one matrix."""

import pytest
import torch

from port_bench import calibrate
from port_bench.core import check, loop, spec
from port_bench.tests.test_bench_run import small_cell

CELLS = [("batched128.b4096", 128, 8), ("single4096.device", 512, None),
         ("single4096.flat", 512, None)]


@pytest.mark.parametrize("cell,n,batch", CELLS)
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_control_fails_the_limits_at_a_small_size(cell, n, batch, seed):
    c = small_cell(cell, n, batch)
    load = loop.Load(c, seed, "cpu")
    readings = calibrate.controls(load)
    assert not check.verdict(readings["reference_tf32"], c.limits)[0]
    assert check.verdict(readings["reference_fp32"], c.limits)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [c[0] for c in CELLS])
def test_control_fails_the_limits_at_the_cells_size(card, cell):
    c = spec.cell(cell)
    for seed in (31, 2**31 + 31, 3 * 10**9 + 31):
        load = loop.Load(c, seed, card)
        readings = calibrate.controls(load)
        assert not check.verdict(readings["reference_tf32"], c.limits)[0]
        if "program_tf32" in readings:
            assert not check.verdict(readings["program_tf32"], c.limits)[0]
        del load
        torch.cuda.empty_cache()
