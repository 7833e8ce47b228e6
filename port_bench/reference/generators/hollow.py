"""The reference's hollow protocol, frozen.

Entries drawn from Uniform(0, 100) with a zero diagonal
(MarchesiGabriele/gpu_matrix_inversion ``main_file.cpp:41-52``). The zero
diagonal makes every pivoted route pivot on the first column of every
leading submatrix. This copy belongs to the benchmark; the program's own
generators are never used, so a change to them cannot change the inputs.
"""

from __future__ import annotations

import numpy as np
import torch

LOW, HIGH = 0.0, 100.0


def device(seed: int, shape: tuple, *, device, dtype=torch.float32):
    """A tensor of ``shape`` (..., n, n) of hollow matrices, drawn on
    ``device`` by a ``torch.Generator`` seeded with ``seed``, in one call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    a = torch.rand(shape, generator=gen, device=device, dtype=dtype)
    a.mul_(HIGH - LOW).add_(LOW)
    a.diagonal(dim1=-2, dim2=-1).zero_()
    return a


def host(seed: int, count: int, n: int, *, dtype=np.float32) -> list:
    """``count`` flat row-major vectors of hollow n x n matrices, drawn
    with numpy on the host from ``seed``."""
    rng = np.random.default_rng(int(seed))
    out = []
    for _ in range(count):
        a = rng.random((n, n), dtype=dtype)
        a *= dtype(HIGH - LOW)
        a += dtype(LOW)
        np.fill_diagonal(a, 0)
        out.append(a.reshape(-1))
    return out
