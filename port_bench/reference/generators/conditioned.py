"""Ill-conditioned matrices of a set 2-norm condition number, frozen.

``A = U diag(s) V^T`` with ``s_i = KAPPA^(-i / (n - 1))``: singular values
spread geometrically from 1 down to ``1 / KAPPA``, so ``kappa_2(A) =
KAPPA`` (LAPACK's ``dlatms`` with MODE = 3, the spectrum of the ``dchkge``
test matrices). ``U`` and ``V`` are the Q factors of two Gaussian matrices,
each column's sign set by R's diagonal so that Q is Haar-distributed and a
function of the draw alone. This copy belongs to the benchmark; the
program's own generators are never used, so a change to them cannot change
the inputs.
"""

from __future__ import annotations

import numpy as np
import torch

KAPPA = 1e4


def _orthogonal(g: torch.Tensor) -> torch.Tensor:
    q, r = torch.linalg.qr(g)
    sign = torch.sgn(torch.diagonal(r, dim1=-2, dim2=-1))
    return q * torch.where(sign == 0, 1.0, sign)[..., None, :]


def device(seed: int, shape: tuple, *, device, dtype=torch.float64):
    """A tensor of ``shape`` (..., n, n) of matrices of condition number
    :data:`KAPPA`, drawn on ``device`` by a ``torch.Generator`` seeded with
    ``seed`` and built there in float64."""
    n = shape[-1]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    u = _orthogonal(torch.randn(shape, generator=gen, device=device,
                                dtype=torch.float64))
    v = _orthogonal(torch.randn(shape, generator=gen, device=device,
                                dtype=torch.float64))
    s = KAPPA ** (-torch.arange(n, device=device, dtype=torch.float64)
                  / max(n - 1, 1))
    return ((u * s) @ v.transpose(-2, -1)).to(dtype)


def host(seed: int, count: int, n: int, *, dtype=np.float64) -> list:
    """``count`` flat row-major vectors of such n x n matrices, the CPU's
    draw of :func:`device` from ``seed``."""
    a = device(seed, (count, n, n), device="cpu").numpy().astype(dtype)
    return [m.reshape(-1) for m in a]
