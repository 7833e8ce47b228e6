"""Operations and bytes of the spec LU route's kernels (``ops/lu.py``), for
their roofline shares: L4, the getrf of an n x n matrix, and L5, the getrs
of its factor on k right-hand sides.

The counts are of the work the step needs, as in ``counts.py``: 2 n^3 / 3
operations for the factor, 2 n^2 k for the two triangular solves; the
factor's matrix, or the factor and the right-hand sides, read once and the
result written once. Bytes are counted in float32, the dtype the refined
route factors and solves in, and the bound is taken at float32's peak
(``counts.bound_s``).
"""

from __future__ import annotations

ITEMSIZE = 4        # float32


def order(inverse_flops: float) -> int:
    """n of one n x n inverse counted at 2 n^3 operations
    (``counts.inverse_flops``)."""
    return round((inverse_flops / 2.0) ** (1.0 / 3.0))


def factor_flops(n: int) -> float:
    """Operations of an n x n LU factorisation: 2 n^3 / 3."""
    return 2.0 * n ** 3 / 3.0


def factor_bytes(n: int, itemsize: int = ITEMSIZE) -> float:
    """Bytes of the factorisation: A read once, L U written once."""
    return 2.0 * n * n * itemsize


def solve_flops(n: int, k: int) -> float:
    """Operations of a forward and a back solve on k right-hand sides:
    2 n^2 k."""
    return 2.0 * n * n * k


def solve_bytes(n: int, k: int, itemsize: int = ITEMSIZE) -> float:
    """Bytes of the solve: the factor and B read once, X written once."""
    return (n * n + 2.0 * n * k) * itemsize
