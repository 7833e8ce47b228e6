"""Refined LU route (``ops/refine.py``, ``ops/lu.py``): L5, the spec getrs
(``csrc/lu_solve.cu``) of the identity (k = n right-hand sides, getri), as
a share of its roofline: the solves' work (``reference/counts_lu.py``:
2n^2k operations, the factor and B read once and X written once, float32)
over L5's device seconds. n is read from the segment's work, 2n^3 a call.
Nothing to read where L5 did not run."""

from port_bench.reference import counts, counts_lu

KERNELS = ("lu_solve_kernel",)


def read(segment):
    seconds = segment.seconds_of(KERNELS)
    if not seconds:
        return None
    n = counts_lu.order(segment.work["flops"] / segment.calls)
    bound = counts.bound_s(segment.calls * counts_lu.solve_flops(n, n),
                           segment.calls * counts_lu.solve_bytes(n, n),
                           "float32")
    return 100.0 * bound / seconds
