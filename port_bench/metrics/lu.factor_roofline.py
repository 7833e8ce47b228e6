"""Refined LU route (``ops/refine.py``, ``ops/lu.py``): L4, the spec getrf
(``csrc/gauss_jordan.cu``'s LU mode), as a share of its roofline: the
factor's work (``reference/counts_lu.py``: 2n^3/3 operations, the matrix
read and written once, float32) over L4's device seconds. n is read from
the segment's work, 2n^3 a call. Nothing to read where L4 did not run."""

from port_bench.reference import counts, counts_lu

KERNELS = ("lu_factor_grid_kernel", "lu_factor_cluster_kernel")


def read(segment):
    seconds = segment.seconds_of(KERNELS)
    if not seconds:
        return None
    n = counts_lu.order(segment.work["flops"] / segment.calls)
    bound = counts.bound_s(segment.calls * counts_lu.factor_flops(n),
                           segment.calls * counts_lu.factor_bytes(n),
                           "float32")
    return 100.0 * bound / seconds
