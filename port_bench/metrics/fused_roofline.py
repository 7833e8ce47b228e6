"""Fused route (``ops/fused.py``, K1): the calls' work (B 2n^3 operations,
B 8n^2 bytes) over their device time, as a share of the roofline. Device
time: every operation the calls ran but the copies between host and
card. Nothing to read where K1 did not run."""

from port_bench.core import kernels


def read(segment):
    return segment.roofline_pct(kernels.K1)
