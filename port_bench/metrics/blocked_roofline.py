"""Blocked route (``ops/blocked.py``, ``ops/refine.py``): one inverse's
work (2n^3 operations, 8n^2 bytes) over the call's device time, as a share
of the roofline. Device time: every operation the calls ran but the
copies between host and card. Nothing to read where the panel kernels
did not run."""

from port_bench.core import kernels


def read(segment):
    return segment.roofline_pct(kernels.PANEL)
