"""Blocked route: the panel factor's share of the call's device time: K2
and K3, its search-only mode (``core/kernels.py``). Device time: every
operation but the copies between host and card."""

from port_bench.core import kernels


def read(segment):
    panel = segment.seconds_of(kernels.PANEL)
    if not panel:
        return None
    return 100.0 * panel / segment.device_s()
