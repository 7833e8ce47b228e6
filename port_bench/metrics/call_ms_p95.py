"""End to end: the 95th percentile of every call's latency in the window,
in ms (host clock), from the call to its result usable on the host: ``ok``
read, or the vector returned."""

import numpy as np


def read(window):
    return float(np.percentile(np.asarray(window.latencies) * 1e3, 95))
