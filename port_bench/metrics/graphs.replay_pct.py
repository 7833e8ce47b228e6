"""Dispatch (``models/solver.py``, ``utils/graphs.py``): the share of the
traced calls served by a CUDA graph replay, a call counted where
``graphs.stats()``'s replays rose across it."""


def read(segment):
    return 100.0 * segment.counters["replayed_calls"] / segment.calls
