"""API (``api.py``): device ms a call of the copies between host and card
(the profiler's Memcpy HtoD and DtoH records)."""


def read(segment):
    copies = segment.host_copies()
    if not copies:
        return None
    return 1e3 * sum(r[2] for r in copies) / segment.calls
