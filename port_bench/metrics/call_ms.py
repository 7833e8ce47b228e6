"""End to end: the window's milliseconds over the calls completed in it
(host clock)."""


def read(window):
    return 1e3 * window.seconds / window.calls
