"""End to end: the matrices whose inverse came back in the window, over
the window's seconds (host clock)."""


def read(window):
    return window.inversions / window.seconds
