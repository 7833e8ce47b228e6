"""Input generators, one a file, found by the name a configuration's
``generator`` gives. Each has ``device(seed, shape, *, device, dtype)``, a
tensor of ``shape`` (``(..., n, n)``) drawn on ``device`` in one call, and
``host(seed, count, n, *, dtype)``, ``count`` flat row-major numpy vectors
drawn on the host. Neither takes anything of the program."""
