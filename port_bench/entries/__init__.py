"""The calls of the program a traffic mix can drive, one a file, found by
the name of the mix's ``entry``. Each has ``INPUTS`` (``"device"``: a
tensor on the card; ``"host"``: a flat numpy vector) and
``bind(device)``, which returns ``call(x, n) -> (answer, ok tensor or
None, ok on the host)``: the answer is the inverse of ``x`` (a tensor of
``x``'s shape, or a flat host vector, empty where the call failed), read
as the caller reads it before using it."""
