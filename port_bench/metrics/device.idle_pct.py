"""Device (H100): the share of the traced segment's wall time in which no
operation ran on the card (1 - the union of kernels and copies over the
segment's seconds). One quantity; each cell reports it under a name of
its own (``device.idle_pct.<cell kind>``) that moves the cell's own
end-to-end metric."""


def read(segment):
    return segment.idle_pct()
