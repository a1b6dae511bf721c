"""``block_device_ms``: the mean ``block`` span of the traced intervals (``benchmark/spans.py``): the card's global
timer from the block graph's first node to its last, none of the host's work."""

from benchmark import spans


def read(ctx):
    s = spans.readings(ctx)
    return None if s is None else s.block_device_ms
