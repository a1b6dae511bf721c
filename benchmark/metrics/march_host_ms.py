"""``march_host_ms``: the host's own work in the march entry, from the program's spans (``benchmark/spans.py``): the
mean over the traced intervals of the ``march`` span (``ShardedController.run(..., lane='fused')`` once the lane is
chosen, to its return) less its ``march.fetch`` (the one fetch, which waits for the card).  ``None`` where a block
graph was captured inside the traced intervals."""

from benchmark import spans


def read(ctx):
    s = spans.readings(ctx)
    return None if s is None else s.march_host_ms
