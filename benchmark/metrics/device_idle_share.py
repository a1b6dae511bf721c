"""``device_idle_share``: the share of the traced intervals' ``march`` spans (on the host clock) that no ``block``
span covers (``benchmark/spans.py``).  A block's span is the card's global timer at its graph's first and last node,
placed on the host clock, so every trip of the block's device ``while`` lies inside it."""

from benchmark import spans


def read(ctx):
    s = spans.readings(ctx)
    return None if s is None else s.device_idle_share
