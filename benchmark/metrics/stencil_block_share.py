"""``stencil_block_share``: the ``stencil.apply`` spans (each launch of K1) over the ``block`` spans, on the card's
timer (``benchmark/spans.py``): the cross stencil's part of a block where the block runs it."""

from benchmark import spans


def read(ctx):
    s = spans.readings(ctx)
    return None if s is None else s.stencil_block_share
