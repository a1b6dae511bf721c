"""``coarse_chain_share``: the ``block.coarse`` spans (IT_COARSE's serial Gauss-Seidel chain and the burn-in's coarse
wavefront) over the ``block`` spans, on the card's timer (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    s = spans.readings(ctx)
    return None if s is None else s.coarse_chain_share
