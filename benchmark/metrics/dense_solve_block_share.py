"""``dense_solve_block_share``: the ``linalg.solve`` spans (``ops/linalg.py:solve``) over the ``block`` spans, on the
card's timer (``benchmark/spans.py``): the part of a block that the dense solve route takes."""

from benchmark import spans


def read(ctx):
    s = spans.readings(ctx)
    return None if s is None else s.dense_solve_block_share
