"""``iters_per_step``: the mean PFASST iteration count over every step of the window, from the statistics
``run`` returns."""


def read(ctx):
    iters = [n for iv in ctx.window.intervals for block in iv.niters for n in block]
    return sum(iters) / len(iters) if iters else None
