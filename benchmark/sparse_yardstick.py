"""The work of the sparse lane's layers that the per-layer metrics of ``sparse.n1024`` time.

Nothing here imports the program.  As in ``yardstick.py``, the work is what a call needs, from its shapes: each
byte read once and written once, so that a later change to the program that fuses, splits or replaces a kernel
leaves the yardstick where it was.
"""

from __future__ import annotations

import math


def spmv_apply_work(n: int, batch: int, diagonals: int, itemsize: int):
    """(operations, bytes) of ``y = A x`` for a matrix of ``n`` rows on ``diagonals`` diagonals (DIA storage,
    ``diagonals x n`` values) over ``batch`` vectors: a multiply and an add a diagonal and entry; the diagonals read
    once, the input read once and the output written once."""
    return 2 * diagonals * n * batch, (diagonals * n + 2 * batch * n) * itemsize


def precond_solve_work(shape, itemsize: int):
    """(operations, bytes) of the preconditioner's exact solve of a right-hand side of ``shape``: the right-hand
    side read once and the solution written once.  Neither the tables of a transform nor its operations are counted
    (a fast sine transform's, about 5 log2(2 n) a point for each axis and direction, would lie near the bytes' time
    at 1024^2): the bytes are a bound that no way of solving can pass."""
    return 0, 2 * math.prod(shape) * itemsize


def graph_seconds(torch, device, calls, seconds: float = 0.2) -> float:
    """The mean time on the card of one of ``calls`` (callables of no argument), timed by CUDA events over about
    ``seconds`` of replays of one CUDA graph that runs each once.  Their first calls (tables, casts, plans) run on a
    side stream before the capture."""
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for call in calls:
            call()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in calls:
            call()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed(replays):
        torch.cuda.synchronize()
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / (replays * len(calls))

    first = timed(1)
    return timed(max(4, math.ceil(seconds / (first * len(calls)))))
