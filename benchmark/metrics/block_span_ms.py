"""``block_span_ms``: the CUDA-event spans of the window's intervals, summed, over the blocks they ran.

The events are recorded on the current stream before the ``run`` call and after the output's copy.  The stream
is idle while the host works in the march entry (its inputs, the blocking fetch, the statistics), so the span
holds that host work as well as the block graphs' replays: it is the interval's time per block, an upper bound
of the fused graph's own time, and it cannot tell the two apart."""


def read(ctx):
    spans = [iv.span_ms for iv in ctx.window.intervals if iv.span_ms is not None]
    if not spans:
        return None
    return sum(spans) / (len(spans) * ctx.run.blocks)
