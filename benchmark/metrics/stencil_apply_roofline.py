"""``stencil_apply_roofline``: the least time of the fine level's operator apply at the shape the block hands
it (``(M, P, n, n)``: a prolongation's nodes of every step), each byte read once and written once at the card's
bandwidth, over its time through the problem's own ``eval_f``.  The applies are timed as the block runs them, from
a CUDA graph (one apply of each of several inputs, rotated past the L2 cache), by CUDA events over about 0.2 s of
replays: timed eagerly, a 512^2 apply measures the host's launch, not the card."""

import math


def read(ctx):
    torch, ys = ctx.torch, ctx.yardstick
    run = ctx.run
    prob = run.ctrl.MS[0].levels[0].prob
    if run.device.type != 'cuda' or not hasattr(prob, 'A'):
        return None
    M = run.spec.config['num_nodes'][0]
    shape = (M, run.P) + tuple(prob.shape)
    itemsize = torch.empty((), dtype=run.dtype).element_size()
    flops, nbytes = ys.stencil_apply_work(shape, itemsize)
    n_buf = max(2, math.ceil(4 * ys.PEAKS['l2_bytes'] / (nbytes / 2)))
    gen = torch.Generator(device=run.device).manual_seed(run.seed % 2**63)
    inputs = [torch.rand(shape, generator=gen, dtype=run.dtype, device=run.device) for _ in range(n_buf)]
    side = torch.cuda.Stream(device=run.device)
    side.wait_stream(torch.cuda.current_stream(run.device))
    with torch.cuda.stream(side):  # first calls (launch plans) outside the capture
        for u in inputs:
            prob.eval_f(u, 0.0)
    torch.cuda.current_stream(run.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for u in inputs:
            prob.eval_f(u, 0.0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed(replays):
        torch.cuda.synchronize()
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / (replays * n_buf)

    first = timed(1)
    seconds = timed(max(4, math.ceil(0.2 / (first * n_buf))))
    share, _ = ys.roofline_share(seconds, flops=flops, nbytes=nbytes, flop_peak=ys.PEAKS['fp32_flop_per_s'])
    del graph, inputs
    return share
