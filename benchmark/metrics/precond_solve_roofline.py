"""``precond_solve_roofline``: the least time of the PCG preconditioner's solve at the shape the PCG hands it
(``(P, nx, ny)``, the first node's shift ``dt QI[1, 1]``), its right-hand side read once and its solution written
once at the card's bandwidth (``benchmark/sparse_yardstick.py``), over its time through the preconditioner's own
``solve_shifted`` (``ops/linop.py``, the Dirichlet eigen path).  Timed from a CUDA graph by CUDA events over about
0.2 s of replays, each replay one solve of each of several right-hand sides, rotated past the L2 cache."""

import math


def read(ctx):
    torch, ys = ctx.torch, ctx.yardstick
    from benchmark import sparse_yardstick

    run = ctx.run
    if run.device.type != 'cuda':
        return None
    level = run.ctrl.MS[0].levels[0]
    precond = getattr(getattr(level.prob, 'A', None), 'precond', None)
    if precond is None:
        return None
    alpha = run.spec.config['dt'] * float(level.sweep.QI[1, 1])
    shape = (run.P,) + tuple(level.prob.A.grid_shape)
    itemsize = torch.empty((), dtype=run.dtype).element_size()
    flops, nbytes = sparse_yardstick.precond_solve_work(shape, itemsize)
    gen = torch.Generator(device=run.device).manual_seed(run.seed % 2**63)
    calls = []
    for _ in range(max(2, math.ceil(4 * ys.PEAKS['l2_bytes'] / (nbytes / 2)))):
        u = torch.rand(shape, generator=gen, dtype=run.dtype, device=run.device)
        calls.append(lambda u=u: precond.solve_shifted(u, alpha))
    seconds = sparse_yardstick.graph_seconds(torch, run.device, calls)
    share, _ = ys.roofline_share(seconds, flops=flops, nbytes=nbytes, flop_peak=ys.PEAKS['fp32_flop_per_s'])
    return share
