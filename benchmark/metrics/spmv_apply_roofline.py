"""``spmv_apply_roofline``: the least time of the sparse operator's SpMV at the shape the PCG hands it (``(P, n)``:
one vector a step of the block), its diagonals, its input and its output each moved once at the card's bandwidth
(``benchmark/sparse_yardstick.py``), over its time through the operator's own ``apply`` (``ops/sparse_op.py``: K2 on
the card).  Timed from a CUDA graph by CUDA events over about 0.2 s of replays, each replay one apply of each of
several copies of the operator's diagonals and of the input, rotated past the L2 cache: every counted byte comes
from HBM."""

import copy
import math


def read(ctx):
    torch, ys = ctx.torch, ctx.yardstick
    from benchmark import sparse_yardstick

    run = ctx.run
    if run.device.type != 'cuda':
        return None
    op = getattr(run.ctrl.MS[0].levels[0].prob, 'A', None)
    if getattr(op, 'dia', None) is None:
        return None
    from pysdc_tpu_torch.ops.sparse import DIA

    dia = op.dia
    itemsize = torch.empty((), dtype=run.dtype).element_size()
    flops, nbytes = sparse_yardstick.spmv_apply_work(op.n, run.P, len(dia.offsets), itemsize)
    gen = torch.Generator(device=run.device).manual_seed(run.seed % 2**63)
    calls = []
    for _ in range(max(2, math.ceil(4 * ys.PEAKS['l2_bytes'] / nbytes))):
        twin = copy.copy(op)  # the operator's own apply, on a copy of its diagonals
        twin.dia = DIA(dia.data.clone(), dia.offsets, dia.shape, nnz=dia.nnz, grid=dia.grid, device=dia.data.device)
        u = torch.rand((run.P,) + tuple(op.grid_shape), generator=gen, dtype=run.dtype, device=run.device)
        calls.append(lambda twin=twin, u=u: twin.apply(u))
    seconds = sparse_yardstick.graph_seconds(torch, run.device, calls)
    share, _ = ys.roofline_share(seconds, flops=flops, nbytes=nbytes, flop_peak=ys.PEAKS['fp32_flop_per_s'])
    return share
