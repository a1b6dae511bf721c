"""``dense_solve_roofline``: the least time of the dense solves that one node of a sweep hands
``ops/linalg.py``'s ``solve`` (``ops/spectral.py``'s ``solve_shifted``: one matrix of ``4 nz`` rows a Fourier mode,
``M + dt QI[0, 0] L`` with its boundary lines, and the block's steps as right-hand sides), the larger of its
operations at the FP64 tensor-core peak and its bytes at the card's bandwidth, over its time through
``linalg.solve``.  CUDA events over a few calls (the matrices are far larger than the L2 cache)."""


def read(ctx):
    torch, ys = ctx.torch, ctx.yardstick
    run = ctx.run
    prob = run.ctrl.MS[0].levels[0].prob
    spec = getattr(prob, 'spec', None)
    if run.device.type != 'cuda' or spec is None:
        return None
    from pysdc_tpu_torch.ops import linalg

    cdtype = torch.complex128 if run.dtype == torch.float64 else torch.complex64
    sweep = run.ctrl.MS[0].levels[0].sweep
    alpha = run.spec.config['dt'] * float(sweep.QI[1, 1])

    def dev(a):
        return torch.as_tensor(a, dtype=cdtype, device=run.device)

    keep = torch.as_tensor(spec.keep_mask, device=run.device)
    A = (dev(spec.M_all) + alpha * dev(spec.L_all)) * keep[:, :, None] + dev(spec.bc_rows)
    batch, n = A.shape[0], A.shape[-1]
    gen = torch.Generator(device=run.device).manual_seed(run.seed % 2**63)
    b = torch.randn((run.P, batch, n, 1), generator=gen, dtype=cdtype, device=run.device)
    linalg.solve(A, b)  # warm
    reps = 3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        linalg.solve(A, b)
    end.record()
    end.synchronize()
    seconds = start.elapsed_time(end) / 1e3 / reps
    flops, nbytes = ys.dense_solve_work(batch, n, run.P, A.element_size())
    share, _ = ys.roofline_share(seconds, flops=flops, nbytes=nbytes, flop_peak=ys.PEAKS['fp64_tensor_flop_per_s'])
    del A, b
    return share
