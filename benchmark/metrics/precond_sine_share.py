"""``precond_sine_share``: the share of the PCG preconditioner's eigen solves that the sine kernels served,
``100 separable.sine_kernel_solves / separable.eigen_solves``, from the program's counters (``utils/trace.py``;
``ops/linop.py``'s ``SeparableFDOperator.solve_shifted``: each solve off the rfft path of an operator with a
non-periodic axis is an eigen solve, inside the PCG's nested device ``while`` one a trip; a sine kernel solve is
tallied only where the kernels' route took the solve, so a decline to the transform chain reads below 100).  It traces on its own after
the harness's other readers, as ``pcg_trips_per_solve`` does: one untimed interval (the block graph captured again,
with the counters), then as many intervals as ``benchmark/spans.py`` traces, and the counters' change over those.
``None`` without a card, or where no eigen solve was counted (a program without these counters)."""

from benchmark import harness, spans

KEYS = ('separable.eigen_solves', 'separable.sine_kernel_solves')


def read(ctx):
    run = ctx.run
    if run.device.type != 'cuda' or not ctx.window.intervals:
        return None
    try:
        from pysdc_tpu_torch.utils import trace
    except ImportError:  # a program without counters
        return None
    return measure(ctx, trace)


def measure(ctx, trace):
    """Trace a few intervals of ``ctx.run`` on its device and read the counters (the CPU tests call it directly)."""
    run = ctx.run
    n = spans._intervals(ctx)
    trace.enable(run.device)
    try:
        u0, _ = run.start_of(0)
        run.interval(u0)  # captures the block graph with its counters
        before = dict(trace.record().counters)
        for i in range(n):
            u0, _ = run.start_of(i)
            run.interval(u0)
        after = trace.record().counters
    finally:
        trace.disable()
    eigen, sine = (after.get(k, 0) - before.get(k, 0) for k in KEYS)
    harness.log(f'precond_sine_share: {n} traced intervals, {eigen} eigen solves, {sine} of them by the sine kernels')
    return 100.0 * sine / eigen if eigen > 0 else None
