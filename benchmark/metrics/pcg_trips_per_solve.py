"""``pcg_trips_per_solve``: the trips of the PCG loops over the PCG solves, ``pcg.trips / pcg.solves``, from the
program's counters (``utils/trace.py``; ``ops/sparse_op.py``'s ``_pcg``: a solve is one call, which holds a block's
steps as its systems, and a trip one pass of its loop, which runs while any of them is still above its tolerance).  It
traces on its own after the harness's other readers: one untimed interval (the block graph captured again, with the
counters and the spans), then as many intervals as ``benchmark/spans.py`` traces, and the counters' change over
those; the operator's summary of what it traced (``trace.report``: the counts and totals of ``pcg.solve``,
``precond.solve`` and ``spmv.apply``) ends on standard error.  ``None`` without a card, or where no solve was counted
(a program without these counters)."""

from benchmark import harness, spans


def read(ctx):
    run = ctx.run
    if run.device.type != 'cuda' or not ctx.window.intervals:
        return None
    try:
        from pysdc_tpu_torch.utils import trace
    except ImportError:  # a program without counters
        return None
    n = spans._intervals(ctx)
    trace.enable(run.device)
    try:
        u0, _ = run.start_of(0)
        run.interval(u0)  # captures the block graph with its counters
        first = trace.record()
        untimed, before = set(first.marches()), dict(first.counters)
        for i in range(n):
            u0, _ = run.start_of(i)
            run.interval(u0)
        rec = trace.record()
    finally:
        trace.disable()
    solves, trips = (rec.counters.get(k, 0) - before.get(k, 0) for k in ('pcg.solves', 'pcg.trips'))
    seqs = set(rec.marches()) - untimed
    harness.log(trace.report(trace.Record([s for s in rec.spans if s.march in seqs],
                                          [s for s in rec.sites if s.march in seqs], rec.counters, rec.clock)))
    harness.log(f'pcg_trips_per_solve: {n} traced intervals, {solves} PCG solves, {trips} trips')
    return trips / solves if solves > 0 else None
