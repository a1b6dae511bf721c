"""``dense_factor_reuse_share``: the share of the sweeps' node solves (``ops/spectral.py``'s ``solve_shifted`` with a
node) that the node's kept LU served without making it again, ``100 (1 - refreshes / slot solves)``, from the
program's counters ``spectral.refreshes`` and ``spectral.slot_solves`` (``utils/trace.py``).  It traces on its own
after the harness's other readers: one untimed interval (the block graph captured again, with the counters), then as
many intervals as ``benchmark/spans.py`` traces, and the counters' change over those.  ``None`` without a card, or
where no solve named its node (a program that keeps no LU)."""

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
        before = dict(trace.record().counters)
        for i in range(n):
            u0, _ = run.start_of(i)
            run.interval(u0)
        after = dict(trace.record().counters)
    finally:
        trace.disable()
    solves, refreshes = (after.get(k, 0) - before.get(k, 0) for k in ('spectral.slot_solves', 'spectral.refreshes'))
    harness.log(f'dense_factor_reuse_share: {n} traced intervals, {solves} slot solves, {refreshes} refreshes')
    return 100.0 * (1.0 - refreshes / solves) if solves > 0 else None
