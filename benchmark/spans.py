"""The program's own spans (``pysdc_tpu_torch/utils/trace.py``) over a few traced intervals, read by the per-layer
metrics of ``source: program_span`` (``metrics/<name>.py``).

The first such reader traces, once a run, after the harness's own readers: it enables tracing, runs one untimed
interval (the block graph is captured again, with its stamps), then as many traced intervals as the harness
profiles (``_profile``'s rule: about a second of intervals, 3 to 10), and disables tracing.  The readings are kept
on ``ctx``; each reader takes its own.  A march's own time on the host is its ``march`` span less its
``march.fetch``; the card's time of a block is its ``block`` span, on the host clock; a layer's share of a block
is the total of its device spans over the total of ``block``.  Without a card, or with a program that has no
tracing module, the readings are ``None``.  The operator's summary (``trace.report``) and what checks the spans
against the program's counters end standard error.
"""

from __future__ import annotations

from types import SimpleNamespace

from benchmark import harness


def _intervals(ctx) -> int:
    hosts = sorted(iv.host_s for iv in ctx.window.intervals)
    return int(min(10, max(3, round(1.0 / hosts[len(hosts) // 2])))) if hosts else 3


def _union(spans, lo: int, hi: int) -> int:
    """Nanoseconds of ``[lo, hi]`` that the ``(start, end)`` pairs cover."""
    covered, at = 0, lo
    for a, b in sorted(spans):
        a, b = max(a, at), min(b, hi)
        if b > a:
            covered += b - a
            at = b
    return covered


def readings(ctx):
    """The spans' readings over the traced intervals (a namespace, kept on ``ctx``), or ``None``."""
    if 'spans' not in vars(ctx):
        ctx.spans = None
        if ctx.run.device.type == 'cuda' and ctx.window.intervals:
            try:
                from pysdc_tpu_torch.utils import trace
            except ImportError:  # a program without spans
                return None
            ctx.spans = measure(ctx, trace)
    return ctx.spans


def measure(ctx, trace) -> SimpleNamespace:
    """Trace a few intervals of ``ctx.run`` on its device and read the spans (the CPU tests call it directly)."""
    run = ctx.run
    n = _intervals(ctx)
    trace.enable(run.device)
    try:
        u0, _ = run.start_of(0)
        run.interval(u0)  # captures the block graph with its stamps
        first = trace.record()
        untimed, captures = set(first.marches()), first.counters.get('fused.captures', 0)
        counted = {k: int(c.item()) for k, c in run.counters.items()}
        checks = 0
        for i in range(n):
            u0, _ = run.start_of(i)
            _, _, niters, _ = run.interval(u0)
            checks += sum(max(block) + 1 for block in niters)
        counted = {k: int(c.item()) - counted[k] for k, c in run.counters.items()}
        rec = trace.record()
    finally:
        trace.disable()
    marches = [s for s in rec.spans if s.name == 'march' and s.march not in untimed]
    seqs = {s.march for s in marches}
    host = [s for s in rec.spans if s.march in seqs]
    blocks = [s for s in host if s.name == 'block']
    sites = [s for s in rec.sites if s.march in seqs]
    times = trace.phase_times(sites)
    by_name = {}
    for path, (count, total, _) in times.items():
        acc = by_name.setdefault(path[-1], [0, 0])
        acc[0] += count
        acc[1] += total
    block_ns = by_name.get('block', [0, 0])[1]

    def share(name):
        return 100.0 * by_name[name][1] / block_ns if name in by_name and block_ns else None

    fetch = {s.march: s.ns for s in host if s.name == 'march.fetch'}
    idle = sum(m.ns - _union([(b.start_ns, b.end_ns) for b in blocks if b.march == m.march], m.start_ns, m.end_ns)
               for m in marches)
    phases = sum(own for path, (_, _, own) in times.items()
                 if len(path) > 1 and path[0] == 'block' and path[-1] not in trace.LAYER_SPANS)
    out = SimpleNamespace(
        march_host_ms=(None if rec.counters.get('fused.captures', 0) != captures
                       else sum(m.ns - fetch.get(m.march, 0) for m in marches) / len(marches) / 1e6),
        device_idle_share=100.0 * idle / sum(m.ns for m in marches),
        block_device_ms=sum(b.ns for b in blocks) / len(blocks) / 1e6 if blocks else None,
        coarse_chain_share=share('block.coarse'),
        stencil_block_share=share('stencil.apply'),
        dense_solve_block_share=share('linalg.solve'),
    )
    # the spans against the program's own counts and the march's clock
    slack = rec.clock.uncertainty_ns if rec.clock is not None else 0
    ends = {s.march: s.end_ns for s in host if s.name == 'march.fetch'}
    late = sum(1 for b in blocks if b.start_ns < b.enqueued_ns - slack or b.end_ns > ends[b.march] + slack)
    harness.log(trace.report(trace.Record(host, sites, rec.counters, rec.clock)))
    harness.log(f'spans: {len(marches)} traced intervals; block.check {by_name.get("block.check", [0])[0]}, checks '
                f'by the iteration counts {checks}; stencil.apply {by_name.get("stencil.apply", [0])[0]}, linalg.solve '
                f'{by_name.get("linalg.solve", [0])[0]}, counted on the card {counted}; phases\' self times '
                f'{100.0 * phases / block_ns if block_ns else float("nan"):.3f}% of block; blocks outside their '
                f'replay\'s enqueue and their march\'s fetch: {late} of {len(blocks)} (uncertainty {slack} ns)')
    out.checks = dict(block_check=by_name.get('block.check', [0])[0], checks=checks, counted=counted,
                      stencil_apply=by_name.get('stencil.apply', [0])[0], solves=by_name.get('linalg.solve', [0])[0],
                      phases_share=100.0 * phases / block_ns if block_ns else None, late=late, blocks=len(blocks))
    return out
