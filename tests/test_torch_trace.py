"""The spans of the fused lane (``pysdc_tpu_torch/utils/trace.py``) on the CPU, where a block runs eagerly and each
device span is the host clock around the same call.

One small two-level PFASST march of the periodic 2-D heat equation through ``lane='fused'``, traced and not: the
same ``uend`` and statistics bit for bit, the spans nested as the module says, the checks, trips and stencil applies
of each block counted, and the host reads unchanged.
"""

import functools

import numpy as np
import pytest
import torch

import pysdc_tpu_torch as pkg
from pysdc_tpu_torch.models.heat import HeatND
from pysdc_tpu_torch.ops import linalg
from pysdc_tpu_torch.ops.kernels import stencil
from pysdc_tpu_torch.parallel import fused
from pysdc_tpu_torch.utils import trace

P, DT, TEND = 4, 0.125, 1.0  # two blocks
PHASES = ('block.start', 'block.check', 'block.down', 'block.coarse', 'block.up', 'block.fine')
#: the sites a burn-in two-level block opens: a phase inside ``block``, the wavefront inside ``block.start``, the
#: stencil inside either
SITES = {('block',)} | {('block', p) for p in PHASES} | {('block', 'block.start', 'block.coarse')} | {
    ('block', p, 'stencil.apply') for p in PHASES if p != 'block.coarse'}


def _controller():
    desc = dict(problem_class=HeatND,
                problem_params=dict(nu=0.1, freq=2, nvars=[(32, 32), (16, 16)], bc='periodic', device='cpu'),
                sweeper_class=pkg.GenericImplicit, sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=[3, 2],
                                                                       QI='LU'),
                level_params=dict(restol=5e-10, dt=DT), step_params=dict(maxiter=50),
                space_transfer_params=dict(rorder=2, iorder=6, periodic=True))
    return pkg.ShardedController(P, {'logger_level': 40, 'predict_type': 'pfasst_burnin'}, desc)


@functools.lru_cache(maxsize=None)
def _runs():
    """The same march untraced, traced (counting the stencil's applies) and untraced again."""
    torch.set_num_threads(1)
    ctrl = _controller()
    u0 = ctrl.MS[0].levels[0].prob.u_exact(0.0)
    plain = ctrl.run(u0, 0.0, TEND, lane='fused')
    off_record = trace.record()
    applies = [0]
    stencil_plain = stencil._plain

    def counted(*args, **kwargs):
        applies[0] += 1
        return stencil_plain(*args, **kwargs)

    trace.enable('cpu')
    stencil._plain = counted
    try:
        traced = ctrl.run(u0, 0.0, TEND, lane='fused')
        host_reads = dict(ctrl.host_reads)
        rec = trace.record()
    finally:
        stencil._plain = stencil_plain
        trace.disable()
    again = ctrl.run(u0, 0.0, TEND, lane='fused')
    # the carry's own counts, block by block, from the untraced program
    checks = []
    u = u0
    for b in range(int(TEND / DT) // P):
        uend, _, _, n_checks, _ = ctrl._fused_fn(u, (b * P + np.arange(P)) * DT, DT, np.ones(P, dtype=bool))
        checks.append(int(n_checks))
        u = uend[-1]
    return dict(ctrl=ctrl, plain=plain, traced=traced, again=again, rec=rec, off=off_record, applies=applies[0],
                host_reads=host_reads, checks=checks, after=trace.record())


def test_trace_on_and_off_give_the_same_march():
    r = _runs()
    for other in (r['traced'], r['again']):
        assert torch.equal(other[0], r['plain'][0])
        assert other[1] == r['plain'][1]
    for rec in (r['off'], r['after']):
        assert rec.spans == [] and rec.sites == [] and rec.counters == {}
    assert not trace.enabled() and trace.key() is None


def test_host_reads_unchanged_with_tracing_on():
    assert _runs()['host_reads'] == {'cont': 0, 'fetch': 1}


def test_spans_nest_and_each_child_lies_inside_its_parent():
    rec = _runs()['rec']
    (march,) = [s for s in rec.spans if s.name == 'march']
    host = {s.name: s for s in rec.spans if s.where == 'host'}
    assert set(host) == {'march', 'march.enqueue', 'march.fetch', 'march.stats'}
    for name in ('march.enqueue', 'march.fetch', 'march.stats'):
        s = host[name]
        assert s.parent == 'march' and s.march == march.march
        assert march.start_ns <= s.start_ns <= s.end_ns <= march.end_ns
    assert host['march.enqueue'].end_ns <= host['march.fetch'].start_ns <= host['march.stats'].start_ns
    blocks = [s for s in rec.spans if s.name == 'block']
    assert [b.index for b in blocks] == [0, 1] and all(b.where == 'cpu' and b.parent == 'march' for b in blocks)
    enqueue = host['march.enqueue']
    for b in blocks:
        assert enqueue.start_ns <= b.enqueued_ns <= b.start_ns <= b.end_ns <= enqueue.end_ns
    assert blocks[0].end_ns <= blocks[1].enqueued_ns
    times = trace.phase_times(rec.sites)
    assert set(times) == SITES
    for path, (count, total, own) in times.items():
        if len(path) > 1:
            assert total <= times[path[:-1]][1] and 0 <= own <= total
    assert sum(s.total_ns for s in rec.sites if s.path == ('block',)) == sum(b.ns for b in blocks)


def test_each_block_counts_its_checks_trips_and_applies():
    """``block.check`` counts the carry's ``k``, ``block.fine`` the trips of the PFASST ``while`` (one a trip, after
    the first check), ``block.start`` one a block, and ``stencil.apply`` every apply the march makes."""
    r = _runs()
    times = trace.phase_times(r['rec'].sites)
    checks = r['checks']
    assert times[('block',)][0] == len(checks) == 2
    assert times[('block', 'block.check')][0] == sum(checks)
    for phase in ('block.down', 'block.coarse', 'block.up', 'block.fine'):
        assert times[('block', phase)][0] == sum(checks) - len(checks)
    assert times[('block', 'block.start')][0] == times[('block', 'block.start', 'block.coarse')][0] == len(checks)
    assert sum(n for path, (n, _, _) in times.items() if path[-1] == 'stencil.apply') == r['applies'] > 0


def test_phase_self_times_leave_the_layers_inside():
    times = trace.phase_times(_runs()['rec'].sites)
    start = times[('block', 'block.start')]
    assert start[2] == start[1] - times[('block', 'block.start', 'block.coarse')][1]
    fine = times[('block', 'block.fine')]
    assert fine[2] == fine[1]  # its stencil applies stay in its self time
    block = times[('block',)]
    assert block[2] == block[1] - sum(times[('block', p)][1] for p in PHASES)


def test_report_names_every_site_and_host_span():
    text = trace.report(_runs()['rec'])
    for name in PHASES + ('stencil.apply', 'march.enqueue', 'march.fetch', 'march.stats', 'device gap'):
        assert name in text
    assert text.startswith('trace: 1 marches')


def test_enabling_recaptures_and_disabling_returns_to_the_untraced_program():
    ctrl = _runs()['ctrl']
    keys = [k[-1] for k in ctrl._fused_fn._programs]
    assert keys.count(None) == 1 and len(keys) == 2  # the untraced program and the one traced under enable()
    u0 = ctrl.MS[0].levels[0].prob.u_exact(0.0)
    trace.enable('cpu')
    try:
        ctrl.run(u0, 0.0, P * DT, lane='fused')
        keys = [k[-1] for k in ctrl._fused_fn._programs]
        assert keys == [None, trace.key()]  # the earlier enable()'s program is gone
    finally:
        trace.disable()


def test_linalg_solve_is_a_device_span_inside_a_march():
    A = torch.eye(3, dtype=torch.float64) * 2 + 0.1
    b = torch.ones((3, 1), dtype=torch.float64)
    trace.enable('cpu')
    try:
        linalg.solve(A, b)  # outside a march: nothing kept on the CPU
        with trace.march():
            x = linalg.solve(A, b)
        rec = trace.record()
    finally:
        trace.disable()
    torch.testing.assert_close(A @ x, b, rtol=0, atol=1e-14)
    assert [(s.path, s.count) for s in rec.sites] == [(('linalg.solve',), 1)]
    assert [s.name for s in rec.spans] == ['march']


@pytest.mark.parametrize('dtypes', [(torch.int32, torch.float32, torch.bool, torch.int64),
                                    (torch.int32, torch.float64, torch.bool)])
def test_one_fetch_brings_every_part_home(dtypes):
    parts = [(torch.arange(7) * 3 - 5).to(d).reshape(7, 1) if d is not torch.bool else torch.arange(3) % 2 == 0
             for d in dtypes]
    got = fused._fetch(parts)
    for want, have in zip(parts, got):
        assert have.shape == tuple(want.shape) and np.array_equal(have, want.numpy())
