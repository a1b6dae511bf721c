"""The sparse lane's spans and counters (``ops/sparse_op.py``, ``utils/trace.py``) on the CPU, where a block runs
eagerly and each device span is the host clock around the same call.

A ``VarCoeffDiffusion2D`` march at 32^2 float64 through ``ShardedController(4)`` on the fused lane, traced and not:
the same ``uend`` bit for bit; ``spmv.apply`` once an operator SpMV, ``pcg.trips`` once a PCG iteration computed,
``pcg.solves`` once a ``_pcg`` call, every ``precond.solve`` inside a ``pcg.solve``; and one traced fused block's
counts equal to the stage lane's for the same block.
"""

import functools

import numpy as np
import pytest
import torch

import pysdc_tpu_torch as pkg
from pysdc_tpu_torch.models.var_diffusion import VarCoeffDiffusion2D
from pysdc_tpu_torch.ops import sparse_op
from pysdc_tpu_torch.utils import trace

P, DT = 4, 1e-3
TEND = 2 * P * DT  # two blocks


def _coeff(x, y):
    return 0.1 * (1.0 + 0.5 * np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y))


def _controller():
    desc = dict(problem_class=VarCoeffDiffusion2D,
                problem_params=dict(nvars=(32, 32), coeff_fn=_coeff, dtype=torch.float64, solver='pcg', device='cpu'),
                sweeper_class=pkg.GenericImplicit,
                sweeper_params=dict(num_nodes=4, quad_type='RADAU-RIGHT', QI='LU'),
                level_params=dict(restol=1e-10, dt=DT), step_params=dict(maxiter=8))
    return pkg.ShardedController(P, {'logger_level': 40}, desc)


def _u0(prob):
    X, Y = prob.grids
    return torch.sin(np.pi * X) * torch.sin(np.pi * Y) + 0.3 * torch.cos(5 * np.pi * X) * torch.sin(3 * np.pi * Y)


class _Counted:
    """The operator's counters and the ``_pcg`` calls over a ``with`` block."""

    def __init__(self, op, monkeypatch):
        self.op, self.all_calls = op, 0
        pcg = sparse_op.SparseOperator._pcg

        def counted(this, *args, **kwargs):
            self.all_calls += 1
            return pcg(this, *args, **kwargs)

        monkeypatch.setattr(sparse_op.SparseOperator, '_pcg', counted)

    def __enter__(self):
        self.spmv, self.steps, self.calls = self.op.spmv_count, self.op.pcg_steps, self.all_calls
        return self

    def __exit__(self, *exc):
        self.spmv, self.steps = self.op.spmv_count - self.spmv, self.op.pcg_steps - self.steps
        self.calls = self.all_calls - self.calls


@functools.lru_cache(maxsize=None)
def _runs():
    """The same march untraced and traced (with the operator's counts over the traced one)."""
    torch.set_num_threads(1)
    ctrl = _controller()
    prob = ctrl.MS[0].levels[0].prob
    u0 = _u0(prob)
    plain = ctrl.run(u0, 0.0, TEND, lane='fused')
    with pytest.MonkeyPatch.context() as mp:
        counted = _Counted(prob.A, mp)
        trace.enable('cpu')
        try:
            with counted:
                traced = ctrl.run(u0, 0.0, TEND, lane='fused')
            rec = trace.record()
        finally:
            trace.disable()
    return dict(plain=plain, traced=traced, rec=rec, counted=counted, after=ctrl.run(u0, 0.0, TEND, lane='fused'))


def _by_name(rec):
    out = {}
    for s in rec.sites:
        out[s.name] = out.get(s.name, 0) + s.count
    return out


def test_sparse_march_is_the_same_traced_and_not():
    r = _runs()
    for other in (r['traced'], r['after']):
        assert torch.equal(other[0], r['plain'][0])
        assert other[1] == r['plain'][1]
    assert not trace.enabled()


def test_spans_and_counters_equal_the_operators_counts():
    r = _runs()
    names, counted, counters = _by_name(r['rec']), r['counted'], r['rec'].counters
    assert names['spmv.apply'] == counted.spmv > 0
    assert counters['pcg.trips'] == names['precond.solve'] == counted.steps > 0
    assert counters['pcg.solves'] == names['pcg.solve'] == counted.calls > 0


def test_precond_solves_lie_inside_pcg_solves_inside_the_block():
    rec = _runs()['rec']
    paths = [s.path for s in rec.sites]
    assert all(p[0] == 'block' for p in paths)
    assert all('pcg.solve' in p[:-1] for p in paths if p[-1] == 'precond.solve')
    assert any(p[-1] == 'spmv.apply' and 'pcg.solve' in p for p in paths)  # r0 and each trip's A p
    assert len(set(paths)) <= trace.TABLE_ROWS
    times = trace.phase_times(rec.sites)
    for path, (_, total, own) in times.items():
        if path[-1] in ('pcg.solve', 'block.fine'):
            assert own == total  # the layers inside keep their time in it


def test_one_traced_fused_block_counts_what_the_stage_lane_computes(monkeypatch):
    """For one block from the same ``u0``: the traced fused block's spans and tallies against the stage lane's
    ``spmv_count``, ``pcg_steps`` and ``_pcg`` calls."""
    torch.set_num_threads(1)
    fused_ctrl, stage_ctrl = _controller(), _controller()
    u0 = _u0(fused_ctrl.MS[0].levels[0].prob)
    fused_ctrl.run(u0, 0.0, P * DT, lane='fused')  # the program made before the traced block
    counted = _Counted(stage_ctrl.MS[0].levels[0].prob.A, monkeypatch)
    with counted:
        stage = stage_ctrl.run(u0, 0.0, P * DT, lane='stage')
    trace.enable('cpu')
    try:
        fused = fused_ctrl.run(u0, 0.0, P * DT, lane='fused')
        rec = trace.record()
    finally:
        trace.disable()
    assert [v for _, v in pkg.get_sorted(fused[1], type='niter')] == [v for _, v in
                                                                      pkg.get_sorted(stage[1], type='niter')]
    names = _by_name(rec)
    assert names['block'] == 1
    assert names['spmv.apply'] == counted.spmv
    assert rec.counters['pcg.trips'] == counted.steps
    assert rec.counters['pcg.solves'] == counted.calls
