"""The circuit problems on the fused lane: the port against its stage lane and against the JAX package's fused lane.

``Piline`` and ``BuckConverter`` (float64, IMEX M=3 RADAU-RIGHT, ``QI='LU'``, ``QE='EE'``, dt 0.05, two blocks of 4
steps) through ``ShardedController(4).run``: ``'auto'`` takes the fused lane, whose implicit solves are the dense
solves of :func:`pysdc_tpu_torch.ops.linalg.solve` (a CUDA graph holds them: no error flag read on the host).  It is
held against ``lane='stage'`` of the same controller and against the JAX package's ``ShardedController(4).run(
lane='fused')`` on the same description: ``niter`` equal, ``uend`` to 1e-12 (the solves' rounding apart).

The buck converter switches at ``k / fsw`` and ``(k + duty) / fsw``.  At ``fsw = 10`` with dt 0.05 the RADAU-RIGHT
end nodes land on those instants, where the rounding of a node time decides the regime: the two lanes of either
package form their node times differently and part there (both packages alike).  ``fsw = 7`` keeps every node time
off the switching instants.

One JAX run per problem is shared through ``functools.lru_cache``; the port's CPU runs use one thread.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import pysdc_tpu
import pysdc_tpu_torch
from pysdc_tpu.models import power_electronics as jax_circuits
from pysdc_tpu_torch.models import power_electronics as circuits
from pysdc_tpu_torch.utils.convert import to_numpy

torch.set_num_threads(1)

UEND_TOL = 1e-12  # float64, absolute; the fields are of size <= 10 (volts and amperes)
PROBLEMS = {'Piline': {}, 'BuckConverter': dict(fsw=7.0)}


def _description(pkg, cls, params):
    return dict(problem_class=cls, problem_params=params, sweeper_class=pkg.IMEXSweeper,
                sweeper_params=dict(num_nodes=3, quad_type='RADAU-RIGHT', QI='LU', QE='EE'),
                level_params=dict(dt=0.05, restol=1e-10), step_params=dict(maxiter=20))


def _summary(pkg, uend, stats):
    return dict(uend=np.asarray(to_numpy(uend)), lane=[v for k, v in stats.items() if k.type == 'lane'],
                niter=[v for _, v in pkg.get_sorted(stats, type='niter', sortby='time')])


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    desc = _description(pysdc_tpu, getattr(jax_circuits, name), dict(PROBLEMS[name]))
    ctrl = pysdc_tpu.ShardedController(4, {'logger_level': 40}, desc)
    uend, stats = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, 0.4, lane='fused')
    return _summary(pysdc_tpu, uend, stats)


@functools.lru_cache(maxsize=None)
def _torch_runs(name):
    """The port's ``'auto'`` and ``'stage'`` runs of one controller."""
    desc = _description(pysdc_tpu_torch, getattr(circuits, name), dict(PROBLEMS[name], device='cpu'))
    ctrl = pysdc_tpu_torch.ShardedController(4, {'logger_level': 40}, desc)
    u0 = ctrl.MS[0].levels[0].prob.u_exact(0.0)
    auto = _summary(pysdc_tpu_torch, *ctrl.run(u0, 0.0, 0.4))
    return auto, _summary(pysdc_tpu_torch, *ctrl.run(u0, 0.0, 0.4, lane='stage')), ctrl


@pytest.mark.parametrize('name', list(PROBLEMS))
def test_auto_takes_the_fused_lane(name):
    auto, stage, ctrl = _torch_runs(name)
    assert auto['lane'] == ['fused'] and stage['lane'] == ['stage']
    assert ctrl.MS[0].levels[0].prob.graph_capture_blocker is None
    assert len(auto['niter']) == 8 and max(auto['niter']) < 20


@pytest.mark.parametrize('name', list(PROBLEMS))
def test_fused_lane_matches_the_stage_lane(name):
    auto, stage, _ = _torch_runs(name)
    assert auto['niter'] == stage['niter']
    np.testing.assert_allclose(auto['uend'], stage['uend'], rtol=0, atol=UEND_TOL)


@pytest.mark.parametrize('name', list(PROBLEMS))
def test_fused_lane_matches_the_jax_fused_lane(name):
    (auto, _, _), want = _torch_runs(name), _jax_run(name)
    assert want['lane'] == ['fused']
    assert auto['niter'] == want['niter']
    np.testing.assert_allclose(auto['uend'], want['uend'], rtol=0, atol=UEND_TOL)
