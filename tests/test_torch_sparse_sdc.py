"""The sparse lane as a whole: SDC through ``ControllerNonMPI`` in both
packages (float64, CPU), on each solver lane of the sparse stack.

For each case the per-step ``niter`` lists are equal and ``uend`` agrees to
1e-10.  Both packages start from the same numpy ``u0``.  The port's work
counters show that ``eval_f`` over the M spread nodes is one batched apply.
The direct solvers (``'banded'``, ``'block_tridiag'``) also run through
``ShardedController(4)``'s fused lane, with its device ``dt``, against the JAX
package's fused lane.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysdc_tpu
import pysdc_tpu_torch
from pysdc_tpu.models.heat import HeatND as JaxHeat
from pysdc_tpu.models.var_diffusion import VarCoeffDiffusion1D as JaxVC1, VarCoeffDiffusion2D as JaxVC2
from pysdc_tpu_torch.models.heat import HeatND as TorchHeat
from pysdc_tpu_torch.models.var_diffusion import VarCoeffDiffusion1D as TorchVC1, VarCoeffDiffusion2D as TorchVC2


def _coeff_2d(X, Y):
    return 0.1 * (1.0 + 0.5 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y))


def _coeff_1d(x):
    return 1.0 + 0.8 * np.sin(2 * np.pi * x)


def _sin_2d(n):
    x = np.arange(1, n + 1) / (n + 1)
    return np.sin(np.pi * x)[:, None] * np.sin(np.pi * x)[None, :]


# name: (JAX class, port class, problem_params, u0 or None for u_exact(0), dt, Tend, solver kind)
CASES = {
    'vc2d-32-pcg': (JaxVC2, TorchVC2, dict(nvars=(32, 32), coeff_fn=_coeff_2d), _sin_2d(32), 1e-3, 4e-3, 'pcg'),
    'vc2d-24-block-tridiag': (JaxVC2, TorchVC2, dict(nvars=(24, 24), coeff_fn=_coeff_2d, solver='block_tridiag'),
                              _sin_2d(24), 1e-3, 4e-3, 'block_tridiag'),
    'heat-63-dirichlet-banded': (JaxHeat, TorchHeat, dict(nvars=63, nu=0.1, freq=2, bc='dirichlet-zero',
                                                          backend='sparse'), None, 0.05, 0.2, 'banded'),
    'heat-32x32-periodic-pcg': (JaxHeat, TorchHeat, dict(nvars=(32, 32), nu=0.1, freq=2, bc='periodic',
                                                         backend='sparse'), None, 0.05, 0.2, 'pcg'),
    'vc1d-64-periodic-cyclic': (JaxVC1, TorchVC1, dict(nvars=64, coeff_fn=_coeff_1d, bc='periodic'),
                                np.sin(2 * np.pi * np.arange(64) / 64), 0.01, 0.04, 'cyclic_tridiag'),
}
M = 3


def _description(pkg, cls, params, dt):
    return dict(
        problem_class=cls,
        problem_params=params,
        sweeper_class=pkg.GenericImplicit,
        sweeper_params=dict(num_nodes=M, quad_type='RADAU-RIGHT', QI='LU'),
        level_params=dict(dt=dt, restol=1e-10),
        step_params=dict(maxiter=30),
    )


@functools.lru_cache(maxsize=None)
def _run(package, case):
    jcls, tcls, params, u0, dt, Tend, _ = CASES[case]
    if u0 is None:
        u0 = np.asarray(jcls(**params).u_exact(0.0))
    if package == 'jax':
        pkg, desc, u0 = pysdc_tpu, _description(pysdc_tpu, jcls, dict(params), dt), jnp.asarray(u0)
    else:
        pkg, desc = pysdc_tpu_torch, _description(pysdc_tpu_torch, tcls, dict(params, device='cpu'), dt)
        u0 = torch.tensor(u0)
    ctrl = pkg.ControllerNonMPI(1, {'logger_level': 40}, desc)
    prob = ctrl.MS[0].levels[0].prob
    uend, stats = ctrl.run(u0, 0.0, Tend)
    niter = [v for _, v in pkg.get_sorted(stats, type='niter', sortby='time')]
    uend = uend.numpy() if isinstance(uend, torch.Tensor) else np.asarray(uend)
    return uend, niter, prob


@pytest.mark.parametrize('case', list(CASES))
def test_sparse_sdc_matches_jax(case):
    want_u, want_niter, jprob = _run('jax', case)
    got_u, got_niter, tprob = _run('torch', case)
    kind = CASES[case][-1]
    assert jprob.A.solver_kind == tprob.A.solver_kind == kind
    assert tprob.accepts_node_index == jprob.accepts_node_index == (kind == 'block_tridiag')
    assert got_niter == want_niter and len(got_niter) > 0
    np.testing.assert_allclose(got_u, want_u, rtol=0, atol=1e-10)
    # the work of a sweep, counted as the JAX package counts it: M evaluations per sweep
    assert tprob.work_counters['rhs'].niter == sum(M * k for k in got_niter)


def test_spmv_count_covers_eval_f_and_pcg():
    """On the PCG lane every SpMV goes through the operator's counter: per
    step u0 and the batched spread (2), per sweep M eval_f plus, per solve,
    one warm-start residual and one matvec per PCG iteration computed (the
    masked loop computes up to READ_EVERY - 1 past the stop, unread)."""
    from pysdc_tpu_torch.ops.loops import READ_EVERY

    _, niter, prob = _run('torch', 'vc2d-32-pcg')
    A = prob.A
    n_solves = M * sum(niter)
    assert A.pcg_solves == n_solves
    assert A.pcg_iterations <= A.pcg_steps <= A.pcg_iterations + n_solves * (READ_EVERY - 1)
    assert A.spmv_count == sum(2 + M * k for k in niter) + n_solves + A.pcg_steps


@functools.lru_cache(maxsize=None)
def _block_run(package, case):
    """``ShardedController(4).run`` over the case's horizon, ``'auto'`` lane: ``(uend, niter, lanes, ctrl)``."""
    jcls, tcls, params, u0, dt, Tend, _ = CASES[case]
    if u0 is None:
        u0 = np.asarray(jcls(**params).u_exact(0.0))
    if package == 'jax':
        pkg, desc, u0 = pysdc_tpu, _description(pysdc_tpu, jcls, dict(params), dt), jnp.asarray(u0)
    else:
        pkg, desc = pysdc_tpu_torch, _description(pysdc_tpu_torch, tcls, dict(params, device='cpu'), dt)
        u0 = torch.tensor(u0)
    ctrl = pkg.ShardedController(4, {'logger_level': 40}, desc)
    uend, stats = ctrl.run(u0, 0.0, Tend)
    uend = uend.numpy() if isinstance(uend, torch.Tensor) else np.asarray(uend)
    return (uend, [v for _, v in pkg.get_sorted(stats, type='niter', sortby='time')],
            [v for k, v in stats.items() if k.type == 'lane'], ctrl)


@pytest.mark.parametrize('case', ['heat-63-dirichlet-banded', 'vc2d-24-block-tridiag'])
def test_direct_solves_on_the_fused_lane_match_jax(case):
    """The direct sparse solves with the fused lane's device ``dt``: ``'auto'`` takes the fused lane in both
    packages, equal ``niter``, ``uend`` to 1e-12, and the port's march reads nothing on the host but its fetch."""
    want_u, want_niter, want_lanes, _ = _block_run('jax', case)
    got_u, got_niter, lanes, ctrl = _block_run('torch', case)
    assert lanes == want_lanes == ['fused'] and ctrl.MS[0].levels[0].prob.A.solver_kind == CASES[case][-1]
    assert got_niter == want_niter and len(got_niter) == 4 and max(got_niter) < 30
    np.testing.assert_allclose(got_u, want_u, rtol=0, atol=1e-12)
    assert ctrl.host_reads == {'cont': 0, 'fetch': 1}
