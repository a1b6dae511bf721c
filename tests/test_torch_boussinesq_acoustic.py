"""The 2D Boussinesq and the 1D acoustic-advection problems of the PyTorch port against the JAX package (float64,
CPU).

``first_derivative_matrix`` and ``upwind_taps`` equal to the JAX package's; ``eval_f`` and the exact shifted solve
on seeded fields (a float and a device-tensor factor); each problem through ``ControllerNonMPI`` with
``IMEXSweeper`` against a live JAX run (equal ``niter``, ``uend`` to 1e-11 relative), the acoustic one against its
exact solution as its JAX test holds it.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysdc_tpu
import pysdc_tpu.models.acoustic as jac
import pysdc_tpu.models.boussinesq as jbo
import pysdc_tpu_torch
from pysdc_tpu_torch.models.acoustic import AcousticAdvection1D
from pysdc_tpu_torch.models.boussinesq import Boussinesq2DIMEX, first_derivative_matrix, upwind_taps
from pysdc_tpu_torch.utils.convert import to_numpy
from test_torch_solvers import close

torch.set_num_threads(1)


@pytest.mark.parametrize('bc', ['periodic', 'neumann', 'dirichlet'])
@pytest.mark.parametrize('order', [2, 4])
def test_derivative_tables_match_jax(bc, order):
    np.testing.assert_array_equal(first_derivative_matrix(12, 0.3, bc, order),
                                  jbo.first_derivative_matrix(12, 0.3, bc, order))
    for upw in range(1, 6):
        assert upwind_taps(upw) == jbo.upwind_taps(upw)


PROBLEMS = {
    'boussinesq': (jbo.Boussinesq2DIMEX, Boussinesq2DIMEX, dict(nvars=(60, 10)), (4, 60, 10)),
    'acoustic': (jac.AcousticAdvection1D, AcousticAdvection1D, dict(nvars=64, cs=1.0, cadv=0.1), (2, 64)),
}


@pytest.mark.parametrize('name', list(PROBLEMS))
def test_operators_match_jax(name):
    J, T, params, shape = PROBLEMS[name]
    jprob, tprob = J(**params), T(device='cpu', **params)
    close(tprob.u_exact(0.0), jprob.u_exact(0.0), rtol=1e-14)
    q = np.random.default_rng(5).standard_normal(shape)
    tq, jq = torch.as_tensor(q), jnp.asarray(q)
    for got, want in zip(tprob.eval_f(tq, 0.0), jprob.eval_f(jq, 0.0)):
        close(got, want, rtol=1e-13)
    for factor in (0.7, torch.tensor(0.7, dtype=torch.float64)):
        close(tprob.solve_system(tq, factor, tq, 0.0), jprob.solve_system(jq, 0.7, jq, 0.0), rtol=1e-13)
    # leading batch axes ride along
    stack = torch.stack([tq, -tq])
    batch = tprob.eval_f(stack, 0.0)
    close(batch.impl[1], -to_numpy(tprob.eval_f(tq, 0.0).impl), rtol=1e-15)
    close(tprob.solve_system(stack, 0.7, stack, 0.0)[1], -to_numpy(tprob.solve_system(tq, 0.7, tq, 0.0)), rtol=1e-15)


RUNS = {
    # tests/test_quench_boussinesq.py:107 at (60, 10); tests/test_more_components.py:131 at 128 points
    'boussinesq': (dict(nvars=(60, 10)), 1.0, 3, 1e-11, 15),
    'acoustic': (dict(nvars=128, cs=1.0, cadv=0.1, waveno=5), 1 / 256, 4, 1e-11, 20),
}


@functools.lru_cache(maxsize=None)
def _run(package, name):
    params, dt, steps, restol, maxiter = RUNS[name]
    J, T = PROBLEMS[name][:2]
    pkg = pysdc_tpu if package == 'jax' else pysdc_tpu_torch
    problem, params = (J, params) if package == 'jax' else (T, dict(params, device='cpu'))
    desc = dict(problem_class=problem, problem_params=params, sweeper_class=pkg.IMEXSweeper,
                sweeper_params=dict(num_nodes=3, QI='LU'), level_params=dict(dt=dt, restol=restol),
                step_params=dict(maxiter=maxiter))
    ctrl = pkg.ControllerNonMPI(1, {'logger_level': 40}, desc)
    prob = ctrl.MS[0].levels[0].prob
    uend, stats = ctrl.run(prob.u_exact(0.0), 0.0, steps * dt)
    return np.asarray(to_numpy(uend)), [v for _, v in pkg.get_sorted(stats, type='niter')], prob


@pytest.mark.parametrize('name', list(RUNS))
def test_run_matches_live_jax(name):
    want, want_niter, _ = _run('jax', name)
    got, niter, prob = _run('torch', name)
    assert niter == want_niter and max(niter) < RUNS[name][4]
    close(got, want)
    if name == 'acoustic':
        _, dt, steps, _, _ = RUNS[name]
        assert np.abs(got - to_numpy(prob.u_exact(steps * dt))).max() < 5e-5  # tests/test_more_components.py:151
