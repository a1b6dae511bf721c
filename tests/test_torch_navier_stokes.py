"""The 2D vorticity Navier-Stokes problem of the PyTorch port against the JAX package (float64, CPU).

``eval_f``, the shifted solve and the diagnostics on a seeded field; Taylor-Green (exact: the advection vanishes)
and the random-mode flow through ``ControllerNonMPI`` with ``IMEXSweeper`` against live JAX runs (equal ``niter``,
``uend`` to 1e-11 relative) and Taylor-Green against ``u_exact`` within the JAX test's 1e-9; one IMEX block through
the block controller's lanes against the port's step-by-step run.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysdc_tpu
import pysdc_tpu.models.navier_stokes as jns
import pysdc_tpu_torch
from pysdc_tpu_torch.models.navier_stokes import NavierStokesVorticity2D
from pysdc_tpu_torch.utils.convert import to_numpy
from test_torch_solvers import close

torch.set_num_threads(1)


def test_operators_and_diagnostics_match_jax():
    jprob = jns.NavierStokesVorticity2D(nvars=(24, 32), nu=5e-3)
    tprob = NavierStokesVorticity2D(nvars=(24, 32), nu=5e-3, device='cpu')
    w = np.asarray(jprob.u_exact(0.0, kind='random')) + 0.1 * np.random.default_rng(2).standard_normal((24, 32))
    tw, jw = torch.as_tensor(w), jnp.asarray(w)
    for got, want in zip(tprob.eval_f(tw, 0.0), jprob.eval_f(jw, 0.0)):
        assert got.dtype == torch.float64
        close(got, want)
    for factor in (0.02, torch.tensor(0.02, dtype=torch.float64)):
        close(tprob.solve_system(tw, factor, tw, 0.0), jprob.solve_system(jw, 0.02, jw, 0.0))
    stack = torch.stack([tw, 2 * tw])
    got = tprob.solve_system_batched(stack, np.array([0.01, 0.04]), stack, np.zeros(2))
    for m, factor in enumerate((0.01, 0.04)):
        close(got[m], jprob.solve_system(jnp.asarray(to_numpy(stack[m])), factor, None, 0.0))
    for got, want in zip(tprob.velocity(tw), jprob.velocity(jw)):
        close(got, want)
    assert abs(tprob.kinetic_energy(tw) - jprob.kinetic_energy(jw)) <= 1e-12 * jprob.kinetic_energy(jw)
    assert abs(tprob.enstrophy(tw) - jprob.enstrophy(jw)) <= 1e-12 * jprob.enstrophy(jw)
    assert tprob.divergence(tw) < 1e-10
    k, E = tprob.energy_spectrum(tw)
    kj, Ej = jprob.energy_spectrum(jw)
    assert np.array_equal(k, kj)
    np.testing.assert_allclose(E, Ej, rtol=0, atol=1e-12 * Ej.max())
    for kind in ('taylor_green', 'random'):
        close(tprob.u_exact(0.0, kind=kind), jprob.u_exact(0.0, kind=kind), rtol=1e-14)
    close(tprob.u_exact(0.3), jprob.u_exact(0.3), rtol=1e-14)


CASES = {'taylor-green': (dict(nvars=(32, 32), nu=1e-2), 0.05, 3, 'taylor_green'),
         'random': (dict(nvars=(32, 32), nu=5e-3), 0.02, 3, 'random')}


def _description(package, name, restol=1e-11):
    params, dt, _, _ = CASES[name]
    pkg = pysdc_tpu if package == 'jax' else pysdc_tpu_torch
    problem = jns.NavierStokesVorticity2D if package == 'jax' else NavierStokesVorticity2D
    if package == 'torch':
        params = dict(params, device='cpu')
    return pkg, dict(problem_class=problem, problem_params=dict(params), sweeper_class=pkg.IMEXSweeper,
                     sweeper_params=dict(num_nodes=3, QI='LU', QE='EE'), level_params=dict(dt=dt, restol=restol),
                     step_params=dict(maxiter=30))


@functools.lru_cache(maxsize=None)
def _run(package, name):
    pkg, desc = _description(package, name)
    ctrl = pkg.ControllerNonMPI(1, {'logger_level': 40}, desc)
    prob = ctrl.MS[0].levels[0].prob
    _, dt, steps, kind = CASES[name]
    uend, stats = ctrl.run(prob.u_exact(0.0, kind=kind), 0.0, steps * dt)
    return np.asarray(to_numpy(uend)), [v for _, v in pkg.get_sorted(stats, type='niter')], prob


@pytest.mark.parametrize('name', list(CASES))
def test_run_matches_live_jax(name):
    want, want_niter, _ = _run('jax', name)
    got, niter, prob = _run('torch', name)
    assert niter == want_niter and max(niter) < 30
    close(got, want)
    if name == 'taylor-green':
        _, dt, steps, _ = CASES[name]
        assert np.abs(got - to_numpy(prob.u_exact(steps * dt))).max() < 1e-9  # tests/test_navier_stokes.py:35-40


@pytest.mark.parametrize('lane', ['stage', 'fused'])
def test_block_lanes_match_the_steps(lane):
    _, desc = _description('torch', 'random', restol=1e-9)
    desc['problem_params']['nvars'] = (16, 16)
    serial = pysdc_tpu_torch.ControllerNonMPI(4, {'logger_level': 40}, desc)
    u0 = serial.MS[0].levels[0].prob.u_exact(0.0, kind='random')
    want, want_stats = serial.run(u0, 0.0, 0.08)
    block = pysdc_tpu_torch.ShardedController(4, {'logger_level': 40}, desc)
    got, stats = block.run(u0, 0.0, 0.08, lane=lane)
    niter = [v for _, v in pysdc_tpu_torch.get_sorted(stats, type='niter')]
    assert niter == [v for _, v in pysdc_tpu_torch.get_sorted(want_stats, type='niter')]
    close(got, to_numpy(want), rtol=1e-12)
