"""The WSCC 9-bus DAE and the Quench problems of the PyTorch port against the JAX package (float64, CPU).

WSCC9: the residual before and after the line outage and with the valve pinned (to 1e-14 of its scale), the event
information, and ``FullyImplicitDAE`` to t = 0.02 (tests/test_wscc9_rdc.py:58 at a shorter horizon) against a live
JAX run: equal ``niter``, ``uend`` to 1e-12 relative (the Newton tolerance 1e-9 sets no floor here: both packages
take the same Newton steps, to roundoff).  Quench: the leak source and its derivative for every leak variant, the
fully implicit problem (``GenericImplicit`` over Newton-Krylov) and ``QuenchIMEX`` through ``ControllerNonMPI``
against live JAX runs (equal ``niter``, ``uend`` to 1e-11 relative), each Newton solve's count against the JAX
loop's, and the scipy reference solution.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysdc_tpu
import pysdc_tpu.models.quench as jq
import pysdc_tpu.models.wscc9 as jw
import pysdc_tpu_torch
from pysdc_tpu.sweepers.dae import FullyImplicitDAE as JaxFullyImplicitDAE
from pysdc_tpu.sweepers.generic_implicit import GenericImplicit as JaxGenericImplicit
from pysdc_tpu_torch.models.quench import Quench, QuenchIMEX
from pysdc_tpu_torch.models.wscc9 import WSCC9BusSystem, _assemble_ybus
from pysdc_tpu_torch.sweepers.dae import FullyImplicitDAE
from pysdc_tpu_torch.utils.convert import to_numpy
from test_torch_solvers import close

torch.set_num_threads(1)


# -- WSCC 9-bus ------------------------------------------------------------------------------------------------------
def test_wscc9_residual_matches_jax():
    jprob, tprob = jw.WSCC9BusSystem(), WSCC9BusSystem(device='cpu')
    np.testing.assert_array_equal(_assemble_ybus(jw._BRANCHES), jw._assemble_ybus(jw._BRANCHES))
    u0 = np.asarray(jprob.u_exact(0.0))
    close(tprob.u_exact(0.0), u0, rtol=0.0)
    rng = np.random.default_rng(11)
    u = u0 * (1.0 + 1e-3 * rng.standard_normal(57))
    du = 0.1 * rng.standard_normal(57)
    pinned = u.copy()
    pinned[10 * jprob.m] = 1.5  # the valve beyond psv_max
    for uu, t in ((u, 0.0), (u, 0.06), (pinned, 0.0)):
        want = np.asarray(jprob.eval_f(jnp.asarray(uu), jnp.asarray(du), t))
        close(tprob.eval_f(torch.as_tensor(uu), torch.as_tensor(du), t), want, rtol=1e-14)
    # the nodes of a residual ride along, each with its own time, and the switch time reaches them
    tprob.t_switch = 0.005
    batch = tprob.eval_f(torch.as_tensor(np.stack([u, pinned])), torch.as_tensor(np.stack([du, du])),
                         np.array([0.0, 0.06]))
    jprob.t_switch = 0.005
    for m, (uu, t) in enumerate(((u, 0.0), (pinned, 0.06))):
        close(batch[m], np.asarray(jprob.eval_f(jnp.asarray(uu), jnp.asarray(du), t)), rtol=1e-14)
    lo, hi = np.zeros(57), np.zeros(57)
    lo[10 * tprob.m], hi[10 * tprob.m] = 0.9, 1.1
    nodes = [lo, lo, hi]
    assert tprob.get_switching_info([torch.as_tensor(x) for x in nodes], 0.0) == jprob.get_switching_info(nodes, 0.0)


def _wscc9_run(package):
    pkg = pysdc_tpu if package == 'jax' else pysdc_tpu_torch
    desc = dict(problem_class=jw.WSCC9BusSystem if package == 'jax' else WSCC9BusSystem,
                problem_params=dict(newton_tol=1e-9) if package == 'jax' else dict(newton_tol=1e-9, device='cpu'),
                sweeper_class=JaxFullyImplicitDAE if package == 'jax' else FullyImplicitDAE,
                sweeper_params=dict(num_nodes=2, QI='IE'), level_params=dict(dt=0.01, restol=5e-9),
                step_params=dict(maxiter=40))
    ctrl = pkg.ControllerNonMPI(1, {'logger_level': 40}, desc)
    uend, stats = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, 0.02)
    return np.asarray(to_numpy(uend)), [v for _, v in pkg.get_sorted(stats, type='niter')]


def test_wscc9_dae_run_matches_live_jax():
    want, want_niter = _wscc9_run('jax')
    got, niter = _wscc9_run('torch')
    assert niter == want_niter and max(niter) < 40
    close(got, want, rtol=1e-12)


# -- Quench -----------------------------------------------------------------------------------------------------------
@pytest.mark.parametrize('leak', [('linear', 'step'), ('exponential', 'step'), ('linear', 'Gaussian'),
                                  ('exponential', 'Gaussian')])
def test_quench_leak_source_matches_jax(leak):
    kw = dict(nvars=64, leak_type=leak[0], leak_transition=leak[1])
    jprob, tprob = jq.Quench(**kw), Quench(device='cpu', **kw)
    u = np.linspace(0.0, 0.08, 64)[::-1].copy()  # through both thresholds
    close(tprob.eval_f_non_linear(torch.as_tensor(u), 0.0), jprob.eval_f_non_linear(jnp.asarray(u), 0.0), rtol=1e-14)
    # the dense Neumann Laplacian rounds to eps times its row sum (4 K / (Cv dx^2)) times max|u|
    scale = 4.0 * tprob.K / tprob.Cv / tprob.dx**2 * u.max()
    np.testing.assert_allclose(to_numpy(tprob.eval_f(torch.as_tensor(u), 0.0)), jprob.eval_f(jnp.asarray(u), 0.0),
                               rtol=0, atol=1e-14 * scale)
    close(tprob._non_linear_prime(torch.as_tensor(u)), jprob._non_linear_prime(jnp.asarray(u)), rtol=1e-14)


QUENCH = {
    # tests/test_quench_boussinesq.py:13 and :30 at 64 points, fewer steps; the fully implicit residual stalls near
    # 5e-9 at the default newton_tol of 1e-8, so its restol is 1e-8
    'implicit': ('Quench', 'GenericImplicit', dict(num_nodes=3, QI='LU'), 10.0, 1e-8, 20, 3),
    'imex': ('QuenchIMEX', 'IMEXSweeper', dict(num_nodes=3, QI='LU'), 5.0, 1e-10, 25, 4),
}


@functools.lru_cache(maxsize=None)
def _quench_run(package, name):
    cls, sweeper, sp, dt, restol, maxiter, steps = QUENCH[name]
    if package == 'jax':
        pkg, problem, pp = pysdc_tpu, getattr(jq, cls), dict(nvars=64)
        sweeper = JaxGenericImplicit if sweeper == 'GenericImplicit' else pkg.IMEXSweeper
    else:
        pkg, problem, pp = pysdc_tpu_torch, {'Quench': Quench, 'QuenchIMEX': QuenchIMEX}[cls], dict(nvars=64,
                                                                                                   device='cpu')
        sweeper = getattr(pkg, sweeper)
    desc = dict(problem_class=problem, problem_params=pp, sweeper_class=sweeper, sweeper_params=sp,
                level_params=dict(dt=dt, restol=restol), step_params=dict(maxiter=maxiter))
    ctrl = pkg.ControllerNonMPI(1, {'logger_level': 40}, desc)
    prob = ctrl.MS[0].levels[0].prob
    if package == 'torch':
        prob.solver_trace = []
    uend, stats = ctrl.run(prob.u_exact(0.0), 0.0, steps * dt)
    return np.asarray(to_numpy(uend)), [v for _, v in pkg.get_sorted(stats, type='niter')], prob


@pytest.mark.parametrize('name', list(QUENCH))
def test_quench_run_matches_live_jax(name):
    want, want_niter, _ = _quench_run('jax', name)
    got, niter, prob = _quench_run('torch', name)
    assert niter == want_niter and max(niter) < QUENCH[name][5]
    close(got, want)
    assert got.max() > 1e-4  # the leak heated the magnet
    if name == 'implicit':
        assert prob.solver_trace
        newton = [k for k, _ in prob.solver_trace]
        assert max(newton) > 0 and all(0 <= k < prob.newton_maxiter for k in newton)


def test_quench_newton_solve_matches_the_jax_loop():
    """One Newton-Krylov solve on a hot state: the result, and the Newton count of ``newton_pde`` against the JAX
    loop's (read from its ``jax.lax.while_loop`` by a callback in the derivative of the leak source)."""
    import jax

    import pysdc_tpu.ops.solvers as jsolvers

    jprob, tprob = jq.Quench(nvars=64), Quench(nvars=64, device='cpu')
    rhs = np.linspace(0.0, 0.08, 64) ** 2 * 10.0
    calls = []
    orig = jsolvers.newton_pde

    def counted(apply_A, solve_shifted, g, gprime, *args, **kwargs):
        def gp(u):
            jax.debug.callback(lambda: calls.append(1), ordered=True)
            return gprime(u)

        return orig(apply_A, solve_shifted, g, gp, *args, **kwargs)

    jq.newton_pde = counted
    try:
        want = jax.block_until_ready(jprob.solve_system(jnp.asarray(rhs), 20.0, jnp.asarray(rhs), 0.0))
        jax.effects_barrier()
    finally:
        jq.newton_pde = orig
    tprob.solver_trace = []
    close(tprob.solve_system(torch.as_tensor(rhs), 20.0, torch.as_tensor(rhs), 0.0), want)
    assert [k for k, _ in tprob.solver_trace] == [len(calls)] and len(calls) >= 2


def test_quench_scipy_reference_matches_jax():
    jprob, tprob = jq.Quench(nvars=32), Quench(nvars=32, device='cpu')
    close(tprob.u_exact(30.0), jprob.u_exact(30.0), rtol=1e-8)
    assert float(tprob.u_exact(0.0).abs().max()) == 0.0
