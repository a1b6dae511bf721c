"""The DAE problems and sweepers of the PyTorch port against the JAX package (float64, CPU).

The cases of tests/test_boris_power_dae.py:99-230 that need no switch
estimator (ROADMAP queue 1, item 13), through both packages'
``ControllerNonMPI`` from the same numpy initial value: ``niter`` per step
equal and ``uend`` to 1e-11 relative to the state's size, with the reference
tests' own gates on the port's runs.  The horizons are cut (the eager node
Newton of the port takes some 5 ms a solve on this CPU); the reference-size
runs are marked ``slow`` here.  Two cases differ, each for a measured reason:

- ``SimpleDAE`` with ``FullyImplicitDAE`` converges slowly to restol 1e-11
  (34 sweeps a step) through residuals that sit on the rounding floor of its
  Newton solves (1e-11 to 1e-10, not monotone): one step of 20 ended a sweep
  apart from the JAX run at the reference horizon.  Its ``niter`` are held to
  1 apart, its ``uend`` to 1e-12 (2.1e-13 measured).
- ``Pendulum2D`` (index 3) at the reference's restol 1e-10 stalls at the
  floor too; here restol is 1e-8, where ``niter`` are equal.  The Lagrange
  multiplier carries the rounding amplified by 1/dt^2: positions to 1e-12,
  velocities to 1e-10, the multiplier to 1e-8 (3.8e-9 measured), the
  constraint to 1e-10 (the reference's gate).
"""

import functools

import numpy as np
import pytest
import torch

import pysdc_tpu
import pysdc_tpu_torch
from pysdc_tpu.models import dae_problems as jdp
from pysdc_tpu.sweepers import dae as jdae
from pysdc_tpu_torch.core.errors import ParameterError
from pysdc_tpu_torch.models import dae_problems as tdp
from pysdc_tpu_torch.sweepers import dae as tdae
from pysdc_tpu_torch.utils.convert import to_numpy, to_torch

torch.set_num_threads(1)

FULLY, SEMI = 'FullyImplicitDAE', 'SemiImplicitDAE'
# name -> (problem, problem params, sweeper, sweeper params, level params, maxiter, t0, Tend)
CASES = {
    # tests/test_boris_power_dae.py:99-112 (Tend 1.0 there)
    'simple-fully': ('SimpleDAE', dict(newton_tol=1e-12), FULLY, dict(num_nodes=3, QI='IE'),
                     dict(dt=0.05, restol=1e-11), 40, 0.0, 0.2),
    'simple-semi': ('SimpleDAE', dict(newton_tol=1e-12), SEMI, dict(num_nodes=3, QI='IE'),
                    dict(dt=0.05, restol=1e-11), 40, 0.0, 0.2),
    # tests/test_boris_power_dae.py:115-127 (restol 1e-10, Tend 1.0 there; see the module docstring)
    'pendulum': ('Pendulum2D', dict(newton_tol=1e-12), FULLY, dict(num_nodes=3, QI='IE'),
                 dict(dt=0.01, restol=1e-8), 50, 0.0, 0.05),
    # tests/test_boris_power_dae.py:170-183 (Tend 1.0 there)
    'problematic-f': ('ProblematicF', dict(eta=1.0), FULLY, dict(num_nodes=3), dict(dt=0.05, restol=1e-11), 40, 0.0,
                      0.2),
    # tests/test_boris_power_dae.py:186-202 (Tend 3.0 there)
    'discontinuous': ('DiscontinuousTestDAE', {}, FULLY, dict(num_nodes=3), dict(dt=0.05, restol=1e-10), 40, 1.0, 1.2),
    # tests/test_boris_power_dae.py:233-250 (Tend 2e-3 there)
    'one-transistor': ('OneTransistorAmplifier', dict(newton_tol=1e-10), FULLY, dict(num_nodes=3),
                       dict(dt=1e-4, restol=1e-9), 40, 0.0, 4e-4),
    'two-transistor': ('TwoTransistorAmplifier', dict(newton_tol=1e-10), FULLY, dict(num_nodes=3),
                       dict(dt=1e-4, restol=1e-9), 40, 0.0, 4e-4),
    # tests/test_boris_power_dae.py:253-271, the steady state (16 steps there)
    'synchronous-machine': ('SynchronousMachineInfiniteBus', dict(newton_tol=1e-11), FULLY, dict(num_nodes=3),
                            dict(dt=1 / 1024, restol=1e-10), 40, 0.0, 4 / 1024),
    # tests/test_boris_power_dae.py:279-316: the RK-DAE classes on DiscontinuousTestDAE before its event
    **{f'rk-{name}': ('DiscontinuousTestDAE', dict(newton_tol=1e-13), name, {}, dict(dt=0.2), 1, 1.0, 1.8)
       for name in ('BackwardEulerDAE', 'TrapezoidalRuleDAE', 'DIRK43_2DAE', 'EDIRK4DAE')},
}


@functools.lru_cache(maxsize=None)
def _run(package, case):
    problem, params, sweeper, sweeper_params, level, maxiter, t0, Tend = CASES[case]
    side = 0 if package == 'jax' else 1
    pkg = pysdc_tpu if side == 0 else pysdc_tpu_torch
    desc = dict(problem_class=getattr((jdp, tdp)[side], problem),
                problem_params=dict(params, device='cpu') if side else params,
                sweeper_class=getattr((jdae, tdae)[side], sweeper), sweeper_params=sweeper_params,
                level_params=level, step_params=dict(maxiter=maxiter))
    ctrl = pkg.ControllerNonMPI(1, {'logger_level': 40}, desc)
    prob = ctrl.MS[0].levels[0].prob
    if side:
        prob.newton_trace = []
    u0 = np.asarray(prob.u_exact(t0)) if side == 0 else to_torch(_run('jax', case)['u0'], 'cpu')
    uend, stats = ctrl.run(u0, t0, Tend)
    exact = None
    if problem in ('SimpleDAE', 'ProblematicF', 'DiscontinuousTestDAE'):
        exact = np.asarray(to_numpy(prob.u_exact(Tend)))
    elif problem == 'SynchronousMachineInfiniteBus':
        exact = np.asarray(to_numpy(prob.u_exact(0.0)))
    return dict(u0=np.asarray(to_numpy(u0)), uend=np.asarray(to_numpy(uend)), exact=exact,
                niter=[v for _, v in pkg.get_sorted(stats, type='niter', sortby='time')],
                newton=None if side == 0 else prob.newton_trace, maxiter=prob.newton_maxiter)


@pytest.mark.parametrize('case', list(CASES))
def test_dae_run_matches_jax(case):
    want, got = _run('jax', case), _run('torch', case)
    assert len(got['niter']) == len(want['niter']) >= 4
    scale = max(1.0, np.abs(want['uend']).max())
    if case == 'simple-fully':
        assert max(abs(a - b) for a, b in zip(got['niter'], want['niter'])) <= 1
        np.testing.assert_allclose(got['uend'], want['uend'], rtol=0, atol=1e-12 * scale)
    elif case == 'pendulum':
        assert got['niter'] == want['niter']
        for part, tol in ((slice(0, 2), 1e-12), (slice(2, 4), 1e-10), (slice(4, 5), 1e-8)):
            np.testing.assert_allclose(got['uend'][part], want['uend'][part], rtol=0, atol=tol * scale)
    else:
        assert got['niter'] == want['niter']
        np.testing.assert_allclose(got['uend'], want['uend'], rtol=0, atol=1e-11 * scale)
    # every Newton solve stopped before its maxiter
    assert got['newton'] and all(max(counts) < got['maxiter'] for counts in got['newton'])


def test_the_reference_gates_on_the_port():
    """tests/test_boris_power_dae.py's assertions on the port's runs (at the cut horizons; SimpleDAE's accuracy
    gate belongs to its horizon, t = 1, and is held by the slow case below)."""
    pend = _run('torch', 'pendulum')['uend']
    assert abs(pend[0] ** 2 + pend[1] ** 2 - 1.0) < 1e-10
    run = _run('torch', 'problematic-f')
    assert np.abs(run['uend'] - run['exact']).max() < 1e-5
    run = _run('torch', 'discontinuous')
    assert np.abs(run['uend'] - run['exact']).max() < 1e-7
    run = _run('torch', 'synchronous-machine')
    assert np.abs(run['uend'] - run['exact']).max() < 1e-6  # the steady state persists
    for case in ('one-transistor', 'two-transistor'):
        assert np.isfinite(_run('torch', case)['uend']).all()


def test_dae_gauss_quadrature_rejected():
    with pytest.raises(ParameterError):
        tdae.FullyImplicitDAE({'num_nodes': 3, 'quad_type': 'LOBATTO'})


def _rk_dae_err(name, dt, t0=1.0, Tend=1.8):
    desc = dict(problem_class=tdp.DiscontinuousTestDAE, problem_params=dict(newton_tol=1e-13, device='cpu'),
                sweeper_class=getattr(tdae, name), sweeper_params={}, level_params=dict(dt=dt),
                step_params=dict(maxiter=1))
    ctrl = pysdc_tpu_torch.ControllerNonMPI(1, {'logger_level': 40}, desc)
    prob = ctrl.MS[0].levels[0].prob
    uend, _ = ctrl.run(prob.u_exact(t0), t0, Tend)
    return float((uend - prob.u_exact(Tend)).abs().max())


@pytest.mark.parametrize('name, expected', [
    ('BackwardEulerDAE', 1), ('TrapezoidalRuleDAE', 2), ('DIRK43_2DAE', 3), ('EDIRK4DAE', 4),
])
def test_rk_dae_orders(name, expected):
    """tests/test_boris_power_dae.py:297-309 on the port: the classical orders of the RK-DAE family."""
    errs = [_rk_dae_err(name, dt) for dt in (0.1, 0.05, 0.025)]
    orders = [np.log(errs[i] / errs[i + 1]) / np.log(2) for i in range(len(errs) - 1)]
    assert float(np.median(orders)) > expected - 0.4, (orders, errs)


def test_rk_dae_carries_du_between_steps():
    """tests/test_boris_power_dae.py:312-316: du_init follows the previous step's last stage."""
    assert _rk_dae_err('TrapezoidalRuleDAE', 0.05) < 5e-3


def test_dae_problems_match_jax():
    """Each problem's residual F(u, u', t) at a seeded point, and for a batch of nodes with one time each (the
    port's residual is one batched evaluation), against the JAX package to 1e-14 relative."""
    rng = np.random.default_rng(21)
    for name in ('SimpleDAE', 'Pendulum2D', 'ProblematicF', 'DiscontinuousTestDAE', 'OneTransistorAmplifier',
                 'TwoTransistorAmplifier', 'SynchronousMachineInfiniteBus'):
        jprob, tprob = getattr(jdp, name)(), getattr(tdp, name)(device='cpu')
        n = jprob.shape[0]
        u, du, ts = 0.3 * rng.standard_normal((3, n)), rng.standard_normal((3, n)), np.array([0.02, 0.04, 0.07])
        got = tprob.eval_f(torch.as_tensor(u), torch.as_tensor(du), ts).numpy()
        for m in range(3):
            want = np.asarray(jprob.eval_f(u[m], du[m], ts[m]))
            np.testing.assert_allclose(got[m], want, rtol=1e-14, atol=1e-14 * np.abs(want).max())
            np.testing.assert_allclose(tprob.eval_f(torch.as_tensor(u[m]), torch.as_tensor(du[m]), float(ts[m])),
                                       want, rtol=1e-14, atol=1e-14 * np.abs(want).max())
    dae = tdp.DiscontinuousTestDAE(device='cpu')
    assert dae.get_switching_info([torch.tensor([49.0, 0.0]), torch.tensor([51.0, 0.0])], 0.0)[:2] == (True, 0)


@pytest.mark.slow
@pytest.mark.parametrize('sweeper', [FULLY, SEMI])
def test_simple_dae_reference_size(sweeper):
    """tests/test_boris_power_dae.py:99-112 at its horizon (20 steps of 28-34 sweeps: some 20 s here)."""
    desc = dict(problem_class=tdp.SimpleDAE, problem_params=dict(newton_tol=1e-12, device='cpu'),
                sweeper_class=getattr(tdae, sweeper), sweeper_params=dict(num_nodes=3, QI='IE'),
                level_params=dict(dt=0.05, restol=1e-11), step_params=dict(maxiter=40))
    ctrl = pysdc_tpu_torch.ControllerNonMPI(1, {'logger_level': 40}, desc)
    prob = ctrl.MS[0].levels[0].prob
    uend, _ = ctrl.run(prob.u_exact(0.0), 0.0, 1.0)
    assert float((uend - prob.u_exact(1.0)).abs().max()) < 5e-7


@pytest.mark.slow
def test_synchronous_machine_torque_drop():
    """tests/test_boris_power_dae.py:263-271: through t = 0.05 the torque drop decelerates the rotor (96 steps)."""
    desc = dict(problem_class=tdp.SynchronousMachineInfiniteBus, problem_params=dict(newton_tol=1e-11, device='cpu'),
                sweeper_class=tdae.FullyImplicitDAE, sweeper_params=dict(num_nodes=3),
                level_params=dict(dt=1 / 1024, restol=1e-10), step_params=dict(maxiter=40))
    ctrl = pysdc_tpu_torch.ControllerNonMPI(1, {'logger_level': 40}, desc)
    prob = ctrl.MS[0].levels[0].prob
    uend, _ = ctrl.run(prob.u_exact(0.0), 0.0, 96 / 1024)
    assert float(uend[7]) < 1.0 - 1e-3 and bool(torch.isfinite(uend).all())


@pytest.mark.parametrize('sweeper', [FULLY, SEMI, 'EDIRK4DAE'])
def test_fused_lanes_refuse_the_dae_sweepers(sweeper):
    """Every node solve is a Newton loop with a host read and a Jacobian by jacfwd, and the RK-DAE classes carry
    the step's derivative on the host: the fused lanes refuse them by name before any capture (the block
    controller's stage lane calls ``eval_f(u, t)``, which a DAE problem does not take, in both packages)."""
    from pysdc_tpu_torch.core.errors import ControllerError
    from pysdc_tpu_torch.parallel import fused

    desc = dict(problem_class=tdp.SimpleDAE, problem_params=dict(device='cpu'), sweeper_class=getattr(tdae, sweeper),
                sweeper_params=dict(num_nodes=3) if sweeper != 'EDIRK4DAE' else {}, level_params=dict(dt=0.05),
                step_params=dict(maxiter=4))
    ctrl = pysdc_tpu_torch.ShardedController(1, {'logger_level': 40}, desc)
    with pytest.raises(ControllerError, match='DAE sweeper solves each node by Newton'):
        fused.check_fused_eligibility(ctrl)
