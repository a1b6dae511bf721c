"""Step-size adaptivity on the stage machine of the PyTorch port against live
runs of the JAX package (float64, CPU).

Every configuration runs through ``pysdc_tpu.ControllerNonMPI`` once (a cached
run shared by the cases of this file), through the port's ``ControllerNonMPI``
and through the stage lane of its block controller.  Gates: equal ``niter`` and
``restart`` per step and equal step counts; ``dt`` and the
``error_embedded_estimate*`` / residual entries to rtol 1e-7 (1e-5 for the
Allen-Cahn block) above a floor of 1e-11; ``uend`` to 1e-10 (1e-8 Allen-Cahn).
The new classes are also held one by one against their JAX counterparts on
inputs from a numpy seed.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import pysdc_tpu
import pysdc_tpu.convergence as jconv
import pysdc_tpu_torch
import pysdc_tpu_torch.convergence as tconv
from pysdc_tpu.hooks import logging_hooks as jhooks
from pysdc_tpu.models.allen_cahn import AllenCahnPeriodicND as JaxAllenCahn
from pysdc_tpu.models.allen_cahn import AllenCahnPeriodicSemiImplicitND as JaxAllenCahnIMEX
from pysdc_tpu.models.odes import VanDerPol as JaxVanDerPol
from pysdc_tpu.models.odes import newton_solve as jax_newton_solve
from pysdc_tpu.sweepers.imex import IMEXSweeper as JaxIMEX
from pysdc_tpu_torch.core.errors import ControllerError, ParameterError
from pysdc_tpu_torch.hooks import logging_hooks as thooks
from pysdc_tpu_torch.models import odes
from pysdc_tpu_torch.ops import loops
from pysdc_tpu_torch.models.allen_cahn import AllenCahnPeriodicND, AllenCahnPeriodicSemiImplicitND
from pysdc_tpu_torch.models.odes import NewtonODE, VanDerPol, newton_solve
from pysdc_tpu_torch.utils.convert import (
    dts_to_numpy,
    dts_to_torch,
    step_to_numpy,
    step_to_torch,
    to_numpy,
    to_torch,
)

# the fields of these runs are small (2 unknowns, 32^2 grids): one thread does them fastest, and several test
# workers with a pool of threads each oversubscribe the cores (a 2 s case took 77 s under six workers)
torch.set_num_threads(1)

CLASSES = {
    'vdp': (JaxVanDerPol, VanDerPol),
    'ac': (JaxAllenCahnIMEX, AllenCahnPeriodicSemiImplicitND),
}
ENTRY_TYPES = ('dt', 'error_embedded_estimate', 'residual_post_iteration', 'residual_post_step',
               'error_embedded_estimate_post_step')


def vdp(controllers, maxiter=4, dt=1e-2, **level):
    """The Van der Pol configuration of tests/test_fused.py:281-360."""
    return dict(
        problem='vdp',
        problem_params=dict(mu=5.0, u0=(2.0, 0.0), newton_tol=1e-10),
        sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=3, QI='LU'),
        level_params=dict(restol=-1.0, dt=dt, **level),
        step_params=dict(maxiter=maxiter),
        convergence_controllers=controllers,
    )


def allen_cahn(controllers, restol=-1.0, maxiter=4):
    """The two-level IMEX Allen-Cahn block of tests/test_fused.py:320-340."""
    return dict(
        problem='ac', sweeper='imex',
        problem_params=dict(nvars=[(32, 32), (16, 16)], eps=0.2, radius=0.25),
        sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=[3], QI='LU', QE='EE'),
        level_params=dict(restol=restol, dt=1e-3),
        step_params=dict(maxiter=maxiter),
        space_transfer_params=dict(rorder=2, iorder=6, periodic=True),
        convergence_controllers=controllers,
    )


JAC = {'mssdc_jac': True}
# name -> (description parts, num_procs, controller params, Tend); a convergence controller is named by its class name
RUNS = {
    'vdp-P1': (vdp({'Adaptivity': {'e_tol': 1e-7}}), 1, {}, 0.1),
    'vdp-P1-linearized': (vdp({'Adaptivity': {'e_tol': 1e-7, 'embedded_error_flavor': 'linearized'}}), 1, {}, 0.1),
    'vdp-P4-jacobi': (vdp({'Adaptivity': {'e_tol': 1e-7}}, maxiter=7, dt=2e-2), 4, JAC, 0.24),
    'vdp-P4-linearized': (vdp({'Adaptivity': {'e_tol': 1e-7, 'embedded_error_flavor': 'linearized'}}, maxiter=7),
                          4, JAC, 0.25),
    'vdp-P3-gauss-seidel': (vdp({'Adaptivity': {'e_tol': 1e-6}}, maxiter=5), 3, {'mssdc_jac': False}, 0.1),
    'vdp-P1-dt-bounds': (vdp({'Adaptivity': {'e_tol': 1e-7, 'dt_min': 6e-3, 'dt_max': 8e-3}}), 1, {}, 0.1),
    'vdp-P1-slope-limiter': (vdp({'Adaptivity': {'e_tol': 1e-7, 'dt_slope_max': 1.2, 'dt_slope_min': 0.6,
                                                 'dt_rel_min_slope': 0.1}}), 1, {}, 0.1),
    'vdp-P2-rounding': (vdp({'Adaptivity': {'e_tol': 1e-7}, 'StepSizeRounding': {}}), 2, JAC, 0.1),
    'vdp-P1-rel-error': (vdp({'Adaptivity': {'e_tol': 1e-7, 'rel_error': True}}), 1, {}, 0.06),
    'vdp-P2-e_tol-termination': (vdp({}, maxiter=12, e_tol=1e-9), 2, JAC, 0.06),
    'ac-P4-burnin': (allen_cahn({'Adaptivity': {'e_tol': 1e-7, 'dt_max': 5e-3, 'dt_min': 1e-5}}), 4,
                     {'predict_type': 'pfasst_burnin'}, 1e-3),
}


def description(package, parts):
    """``parts`` with the classes of ``package`` ('jax' or 'torch'); the port runs on the CPU."""
    jax_side = package == 'jax'
    pkg = pysdc_tpu if jax_side else pysdc_tpu_torch
    conv = jconv if jax_side else tconv
    parts = dict(parts)
    problem = CLASSES[parts.pop('problem')][0 if jax_side else 1]
    if parts.pop('sweeper', 'implicit') == 'imex':
        sweeper = JaxIMEX if jax_side else pysdc_tpu_torch.IMEXSweeper
    else:
        sweeper = pkg.GenericImplicit
    controllers = {getattr(conv, name): dict(params) for name, params in parts.pop('convergence_controllers').items()}
    desc = dict(parts, problem_class=problem, sweeper_class=sweeper, convergence_controllers=controllers)
    if not jax_side:
        desc['problem_params'] = dict(desc['problem_params'], device='cpu')
    return pkg, desc


def summary(pkg, ctrl, uend, stats):
    return dict(uend=np.asarray(to_numpy(uend)), stats=stats, ctrl=ctrl, pkg=pkg)


def entries(run, kind):
    return run['pkg'].get_sorted(run['stats'], type=kind, recomputed=None)


@functools.lru_cache(maxsize=None)
def virtual(package, name):
    """``ControllerNonMPI`` of ``package`` on run ``name``."""
    parts, num_procs, controller_params, Tend = RUNS[name]
    pkg, desc = description(package, parts)
    ctrl = pkg.ControllerNonMPI(num_procs, {'logger_level': 40, **controller_params}, desc)
    uend, stats = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, Tend)
    return summary(pkg, ctrl, uend, stats)


@functools.lru_cache(maxsize=None)
def block(name, lane):
    """The port's block controller on run ``name`` through ``lane``."""
    parts, num_procs, controller_params, Tend = RUNS[name]
    pkg, desc = description('torch', parts)
    ctrl = pkg.ShardedController(num_procs, {'logger_level': 40, **controller_params}, desc)
    uend, stats = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, Tend, lane=lane)
    return summary(pkg, ctrl, uend, stats)


def assert_parity(want, got, rtol, uend_tol):
    """The gate of ``_adaptive_parity`` (tests/test_fused.py:254-278)."""
    for kind in ('niter', 'restart'):
        assert [v for _, v in entries(want, kind)] == [v for _, v in entries(got, kind)], kind
    for kind in ENTRY_TYPES:
        a, b = entries(want, kind), entries(got, kind)
        assert len(a) == len(b), kind
        for (t1, v1), (t2, v2) in zip(a, b):
            assert abs(t1 - t2) < 1e-9, (kind, t1, t2)
            assert np.isclose(v1, v2, rtol=rtol, atol=1e-11), (kind, t1, v1, v2)
    np.testing.assert_allclose(got['uend'], want['uend'], rtol=0, atol=uend_tol)


def tolerances(name):
    return (1e-5, 1e-8) if name.startswith('ac') else (1e-7, 1e-10)


@pytest.mark.parametrize('name', list(RUNS))
def test_stage_machine_matches_live_jax_run(name):
    want, got = virtual('jax', name), virtual('torch', name)
    assert_parity(want, got, *tolerances(name))
    assert len(entries(got, 'niter')) > 2


@pytest.mark.parametrize('name', list(RUNS))
def test_block_controller_stage_lane_matches_live_jax_run(name):
    """The batched stage handlers, with ``newton_tol`` as a per-step ``(P,)`` argument of the batched Newton."""
    want, got = virtual('jax', name), block(name, 'stage')
    assert_parity(want, got, *tolerances(name))
    assert [v for k, v in got['stats'].items() if k.type == 'lane'] == ['stage']


@pytest.mark.parametrize('name, restarts, distinct', [
    ('vdp-P1', 1, 5), ('vdp-P4-jacobi', 4, 4), ('vdp-P4-linearized', 1, 4), ('ac-P4-burnin', 4, 4),
    ('vdp-P1-dt-bounds', 1, 2), ('vdp-P2-rounding', 1, 2),
])
def test_the_runs_do_adapt(name, restarts, distinct):
    """The gates above hold something: each run restarts and takes several step sizes."""
    got = virtual('torch', name)
    assert sum(v for _, v in entries(got, 'restart')) >= restarts
    assert len({round(v, 14) for _, v in entries(got, 'dt')}) >= distinct


def test_dt_bounds_and_rounding_show_in_the_step_sizes():
    dts = [v for _, v in entries(virtual('torch', 'vdp-P1-dt-bounds'), 'dt')]
    assert min(dts[1:-1]) >= 6e-3 - 1e-15 and max(dts[1:]) <= 8e-3 + 1e-15 and dts[0] == 1e-2
    rounded = [v for _, v in entries(virtual('torch', 'vdp-P2-rounding'), 'dt')]
    for dt in rounded[:-2]:  # the last block is cut to land on Tend
        mantissa = dt / 10.0 ** np.floor(np.log10(dt))
        assert abs(mantissa * 10 - round(mantissa * 10)) < 1e-9 and round(mantissa * 10) % 5 == 0, dt


def test_e_tol_termination_registers_the_estimator():
    """``CheckConvergence(e_tol=...)``: the increment under e_tol ends a step before maxiter."""
    got = virtual('torch', 'vdp-P2-e_tol-termination')
    names = [type(C).__name__ for C in got['ctrl'].ordered_convergence_controllers()]
    assert names == [type(C).__name__ for C in virtual('jax', 'vdp-P2-e_tol-termination')['ctrl']
                     .ordered_convergence_controllers()]
    assert 'EstimateEmbeddedError' in names and 'StoreUOld' in names
    assert all(0 < v < 12 for _, v in entries(got, 'niter'))


@pytest.mark.parametrize('name', ['vdp-P4-jacobi', 'vdp-P1-slope-limiter', 'vdp-P2-rounding', 'ac-P4-burnin'])
def test_controller_stack_and_hooks_match(name):
    """The same policies in the same order and the same hooks as the JAX package registers."""
    want, got = virtual('jax', name)['ctrl'], virtual('torch', name)['ctrl']
    order = lambda c: [(type(C).__name__, C.params.control_order) for C in c.ordered_convergence_controllers()]  # noqa: E731
    assert order(got) == order(want)
    assert [type(h).__name__ for h in got.hooks] == [type(h).__name__ for h in want.hooks]


# -- the classes one by one ------------------------------------------------
def _fake_step(dt, dt_new, restart=False):
    lvl = SimpleNamespace(params=SimpleNamespace(dt=dt), status=SimpleNamespace(dt_new=dt_new))
    return SimpleNamespace(levels=[lvl], status=SimpleNamespace(restart=restart, slot=0))


def _policy(conv, name, params):
    ctrl = SimpleNamespace(add_convergence_controller=lambda *a, **k: None, add_hook=lambda *a, **k: None)
    return getattr(conv, name)(ctrl, dict(params), {'level_params': {'restol': -1.0}})


LIMITERS = [
    ('StepSizeLimiter', dict(dt_min=2e-3, dt_max=3e-2)),
    ('StepSizeLimiter', dict()),
    ('StepSizeSlopeLimiter', dict(dt_slope_min=0.5, dt_slope_max=1.5)),
    ('StepSizeSlopeLimiter', dict(dt_rel_min_slope=0.2)),
    ('StepSizeRounding', dict()),
    ('StepSizeRounding', dict(digits=2, fac=2)),
]


@pytest.mark.parametrize('seed', range(4))
@pytest.mark.parametrize('name, params', LIMITERS)
def test_step_size_policies_match(name, params, seed):
    rng = np.random.RandomState(seed)
    for dt, dt_new in zip(10.0 ** rng.uniform(-3, -1, 8), 10.0 ** rng.uniform(-4, 0, 8)):
        for restart in (False, True):
            steps = [_fake_step(dt, dt_new, restart), _fake_step(dt, dt_new, restart)]
            _policy(jconv, name, params).get_new_step_size(None, steps[0])
            _policy(tconv, name, params).get_new_step_size(None, steps[1])
            assert steps[0].levels[0].status.dt_new == steps[1].levels[0].status.dt_new


@pytest.mark.parametrize('seed', range(3))
def test_controller_formula_matches(seed):
    from pysdc_tpu.convergence.adaptivity import _controller_formula as want
    from pysdc_tpu_torch.convergence.adaptivity import _controller_formula as got

    rng = np.random.RandomState(seed)
    for beta, dt, e_tol, e, k in zip(rng.uniform(0.5, 1, 6), rng.uniform(1e-3, 1, 6), 10.0 ** rng.uniform(-9, -3, 6),
                                     10.0 ** rng.uniform(-10, -2, 6), rng.randint(1, 8, 6)):
        assert got(beta, dt, e_tol, e, k) == want(beta, dt, e_tol, e, k)


def test_limiter_forwarding_of_the_slope_keys():
    """``Adaptivity`` forwards dt_min / dt_max and the slope keys to ``StepSizeLimiter``, which forwards the slope
    keys to ``StepSizeSlopeLimiter`` one place before itself."""
    ctrl = virtual('torch', 'vdp-P1-slope-limiter')['ctrl']
    by_name = {type(C).__name__: C for C in ctrl.convergence_controllers}
    assert by_name['StepSizeSlopeLimiter'].params.control_order == by_name['StepSizeLimiter'].params.control_order - 1
    assert by_name['StepSizeSlopeLimiter'].params.dt_slope_max == 1.2


def test_adaptivity_needs_e_tol_and_no_restol():
    pkg, desc = description('torch', vdp({'Adaptivity': {}}))
    with pytest.raises(ParameterError, match='e_tol'):
        pkg.ControllerNonMPI(1, {'logger_level': 40}, desc)
    pkg, desc = description('torch', vdp({'Adaptivity': {'e_tol': 1e-6}}))
    desc['level_params']['restol'] = 1e-8
    with pytest.raises(ParameterError, match='restol'):
        pkg.ControllerNonMPI(1, {'logger_level': 40}, desc)
    with pytest.raises(NotImplementedError, match='flavor'):
        tconv.EstimateEmbeddedError.get_implementation('other')


def _newly_ported(name):
    """A short Van der Pol run of each class that raised "not ported" until the estimators were ported."""
    params = {
        'AdaptivityResidual': {'e_tol': 1e-5, 'max_restol': 1e-9},
        'AdaptivityPolynomialError': {'e_tol': 1e-7},
        'AdaptivityExtrapolationWithinQ': {'e_tol': 1e-7},
        'AdaptivityCollocation': {'e_tol': 1e-7, 'adaptive_coll_params': {'num_nodes': [2, 3]}},
        'EstimateEmbeddedErrorCollocation': {'adaptive_coll_params': {'num_nodes': [2, 3]}},
    }[name]
    parts = vdp({name: params}, maxiter=4 if name == 'AdaptivityResidual' else 30, dt=2e-2)
    if name != 'AdaptivityResidual':
        parts['level_params']['restol'] = 1e-10
    runs = {}
    for package in ('jax', 'torch'):
        pkg, desc = description(package, parts)
        ctrl = pkg.ControllerNonMPI(1, {'logger_level': 40}, desc)
        uend, stats = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, 0.1)
        runs[package] = summary(pkg, ctrl, uend, stats)
    return runs


@pytest.mark.parametrize('name, item', [
    ('AdaptivityResidual', 'item 13'), ('AdaptivityPolynomialError', 'item 13'),
    ('AdaptivityExtrapolationWithinQ', 'item 13'), ('AdaptivityCollocation', 'item 13'),
    ('EstimateEmbeddedErrorCollocation', 'item 13'),
])
def test_unported_controllers_raise_naming_their_item(name, item):
    """The classes that raised naming ROADMAP ``item`` until it was ported now run, and their runs equal the JAX
    package's under this file's gate (tests/test_torch_estimators.py holds them to tighter ones)."""
    runs = _newly_ported(name)
    assert_parity(runs['jax'], runs['torch'], 1e-7, 1e-10)
    assert len(entries(runs['torch'], 'niter')) >= 3 and name in jconv.__all__ and name in tconv.__all__


def test_exports_are_names_of_the_jax_registry():
    assert set(tconv.__all__) <= set(jconv.__all__)
    for name in ('Adaptivity', 'EstimateEmbeddedError', 'EstimateEmbeddedErrorLinearized', 'StepSizeLimiter',
                 'StepSizeSlopeLimiter', 'StepSizeRounding', 'StoreUOld'):
        assert name in tconv.__all__
    assert tconv.EstimateEmbeddedError.get_implementation('linearized') is tconv.EstimateEmbeddedErrorLinearized


def test_log_solution_and_step_size_hooks():
    """``LogSolution`` ('u' at the step's end time) and ``LogStepSize`` against the JAX package's hooks."""
    parts = vdp({'Adaptivity': {'e_tol': 1e-6}})
    runs = {}
    for package, hooks in (('jax', jhooks), ('torch', thooks)):
        pkg, desc = description(package, parts)
        ctrl = pkg.ControllerNonMPI(1, {'logger_level': 40, 'hook_class': [hooks.LogSolution, hooks.LogStepSize]}, desc)
        uend, stats = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, 0.05)
        runs[package] = summary(pkg, ctrl, uend, stats)
    for kind in ('u', 'dt'):
        a, b = entries(runs['jax'], kind), entries(runs['torch'], kind)
        assert len(a) == len(b) > 2
        for (t1, v1), (t2, v2) in zip(a, b):
            assert abs(t1 - t2) < 1e-12
            np.testing.assert_allclose(np.asarray(v2), np.asarray(v1), rtol=1e-9, atol=1e-12)
    assert isinstance(entries(runs['torch'], 'u')[0][1], np.ndarray)
    np.testing.assert_allclose(entries(runs['torch'], 'u')[-1][1], runs['torch']['uend'], rtol=0, atol=0)


# -- the Newton solve and the models -----------------------------------------
@pytest.mark.parametrize('seed', range(3))
def test_newton_solve_batched_equals_one_system_at_a_time(seed):
    rng = np.random.RandomState(seed)
    prob = VanDerPol(device='cpu', newton_tol=1e-11)
    rhs = torch.as_tensor(rng.uniform(-2, 2, (3, 4, 2)))
    factor = torch.as_tensor(rng.uniform(1e-3, 5e-2, 3))
    batched = prob.solve_system_batched(rhs, factor, rhs, torch.zeros(3, 4, dtype=torch.float64))
    jprob = JaxVanDerPol(newton_tol=1e-11)
    for m in range(3):
        block_m = prob.solve_system(rhs[m], float(factor[m]), rhs[m], torch.zeros(4, dtype=torch.float64))
        for j in range(4):
            one = prob.solve_system(rhs[m, j], float(factor[m]), rhs[m, j], 0.0)
            np.testing.assert_allclose(batched[m, j].numpy(), one.numpy(), rtol=0, atol=1e-14)
            np.testing.assert_allclose(block_m[j].numpy(), one.numpy(), rtol=0, atol=1e-14)
            want = jprob.solve_system(rhs[m, j].numpy(), float(factor[m]), rhs[m, j].numpy(), 0.0)
            np.testing.assert_allclose(one.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    residual = batched - factor.reshape(3, 1, 1) * prob.eval_f(batched, 0.0) - rhs
    assert float(torch.linalg.vector_norm(residual, dim=-1).max()) <= 1e-11


def test_newton_solve_stops_each_system_on_its_own_tolerance():
    """A per-step tolerance ``(P,)``: a step with a loose one stops early and then does not change."""
    rng = np.random.RandomState(5)
    prob = VanDerPol(device='cpu')
    rhs = torch.as_tensor(rng.uniform(-2, 2, (4, 2)))
    tight = prob.solve_system(rhs, 0.05, rhs, 0.0)
    prob.newton_tol = torch.tensor([1e-9, 1e-1, 1e-9, 1e-1], dtype=torch.float64)
    mixed = prob.solve_system(rhs, 0.05, rhs, 0.0)
    gap = (mixed - tight).abs().amax(dim=-1)
    assert gap[0] == 0 and gap[2] == 0 and gap[1] > 1e-9 and gap[3] > 1e-9
    f = lambda u: prob.eval_f(u, 0.0)  # noqa: E731
    assert torch.equal(newton_solve(f, lambda u: prob.eval_jacobian(u, 0.0), rhs, 0.05, rhs, 1e9, 50), rhs)


def test_jacobian_by_hand_equals_forward_mode():
    rng = np.random.RandomState(2)
    prob = VanDerPol(device='cpu')
    u = torch.as_tensor(rng.uniform(-2, 2, (3, 4, 2)))
    by_hand = prob.eval_jacobian(u, 0.0)
    count = prob.work_counters['rhs'].niter
    for t in (0.0, torch.zeros(3, 4, dtype=torch.float64), torch.zeros(3, dtype=torch.float64)):
        np.testing.assert_allclose(NewtonODE.eval_jacobian(prob, u, t).numpy(), by_hand.numpy(), rtol=0, atol=1e-14)
    assert prob.work_counters['rhs'].niter == count
    one = NewtonODE.eval_jacobian(prob, u[0, 0], 0.0)
    np.testing.assert_allclose(one.numpy(), by_hand[0, 0].numpy(), rtol=0, atol=1e-14)


def test_newton_under_capture_runs_a_fixed_depth_and_flags(monkeypatch):
    """While a graph is captured the loop cannot read: fixed depth, and a system it cuts short sets the flag."""
    rng = np.random.RandomState(3)
    prob = VanDerPol(device='cpu', newton_tol=1e-12)
    rhs = torch.as_tensor(rng.uniform(-2, 2, (4, 2)))
    eager = prob.solve_system(rhs, 0.05, rhs, 0.0)
    monkeypatch.setattr(loops, 'capturing', lambda u: True)  # the masked loop's and the solve's test
    fixed = prob.solve_system(rhs, 0.05, rhs, 0.0)
    np.testing.assert_allclose(fixed.numpy(), eager.numpy(), rtol=0, atol=1e-14)
    assert not bool(prob.newton_failed)
    monkeypatch.setattr(odes, 'CAPTURE_DEPTH', 1)
    prob.solve_system(rhs, 0.05, rhs, 0.0)
    assert bool(prob.newton_failed)
    f = lambda u: prob.eval_f(u, 0.0)  # noqa: E731
    with pytest.raises(RuntimeError, match='failed'):
        newton_solve(f, lambda u: prob.eval_jacobian(u, 0.0), rhs, 0.05, rhs, 1e-12, 50)


def test_van_der_pol_matches():
    rng = np.random.RandomState(4)
    u = rng.uniform(-2, 2, 2)
    jprob, prob = JaxVanDerPol(mu=3.0), VanDerPol(mu=3.0, device='cpu')
    np.testing.assert_allclose(prob.eval_f(torch.as_tensor(u), 0.0).numpy(), np.asarray(jprob.eval_f(u, 0.0)), atol=1e-15)
    np.testing.assert_allclose(prob.u_exact(0.0).numpy(), np.asarray(jprob.u_exact(0.0)), atol=0)
    np.testing.assert_allclose(prob.u_exact(0.05).numpy(), np.asarray(jprob.u_exact(0.05)), atol=1e-10)
    assert prob.newton_maxiter == jprob.newton_maxiter == 100 and prob.shape == (2,)


@pytest.mark.parametrize('nvars', [(16, 16), (24,)])
def test_allen_cahn_matches(nvars):
    rng = np.random.RandomState(6)
    u = rng.uniform(0, 1, nvars)
    jprob = JaxAllenCahnIMEX(nvars=nvars, eps=0.1)
    prob = AllenCahnPeriodicSemiImplicitND(nvars=nvars, eps=0.1, device='cpu')
    tu = torch.as_tensor(u)
    for t in (0.0, 0.01):
        np.testing.assert_allclose(prob.u_exact(t).numpy(), np.asarray(jprob.u_exact(t)), rtol=0, atol=1e-14)
    want, got = jprob.eval_f(u, 0.0), prob.eval_f(tu, 0.0)
    np.testing.assert_allclose(got.impl.numpy(), np.asarray(want.impl), rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.expl.numpy(), np.asarray(want.expl), rtol=0, atol=1e-12)
    np.testing.assert_allclose(prob._reaction_prime(tu).numpy(), np.asarray(jprob._reaction_prime(u)), rtol=0, atol=1e-11)
    np.testing.assert_allclose(prob.solve_system(tu, 0.02, tu, 0.0).numpy(),
                               np.asarray(jprob.solve_system(u, 0.02, u, 0.0)), rtol=0, atol=1e-13)
    full_j, full_t = JaxAllenCahn(nvars=nvars, eps=0.1), AllenCahnPeriodicND(nvars=nvars, eps=0.1, device='cpu')
    np.testing.assert_allclose(full_t.eval_f(tu, 0.0).numpy(), np.asarray(full_j.eval_f(u, 0.0)), rtol=0, atol=1e-10)
    # the fully implicit solve (Newton-Krylov, ported with the nonlinear slice) against the JAX package's
    np.testing.assert_allclose(full_t.solve_system(tu, 0.02, tu, 0.0).numpy(),
                               np.asarray(full_j.solve_system(u, 0.02, u, 0.0)), rtol=0, atol=1e-11)
    assert hasattr(prob, 'newton_tol') and prob.f_kind == 'imex'


def test_allen_cahn_batched_functions_carry_node_and_time_axes():
    """``eval_f_batched`` / ``solve_system_batched`` on ``(M, P, *shape)`` equal the one-field functions, with the
    shifts a host array or a float64 tensor (``dt`` on the device times a constant table)."""
    rng = np.random.RandomState(7)
    prob = AllenCahnPeriodicSemiImplicitND(nvars=(16, 16), eps=0.1, device='cpu')
    u = torch.as_tensor(rng.uniform(0, 1, (3, 2, 16, 16)))
    shifts = np.array([0.01, 0.02, 0.03])
    f = prob.eval_f_batched(u, None)
    solved = prob.solve_system_batched(u, shifts, u, None)
    on_device = prob.solve_system_batched(u, torch.as_tensor(0.5, dtype=torch.float64) * torch.as_tensor(2 * shifts), u, None)
    assert torch.equal(solved, on_device)
    for m in range(3):
        for j in range(2):
            one = prob.eval_f(u[m, j], 0.0)
            np.testing.assert_allclose(f.impl[m, j].numpy(), one.impl.numpy(), rtol=0, atol=1e-12)
            np.testing.assert_allclose(f.expl[m, j].numpy(), one.expl.numpy(), rtol=0, atol=0)
            np.testing.assert_allclose(solved[m, j].numpy(), prob.solve_system(u[m, j], shifts[m], None, 0.0).numpy(),
                                       rtol=0, atol=1e-14)
    sparse = AllenCahnPeriodicSemiImplicitND(nvars=(8,), eps=0.1, backend='sparse', device='cpu')
    v = torch.as_tensor(rng.uniform(0, 1, 8))
    dense = AllenCahnPeriodicSemiImplicitND(nvars=(8,), eps=0.1, device='cpu')
    np.testing.assert_allclose(sparse.eval_f(v, 0.0).impl.numpy(), dense.eval_f(v, 0.0).impl.numpy(), rtol=0, atol=1e-11)


# -- per-step problem scalars and the state carried across ----------------------
def test_per_step_newton_tol_reaches_the_batched_newton():
    """Each step's own ``newton_tol`` (what a policy such as NewtonInexactness writes) is used by the block
    controller's batched sweeps as it is by the virtual controller's per-step sweeps."""
    parts, _, _, _ = RUNS['vdp-P3-gauss-seidel']
    tols = [1e-10, 1e-3, 1e-6]
    results = {}
    for jac in (True, False):
        for kind in ('virtual', 'block'):
            pkg, desc = description('torch', parts)
            cls = pkg.ControllerNonMPI if kind == 'virtual' else pkg.ShardedController
            ctrl = cls(3, {'logger_level': 40, 'mssdc_jac': jac}, desc)
            for step, tol in zip(ctrl.MS, tols):
                step.levels[0].prob.newton_tol = tol
            kwargs = {'lane': 'stage'} if kind == 'block' else {}
            uend, stats = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, 0.06, **kwargs)
            results[jac, kind] = summary(pkg, ctrl, uend, stats)
            if kind == 'block':
                ov = ctrl._block_overrides(0)
                assert ov['newton_tol'].tolist() == tols and ov['newton_tol'].dtype == torch.float64
        assert_parity(results[jac, 'virtual'], results[jac, 'block'], 1e-9, 1e-12)
    uniform = block('vdp-P3-gauss-seidel', 'stage')
    assert np.abs(results[False, 'block']['uend'] - uniform['uend']).max() > 0  # the loose tolerances do show


def test_t_switch_override_raises_naming_its_item():
    """The per-step ``t_switch`` (which raised naming item 13 until the switch estimator was ported) reaches the
    batched functions as a ``(P,)`` float64 tensor beside ``newton_tol``, with the JAX package's values."""
    overrides = {}
    for package in ('jax', 'torch'):
        pkg, desc = description(package, RUNS['vdp-P1'][0])
        ctrl = pkg.ShardedController(2, {'logger_level': 40}, desc)
        ctrl.blocks[0].traced_keys = ('newton_tol', 't_switch')
        for step, t_switch in zip(ctrl.MS, (np.inf, 0.25)):
            step.levels[0].prob.t_switch = t_switch
        overrides[package] = ctrl._block_overrides(0)
    for key in ('newton_tol', 't_switch'):
        assert overrides['torch'][key].dtype == torch.float64 and overrides['torch'][key].shape == (2,)
        assert overrides['torch'][key].tolist() == np.asarray(overrides['jax'][key]).tolist()
    assert overrides['torch']['t_switch'].tolist() == [np.inf, 0.25]


def test_rejected_block_state_crosses_between_the_packages():
    """A step of the JAX run after its last block, with ``uold`` (the previous sweep) and the per-level step sizes,
    written into a step of the port: the estimator reads the same gap, a sweep with ``dt`` on the device gives
    the same state, and the carried ``dts`` come back unchanged."""
    from pysdc_tpu.convergence.estimate_embedded_error import _order_gap as jax_gap
    from pysdc_tpu_torch.convergence.estimate_embedded_error import _order_gap as torch_gap

    jctrl, tctrl = virtual('jax', 'ac-P4-burnin')['ctrl'], virtual('torch', 'ac-P4-burnin')['ctrl']
    jstep = jctrl.MS[0]
    levels = step_to_numpy(jstep)
    assert levels[0]['uold'] is not None and levels[0]['dt'] != levels[1]['dt']  # restarts left the coarse dt behind
    pkg, desc = description('torch', RUNS['ac-P4-burnin'][0])
    tstep = pkg.ControllerNonMPI(1, {'logger_level': 40}, desc).MS[0]
    step_to_torch(levels, tstep, dtype=torch.float64)
    assert [lvl.params.dt for lvl in tstep.levels] == [float(lvl.params.dt) for lvl in jstep.levels]
    for rel in (False, True):
        assert np.isclose(torch_gap(tstep.levels[0], 'SDC', rel), jax_gap(jstep.levels[0], 'SDC', rel), rtol=1e-9)
    back = step_to_numpy(tstep)
    np.testing.assert_array_equal(back[0]['uold'], levels[0]['uold'])
    assert back[0]['dt'] == levels[0]['dt']

    dts = dts_to_torch([lvl['dt'] for lvl in levels], 'cpu')
    assert dts.dtype == torch.float64 and dts.shape == (2,)
    np.testing.assert_array_equal(dts_to_numpy(dts), [lvl['dt'] for lvl in levels])
    L, JL = tstep.levels[0], jstep.levels[0]
    t = float(JL.status.time)
    swept = L.sweep.update_nodes(L.prob, L.state, torch.as_tensor(t, dtype=torch.float64), dts[0], 0)
    host = L.sweep.update_nodes(L.prob, L.state, t, float(dts[0]), 0)
    want = JL.sweep.update_nodes(JL.prob, JL.state, t, float(JL.params.dt), 0)
    np.testing.assert_allclose(swept.u.numpy(), np.asarray(want.u), rtol=0, atol=1e-12)
    assert torch.equal(swept.u, host.u) and torch.equal(swept.f.expl, host.f.expl)
    assert swept.u.dtype == torch.float64
    assert str(tctrl.MS[0].levels[0].prob.device) == 'cpu'
    assert to_torch(levels[0]['uold'], 'cpu').shape == L.state.u.shape
