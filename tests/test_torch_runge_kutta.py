"""The Runge-Kutta sweepers of the PyTorch port against the JAX package (float64, CPU).

Every tableau of ``pysdc_tpu_torch.sweepers.runge_kutta`` equals the JAX
package's as numpy arrays; the empirical orders of tests/test_runge_kutta.py
(``EXPECTED_ORDER``, ``IMEX_ORDER``, the embedded secondary's lower order) hold
on the port; each tableau runs on ``Dahlquist`` (``DahlquistIMEX`` for the IMEX
pairs) against a live JAX run, ``uend`` to 1e-13; ``ESDIRK43`` and
``ARK548L2SA`` on the heat problems at 32^2 against JAX; ``AdaptivityRK`` on the
stage machine (ESDIRK43 on HeatND 32^2, Cash-Karp on VanDerPol) stats entry for
entry: equal ``niter`` and restarts, accepted ``dt`` to 1e-8 relative (see
``DT_RTOL``), the estimates to 1e-6, ``uend`` to 1e-9.
"""

import inspect
import logging

import numpy as np
import pytest
import torch

import pysdc_tpu
import pysdc_tpu_torch
from pysdc_tpu.convergence.adaptivity import AdaptivityRK as JaxAdaptivityRK
from pysdc_tpu.models import dahlquist as jdahl
from pysdc_tpu.models import heat as jheat
from pysdc_tpu.models import odes as jodes
from pysdc_tpu.sweepers import runge_kutta as jrk
from pysdc_tpu_torch.convergence.adaptivity import AdaptivityRK
from pysdc_tpu_torch.core.errors import ParameterError
from pysdc_tpu_torch.core.level import Level
from pysdc_tpu_torch.models import dahlquist as tdahl
from pysdc_tpu_torch.models import heat as theat
from pysdc_tpu_torch.models import odes as todes
from pysdc_tpu_torch.sweepers import runge_kutta as rk
from pysdc_tpu_torch.utils.convert import to_numpy

# tiny states: one thread does them fastest, and test workers with a pool of threads each oversubscribe the cores
torch.set_num_threads(1)

TABLEAUS = sorted(name for name, cls in vars(rk).items()
                  if inspect.isclass(cls) and issubclass(cls, rk.RungeKutta) and cls.__module__ == rk.__name__
                  and cls not in (rk.RungeKutta, rk.RungeKuttaIMEX))
IMEX_TABLEAUS = [name for name in TABLEAUS if issubclass(getattr(rk, name), rk.RungeKuttaIMEX)]

# tests/test_runge_kutta.py: EXPECTED_ORDER, the orders of the newer tableaus, IMEX_ORDER and the new IMEX orders
ORDER = {'ForwardEuler': 1, 'BackwardEuler': 1, 'CrankNicolson': 2, 'ExplicitMidpointMethod': 2,
         'ImplicitMidpointMethod': 2, 'RK4': 4, 'Heun_Euler': 2, 'Cash_Karp': 5, 'CrouzeixDIRK4': 4,
         'ARK324L2SAESDIRK': 3, 'ARK324L2SAERK': 3, 'DIRK43_2': 3, 'ESDIRK43': 4, 'EDIRK4': 4, 'DIRK43': 4,
         'ESDIRK53': 5, 'ARK548L2SAESDIRK': 5, 'ARK548L2SAERK2': 5}
IMEX_ORDER = {'IMEXEuler': 1, 'IMEXEulerStifflyAccurate': 1, 'ARK32': 3, 'ARK54': 5, 'ARK548L2SA': 5, 'ARK2': 2,
              'ARK3': 3}
LAMBDAS = np.random.default_rng(8).uniform(-4, 0, 16) + 1j * np.random.default_rng(9).uniform(-4, 4, 16)


def _run(pkg, problem_class, problem_params, sweeper_class, dt, Tend, controllers=None, level=None):
    if pkg is pysdc_tpu_torch:
        problem_params = dict(problem_params, device='cpu')
    desc = dict(problem_class=problem_class, problem_params=problem_params, sweeper_class=sweeper_class,
                sweeper_params={}, level_params=dict(dt=dt, **(level or {})), step_params=dict(maxiter=1),
                convergence_controllers=controllers or {})
    ctrl = pkg.ControllerNonMPI(1, {'logger_level': 40}, desc)
    prob = ctrl.MS[0].levels[0].prob
    uend, stats = ctrl.run(prob.u_exact(0.0), 0.0, Tend)
    return np.asarray(to_numpy(uend)), stats, prob


def _error(sweeper_class, problem_class, problem_params, dt, Tend):
    uend, _, prob = _run(pysdc_tpu_torch, problem_class, problem_params, sweeper_class, dt, Tend)
    return float(np.abs(uend - to_numpy(prob.u_exact(Tend))).max())


def _order(errs, dts):
    return float(np.median([np.log(errs[i] / errs[i + 1]) / np.log(dts[i] / dts[i + 1]) for i in range(len(errs) - 1)]))


# -- the tables ------------------------------------------------------------
@pytest.mark.parametrize('name', TABLEAUS)
def test_tableau_equals_jax(name):
    ours, theirs = getattr(rk, name), getattr(jrk, name)
    for attr in ('nodes', 'weights', 'matrix'):
        np.testing.assert_array_equal(np.asarray(getattr(ours, attr)), np.asarray(getattr(theirs, attr)), err_msg=attr)
    a, b = ours({}).coll, theirs({}).coll
    for attr in ('nodes', 'weights', 'Qmat', 'delta_m'):
        np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr), err_msg=attr)
    assert (a.num_nodes, a.right_is_node, a.implicit, a.globally_stiffly_accurate) == \
           (b.num_nodes, b.right_is_node, b.implicit, b.globally_stiffly_accurate)
    assert ours.is_embedded() == theirs.is_embedded()
    if ours.is_embedded():
        assert ours.get_update_order() == theirs.get_update_order()
    else:
        with pytest.raises(NotImplementedError, match='update order'):
            ours.get_update_order()
    if name in IMEX_TABLEAUS:
        before = ours.weights_explicit
        sweep = ours({})
        jsweep = theirs({})
        np.testing.assert_array_equal(sweep.QE, jsweep.QE)
        np.testing.assert_array_equal(sweep.coll_explicit.weights, jsweep.coll_explicit.weights)
        assert ours.weights_explicit is before  # construction leaves the class as it was


def test_the_port_has_every_tableau_of_the_jax_package():
    theirs = sorted(name for name, cls in vars(jrk).items()
                    if inspect.isclass(cls) and issubclass(cls, jrk.RungeKutta) and cls.__module__ == jrk.__name__
                    and cls not in (jrk.RungeKutta, jrk.RungeKuttaIMEX))
    assert TABLEAUS == theirs and len(TABLEAUS) == 27


def test_tableau_validation():
    with pytest.raises(ParameterError):
        rk.ButcherTableau(np.array([1.0]), np.array([0.0]), np.array([[0.0, 1.0], [0.0, 0.0]]))
    with pytest.raises(ParameterError):
        rk.ButcherTableau(np.array([0.5, 0.5]), np.array([0.0, 1.0]), np.array([[0.0, 0.5], [0.5, 0.0]]))
    with pytest.raises(ParameterError):
        rk.ButcherTableauEmbedded(np.array([0.5, 0.5]), np.array([0.0, 1.0]), np.array([[0.0, 0.0], [1.0, 0.0]]))


def test_level_overrides_restol_for_direct_solvers(caplog):
    prob = todes.Logistic(device='cpu')
    with caplog.at_level(logging.WARNING, logger='level'):
        lvl = Level(prob, rk.RK4({}), dict(dt=0.1, restol=1e-10))
    assert lvl.params.restol == -1.0 and 'direct' in caplog.text
    assert not lvl.host_stateful and lvl.uend_secondary is None


# -- orders on the port alone --------------------------------------------------
@pytest.mark.parametrize('name', sorted(ORDER))
def test_rk_order_nonlinear(name):
    """Order on the (nonlinear) logistic equation, as tests/test_runge_kutta.py gates it."""
    dt0 = 0.05 if name == 'DIRK43_2' else 0.2
    dts = [dt0 / 2**i for i in range(4)]
    errs = [_error(getattr(rk, name), todes.Logistic, dict(u0=0.5, lam=2.0, newton_tol=1e-14), dt, 1.0) for dt in dts]
    assert _order(errs, dts) > ORDER[name] - 0.35, (name, errs)


@pytest.mark.parametrize('name', sorted(IMEX_ORDER))
def test_rk_imex_order(name):
    dts = [0.25 / 2**i for i in range(4)]
    params = dict(lambdas_implicit=np.array([-1.0]), lambdas_explicit=np.array([0.5]))
    errs = [_error(getattr(rk, name), tdahl.DahlquistIMEX, params, dt, 1.0) for dt in dts]
    assert _order(errs, dts) > IMEX_ORDER[name] - 0.35, (name, errs)


@pytest.mark.parametrize('name, local', [('Heun_Euler', 2), ('Cash_Karp', 5), ('ARK324L2SAESDIRK', 3), ('ESDIRK43', 4)])
def test_embedded_secondary_has_lower_order(name, local):
    """The embedded update converges at its own (lower) order: local error order = embedded order + 1."""
    errs, dts = [], [0.2, 0.1, 0.05]
    for dt in dts:
        prob = todes.Logistic(u0=0.5, lam=2.0, newton_tol=1e-14, device='cpu')
        lvl = Level(prob, getattr(rk, name)({}), dict(dt=dt))
        lvl.status.time = 0.0
        lvl.predict(prob.u_exact(0.0))
        lvl.update_nodes()
        lvl.compute_end_point()
        errs.append(float((lvl.uend_secondary - prob.u_exact(dt)).abs().max()))
    assert _order(errs, dts) > local - 0.6, errs


def test_stability_on_stiff_dahlquist():
    """L-stable methods damp a very stiff lambda; EDIRK4 (A-stable only) more slowly."""
    for name in ('BackwardEuler', 'ARK324L2SAESDIRK', 'ESDIRK43', 'DIRK43_2', 'ESDIRK53', 'DIRK43',
                 'ARK548L2SAESDIRK', 'ARK548L2SAESDIRK2'):
        assert _error(getattr(rk, name), tdahl.Dahlquist, dict(lambdas=np.array([-1e6])), 0.1, 1.0) < 1e-3, name
    assert _error(rk.EDIRK4, tdahl.Dahlquist, dict(lambdas=np.array([-1e6])), 0.1, 1.0) < 0.1


# -- against live JAX runs ---------------------------------------------------------
@pytest.mark.parametrize('name', TABLEAUS)
def test_tableau_on_dahlquist_matches_jax(name):
    """16 complex lambdas in the left half-plane, complex128; the IMEX pairs on DahlquistIMEX."""
    if name in IMEX_TABLEAUS:
        params = dict(lambdas_implicit=LAMBDAS, lambdas_explicit=0.25j * np.ones(16))
        jcls, tcls = jdahl.DahlquistIMEX, tdahl.DahlquistIMEX
    else:
        params = dict(lambdas=LAMBDAS)
        jcls, tcls = jdahl.Dahlquist, tdahl.Dahlquist
    want, _, _ = _run(pysdc_tpu, jcls, params, getattr(jrk, name), 0.1, 0.3)
    got, _, prob = _run(pysdc_tpu_torch, tcls, params, getattr(rk, name), 0.1, 0.3)
    assert prob.dtype == torch.complex128 and got.dtype == np.complex128
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    assert np.abs(got - 1).max() > 1e-2  # the state moved


@pytest.mark.parametrize('name, jcls, tcls, steps, bound', [
    # HeatND's u_exact takes the discrete eigenvalue: the time error alone; HeatNDForced's is the continuous
    # solution, 4.7e-4 away at 32^2 by the space error
    ('ESDIRK43', jheat.HeatND, theat.HeatND, 4, 1e-6),
    ('ARK548L2SA', jheat.HeatNDForced, theat.HeatNDForced, 2, 1e-3),
])
def test_heat_matches_jax(name, jcls, tcls, steps, bound):
    params = dict(nvars=(32, 32), nu=0.1, freq=2, bc='periodic')
    want, _, _ = _run(pysdc_tpu, jcls, params, getattr(jrk, name), 0.01, steps * 0.01)
    got, _, prob = _run(pysdc_tpu_torch, tcls, params, getattr(rk, name), 0.01, steps * 0.01)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    assert np.abs(got - to_numpy(prob.u_exact(steps * 0.01))).max() < bound


ADAPTIVE = {
    # ESDIRK43 with AdaptivityRK on HeatND 32^2 (15 steps, one restart in the JAX package)
    'esdirk43-heat': ((jheat.HeatND, theat.HeatND), dict(nvars=(32, 32), nu=0.1, freq=2, bc='periodic'),
                      'ESDIRK43', dict(e_tol=1e-7, update_order=4), 0.01, 0.1),
    # Cash-Karp on VanDerPol (tests/test_fused.py:363)
    'cash-karp-vdp': ((jodes.VanDerPol, todes.VanDerPol), dict(mu=5.0, u0=(2.0, 0.0), newton_tol=1e-10),
                      'Cash_Karp', dict(e_tol=1e-7, update_order=5), 1e-2, 0.3),
}


# The estimate is the gap between two end points of size 1 that the packages contract in other orders (1e-16
# apart): on a gap of 1e-7 to 1e-8 that is 1e-9 of it, and 2e-10 to 5e-9 of the accepted dt (measured)
DT_RTOL = 1e-8


@pytest.mark.parametrize('name', sorted(ADAPTIVE))
def test_adaptivity_rk_stage_machine_matches_jax(name):
    (jcls, tcls), params, tableau, ad, dt, Tend = ADAPTIVE[name]
    level = dict(restol=-1.0)
    want_u, want, _ = _run(pysdc_tpu, jcls, params, getattr(jrk, tableau), dt, Tend, {JaxAdaptivityRK: ad}, level)
    got_u, got, _ = _run(pysdc_tpu_torch, tcls, params, getattr(rk, tableau), dt, Tend, {AdaptivityRK: ad}, level)
    key = lambda k: (k.type, k.process, round(k.time, 9), k.level, k.iter, k.sweep, k.num_restarts)  # noqa: E731
    theirs = {key(k): v for k, v in want.items() if not k.type.startswith('timing')}
    ours = {key(k): v for k, v in got.items() if not k.type.startswith('timing')}
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        if k[0] in ('niter', 'restart'):
            assert ours[k] == v, k
        else:
            assert np.isclose(ours[k], v, rtol=DT_RTOL if k[0] == 'dt' else 1e-6, atol=1e-11), (k, ours[k], v)
    np.testing.assert_allclose(got_u, want_u, rtol=0, atol=1e-9)
    dts = [v for _, v in pysdc_tpu_torch.get_sorted(got, type='dt')]
    assert len(set(np.round(dts, 12))) > 3  # the run adapts
    if name == 'esdirk43-heat':
        assert len(dts) == 15 and sum(v for _, v in pysdc_tpu_torch.get_sorted(got, type='restart')) == 1


def test_embedded_estimate_registers_no_store_uold():
    """For a Runge-Kutta sweeper the estimate reads the two weight rows: no StoreUOld, as in the JAX package."""
    desc = dict(problem_class=todes.VanDerPol, problem_params=dict(device='cpu'), sweeper_class=rk.Cash_Karp,
                sweeper_params={}, level_params=dict(dt=1e-2, restol=-1.0), step_params=dict(maxiter=1),
                convergence_controllers={AdaptivityRK: dict(e_tol=1e-7)})
    ctrl = pysdc_tpu_torch.ControllerNonMPI(1, {'logger_level': 40}, desc)
    names = [type(C).__name__ for C in ctrl.ordered_convergence_controllers()]
    assert 'StoreUOld' not in names and 'EstimateEmbeddedError' in names
    est = next(C for C in ctrl.convergence_controllers if type(C).__name__ == 'EstimateEmbeddedError')
    assert est.params.sweeper_type == 'RK'
    assert next(C for C in ctrl.convergence_controllers if type(C) is AdaptivityRK).params.update_order == 5
