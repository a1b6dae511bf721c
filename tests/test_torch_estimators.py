"""The error estimators and adaptivity flavours of the PyTorch port against
live runs of the JAX package (float64, CPU).

Each configuration runs once through ``pysdc_tpu.ControllerNonMPI`` and once
through the port's (cached runs shared by the cases of this file; the other
``test_torch_*`` files of this slice import :func:`run` and
:func:`assert_same_run` from here).  Both start from the same numpy-made
initial value.  Gates: equal ``niter`` and ``restart`` per step and equal
step counts; ``dt`` to 1e-12 relative; every estimate a run logs, and every
status value a probe hook reads after each iteration, to 1e-10 relative above
a floor of 1e-13 ``max |u|``; ``uend`` to 1e-12 (relative to ``max |u|``); the
same stats types, each with values of the same kind.  The floor is the
rounding of the estimates themselves: an estimate is a difference of fields of
size ``max |u|`` that cancel (the extrapolation estimate of a 64-point heat run
is 5e-7 of ``max |u| = 1``), so the two packages' different summation orders
leave it a few ``eps max |u|`` apart (3e-16 there, 6e-10 relative); the
extrapolation weights (up to 20) and its prefactor multiply that by up to
100 (1.5e-14 in the Hot Rod run of ``test_torch_resilience.py``).
The estimators' host-side weight builders are held entry by entry.
"""

import functools
import importlib
import numbers
from unittest import mock

import numpy as np
import pytest
import torch

import pysdc_tpu
import pysdc_tpu.convergence as jconv
import pysdc_tpu_torch
import pysdc_tpu_torch.convergence as tconv
import pysdc_tpu_torch.models as tmodels
import pysdc_tpu_torch.ops.linop as tlinop
from pysdc_tpu.core.hooks import Hooks as JaxHooks
from pysdc_tpu.hooks import logging_hooks as jhooks
from pysdc_tpu.models import dae_problems as jdae_models
from pysdc_tpu.models import heat as jheat
from pysdc_tpu.models import odes as jodes
from pysdc_tpu.models import power_electronics as jpower
from pysdc_tpu.resilience import fault_injection as jfaults
from pysdc_tpu.sweepers import dae as jdae
from pysdc_tpu.sweepers.imex import IMEXSweeper as JaxIMEX
from pysdc_tpu_torch.core.errors import ConvergenceError, ParameterError
from pysdc_tpu_torch.core.hooks import Hooks as TorchHooks
from pysdc_tpu_torch.hooks import logging_hooks as thooks
from pysdc_tpu_torch.resilience import fault_injection as tfaults
from pysdc_tpu_torch.sweepers import dae as tdae
from pysdc_tpu_torch.utils.convert import fault_to_torch, to_numpy, to_torch

# small fields: one thread is fastest, and test workers with thread pools each oversubscribe the cores
torch.set_num_threads(1)

_JAX_MODELS = {
    'HeatND': jheat.HeatND, 'HeatNDForced': jheat.HeatNDForced, 'VanDerPol': jodes.VanDerPol,
    'DiscontinuousTestODE': jodes.DiscontinuousTestODE, 'DiscontinuousTestDAE': jdae_models.DiscontinuousTestDAE,
    'Battery': jpower.Battery, 'BatteryNCapacitors': jpower.BatteryNCapacitors, 'Piline': jpower.Piline,
    'BuckConverter': jpower.BuckConverter,
}
_SWEEPERS = {
    'implicit': (pysdc_tpu.GenericImplicit, pysdc_tpu_torch.GenericImplicit),
    'imex': (JaxIMEX, pysdc_tpu_torch.IMEXSweeper),
    'dae': (jdae.FullyImplicitDAE, tdae.FullyImplicitDAE),
}
#: status values a probe hook reads after every iteration (those a level has)
PROBED = ('error_embedded_estimate', 'error_extrapolation_estimate', 'contraction_factor', 'iter_to_convergence',
          'diff_old_loc', 'error_embedded_estimate_collocation', 'order_embedded_estimate')


def spec(problem, controllers, problem_params=None, sweeper='implicit', num_nodes=3, QI='LU', dt=0.1,
         restol=-1.0, maxiter=5, Tend=1.0, t0=0.0, hooks=(), num_procs=1, controller_params=None, faults=(),
         tol=None, eigen_tables=False, **sweeper_params):
    """One run: the problem and its parameters, the sweeper, the convergence controllers by class name with
    their parameters, logging hooks by class name and faults (``Fault`` fields) to inject; ``tol`` the
    tolerances of :func:`assert_same_run` where they differ from its defaults; ``eigen_tables``: the port's
    order-2 Dirichlet axes take the dense eigen product of numpy's ``eigh`` tables, as the JAX package's do,
    in place of the sine transform (:func:`build`)."""
    return dict(problem=problem, problem_params=problem_params or {}, sweeper=sweeper,
                sweeper_params=dict(num_nodes=num_nodes, QI=QI, **sweeper_params),
                level_params=dict(dt=dt, restol=restol), maxiter=maxiter, controllers=controllers, Tend=Tend,
                t0=t0, hooks=tuple(hooks), num_procs=num_procs, controller_params=controller_params or {},
                faults=tuple(faults), tol=tol or {}, eigen_tables=eigen_tables)


def heat(controllers, **kw):
    """HeatND 1D 64 periodic of tests/test_estimators_resilience.py:23-32."""
    return spec('HeatND', controllers, dict(nvars=64, nu=0.1, freq=2, bc='periodic'), **kw)


def vdp(controllers, **kw):
    return spec('VanDerPol', controllers, dict(mu=5.0, u0=(2.0, 0.0), newton_tol=1e-11), **kw)


def forced(controllers, **kw):
    """The forced heat equation of tests/test_convergence_controllers.py:128-175, at 63 points."""
    return spec('HeatNDForced', controllers, dict(nu=0.1, freq=4, nvars=63, bc='dirichlet-zero'), sweeper='imex',
                quad_type='RADAU-RIGHT', **kw)


#: runs whose dt is chosen from an estimate of about 1e-7 max |u|: the estimate's rounding floor (module
#: docstring) is 1e-8 of it, which moves dt by 1e-8 / order and the step ends, node values and ``uend`` with it
ESTIMATE_DRIVEN = dict(dt=1e-8, uend=1e-9)

RUNS = {
    'extrapolation': heat({'EstimateExtrapolationErrorNonMPI': {'no_storage': False}},
                          hooks=('LogExtrapolationErrorEstimate', 'LogLocalErrorPostStep')),
    'polynomial': heat({'EstimatePolynomialError': {}}, maxiter=14, dt=0.2, restol=1e-11, Tend=0.4),
    'contraction': heat({'EstimateContractionFactor': {'e_tol': 1e-10}}, Tend=0.3),
    'iteration-estimator': heat({'CheckIterationEstimatorNonMPI': {'errtol': 1e-8}}, dt=0.05, maxiter=50,
                                Tend=0.2),
    'within-q': vdp({'EstimateExtrapolationErrorWithinQ': {}}, dt=1e-2, restol=1e-10, maxiter=30, Tend=0.05),
    'adaptivity-residual': vdp({'AdaptivityResidual': {'e_tol': 1e-5, 'max_restol': 1e-9}}, dt=2e-2, maxiter=4,
                               Tend=0.3),
    'adaptivity-polynomial': heat({'AdaptivityPolynomialError': {'e_tol': 1e-7}}, dt=0.05, restol=1e-9,
                                  maxiter=30, Tend=0.5, hooks=('LogGlobalErrorPostStep',), tol=ESTIMATE_DRIVEN),
    'adaptivity-within-q': vdp({'AdaptivityExtrapolationWithinQ': {'e_tol': 1e-6}}, dt=1e-2, restol=1e-10,
                               maxiter=30, Tend=0.3, tol=ESTIMATE_DRIVEN),
    'adaptivity-collocation': forced({'AdaptivityCollocation': {'e_tol': 1e-7,
                                                                'adaptive_coll_params': {'num_nodes': [2, 3]}}},
                                     dt=0.05, restol=1e-9, maxiter=60, Tend=0.2, tol=ESTIMATE_DRIVEN,
                                     eigen_tables=True),
    'adaptive-collocation': forced({'AdaptiveCollocation': {'num_nodes': [2, 4], 'restol': [1e-7, 1e-9]}},
                                   dt=0.1, restol=1e-9, maxiter=50, Tend=0.3),
    'interpolate-between-restarts': heat({'Adaptivity': {'e_tol': 1e-5}, 'InterpolateBetweenRestarts': {}},
                                         dt=0.5, maxiter=4, Tend=0.5, tol=ESTIMATE_DRIVEN),
}


def _probe(base):
    class Probe(base):
        """Reads :data:`PROBED` off the finest level after each iteration."""

        def post_iteration(self, step, level_number):
            super().post_iteration(step, level_number)
            status = step.levels[level_number].status
            for name in PROBED:
                value = getattr(status, name, None)
                if value is not None:
                    value = tuple(float(v) for v in value) if isinstance(value, tuple) else float(value)
                    self.add_to_stats(process=step.status.slot, time=step.levels[level_number].time,
                                      level=level_number, iter=step.status.iter, sweep=0, type=f'probe_{name}',
                                      value=value)

    return Probe


_PROBES = {'jax': _probe(JaxHooks), 'torch': _probe(TorchHooks)}


def _controller(conv, name):
    """A convergence controller by name: from the registry, or ``Compression`` from its own module."""
    if hasattr(conv, name):
        return getattr(conv, name)
    return getattr(importlib.import_module(conv.__name__ + '.compression'), name)


def build(package, run_spec):
    """(package module, controller, problem) for ``run_spec`` with the classes of ``package`` ('jax' or 'torch');
    the port runs on the CPU."""
    jax_side = package == 'jax'
    pkg = pysdc_tpu if jax_side else pysdc_tpu_torch
    conv = jconv if jax_side else tconv
    hooks_mod = jhooks if jax_side else thooks
    name = run_spec['problem']
    problem = _JAX_MODELS[name] if jax_side else getattr(tmodels, name)
    params = dict(run_spec['problem_params'])
    if not jax_side:
        params['device'] = 'cpu'
    desc = dict(
        problem_class=problem, problem_params=params,
        sweeper_class=_SWEEPERS[run_spec['sweeper']][0 if jax_side else 1],
        sweeper_params=dict(run_spec['sweeper_params']), level_params=dict(run_spec['level_params']),
        step_params=dict(maxiter=run_spec['maxiter']),
        convergence_controllers={_controller(conv, key): dict(val) for key, val in run_spec['controllers'].items()},
    )
    hooks = [getattr(hooks_mod, h) for h in run_spec['hooks']] + [_PROBES[package]]
    make = functools.partial(pkg.ControllerNonMPI, run_spec['num_procs'],
                             {'logger_level': 40, 'hook_class': hooks, **run_spec['controller_params']}, desc)
    if jax_side or not run_spec.get('eigen_tables'):
        ctrl = make()
    else:
        # the JAX package solves an order-2 Dirichlet axis by dense products of LAPACK's eigh tables, whose own
        # rounding (3e-15 - 1e-14 of a solve at 63 points) an estimate-driven dt amplifies to 1.17e-8 against the
        # port's exact sine transform; such a run holds the estimators with the same tables on both sides, and
        # tests/test_torch_linop_sine.py holds the sine transform against eigh
        with mock.patch.object(tlinop, 'second_difference_scale', lambda A1: None):
            ctrl = make()
    return pkg, ctrl, ctrl.MS[0].levels[0].prob


def execute(package, run_spec):
    """Run ``run_spec`` once with ``package`` from the numpy initial value; returns a summary dict."""
    pkg, ctrl, prob = build(package, run_spec)
    injector = None
    if run_spec['faults']:
        injector = (jfaults if package == 'jax' else tfaults).FaultInjector()
        for fields in run_spec['faults']:
            injector.add_fault(jfaults.Fault(**fields) if package == 'jax' else fault_to_torch(fields))
        ctrl.hooks.append(injector)
    t0 = run_spec['t0']
    u0 = np.asarray(to_numpy(prob.u_exact(t0)))
    u0 = u0 if package == 'jax' else to_torch(u0, 'cpu')
    uend, stats = ctrl.run(u0, t0, run_spec['Tend'])
    return dict(pkg=pkg, ctrl=ctrl, prob=prob, stats=stats, uend=np.asarray(to_numpy(uend)), injector=injector)


@functools.lru_cache(maxsize=None)
def run(package, name, runs_id=None):
    """The cached run ``name`` of ``RUNS`` (or of the dict registered under ``runs_id``)."""
    return execute(package, (REGISTRY[runs_id] if runs_id else RUNS)[name])


#: run tables of the other files of this slice, by id (they register theirs here to share the cache helpers)
REGISTRY = {}


def entries(result, kind):
    return [(round(float(t), 12), v) for t, v in result['pkg'].get_sorted(result['stats'], type=kind,
                                                                            recomputed=None)]


def _kind(value):
    if isinstance(value, (bool, numbers.Integral)):
        return 'int'
    if isinstance(value, numbers.Real):
        return 'float'
    if isinstance(value, np.ndarray):
        return 'array'
    return type(value).__name__


def _close(got, want, rtol, floor):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol, floor)
        return
    assert abs(got - want) <= rtol * abs(want) + floor, (got, want)


def assert_same_run(want, got, rtol=1e-10, dt=1e-12, uend=1e-12):
    """The gates of this slice's parity tests (module docstring): estimates to ``rtol``, ``dt`` and the times
    of the entries to ``dt`` relative, ``uend`` to ``uend`` relative to ``max |u|``."""
    scale = max(1.0, float(np.abs(want['uend']).max()))
    types = sorted({key.type for key in want['stats']})
    assert types == sorted({key.type for key in got['stats']})
    for kind in types:
        w, g = entries(want, kind), entries(got, kind)
        assert len(w) == len(g), kind
        assert {_kind(v) for _, v in w} == {_kind(v) for _, v in g}, kind
        np.testing.assert_allclose([t for t, _ in g], [t for t, _ in w], rtol=dt, atol=dt, err_msg=kind)
        if kind in ('niter', 'restart', 'k') or kind.startswith('work_'):
            assert [v for _, v in w] == [v for _, v in g], kind
        elif kind == 'dt':
            np.testing.assert_allclose([v for _, v in g], [v for _, v in w], rtol=dt, atol=0)
        elif 'estimate' in kind or kind.startswith('probe_') or kind.startswith('e_'):
            floor = 1e-13 * scale if dt <= 1e-12 else uend * scale
            for (_, gv), (_, wv) in zip(g, w):
                _close(gv, wv, rtol, floor)
    np.testing.assert_allclose(got['uend'], want['uend'], rtol=0, atol=uend * scale)


@pytest.mark.parametrize('name', list(RUNS))
def test_run_matches_jax(name):
    want, got = run('jax', name), run('torch', name)
    assert_same_run(want, got, **RUNS[name]['tol'])
    assert len(entries(got, 'niter')) >= 2


def test_estimators_report_what_they_estimate():
    """The runs above do what the JAX package's tests hold them to (tests/test_estimators_resilience.py,
    tests/test_convergence_controllers.py, tests/test_more_components.py), here on the port's runs."""
    ex = run('torch', 'extrapolation')
    local = dict(entries(ex, 'e_local_post_step'))
    est = entries(ex, 'error_extrapolation_estimate')
    assert len(est) >= 3 and all(v == pytest.approx(local[round(t + 0.1, 12)], rel=50) for t, v in est[1:])
    rhos = [v for _, v in entries(run('torch', 'contraction'), 'probe_contraction_factor')]
    assert rhos and np.median(rhos) < 0.5
    assert all(k < 10 for _, k in entries(run('torch', 'iteration-estimator'), 'niter'))
    for name in ('adaptivity-polynomial', 'adaptivity-within-q', 'adaptivity-collocation'):
        dts = [v for _, v in entries(run('torch', name), 'dt')]
        assert len(set(np.round(dts, 12))) > 1, name
    assert min(v for _, v in entries(run('torch', 'interpolate-between-restarts'), 'dt')) < 0.5


def test_adaptive_collocation_lands_on_the_last_rule():
    """Switching 2 -> 4 nodes mid-step lands on the 4-node collocation solution: the level's state, the
    sweeper's tables and the node count all follow the switch."""
    got = run('torch', 'adaptive-collocation')
    lvl = got['ctrl'].MS[0].levels[0]
    assert lvl.sweep.coll.num_nodes == 4 and lvl.state.u.shape[0] == 5
    four = spec('HeatNDForced', {}, dict(nu=0.1, freq=4, nvars=63, bc='dirichlet-zero'), sweeper='imex',
                quad_type='RADAU-RIGHT', num_nodes=4, dt=0.1, restol=1e-9, maxiter=50, Tend=0.3)
    assert np.abs(execute('torch', four)['uend'] - got['uend']).max() < 1e-8


def test_taylor_weights_match_jax():
    from pysdc_tpu.convergence.estimate_extrapolation_error import taylor_combination_weights as jweights
    from pysdc_tpu_torch.convergence.estimate_extrapolation_error import taylor_combination_weights as tweights

    rng = np.random.default_rng(5)
    for K, n in ((7, 4), (4, 4), (5, 3)):
        dts = rng.uniform(0.05, 0.2, n)
        times = np.cumsum(dts)
        t_eval = times[-1] + rng.uniform(0.05, 0.2)
        for got, want in zip(tweights(times, dts, t_eval, K, n), jweights(times, dts, t_eval, K, n)):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize('name, params, error', [
    ('EstimateExtrapolationErrorNonMPI', {}, ParameterError),
    ('HotRod', {}, ParameterError),
    ('AdaptivityPolynomialError', {}, ParameterError),
    ('AdaptivityExtrapolationWithinQ', {}, ParameterError),
    ('AdaptiveCollocation', {'num_nodes': [2, 3], 'QI': ['LU', 'IE']}, ParameterError),
])
def test_configuration_errors_match_jax(name, params, error):
    """What the JAX package refuses at set-up, the port refuses too."""
    run_spec = heat({name: params}, restol=1e-8)
    for package in ('jax', 'torch'):
        with pytest.raises(Exception) as info:
            build(package, run_spec)
        assert type(info.value).__name__ == error.__name__


def test_stop_at_nan_and_max_runtime():
    """StopAtNan raises once the solution leaves its bound, StopAtMaxRuntime once the budget is spent."""
    for name, params in (('StopAtNan', {'thresh': 0.5}), ('StopAtMaxRuntime', {'max_runtime': 0.0})):
        raised = []
        for package in ('jax', 'torch'):
            with pytest.raises(Exception) as info:
                execute(package, heat({name: params}, Tend=0.3))
            raised.append(type(info.value).__name__)
        assert raised == [ConvergenceError.__name__] * 2


@pytest.mark.parametrize('abs_bound', [1e-12, 1e-2])
def test_compression_matches_jax(abs_bound):
    """The quantizing round trip of tests/test_convergence_controllers.py:267, both packages, and a host
    compressor (numpy in and out) that equals the quantizer."""
    from pysdc_tpu_torch.convergence.compression import quantize_roundtrip

    run_spec = heat({'Compression': {'abs_bound': abs_bound}}, restol=1e-10, maxiter=20, Tend=0.3)
    assert_same_run(execute('jax', run_spec), execute('torch', run_spec))
    host = heat({'Compression': {'compressor': lambda u: np.round(u / (2 * abs_bound)) * 2 * abs_bound}},
                restol=1e-10, maxiter=20, Tend=0.3)
    assert_same_run(execute('jax', run_spec), execute('torch', host))
    u = torch.linspace(-1, 1, 11, dtype=torch.float64)
    assert float((quantize_roundtrip(u, abs_bound) - u).abs().max()) <= abs_bound
