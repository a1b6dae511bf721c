"""The logging and profiling hooks of the PyTorch port against the JAX
package's (float64, CPU).

``LogWork`` counts what the JAX package counts: M right-hand sides and M
solves (on the first of ``newton`` / ``CG`` / ``GMRES`` / ``linear`` the
problem registers) per sweep.  The one difference the JAX package keeps is
its trace-time ticks: a problem's ``eval_f`` / ``solve_system`` tick once
while a program is traced, so the first run of a controller counts a few more
(one per compiled program that evaluates).  The comparison is therefore made
on a second run of the same controller in the same process, once the JAX
programs are compiled: there every ``work_*`` entry is equal.

The other hooks (``LogSolutionAfterIteration``, the ``LogError`` family,
``LogSDCIterations``, ``LogExtrapolationErrorEstimate``) give the stats types
and value kinds of the JAX package's, with values to the tolerances of
:func:`tests.test_torch_estimators.assert_same_run`; ``LogToPickleFile``
writes the same files, ``PlotPostStep`` its figures, and ``ProfilerHook`` a
Chrome trace of the run.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from pysdc_tpu_torch.hooks import logging_hooks as thooks
from pysdc_tpu_torch.hooks.profiling import ProfilerHook
from pysdc_tpu_torch.utils.convert import to_numpy, to_torch
from test_torch_estimators import REGISTRY, assert_same_run, build, forced, heat, run, spec, vdp

torch.set_num_threads(1)

WORK_RUNS = {
    'heat': heat({}, restol=1e-10, maxiter=20, Tend=0.3, hooks=('LogWork', 'LogSDCIterations')),
    'heat-cg': spec('HeatND', {}, dict(nvars=32, nu=0.1, freq=2, bc='periodic', solver_type='CG', lintol=1e-13),
                    restol=1e-10, maxiter=20, Tend=0.2, hooks=('LogWork',)),
    'forced': forced({}, restol=1e-10, maxiter=20, Tend=0.2, hooks=('LogWork',)),
    'vdp': vdp({}, dt=0.05, restol=1e-10, maxiter=20, Tend=0.15, hooks=('LogWork',)),
    'battery': spec('Battery', {}, sweeper='imex', num_nodes=4, dt=0.01, restol=1e-12, maxiter=10, Tend=0.05,
                    hooks=('LogWork',)),
}
LOG_RUNS = {
    'errors': heat({}, restol=1e-10, maxiter=20, Tend=0.3,
                   hooks=('LogGlobalErrorPostStep', 'LogGlobalErrorPostIter', 'LogLocalErrorPostStep',
                          'LogLocalErrorPostIter', 'LogSolutionAfterIteration', 'LogSolution', 'LogSDCIterations')),
    'extrapolation': heat({'EstimateExtrapolationErrorNonMPI': {}}, Tend=0.8,
                          hooks=('LogExtrapolationErrorEstimate', 'LogStepSize', 'LogRestarts')),
}
REGISTRY['hooks'] = LOG_RUNS


def second_run(package, name):
    """The ``work_*`` entries and ``niter`` of a controller's second run."""
    pkg, ctrl, prob = build(package, WORK_RUNS[name])
    u0 = np.asarray(to_numpy(prob.u_exact(0.0)))
    u0 = u0 if package == 'jax' else to_torch(u0, 'cpu')
    counts = []
    for _ in range(2):
        _, stats = ctrl.run(u0, 0.0, WORK_RUNS[name]['Tend'])
        kinds = sorted({k.type for k in stats if k.type.startswith('work_')} | {'niter'})
        counts.append({kind: [v for _, v in pkg.get_sorted(stats, type=kind)] for kind in kinds})
    return counts, prob


@pytest.mark.parametrize('name', list(WORK_RUNS))
def test_log_work_matches_jax_on_the_second_run(name):
    (_, want), jprob = second_run('jax', name)
    (first, got), prob = second_run('torch', name)
    assert got == want and got == first  # the port counts no trace-time ticks: both of its runs are equal
    M = WORK_RUNS[name]['sweeper_params']['num_nodes']
    solver = next((key for key in ('newton', 'CG', 'GMRES', 'linear') if key in prob.work_counters), None)
    for kind in ['work_rhs'] + ([f'work_{solver}'] if solver else []):
        assert got[kind] == [M * k for k in got['niter']], kind
    assert sorted(prob.work_counters) == sorted(jprob.work_counters)


@pytest.mark.parametrize('name', list(LOG_RUNS))
def test_logging_hooks_match_jax(name):
    want, got = run('jax', name, 'hooks'), run('torch', name, 'hooks')
    assert_same_run(want, got)
    # the solutions each hook logged, matched by their entries (step, iteration)
    def solutions(result):
        return [v for key, v in sorted(((k, v) for k, v in result['stats'].items() if k.type == 'u'),
                                       key=lambda kv: (round(kv[0].time, 12), kv[0].iter))]

    w, g = solutions(want), solutions(got)
    assert len(w) == len(g) and (len(g) > 3) == (name == 'errors')
    for a, b in zip(g, w):
        assert isinstance(a, np.ndarray) and a.shape == np.shape(b)
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-12)


def test_log_to_pickle_file(tmp_path):
    """Every step's end point is pickled as the JAX package pickles it: ``{'t': float, 'u': numpy array}``."""
    from pysdc_tpu.hooks import logging_hooks as jhooks

    files = {}
    for package, module in (('jax', jhooks), ('torch', thooks)):
        hook = type('Pickles', (module.LogToPickleFile,), {'path': str(tmp_path / package), 'file_name': 'sol'})
        _, ctrl, prob = build(package, heat({}, restol=1e-10, maxiter=20, Tend=0.3))
        ctrl.hooks.append(hook())
        u0 = np.asarray(to_numpy(prob.u_exact(0.0)))
        ctrl.run(u0 if package == 'jax' else to_torch(u0, 'cpu'), 0.0, 0.3)
        files[package] = sorted(os.listdir(tmp_path / package))
    assert files['torch'] == files['jax'] and len(files['torch']) == 3
    for name in files['torch']:
        with open(tmp_path / 'torch' / name, 'rb') as fh:
            got = pickle.load(fh)
        with open(tmp_path / 'jax' / name, 'rb') as fh:
            want = pickle.load(fh)
        assert isinstance(got['u'], np.ndarray) and isinstance(got['t'], float) and got['t'] == want['t']
        np.testing.assert_allclose(got['u'], np.asarray(want['u']), rtol=0, atol=1e-12)


def test_plot_post_step(tmp_path):
    """One PNG a step; matplotlib is imported at the first plot, not with the module."""
    hook = type('Plots', (thooks.PlotPostStep,), {'save_plot': str(tmp_path / 'heat')})
    _, ctrl, prob = build('torch', heat({}, restol=1e-10, maxiter=20, Tend=0.2))
    ctrl.hooks.append(hook())
    ctrl.run(prob.u_exact(0.0), 0.0, 0.2)
    assert sorted(os.listdir(tmp_path)) == ['heat_000001.png', 'heat_000002.png']


def test_profiler_hook_writes_a_chrome_trace(tmp_path, monkeypatch):
    assert os.path.basename(ProfilerHook.trace_dir) == 'pysdc_tpu_torch_trace'  # the default names the port
    monkeypatch.setattr(ProfilerHook, 'trace_dir', str(tmp_path))
    _, ctrl, prob = build('torch', heat({}, restol=1e-10, maxiter=20, Tend=0.2))
    ctrl.hooks.append(ProfilerHook())
    uend, _ = ctrl.run(prob.u_exact(0.0), 0.0, 0.2)
    assert ProfilerHook._profiler is None and os.path.dirname(ProfilerHook.last_trace) == str(tmp_path)
    with open(ProfilerHook.last_trace) as fh:
        assert 'traceEvents' in fh.read(200_000)
    assert torch.isfinite(uend).all()
