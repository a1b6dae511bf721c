"""IMEX in the PyTorch port against the JAX package (float64, CPU).

``IMEXSweeper``, ``HeatNDForced`` and ``VarCoeffDiffusionForced1D``: the same
inputs, made from a seed with numpy, go through the JAX function and its
counterpart in the port.  Sweeper states agree to 1e-12 relative to the
field's size; end to end the ``niter`` lists are equal, ``uend`` agrees to
1e-10 and the stats keys are the same, against a live ``pysdc_tpu`` run.
"""

import functools

import numpy as np
import pytest

import pysdc_tpu
import pysdc_tpu_torch
from pysdc_tpu.models import heat as jax_heat, var_diffusion as jax_var
from pysdc_tpu_torch.models import heat as torch_heat, var_diffusion as torch_var
from pysdc_tpu_torch.utils.convert import state_to_numpy, state_to_torch, to_numpy, to_torch


def _coeff(x):
    return 1.0 + 0.8 * np.sin(2 * np.pi * x)


# name -> (module pair, class name, problem params)
PROBLEMS = {
    'heat2d-periodic': ((jax_heat, torch_heat), 'HeatNDForced', dict(nvars=(16, 16), nu=0.1, freq=2, bc='periodic')),
    'heat1d-dirichlet': ((jax_heat, torch_heat), 'HeatNDForced', dict(nvars=31, nu=0.1, freq=4, bc='dirichlet-zero')),
    'varcoeff1d': ((jax_var, torch_var), 'VarCoeffDiffusionForced1D', dict(nvars=31, coeff_fn=_coeff, freq=2)),
}


def _problems(name):
    (jmod, tmod), cls, params = PROBLEMS[name]
    return getattr(jmod, cls)(**params), getattr(tmod, cls)(**params, device='cpu')


def _states_close(tstate, jstate, tol=1e-12):
    got, want = state_to_numpy(tstate), state_to_numpy(jstate)
    for g, w in zip((got.u, *got.f, got.tau), (want.u, *want.f, want.tau)):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize('qd', ['IE', 'LU', 'MIN-SR-S', 'MIN-SR-FLEX'])
def test_explicit_and_implicit_tables_equal_jax(qd):
    params = dict(num_nodes=3, quad_type='RADAU-RIGHT', QI=qd, QE='PIC' if qd.startswith('MIN') else 'EE')
    jsw, tsw = pysdc_tpu.IMEXSweeper(params), pysdc_tpu_torch.IMEXSweeper(params)
    np.testing.assert_allclose(tsw.QE, jsw.QE, rtol=0, atol=1e-14)
    np.testing.assert_allclose(tsw.QI, jsw.QI, rtol=0, atol=1e-14)
    assert tsw.parallelizable == jsw.parallelizable == qd.startswith('MIN')
    assert tsw.k_dependent == jsw.k_dependent == (qd == 'MIN-SR-FLEX')
    for k in (0, 1, 2):
        for got, want in zip(tsw._coeffs(k), jsw._coeffs(k)):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    with pytest.raises(ValueError, match='explicit QDelta'):
        tsw.get_Qdelta_explicit('LU')


@pytest.mark.parametrize('problem', list(PROBLEMS))
def test_forced_problems_match_jax(problem):
    """eval_f, eval_f_batched (one time per node), solve_system and u_exact."""
    jprob, tprob = _problems(problem)
    assert tprob.f_kind == 'imex' and getattr(tprob, 'diagonalizable_operator', None) is None
    rng = np.random.default_rng(2)
    u = rng.standard_normal((3,) + jprob.shape)
    ts = np.array([0.1, 0.25, 0.4])
    jf, tf = jprob.eval_f(np.asarray(u[0]), 0.3), tprob.eval_f(to_torch(u[0], 'cpu'), 0.3)
    before = tprob.work_counters['rhs'].niter
    jfb, tfb = jprob.eval_f_batched(np.asarray(u), ts), tprob.eval_f_batched(to_torch(u, 'cpu'), ts)
    assert tprob.work_counters['rhs'].niter == before  # an evaluation ticks nothing: the level counts a sweep
    for got, want in ((tf, jf), (tfb, jfb)):
        assert type(got).__name__ == 'IMEX'
        for g, w in zip(got, want):
            np.testing.assert_allclose(to_numpy(g), np.asarray(w), rtol=0, atol=1e-12 * max(1.0, np.abs(w).max()))
    np.testing.assert_allclose(to_numpy(tprob.solve_system(to_torch(u[0], 'cpu'), 0.02, None, 0.3)),
                               np.asarray(jprob.solve_system(np.asarray(u[0]), 0.02, None, 0.3)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(to_numpy(tprob.u_exact(0.7)), np.asarray(jprob.u_exact(0.7)), rtol=0, atol=1e-14)


# name -> sweeper params: the sequential Gauss-Seidel branch, the diagonal
# (batched) branch with zero QE, and sweep-dependent coefficients
BRANCHES = {
    'sequential-IE-EE': dict(QI='IE', QE='EE'),
    'sequential-LU-EE': dict(QI='LU', QE='EE'),
    'diagonal-MIN-SR-S-PIC': dict(QI='MIN-SR-S', QE='PIC'),
    'diagonal-MIN-SR-FLEX-PIC': dict(QI='MIN-SR-FLEX', QE='PIC'),
    'sequential-LU-PIC': dict(QI='LU', QE='PIC'),
}


@pytest.mark.parametrize('problem', ['heat2d-periodic', 'varcoeff1d'])
@pytest.mark.parametrize('branch', list(BRANCHES))
def test_imex_sweeper_states_match_jax(branch, problem):
    """predict, three sweeps (k = 1, 2, 3 as the level counts them) and the
    residual from the same seeded u0, 1e-12."""
    jprob, tprob = _problems(problem)
    params = dict(num_nodes=3, quad_type='RADAU-RIGHT', **BRANCHES[branch])
    jsw, tsw = pysdc_tpu.IMEXSweeper(params), pysdc_tpu_torch.IMEXSweeper(params)
    u0 = np.random.default_rng(4).standard_normal(jprob.shape)
    t, dt = 0.2, 0.02
    jstate = jsw.predict(jprob, np.asarray(u0), t, dt)
    tstate = tsw.predict(tprob, to_torch(u0, 'cpu'), t, dt)
    _states_close(tstate, jstate)
    for k in (1, 2, 3):
        jstate = jsw.update_nodes(jprob, jstate, t, dt, k)
        tstate = tsw.update_nodes(tprob, state_to_torch(state_to_numpy(tstate), 'cpu'), t, dt, k)
        _states_close(tstate, jstate)
    _, jres = jsw.compute_residual(jstate, dt)
    _, tres = tsw.compute_residual(tstate, dt)
    np.testing.assert_allclose(tres.item(), float(jres), rtol=1e-8, atol=1e-13)


def test_imex_sweeper_routes_the_node_index():
    """With prepared per-node factorizations the sweeper passes ``node=m``."""
    from pysdc_tpu_torch.core.level import Level

    prob = torch_var.VarCoeffDiffusionForced1D(nvars=31, coeff_fn=_coeff, device='cpu')
    sweep = pysdc_tpu_torch.IMEXSweeper(dict(num_nodes=3, QI='LU'))
    lvl = Level(prob, sweep, dict(dt=0.05))
    lvl.status.time = 0.0
    seen = []
    solve = prob.solve_system
    prob.solve_system = lambda rhs, factor, u0, t, node=None: (seen.append(node), solve(rhs, factor, u0, t, node=node))[1]
    lvl.predict(prob.u_exact(0.0))
    lvl.update_nodes()
    assert seen == ([0, 1, 2] if prob.accepts_node_index else [None] * 3)


# name -> (problem, sweeper params, level params, maxiter, t0, Tend)
RUNS = {
    # tutorial step 2 (tests/test_controllers.py:20-37)
    'step2': ('heat1d-step2', dict(num_nodes=3, quad_type='RADAU-RIGHT'), dict(restol=1e-10, dt=0.1), 20, 0.1, 0.3),
    # its M=5 LU variant (tests/test_golden_regression.py:44-62)
    'step2-M5-LU': ('heat1d-step2', dict(num_nodes=5, quad_type='RADAU-RIGHT', QI='LU'), dict(restol=1e-10, dt=0.1),
                    20, 0.0, 0.4),
    'heat2d-diagonal': ('heat2d-periodic', dict(num_nodes=3, QI='MIN-SR-S', QE='PIC'), dict(restol=1e-9, dt=0.05),
                        40, 0.0, 0.1),
    'varcoeff-dt0.1': ('varcoeff-order', dict(num_nodes=3, quad_type='RADAU-RIGHT', QI='LU'),
                       dict(restol=1e-11, dt=0.1), 40, 0.0, 0.4),
    'varcoeff-dt0.05': ('varcoeff-order', dict(num_nodes=3, quad_type='RADAU-RIGHT', QI='LU'),
                        dict(restol=1e-11, dt=0.05), 40, 0.0, 0.4),
}
PROBLEMS['heat1d-step2'] = ((jax_heat, torch_heat), 'HeatNDForced',
                            dict(nvars=1023, nu=0.1, freq=4, bc='dirichlet-zero'))
PROBLEMS['varcoeff-order'] = ((jax_var, torch_var), 'VarCoeffDiffusionForced1D',
                              dict(nvars=63, coeff_fn=_coeff, freq=2))


@functools.lru_cache(maxsize=None)
def _run(package, name):
    problem, sweeper_params, level_params, maxiter, t0, Tend = RUNS[name]
    (jmod, tmod), cls, params = PROBLEMS[problem]
    pkg, mod, device = (pysdc_tpu, jmod, {}) if package == 'jax' else (pysdc_tpu_torch, tmod, dict(device='cpu'))
    desc = dict(
        problem_class=getattr(mod, cls),
        problem_params=dict(params, **device),
        sweeper_class=pkg.IMEXSweeper,
        sweeper_params=sweeper_params,
        level_params=level_params,
        step_params=dict(maxiter=maxiter),
    )
    ctrl = pkg.ControllerNonMPI(1, {'logger_level': 40}, desc)
    prob = ctrl.MS[0].levels[0].prob
    uend, stats = ctrl.run(prob.u_exact(t0), t0, Tend)
    return dict(
        uend=np.asarray(to_numpy(uend)),
        err=float(np.abs(to_numpy(uend) - to_numpy(prob.u_exact(Tend))).max()),
        niter=[v for _, v in pkg.get_sorted(stats, type='niter', sortby='time')],
        keys=sorted((k.type, k.level, k.iter, round(k.time, 12)) for k in stats),
    )


@pytest.mark.parametrize('name', list(RUNS))
def test_imex_controller_matches_live_jax_run(name):
    want, got = _run('jax', name), _run('torch', name)
    assert got['niter'] == want['niter']
    assert all(k < RUNS[name][3] for k in got['niter'])
    np.testing.assert_allclose(got['uend'], want['uend'], rtol=0, atol=1e-10)
    assert got['keys'] == want['keys']


@pytest.mark.parametrize('name', ['step2', 'step2-M5-LU'])
def test_tutorial_step2_error_gate(name):
    """err < 2e-5 (reference tutorial step 2), for the port on its own."""
    assert _run('torch', name)['err'] < 2e-5


def test_var_diffusion_forced_sdc_order():
    """The discrete forcing makes the semi-discrete solution exact, so the
    error is pure time error and must drop with dt at the collocation order
    (tests/test_sparse.py::test_var_diffusion_sdc_order)."""
    errs = [_run('torch', 'varcoeff-dt0.1')['err'], _run('torch', 'varcoeff-dt0.05')['err']]
    assert errs[1] < errs[0] / 4
    assert errs[1] < 1e-6
