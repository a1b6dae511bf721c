"""The first port slice as a whole: SDC on the heat equation through
``ControllerNonMPI``, the PyTorch port against the JAX package (float64, CPU).

For each description ``uend`` agrees to 1e-12 and the ``niter`` lists are
equal.  Residual stats agree to rtol 1e-8 above an absolute floor of 1e-13:
converged residuals sit near 1e-11, where the roundoff of an O(1) field
(about 1e-15) is already 1e-4 of the value.  The stats ``type`` sets are
equal.  Sweeper states are compared after ``predict`` and after sweeps,
fed the same numpy ``u0`` through ``pysdc_tpu_torch.utils.convert``.
"""

import functools

import numpy as np
import pytest
import torch

import pysdc_tpu
import pysdc_tpu_torch
from pysdc_tpu.models.heat import HeatND as JaxHeat
from pysdc_tpu_torch.models.heat import HeatND as TorchHeat
from pysdc_tpu_torch.utils.convert import state_to_numpy, state_to_torch, to_numpy, to_torch

# (problem_params, num_nodes, dt, Tend, num_procs)
CONFIGS = {
    'quickstart': (dict(nvars=64, nu=0.1, freq=2, bc='periodic'), 3, 0.1, 1.0, 1),
    'heat2d': (dict(nvars=(32, 32), nu=0.1, freq=2, bc='periodic'), 4, 0.01, 0.04, 1),
    'heat2d-2procs': (dict(nvars=(32, 32), nu=0.1, freq=2, bc='periodic'), 4, 0.01, 0.04, 2),
}


def _description(pkg, heat, problem_params, M, dt, **sweeper_params):
    return dict(
        problem_class=heat,
        problem_params=problem_params,
        sweeper_class=pkg.GenericImplicit,
        sweeper_params=dict(num_nodes=M, QI='LU', quad_type='RADAU-RIGHT', **sweeper_params),
        level_params=dict(dt=dt, restol=1e-10),
        step_params=dict(maxiter=20),
    )


@functools.lru_cache(maxsize=None)
def _run(package, config):
    params, M, dt, Tend, procs = CONFIGS[config]
    if package == 'jax':
        pkg, desc = pysdc_tpu, _description(pysdc_tpu, JaxHeat, dict(params), M, dt)
    else:
        pkg, desc = pysdc_tpu_torch, _description(pysdc_tpu_torch, TorchHeat, dict(params, device='cpu'), M, dt)
    ctrl = pkg.ControllerNonMPI(procs, {'logger_level': 30}, desc)
    prob = ctrl.MS[0].levels[0].prob
    uend, stats = ctrl.run(prob.u_exact(0.0), 0.0, Tend)

    def series(kind):
        return [v for _, v in pkg.get_sorted(stats, type=kind, sortby='time')]

    return dict(
        uend=np.asarray(to_numpy(uend)),
        niter=series('niter'),
        residual_post_step=series('residual_post_step'),
        residual_post_iteration=series('residual_post_iteration'),
        types=set(pkg.get_list_of_types(stats)),
    )


@pytest.mark.parametrize('config', list(CONFIGS))
def test_controller_matches_jax(config):
    want, got = _run('jax', config), _run('torch', config)
    np.testing.assert_allclose(got['uend'], want['uend'], rtol=0, atol=1e-12)
    assert got['niter'] == want['niter']
    for kind in ('residual_post_step', 'residual_post_iteration'):
        assert len(got[kind]) == len(want[kind])
        np.testing.assert_allclose(got[kind], want[kind], rtol=1e-8, atol=1e-13)
    assert got['types'] == want['types']


@pytest.mark.parametrize('initial_guess', ['spread', 'copy', 'zero', 'random'])
@pytest.mark.parametrize('qi', ['LU', 'MIN-SR-S'])
def test_sweeper_states_match_jax(qi, initial_guess):
    """predict and two sweeps from the same numpy u0: LU takes the
    Gauss-Seidel path, MIN-SR-S the diagonal (batched) path."""
    params = dict(nvars=(16, 16), nu=0.1, freq=2, bc='periodic')
    sweep_params = dict(num_nodes=3, QI=qi, quad_type='RADAU-RIGHT', initial_guess=initial_guess)
    jprob, tprob = JaxHeat(**params), TorchHeat(**params, device='cpu')
    jsw, tsw = pysdc_tpu.GenericImplicit(sweep_params), pysdc_tpu_torch.GenericImplicit(sweep_params)
    u0 = np.random.default_rng(4).standard_normal((16, 16))
    dt, rv = 0.02, jsw.draw_random_val()
    assert tsw.draw_random_val() == rv

    jstate = jsw.predict(jprob, np.asarray(u0), 0.0, dt, rv)
    tstate = tsw.predict(tprob, to_torch(u0, 'cpu'), 0.0, dt, rv)
    _states_close(tstate, jstate)
    for k in range(2):
        # each package sweeps its own state, started from the same numbers
        jstate = jsw.update_nodes(jprob, jstate, 0.0, dt, k)
        tstate = tsw.update_nodes(tprob, state_to_torch(state_to_numpy(tstate), 'cpu'), 0.0, dt, k)
        _states_close(tstate, jstate)
    _, jres = jsw.compute_residual(jstate, dt)
    _, tres = tsw.compute_residual(tstate, dt)
    np.testing.assert_allclose(tres.item(), float(jres), rtol=1e-8, atol=1e-13)
    np.testing.assert_allclose(to_numpy(tsw.compute_end_point(tstate, 0.0, dt)),
                               np.asarray(jsw.compute_end_point(jstate, 0.0, dt)), rtol=0, atol=1e-12)


# name -> (problem params, QI): the rfft basis, the full complex FFT basis
# (disable_rfft), the Dirichlet eigenbasis; Gauss-Seidel, diagonal and
# sweep-dependent tables
DIAG_CASES = {
    'periodic2d-LU': (dict(nvars=(16, 16), nu=0.1, freq=2, bc='periodic'), 'LU'),
    'periodic2d-MIN-SR-S': (dict(nvars=(16, 16), nu=0.1, freq=2, bc='periodic'), 'MIN-SR-S'),
    'periodic2d-MIN-SR-FLEX': (dict(nvars=(16, 16), nu=0.1, freq=2, bc='periodic'), 'MIN-SR-FLEX'),
    'periodic1d-full-fft-LU': (dict(nvars=32, nu=0.1, freq=2, bc='periodic'), 'LU'),
    'dirichlet1d-LU': (dict(nvars=31, nu=0.1, freq=2, bc='dirichlet-zero'), 'LU'),
    'dirichlet2d-IE': (dict(nvars=(15, 15), nu=0.1, freq=2, bc='dirichlet-zero'), 'IE'),
}


@pytest.mark.parametrize('case', list(DIAG_CASES))
def test_diagonal_sweeps_match_jax_and_the_sweep_loop(case):
    """``diagonal_sweeps`` (4 sweeps in the operator's diagonal basis, with a
    seeded tau) against the JAX package's ``update_nodes_k``, which dispatches
    to its twin, and against the port's ``update_nodes_k``, which is 4
    ``update_nodes`` calls: 1e-12 relative to the field's size."""
    from pysdc_tpu.core.state import LevelState as JaxLevelState
    from pysdc_tpu_torch.ops.diag_sdc import diagonal_sweeps

    params, qi = DIAG_CASES[case]
    sweep_params = dict(num_nodes=3, QI=qi, quad_type='RADAU-RIGHT')
    jprob, tprob = JaxHeat(**params), TorchHeat(**params, device='cpu')
    if 'full-fft' in case:
        jprob.A.disable_rfft()
        tprob.A.disable_rfft()
    assert tprob.diagonalizable_operator is tprob.A
    jsw, tsw = pysdc_tpu.GenericImplicit(sweep_params), pysdc_tpu_torch.GenericImplicit(sweep_params)
    rng = np.random.default_rng(9)
    u0 = rng.standard_normal(jprob.shape)
    tau = 1e-2 * rng.standard_normal((3,) + jprob.shape)
    dt, k0 = 0.02, 1
    jstate = jsw.predict(jprob, np.asarray(u0), 0.0, dt)._replace(tau=np.asarray(tau))
    jstate = JaxLevelState(*(np.asarray(x) for x in jstate))
    tstate = state_to_torch(state_to_numpy(jstate), 'cpu')

    fused = diagonal_sweeps(tprob.diagonalizable_operator, tsw, tstate, 0.0, dt, 4, k0)
    _states_close(fused, jsw.update_nodes_k(jprob, jstate, 0.0, dt, 4, k0))
    _states_close(fused, tsw.update_nodes_k(tprob, tstate, 0.0, dt, 4, k0))
    assert fused.u.dtype == torch.float64 and fused.f.shape == tstate.f.shape and fused.tau is tstate.tau


def test_update_nodes_k_loops_without_a_diagonalizable_operator():
    """``update_nodes_k`` is the loop of ``update_nodes`` whether or not the
    problem advertises an operator (the sparse backend and the forced problem
    advertise none), and a float32 state stays float32 through the diagonal
    basis."""
    from pysdc_tpu_torch.models.heat import HeatNDForced
    from pysdc_tpu_torch.ops.diag_sdc import diagonal_sweeps

    sparse = TorchHeat(nvars=(8, 8), bc='periodic', backend='sparse', device='cpu')
    assert sparse.diagonalizable_operator is None
    assert HeatNDForced(nvars=8, device='cpu').diagonalizable_operator is None
    sw = pysdc_tpu_torch.GenericImplicit(dict(num_nodes=3, QI='LU'))
    state = sw.predict(sparse, sparse.u_exact(0.0), 0.0, 0.01)
    looped = sw.update_nodes(sparse, sw.update_nodes(sparse, state, 0.0, 0.01), 0.0, 0.01)
    np.testing.assert_array_equal(to_numpy(sw.update_nodes_k(sparse, state, 0.0, 0.01, 2).u), to_numpy(looped.u))

    prob = TorchHeat(nvars=(16, 16), bc='periodic', dtype=torch.float32, device='cpu')
    state = sw.predict(prob, prob.u_exact(0.0), 0.0, 0.01)
    looped = state
    for _ in range(3):
        looped = sw.update_nodes(prob, looped, 0.0, 0.01)
    np.testing.assert_array_equal(to_numpy(sw.update_nodes_k(prob, state, 0.0, 0.01, 3).u), to_numpy(looped.u))
    fused = diagonal_sweeps(prob.diagonalizable_operator, sw, state, 0.0, 0.01, 3)
    assert fused.u.dtype == torch.float32 and fused.f.dtype == torch.float32
    assert (fused.u - looped.u).abs().max().item() < 1e-5


def _states_close(tstate, jstate):
    got, want = state_to_numpy(tstate), state_to_numpy(jstate)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12 * max(1.0, np.abs(w).max()))


def test_convert_round_trip_and_containers():
    from pysdc_tpu.core.state import IMEX as JaxIMEX, LevelState as JaxLevelState
    from pysdc_tpu_torch.core.state import IMEX

    rng = np.random.default_rng(0)
    u, f1, f2, tau = (rng.standard_normal((3, 4)) for _ in range(4))
    state = state_to_torch(JaxLevelState(u=u, f=JaxIMEX(f1, f2), tau=tau), 'cpu', torch.float64)
    assert isinstance(state.f, IMEX) and state.u.dtype == torch.float64
    back = state_to_numpy(state)
    for a, b in ((back.u, u), (back.f.impl, f1), (back.f.expl, f2), (back.tau, tau)):
        np.testing.assert_array_equal(a, b)


def test_device_timings_and_work_counters_on_cpu():
    from pysdc_tpu_torch.core.hooks import DeviceTimings

    params, M, dt, Tend, _ = CONFIGS['heat2d']
    desc = _description(pysdc_tpu_torch, TorchHeat, dict(params, device='cpu'), M, dt)
    ctrl = pysdc_tpu_torch.ControllerNonMPI(1, {'logger_level': 30, 'hook_class': DeviceTimings}, desc)
    prob = ctrl.MS[0].levels[0].prob
    _, stats = ctrl.run(prob.u_exact(0.0), 0.0, Tend)
    types = set(pysdc_tpu_torch.get_list_of_types(stats))
    assert {'timing_run', 'timing_step', 'timing_iteration', 'timing_sweep', 'restart'} <= types
    niter = [v for _, v in pysdc_tpu_torch.get_sorted(stats, type='niter')]
    # the work of a sweep, counted as the JAX package counts it: M evaluations per sweep
    assert prob.work_counters['rhs'].niter == sum(M * k for k in niter)
    assert all(isinstance(v, (int, float)) for v in stats.values())
