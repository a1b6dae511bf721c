"""The block controller and the fused lane of the PyTorch port
(``ShardedController`` with ``mesh=None``, ``run_fused``) against live runs of
the JAX package's virtual controller and of the port's own (float64, CPU).

For every configuration and both lanes (``'stage'``: the batched stage
handlers; ``'fused'``: the device loop, which on the CPU runs its pieces
eagerly) the per-step ``niter`` lists are equal, ``uend`` agrees with the JAX
run to 1e-10 and with the port's stage machine to 1e-11.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import pysdc_tpu
import pysdc_tpu_torch
from pysdc_tpu.models.heat import HeatND as JaxHeat
from pysdc_tpu.models.heat import HeatNDForced as JaxHeatForced
from pysdc_tpu_torch.core.errors import ControllerError
from pysdc_tpu_torch.core.hooks import Hooks
from pysdc_tpu_torch.convergence.check_convergence import CheckConvergence
from pysdc_tpu_torch.models.heat import HeatND, HeatNDForced
from pysdc_tpu_torch.parallel import fused
from pysdc_tpu_torch.utils.convert import to_numpy

PROBLEMS = {'heat': (JaxHeat, HeatND), 'forced': (JaxHeatForced, HeatNDForced)}
SWEEPERS = {'implicit': 'GenericImplicit', 'imex': 'IMEXSweeper'}


def _step6(**over):
    """Reference tutorial step 6 (tests/test_controllers.py:40-50)."""
    base = dict(
        problem_params=dict(nu=0.1, freq=2, nvars=[63, 31], bc='dirichlet-zero'),
        sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=[3], QI='LU'),
        level_params=dict(restol=5e-10, dt=0.125),
        step_params=dict(maxiter=50),
        space_transfer_params=dict(rorder=2, iorder=6),
    )
    base.update(over)
    return base


def _periodic2d(**over):
    """The periodic 32^2 / 16^2 configuration (tests/test_golden_regression.py:65-80)."""
    return _step6(**{'problem_params': dict(nu=0.1, freq=2, nvars=[(32, 32), (16, 16)], bc='periodic'),
                     'space_transfer_params': dict(rorder=2, iorder=6, periodic=True), **over})


def _single(**over):
    """Single-level multi-step SDC (tests/test_fused.py:83-96)."""
    return dict(dict(
        problem_params=dict(nu=0.1, freq=2, nvars=63, bc='dirichlet-zero'),
        sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=3, QI='LU'),
        level_params=dict(restol=5e-10, dt=0.125),
        step_params=dict(maxiter=50),
    ), **over)


def _forced(**over):
    """The forced heat equation under the IMEX sweeper (tutorial step 2), several blocks."""
    return dict(dict(
        problem='forced', sweeper='imex',
        problem_params=dict(nu=0.1, freq=4, nvars=63, bc='dirichlet-zero'),
        sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=3, QI='LU', QE='EE'),
        level_params=dict(restol=1e-10, dt=0.05),
        step_params=dict(maxiter=50),
    ), **over)


THREE = dict(problem_params=dict(nu=0.1, freq=2, nvars=[127, 63, 31], bc='dirichlet-zero'),
             level_params=dict(restol=5e-10, dt=0.125, nsweeps=[1, 2, 1]))
BURNIN = {'predict_type': 'pfasst_burnin'}
# name -> (description parts, num_procs, controller params, Tend)
RUNS = {
    'pfasst-P2': (_step6(), 2, BURNIN, 1.0),
    'pfasst-P4': (_step6(), 4, BURNIN, 1.0),
    'mssdc-jacobi': (_single(), 4, {}, 1.0),
    'mssdc-gauss-seidel': (_single(), 4, dict(mssdc_jac=False), 1.0),
    'all-to-done': (_step6(), 4, dict(BURNIN, all_to_done=True), 1.0),
    'predict-none': (_step6(), 2, {'predict_type': None}, 0.5),
    'predict-fine-only': (_step6(), 4, {'predict_type': 'fine_only'}, 1.0),
    'predict-fmg': (_step6(), 4, {'predict_type': 'fmg'}, 1.0),
    'partial-final-block': (_step6(), 4, BURNIN, 0.75),
    'maxiter-termination': (_step6(level_params=dict(restol=1e-30, dt=0.125), step_params=dict(maxiter=3)),
                            4, BURNIN, 0.5),
    'three-levels-P3': (_step6(**THREE), 3, BURNIN, 0.75),
    'three-levels-fmg-P2': (_step6(**dict(THREE, sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=[3, 3, 2],
                                                                    QI='LU'))), 2, {'predict_type': 'fmg'}, 0.5),
    'imex-forced-jacobi-P2': (_forced(), 2, {}, 0.25),
    'imex-forced-gauss-seidel-P3': (_forced(), 3, dict(mssdc_jac=False), 0.4),
    'imex-forced-2d-periodic': (_forced(problem_params=dict(nu=0.1, freq=2, nvars=(16, 16), bc='periodic')), 2, {}, 0.15),
    'serial-sdc': (_single(), 1, {}, 0.5),
    'serial-mlsdc': (_step6(), 1, {}, 0.5),
    'periodic2d-P4': (_periodic2d(), 4, BURNIN, 1.0),
    'periodic2d-diagonal-QI': (_periodic2d(sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=[3, 2],
                                                               QI='MIN-SR-S')), 2, BURNIN, 0.5),
}
LANES = ('stage', 'fused')


def _description(package, parts):
    """``parts`` with the classes of ``package`` ('jax' or 'torch'); the port runs on the CPU."""
    jax_side = package == 'jax'
    pkg = pysdc_tpu if jax_side else pysdc_tpu_torch
    parts = dict(parts)
    problem = PROBLEMS[parts.pop('problem', 'heat')][0 if jax_side else 1]
    sweeper = SWEEPERS[parts.pop('sweeper', 'implicit')]
    if sweeper == 'IMEXSweeper' and jax_side:
        from pysdc_tpu.sweepers.imex import IMEXSweeper as sweeper_class
    else:
        sweeper_class = getattr(pkg, sweeper)
    desc = dict(parts, problem_class=problem, sweeper_class=sweeper_class)
    if not jax_side:
        desc['problem_params'] = dict(desc['problem_params'], device='cpu')
    return pkg, desc


def _summary(pkg, ctrl, uend, stats):
    return dict(
        uend=np.asarray(to_numpy(uend)),
        niter=[v for _, v in pkg.get_sorted(stats, type='niter', sortby='time')],
        stats=stats,
        ctrl=ctrl,
    )


@functools.lru_cache(maxsize=None)
def _virtual(package, name):
    """The virtual controller (``ControllerNonMPI``) of ``package`` on run ``name``."""
    parts, num_procs, controller_params, Tend = RUNS[name]
    pkg, desc = _description(package, parts)
    ctrl = pkg.ControllerNonMPI(num_procs, {'logger_level': 40, **controller_params}, desc)
    uend, stats = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, Tend)
    return _summary(pkg, ctrl, uend, stats)


@functools.lru_cache(maxsize=None)
def _block(name, lane, coarse_mode='auto'):
    """The port's block controller on run ``name`` through ``lane``."""
    parts, num_procs, controller_params, Tend = RUNS[name]
    pkg, desc = _description('torch', parts)
    ctrl = pkg.ShardedController(num_procs, {'logger_level': 40, **controller_params}, desc, coarse_mode=coarse_mode)
    uend, stats = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, Tend, lane=lane)
    return _summary(pkg, ctrl, uend, stats)


@pytest.mark.parametrize('lane', LANES)
@pytest.mark.parametrize('name', list(RUNS))
def test_block_controller_matches_live_jax_run(name, lane):
    want, own, got = _virtual('jax', name), _virtual('torch', name), _block(name, lane)
    assert got['niter'] == want['niter'] == own['niter']
    np.testing.assert_allclose(got['uend'], want['uend'], rtol=0, atol=1e-10)
    np.testing.assert_allclose(got['uend'], own['uend'], rtol=0, atol=1e-11)
    assert [v for k, v in got['stats'].items() if k.type == 'lane'] == [lane]
    if name == 'maxiter-termination':
        assert got['niter'] == [3, 3, 3, 3]
    else:
        maxiter = RUNS[name][0]['step_params']['maxiter']
        assert all(k < maxiter for k in got['niter'])
    if name == 'partial-final-block':
        assert len(got['niter']) == 6  # 4 + 2 steps


@pytest.mark.parametrize('name', ['pfasst-P2', 'periodic2d-P4'])
def test_fused_lane_matches_live_jax_fused_lane(name):
    """The JAX package's own ``run_fused`` (one ``lax.while_loop`` a block): the same counts, fields and entries."""
    parts, num_procs, controller_params, Tend = RUNS[name]
    pkg, desc = _description('jax', parts)
    ctrl = pkg.ShardedController(num_procs, {'logger_level': 40, **controller_params}, desc)
    uend, stats = ctrl.run_fused(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, Tend)
    want, got = _summary(pkg, ctrl, uend, stats), _block(name, 'fused')
    assert got['ctrl'].coarse_mode == ctrl.coarse_mode == 'diag'
    assert got['niter'] == want['niter']
    np.testing.assert_allclose(got['uend'], want['uend'], rtol=0, atol=1e-10)
    key = lambda k: (k.type, k.process, round(k.time, 10), k.level, k.iter, k.sweep)  # noqa: E731
    theirs = {key(k): v for k, v in want['stats'].items()}
    ours = {key(k): v for k, v in got['stats'].items() if k.type != 'lane'}
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        assert np.isclose(ours[k], v, rtol=1e-6, atol=1e-13), k


@pytest.mark.parametrize('name', ['pfasst-P4', 'partial-final-block', 'imex-forced-jacobi-P2'])
def test_fused_residual_history_matches_stage_machine(name):
    """``residual_post_iteration`` and ``residual_post_step`` of the fused lane, built from the fetched
    history, against the virtual controller's entries."""
    own, got = _virtual('torch', name), _block(name, 'fused')
    for typ in ('residual_post_iteration', 'residual_post_step', 'niter', 'dt', 'restart'):
        a = {(round(k.time, 10), k.iter, k.level): v for k, v in own['stats'].items() if k.type == typ}
        b = {(round(k.time, 10), k.iter, k.level): v for k, v in got['stats'].items() if k.type == typ}
        assert set(a) == set(b), typ
        for k in a:
            assert np.isclose(a[k], b[k], rtol=1e-6, atol=1e-13), (typ, k)


@pytest.mark.parametrize('lane', LANES)
@pytest.mark.parametrize('name', ['periodic2d-P4', 'mssdc-gauss-seidel', 'predict-fmg'])
def test_diag_chain_matches_serial_chain(name, lane):
    """``coarse_mode='diag'`` (chain and wavefront in the operator's basis) against the serial loop under both
    of its names; ``'auto'`` resolves to ``'diag'`` where the coarsest level is eligible."""
    auto = _block(name, lane)
    assert auto['ctrl'].coarse_mode == 'diag'
    for mode in ('replicated', 'pipelined'):
        serial = _block(name, lane, mode)
        assert serial['ctrl'].coarse_mode == mode
        assert serial['niter'] == auto['niter']
        np.testing.assert_allclose(serial['uend'], auto['uend'], rtol=0, atol=1e-11)


def test_auto_coarse_mode_is_serial_where_diag_is_not_eligible():
    assert _block('imex-forced-gauss-seidel-P3', 'fused')['ctrl'].coarse_mode == 'replicated'
    parts, num_procs, controller_params, _ = RUNS['imex-forced-gauss-seidel-P3']
    pkg, desc = _description('torch', parts)
    with pytest.raises(ControllerError, match='diagonalizable'):
        pkg.ShardedController(num_procs, {'logger_level': 40}, desc, coarse_mode='diag')
    with pytest.raises(ControllerError, match='unknown coarse_mode'):
        pkg.ShardedController(num_procs, {'logger_level': 40}, desc, coarse_mode='other')


def test_host_reads_of_the_fused_lane():
    """One ``cont`` read a check but the first, one fetch a march."""
    for name in ('pfasst-P4', 'partial-final-block', 'maxiter-termination'):
        got = _block(name, 'fused')
        P = RUNS[name][1]
        blocks = [got['niter'][i:i + P] for i in range(0, len(got['niter']), P)]
        assert got['ctrl'].host_reads == {'cont': sum(max(1, max(b)) for b in blocks), 'fetch': 1}
        assert got['ctrl']._fused_converged == (name != 'maxiter-termination')
    assert _block('pfasst-P4', 'stage')['ctrl'].host_reads == {'cont': 0, 'fetch': 0}


def test_run_fused_over_an_empty_horizon_marches_nothing():
    """As the JAX package's ``run_fused``: no step to take, ``u0`` comes back and nothing is read."""
    ctrl = _block('pfasst-P2', 'fused')['ctrl']
    u0 = ctrl.MS[0].levels[0].prob.u_exact(0.0)
    uend, stats = fused.run_fused(ctrl, u0, 0.5, 0.5)
    assert uend is u0 and not [k for k in stats if k.type == 'niter']
    assert ctrl.host_reads == {'cont': 0, 'fetch': 0}


def test_fused_programs_follow_dt_and_times():
    """One controller, one program: a second march from another start time and a march at another ``dt`` reuse it
    (times and step sizes are inputs that the pieces read from the device), and each result equals a fresh
    controller's that was built for that ``dt``."""
    name = 'imex-forced-jacobi-P2'
    parts, num_procs, controller_params, Tend = RUNS[name]
    pkg, desc = _description('torch', parts)
    ctrl = pkg.ShardedController(num_procs, {'logger_level': 40}, desc)
    prob = ctrl.MS[0].levels[0].prob
    mid, _ = ctrl.run_fused(prob.u_exact(0.0), 0.0, 0.1)
    uend, _ = ctrl.run_fused(mid, 0.1, Tend)
    assert len(ctrl._fused_fn._programs) == 1
    np.testing.assert_allclose(to_numpy(uend), _block(name, 'fused')['uend'], rtol=0, atol=1e-12)
    for step in ctrl.MS:
        step.levels[0].params.dt = 0.025
    half, stats = ctrl.run_fused(prob.u_exact(0.0), 0.0, 0.1)
    assert len(ctrl._fused_fn._programs) == 1
    assert [round(k.time, 10) for k in stats if k.type == 'niter'] == [0.0, 0.025, 0.05, 0.075]
    assert float((half - mid).abs().max()) < 1e-6  # both converged to the collocation solution of their dt

    fresh = {}
    for dt in (0.05, 0.025):
        _, desc_dt = _description('torch', dict(parts, level_params=dict(restol=1e-10, dt=dt)))
        other = pkg.ShardedController(num_procs, {'logger_level': 40}, desc_dt)
        fresh[dt] = other.run_fused(prob.u_exact(0.0), 0.0, 0.1)
        assert len(other._fused_fn._programs) == 1
    np.testing.assert_allclose(to_numpy(mid), to_numpy(fresh[0.05][0]), rtol=0, atol=1e-14)
    np.testing.assert_allclose(to_numpy(half), to_numpy(fresh[0.025][0]), rtol=0, atol=1e-14)
    niter = lambda st: [v for _, v in pkg.get_sorted(st, type='niter', sortby='time')]  # noqa: E731
    assert niter(stats) == niter(fresh[0.025][1])
    # the same through the block function itself, dt as a host number and as a tensor on the device
    t_arr, window = [0.0, 0.025], [True, True]
    a = ctrl._fused_fn(prob.u_exact(0.0), t_arr, 0.025, window)
    b = ctrl._fused_fn(prob.u_exact(0.0), t_arr, torch.tensor(0.025, dtype=torch.float64), window)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and len(ctrl._fused_fn._programs) == 1


class _PerSweepHook(Hooks):
    """A hook the fused lane cannot serve: it wants every sweep."""


class _OtherCheck(CheckConvergence):
    """A convergence controller outside the fused lane's list (exact types only)."""


def _lane_of(stats):
    return [v for k, v in stats.items() if k.type == 'lane']


@pytest.mark.parametrize('extra, named', [
    (dict(controller=dict(hook_class=[_PerSweepHook])), '_PerSweepHook'),
    (dict(description=dict(convergence_controllers={_OtherCheck: {}})), '_OtherCheck'),
    (dict(description=dict(sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=[3], QI='MIN-SR-FLEX'))),
     'iteration-independent'),
    (dict(controller=dict(use_iteration_estimator=True)), 'iteration estimator'),
])
def test_fused_lane_rejects_what_needs_the_stage_machine(extra, named):
    """``run_fused`` raises by name; ``run()`` then takes the stage machine and records it."""
    pkg, desc = _description('torch', _step6(**extra.get('description', {})))
    ctrl = pkg.ShardedController(2, {'logger_level': 40, **BURNIN, **extra.get('controller', {})}, desc)
    u0 = ctrl.MS[0].levels[0].prob.u_exact(0.0)
    with pytest.raises(ControllerError, match=named):
        ctrl.run_fused(u0, 0.0, 0.25)
    with pytest.raises(ControllerError, match=named):
        ctrl.run(u0, 0.0, 0.25, lane='fused')
    if 'hook' in str(extra) or 'Check' in named:
        with pytest.raises(ControllerError, match='stage-machine'):
            fused.check_fused_eligibility(ctrl)
    uend, stats = ctrl.run(u0, 0.0, 0.25)
    assert _lane_of(stats) == ['stage']
    assert uend.shape == (63,)


def test_run_autodispatch_and_unknown_lane():
    got = _block('pfasst-P2', 'stage')
    pkg, desc = _description('torch', RUNS['pfasst-P2'][0])
    ctrl = pkg.ShardedController(2, {'logger_level': 40, **BURNIN}, desc)
    u0 = ctrl.MS[0].levels[0].prob.u_exact(0.0)
    uend, stats = ctrl.run(u0, 0.0, 1.0)  # lane='auto'
    assert _lane_of(stats) == ['fused']
    np.testing.assert_allclose(to_numpy(uend), got['uend'], rtol=0, atol=1e-11)
    with pytest.raises(ControllerError, match='unknown execution lane'):
        ctrl.run(u0, 0.0, 1.0, lane='other')


def test_lane_stats_contract():
    """The per-lane stats contract (tests/test_fused.py:429-453): each lane emits exactly the documented
    entry-type set under the default hook stack."""
    base = {'dt', 'lane', 'niter', 'residual_post_iteration', 'residual_post_step', 'restart'}
    timings = {'timing_run', 'timing_step', 'timing_iteration'}
    expected = {'stage': base | timings | {'timing_sweep', 'residual_post_sweep'}, 'fused': base}
    for lane, want in expected.items():
        got = {k.type for k in _block('periodic2d-P4', lane)['stats']}
        assert got == want, f'{lane}: {sorted(got ^ want)}'
    for value in _block('periodic2d-P4', 'fused')['stats'].values():
        assert isinstance(value, (int, float, str)) and not isinstance(value, torch.Tensor)


@pytest.mark.parametrize('entry', ['check_fused_adaptive_eligibility', 'run_fused_adaptive',
                                   'advance_fused_adaptive', 'build_fused_adaptive_block'])
def test_adaptive_lane_raises_naming_the_roadmap(entry):
    """The adaptive lane is ported: nothing of it names a ROADMAP item any more.  On this plain configuration
    (restol >= 0) its entry points raise what the lane needs, and ``build_fused_adaptive_block`` captures nothing yet."""
    ctrl = _block('pfasst-P2', 'fused')['ctrl']
    fn = getattr(fused, entry)
    if entry == 'build_fused_adaptive_block':
        program = fn(ctrl)
        assert callable(program) and program._programs == {} and program.maxiter == 50
    elif entry == 'advance_fused_adaptive':
        with pytest.raises(ControllerError, match='must start at SPREAD') as err:
            fn(ctrl, [SimpleNamespace(status=SimpleNamespace(stage='IT_CHECK'))])
        assert 'ROADMAP' not in str(err.value)
    else:
        args = (ctrl,) if entry.startswith('check') else (ctrl, None, 0.0, 1.0)
        with pytest.raises(ControllerError, match='restol < 0') as err:
            fn(*args)
        assert 'ROADMAP' not in str(err.value)
    with pytest.raises(ControllerError, match='maxiter-only termination'):
        ctrl.run(None, 0.0, 1.0, lane='fused_adaptive')


def test_run_fused_of_an_adaptive_shape_names_the_adaptive_lane():
    """restol < 0 with a controller outside the plain list is the adaptive lane's shape: its error is raised."""
    pkg, desc = _description('torch', _step6(level_params=dict(restol=-1.0, dt=0.125), step_params=dict(maxiter=3),
                                             convergence_controllers={_OtherCheck: {}}))
    ctrl = pkg.ShardedController(2, {'logger_level': 40, **BURNIN}, desc)
    with pytest.raises(ControllerError, match='_OtherCheck is not supported by the adaptive fused lane'):
        ctrl.run_fused(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, 0.25)


def test_mesh_and_owner_chain_raise_naming_the_roadmap():
    pkg, desc = _description('torch', _step6())
    with pytest.raises(ControllerError, match='ROADMAP queue 1, item 10b'):
        pkg.ShardedController(2, {'logger_level': 40}, desc, mesh=object())
    with pytest.raises(ControllerError, match='item 10b'):
        pkg.ShardedController(2, {'logger_level': 40}, desc, coarse_mode='owner')


def test_per_step_overrides_raise_naming_the_roadmap():
    """``newton_tol`` and ``t_switch`` on a problem are per-step ``(P,)`` arguments of the batched functions (the
    second raised naming item 13 until the switch estimator was ported)."""
    pkg, desc = _description('torch', _single())
    ctrl = pkg.ShardedController(2, {'logger_level': 40}, desc)
    assert ctrl._block_overrides(0) is None
    for step, tol in zip(ctrl.MS, (1e-9, 1e-7)):
        step.levels[0].prob.newton_tol = tol
    ctrl.blocks[0].traced_keys = ('newton_tol',)
    ov = ctrl._block_overrides(0)
    assert ov['newton_tol'].tolist() == [1e-9, 1e-7] and ov['newton_tol'].dtype == torch.float64

    # a sweep under overrides: the problem reads them as its attribute while the sweep runs, and gets its own back
    prob = ctrl.blocks[0].level.prob
    u0 = prob.u_exact(0.0)
    t_arr = torch.zeros(2, dtype=torch.float64)
    state = ctrl.blocks[0].predict(torch.stack([u0, u0]), t_arr, 0.1)
    mask = torch.ones(2, dtype=torch.bool)
    plain = ctrl.blocks[0].sweep(state, t_arr, 0.1, mask, 0)
    with_ov = ctrl.blocks[0].sweep(state, t_arr, 0.1, mask, 0, ov)
    assert torch.equal(plain.u, with_ov.u) and prob.newton_tol == 1e-9

    ctrl.blocks[0].traced_keys = ('newton_tol', 't_switch')
    for step, t_switch in zip(ctrl.MS, (0.05, np.inf)):
        step.levels[0].prob.t_switch = t_switch
    ov = ctrl._block_overrides(0)
    assert ov['t_switch'].tolist() == [0.05, np.inf] and ov['t_switch'].dtype == torch.float64
    prob.t_switch = np.inf
    with_ov = ctrl.blocks[0].sweep(state, t_arr, 0.1, mask, 0, ov)
    assert torch.equal(plain.u, with_ov.u) and prob.t_switch == np.inf  # read while the sweep runs, then restored
