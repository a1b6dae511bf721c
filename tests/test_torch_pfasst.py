"""The multi-level path of the PyTorch port (MLSDC, virtual PFASST, multi-step
SDC) through ``ControllerNonMPI`` against a live run of the JAX package
(float64, CPU).

For each configuration the per-step ``niter`` lists are equal, ``uend`` agrees
to 1e-10, and the stats keys (type, level, iter, time) are the same, which
covers the per-level ``residual_post_sweep`` entries below level 0.
"""

import functools

import numpy as np
import pytest

import pysdc_tpu
import pysdc_tpu_torch
from pysdc_tpu.models.heat import HeatND as JaxHeat
from pysdc_tpu.transfer.no_coarse import NoCoarseTransfer as JaxNoCoarse
from pysdc_tpu.transfer.space_fft import FFTTransfer as JaxFFT
from pysdc_tpu_torch.models.heat import HeatND
from pysdc_tpu_torch.transfer import FFTTransfer, NoCoarseTransfer
from pysdc_tpu_torch.utils.convert import to_numpy

SPACE = {'fft': (JaxFFT, FFTTransfer), 'no-coarse': (JaxNoCoarse, NoCoarseTransfer)}


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


def _mssdc():
    """Single-level multi-step SDC (tests/test_controllers.py:85-101)."""
    return dict(
        problem_params=dict(nu=0.1, freq=2, nvars=64, bc='periodic'),
        sweeper_params=dict(num_nodes=3, QI='LU'),
        level_params=dict(restol=1e-10, dt=0.05),
        step_params=dict(maxiter=30),
    )


def _galerkin(coarse_op):
    """MLSDC on the assembled-CSR backend (tests/test_sparse.py:466-488), at 16^2."""
    return dict(
        problem_params=dict(nu=0.1, freq=2, nvars=[(16, 16), (8, 8)], bc='periodic', backend='sparse'),
        sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=[3], QI='LU'),
        level_params=dict(restol=1e-9, dt=0.05),
        step_params=dict(maxiter=30),
        base_transfer_params=dict(coarse_op=coarse_op),
        space_transfer_params=dict(rorder=2, iorder=2, periodic=True),
    )


BURNIN = {'predict_type': 'pfasst_burnin'}
# name -> (description parts, num_procs, controller params, Tend)
RUNS = {
    **{f'step6-P{P}': (_step6(), P, dict(BURNIN, all_to_done=True), 1.0) for P in (1, 2, 4, 8)},
    'step6-P4-no-all-to-done': (_step6(), 4, BURNIN, 0.5),
    'periodic2d-P4': (_periodic2d(), 4, BURNIN, 1.0),
    'mssdc-gauss-seidel': (_mssdc(), 4, dict(mssdc_jac=False), 0.2),
    'mssdc-jacobi': (_mssdc(), 4, dict(mssdc_jac=True), 0.2),
    'mlsdc-fft': (_periodic2d(space_transfer_class='fft', space_transfer_params={},
                              sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=[3, 2], QI='LU')),
                  1, {}, 0.25),
    'mlsdc-no-coarse': (dict(_mssdc(), sweeper_params=dict(num_nodes=[3, 2], QI='LU'),
                             space_transfer_class='no-coarse'), 1, {}, 0.1),
    'predict-none': (_step6(), 2, {'predict_type': None}, 0.25),
    'predict-fine-only': (_step6(), 2, {'predict_type': 'fine_only'}, 0.25),
    'predict-fmg': (_step6(), 2, {'predict_type': 'fmg'}, 0.25),
    'mlsdc-finter': (_step6(base_transfer_params=dict(finter=True)), 1, {}, 0.25),
    'galerkin': (_galerkin('galerkin'), 1, {}, 0.05),
    'rediscretize': (_galerkin('rediscretize'), 1, {}, 0.05),
    # three levels: the middle-level sweeps of the restrict and prolong cascades
    'three-levels-mlsdc': (_step6(problem_params=dict(nu=0.1, freq=2, nvars=[127, 63, 31], bc='dirichlet-zero'),
                                  level_params=dict(restol=5e-10, dt=0.125, nsweeps=[1, 2, 1])), 1, {}, 0.25),
    'three-levels-pfasst-P3': (_step6(problem_params=dict(nu=0.1, freq=2, nvars=[127, 63, 31], bc='dirichlet-zero'),
                                      level_params=dict(restol=5e-10, dt=0.125, nsweeps=[1, 2, 1])), 3, BURNIN, 0.375),
    'three-levels-fmg-P2': (_step6(problem_params=dict(nu=0.1, freq=2, nvars=[127, 63, 31], bc='dirichlet-zero'),
                                   sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=[3, 3, 2], QI='LU')),
                            2, {'predict_type': 'fmg'}, 0.25),
}


def _description(package, parts):
    """``parts`` with the classes of ``package`` ('jax' or 'torch'); the port runs on the CPU."""
    jax_side = package == 'jax'
    pkg = pysdc_tpu if jax_side else pysdc_tpu_torch
    desc = dict(parts, problem_class=JaxHeat if jax_side else HeatND, sweeper_class=pkg.GenericImplicit)
    if not jax_side:
        desc['problem_params'] = dict(desc['problem_params'], device='cpu')
    if 'space_transfer_class' in desc:
        desc['space_transfer_class'] = SPACE[desc['space_transfer_class']][0 if jax_side else 1]
    return pkg, desc


@functools.lru_cache(maxsize=None)
def _run(package, name):
    parts, num_procs, controller_params, Tend = RUNS[name]
    pkg, desc = _description(package, parts)
    ctrl = pkg.ControllerNonMPI(num_procs, {'logger_level': 40, **controller_params}, desc)
    prob = ctrl.MS[0].levels[0].prob
    uend, stats = ctrl.run(prob.u_exact(0.0), 0.0, Tend)
    return dict(
        uend=np.asarray(to_numpy(uend)),
        err=float(np.abs(to_numpy(uend) - to_numpy(prob.u_exact(Tend))).max()),
        niter=[v for _, v in pkg.get_sorted(stats, type='niter', sortby='time')],
        keys=sorted((k.type, k.level, k.iter, k.process, round(k.time, 12)) for k in stats),
        levels=sorted({k.level for k in stats if k.type == 'residual_post_sweep'}),
        nlevels=len(ctrl.MS[0].levels),
        maxiter=desc['step_params']['maxiter'],
    )


@pytest.mark.parametrize('name', list(RUNS))
def test_controller_matches_live_jax_run(name):
    want, got = _run('jax', name), _run('torch', name)
    assert got['niter'] == want['niter']
    assert all(k < got['maxiter'] for k in got['niter'])
    np.testing.assert_allclose(got['uend'], want['uend'], rtol=0, atol=1e-10)
    assert got['keys'] == want['keys']
    assert got['levels'] == want['levels']
    if got['nlevels'] > 1:
        # per-level residual_post_sweep entries: MLSDC and PFASST sweep on every level
        assert got['levels'] == list(range(got['nlevels']))


@pytest.mark.parametrize('num_procs', [1, 2, 4, 8])
def test_pfasst_tutorial_step6_iteration_counts(num_procs):
    """The reference's gate, for the port on its own: 8 steps, every count <= 8, err < 2e-5."""
    got = _run('torch', f'step6-P{num_procs}')
    assert len(got['niter']) == 8
    assert all(k <= 8 for k in got['niter']), got['niter']
    assert got['err'] < 2e-5


def test_two_level_description_builds_and_runs():
    """A per-level ``nvars`` list builds a two-level hierarchy with its transfer."""
    desc = dict(
        problem_class=HeatND,
        problem_params=dict(nvars=[16, 8], device='cpu'),
        sweeper_class=pysdc_tpu_torch.GenericImplicit,
        sweeper_params=dict(num_nodes=3),
        level_params=dict(dt=0.1),
    )
    ctrl = pysdc_tpu_torch.ControllerNonMPI(1, {'logger_level': 40}, desc)
    step = ctrl.MS[0]
    assert [lvl.prob.shape for lvl in step.levels] == [(16,), (8,)] and len(step.base_transfers) == 1
    uend, _ = ctrl.run(step.levels[0].prob.u_exact(0.0), 0.0, 0.1)
    assert uend.shape == (16,) and step.levels[1].uold is not None


def test_mssdc_variants_agree_with_serial_sdc():
    """Gauss-Seidel and Jacobi multi-step SDC over 4 steps against one process marching them."""
    parts, _, _, Tend = RUNS['mssdc-jacobi']
    _, desc = _description('torch', parts)
    ctrl = pysdc_tpu_torch.ControllerNonMPI(1, {'logger_level': 40}, desc)
    uend, _ = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, Tend)
    for name in ('mssdc-gauss-seidel', 'mssdc-jacobi'):
        assert np.abs(_run('torch', name)['uend'] - to_numpy(uend)).max() < 1e-9


def test_galerkin_and_rediscretized_coarse_operators_agree():
    gal, red = _run('torch', 'galerkin'), _run('torch', 'rediscretize')
    assert gal['niter'] == red['niter']
    assert np.abs(gal['uend'] - red['uend']).max() < 1e-8


def test_block_validation_raises():
    from pysdc_tpu_torch.core.errors import ControllerError

    quiet = {'logger_level': 40}
    _, gauss = _description('torch', _step6(sweeper_params=dict(quad_type='GAUSS', num_nodes=[3], QI='LU')))
    with pytest.raises(ControllerError, match='right interval end'):
        pysdc_tpu_torch.ControllerNonMPI(2, quiet, gauss)
    pysdc_tpu_torch.ControllerNonMPI(1, quiet, gauss)  # MLSDC takes any rule
    _, coarse_sweeps = _description('torch', _step6(level_params=dict(dt=0.1, nsweeps=[1, 2])))
    with pytest.raises(ControllerError, match='coarsest-level sweeps'):
        pysdc_tpu_torch.ControllerNonMPI(1, quiet, coarse_sweeps)
    _, plain = _description('torch', _step6())
    ctrl = pysdc_tpu_torch.ControllerNonMPI(1, dict(quiet, predict_type='other'), plain)
    with pytest.raises(ControllerError, match='predict_type'):
        ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, 0.1)
