"""The Allen-Cahn family and the generalized Fisher equation of the PyTorch
port against live runs of the JAX package (float64, CPU), and the slice as a
whole: the fully implicit Allen-Cahn main path (``AllenCahnPeriodicND``,
``GenericImplicit`` M=3 RADAU-RIGHT LU, dt 2e-4, restol 1e-8, 4 steps; the
``'fully_implicit'`` entry of ``examples/step_20_allen_cahn_campaign.py`` at
32^2) through ``ControllerNonMPI`` and through ``ShardedController(4).run``,
where ``'auto'`` picks the fused lane in both packages.

Gates: equal ``niter``; each Newton solve's iteration count and each of its
PCG counts equal to the JAX package's (counted on its side by ordered debug
callbacks, see ``tests/test_torch_solvers.py``); ``uend`` to 1e-11 relative;
the block controller's stats entry for entry.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import pysdc_tpu
import pysdc_tpu.models.allen_cahn as jac
import pysdc_tpu.models.fisher as jfisher
import pysdc_tpu_torch
from pysdc_tpu.sweepers.imex import IMEXSweeper as JaxIMEX
from pysdc_tpu_torch.core.errors import ControllerError
from pysdc_tpu_torch.models import allen_cahn as tac
from pysdc_tpu_torch.models.fisher import GeneralizedFisher1D
from pysdc_tpu_torch.core.state import Comp2
from pysdc_tpu_torch.utils.convert import state_to_torch, to_numpy
from test_torch_solvers import close, jax_solve_events, parse_newton_events

torch.set_num_threads(1)

FRONT = dict(nvars=127, dw=-0.04, eps=0.04, newton_tol=1e-12)
MAIN = dict(nvars=(32, 32), eps=0.04, radius=0.25, newton_tol=1e-10)
LU3 = dict(num_nodes=3, quad_type='RADAU-RIGHT', QI='LU')
# name -> (class name, problem_params, sweeper ('implicit' | 'imex'), sweeper_params, dt, Tend, restol, maxiter)
CASES = {
    'front': ('AllenCahnFront1D', FRONT, 'implicit', LU3, 1e-3, 3e-3, 1e-11, 40),
    'front-semi-implicit': ('AllenCahnFront1DSemiImplicit', FRONT, 'imex', dict(LU3, QE='EE'), 1e-3, 3e-3, 1e-11, 40),
    'front-finel': ('AllenCahnFront1DFinel', FRONT, 'implicit', LU3, 1e-3, 3e-3, 1e-11, 40),
    'fisher': ('GeneralizedFisher1D', dict(nvars=127, nu=1.0, lambda0=2.0), 'implicit', LU3, 0.01, 0.03, 1e-11, 30),
    'periodic-1d': ('AllenCahnPeriodicND', dict(nvars=64, eps=0.1, newton_tol=1e-10), 'implicit', LU3, 1e-3, 3e-3,
                    1e-10, 20),
    'periodic-sparse': ('AllenCahnPeriodicND', dict(nvars=(16, 16), eps=0.1, newton_tol=1e-10, backend='sparse'),
                        'implicit', LU3, 1e-3, 2e-3, 1e-10, 20),
    'main': ('AllenCahnPeriodicND', MAIN, 'implicit', LU3, 2e-4, 8e-4, 1e-8, 12),
    'main-diagonal-QI': ('AllenCahnPeriodicND', MAIN, 'implicit', dict(LU3, QI='MIN-SR-S'), 2e-4, 4e-4, 1e-8, 12),
}


def _classes(name):
    cls = CASES[name][0]
    jmod = jfisher if cls == 'GeneralizedFisher1D' else jac
    return jmod, getattr(jmod, cls), (GeneralizedFisher1D if cls == 'GeneralizedFisher1D' else getattr(tac, cls))


def _description(package, name):
    _, pp, sweeper, sp, dt, _, restol, maxiter = CASES[name]
    jmod, jcls, tcls = _classes(name)
    if package == 'jax':
        pkg, cls = pysdc_tpu, jcls
        sweeper_class = JaxIMEX if sweeper == 'imex' else pysdc_tpu.GenericImplicit
    else:
        pkg, cls, pp = pysdc_tpu_torch, tcls, dict(pp, device='cpu')
        sweeper_class = pkg.IMEXSweeper if sweeper == 'imex' else pkg.GenericImplicit
    return pkg, dict(problem_class=cls, problem_params=dict(pp), sweeper_class=sweeper_class, sweeper_params=dict(sp),
                     level_params=dict(dt=dt, restol=restol), step_params=dict(maxiter=maxiter))


def _summary(pkg, ctrl, uend, stats, trace=None):
    return dict(uend=np.asarray(to_numpy(uend)), niter=[v for _, v in pkg.get_sorted(stats, type='niter', sortby='time')],
                stats=stats, trace=trace, ctrl=ctrl)


@functools.lru_cache(maxsize=None)
def _jax_run(name, controller='nonmpi', num_procs=1):
    """One live JAX run, its Newton solves counted (``ControllerNonMPI``: the block controller's vmap cannot hold
    ordered callbacks, so its runs are compared on counts and fields only)."""
    pkg, desc = _description('jax', name)
    Tend = CASES[name][5]
    jmod = _classes(name)[0]
    if controller == 'nonmpi':
        with jax_solve_events(jmod) as events:
            ctrl = pkg.ControllerNonMPI(num_procs, {'logger_level': 40}, desc)
            uend, stats = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, Tend)
            jax.effects_barrier()
        newton_calls = CASES[name][2] == 'implicit'
        return _summary(pkg, ctrl, uend, stats, parse_newton_events(events) if newton_calls else None)
    ctrl = pkg.ShardedController(num_procs, {'logger_level': 40}, desc)
    uend, stats = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, Tend)
    return _summary(pkg, ctrl, uend, stats)


@functools.lru_cache(maxsize=None)
def _torch_run(name, controller='nonmpi', num_procs=1, lane='auto'):
    pkg, desc = _description('torch', name)
    Tend = CASES[name][5]
    if controller == 'nonmpi':
        ctrl = pkg.ControllerNonMPI(num_procs, {'logger_level': 40}, desc)
    else:
        ctrl = pkg.ShardedController(num_procs, {'logger_level': 40}, desc)
    prob = ctrl.MS[0].levels[0].prob
    prob.solver_trace = []
    kwargs = {} if controller == 'nonmpi' else dict(lane=lane)
    uend, stats = ctrl.run(prob.u_exact(0.0), 0.0, Tend, **kwargs)
    return _summary(pkg, ctrl, uend, stats, prob.solver_trace)


@pytest.mark.parametrize('name', [n for n in CASES if n != 'main-diagonal-QI'])
def test_controller_nonmpi_matches_live_jax_run(name):
    want, got = _jax_run(name), _torch_run(name)
    assert got['niter'] == want['niter'] and len(got['niter']) >= 2
    assert all(0 < k < CASES[name][7] for k in got['niter'])
    close(got['uend'], want['uend'])
    if want['trace'] is not None:
        assert got['trace'] == want['trace'] and len(got['trace']) > 0
        assert max(k for k, _ in got['trace']) >= 1


def test_diagonal_QI_solves_all_nodes_in_one_batched_newton():
    """MIN-SR-S: the M node solves are one ``solve_system_batched``, each node its own Newton system with its own
    shift and flags (the JAX package's per-node solves)."""
    want, got = _jax_run('main-diagonal-QI'), _torch_run('main-diagonal-QI')
    assert got['niter'] == want['niter']
    close(got['uend'], want['uend'])
    prob = got['ctrl'].MS[0].levels[0].prob
    assert len(got['trace']) == 3 * sum(got['niter'])  # one entry per node and sweep
    assert prob.work_counters['newton'].niter == 3 * sum(got['niter'])


def test_slice_main_path_on_both_lanes_of_the_block_controller():
    """The main path through ``ShardedController(4).run``: ``'auto'`` picks the fused lane in both packages; the
    port's fused and stage lanes equal the JAX run in ``niter``, ``uend`` and every stats entry."""
    want = _jax_run('main', 'sharded', 4)
    assert [v for k, v in want['stats'].items() if k.type == 'lane'] == ['fused']
    serial = _torch_run('main')
    key = lambda k: (k.type, k.process, round(k.time, 10), k.level, k.iter, k.sweep)  # noqa: E731
    theirs = {key(k): v for k, v in want['stats'].items() if k.type != 'lane'}
    for lane in ('auto', 'stage'):
        got = _torch_run('main', 'sharded', 4, lane)
        assert [v for k, v in got['stats'].items() if k.type == 'lane'] == ['fused' if lane == 'auto' else 'stage']
        assert got['niter'] == want['niter'] and max(got['niter']) > max(serial['niter'])
        close(got['uend'], want['uend'])
        if lane == 'auto':
            assert got['ctrl'].host_reads['fetch'] == 1
            ours = {key(k): v for k, v in got['stats'].items() if k.type != 'lane'}
            assert set(ours) == set(theirs)
            for k, v in theirs.items():
                assert np.isclose(ours[k], v, rtol=1e-6, atol=1e-13), k
    assert not bool(got['ctrl'].MS[0].levels[0].prob.newton_failed)


def test_sparse_backend_runs_on_the_stage_lane_and_names_why():
    """The sparse backend's preconditioner is an iterative CG: a CUDA graph would hold its maxiter masked
    iterations, so the fused lane refuses it by name before any capture and ``'auto'`` takes the stage lane."""
    own, got = _torch_run('periodic-sparse', 'nonmpi', 2), _torch_run('periodic-sparse', 'sharded', 2, 'auto')
    assert [v for k, v in got['stats'].items() if k.type == 'lane'] == ['stage']
    assert got['niter'] == own['niter'] and len(got['niter']) == 2
    close(got['uend'], own['uend'])
    pkg, desc = _description('torch', 'periodic-sparse')
    ctrl = pkg.ShardedController(2, {'logger_level': 40}, desc)
    assert ctrl.MS[0].levels[0].prob.A.solver_kind == 'cg'
    with pytest.raises(ControllerError, match='stage-machine path'):
        ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, 2e-3, lane='fused')


@pytest.mark.parametrize('linear', [False, True])
def test_multi_implicit_problem_solves_directly(linear):
    """``AllenCahnPeriodicMultiImplicitND`` (its sweeper: tests/test_torch_sweepers.py): ``eval_f``'s two components, the
    linear solve and the pointwise Newton ``solve_system_2`` against the JAX class on a seeded field."""
    jprob = jac.AllenCahnPeriodicMultiImplicitND(nvars=(16, 16), eps=0.1, newton_tol=1e-12)
    tprob = tac.AllenCahnPeriodicMultiImplicitND(nvars=(16, 16), eps=0.1, newton_tol=1e-12, device='cpu')
    rng = np.random.default_rng(11)
    u = np.asarray(jprob.u_exact(0.0)) + 0.02 * rng.standard_normal((16, 16))
    rhs = u + 0.01 * rng.standard_normal((16, 16))
    tu, trhs = torch.as_tensor(u), torch.as_tensor(rhs)
    fj, ft = jprob.eval_f(u, 0.0), tprob.eval_f(tu, 0.0)
    assert type(ft).__name__ == 'Comp2'
    close(ft.comp1, fj.comp1)
    close(ft.comp2, fj.comp2)
    # a level state with the JAX package's Comp2 right-hand side carries over to the port's Comp2
    carried = state_to_torch((u, fj, np.zeros_like(u)), 'cpu')
    assert isinstance(carried.f, Comp2) and torch.equal(carried.f.comp2, torch.as_tensor(np.asarray(fj.comp2)))
    factor = 2e-3
    if linear:
        close(tprob.solve_system(trhs, factor, tu, 0.0), jprob.solve_system(rhs, factor, u, 0.0))
        return
    tprob.solver_trace = []
    with jax_solve_events(jac) as events:
        want = jprob.solve_system_2(rhs, factor, u, 0.0)
        jax.block_until_ready(want)
        jax.effects_barrier()
    close(tprob.solve_system_2(trhs, factor, tu, 0.0), want)
    assert tprob.solver_trace == parse_newton_events(events) and tprob.solver_trace[0][0] >= 2


def test_front_boundary_term_takes_a_tensor_of_times():
    """``_bc_term`` of a tensor of times (the node times of a block) stacks one boundary row per time."""
    prob = tac.AllenCahnFront1D(nvars=31, device='cpu')
    ts = torch.tensor([0.0, 1e-3, 2e-3], dtype=torch.float64)
    rows = prob._bc_term(ts)
    assert rows.shape == (3, 31)
    for i, t in enumerate(ts.tolist()):
        assert torch.equal(rows[i], prob._bc_term(t))
