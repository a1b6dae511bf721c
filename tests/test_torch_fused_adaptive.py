"""The adaptive fused lane of the PyTorch port (``run_fused_adaptive``) against
the stage machines of both packages and the JAX package's own adaptive lane
(float64, CPU, where the lane's pieces run eagerly).

The port's twins of the adaptive cases of tests/test_fused.py: equal ``niter``
and ``restart`` per step, ``dt`` and estimate entries to rtol 1e-7 (1e-5 for
the Allen-Cahn block), ``uend`` to 1e-10 (1e-8).  One block program serves
every step size of a march, on the plain and on the adaptive lane.
"""

import functools

import numpy as np
import pytest
import torch

import pysdc_tpu
import pysdc_tpu_torch
from pysdc_tpu_torch.core.errors import ControllerError
from pysdc_tpu_torch.core.hooks import Hooks
from pysdc_tpu_torch.models import odes
from pysdc_tpu_torch.ops import loops
from pysdc_tpu_torch.parallel import fused
from pysdc_tpu_torch.utils.convert import dts_to_torch, to_numpy, to_torch
from test_torch_adaptivity import (
    JAC,
    allen_cahn,
    assert_parity,
    description,
    entries,
    summary,
    tolerances,
    vdp,
)

RUNS = {
    # tests/test_fused.py:281, 301, 320, 343 (the Allen-Cahn block with a shorter horizon)
    'vdp-single-step': (vdp({'Adaptivity': {'e_tol': 1e-7}}), 1, {}, 0.25),
    'vdp-block': (vdp({'Adaptivity': {'e_tol': 1e-7}}, maxiter=7, dt=2e-2), 4, JAC, 0.24),
    'ac-pfasst-block': (allen_cahn({'Adaptivity': {'e_tol': 1e-7, 'dt_max': 5e-3, 'dt_min': 1e-5}}), 4,
                        {'predict_type': 'pfasst_burnin'}, 1e-3),
    'vdp-linearized-block': (vdp({'Adaptivity': {'e_tol': 1e-7, 'embedded_error_flavor': 'linearized'}}, maxiter=7),
                             4, JAC, 0.25),
    # beyond them
    'vdp-gauss-seidel': (vdp({'Adaptivity': {'e_tol': 1e-6}}, maxiter=5), 3, {'mssdc_jac': False}, 0.1),
    'vdp-rel-error-rounding': (vdp({'Adaptivity': {'e_tol': 1e-7, 'rel_error': True}, 'StepSizeRounding': {}}),
                               2, JAC, 0.1),
    'vdp-slope-averaged': (vdp({'Adaptivity': {'e_tol': 1e-6, 'dt_slope_max': 1.3},
                                'EstimateEmbeddedErrorLinearized': {'averaged': True}}, maxiter=5), 2, JAC, 0.1),
    'ac-fine-only': (allen_cahn({'Adaptivity': {'e_tol': 1e-6, 'dt_max': 2e-3}}, maxiter=3), 2,
                     {'predict_type': 'fine_only'}, 2e-3),
}
LIVE_JAX = ('vdp-single-step', 'vdp-block', 'ac-pfasst-block', 'vdp-linearized-block')


def _run(package, kind, name, lane='auto'):
    parts, num_procs, controller_params, Tend = RUNS[name]
    pkg, desc = description(package, parts)
    cls = pkg.ControllerNonMPI if kind == 'virtual' else pkg.ShardedController
    ctrl = cls(num_procs, {'logger_level': 40, **controller_params}, desc)
    kwargs = {'lane': lane} if kind == 'block' else {}
    uend, stats = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, Tend, **kwargs)
    return summary(pkg, ctrl, uend, stats)


@functools.lru_cache(maxsize=None)
def virtual(package, name):
    return _run(package, 'virtual', name)


@functools.lru_cache(maxsize=None)
def adaptive(name):
    """The port's block controller through ``run()``: ``lane='auto'`` must pick the adaptive fused lane."""
    return _run('torch', 'block', name)


def _lane_of(stats):
    return [v for k, v in stats.items() if k.type == 'lane']


@pytest.mark.parametrize('name', LIVE_JAX)
def test_fused_adaptive_matches_live_jax_stage_machine(name):
    got = adaptive(name)
    assert _lane_of(got['stats']) == ['fused_adaptive']
    assert_parity(virtual('jax', name), got, *tolerances(name))


@pytest.mark.parametrize('name', list(RUNS))
def test_fused_adaptive_matches_own_stage_machine(name):
    got = adaptive(name)
    assert _lane_of(got['stats']) == ['fused_adaptive']
    assert_parity(virtual('torch', name), got, *tolerances(name))
    if name in LIVE_JAX:
        assert sum(v for _, v in entries(got, 'restart')) >= 1


def test_fused_adaptive_matches_live_jax_adaptive_lane():
    """The JAX package's own ``ShardedController.run`` on the adaptive lane: the stats equal entry for entry."""
    name = 'vdp-block'
    parts, num_procs, controller_params, Tend = RUNS[name]
    pkg, desc = description('jax', parts)
    ctrl = pkg.ShardedController(num_procs, {'logger_level': 40, **controller_params}, desc)
    uend, stats = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, Tend)
    got = adaptive(name)
    assert _lane_of(stats) == _lane_of(got['stats']) == ['fused_adaptive']
    np.testing.assert_allclose(got['uend'], np.asarray(uend), rtol=0, atol=1e-10)
    key = lambda k: (k.type, k.process, round(k.time, 9), k.level, k.iter, k.sweep, k.num_restarts)  # noqa: E731
    timed = lambda k: k.type.startswith('timing')  # noqa: E731
    theirs = {key(k): v for k, v in stats.items() if not timed(k)}
    ours = {key(k): v for k, v in got['stats'].items() if not timed(k)}
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        assert ours[k] == v if isinstance(v, str) else np.isclose(ours[k], v, rtol=1e-7, atol=1e-11), k
    assert {key(k) for k in stats if timed(k)} == {key(k) for k in got['stats'] if timed(k)}


def test_run_autodispatch_lanes():
    """Default ``run()`` picks the fused lane for eligible configs, the adaptive fused lane for the adaptivity
    stack (both estimator flavors) and the stage machine otherwise, ``AdaptivityResidual`` among them
    (tests/test_fused.py:205-248)."""
    Tend = 3e-2

    def controller(cc, **kw):
        parts = vdp(cc, **kw)
        if not cc:
            parts['level_params']['restol'] = 1e-8
        pkg, desc = description('torch', parts)
        return pkg.ShardedController(2, {'logger_level': 40}, desc)

    sh = controller({})
    u0 = sh.MS[0].levels[0].prob.u_exact(0.0)
    assert _lane_of(sh.run(u0, 0.0, Tend)[1]) == ['fused']
    assert _lane_of(controller({'Adaptivity': {'e_tol': 1e-6}}).run(u0, 0.0, Tend)[1]) == ['fused_adaptive']
    lin = controller({'Adaptivity': {'e_tol': 1e-6, 'embedded_error_flavor': 'linearized'}})
    assert _lane_of(lin.run(u0, 0.0, Tend)[1]) == ['fused_adaptive']
    assert _lane_of(lin.run(u0, 0.0, Tend, lane='stage')[1]) == ['stage']
    res = controller({'AdaptivityResidual': {'e_tol': 1e3, 'max_restol': 1e-11}})
    assert _lane_of(res.run(u0, 0.0, Tend)[1]) == ['stage']


def test_fused_adaptive_rk_cash_karp():
    """Embedded-RK adaptivity (``AdaptivityRK`` with the Cash-Karp pair, tests/test_fused.py:363) through the
    adaptive fused lane: ``run()`` takes it, and it equals the JAX package's stage machine and its adaptive lane
    (``dt`` to 1e-7, ``uend`` to 1e-10; the estimate entries, the check-#0 eps floor included, entry for entry)."""
    from pysdc_tpu.sweepers.runge_kutta import Cash_Karp as JaxCashKarp
    from pysdc_tpu_torch.sweepers.runge_kutta import Cash_Karp

    Tend = 0.5
    runs = {}
    for package, sweeper in (('jax', JaxCashKarp), ('torch', Cash_Karp)):
        parts = vdp({'AdaptivityRK': {'e_tol': 1e-7, 'update_order': 5}}, maxiter=1)
        parts['sweeper_params'] = {}
        pkg, desc = description(package, parts)
        desc['sweeper_class'] = sweeper
        for kind in ('virtual', 'block'):
            cls = pkg.ControllerNonMPI if kind == 'virtual' else pkg.ShardedController
            ctrl = cls(1, {'logger_level': 40}, desc)
            uend, stats = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, Tend)
            runs[package, kind] = summary(pkg, ctrl, uend, stats)
    got = runs['torch', 'block']
    assert _lane_of(got['stats']) == _lane_of(runs['jax', 'block']['stats']) == ['fused_adaptive']
    for want in (runs['jax', 'virtual'], runs['jax', 'block'], runs['torch', 'virtual']):
        assert_parity(want, got, 1e-7, 1e-10)
    assert len(entries(got, 'dt')) > 10 and len({round(v, 12) for _, v in entries(got, 'dt')}) > 3


def test_fused_adaptive_on_device_mesh():
    """The adaptive lane under a mesh (tests/test_fused.py:384) waits for the mesh half of the block controller."""
    pkg, desc = description('torch', vdp({'Adaptivity': {'e_tol': 1e-6}}))
    with pytest.raises(ControllerError, match='ROADMAP queue 1, item 10b'):
        pkg.ShardedController(4, {'logger_level': 40}, desc, mesh=object())


def test_lane_stats_contract():
    """The adaptive half of the per-lane stats contract (tests/test_fused.py:455-469)."""
    from pysdc_tpu_torch.convergence import Adaptivity
    from pysdc_tpu_torch.models.heat import HeatND

    desc = dict(
        problem_class=HeatND,
        problem_params=dict(nu=0.1, freq=2, nvars=[(32, 32), (16, 16)], bc='periodic', device='cpu'),
        sweeper_class=pysdc_tpu_torch.GenericImplicit,
        sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=[3], QI='LU'),
        level_params=dict(restol=-1.0, dt=0.05),
        step_params=dict(maxiter=4),
        space_transfer_params=dict(rorder=2, iorder=2, periodic=True),
        convergence_controllers={Adaptivity: {'e_tol': 1e-6}},
    )
    cp = {'logger_level': 40, 'predict_type': 'pfasst_burnin'}
    base = {'dt', 'lane', 'niter', 'residual_post_iteration', 'residual_post_step', 'restart'}
    timings = {'timing_run', 'timing_step', 'timing_iteration'}
    emb = {'error_embedded_estimate', 'error_embedded_estimate_post_step'}
    expected = {
        'stage': base | timings | {'timing_sweep', 'residual_post_sweep'} | emb,
        'fused_adaptive': base | timings | emb,
    }
    uends = {}
    for lane, want in expected.items():
        c = pysdc_tpu_torch.ShardedController(2, cp, desc)
        assert c.coarse_mode == 'diag'
        u0 = c.MS[0].levels[0].prob.u_exact(0.0)
        uends[lane], stats = c.run(u0, 0.0, 0.2, lane=lane)
        got = {k.type for k in stats}
        assert got == want, f'adaptive-{lane}: {sorted(got ^ want)}'
        for value in stats.values():
            assert isinstance(value, (int, float, str)) and not isinstance(value, torch.Tensor)
    assert float((uends['stage'] - uends['fused_adaptive']).abs().max()) < 1e-10  # measured 9.8e-12


def test_fused_imex_problem():
    """IMEX split RHS through the plain fused loop on the Allen-Cahn problem (tests/test_fused.py:147), against
    live runs of both packages' virtual controllers."""
    parts = allen_cahn({}, restol=1e-9, maxiter=50)
    cp = {'logger_level': 40, 'predict_type': 'pfasst_burnin'}
    runs = {}
    for package in ('jax', 'torch'):
        pkg, desc = description(package, parts)
        ctrl = pkg.ControllerNonMPI(4, cp, desc)
        runs[package] = summary(pkg, ctrl, *ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, 4e-3))
    pkg, desc = description('torch', parts)
    sh = pkg.ShardedController(4, cp, desc)
    u_fu, s_fu = sh.run_fused(sh.MS[0].levels[0].prob.u_exact(0.0), 0.0, 4e-3)
    niter = lambda st, p: [int(v) for _, v in p.get_sorted(st, type='niter')]  # noqa: E731
    assert niter(s_fu, pkg) == niter(runs['torch']['stats'], pkg) == niter(runs['jax']['stats'], pysdc_tpu)
    assert max(niter(s_fu, pkg)) > 1
    np.testing.assert_allclose(to_numpy(u_fu), runs['jax']['uend'], rtol=0, atol=1e-10)
    np.testing.assert_allclose(to_numpy(u_fu), runs['torch']['uend'], rtol=0, atol=1e-11)
    assert _lane_of(sh.run(sh.MS[0].levels[0].prob.u_exact(0.0), 0.0, 4e-3)[1]) == ['fused']


# -- one program for every dt ------------------------------------------------
@pytest.mark.parametrize('name', ['vdp-block', 'ac-pfasst-block', 'vdp-single-step'])
def test_one_program_serves_every_step_size(name):
    """Three pieces, built once, over a march in which ``dt`` takes at least three values; no ``cont`` read, one
    fetch a block."""
    got = adaptive(name)
    ctrl = got['ctrl']
    assert len({round(v, 14) for _, v in entries(got, 'dt')}) >= 3
    programs = ctrl._fused_adaptive_fn._programs
    assert len(programs) == 1
    (key,) = programs
    assert not any(isinstance(part, float) for part in key)
    prob = ctrl.MS[0].levels[0].prob
    assert key == (prob.dtype, prob.device, prob.shape)
    steps = len(entries(got, 'niter'))  # every step a block ran, the rejected ones too
    assert ctrl.host_reads['cont'] == 0
    assert steps / RUNS[name][1] <= ctrl.host_reads['fetch'] <= steps  # one fetch a block
    assert ctrl.host_reads['estimate'] == steps  # the final check's estimator reads one norm a step


def test_one_program_two_step_sizes_equal_two_fresh_controllers():
    """What a frozen host ``dt`` would break: the block function called with two sets of per-level step sizes (the
    second one a rejected block's: a new fine ``dt``, the old coarse one) equals fresh controllers' first calls."""
    parts = RUNS['ac-pfasst-block'][0]
    cp = {'logger_level': 40, 'predict_type': 'pfasst_burnin'}

    def fresh():
        pkg, desc = description('torch', parts)
        ctrl = pkg.ShardedController(4, cp, desc)
        return ctrl, fused.build_fused_adaptive_block(ctrl)

    ctrl, fn = fresh()
    u0 = ctrl.MS[0].levels[0].prob.u_exact(0.0)
    window = np.array([True, True, True, False])
    calls = [([1e-3, 1e-3], 0.0), ([2.5e-4, 1e-3], 0.0), (dts_to_torch([4e-4, 5e-4], 'cpu'), 1e-3)]
    for dts, t0 in calls:
        t_arr = t0 + float(dts[0]) * np.arange(4)
        state, uend, res, est, prev, _ = fn(u0, t_arr, dts, window)
        _, other = fresh()
        s2, u2, r2, e2, p2, _ = other(u0, t_arr, dts, window)
        assert torch.equal(uend, u2) and torch.equal(res, r2) and torch.equal(est, e2) and torch.equal(prev, p2)
        assert torch.equal(state.u, s2.u) and torch.equal(state.f.expl, s2.f.expl)
        assert float(res[1:, :3].min()) > 0 and float(res[:, 3].abs().max()) == 0  # the inactive step records nothing
        assert float(est[0].abs().max()) == 0 and float(est[1:, :3].min()) > 0
    assert len(fn._programs) == 1
    assert prev.shape == (4, 32, 32) and res.shape == est.shape == (5, 4)


def test_adaptive_block_program_matches_live_jax_program():
    """``build_fused_adaptive_block`` of both packages on one rejected block: the same ``u0``, times, window and
    per-level ``dts`` (fine 2.5e-4, coarse 1e-3) give the same histories, end values and ``prev_last``."""
    import jax

    from pysdc_tpu.parallel.fused import build_fused_adaptive_block as jax_build

    parts = RUNS['ac-pfasst-block'][0]
    cp = {'logger_level': 40, 'predict_type': 'pfasst_burnin'}
    rng = np.random.RandomState(11)
    pkg, desc = description('jax', parts)
    jctrl = pkg.ShardedController(4, cp, desc)
    u0 = np.asarray(jctrl.MS[0].levels[0].prob.u_exact(0.0)) + 0.01 * rng.standard_normal((32, 32))
    dts = np.array([2.5e-4, 1e-3])
    t_arr = 0.3 + dts[0] * np.arange(4)
    window = np.array([True, True, True, False])
    jstate, juend, jres, jest, jprev = jax.jit(jax_build(jctrl))(u0, t_arr, dts, window)

    pkg, desc = description('torch', parts)
    ctrl = pkg.ShardedController(4, cp, desc)
    state, uend, res, est, prev, flags = fused.build_fused_adaptive_block(ctrl)(
        to_torch(u0, 'cpu'), t_arr, dts_to_torch(dts, 'cpu'), window)
    assert flags == []  # the Allen-Cahn solve is linear: no Newton flag
    np.testing.assert_allclose(to_numpy(res), np.asarray(jres), rtol=1e-7, atol=1e-13)
    np.testing.assert_allclose(to_numpy(est), np.asarray(jest), rtol=1e-7, atol=1e-13)
    np.testing.assert_allclose(to_numpy(uend)[:3], np.asarray(juend)[:3], rtol=0, atol=1e-11)
    np.testing.assert_allclose(to_numpy(prev)[:3], np.asarray(jprev)[:3], rtol=0, atol=1e-11)
    # the port keeps the node axis first, (M+1, P, ...); the JAX package the time axis, (P, M+1, ...)
    np.testing.assert_allclose(to_numpy(state.u)[:, :3], np.moveaxis(np.asarray(jstate.u), 0, 1)[:, :3], rtol=0, atol=1e-11)


def test_plain_lane_program_has_no_dt_in_its_key():
    from test_torch_fused import _block

    ctrl = _block('periodic2d-P4', 'fused')['ctrl']
    (key,) = ctrl._fused_fn._programs
    assert not any(isinstance(part, float) for part in key)


# -- eligibility, restarts, the Newton flag ------------------------------------
class _PerSweepHook(Hooks):
    """A hook the adaptive lane cannot serve."""


def test_adaptive_eligibility():
    from pysdc_tpu_torch.hooks.logging_hooks import LogEmbeddedErrorEstimate, LogSolution, LogStepSize

    def controller(parts, **cp):
        pkg, desc = description('torch', parts)
        return pkg.ShardedController(2, {'logger_level': 40, **cp}, desc)

    ok = controller(vdp({'Adaptivity': {'e_tol': 1e-6}, 'StepSizeRounding': {}, 'StepSizeSlopeLimiter': {}}),
                    hook_class=[LogSolution, LogStepSize, LogEmbeddedErrorEstimate])
    fused.check_fused_adaptive_eligibility(ok)
    u0 = ok.MS[0].levels[0].prob.u_exact(0.0)
    _, stats = ok.run_fused(u0, 0.0, 0.02)  # run_fused routes an adaptive configuration to the adaptive lane
    assert {'u', 'dt', 'error_embedded_estimate'} <= {k.type for k in stats}
    with pytest.raises(ControllerError, match='only restol/maxiter termination'):
        fused.check_fused_eligibility(ok)

    bad_hook = controller(vdp({'Adaptivity': {'e_tol': 1e-6}}), hook_class=[_PerSweepHook])
    with pytest.raises(ControllerError, match='_PerSweepHook needs per-sweep data the adaptive fused lane'):
        bad_hook.run_fused(u0, 0.0, 0.02)
    assert _lane_of(bad_hook.run(u0, 0.0, 0.02)[1]) == ['stage']

    e_tol = controller(vdp({}, e_tol=1e-8))
    with pytest.raises(ControllerError, match='does not support e_tol termination'):
        fused.check_fused_adaptive_eligibility(e_tol)
    assert _lane_of(e_tol.run(u0, 0.0, 0.02)[1]) == ['stage']

    flex = vdp({'Adaptivity': {'e_tol': 1e-6}})
    flex['sweeper_params'] = dict(flex['sweeper_params'], QI='MIN-SR-FLEX')
    with pytest.raises(ControllerError, match='iteration-independent'):
        fused.check_fused_adaptive_eligibility(controller(flex))


def test_restart_reruns_the_block_from_the_same_state():
    """After a restart the program's buffers hold the rejected block: ``start`` overwrites all of it.  The accepted
    steps tile the horizon (each starts where its predecessor ended) and a rejected step's time point comes
    again with a smaller ``dt``; parity with the stage machines holds the values."""
    got = adaptive('vdp-block')
    dts = entries(got, 'dt')
    flags = [r for _, r in entries(got, 'restart')]
    assert len(dts) == len(flags) and sum(flags) >= 4
    accepted = [(t, v) for (t, v), r in zip(dts, flags) if not r]
    rejected = [(t, v) for (t, v), r in zip(dts, flags) if r]
    first = rejected[0]
    again = [v for t, v in accepted if abs(t - first[0]) < 1e-12]
    assert len(again) == 1 and again[0] < first[1]  # the same time point again, with a smaller dt
    times = [t for t, _ in accepted]
    np.testing.assert_allclose(np.diff(times), [v for _, v in accepted][:-1], rtol=0, atol=1e-12)
    assert times[-1] < RUNS['vdp-block'][3] <= times[-1] + accepted[-1][1] + 1e-12  # the tail block reaches Tend


def test_returned_uend_is_not_a_view_of_the_program_buffers():
    parts, num_procs, cp, Tend = RUNS['vdp-gauss-seidel']
    pkg, desc = description('torch', parts)
    ctrl = pkg.ShardedController(num_procs, {'logger_level': 40, **cp}, desc)
    u0 = ctrl.MS[0].levels[0].prob.u_exact(0.0)
    first, _ = ctrl.run(u0, 0.0, Tend)
    kept = first.clone()
    ctrl.run(u0, 0.0, Tend / 2)
    assert torch.equal(first, kept)
    np.testing.assert_allclose(to_numpy(first), adaptive('vdp-gauss-seidel')['uend'], rtol=0, atol=1e-13)


def test_newton_flag_of_a_captured_block_raises(monkeypatch):
    """A Newton solve that the fixed depth of a capture cuts short sets the device flag; the block's one fetch
    brings it to the host, which raises."""
    parts, num_procs, cp, _ = RUNS['vdp-block']
    pkg, desc = description('torch', parts)
    ctrl = pkg.ShardedController(num_procs, {'logger_level': 40, **cp}, desc)
    u0 = ctrl.MS[0].levels[0].prob.u_exact(0.0)
    monkeypatch.setattr(loops, 'capturing', lambda u: True)  # the masked loop's and the solve's test
    uend, _ = ctrl.run(u0, 0.0, 0.04)  # depth 8 is enough: the flag stays clear
    assert torch.isfinite(uend).all() and not bool(ctrl.blocks[0].level.prob.newton_failed)
    monkeypatch.setattr(odes, 'CAPTURE_DEPTH', 1)
    with pytest.raises(ControllerError, match='did not reach newton_tol'):
        ctrl.run(u0, 0.0, 0.04)
