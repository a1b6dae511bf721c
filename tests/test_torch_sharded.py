"""The time axis through the numeric core of the PyTorch port, and the block
controller's stage lane against the virtual controller (float64, CPU).

A block of P steps is a state with leaves ``(M+1, P, *shape)`` and times
``(P,)``.  Each batched function equals the one-step function applied to each
slice (1e-13); a masked step keeps its data bit for bit; the stage lane's
stats equal the virtual controller's entry for entry.
"""

import functools

import numpy as np
import pytest
import torch

import pysdc_tpu_torch
from pysdc_tpu_torch import ControllerNonMPI, GenericImplicit, IMEXSweeper, ShardedController
from pysdc_tpu_torch.core.state import IMEX, LevelState, components, map_components
from pysdc_tpu_torch.models.heat import HeatND, HeatNDForced
from pysdc_tpu_torch.parallel.sharded import _BlockLevel, _BlockTransfer, _step_of, _where_mask

P, DT = 4, 0.05
TOL = dict(rtol=0, atol=1e-13)
KINDS = {
    'implicit-LU': (HeatND, GenericImplicit, dict(QI='LU')),
    'implicit-diagonal': (HeatND, GenericImplicit, dict(QI='MIN-SR-S')),
    'imex': (HeatNDForced, IMEXSweeper, dict(QI='LU', QE='EE')),
    'imex-diagonal': (HeatNDForced, IMEXSweeper, dict(QI='IEpar', QE='PIC')),
}


@functools.lru_cache(maxsize=None)
def _step(kind, two_levels=False):
    """A step's template levels (periodic 16^2, and 8^2 below it) for ``kind``."""
    problem, sweeper, qs = KINDS[kind]
    desc = dict(
        problem_class=problem,
        problem_params=dict(nu=0.1, freq=2, nvars=[(16, 16), (8, 8)] if two_levels else (16, 16), bc='periodic',
                            device='cpu'),
        sweeper_class=sweeper,
        sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=[3, 2] if two_levels else 3, **qs),
        level_params=dict(dt=DT, restol=1e-10),
        space_transfer_params=dict(rorder=2, iorder=6, periodic=True),
    )
    return ControllerNonMPI(1, {'logger_level': 40}, desc).MS[0]


def _block_state(level, seed):
    """A block state from numpy noise: u anything, f = f(u) at the node times, tau anything."""
    rng = np.random.default_rng(seed)
    M = level.sweep.coll.num_nodes
    shape = level.prob.shape
    t_arr = torch.as_tensor(0.3 + DT * np.arange(P))
    u = torch.as_tensor(rng.standard_normal((M + 1, P) + shape))
    tau = torch.as_tensor(0.1 * rng.standard_normal((M, P) + shape))
    steps = []
    for j in range(P):
        f0 = level.prob.eval_f(u[0, j], float(t_arr[j]))
        fn = level.prob.eval_f_batched(u[1:, j], level.sweep.node_times(float(t_arr[j]), DT))
        steps.append(map_components(lambda a, b: torch.cat([a.unsqueeze(0), b]), f0, fn))
    f = map_components(lambda *leaves: torch.stack(leaves, dim=1), *steps)
    return LevelState(u=u, f=f, tau=tau), t_arr


def _assert_state_close(got: LevelState, want: LevelState, exact=False):
    for a, b in zip((got.u, *components(got.f), got.tau), (want.u, *components(want.f), want.tau)):
        if exact:
            assert torch.equal(a, b)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize('kind', list(KINDS))
def test_predict_over_a_block_equals_each_step(kind):
    level = _step(kind).levels[0]
    blk = _BlockLevel(level, P)
    rng = np.random.default_rng(0)
    u0 = torch.as_tensor(rng.standard_normal((P,) + level.prob.shape))
    t_arr = torch.as_tensor(0.3 + DT * np.arange(P))
    got = blk.predict(u0, t_arr, DT)
    assert got.u.shape == (4, P, 16, 16) and got.tau.shape == (3, P, 16, 16)
    for j in range(P):
        want = level.sweep.predict(level.prob, u0[j], float(t_arr[j]), DT)
        _assert_state_close(_step_of(got, j), want)


@pytest.mark.parametrize('kind', list(KINDS))
def test_sweep_over_a_block_equals_each_step_and_masks_hold(kind):
    level = _step(kind).levels[0]
    blk = _BlockLevel(level, P)
    state, t_arr = _block_state(level, 1)
    active = torch.tensor([True, False, True, True])
    got = blk.sweep(state, t_arr, DT, active, 0)
    for j in range(P):
        old = _step_of(state, j)
        if active[j]:
            _assert_state_close(_step_of(got, j), level.sweep.update_nodes(level.prob, old, float(t_arr[j]), DT, 0))
        else:
            _assert_state_close(_step_of(got, j), old, exact=True)


@pytest.mark.parametrize('residual_type', ['full_abs', 'last_abs', 'full_rel', 'last_rel'])
@pytest.mark.parametrize('kind', ['implicit-LU', 'imex'])
def test_residual_over_a_block_is_one_norm_per_step(kind, residual_type):
    level = _step(kind).levels[0]
    state, _ = _block_state(level, 2)
    res, norms = level.sweep.compute_residual(state, DT, residual_type, time_axis=True)
    assert norms.shape == (P,) and res.shape == (3, P, 16, 16)
    for j in range(P):
        res_j, norm_j = level.sweep.compute_residual(_step_of(state, j), DT, residual_type)
        np.testing.assert_allclose(res[:, j].numpy(), res_j.numpy(), **TOL)
        np.testing.assert_allclose(float(norms[j]), float(norm_j), **TOL)
    blk = _BlockLevel(level, P)
    np.testing.assert_allclose(blk.residual(state, DT).numpy(),
                               level.sweep.compute_residual(state, DT, 'full_abs', time_axis=True)[1].numpy(), **TOL)


@pytest.mark.parametrize('quad_type', ['RADAU-RIGHT', 'GAUSS'])
@pytest.mark.parametrize('kind', ['implicit-LU', 'imex'])
def test_end_point_and_integral_over_a_block(kind, quad_type):
    """Both branches of ``compute_end_point``: the last node, and the collocation update of a GAUSS rule."""
    problem, sweeper, qs = KINDS[kind]
    level = _step(kind).levels[0]
    sweep = sweeper(dict(num_nodes=3, quad_type=quad_type, **qs))
    state, t_arr = _block_state(level, 3)
    stand_in = type(level)(level.prob, sweep, dict(dt=DT))
    blk = _BlockLevel(stand_in, P)
    uend_old = torch.as_tensor(np.random.default_rng(4).standard_normal((P, 16, 16)))
    active = torch.tensor([True, True, False, True])
    got = blk.endpoint(state, t_arr, DT, active, uend_old)
    integral = sweep.integrate(state, DT)
    for j in range(P):
        step = _step_of(state, j)
        want = sweep.compute_end_point(step, float(t_arr[j]), DT) if active[j] else uend_old[j]
        np.testing.assert_allclose(got[j].numpy(), want.numpy(), **TOL)
        np.testing.assert_allclose(integral[:, j].numpy(), sweep.integrate(step, DT).numpy(), **TOL)
    assert torch.equal(got[2], uend_old[2])


@pytest.mark.parametrize('kind', ['implicit-LU', 'imex'])
def test_shift_recv_over_a_block(kind):
    """u0 of step j from uend of step j-1 where the mask says so, f at node 0 evaluated again there."""
    level = _step(kind).levels[0]
    blk = _BlockLevel(level, P)
    state, t_arr = _block_state(level, 5)
    uend = torch.as_tensor(np.random.default_rng(6).standard_normal((P, 16, 16)))
    recv = torch.tensor([False, True, False, True])
    got = blk.shift_recv(state, uend, t_arr, recv)
    for j in range(P):
        old = _step_of(state, j)
        if not recv[j]:
            _assert_state_close(_step_of(got, j), old, exact=True)
            continue
        f0 = level.prob.eval_f(uend[j - 1], float(t_arr[j]))
        want = LevelState(
            u=torch.cat([uend[j - 1].unsqueeze(0), old.u[1:]]),
            f=map_components(lambda leaf, new: torch.cat([new.unsqueeze(0), leaf[1:]]), old.f, f0),
            tau=old.tau,
        )
        _assert_state_close(_step_of(got, j), want)


@pytest.mark.parametrize('kind', ['implicit-LU', 'imex'])
def test_restrict_and_prolong_over_a_block(kind):
    step = _step(kind, two_levels=True)
    fine, coarse = step.levels
    bt = step.base_transfers[0]
    tr = _BlockTransfer(bt, _BlockLevel(fine, P), _BlockLevel(coarse, P))
    F, t_arr = _block_state(fine, 7)
    G, G_uold, G_fold = tr.restrict(F, t_arr, DT, DT)
    assert G.u.shape == (3, P, 8, 8) and G.tau.shape == (2, P, 8, 8) and G_uold is G.u and G_fold is G.f
    rng = np.random.default_rng(8)
    G_new = G._replace(u=G.u + torch.as_tensor(0.01 * rng.standard_normal(tuple(G.u.shape))))
    F_new = tr.prolong(F, G_new, G_uold, t_arr, DT)
    for j in range(P):
        G_j = bt._restrict_state(_step_of(F, j), float(t_arr[j]), DT, DT)
        _assert_state_close(_step_of(G, j), G_j)
        want = bt._prolong_state(_step_of(F, j), _step_of(G_new, j), G_uold[:, j], float(t_arr[j]), DT)
        _assert_state_close(_step_of(F_new, j), want)
    # an unchanged coarse state prolongs exact zeros: the fine values stay bit for bit
    assert torch.equal(tr.prolong(F, G, G_uold, t_arr, DT).u, F.u)


@pytest.mark.parametrize('kind', ['implicit-LU', 'implicit-diagonal', 'imex'])
def test_serial_chain_equals_the_steps_in_turn(kind):
    """The Gauss-Seidel chain: step q takes uend of step q-1, sweeps, hands forward; inactive steps stay."""
    level = _step(kind).levels[0]
    blk = _BlockLevel(level, P)
    state, t_arr = _block_state(level, 9)
    uend = torch.as_tensor(np.random.default_rng(10).standard_normal((P, 16, 16)))
    recv = torch.tensor([False, True, True, True])
    active = torch.tensor([True, True, False, True])
    got, got_uend = blk.coarse_chain(state, uend, t_arr, DT, recv, active, 0)
    carry = state.u[0, 0]
    for j in range(P):
        s = _step_of(state, j)
        if not active[j]:
            _assert_state_close(_step_of(got, j), s, exact=True)
            assert torch.equal(got_uend[j], uend[j])
            carry = uend[j]
            continue
        if recv[j]:
            s = _step_of(blk.shift_recv(state, torch.roll(carry.expand(P, 16, 16), 0, 0), t_arr,
                                        torch.arange(P) == j), j)
        s = level.sweep.update_nodes(level.prob, s, float(t_arr[j]), DT, 0)
        carry = level.sweep.compute_end_point(s, float(t_arr[j]), DT)
        _assert_state_close(_step_of(got, j), s)
        np.testing.assert_allclose(got_uend[j].numpy(), carry.numpy(), **TOL)


def test_diag_chain_and_wavefront_equal_the_plain_ones():
    level = _step('implicit-LU').levels[0]
    blk = _BlockLevel(level, P)
    assert blk.select_coarse_impl('auto') == 'diag' and blk.coarse_chain is blk._coarse_diag
    state, t_arr = _block_state(level, 11)
    uend = torch.as_tensor(np.random.default_rng(12).standard_normal((P, 16, 16)))
    recv = torch.tensor([False, True, True, True])
    active = torch.tensor([True, True, False, True])
    for a, b in zip(blk.raw.coarse_diag(state, uend, t_arr, DT, recv, active, 0),
                    blk.raw.coarse_replicated(state, uend, t_arr, DT, recv, active, 0)):
        for x, y in zip((a.u, a.f, a.tau) if isinstance(a, LevelState) else (a,),
                        (b.u, b.f, b.tau) if isinstance(b, LevelState) else (b,)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=1e-11)
    window = torch.tensor([True, True, True, False])
    (sd, ud), (sp, up) = (fn(state, uend, t_arr, DT, window, P) for fn in (blk.raw.wavefront_diag, blk.raw.wavefront))
    np.testing.assert_allclose(sd.u.numpy(), sp.u.numpy(), rtol=0, atol=1e-11)
    np.testing.assert_allclose(sd.f.numpy(), sp.f.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ud.numpy(), up.numpy(), rtol=0, atol=1e-11)
    # the step outside the window keeps its data bit for bit on both
    assert torch.equal(sd.u[:, 3], state.u[:, 3]) and torch.equal(sp.u[:, 3], state.u[:, 3])
    assert torch.equal(ud[3], uend[3]) and torch.equal(up[3], uend[3])
    assert blk.select_coarse_impl('pipelined') == 'pipelined' and blk.coarse_chain is blk._coarse_serial


def test_where_mask_keeps_masked_steps_bit_for_bit():
    rng = np.random.default_rng(13)
    new, old = (LevelState(u=torch.as_tensor(rng.standard_normal((3, P, 5))),
                           f=IMEX(torch.as_tensor(rng.standard_normal((3, P, 5))),
                                  torch.as_tensor(rng.standard_normal((3, P, 5)))),
                           tau=torch.as_tensor(rng.standard_normal((2, P, 5)))) for _ in range(2))
    mask = torch.tensor([True, False, False, True])
    got = _where_mask(mask, new, old, axis=1)
    for g, n, o in zip((got.u, *got.f, got.tau), (new.u, *new.f, new.tau), (old.u, *old.f, old.tau)):
        assert torch.equal(g[:, 0], n[:, 0]) and torch.equal(g[:, 1], o[:, 1]) and torch.equal(g[:, 3], n[:, 3])
    flat = _where_mask(mask, new.u[0], old.u[0])
    assert torch.equal(flat[1], old.u[0, 1]) and torch.equal(flat[0], new.u[0, 0])


def test_node_times_of_a_block_stay_on_the_device_side():
    sweep = _step('imex').levels[0].sweep
    t_arr = torch.as_tensor(0.3 + DT * np.arange(P))
    ts = sweep.node_times(t_arr, DT)
    assert isinstance(ts, torch.Tensor) and ts.shape == (3, P) and ts.dtype == torch.float64
    for j in range(P):
        np.testing.assert_allclose(ts[:, j].numpy(), sweep.node_times(float(t_arr[j]), DT), rtol=0, atol=1e-15)
    assert isinstance(sweep.node_time(ts, 1), torch.Tensor) and isinstance(sweep.node_time(ts.numpy()[:, 0], 1), float)
    prob = _step('imex').levels[0].prob
    u = torch.zeros((3, P, 16, 16), dtype=torch.float64)
    expl = prob.eval_f_batched(u, ts).expl
    for m in range(3):
        for j in range(P):
            want = prob.eval_f(u[m, j], float(ts[m, j])).expl
            np.testing.assert_allclose(expl[m, j].numpy(), want.numpy(), **TOL)


# -- the stage lane against the virtual controller, entry for entry ---------
def _pfasst(nvars, bc, **over):
    desc = dict(
        problem_class=HeatND,
        problem_params=dict(nu=0.1, freq=2, nvars=nvars, bc=bc, device='cpu'),
        sweeper_class=GenericImplicit,
        sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=[3], QI='LU'),
        level_params=dict(restol=5e-10, dt=0.125),
        step_params=dict(maxiter=50),
        space_transfer_params=dict(rorder=2, iorder=6, periodic=bc == 'periodic'),
    )
    desc.update(over)
    return desc


STAGE_RUNS = {
    'pfasst-P4': (_pfasst([63, 31], 'dirichlet-zero'), 4, dict(predict_type='pfasst_burnin'), 1.0),
    'pfasst-P3-partial': (_pfasst([63, 31], 'dirichlet-zero'), 3, dict(predict_type='pfasst_burnin'), 0.625),
    'all-to-done': (_pfasst([63, 31], 'dirichlet-zero'), 4, dict(predict_type='pfasst_burnin', all_to_done=True), 0.5),
    'fmg': (_pfasst([63, 31], 'dirichlet-zero'), 2, dict(predict_type='fmg'), 0.5),
    'fine-only': (_pfasst([63, 31], 'dirichlet-zero'), 2, dict(predict_type='fine_only'), 0.5),
    'periodic2d': (_pfasst([(32, 32), (16, 16)], 'periodic'), 4, dict(predict_type='pfasst_burnin'), 0.5),
    'three-levels': (_pfasst([127, 63, 31], 'dirichlet-zero',
                             level_params=dict(restol=5e-10, dt=0.125, nsweeps=[1, 2, 1])),
                     3, dict(predict_type='pfasst_burnin'), 0.375),
    'mssdc-gauss-seidel': (_pfasst(63, 'dirichlet-zero'), 4, dict(mssdc_jac=False), 0.5),
    'mssdc-jacobi-two-sweeps': (_pfasst(63, 'dirichlet-zero', level_params=dict(restol=5e-10, dt=0.125, nsweeps=2)),
                                4, {}, 0.5),
    'imex-forced': (dict(_pfasst(63, 'dirichlet-zero'), problem_class=HeatNDForced, sweeper_class=IMEXSweeper,
                         sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=3, QI='LU', QE='EE')), 2, {}, 0.5),
}
TIMINGS = ('timing_run', 'timing_step', 'timing_iteration', 'timing_sweep')


@pytest.mark.parametrize('coarse_mode', ['auto', 'replicated'])
@pytest.mark.parametrize('name', list(STAGE_RUNS))
def test_stage_lane_stats_equal_the_virtual_controller_entry_for_entry(name, coarse_mode):
    desc, num_procs, controller_params, Tend = STAGE_RUNS[name]
    runs = {}
    for cls, kw in ((ControllerNonMPI, {}), (ShardedController, dict(coarse_mode=coarse_mode))):
        ctrl = cls(num_procs, {'logger_level': 40, **controller_params}, desc, **kw)
        uend, stats = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, Tend)
        runs[cls] = (uend, stats, ctrl)
    (u_virt, s_virt, _), (u_block, s_block, block) = runs[ControllerNonMPI], runs[ShardedController]
    # the default lane of the block controller is the fused one; entry for entry is the stage lane's gate
    assert [v for k, v in s_block.items() if k.type == 'lane'] == ['fused']
    u_stage, s_stage = block.run(block.MS[0].levels[0].prob.u_exact(0.0), 0.0, Tend, lane='stage')
    np.testing.assert_allclose(u_stage.numpy(), u_virt.numpy(), rtol=0, atol=1e-11)
    lane = {k: v for k, v in s_stage.items() if k.type == 'lane'}
    assert list(lane.values()) == ['stage']
    rest = {k: v for k, v in s_stage.items() if k.type != 'lane'}
    assert set(rest) == set(s_virt), sorted(set(rest) ^ set(s_virt))[:5]
    for key, want in s_virt.items():
        if key.type in TIMINGS:
            assert rest[key] >= 0.0
        elif key.type in ('niter', 'restart', 'dt'):
            assert rest[key] == want, key
        else:
            assert np.isclose(rest[key], want, rtol=1e-6, atol=1e-13), (key, rest[key], want)
    assert pysdc_tpu_torch.get_sorted(s_stage, type='niter') == pysdc_tpu_torch.get_sorted(s_virt, type='niter')


def test_block_controller_needs_one_dt_per_block():
    from pysdc_tpu_torch.core.errors import ControllerError

    desc, num_procs, controller_params, _ = STAGE_RUNS['pfasst-P4']
    ctrl = ShardedController(num_procs, {'logger_level': 40, **controller_params}, desc)
    ctrl.MS[1].levels[0].params.dt = 0.25
    with pytest.raises(ControllerError, match='one dt per block'):
        ctrl._block_dt(ctrl.MS)
    assert ctrl._block_dt(ctrl.MS, 1) == 0.125 and ctrl.template is ctrl.MS[0]
