"""The mesh half of the port's block controller against the JAX package's mesh
runs: the port's twins of tests/test_sharded.py:37, 55, 74, 104, 126, 159,
202, 244, 280, 314 and 351 (tests/test_torch_mesh_lanes.py holds the mesh
cases of test_core_smoke.py, test_baseline_configs.py and test_fused.py).

Each case runs the port's ``ShardedController`` on a mesh of ``['cpu'] * 8``
positions and gates it against the JAX package's run on the same mesh shape
(its 8 emulated devices, tests/conftest.py) and against the port's run without
a mesh: ``niter`` equal exactly, ``uend`` within 1e-11 (1e-9, and ``dt``
within 1e-8, for the runs that an error estimate drives), the stats entries
equal (residuals to rtol 1e-6, as the JAX tests compare them) and the lane as
the JAX test asserts it.  Every run is made once (``functools.lru_cache``) and
shared by the cases that read it.  Float64 throughout.
"""

import functools

import numpy as np
import pytest
import torch

import pysdc_tpu
import pysdc_tpu_torch
from pysdc_tpu.parallel.mesh import make_mesh as jax_mesh
from pysdc_tpu_torch.core.errors import ControllerError
from pysdc_tpu_torch.parallel import mesh as tmesh
from pysdc_tpu_torch.parallel.mesh import TimeShards

torch.set_num_threads(1)
CPU8 = ['cpu'] * 8
BURNIN = {'predict_type': 'pfasst_burnin'}
STATS = ('residual_post_iteration', 'residual_post_step')
ADAPTIVE_STATS = ('dt', 'restart', 'error_embedded_estimate') + STATS + ('residual_post_sweep',)


def _pkg(package):
    return pysdc_tpu if package == 'jax' else pysdc_tpu_torch


def _models(package):
    if package == 'jax':
        from pysdc_tpu.models import heat, odes
    else:
        from pysdc_tpu_torch.models import heat, odes
    return heat, odes


def _cpu(package, params):
    return params if package == 'jax' else dict(params, device='cpu')


def heat(package, nvars, bc='dirichlet-zero', restol=5e-10, dt=0.125, maxiter=50, transfer=None):
    """tests/test_sharded.py:22 (``_desc``) and the periodic 2D description of :74."""
    heat_mod, _ = _models(package)
    return dict(
        problem_class=heat_mod.HeatND,
        problem_params=_cpu(package, dict(nu=0.1, freq=2, nvars=nvars, bc=bc)),
        sweeper_class=_pkg(package).GenericImplicit,
        sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=[3], QI='LU'),
        level_params=dict(restol=restol, dt=dt),
        step_params=dict(maxiter=maxiter),
        space_transfer_params=transfer or dict(rorder=2, iorder=6),
    )


def periodic(package, nvars):
    return heat(package, nvars, bc='periodic', restol=1e-9, dt=0.05, maxiter=20,
                transfer=dict(rorder=2, iorder=2, periodic=True))


def vdp(package, controllers, **problem):
    """tests/test_sharded.py:202-354's Van der Pol descriptions."""
    _, odes = _models(package)
    if package == 'jax':
        from pysdc_tpu import convergence as conv
    else:
        from pysdc_tpu_torch import convergence as conv
    mu, newton_tol, qi, restol, dt, maxiter = problem.pop('setup')
    return dict(
        problem_class=odes.VanDerPol,
        problem_params=_cpu(package, dict(mu=mu, u0=(2.0, 0.0), newton_tol=newton_tol, **problem)),
        sweeper_class=_pkg(package).GenericImplicit,
        sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=3, QI=qi),
        level_params=dict(restol=restol, dt=dt),
        step_params=dict(maxiter=maxiter),
        convergence_controllers={getattr(conv, name): dict(p) for name, p in controllers.items()},
    )


ADAPTIVITY = {'Adaptivity': {'e_tol': 1e-7, 'embedded_error_flavor': 'linearized'}}
CASES = {
    # name: (description of a package, num_procs, controller params, Tend)
    'pfasst-P2': (lambda p: heat(p, [63, 31]), 2, BURNIN, 1.0),
    'pfasst-P4': (lambda p: heat(p, [63, 31]), 4, BURNIN, 1.0),
    'single-level': (lambda p: heat(p, 63), 4, {}, 1.0),
    'time-space-2d': (lambda p: periodic(p, [(16, 16), (8, 8)]), 4, BURNIN, 0.2),
    'three-axis': (lambda p: periodic(p, [(16, 16), (8, 8)]), 2, BURNIN, 0.1),
    'mixed-halo': (lambda p: periodic(p, [(32, 32), (16, 16)]), 2, BURNIN, 0.2),
    'vdp-adaptive-0.3': (lambda p: vdp(p, ADAPTIVITY, setup=(5.0, 1e-10, 'LU', -1.0, 1e-2, 7)), 4,
                         {'mssdc_jac': True}, 0.3),
    'vdp-adaptive-0.4': (lambda p: vdp(p, ADAPTIVITY, setup=(5.0, 1e-10, 'LU', -1.0, 1e-2, 7)), 4,
                         {'mssdc_jac': True}, 0.4),
    'vdp-inexact': (lambda p: vdp(p, {'NewtonInexactness': {'ratio': 1e-2}}, newton_maxiter=100,
                                  setup=(2.0, 1e-3, 'IE', 1e-9, 0.05, 30)), 4, {}, 0.8),
}


def make_mesh(package, shape):
    n_time, n_node, n_space = shape
    if package == 'jax':
        return jax_mesh(n_time=n_time, n_space=n_space, n_node=n_node)
    return tmesh.make_mesh(n_time=n_time, n_space=n_space, n_node=n_node, devices=CPU8)


def controller(package, name, mesh=None, coarse_mode='auto'):
    make, num_procs, cp, _ = CASES[name]
    m = None if mesh is None else make_mesh(package, mesh)
    return _pkg(package).ShardedController(num_procs, {'logger_level': 40, **cp}, make(package), mesh=m,
                                           coarse_mode=coarse_mode)


@functools.lru_cache(maxsize=None)
def run(package, name, mesh=None, lane='stage', coarse_mode='auto'):
    """One run of case ``name`` (``mesh`` a (time, node, space) shape or None);
    ``lane='run_fused'`` calls ``run_fused``, any other ``run(lane=...)``."""
    ctrl = controller(package, name, mesh, coarse_mode)
    u0 = ctrl.MS[0].levels[0].prob.u_exact(0.0)
    Tend = CASES[name][3]
    if lane == 'run_fused':
        uend, stats = ctrl.run_fused(u0, 0.0, Tend)
    else:
        uend, stats = ctrl.run(u0, 0.0, Tend, lane=lane)
    uend = uend.numpy() if isinstance(uend, torch.Tensor) else np.asarray(uend)
    traffic = dict(ctrl.mesh.traffic) if package == 'torch' and mesh else None
    return dict(uend=uend, stats=stats, ctrl=ctrl, pkg=_pkg(package), traffic=traffic)


def niters(r):
    return [(round(t, 10), int(v)) for t, v in r['pkg'].get_sorted(r['stats'], type='niter')]


def lanes(r):
    return [v for k, v in r['stats'].items() if k.type == 'lane']


def assert_same(want, got, uend_tol, kinds=STATS, dt_tol=None):
    """niter equal exactly, the stats entries of ``kinds`` equal, ``uend`` within ``uend_tol``; the step times
    within 1e-9 where ``dt_tol`` says an error estimate chose the step sizes."""
    if dt_tol is None:
        assert niters(want) == niters(got)
    else:
        a, b = niters(want), niters(got)
        assert [v for _, v in a] == [v for _, v in b]
        assert max(abs(t1 - t2) for (t1, _), (t2, _) in zip(a, b)) < 1e-9
    for kind in kinds:
        a = want['pkg'].get_sorted(want['stats'], type=kind, recomputed=None)
        b = got['pkg'].get_sorted(got['stats'], type=kind, recomputed=None)
        assert len(a) == len(b), (kind, len(a), len(b))
        for (t1, v1), (t2, v2) in zip(a, b):
            assert abs(t1 - t2) < (1e-12 if dt_tol is None else 1e-9), (kind, t1, t2)
            if kind == 'dt' and dt_tol is not None:
                assert abs(v1 - v2) < dt_tol, (kind, t1, v1, v2)
            else:
                assert np.isclose(v1, v2, rtol=1e-6, atol=1e-12), (kind, t1, v1, v2)
    np.testing.assert_allclose(got['uend'], want['uend'], rtol=0, atol=uend_tol)


def assert_time_sharded(ctrl, n_time):
    """The block state really is split over the mesh's time rows."""
    for blk in ctrl.blocks:
        assert isinstance(blk.state, TimeShards) and len(blk.state) == n_time
        for c, part in enumerate(blk.state):
            assert part.u.shape[1] == ctrl.num_procs // n_time
            assert part.u.device == ctrl.mesh.row_device(c)


def _gate(name, mesh, tol=1e-11, kinds=STATS, lane='stage', **kw):
    got = run('torch', name, mesh, lane, **kw)
    assert_same(run('jax', name, mesh, lane, **kw), got, tol, kinds)
    assert_same(run('torch', name, None, lane), got, tol, kinds)
    return got


@pytest.mark.parametrize('num_procs', [2, 4])
def test_sharded_matches_virtual_pfasst(num_procs):
    """tests/test_sharded.py:37."""
    got = _gate(f'pfasst-P{num_procs}', (num_procs, 1, 1))
    assert lanes(got) == ['stage']
    assert_time_sharded(got['ctrl'], num_procs)
    assert got['ctrl'].coarse_mode == 'owner'


def test_sharded_single_level_sdc_matches_virtual():
    """tests/test_sharded.py:55."""
    got = _gate('single-level', (4, 1, 1))
    assert_time_sharded(got['ctrl'], 4)


def test_sharded_time_space_mesh_2d():
    """tests/test_sharded.py:74: the halo apply on every level of a time x space mesh."""
    got = _gate('time-space-2d', (4, 1, 2))
    assert_time_sharded(got['ctrl'], 4)
    for lvl in got['ctrl'].MS[0].levels:
        assert lvl.prob.A._halo is not None and lvl.prob.A._halo[0] is got['ctrl'].mesh


@pytest.mark.parametrize('mode', ['replicated', 'pipelined', 'owner'])
def test_pipelined_coarse_chain_matches_replicated(mode):
    """tests/test_sharded.py:104: the three chains on the port's mesh against the same chain of the JAX package,
    against the replicated one and against the port's run without a mesh."""
    got = run('torch', 'pfasst-P4', (4, 1, 1), coarse_mode=mode)
    assert got['ctrl'].coarse_mode == mode
    assert_same(run('jax', 'pfasst-P4', (4, 1, 1), coarse_mode=mode), got, 1e-11)
    assert_same(run('torch', 'pfasst-P4', (4, 1, 1), coarse_mode='replicated'), got, 1e-12)
    assert_same(run('torch', 'pfasst-P4'), got, 1e-11)


def test_owner_chain_moves_less_than_the_others():
    """The owner chain copies one field per shard boundary; the replicated chain gathers the coarse block and
    splits it again, the pipelined one moves every step there and back."""
    traffic = {mode: run('torch', 'pfasst-P4', (4, 1, 1), coarse_mode=mode)['traffic']
               for mode in ('replicated', 'pipelined', 'owner')}
    assert traffic['owner']['copies'] < traffic['replicated']['copies'] < traffic['pipelined']['copies']
    assert traffic['owner']['gathers'] < traffic['replicated']['gathers']


def test_coarse_mode_auto_selection():
    """tests/test_sharded.py:126, beside the JAX package's own choices."""
    for mesh, want in (((4, 1, 1), 'owner'), (None, 'diag'), ((2, 1, 2), 'replicated')):
        name = 'pfasst-P4' if mesh is None or mesh[0] == 4 else 'pfasst-P2'
        assert controller('torch', name, mesh).coarse_mode == controller('jax', name, mesh).coarse_mode == want
    blk = controller('torch', 'pfasst-P4').blocks[-1]
    blk._diag_eligible = False  # force the size-based fallback pair
    assert blk.select_coarse_impl('auto', threshold_bytes=1 << 30) == 'replicated'
    assert blk.select_coarse_impl('auto', threshold_bytes=1) == 'pipelined'
    with pytest.raises(ControllerError, match='owner coarse chain needs a time-only mesh dividing P'):
        controller('torch', 'pfasst-P4', coarse_mode='owner')
    with pytest.raises(ControllerError, match='owner coarse chain needs a time-only mesh'):
        controller('torch', 'pfasst-P2', (2, 1, 2), coarse_mode='owner')
    with pytest.raises(ControllerError, match='diag coarse chain needs .* no device mesh'):
        controller('torch', 'pfasst-P4', (4, 1, 1), coarse_mode='diag')


def test_sharded_three_axis_mesh():
    """tests/test_sharded.py:159: the (time, node, space) product mesh; the node axis in the leaves' layout."""
    got = _gate('three-axis', (2, 2, 2))
    ctrl = got['ctrl']
    assert dict(ctrl.mesh.shape) == {'time': 2, 'node': 2, 'space': 2}
    assert_time_sharded(ctrl, 2)
    # u/f leaves (M+1, P, *space): M+1 = 4 divides over n_node = 2, so the node axis is sharded, as in JAX
    whole = ctrl.blocks[0].whole(ctrl.blocks[0].state)
    assert tuple(ctrl.blocks[0]._spec(whole.u)) == ('node', 'time', 'space', None)
    assert tuple(ctrl.blocks[0]._spec(whole.tau)) == (None, 'time', 'space', None)  # M = 3 nodes do not divide
    # with a node axis the applies stay whole: no halo (pysdc_tpu/parallel/sharded.py:607)
    assert all(lvl.prob.A._halo is None for lvl in ctrl.MS[0].levels)


def test_sharded_stats_equivalence_adaptive_run():
    """tests/test_sharded.py:202: stats entry for entry, and the same Entry keys."""
    got = run('torch', 'vdp-adaptive-0.3', (4, 1, 1))
    for want in (run('jax', 'vdp-adaptive-0.3', (4, 1, 1)), run('torch', 'vdp-adaptive-0.3')):
        assert_same(want, got, 1e-9, ADAPTIVE_STATS, dt_tol=1e-8)
        for kind in ('niter', 'restart'):  # the same Entry keys, the step times to the estimate's 1e-9
            a, b = (sorted((k for k in r['stats'] if k.type == kind), key=lambda k: (k.time, k.process))
                    for r in (want, got))
            assert [k._replace(time=0.0) for k in a] == [k._replace(time=0.0) for k in b], kind
            assert max(abs(k1.time - k2.time) for k1, k2 in zip(a, b)) < 1e-9, kind


def test_sharded_adaptivity_matches_virtual():
    """tests/test_sharded.py:244: accepted step sizes, restarts and the solution."""
    got = run('torch', 'vdp-adaptive-0.4', (4, 1, 1))
    for want in (run('jax', 'vdp-adaptive-0.4', (4, 1, 1)), run('torch', 'vdp-adaptive-0.4')):
        assert_same(want, got, 1e-9, ('dt', 'restart'), dt_tol=1e-8)
        assert sum(v for _, v in want['pkg'].get_sorted(want['stats'], type='restart')) == sum(
            v for _, v in got['pkg'].get_sorted(got['stats'], type='restart'))
    assert sum(v for _, v in got['pkg'].get_sorted(got['stats'], type='restart')) > 0


def test_sharded_mixed_mesh_halo_lane():
    """tests/test_sharded.py:280: on a (time x space) mesh the halo apply carries every level and ``run()`` takes
    the fused lane."""
    got = _gate('mixed-halo', (2, 1, 4), lane='auto')
    assert lanes(got) == lanes(run('jax', 'mixed-halo', (2, 1, 4), 'auto')) == ['fused']
    for lvl in got['ctrl'].MS[0].levels:
        assert lvl.prob.A._halo is not None, 'halo must be active on mixed meshes'


@pytest.mark.parametrize('n_time', [2, 4])
def test_block_kernels_apply_per_step_problem_scalars(n_time):
    """tests/test_sharded.py:314 on time shards: each slot's sweep with its own ``newton_tol`` equals a standalone
    sweep with that tolerance, and the whole block equals the JAX package's batched sweep."""
    import jax.numpy as jnp

    setup = (2.0, 1e-10, 'IE', 1e-10, 0.05, 10)
    parts = {p: vdp(p, {}, newton_maxiter=100, setup=setup) for p in ('jax', 'torch')}
    tols = [1e-1, 1e-12, 1e-1, 1e-12]
    t_host = [0.0, 0.05, 0.1, 0.15]

    jsh = pysdc_tpu.ShardedController(4, {'logger_level': 40}, parts['jax'])
    jblk = jsh.blocks[0]
    ju0 = jnp.asarray(jblk.level.prob.u_exact(0.0))
    jstate = jblk.predict(jnp.broadcast_to(ju0, (4,) + ju0.shape), jnp.asarray(t_host), 0.05)
    want = jblk.sweep(jstate, jnp.asarray(t_host), 0.05, jnp.ones((4,), bool), 0, {'newton_tol': jnp.asarray(tols)})

    sh = pysdc_tpu_torch.ShardedController(4, {'logger_level': 40}, parts['torch'],
                                           mesh=tmesh.make_mesh(n_time=n_time, devices=CPU8))
    blk = sh.blocks[0]
    prob, sweep = blk.level.prob, blk.level.sweep
    u0 = prob.u_exact(0.0)
    t_arr = torch.tensor(t_host, dtype=torch.float64)
    state = blk.predict(u0.expand((4,) + tuple(u0.shape)).contiguous(), t_arr, 0.05)
    assert isinstance(state, TimeShards) and len(state) == n_time
    mask = torch.ones(4, dtype=torch.bool)
    out = blk.sweep(state, t_arr, 0.05, mask, 0, {'newton_tol': torch.tensor(tols, dtype=torch.float64)})
    got = blk.whole(out).u
    np.testing.assert_allclose(got.numpy(), np.moveaxis(np.asarray(want.u), 0, 1), rtol=0, atol=1e-12)
    whole = blk.whole(state)
    for j, tol in enumerate(tols):
        old = prob.newton_tol
        prob.newton_tol = tol
        ref = sweep.update_nodes(prob, whole._replace(u=whole.u[:, j], f=whole.f[:, j], tau=whole.tau[:, j]),
                                 float(t_arr[j]), 0.05, 0)
        prob.newton_tol = old
        np.testing.assert_allclose(got[:, j].numpy(), ref.u.numpy(), rtol=0, atol=1e-13)
    tight = blk.whole(blk.sweep(state, t_arr, 0.05, mask, 0, {'newton_tol': torch.full((4,), 1e-12,
                                                                                          dtype=torch.float64)}))
    assert float((got[:, 0] - tight.u[:, 0]).abs().max()) > 0.0


def test_sharded_newton_inexactness_matches_virtual():
    """tests/test_sharded.py:351 (the JAX test runs without a mesh): the policy's per-step ``newton_tol`` writes
    steer the sharded sweeps and the owner chain as they steer the virtual controller's solves."""
    got = run('torch', 'vdp-inexact', (4, 1, 1))
    assert got['ctrl'].coarse_mode == 'owner'
    assert_same(run('jax', 'vdp-inexact'), got, 1e-11)
    assert_same(run('torch', 'vdp-inexact'), got, 1e-11)
