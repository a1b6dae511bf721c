"""The port's block controller on a mesh, beyond tests/test_sharded.py: the
twins of tests/test_core_smoke.py:56, tests/test_baseline_configs.py:76 and
:125, and tests/test_fused.py:61, :110 and :384 (the fused lanes on a mesh).

The gates and the run harness are those of tests/test_torch_sharded_mesh.py:
the port's mesh run against the JAX package's mesh run and against the port's
run without a mesh, ``niter`` equal exactly, ``uend`` within 1e-11 (1e-10 for
the Allen-Cahn configuration, whose JAX test allows that; 1e-9 and ``dt``
within 1e-8 for the adaptive lane), stats entries equal and the lane as the
JAX test asserts it.  On a mesh whose positions share one device the fused
lanes run their pieces on the time shards (captured into CUDA graphs on the
card, eager here).
"""

import numpy as np
import pytest
import torch

import pysdc_tpu_torch
from test_torch_sharded_mesh import (
    BURNIN,
    CASES,
    STATS,
    _cpu,
    _pkg,
    assert_same,
    assert_time_sharded,
    heat,
    lanes,
    periodic,
    run,
    vdp,
)


def allen_cahn(package):
    """tests/test_baseline_configs.py:60's semi-implicit 2D Allen-Cahn description."""
    if package == 'jax':
        from pysdc_tpu.models.allen_cahn import AllenCahnPeriodicSemiImplicitND
    else:
        from pysdc_tpu_torch.models.allen_cahn import AllenCahnPeriodicSemiImplicitND
    return dict(
        problem_class=AllenCahnPeriodicSemiImplicitND,
        problem_params=_cpu(package, dict(nvars=(64, 64), eps=0.08, radius=0.25)),
        sweeper_class=_pkg(package).IMEXSweeper,
        sweeper_params=dict(num_nodes=3, QI='LU'),
        level_params=dict(dt=1e-3, restol=1e-9),
        step_params=dict(maxiter=20),
    )


CASES.update({
    'smoke-2d': (lambda p: periodic(p, [(16, 16), (8, 8)]), 2, BURNIN, 0.1),
    'allen-cahn-2d': (allen_cahn, 2, {}, 4e-3),
    'heat-3d': (lambda p: heat(p, [(16, 16, 16), (8, 8, 8)], bc='periodic', restol=1e-9, dt=0.05, maxiter=20,
                               transfer=dict(rorder=2, iorder=2, periodic=True)), 4, BURNIN, 0.4),
    'fine-only': (lambda p: heat(p, [63, 31]), 4, {'predict_type': 'fine_only'}, 1.0),
    'vdp-fused-adaptive': (lambda p: vdp(p, {'Adaptivity': {'e_tol': 1e-6}}, setup=(5.0, 1e-10, 'LU', -1.0, 1e-2, 4)),
                           4, {}, 0.03),
})


def test_sharded_stage_smoke_parity():
    """tests/test_core_smoke.py:56: the stage machine on a 2-position time mesh."""
    got = run('torch', 'smoke-2d', (2, 1, 1))
    assert_same(run('jax', 'smoke-2d', (2, 1, 1)), got, 1e-11)
    assert_same(run('torch', 'smoke-2d'), got, 1e-11)
    assert_time_sharded(got['ctrl'], 2)


def test_config3_allen_cahn_2d_sharded_space():
    """tests/test_baseline_configs.py:76: semi-implicit 2D Allen-Cahn with the spatial axis sharded 4 ways: the halo
    apply on each time row's space positions."""
    got = run('torch', 'allen-cahn-2d', (2, 1, 4))
    assert_same(run('jax', 'allen-cahn-2d', (2, 1, 4)), got, 1e-10)
    assert_same(run('torch', 'allen-cahn-2d'), got, 1e-10)
    assert_time_sharded(got['ctrl'], 2)
    assert got['ctrl'].MS[0].levels[0].prob.A._halo is not None
    assert got['traffic']['copies'] > 0


def test_config5_heat3d_pfasst_sharded_time():
    """tests/test_baseline_configs.py:125: 3D heat on a 4 x 2 (time, space) mesh (no 2D cross stencil, so no halo:
    the applies stay whole on each time row)."""
    got = run('torch', 'heat-3d', (4, 1, 2))
    assert_same(run('jax', 'heat-3d', (4, 1, 2)), got, 1e-11)
    assert_same(run('torch', 'heat-3d'), got, 1e-11)
    assert_time_sharded(got['ctrl'], 4)
    prob = got['ctrl'].MS[0].levels[0].prob
    assert np.abs(got['uend'] - prob.u_exact(0.4).numpy()).max() < 1e-4


def test_fused_matches_slow_sharded_on_mesh():
    """tests/test_fused.py:61: ``run()`` (the fused lane) and the stage machine on a time mesh, against each other,
    against the JAX package's mesh run and against the port's fused lane without a mesh; the residual trajectories
    agree at every recorded iteration."""
    mesh = (4, 1, 1)
    fused = run('torch', 'pfasst-P4', mesh, 'auto')
    assert lanes(fused) == lanes(run('jax', 'pfasst-P4', mesh, 'auto')) == ['fused']
    assert_same(run('torch', 'pfasst-P4', mesh, 'stage'), fused, 1e-11, ('residual_post_step',))
    assert_same(run('jax', 'pfasst-P4', mesh, 'auto'), fused, 1e-11, STATS)
    assert_same(run('torch', 'pfasst-P4', None, 'auto'), fused, 1e-11, STATS)
    assert_same(run('torch', 'pfasst-P4', mesh, 'run_fused'), fused, 1e-12, STATS)
    slow = run('torch', 'pfasst-P4', mesh, 'stage')
    r_slow = {(round(e.time, 10), e.iter): v for e, v in slow['stats'].items() if e.type == 'residual_post_iteration'}
    r_fu = {(round(e.time, 10), e.iter): v for e, v in fused['stats'].items() if e.type == 'residual_post_iteration'}
    assert set(r_slow) == set(r_fu)
    for key in r_slow:
        assert np.isclose(r_slow[key], r_fu[key], rtol=1e-6, atol=1e-13), key


def test_fused_fine_only_predictor():
    """tests/test_fused.py:110."""
    mesh = (4, 1, 1)
    got = run('torch', 'fine-only', mesh, 'run_fused')
    assert_same(run('torch', 'fine-only', mesh, 'stage'), got, 1e-11, ())
    assert_same(run('jax', 'fine-only', mesh, 'run_fused'), got, 1e-11)
    assert_same(run('torch', 'fine-only', None, 'run_fused'), got, 1e-11)


def test_fused_adaptive_on_device_mesh():
    """tests/test_fused.py:384: sharding the block does not change the adaptive trajectory: the same lane, niter and
    restarts, and accepted dts as the meshless adaptive run and the JAX package's mesh run."""
    got = run('torch', 'vdp-fused-adaptive', (4, 1, 1), 'auto')
    for want in (run('torch', 'vdp-fused-adaptive', None, 'auto'), run('jax', 'vdp-fused-adaptive', (4, 1, 1), 'auto')):
        assert lanes(want) == lanes(got) == ['fused_adaptive']
        assert_same(want, got, 1e-9, ('dt', 'restart'), dt_tol=1e-8)
    assert_time_sharded(got['ctrl'], 4)


def test_fused_lanes_refuse_a_mesh_over_several_devices():
    """A capture is one device's: the fused lanes refuse by name a mesh whose positions span devices."""
    from pysdc_tpu_torch.core.errors import ControllerError
    from pysdc_tpu_torch.parallel import fused
    from pysdc_tpu_torch.parallel.mesh import make_mesh

    make, num_procs, cp, _ = CASES['pfasst-P4']
    ctrl = pysdc_tpu_torch.ShardedController(num_procs, {'logger_level': 40, **cp}, make('torch'),
                                             mesh=make_mesh(n_time=4, devices=['cpu'] * 4))
    # a second device in the layout: only the eligibility check reads it
    ctrl.mesh.devices[1, 0, 0] = torch.device('meta')
    with pytest.raises(ControllerError, match='this mesh spans 2 devices'):
        fused.check_fused_eligibility(ctrl)
