"""The switch estimator and the power-electronics problems of the PyTorch port
against live runs of the JAX package (float64, CPU).

The event runs of tests/test_boris_power_dae.py and
tests/test_more_components.py (``Battery``, ``BatteryNCapacitors`` with two
switches, ``DiscontinuousTestODE``, ``DiscontinuousTestDAE`` by contact, there
at 5 iterations a step and restol 1e-8, which the sliding mode never reaches,
so each attempt runs 5 sweeps instead of 20) go
through both packages with the gates of
:func:`tests.test_torch_estimators.assert_same_run`, and ``t_switch`` to
1e-12 with equal ``nswitches``.  The circuits' ``eval_f`` / ``solve_system``
are held against the JAX package's on seeded inputs, node-batched and with a
``(P,)`` ``t_switch`` over a block ``(M+1, P, n)``.  ``ShardedController``
runs ``DiscontinuousTestODE`` with the switch estimator on the stage lane
(the fused lanes refuse it by name) and equals ``ControllerNonMPI`` entry for
entry.
"""

import numpy as np
import pytest
import torch

import pysdc_tpu_torch
import pysdc_tpu_torch.models as tmodels
from pysdc_tpu_torch.core.errors import ControllerError
from pysdc_tpu_torch.utils.convert import to_numpy, to_torch
from test_torch_estimators import _JAX_MODELS, REGISTRY, assert_same_run, build, entries, run, spec

torch.set_num_threads(1)

SE = {'SwitchEstimator': {}}
RUNS = {
    'battery': spec('Battery', SE, sweeper='imex', num_nodes=4, dt=0.01, restol=1e-12, maxiter=10, Tend=0.5),
    'battery-n': spec('BatteryNCapacitors', SE, dict(ncapacitors=2), sweeper='imex', num_nodes=4, dt=0.01,
                      restol=1e-12, maxiter=10, Tend=0.6),
    'discontinuous-ode': spec('DiscontinuousTestODE', SE, QI='IE', dt=0.05, restol=1e-12, maxiter=10, Tend=2.0),
    'discontinuous-dae': spec('DiscontinuousTestDAE', {
        'SwitchEstimator': {'tol': 1e-6, 'alpha': 0.97, 'contact_tol': 0.5},
        'BasicRestarting': {'max_restarts': 20, 'crash_after_max_restarts': False},
    }, dict(newton_tol=1e-6), sweeper='dae', num_nodes=4, dt=0.02, restol=1e-8, maxiter=5, t0=4.6, Tend=4.62),
    'piline': spec('Piline', {}, sweeper='imex', num_nodes=3, dt=0.05, restol=1e-10, maxiter=20, Tend=0.5),
    'buck': spec('BuckConverter', {}, sweeper='imex', num_nodes=3, dt=1e-4, restol=1e-10, maxiter=20, Tend=2e-3),
}
REGISTRY['switch'] = RUNS


def result(package, name):
    return run(package, name, 'switch')


@pytest.mark.parametrize('name', list(RUNS))
def test_run_matches_jax(name):
    want, got = result('jax', name), result('torch', name)
    assert_same_run(want, got)
    for key in ('t_switch', 'nswitches'):
        if hasattr(want['prob'], key):
            w, g = float(getattr(want['prob'], key)), float(getattr(got['prob'], key))
            assert g == w if key == 'nswitches' or np.isinf(w) else abs(g - w) <= 1e-12, key


def test_events_found_where_the_jax_tests_find_them():
    battery = result('torch', 'battery')['prob']
    assert battery.nswitches == 1 and abs(battery.t_switch - np.log(1.2)) < 1e-4
    assert result('torch', 'battery-n')['prob'].nswitches == 2
    ode = result('torch', 'discontinuous-ode')['prob']
    assert ode.nswitches == 1 and abs(ode.t_switch - np.log(5.0)) < 5e-4
    dae = result('torch', 'discontinuous-dae')
    dts = [v for _, v in dae['pkg'].get_sorted(dae['stats'], type='dt', recomputed=False)]
    assert dts[0] < 0.01 and abs(4.6 + dts[0] - dae['prob'].t_switch_exact) < 2e-3


CIRCUITS = {
    'Battery': {}, 'BatteryNCapacitors': dict(ncapacitors=2), 'Piline': {}, 'BuckConverter': dict(fsw=10.0),
}


@pytest.mark.parametrize('name', list(CIRCUITS))
def test_circuit_functions_match_jax(name):
    """eval_f and solve_system on one state, node-batched (one time per node) and, with ``t_switch`` as a
    ``(P,)`` tensor, over a block ``(M+1, P, n)``: each system of the block equals the JAX function on it."""
    jprob = _JAX_MODELS[name](**CIRCUITS[name])
    tprob = getattr(tmodels, name)(**CIRCUITS[name], device='cpu')
    n = jprob.shape[0]
    rng = np.random.default_rng(11)
    # voltages around V_ref = 1, so both regimes show up
    block = rng.uniform(0.6, 1.4, (4, 3, n))
    times = rng.uniform(0.0, 0.2, (4, 3))
    t_switch = np.array([np.inf, 0.05, 0.1])
    factors = np.array([0.0, 0.01, 0.02, 0.03])

    def jax_at(i, j, fn, *args):
        if hasattr(jprob, 't_switch'):
            jprob.t_switch = t_switch[j]
        return fn(*args)

    if hasattr(tprob, 't_switch'):
        tprob.t_switch = torch.as_tensor(t_switch)
    got_f = tprob.eval_f(to_torch(block, 'cpu'), torch.as_tensor(times))
    got_x = tprob.solve_system(to_torch(block, 'cpu'), torch.as_tensor(factors)[:, None], None,
                               torch.as_tensor(times))
    for i in range(4):
        for j in range(3):
            want_f = jax_at(i, j, jprob.eval_f, block[i, j], times[i, j])
            want_x = jax_at(i, j, jprob.solve_system, block[i, j], factors[i], None, times[i, j])
            for g, w in zip(got_f, want_f):
                np.testing.assert_allclose(to_numpy(g)[i, j], np.asarray(w), rtol=1e-14, atol=1e-14)
            np.testing.assert_allclose(to_numpy(got_x)[i, j], np.asarray(want_x), rtol=1e-13, atol=1e-14)
    # one state, and the nodes of one step batched with their own times
    tprob.t_switch = np.inf if hasattr(tprob, 't_switch') else None
    if hasattr(jprob, 't_switch'):
        jprob.t_switch = np.inf
    one = tprob.eval_f_batched(to_torch(block[:, 0], 'cpu'), times[:, 0])
    for i in range(4):
        for g, w in zip(one, jprob.eval_f(block[i, 0], times[i, 0])):
            np.testing.assert_allclose(to_numpy(g)[i], np.asarray(w), rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(to_numpy(tprob.u_exact(0.0)), np.asarray(jprob.u_exact(0.0)), rtol=0, atol=0)


def test_block_controller_takes_the_switch_estimator_on_the_stage_lane():
    """``ShardedController(4).run`` on the event run: ``'auto'`` gives the stage lane with the per-step
    ``t_switch`` as a ``(P,)`` float64 tensor, every stats entry equal to ``ControllerNonMPI(4)``'s; the fused
    lanes refuse the switch estimator."""
    parts = dict(RUNS['discontinuous-ode'], num_procs=4, Tend=1.8)
    _, serial, prob = build('torch', parts)
    u0 = prob.u_exact(0.0)
    want_u, want = serial.run(u0, 0.0, 1.8)
    ctrl = pysdc_tpu_torch.ShardedController(4, {'logger_level': 40, 'hook_class': serial.hooks[-1].__class__},
                                             serial.description)
    seen = []
    original = ctrl._block_overrides

    def spy(lvl_idx):
        ov = original(lvl_idx)
        seen.append(ov['t_switch'].clone())
        return ov

    ctrl._block_overrides = spy
    got_u, got = ctrl.run(u0, 0.0, 1.8)
    assert {v for k, v in got.items() if k.type == 'lane'} == {'stage'}
    assert seen and all(t.shape == (4,) and t.dtype == torch.float64 for t in seen)
    assert any(torch.isfinite(t).any() for t in seen)  # an event time reached the batched functions
    types = sorted({k.type for k in want if not k.type.startswith('timing')})
    assert types == sorted({k.type for k in got if not k.type.startswith('timing') and k.type != 'lane'})
    for kind in types:
        w = pysdc_tpu_torch.get_sorted(want, type=kind, recomputed=None)
        g = pysdc_tpu_torch.get_sorted(got, type=kind, recomputed=None)
        assert [t for t, _ in w] == [t for t, _ in g], kind
        for (_, a), (_, b) in zip(w, g):
            assert a == b if not isinstance(a, float) else abs(a - b) <= 1e-12 * max(1.0, abs(a)), kind
    np.testing.assert_allclose(to_numpy(got_u), to_numpy(want_u), rtol=0, atol=1e-12)
    assert [float(s.levels[0].prob.t_switch) for s in ctrl.MS] == [float(s.levels[0].prob.t_switch)
                                                                   for s in serial.MS]
    for lane in ('fused', 'fused_adaptive'):
        with pytest.raises(ControllerError, match='SwitchEstimator'):
            ctrl.run(u0, 0.0, 1.8, lane=lane)
