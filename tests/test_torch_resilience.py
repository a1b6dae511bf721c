"""Resilience in the PyTorch port against live runs of the JAX package
(float64, CPU): bit flips, the fault injector, Hot Rod and
``NewtonInexactness``.

``flip_bit`` is held against the JAX package's bit pattern for every bit of
both float widths.  The Hot Rod campaign of
``tests/test_estimators_resilience.py::test_hotrod_detects_injected_fault``
(HeatND 1D 64, a flip of exponent bit 10 at step 6, iteration 3, last node)
runs through both packages with the gates of
:func:`tests.test_torch_estimators.assert_same_run` (per step ``niter`` and
``restart``, both estimates per iteration to 1e-10 relative above the
rounding floor, ``uend`` to 1e-12), and through the port alone against its
fault-free run.  ``NewtonInexactness`` gives the same tolerance after every
iteration as the JAX package, and the block controller's stage lane hands
the same tolerances to its batched Newton as ``(P,)`` tensors.
"""

import numpy as np
import pytest
import torch

import pysdc_tpu_torch
from pysdc_tpu.convergence.estimate_extrapolation_error import EstimateExtrapolationErrorNonMPI as JaxExtrapolation
from pysdc_tpu.resilience.fault_injection import Fault as JaxFault
from pysdc_tpu.resilience.fault_injection import flip_bit as jax_flip_bit
from pysdc_tpu_torch.convergence.estimate_extrapolation_error import EstimateExtrapolationErrorNonMPI
from pysdc_tpu_torch.resilience.fault_injection import Fault, FaultInjector, flip_bit
from pysdc_tpu_torch.utils.convert import (
    extrapolation_store_to_numpy,
    extrapolation_store_to_torch,
    fault_to_torch,
    to_numpy,
)
from test_torch_estimators import REGISTRY, assert_same_run, build, entries, heat, run, vdp

torch.set_num_threads(1)

FAULT = dict(timestep=6, iteration=3, node=3, problem_pos=(10,), bit=10)
HOTROD_TOL = 1e-6
RUNS = {
    'hotrod-fault': heat({'HotRod': {'HotRod_tol': HOTROD_TOL}}, faults=(FAULT,)),
    'hotrod-clean': heat({'HotRod': {'HotRod_tol': HOTROD_TOL}}),
    'fault-without-hotrod': heat({}, faults=(dict(FAULT, iteration=5),)),
    'inexactness': vdp({'NewtonInexactness': {'ratio': 1e-2}}, dt=0.05, restol=1e-10, maxiter=20, Tend=0.2),
}
REGISTRY['resilience'] = RUNS


def result(package, name):
    return run(package, name, 'resilience')


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_flip_bit_matches_jax_for_every_bit(dtype):
    """Every bit of a random vector (negative, subnormal-free, zero included) against the JAX flip."""
    import jax.numpy as jnp

    width = 32 if dtype == 'float32' else 64
    values = np.random.default_rng(7).standard_normal(6).astype(dtype)
    values[0] = 0.0
    for bit in range(width):
        got = flip_bit(torch.as_tensor(values), bit).numpy()
        want = np.asarray(jax_flip_bit(jnp.asarray(values), bit))
        np.testing.assert_array_equal(got.view(f'u{width // 8}'), want.view(f'u{width // 8}'))
        assert np.array_equal(flip_bit(torch.as_tensor(got), bit).numpy().view(f'u{width // 8}'),
                              values.view(f'u{width // 8}'))
    assert float(flip_bit(torch.tensor(1.0, dtype=getattr(torch, dtype)), 0)) == -1.0
    with pytest.raises(NotImplementedError):
        flip_bit(torch.ones(2, dtype=torch.float16), 0)


@pytest.mark.parametrize('name', list(RUNS))
def test_run_matches_jax(name):
    want, got = result('jax', name), result('torch', name)
    assert_same_run(want, got)
    if want['injector'] is not None:
        assert [f.happened for f in got['injector'].faults] == [f.happened for f in want['injector'].faults] == [True]


def test_hotrod_detects_the_injected_fault_and_recovers():
    """The gates of the Resilience campaign: the fault happened, exactly the faulted step restarts, no restart
    without the fault, ``uend`` equals the fault-free run's, and the fault without Hot Rod leaves an error at
    least 1e3 times larger."""
    faulted, clean = result('torch', 'hotrod-fault'), result('torch', 'hotrod-clean')
    assert faulted['injector'].faults[0].happened
    restarts = entries(faulted, 'restart')
    steps = sorted({t for t, _ in entries(clean, 'niter')})
    assert [t for t, v in restarts if v] == [steps[FAULT['timestep'] - 1]]
    assert sum(v for _, v in entries(clean, 'restart')) == 0
    np.testing.assert_allclose(faulted['uend'], clean['uend'], rtol=1e-12, atol=0)
    exact = to_numpy(faulted['prob'].u_exact(1.0))
    err = np.abs(faulted['uend'] - exact).max()
    assert np.abs(result('torch', 'fault-without-hotrod')['uend'] - exact).max() > 1e3 * err


def test_random_faults_and_fault_fields_cross():
    """``Fault.random`` draws the same fault from the same generator; a fault of the JAX package crosses."""
    got = Fault.random(dict(timestep=3, max_iter=4), np.random.default_rng(3), 3, (8, 8), bits=32)
    want = JaxFault.random(dict(timestep=3, max_iter=4), np.random.default_rng(3), 3, (8, 8), bits=32)
    assert got == fault_to_torch(want) == fault_to_torch(vars(want))
    injector = FaultInjector()
    assert injector.add_random_fault(timestep=2, shape=(4,)).timestep == 2 and len(injector.faults) == 1


def test_extrapolation_store_crosses_between_the_packages():
    """A JAX run's stored step-end history, carried into a fresh port estimator, gives the JAX estimate."""
    jax_ctrl = result('jax', 'hotrod-clean')['ctrl']
    jax_est = next(C for C in jax_ctrl.convergence_controllers if isinstance(C, JaxExtrapolation))
    store = extrapolation_store_to_numpy(jax_est.store)
    _, ctrl, _ = build('torch', RUNS['hotrod-clean'])
    est = next(C for C in ctrl.convergence_controllers if isinstance(C, EstimateExtrapolationErrorNonMPI))
    est.store = extrapolation_store_to_torch(store, 'cpu')
    assert all(isinstance(u, torch.Tensor) for u in est.store['u'])
    for key in ('t', 'dt'):
        assert est.store[key] == store[key]
    for a, b in zip(est.store['u'], jax_est.store['u']):
        np.testing.assert_array_equal(to_numpy(a), np.asarray(b))


def test_newton_inexactness_tolerance_sequence():
    """The tolerance after every iteration equals the JAX package's (ratio times the residual), and tightens."""
    tols = {}
    for package in ('jax', 'torch'):
        res = result(package, 'inexactness')
        tols[package] = [v for _, v in entries(res, 'residual_post_iteration')]
        assert res['prob'].newton_tol == pytest.approx(1e-2 * tols[package][-1], rel=1e-12)
    np.testing.assert_allclose(tols['torch'], tols['jax'], rtol=1e-8, atol=1e-16)
    assert min(tols['torch']) < 1e-8


def test_newton_inexactness_on_the_block_stage_lane():
    """``ShardedController`` on the stage lane: the per-step tolerances reach the batched Newton as one
    ``(P,)`` float64 tensor, and the run equals ``ControllerNonMPI`` entry for entry."""
    parts = vdp({'NewtonInexactness': {'ratio': 1e-2}}, dt=0.05, restol=1e-10, maxiter=20, Tend=0.2)
    _, serial, prob = build('torch', dict(parts, num_procs=2))
    u0 = prob.u_exact(0.0)
    want_u, want = serial.run(u0, 0.0, 0.2)
    _, template, _ = build('torch', parts)
    ctrl = pysdc_tpu_torch.ShardedController(2, {'logger_level': 40}, template.description)
    seen = []
    original = ctrl._block_overrides

    def spy(lvl_idx):
        ov = original(lvl_idx)
        seen.append(ov['newton_tol'])
        return ov

    ctrl._block_overrides = spy
    got_u, got = ctrl.run(u0, 0.0, 0.2, lane='stage')
    assert seen and all(t.shape == (2,) and t.dtype == torch.float64 for t in seen)
    assert len({tuple(t.tolist()) for t in seen}) > 2
    for kind in ('niter', 'restart', 'residual_post_iteration'):
        w = pysdc_tpu_torch.get_sorted(want, type=kind, recomputed=None)
        g = pysdc_tpu_torch.get_sorted(got, type=kind, recomputed=None)
        assert len(w) == len(g) and all(abs(a[1] - b[1]) <= 1e-9 * abs(a[1]) + 1e-15 for a, b in zip(w, g)), kind
    np.testing.assert_allclose(to_numpy(got_u), to_numpy(want_u), rtol=0, atol=1e-12)
