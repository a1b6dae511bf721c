"""Exponential SDC, the ionic models and the Monodomain problems of the PyTorch port against the JAX package
(float64, CPU).

The ESDC machinery (``derivative_weights_at_zero``, the phi tables summed node by node against the JAX einsum, the
exponential quadrature tensor) to 1e-14; each of the five ionic models against its JAX twin on the V sweep of
tests/test_monodomain.py:159-190 (1e-13 relative to each component's largest value) and against the native C++
library (the JAX tests' own tolerances); ``MonodomainIMEXEXP`` with ``IMEXEXPSweeper`` and ``MonodomainIMEX`` with ``IMEXSweeper`` on a 2D grid
through ``ControllerNonMPI`` against live JAX runs (equal ``niter``, ``uend`` to 1e-12 relative), ten Tusscher too;
and the block controller's stage and fused lanes, which the JAX package runs on these problems, against a live JAX
``ControllerNonMPI(4, ...)`` run.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysdc_tpu
import pysdc_tpu.models.ionic as jionic
import pysdc_tpu.models.monodomain as jmono
import pysdc_tpu.sweepers.imexexp as jexp
import pysdc_tpu_torch
from pysdc_tpu.core.state import IMEXEXP as JaxIMEXEXP
from pysdc_tpu_torch.core.state import IMEXEXP
from pysdc_tpu_torch.models import ionic, monodomain
from pysdc_tpu_torch.sweepers import imexexp
from pysdc_tpu_torch.utils.convert import to_numpy, to_torch
from test_torch_solvers import close

torch.set_num_threads(1)

MODELS = ['bistable', 'hodgkinhuxley', 'courtemanche', 'tentusscher', 'tentusscher_smooth']


# -- the ESDC machinery -------------------------------------------------------------------------------------------
@pytest.mark.parametrize('M', [2, 3, 5])
def test_derivative_weights_match_jax(M):
    c = pysdc_tpu_torch.IMEXSweeper(dict(num_nodes=M)).coll.nodes
    np.testing.assert_allclose(imexexp.derivative_weights_at_zero(c), jexp.derivative_weights_at_zero(c), rtol=0,
                               atol=1e-14 * np.abs(jexp.derivative_weights_at_zero(c)).max())


@pytest.mark.parametrize('K', [1, 3])
def test_phi_tables_match_the_jax_einsum(K):
    """The phi tables summed over the 12 Gauss nodes one at a time against the JAX package's einsum over all of them,
    on a seeded lambda field with several factors; and against phi_k's series / recurrence."""
    rng = np.random.default_rng(3)
    lmbda = -30.0 * rng.random((4, 8, 8)) + 1.0
    factors = np.array([0.01, 0.05, 0.5])
    tsw, jsw = imexexp.IMEXEXPSweeper(dict(num_nodes=3)), jexp.IMEXEXPSweeper(dict(num_nodes=3))
    got = tsw._phi_eval(factors, K, torch.as_tensor(lmbda))
    want = np.asarray(jsw._phi_eval(factors, K, jnp.asarray(lmbda)))
    assert got.shape == want.shape == (3, K) + lmbda.shape
    close(got, want, rtol=1e-14)
    for z in (-20.0, -0.5, 1.5):
        exact = [(math.exp(z) - 1.0) / z]
        for k in (1, 2):
            exact.append((exact[-1] - 1.0 / math.factorial(k)) / z)
        phi = to_numpy(tsw._phi_eval(np.array([1.0]), K, torch.tensor([z], dtype=torch.float64)))[0, :, 0]
        np.testing.assert_allclose(phi, exact[:K], rtol=1e-8)


def test_exponential_quadrature_matches_jax():
    """lambda(u0), the phi_1 table at the QI diagonal and Qmat_exp against the JAX sweeper's, for a host ``dt`` and
    for a 0-d ``dt`` tensor (as the fused lanes pass it)."""
    tprob = monodomain.MonodomainIMEXEXP(nvars=(8, 8), device='cpu')
    jprob = jmono.MonodomainIMEXEXP(nvars=(8, 8))
    rng = np.random.default_rng(4)
    u0 = np.asarray(jprob.u_exact(0.0)) * (1.0 + 0.05 * rng.standard_normal((4, 8, 8)))
    tsw, jsw = imexexp.IMEXEXPSweeper(dict(num_nodes=3)), jexp.IMEXEXPSweeper(dict(num_nodes=3))
    lm_j, phi_one_j, qmat_j = jsw._lambda_phi_qmat(jprob, jnp.asarray(u0), 0.0, 0.05)
    for dt in (0.05, torch.tensor(0.05, dtype=torch.float64)):
        lm, qmat = tsw._lambda_qmat(tprob, torch.as_tensor(u0), 0.0, dt)
        lm_one, phi_one = tsw._lambda_phi_one(tprob, torch.as_tensor(u0), 0.0, dt)
        close(lm, lm_j, rtol=1e-14)
        close(lm_one, lm_j, rtol=1e-14)
        close(qmat, qmat_j, rtol=1e-14)
        close(phi_one, phi_one_j, rtol=1e-14)


def test_imexexp_state_carries_across():
    z = np.arange(6.0).reshape(2, 3)
    f = to_torch(JaxIMEXEXP(impl=jnp.asarray(z), expl=jnp.asarray(2 * z), exp=jnp.asarray(3 * z)), 'cpu')
    assert isinstance(f, IMEXEXP) and float(f.exp[1, 2]) == 15.0
    back = to_numpy(f)
    assert type(back).__name__ == 'IMEXEXP' and np.array_equal(back.expl, 2 * z)


# -- the ionic models ---------------------------------------------------------------------------------------------
def _v_sweep(name):
    """tests/test_monodomain.py:159-190: perturbed published states, V swept through every rate branch."""
    native = jionic.NativeIonicModel(name, scale=1.0)
    y0 = native.initial_values()
    rng = np.random.default_rng(7)
    Y = y0[:, None] * (1.0 + 0.05 * rng.standard_normal((native.size, 64)))
    Y[0] = np.linspace(-90.0, 40.0, 64)
    conc = {'courtemanche': (16, 17, 18, 19, 20), 'tentusscher': (13, 14, 15, 17, 18),
            'tentusscher_smooth': (13, 14, 15, 17, 18)}.get(name, ())
    for i in conc:
        Y[i] = np.abs(Y[i]) + 1e-6
    if name == 'hodgkinhuxley':
        Y[1:] = rng.uniform(0.01, 0.99, (3, 64))
    return Y


def _rel(got, want):
    """Elementwise relative error with a floor of 1e-12 (the JAX tests' measure against the native library)."""
    return np.max(np.abs(got - want) / (1e-12 + np.abs(want)))


def _rel_rows(got, want):
    """The largest error of a component relative to that component's largest value: a rate that is a sum of
    cancelling currents (Courtemanche's d Ca_i / dt, 5e-10 out of 6e-8 on this sweep) carries the rounding of its
    terms, not of itself."""
    scale = np.maximum(np.abs(want).max(axis=-1, keepdims=True), 1e-300)
    return np.max(np.abs(got - want) / scale)


@pytest.mark.parametrize('name', MODELS)
def test_ionic_model_matches_jax(name):
    Y = _v_sweep(name)
    tm, jm = ionic.TORCH_MODELS[name](scale=1.3), jionic.JAX_MODELS[name](scale=1.3)
    assert tm.size == jm.size and tm.f_exp_indices == jm.f_exp_indices and tm.rho_f_expl() == jm.rho_f_expl()
    assert np.array_equal(to_numpy(tm.initial_values()), np.asarray(jm.initial_values()))
    ty, jy = torch.as_tensor(Y), jnp.asarray(Y)
    for fn in ('f', 'f_expl', 'lmbda_exp'):
        assert _rel_rows(to_numpy(getattr(tm, fn)(ty)), np.asarray(getattr(jm, fn)(jy))) < 1e-13, fn
    for got, want in zip(tm.lmbda_yinf_exp(ty), jm.lmbda_yinf_exp(jy)):
        assert _rel_rows(to_numpy(got), np.asarray(want)) < 1e-13
    # the component axis in front, any other axes ride along
    batched = tm.f(torch.as_tensor(np.stack([Y, Y[:, ::-1]], axis=1).reshape(tm.size, 2, 8, 8)))
    assert torch.equal(batched[:, 0].reshape(tm.size, 64), tm.f(ty))


@pytest.mark.parametrize('name', MODELS)
def test_ionic_model_matches_native_library(name):
    """The port's own copy of the ctypes reference, and the torch models against it at the JAX tests' tolerances
    (``np.allclose`` at rtol 1e-14 / 1e-13 for the bistable cubic and Hodgkin-Huxley, 1e-8 for the full models)."""
    Y = _v_sweep(name)
    native, tm = ionic.NativeIonicModel(name), ionic.TORCH_MODELS[name]()
    assert native.size == tm.size and native.rho_f_expl() == tm.rho_f_expl()
    np.testing.assert_allclose(native.initial_values(), to_numpy(tm.initial_values()))
    ty = torch.as_tensor(Y)
    if name in ('bistable', 'hodgkinhuxley'):  # tests/test_monodomain.py:23-49: np.allclose at these rtol
        rtol = 1e-14 if name == 'bistable' else 1e-13
        assert np.allclose(native.f(Y), to_numpy(tm.f(ty)), rtol=rtol)
        if name == 'hodgkinhuxley':
            assert np.allclose(native.f_expl(Y), to_numpy(tm.f_expl(ty)), rtol=rtol)
            assert np.allclose(native.lmbda_exp(Y), to_numpy(tm.lmbda_exp(ty)), rtol=rtol)
            for got, want in zip(tm.lmbda_yinf_exp(ty), native.lmbda_yinf_exp(Y)):
                assert np.allclose(want, to_numpy(got), rtol=rtol)
        return
    # tests/test_monodomain.py:177-190
    assert _rel(to_numpy(tm.f(ty)), native.f(Y)) < 1e-8
    assert np.max(np.abs(to_numpy(tm.lmbda_exp(ty)) - native.lmbda_exp(Y))) < 1e-8
    lm, yi = native.lmbda_yinf_exp(Y)
    assert np.max(np.abs(to_numpy(tm.lmbda_yinf_exp(ty)[1]) - yi)) < 1e-10
    fe = to_numpy(tm.f_expl(ty))
    for i in tm.f_expl_indices:
        assert _rel(fe[i], native.f_expl(Y)[i]) < 1e-8


# -- the Monodomain problems through the controllers -----------------------------------------------------------------
RUNS = {
    # name -> (problem, sweeper, sweeper params, problem params, dt, steps)
    'esdc': ('MonodomainIMEXEXP', 'esdc', dict(num_nodes=3, QI='IE'), dict(nvars=(32, 32)), 0.05, 2),
    'imex': ('MonodomainIMEX', 'imex', dict(num_nodes=3, QI='LU'), dict(nvars=(32, 32)), 0.05, 2),
    'esdc-tentusscher': ('MonodomainIMEXEXP', 'esdc', dict(num_nodes=3, QI='IE'),
                         dict(nvars=(16, 16), ionic_model='tentusscher', stim_ampl=40.0), 0.02, 2),
    # step 21's 1D strip (examples/step_21_monodomain_campaign.py:54-79) at 64 points: no K1 on a 1D grid
    'esdc-1d': ('MonodomainIMEXEXP', 'esdc', dict(num_nodes=3, QI='IE'), dict(nvars=64), 0.05, 2),
    # one step a block step, for the block controller's lanes (4 steps)
    'esdc-16': ('MonodomainIMEXEXP', 'esdc', dict(num_nodes=3, QI='IE'), dict(nvars=(16, 16)), 0.05, 1),
    'imex-16': ('MonodomainIMEX', 'imex', dict(num_nodes=3, QI='LU'), dict(nvars=(16, 16)), 0.05, 1),
}


def _description(package, name):
    cls, kind, sp, pp, dt, _ = RUNS[name]
    pp = dict(dict(ionic_model='hodgkinhuxley', diff=0.1, L=10.0), **pp)
    if package == 'jax':
        problem = getattr(jmono, cls)
        sweeper = jexp.IMEXEXPSweeper if kind == 'esdc' else pysdc_tpu.IMEXSweeper
    else:
        problem = getattr(monodomain, cls)
        sweeper = pysdc_tpu_torch.sweepers.IMEXEXPSweeper if kind == 'esdc' else pysdc_tpu_torch.IMEXSweeper
        pp = dict(pp, device='cpu')
    return dict(problem_class=problem, problem_params=pp, sweeper_class=sweeper, sweeper_params=dict(sp),
                level_params=dict(dt=dt, restol=1e-8), step_params=dict(maxiter=50))


@functools.lru_cache(maxsize=None)
def _run(package, name, num_procs=1, lane=None):
    pkg = pysdc_tpu if package == 'jax' else pysdc_tpu_torch
    desc = _description(package, name)
    if lane is None:
        ctrl = pkg.ControllerNonMPI(num_procs, {'logger_level': 40}, desc)
    else:
        ctrl = pkg.ShardedController(num_procs, {'logger_level': 40}, desc)
    prob = ctrl.MS[0].levels[0].prob
    steps = RUNS[name][5] * num_procs
    kwargs = {} if lane is None else dict(lane=lane)
    uend, stats = ctrl.run(prob.u_exact(0.0), 0.0, steps * RUNS[name][4], **kwargs)
    lanes = [v for k, v in stats.items() if k.type == 'lane']
    return np.asarray(to_numpy(uend)), [v for _, v in pkg.get_sorted(stats, type='niter', sortby='time')], lanes


@pytest.mark.parametrize('name', ['esdc', 'imex', 'esdc-tentusscher', 'esdc-1d'])
def test_monodomain_run_matches_live_jax(name):
    want, want_niter, _ = _run('jax', name)
    got, niter, _ = _run('torch', name)
    assert niter == want_niter and max(niter) < 50
    close(got, want, rtol=1e-12)
    assert np.isfinite(got).all() and got.shape == want.shape


def test_monodomain_evaluations_match_jax():
    """``eval_f`` (all three parts) and ``lmbda_eval`` on a perturbed state inside and after the stimulus, and the
    potential's shifted solve; ``eval_f_batched`` over the nodes with one time each."""
    jprob, tprob = jmono.MonodomainIMEXEXP(nvars=(16, 16)), monodomain.MonodomainIMEXEXP(nvars=(16, 16), device='cpu')
    rng = np.random.default_rng(9)
    u = np.asarray(jprob.u_exact(0.0)) * (1.0 + 0.05 * rng.standard_normal((4, 16, 16)))
    tu = torch.as_tensor(u)
    for t in (0.5, 3.0):
        for got, want in zip(tprob.eval_f(tu, t), jprob.eval_f(jnp.asarray(u), t)):
            close(got, want, rtol=1e-14)
    close(tprob.lmbda_eval(tu, 0.0), jprob.lmbda_eval(jnp.asarray(u), 0.0), rtol=1e-14)
    close(tprob.solve_system(tu, 0.3, tu, 0.0), jprob.solve_system(jnp.asarray(u), 0.3, None, 0.0), rtol=1e-14)
    stack = torch.stack([tu, 2 * tu])
    batched = tprob.eval_f_batched(stack, np.array([1.0, 2.5]))
    for m, t in enumerate((1.0, 2.5)):
        for got, want in zip(batched, tprob.eval_f(stack[m], t)):
            close(got[m], to_numpy(want), rtol=1e-15)


@pytest.mark.parametrize('name', ['esdc-16', 'imex-16'])
@pytest.mark.parametrize('lane', [None, 'stage', 'fused'])
def test_block_lanes_run_as_the_jax_package_does(name, lane):
    """The port's ``ControllerNonMPI(4, ...)`` and the block controller's stage and fused lanes on 4 steps at 16^2
    against a live JAX ``ControllerNonMPI(4, ...)`` run: equal ``niter``, ``uend`` to 1e-12 relative."""
    want, want_niter, _ = _run('jax', name, 4)
    got, niter, lanes = _run('torch', name, 4, lane)
    assert lanes == ([] if lane is None else [lane]) and niter == want_niter and max(niter) < 50
    close(got, want, rtol=1e-12)
