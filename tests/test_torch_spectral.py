"""The spectral operator and the spectral PDE models of the PyTorch port
against the JAX package (float64 / complex128, CPU).

``SpectralOperator`` is held against the JAX class on seeded fields (real and
complex symbols, real and complex fields, one shift per node of a batch); each
model runs through ``ControllerNonMPI`` with the sweeper its ``f_kind`` calls
for (all here are IMEX), against a live JAX run: equal ``niter``, ``uend`` to
1e-11 relative, the initial conditions equal (the random ones are drawn from
the same numpy generators).  The multi-implicit Gray-Scott classes' two solves
are held directly, the pointwise Newton's iteration count against the JAX
loop's (their sweeper runs them in tests/test_torch_sweepers.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysdc_tpu
import pysdc_tpu.models.advdiff as jadv
import pysdc_tpu.models.allen_cahn_spectral as jacs
import pysdc_tpu.models.brusselator as jbru
import pysdc_tpu.models.gray_scott as jgs
import pysdc_tpu.models.nls as jnls
import pysdc_tpu_torch
from pysdc_tpu.ops.linop import SpectralOperator as JaxSpectral
from pysdc_tpu.sweepers.imex import IMEXSweeper as JaxIMEX
from pysdc_tpu_torch import models
from pysdc_tpu_torch.models.heat import node_shift_column
from pysdc_tpu_torch.ops.linop import SpectralOperator
from pysdc_tpu_torch.utils.convert import to_numpy, to_torch
from test_torch_solvers import close

torch.set_num_threads(1)


@pytest.mark.parametrize('symbol', ['laplacian', 'derivative'])
@pytest.mark.parametrize('shape', [(48,), (16, 24)])
@pytest.mark.parametrize('complex_field', [False, True])
def test_spectral_operator_matches_jax(symbol, shape, complex_field):
    lengths = (2.0,) * len(shape)
    fn = None if symbol == 'laplacian' else (lambda *k: 1j * sum(k))
    jop = JaxSpectral(shape, symbol_fn=fn, lengths=lengths, scale=0.3)
    top = SpectralOperator(shape, symbol_fn=fn, lengths=lengths, scale=0.3)
    rng = np.random.default_rng(1)
    u = rng.standard_normal((3,) + shape)
    if complex_field:
        u = u + 1j * rng.standard_normal((3,) + shape)
    tu = torch.as_tensor(u)
    got = top.apply(tu)
    assert got.dtype == tu.dtype
    close(got, jop.apply(jnp.asarray(u)))
    close(top.solve_shifted(tu, 0.05), jop.solve_shifted(jnp.asarray(u), 0.05))
    # one shift per entry of the leading axis, as a sweep over the nodes gives them
    shifts = np.array([0.01, 0.02, 0.04])
    got = top.solve_shifted(tu, node_shift_column(top, shifts, tu))
    for m in range(3):
        close(got[m], jop.solve_shifted(jnp.asarray(u[m]), float(shifts[m])))
    uhat = top.diag_forward(tu)
    close(uhat, jop.diag_forward(jnp.asarray(u)))
    close(top.diag_backward(uhat * top.diag_symbol_on(uhat), tu.dtype, not complex_field),
          jop.diag_backward(jop.diag_forward(jnp.asarray(u)) * jop.diag_symbol, jnp.asarray(u).dtype,
                            not complex_field))


def test_spectral_symbol_follows_the_field_and_its_changes():
    """The symbol meets a field in the field's precision (float32 / complex64 stay single), and a symbol set after
    construction (the stabilized Allen-Cahn splitting shifts it) replaces the tensors made of the old one."""
    op = SpectralOperator((16, 16))
    u32 = torch.ones(16, 16, dtype=torch.float32)
    assert op.apply(u32).dtype == torch.float32 and op.symbol_on(u32).dtype == torch.float32
    assert op.symbol_on(u32.to(torch.complex64)).dtype == torch.float32
    before = op.symbol_on(u32.double()).clone()
    op.symbol = op.symbol - 5.0
    assert torch.equal(op.symbol_on(u32.double()), before - 5.0)


# -- the models through the controller ---------------------------------------------------------------------------
# name -> (JAX module, class name, problem_params, dt, n_steps)
MODELS = {
    'advdiff': (jadv, 'AdvectionDiffusion1D', dict(nvars=64, c=1.0, nu=0.02, freq=2), 0.01, 3),
    'brusselator': (jbru, 'Brusselator', dict(nvars=(24, 24), alpha=0.1), 0.01, 2),
    'gray-scott': (jgs, 'GrayScott', dict(nvars=(24, 24), num_blobs=3), 1.0, 2),
    'gray-scott-linear': (jgs, 'GrayScottLinearIMEX', dict(nvars=(24, 24)), 1.0, 2),
    'nls-2d': (jnls, 'NonlinearSchroedinger', dict(nvars=(16, 16), c=1.0), 0.01, 2),
    'nls-1d-linear': (jnls, 'NonlinearSchroedinger', dict(nvars=32, c=0.0), 0.05, 2),
    'ac-spectral-circle': (jacs, 'AllenCahnSpectralND', dict(nvars=(32, 32), eps=0.04, dw=-0.5), 1e-4, 2),
    'ac-spectral-rand': (jacs, 'AllenCahnSpectralND', dict(nvars=(32, 32), eps=0.1, L=2.0, init_type='circle_rand'),
                         1e-3, 2),
    'ac-time-forcing': (jacs, 'AllenCahnSpectralTimeForcing', dict(nvars=(32, 32), eps=0.04), 1e-4, 2),
    'ac-2d': (jacs, 'AllenCahn2DSpectral', dict(nvars=(32, 32), eps=0.04), 1e-4, 2),
    'ac-2d-random': (jacs, 'AllenCahn2DSpectral', dict(nvars=(32, 32), eps=0.2, init_type='random'), 1e-3, 2),
    'ac-2d-stab': (jacs, 'AllenCahn2DSpectralStab', dict(nvars=(32, 32), eps=0.04), 1e-4, 2),
    'ac-temperature': (jacs, 'AllenCahnTempSpectralND', dict(nvars=(24, 24), eps=0.04, dw=-0.5), 1e-4, 2),
}


def _description(package, name):
    _, cls, params, dt, _ = MODELS[name]
    if package == 'jax':
        pkg, problem, sweeper = pysdc_tpu, getattr(MODELS[name][0], cls), JaxIMEX
    else:
        pkg, problem, sweeper = pysdc_tpu_torch, getattr(models, cls), pysdc_tpu_torch.IMEXSweeper
        params = dict(params, device='cpu')
    return pkg, dict(problem_class=problem, problem_params=dict(params), sweeper_class=sweeper,
                     sweeper_params=dict(num_nodes=3, quad_type='RADAU-RIGHT', QI='LU', QE='EE'),
                     level_params=dict(dt=dt, restol=1e-10), step_params=dict(maxiter=20))


@functools.lru_cache(maxsize=None)
def _run(package, name):
    pkg, desc = _description(package, name)
    ctrl = pkg.ControllerNonMPI(1, {'logger_level': 40}, desc)
    prob = ctrl.MS[0].levels[0].prob
    u0 = prob.u_exact(0.0)
    uend, stats = ctrl.run(u0, 0.0, MODELS[name][4] * MODELS[name][3])
    return (np.asarray(to_numpy(u0)), np.asarray(to_numpy(uend)),
            [v for _, v in pkg.get_sorted(stats, type='niter', sortby='time')], prob)


@pytest.mark.parametrize('name', list(MODELS))
def test_spectral_model_matches_live_jax_run(name):
    want_u0, want, want_niter, _ = _run('jax', name)
    got_u0, got, niter, prob = _run('torch', name)
    assert prob.f_kind == 'imex' and got.dtype == want.dtype
    close(got_u0, want_u0, rtol=1e-14)
    assert niter == want_niter and len(niter) >= 2 and max(niter) < 20
    close(got, want)
    assert np.abs(got - got_u0).max() > 1e-8  # the run moved


def test_nls_exact_solution_and_state_type():
    jprob, tprob = jnls.NonlinearSchroedinger(nvars=(16, 16)), models.NonlinearSchroedinger(nvars=(16, 16),
                                                                                            device='cpu')
    assert tprob.dtype == torch.complex128 and tprob.u_init.dtype == torch.complex128
    for t in (0.0, 0.3):
        close(tprob.u_exact(t), jprob.u_exact(t))
    state = to_torch(np.asarray(jprob.u_exact(0.1)), 'cpu', torch.float64)  # a real dtype asked of a complex field
    assert state.dtype == torch.complex128 and bool(state.imag.abs().max() > 0)


@pytest.mark.parametrize('cls', ['GrayScottMultiImplicit', 'GrayScottMultiImplicitLinear'])
def test_gray_scott_multi_implicit_solves(cls):
    """Both components of ``eval_f``, the diffusion solve and the pointwise 2x2 Newton ``solve_system_2`` against
    the JAX class; the Newton count against the JAX loop's (one Jacobian an iteration, counted by a callback)."""
    jprob = getattr(jgs, cls)(nvars=(16, 16), newton_tol=1e-12)
    tprob = getattr(models, cls)(nvars=(16, 16), newton_tol=1e-12, device='cpu')
    rng = np.random.default_rng(21)
    u = np.asarray(jprob.u_exact(0.0)) + 0.05 * rng.standard_normal((2, 16, 16))
    rhs = u + 0.05 * rng.standard_normal((2, 16, 16))
    tu, trhs = torch.as_tensor(u), torch.as_tensor(rhs)
    fj, ft = jprob.eval_f(u, 0.0), tprob.eval_f(tu, 0.0)
    close(ft.comp1, fj.comp1)
    close(ft.comp2, fj.comp2)
    factor = 0.5
    close(tprob.solve_system(trhs, factor, tu, 0.0), jprob.solve_system(rhs, factor, u, 0.0))
    calls = []
    orig = jgs._newton_2x2_pointwise

    def counted(rhs, factor, u0, residual_fn, jacobian_fn, tol, maxiter):
        def jac(v):
            jax.debug.callback(lambda: calls.append(1), ordered=True)
            return jacobian_fn(v)

        return orig(rhs, factor, u0, residual_fn, jac, tol, maxiter)

    jgs._newton_2x2_pointwise = counted
    try:
        want = jax.block_until_ready(jprob.solve_system_2(rhs, factor, u, 0.0))
        jax.effects_barrier()
    finally:
        jgs._newton_2x2_pointwise = orig
    tprob.newton_trace = []
    close(tprob.solve_system_2(trhs, factor, tu, 0.0), want)
    assert tprob.newton_trace == [len(calls)] and 2 <= len(calls) < tprob.newton_maxiter
