"""SeparableFDOperator of the PyTorch port against the JAX package.

``apply`` and ``solve_shifted`` (rfft and full-FFT paths, several shifts
including 0) on periodic 1D/2D/3D and Dirichlet-zero (eigen) operators, and
the diagonal-basis interface, must agree with ``pysdc_tpu.ops.linop`` to
1e-12 relative to the result's scale, float64 on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysdc_tpu.ops.linop import SeparableFDOperator as JaxOp
from pysdc_tpu_torch.ops.linop import SeparableFDOperator as TorchOp

CASES = {
    'periodic-1d': ([(16, 'periodic', 2)], (16,)),
    'periodic-2d': ([(12, 'periodic', 2)] * 2, (3, 12, 12)),
    'periodic-2d-order4': ([(16, 'periodic', 4)] * 2, (16, 16)),
    'periodic-3d': ([(6, 'periodic', 2)] * 3, (2, 6, 6, 6)),
    'dirichlet-1d': ([(15, 'dirichlet-zero', 2)], (15,)),
    'dirichlet-2d': ([(10, 'dirichlet-zero', 4)] * 2, (2, 10, 10)),
    'mixed-2d': ([(8, 'periodic', 2), (9, 'dirichlet-zero', 2)], (8, 9)),
}


def _ops(case):
    dims, shape = CASES[case]
    per_dim = [dict(size=n, dx=1.0 / (n if bc == 'periodic' else n + 1), derivative=2, order=order, bc=bc)
               for n, bc, order in dims]
    return JaxOp(per_dim, scale=0.3), TorchOp(per_dim, scale=0.3), shape


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize('case', list(CASES))
def test_apply_matches_jax(case):
    jop, top, shape = _ops(case)
    u = np.random.default_rng(3).standard_normal(shape)
    _close(top.apply(torch.from_numpy(u)), jop.apply(jnp.asarray(u)))
    top.disable_pallas()
    _close(top.apply(torch.from_numpy(u)), jop.apply(jnp.asarray(u)))
    assert top.nnz_per_dof == jop.nnz_per_dof


@pytest.mark.parametrize('full_fft', [False, True], ids=['rfft', 'fft'])
@pytest.mark.parametrize('factor', [0.0, 1e-3, 0.37])
@pytest.mark.parametrize('case', list(CASES))
def test_solve_shifted_matches_jax(case, factor, full_fft):
    jop, top, shape = _ops(case)
    if full_fft:
        jop.disable_rfft()
        top.disable_rfft()
    rhs = np.random.default_rng(5).standard_normal(shape)
    got = top.solve_shifted(torch.from_numpy(rhs), factor)
    assert got.dtype == torch.float64 and got.shape == shape
    _close(got, jop.solve_shifted(jnp.asarray(rhs), factor))
    # it solves (I - factor A) x = rhs
    _close(got - factor * top.apply(got), rhs)


def test_batched_shifts_and_rfft_switch():
    jop, top, shape = _ops('periodic-2d')
    rhs = np.random.default_rng(8).standard_normal(shape)
    shifts = [0.0, 0.01, 0.2]
    got = top.solve_shifted(torch.from_numpy(rhs), torch.tensor(shifts, dtype=torch.float64).reshape(3, 1, 1))
    for i, f in enumerate(shifts):
        _close(got[i], jop.solve_shifted(jnp.asarray(rhs[i]), f))
    top.disable_rfft()
    assert not top._rfft_ok
    top.enable_rfft()
    assert top._rfft_ok


@pytest.mark.parametrize('case', ['periodic-2d', 'dirichlet-2d', 'mixed-2d'])
def test_diagonal_basis_matches_jax(case):
    """The same basis as the JAX package's.  An order-2 Dirichlet axis is the sine transform, whose modes run
    k = 1..n, the reverse of ``eigh``'s ascending eigenvalues, each eigenvector up to its sign: such an axis is
    flipped, and each of its modes takes the sign that matches."""
    jop, top, shape = _ops(case)
    x = np.random.default_rng(9).standard_normal(shape)
    sine = [d['axis'] - len(top.shape) for d in top._dims if d['kind'] == 'sine']
    assert (case == 'mixed-2d') == bool(sine)
    sym = np.flip(top.diag_symbol, axis=sine) if sine else top.diag_symbol
    np.testing.assert_allclose(sym, jop.diag_symbol, rtol=1e-14, atol=0)
    xhat = top.diag_forward(torch.from_numpy(x))
    want = np.asarray(jop.diag_forward(jnp.asarray(x)))
    got = torch.flip(xhat, sine)
    for ax in sine:
        others = tuple(a for a in range(got.dim()) if a != got.dim() + ax)
        sign = np.sign((got.numpy().conj() * want).real.sum(axis=others))
        assert np.all(sign != 0)
        got = got * torch.from_numpy(sign).reshape((-1,) + (1,) * (-ax - 1))
    _close(got, want)
    back = top.diag_backward(xhat, torch.float64, real=True)
    _close(back, x)


def test_float32_stays_float32():
    _, top, shape = _ops('mixed-2d')
    u = torch.from_numpy(np.random.default_rng(1).standard_normal(shape)).float()
    assert top.apply(u).dtype == torch.float32
    assert top.solve_shifted(u, 0.1).dtype == torch.float32
