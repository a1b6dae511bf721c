"""The sine-transform path of ``SeparableFDOperator`` (``ops/linop.py``) against an independent eigen solve.

An axis whose 1-D matrix is the order-2 Dirichlet second difference ``c tridiag(1, -2, 1)`` transforms by the
orthonormal DST-I; these tests hold it against ``V diag(.) V^T`` from numpy's ``eigh`` of the same matrix: the
shifted solve in float64 to 1e-12 and in float32 to a few float32 eps times ``log2 n``, in 1-D and 2-D, odd and even
sizes, ``nx != ny``, a ``dx`` of each axis, leading batch axes with one shift each; the diagonal basis's round trip and
its symbol in the transform's mode order; the counters ``separable.eigen_solves`` / ``separable.sine_solves`` /
``separable.sine_kernel_solves``; the dense path kept for every other non-periodic operator; and ``VarCoeffDiffusion2D``'s PCG, preconditioned through the
sine path, against the same PCG preconditioned by the numpy eigen solve.
"""

import math

import numpy as np
import pytest
import torch

from pysdc_tpu_torch.models.var_diffusion import VarCoeffDiffusion2D
from pysdc_tpu_torch.ops.fd import fd_matrix_1d
from pysdc_tpu_torch.ops.linop import SeparableFDOperator, second_difference_scale, sine_transform
from pysdc_tpu_torch.utils import trace

torch.set_num_threads(1)  # several test processes share the machine's cores

SCALE = 0.3
#: (sizes, dx of each axis, leading batch shape)
CASES = {
    '1d-odd': ((15,), (0.07,), ()),
    '1d-even': ((16,), (0.05,), (3,)),
    '2d-odd-even': ((9, 12), (0.1, 0.03), (2,)),
    '2d-even-odd': ((16, 7), (0.02, 0.11), (2, 3)),
    '2d-square': ((32, 32), (1 / 33, 1 / 33), (4,)),
}


def _per_dim(sizes, dxs, bc='dirichlet-zero', order=2):
    return [dict(size=n, dx=dx, derivative=2, order=order, bc=bc) for n, dx in zip(sizes, dxs)]


def _eigh_solve(per_dim, rhs, factor):
    """``(I - factor * SCALE * A) x = rhs`` through ``V diag(1 / (1 - factor SCALE lam)) V^T`` of each axis's
    ``eigh``, in float64 numpy; ``factor`` a number or an array that broadcasts against ``rhs``."""
    ndim = len(per_dim)
    x, lam_nd = np.asarray(rhs), 0.0
    tables = []
    for axis, d in enumerate(per_dim):
        A1, _ = fd_matrix_1d(2, d['order'], d['size'], d['dx'], bc=d['bc'])
        lam, V = np.linalg.eigh(0.5 * (A1 + A1.T))
        tables.append(V)
        shape = [1] * ndim
        shape[axis] = d['size']
        lam_nd = lam_nd + lam.reshape(shape)
    offset = x.ndim - ndim
    for axis, V in enumerate(tables):
        x = np.moveaxis(np.tensordot(V.T, x, axes=([1], [axis + offset])), 0, axis + offset)
    x = x / (1.0 - np.asarray(factor) * SCALE * lam_nd)
    for axis, V in enumerate(tables):
        x = np.moveaxis(np.tensordot(V, x, axes=([1], [axis + offset])), 0, axis + offset)
    return x


def _factor(batch, ndim):
    """One shift for each batch entry, shaped to broadcast against the grid (a float without batch axes)."""
    if not batch:
        return 0.37
    return np.geomspace(1e-4, 0.5, math.prod(batch)).reshape(batch + (1,) * ndim)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32], ids=['float64', 'float32'])
@pytest.mark.parametrize('case', list(CASES))
def test_solve_shifted_matches_eigh(case, dtype):
    sizes, dxs, batch = CASES[case]
    per_dim = _per_dim(sizes, dxs)
    op = SeparableFDOperator(per_dim, scale=SCALE)
    assert [d['kind'] for d in op._dims] == ['sine'] * len(sizes)
    assert not any('V' in d or 'Vinv' in d for d in op._dims)
    rhs = np.random.default_rng(11).standard_normal(batch + sizes)
    f = _factor(batch, len(sizes))
    factor = f if np.isscalar(f) else torch.as_tensor(f, dtype=dtype)
    got = op.solve_shifted(torch.as_tensor(rhs, dtype=dtype), factor)
    assert got.dtype == dtype and got.shape == rhs.shape and got.is_contiguous()
    want = _eigh_solve(per_dim, rhs, f)
    if dtype == torch.float64:
        tol = 1e-12
    else:
        tol = 4 * torch.finfo(torch.float32).eps * math.log2(max(sizes) + 1)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize('n', [3, 8, 15, 16, 33])
def test_sine_transform_is_the_orthonormal_dst(n):
    x = torch.as_tensor(np.random.default_rng(n).standard_normal((2, n, 5)))
    j = np.arange(1, n + 1)
    S = math.sqrt(2 / (n + 1)) * np.sin(np.pi * np.outer(j, j) / (n + 1))
    angle = torch.as_tensor(np.pi * j / (n + 1))
    cs, sn = torch.cos(angle), torch.sin(angle)
    got = sine_transform(x, 1, cs, sn)
    np.testing.assert_allclose(got.numpy(), np.einsum('kj,bjc->bkc', S, x.numpy()), rtol=0, atol=1e-13)
    np.testing.assert_allclose(sine_transform(got, 1, cs, sn).numpy(), x.numpy(), rtol=0, atol=1e-13)
    np.testing.assert_allclose(sine_transform(x.transpose(1, 2), -1, cs, sn).numpy(),
                               np.einsum('kj,bjc->bck', S, x.numpy()), rtol=0, atol=1e-13)
    z = torch.complex(x, 2 * x.flip(0))
    np.testing.assert_allclose(sine_transform(z, 1, cs, sn).numpy(), np.einsum('kj,bjc->bkc', S, z.numpy()), rtol=0,
                               atol=1e-13)


@pytest.mark.parametrize('case', ['1d-even', '2d-odd-even', '2d-even-odd'])
def test_diagonal_basis_round_trip_and_symbol(case):
    """``diag_backward(diag_forward(x)) == x``, and the symbol in the same mode order: ``diag_backward(symbol *
    diag_forward(x))`` is the operator's apply; the symbol is the closed form, the multiset of ``eigh``'s."""
    sizes, dxs, batch = CASES[case]
    per_dim = _per_dim(sizes, dxs)
    op = SeparableFDOperator(per_dim, scale=SCALE)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(batch + sizes))
    xhat = op.diag_forward(x)
    assert xhat.dtype == torch.float64
    np.testing.assert_allclose(op.diag_backward(xhat, torch.float64, real=True).numpy(), x.numpy(), rtol=0,
                               atol=1e-13)
    sym = op.diag_symbol_on(xhat)
    Ax = op.apply(x)
    np.testing.assert_allclose(op.diag_backward(sym * xhat, torch.float64, real=True).numpy(), Ax.numpy(), rtol=0,
                               atol=1e-12 * float(Ax.abs().max()))
    lam_nd = 0.0
    for axis, d in enumerate(per_dim):
        A1, _ = fd_matrix_1d(2, 2, d['size'], d['dx'], bc=d['bc'])
        shape = [1] * len(sizes)
        shape[axis] = d['size']
        lam_nd = lam_nd + np.linalg.eigh(0.5 * (A1 + A1.T))[0].reshape(shape)
    want = np.sort(SCALE * np.ravel(lam_nd))
    np.testing.assert_allclose(np.sort(np.ravel(op.diag_symbol)), want, rtol=0, atol=1e-13 * np.abs(want).max())


@pytest.mark.parametrize('bc', ['dirichlet', 'dirichlet-zero'])
@pytest.mark.parametrize('n', [3, 16, 17, 1024])
def test_second_difference_detected(n, bc):
    A1, _ = fd_matrix_1d(2, 2, n, 0.37 / (n + 1), bc=bc)
    assert second_difference_scale(A1) == pytest.approx((n + 1) ** 2 / 0.37**2, rel=1e-15)


@pytest.mark.parametrize('order,bc', [(4, 'dirichlet-zero'), (2, 'neumann'), (2, ('dirichlet', 'neumann')),
                                      (4, 'dirichlet')])
def test_other_operators_keep_the_dense_path(order, bc):
    """Order 4 and Neumann axes keep the dense eigen product, and count as eigen solves, not sine solves."""
    per_dim = _per_dim((12, 10), (0.08, 0.09), bc=bc, order=order)
    A1, _ = fd_matrix_1d(2, order, 12, 0.08, bc=bc)
    assert second_difference_scale(A1) is None
    op = SeparableFDOperator(per_dim, scale=SCALE)
    assert [d['kind'] for d in op._dims] == ['dense', 'dense']
    rhs = torch.as_tensor(np.random.default_rng(2).standard_normal((2, 12, 10)))
    trace.enable('cpu')
    try:
        x = op.solve_shifted(rhs, 0.01)
        op.solve_shifted(rhs, 0.02)
        counters = dict(trace.record().counters)
    finally:
        trace.disable()
    assert counters.get('separable.eigen_solves') == 2 and counters.get('separable.sine_solves', 0) == 0
    np.testing.assert_allclose((x - 0.01 * op.apply(x)).numpy(), rhs.numpy(), rtol=0, atol=1e-11)


def test_counters():
    """Every solve off the rfft path of an operator with a non-periodic axis is an eigen solve; a sine solve where
    every such axis is a sine axis; a sine kernel solve where the sine kernels served it (never off the card through
    ``solve_shifted``; their route called directly runs their plain version), not where they declined; the rfft path
    counts none; nothing is counted with tracing off."""
    sine = SeparableFDOperator(_per_dim((8, 9), (0.1, 0.1)), scale=SCALE)
    mixed = SeparableFDOperator([dict(size=8, dx=0.125, bc='periodic'), dict(size=9, dx=0.1, bc='dirichlet-zero')],
                                scale=SCALE)
    half = SeparableFDOperator([dict(size=8, dx=0.1, bc='dirichlet-zero'),
                                dict(size=9, dx=0.1, order=4, bc='dirichlet-zero')], scale=SCALE)
    periodic = SeparableFDOperator([dict(size=8, dx=0.125, bc='periodic')] * 2, scale=SCALE)
    assert [d['kind'] for d in half._dims] == ['sine', 'dense']
    u = torch.ones((8, 9), dtype=torch.float64)
    sine.solve_shifted(u, 0.1)  # tracing off
    trace.enable('cpu')
    try:
        sine.solve_shifted(u, 0.1)
        sine.solve_shifted(u.to(torch.complex128), 0.1)
        mixed.solve_shifted(u, 0.1)
        half.solve_shifted(u, 0.1)
        periodic.solve_shifted(torch.ones((8, 8), dtype=torch.float64), 0.1)
        assert sine._sine_kernel_solve(u, -0.1) is None
        sine._sine_kernel_solve(u, 0.1)
        counters = {k: v for k, v in trace.record().counters.items() if k.startswith('separable.')}
    finally:
        trace.disable()
    assert counters == {'separable.eigen_solves': 4, 'separable.sine_solves': 3, 'separable.sine_kernel_solves': 1}


def test_mixed_and_complex_solves_match_eigh():
    """A complex right-hand side, on two sine axes and beside a periodic axis, against the eigen solve."""
    rng = np.random.default_rng(6)
    per_dim = _per_dim((9, 12), (0.1, 0.03))
    rhs = rng.standard_normal((2, 9, 12)) + 1j * rng.standard_normal((2, 9, 12))
    got = SeparableFDOperator(per_dim, scale=SCALE).solve_shifted(torch.as_tensor(rhs), 0.05)
    assert got.dtype == torch.complex128
    want = _eigh_solve(per_dim, rhs, 0.05)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())
    mixed = SeparableFDOperator([dict(size=8, dx=0.125, derivative=2, order=2, bc='periodic'),
                                 dict(size=9, dx=0.1, derivative=2, order=2, bc='dirichlet-zero')], scale=SCALE)
    rhs = rhs[0, :8, :9]
    x = mixed.solve_shifted(torch.as_tensor(rhs), 0.2)
    assert x.dtype == torch.complex128
    np.testing.assert_allclose((x - 0.2 * mixed.apply(x)).numpy(), rhs, rtol=0, atol=1e-12)


def test_complex_and_batched_shifts():
    """A complex shift makes the transformed field complex; a shift for each of several systems widens an unbatched
    right-hand side to one solution each, as the division does on the dense path."""
    per_dim = _per_dim((9, 12), (0.1, 0.03))
    op = SeparableFDOperator(per_dim, scale=SCALE)
    rng = np.random.default_rng(8)
    rhs = rng.standard_normal((2, 9, 12))
    z = rhs + 1j * rng.standard_normal((2, 9, 12))
    for f in (0.05 + 0.02j, torch.tensor(0.05 - 0.03j, dtype=torch.complex128)):
        got = op.solve_shifted(torch.as_tensor(z), f)
        assert got.dtype == torch.complex128
        want = _eigh_solve(per_dim, z, complex(f))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())
    f = np.array([0.0, 1e-3, 0.2]).reshape(3, 1, 1)
    got = op.solve_shifted(torch.as_tensor(rhs[0]), torch.as_tensor(f))
    assert got.shape == (3, 9, 12)
    want = _eigh_solve(per_dim, np.broadcast_to(rhs[0], (3, 9, 12)), f)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())


class _EighPrecond:
    """The separable surrogate's shifted solve by numpy's ``eigh`` tables, applied as dense products in float64:
    the preconditioner as it was before the sine transform, independent of ``ops/linop.py``."""

    def __init__(self, op: SeparableFDOperator):
        self.per_dim = [dict(size=d['A'].shape[0], A=d['A']) for d in op._dims]
        self.scale = op.scale
        self.tables = []
        lam_nd = 0.0
        for axis, d in enumerate(self.per_dim):
            lam, V = np.linalg.eigh(0.5 * (d['A'] + d['A'].T))
            self.tables.append(torch.as_tensor(V))
            shape = [1] * len(self.per_dim)
            shape[axis] = d['size']
            lam_nd = lam_nd + lam.reshape(shape)
        self.lam = torch.as_tensor(lam_nd)

    def solve_shifted(self, rhs, factor):
        offset = rhs.dim() - len(self.tables)
        x = rhs
        for axis, V in enumerate(self.tables):
            x = torch.movedim(torch.tensordot(V.T.to(rhs.dtype), x, dims=([1], [axis + offset])), 0, axis + offset)
        x = x / (1.0 - factor * self.scale * self.lam.to(rhs.dtype))
        for axis, V in enumerate(self.tables):
            x = torch.movedim(torch.tensordot(V.to(rhs.dtype), x, dims=([1], [axis + offset])), 0, axis + offset)
        return x.contiguous()


def _coeff(x, y):
    return 0.1 * (1.0 + 0.5 * np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y))


@pytest.mark.parametrize('n', [32, 64])
def test_var_diffusion_pcg_unchanged(n):
    """``VarCoeffDiffusion2D``'s PCG through the sine path takes the same trips on each system as through the numpy
    eigen solve, and the solutions agree within the PCG's tolerance."""
    prob = VarCoeffDiffusion2D(nvars=(n, n), coeff_fn=_coeff, dtype=torch.float64, solver='pcg', device='cpu')
    A = prob.A
    assert [d['kind'] for d in A.precond._dims] == ['sine', 'sine']
    X, Y = prob.grids
    rng = np.random.default_rng(n)
    rhs = torch.stack([torch.sin(np.pi * X) * torch.sin(np.pi * Y) + 0.3 * torch.cos(5 * np.pi * X) * Y,
                       torch.as_tensor(rng.standard_normal((n, n)))]).contiguous()
    tol = 1e-10
    runs = {}
    for name, precond in (('sine', A.precond), ('eigh', _EighPrecond(A.precond))):
        A.precond, A.pcg_trace = precond, []
        for factor in (2.5e-4, 1e-3):
            x = A.solve_shifted(rhs, factor, tol=tol, batch_ndim=1)
            runs.setdefault(name, []).append(x)
        runs[name + '_trips'] = list(A.pcg_trace)
    assert runs['sine_trips'] == runs['eigh_trips']
    assert min(runs['sine_trips']) > 1
    for a, b in zip(runs['sine'], runs['eigh']):
        for i in range(rhs.shape[0]):
            assert float((a[i] - b[i]).norm() / b[i].norm()) <= 10 * tol


# ----------------------------------------------------------------------
# the sine kernels' algorithm (ops/kernels/sine.py), by its plain version: the DST-I along y from a complex FFT of
# each row's odd extension, a tridiagonal sweep along x for each sine mode
# ----------------------------------------------------------------------
@pytest.mark.parametrize('n', [1, 2, 7, 16, 33])
def test_dst_coefficients_from_the_odd_extension(n):
    """The split of the FFT of the odd extension's interleaved pairs gives the unnormalised DST-I of each row, and
    ``dst_rows`` that, scaled."""
    from pysdc_tpu_torch.ops.kernels.sine import dst_coefficients, dst_rows, fft_rows, odd_extension

    x = torch.as_tensor(np.random.default_rng(n).standard_normal((3, 2, n)))
    k = np.arange(1, n + 1)
    angle = torch.as_tensor(np.pi * k / (n + 1))
    got = dst_coefficients(fft_rows(odd_extension(x)), torch.cos(angle), torch.sin(angle))
    S = np.sin(np.pi * np.outer(k, k) / (n + 1))
    np.testing.assert_allclose(got.numpy(), x.numpy() @ S, rtol=0, atol=1e-13 * n)
    # the transform alone, scaled, on a field whose rows are not contiguous (its plain version on the CPU)
    y = x.transpose(0, 1)
    got = dst_rows(y, torch.cos(angle), torch.sin(angle), 0.5)
    np.testing.assert_allclose(got.numpy(), 0.5 * y.numpy() @ S, rtol=0, atol=1e-13 * n)


def test_tridiag_sweep_matches_a_dense_solve():
    from pysdc_tpu_torch.ops.kernels.sine import tridiag_sweep

    rng = np.random.default_rng(3)
    B, nx, ny = 2, 13, 5
    diag = torch.as_tensor(2.5 + rng.random((B, ny)))
    off = torch.as_tensor(-rng.random((B, 1)))
    d = torch.as_tensor(rng.standard_normal((B, nx, ny)))
    got = tridiag_sweep(d, diag, off)
    for b in range(B):
        for k in range(ny):
            T = (np.diag(np.full(nx, float(diag[b, k]))) + float(off[b, 0]) * (np.eye(nx, k=1) + np.eye(nx, k=-1)))
            np.testing.assert_allclose(got[b, :, k].numpy(), np.linalg.solve(T, d[b, :, k].numpy()), rtol=0,
                                       atol=1e-13)


SWEEP_CASES = {'odd-even': ((9, 12), (0.1, 0.03), (2,)), 'even-odd': ((16, 7), (0.02, 0.11), (2, 3)),
               'square': ((32, 32), (1 / 33, 1 / 33), (4,)), 'unbatched': ((33, 20), (0.05, 0.07), ())}


@pytest.mark.parametrize('shift', ['number', 'tensor'])
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32], ids=['float64', 'float32'])
@pytest.mark.parametrize('case', list(SWEEP_CASES))
def test_sine_kernel_solve_matches_eigh(case, dtype, shift):
    """The operator's route to the sine kernels (on the CPU their plain version runs): the shifts reshaped to one a
    batch entry, the tables, the scale; float64 to 1e-12, float32 to a few eps times ``log2 n``."""
    sizes, dxs, batch = SWEEP_CASES[case]
    per_dim = _per_dim(sizes, dxs)
    op = SeparableFDOperator(per_dim, scale=SCALE)
    rhs = np.random.default_rng(12).standard_normal(batch + sizes)
    if shift == 'number' or not batch:
        f = 0.0123
        factor = f if shift == 'number' else torch.tensor(f, dtype=dtype)
    else:
        f = np.geomspace(1e-4, 0.5, math.prod(batch)).reshape(batch + (1, 1))
        factor = torch.as_tensor(f, dtype=dtype)
    got = op._sine_kernel_solve(torch.as_tensor(rhs, dtype=dtype), factor)
    assert got.dtype == dtype and got.shape == rhs.shape and got.is_contiguous()
    want = _eigh_solve(per_dim, rhs, f)
    tol = 1e-12 if dtype == torch.float64 else 4 * torch.finfo(torch.float32).eps * math.log2(max(sizes) + 1)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=0, atol=tol * np.abs(want).max())


def test_sine_kernel_solve_declines():
    """The kernels' route declines what the sweep cannot take: a complex field or shift, a shift that varies over the
    grid, a negative number, a field a gradient is asked of; and operators that are not two sine axes have none."""
    op = SeparableFDOperator(_per_dim((9, 12), (0.1, 0.03)), scale=SCALE)
    u = torch.ones((2, 9, 12), dtype=torch.float64)
    assert op._sine_kernel_solve(u.to(torch.complex128), 0.1) is None
    assert op._sine_kernel_solve(u, 0.1 + 0.1j) is None
    assert op._sine_kernel_solve(u, torch.tensor(0.1 + 0.0j)) is None
    assert op._sine_kernel_solve(u, torch.full((9, 12), 0.1)) is None
    assert op._sine_kernel_solve(u, -0.1) is None
    assert op._sine_kernel_solve(u, np.array([0.1, 0.2]).reshape(2, 1, 1)) is None
    assert op._sine_kernel_solve(u[0], torch.full((2, 1, 1), 0.1)) is None  # widens the field: the chain's work
    assert op._sine_kernel_solve(u.clone().requires_grad_(), 0.1) is None
    assert op._sine_kernel_solve(u, torch.full((2, 1, 1), 0.1)) is not None
    for per_dim in (_per_dim((9,), (0.1,)), _per_dim((9, 12, 5), (0.1, 0.1, 0.1)),
                    _per_dim((9, 12), (0.1, 0.1), order=4),
                    [dict(size=8, dx=0.125, bc='periodic'), dict(size=9, dx=0.1, bc='dirichlet-zero')]):
        assert SeparableFDOperator(per_dim)._sine_2d is None
    # a scale that makes the operator positive definite leaves the modes' systems indefinite for positive shifts
    assert SeparableFDOperator(_per_dim((9, 12), (0.1, 0.03)), scale=-SCALE)._sine_2d is None


class _SweepPrecond:
    """The separable surrogate's solve by the sine kernels' algorithm (their plain version on the CPU)."""

    def __init__(self, op: SeparableFDOperator):
        self.op = op

    def solve_shifted(self, rhs, factor):
        return self.op._sine_kernel_solve(rhs, factor)


@pytest.mark.parametrize('n', [32, 64])
def test_var_diffusion_pcg_unchanged_by_the_sweep(n):
    """``VarCoeffDiffusion2D``'s PCG preconditioned by the sine kernels' algorithm takes the same trips on each
    system as through the numpy eigen solve, and the solutions agree within the PCG's tolerance."""
    prob = VarCoeffDiffusion2D(nvars=(n, n), coeff_fn=_coeff, dtype=torch.float64, solver='pcg', device='cpu')
    A = prob.A
    X, Y = prob.grids
    rng = np.random.default_rng(n + 1)
    rhs = torch.stack([torch.sin(np.pi * X) * torch.sin(np.pi * Y) + 0.3 * torch.cos(5 * np.pi * X) * Y,
                       torch.as_tensor(rng.standard_normal((n, n)))]).contiguous()
    tol = 1e-10
    runs = {}
    for name, precond in (('sweep', _SweepPrecond(A.precond)), ('eigh', _EighPrecond(A.precond))):
        A.precond, A.pcg_trace = precond, []
        for factor in (2.5e-4, 1e-3):
            runs.setdefault(name, []).append(A.solve_shifted(rhs, factor, tol=tol, batch_ndim=1))
        runs[name + '_trips'] = list(A.pcg_trace)
    assert runs['sweep_trips'] == runs['eigh_trips'] and min(runs['sweep_trips']) > 1
    for a, b in zip(runs['sweep'], runs['eigh']):
        for i in range(rhs.shape[0]):
            assert float((a[i] - b[i]).norm() / b[i].norm()) <= 10 * tol
