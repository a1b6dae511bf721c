"""The sparse lane's modules of the PyTorch port against the JAX package.

Inputs come from ``numpy.random.default_rng(seed)`` and go through the JAX
function and its counterpart in the port, float64 on the CPU.  Tolerances:

- host CSR algebra and the format conversions (``DIA.from_csr``,
  ``with_grid``, ``BSR.from_csr``): equal arrays (the same numpy code);
- SpMVs (``DIA.spmv``, K2's and K3's plain versions, ``apply_bsr``): 1e-13
  of the scale of the sum (sum of |coefficients| in a row times max|u|),
  against the JAX ``DIA.spmv`` and the Pallas kernels in interpret mode;
- every ``banded.py`` solver against its JAX twin: rtol 1e-12 above an
  absolute floor of 1e-12 * max|x|;
- ``SparseOperator.solve_shifted`` for each solver kind: 1e-11 * max|x|;
  PCG iteration counts: equal.

The CUDA kernels themselves run only on the card (``chip_smoke.py``); here
the wrappers take their plain versions because the tensors lie on the CPU.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysdc_tpu.models.heat import HeatND as JaxHeat
from pysdc_tpu.models.var_diffusion import VarCoeffDiffusion1D as JaxVC1, VarCoeffDiffusion2D as JaxVC2
from pysdc_tpu.ops import banded as jb
from pysdc_tpu.ops import sparse as js
from pysdc_tpu.ops import sparse_op as jso
from pysdc_tpu_torch.core.errors import ProblemError
from pysdc_tpu_torch.models.heat import HeatND as TorchHeat
from pysdc_tpu_torch.models.var_diffusion import VarCoeffDiffusion1D as TorchVC1, VarCoeffDiffusion2D as TorchVC2
from pysdc_tpu_torch.ops import banded as tb
from pysdc_tpu_torch.ops import sparse as ts
from pysdc_tpu_torch.ops import sparse_op as tso
from pysdc_tpu_torch.ops.kernels import bsr as tbsr
from pysdc_tpu_torch.ops.kernels import dia as tdia
from pysdc_tpu_torch.utils.convert import bsr_to_torch, dia_to_torch

def _smooth(X, Y):
    return 0.1 * (1.0 + 0.5 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y))


def _rough(X, Y):
    return 0.1 * (1.0 + 0.9 * np.sign(np.sin(6 * np.pi * X)) * np.cos(2 * np.pi * Y))


def _t(x):
    return torch.from_numpy(np.array(x))


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close_solve(got, want, rtol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(_n(got), want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


def _random_coo(rng, n, m, density):
    k = max(1, int(n * m * density))
    return rng.integers(0, n, k), rng.integers(0, m, k), rng.normal(size=k), (n, m)


def _both_csr(rng, n, m, density=0.1):
    args = _random_coo(rng, n, m, density)
    return js.CSR.from_coo(*args), ts.CSR.from_coo(*args)


def _same_csr(a, b):
    np.testing.assert_array_equal(a.data, b.data)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.indptr, b.indptr)
    assert tuple(a.shape) == tuple(b.shape)


# ----------------------------------------------------------------------
# host CSR algebra
# ----------------------------------------------------------------------
@pytest.mark.parametrize('op', ['from_coo', 'diags', 'kron', 'matmul', 'add_transpose', 'galerkin', 'galerkin_R'])
def test_csr_algebra_matches_jax(op):
    rng = np.random.default_rng(42)
    if op == 'from_coo':
        j, t = _both_csr(rng, 37, 23)
    elif op == 'diags':
        diags = [rng.normal(size=9), rng.normal(size=10), rng.normal(size=9), 0.5]
        j = js.CSR.diags(diags, [-1, 0, 1, 3], (10, 10))
        t = ts.CSR.diags(diags, [-1, 0, 1, 3], (10, 10))
    elif op == 'kron':
        (ja, ta), (jB, tB) = _both_csr(rng, 6, 5), _both_csr(rng, 4, 7)
        j, t = ja.kron(jB), ta.kron(tB)
    elif op == 'matmul':
        (ja, ta), (jB, tB) = _both_csr(rng, 40, 30), _both_csr(rng, 30, 50)
        j, t = ja @ jB, ta @ tB
    elif op == 'add_transpose':
        ja, ta = _both_csr(rng, 20, 20)
        j, t = (ja + ja.scale(-0.5)).T.prune(1e-3), (ta + ta.scale(-0.5)).T.prune(1e-3)
    else:
        (jA, tA), (jP, tP) = _both_csr(rng, 32, 32, 0.2), _both_csr(rng, 32, 8, 0.3)
        R = (None, None) if op == 'galerkin' else _both_csr(rng, 8, 32, 0.3)
        j, t = js.galerkin_product(jP, jA, R=R[0]), ts.galerkin_product(tP, tA, R=R[1])
    _same_csr(j, t)
    np.testing.assert_array_equal(j.row_of(), t.row_of())
    assert j.bandwidths() == t.bandwidths()
    for a, b in zip(j.to_banded(), t.to_banded()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(j.to_dense(), t.to_dense())


def _var_coeff_2d_matrix(mod, n, periodic=True, seed=3):
    """Variable-coefficient 2D 5-point matrix incl. wrap diagonals
    (tests/test_sparse.py:615-627), built with ``mod``'s CSR."""
    CSR = mod.CSR
    lap1 = CSR.diags([np.ones(n), -2.0 * np.ones(n), np.ones(n)], [-1, 0, 1], (n, n))
    if periodic:
        lap1 = CSR.from_dense(lap1.to_dense() + np.eye(n, k=n - 1) + np.eye(n, k=-(n - 1)))
    eye = CSR.eye(n)
    A2 = lap1.kron(eye) + eye.kron(lap1)
    scale = 1.0 + 0.5 * np.random.default_rng(seed).standard_normal(n * n)
    return CSR.diags([scale], [0], (n * n, n * n)).matmul(A2)


@pytest.mark.parametrize('periodic', [True, False])
@pytest.mark.parametrize('n', [16, 24])
def test_dia_and_bsr_conversion_match_jax(n, periodic):
    jA, tA = _var_coeff_2d_matrix(js, n, periodic), _var_coeff_2d_matrix(ts, n, periodic)
    _same_csr(jA, tA)
    jd, td = js.DIA.from_csr(jA), ts.DIA.from_csr(tA, device='cpu')
    np.testing.assert_array_equal(np.asarray(jd.data), td.data.numpy())
    assert jd.offsets == td.offsets and jd.shape == td.shape and jd.nnz == td.nnz
    jg, tg = jd.with_grid((n, n)), td.with_grid((n, n))
    assert jg.grid == tg.grid
    assert (tg.grid is not None) == (not periodic)  # periodic wraps cross grid rows
    jbs, tbs = js.BSR.from_csr(jA, 8, 8), ts.BSR.from_csr(tA, 8, 8, device='cpu')
    np.testing.assert_array_equal(np.asarray(jbs.blocks), tbs.blocks.numpy())
    np.testing.assert_array_equal(np.asarray(jbs.seg_starts), tbs.seg_starts.numpy())
    assert (jbs.br, jbs.bc, jbs.nnz) == (tbs.br, tbs.bc, tbs.nnz)


@pytest.mark.parametrize('batch', [(), (5,)], ids=str)
def test_ell_spmv_matches_jax(batch):
    """The gather SpMV that serves matrices without a DIA form."""
    rng = np.random.default_rng(17)
    jA, tA = _both_csr(rng, 64, 48)
    je, te = js.ELL.from_csr(jA), ts.ELL.from_csr(tA, device='cpu')
    np.testing.assert_array_equal(np.asarray(je.vals), te.vals.numpy())
    np.testing.assert_array_equal(np.asarray(je.cols), te.cols.numpy())
    u = rng.normal(size=batch + (48,))
    got = _n(te.spmv(_t(u)))
    np.testing.assert_allclose(got, np.asarray(je.spmv(jnp.asarray(u))), rtol=0, atol=1e-13 * _spmv_scale(tA, u))
    np.testing.assert_allclose(got, u @ tA.to_dense().T, rtol=0, atol=1e-13 * _spmv_scale(tA, u))


def test_dia_rejects_unstructured_and_bsr_checks_segments():
    rng = np.random.default_rng(3)
    A = ts.CSR.from_coo(rng.integers(0, 64, 200), rng.integers(0, 64, 200), rng.normal(size=200), (64, 64))
    assert ts.DIA.from_csr(A, max_diags=24, device='cpu') is None
    with pytest.raises(ProblemError, match='segments'):
        ts.BSR(np.zeros((2, 1, 4, 4)), [[0], [6]], (8, 8), 4, 4, device='cpu')


# ----------------------------------------------------------------------
# K2's plain version (DIA.spmv) and the wrapper against the JAX package
# ----------------------------------------------------------------------
def _spmv_scale(A, u):
    return np.abs(A.to_dense()).sum(axis=1).max() * np.abs(u).max()


@pytest.mark.parametrize('form', ['flat', 'grid'])
@pytest.mark.parametrize('periodic', [True, False])
@pytest.mark.parametrize('n', [16, 24])
def test_dia_spmv_matches_jax(n, periodic, form):
    from pysdc_tpu.ops.pallas.dia import dia_spmv as jax_dia_spmv

    jA, tA = _var_coeff_2d_matrix(js, n, periodic), _var_coeff_2d_matrix(ts, n, periodic)
    jd, td = js.DIA.from_csr(jA), ts.DIA.from_csr(tA, device='cpu')
    if form == 'grid':
        jd, td = jd.with_grid((n, n)), td.with_grid((n, n))
    u = np.random.default_rng(n).standard_normal((3, n * n))
    atol = 1e-13 * _spmv_scale(tA, u)
    got = _n(td.spmv(_t(u)))
    np.testing.assert_allclose(got, u @ tA.to_dense().T, rtol=0, atol=atol)
    np.testing.assert_allclose(got, np.asarray(jd.spmv(jnp.asarray(u))), rtol=0, atol=atol)
    np.testing.assert_allclose(_n(tdia.dia_spmv(td, _t(u))), got, rtol=0, atol=atol)
    # the JAX package's DIA, carried across, applies the same matrix
    carried = dia_to_torch(np.asarray(jd.data), jd.offsets, jd.shape, grid=jd.grid, device='cpu')
    np.testing.assert_allclose(_n(carried.spmv(_t(u))), got, rtol=0, atol=atol)
    if form == 'flat':
        for version in (1, 2):
            want = np.asarray(jax_dia_spmv(jd, jnp.asarray(u), Tr=8, interpret=True, version=version))
            np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize('shape', [(4099,), (4, 4099), (3, 5, 4099)], ids=str)
def test_dia_spmv_1d_periodic_odd_n_and_batch_shapes(shape):
    """The 1D periodic matrix at an odd n: wrap diagonals at +-(n-1)."""
    n = shape[-1]
    a = 1.0 + 0.5 * np.sin(2 * np.pi * np.arange(n + 1) / n)
    A = tso.variable_diffusion_matrix(a, 1.0 / n, bc='periodic')
    d = ts.DIA.from_csr(A, device='cpu')
    assert d.offsets == (-(n - 1), -1, 0, 1, n - 1)
    u = np.random.default_rng(1).standard_normal(shape)
    got = _n(tdia.dia_spmv(d, _t(u)))
    np.testing.assert_allclose(got, u @ A.to_dense().T, rtol=0, atol=1e-13 * _spmv_scale(A, u))


def test_dia_float32_state_stays_float32():
    A = _var_coeff_2d_matrix(ts, 16)
    d = ts.DIA.from_csr(A, device='cpu')
    u = torch.from_numpy(np.random.default_rng(0).standard_normal(256).astype(np.float32))
    y = tdia.dia_spmv(d, u)
    assert y.dtype == torch.float32 and d.data.dtype == torch.float64
    assert d.data_for(u) is d.data_for(u)  # the cast is made once and kept


# ----------------------------------------------------------------------
# K3's plain version (BSR.spmv) and apply_bsr against the Pallas kernel
# ----------------------------------------------------------------------
@pytest.mark.parametrize('n, br, B', [(128, 8, 5), (256, 128, 4), (64, 8, 1)])
def test_bsr_spmm_matches_jax(n, br, B):
    from pysdc_tpu.ops.pallas.spmv import bsr_spmm as jax_bsr_spmm

    rng = np.random.default_rng(n + br)
    args = _random_coo(rng, n, n, 0.1)
    jA, tA = js.CSR.from_coo(*args), ts.CSR.from_coo(*args)
    jbs, tbs = js.BSR.from_csr(jA, br, br), ts.BSR.from_csr(tA, br, br, device='cpu')
    u = rng.normal(size=(n, B))
    atol = 1e-13 * _spmv_scale(tA, u)
    got = _n(tbsr.bsr_spmm(tbs, _t(u)))
    np.testing.assert_allclose(got, tA.to_dense() @ u, rtol=0, atol=atol)
    np.testing.assert_allclose(got, np.asarray(jax_bsr_spmm(jbs, jnp.asarray(u), interpret=True)), rtol=0, atol=atol)
    np.testing.assert_allclose(_n(tbs.spmv(_t(u[:, 0]))), np.asarray(jbs.spmv(jnp.asarray(u[:, 0]))),
                               rtol=0, atol=atol)
    carried = bsr_to_torch(np.asarray(jbs.blocks), np.asarray(jbs.seg_starts), jbs.shape, jbs.br, jbs.bc,
                           device='cpu')
    np.testing.assert_allclose(_n(carried.spmv(_t(u))), got, rtol=0, atol=atol)


def test_apply_bsr_auto_blocking_matches_jax():
    """apply_bsr picks the largest of 256/128 dividing n and matches the
    JAX apply_bsr (Pallas interpret) and the DIA apply."""
    jp = JaxVC2(nvars=(16, 16), coeff_fn=_smooth, dtype=jnp.float64)
    tp = TorchVC2(nvars=(16, 16), coeff_fn=_smooth, dtype=torch.float64, device='cpu')
    u = np.random.default_rng(5).standard_normal((256, 3))
    got = _n(tp.A.apply_bsr(_t(u)))
    assert tp.A._bsr.br == 256
    atol = 1e-13 * _spmv_scale(tp.A.A, u)
    np.testing.assert_allclose(got, np.asarray(jp.A.apply_bsr(jnp.asarray(u), interpret=True)), rtol=0, atol=atol)
    via_dia = np.stack([_n(tp.A.apply(_t(u[:, b].reshape(16, 16)))).ravel() for b in range(3)], axis=1)
    np.testing.assert_allclose(got, via_dia, rtol=0, atol=atol)
    np.testing.assert_allclose(_n(tp.A.apply_bsr(_t(u[:, 0]))), got[:, 0], rtol=0, atol=atol)


# ----------------------------------------------------------------------
# wrappers: CPU tensors take the plain version, other devices raise
# ----------------------------------------------------------------------
def test_cpu_path_launches_nothing_and_other_devices_raise():
    A = _var_coeff_2d_matrix(ts, 8)
    d, b = ts.DIA.from_csr(A, device='cpu'), ts.BSR.from_csr(A, 8, 8, device='cpu')
    before = (tdia.dia_spmv.launches, tbsr.bsr_spmm.launches)
    tdia.dia_spmv(d, torch.ones(64, dtype=torch.float64))
    tbsr.bsr_spmm(b, torch.ones(64, 2, dtype=torch.float64))
    assert (tdia.dia_spmv.launches, tbsr.bsr_spmm.launches) == before
    with pytest.raises(ValueError):
        tdia.dia_spmv(d, torch.ones(64, device='meta'))
    with pytest.raises(ValueError):
        tbsr.bsr_spmm(b, torch.ones(64, 2, device='meta'))


def test_kernel_modules_import_without_a_card():
    """Importing the wrappers compiles nothing and needs no nvcc; the build
    registry names all three kernel sources."""
    code = (
        'import pysdc_tpu_torch.ops.kernels.dia as d, pysdc_tpu_torch.ops.kernels.bsr as s\n'
        'import pysdc_tpu_torch.ops.kernels.build as b\n'
        'assert not b._loaded and d._library.cache_info().currsize == 0 and s._library.cache_info().currsize == 0\n'
        'print(sorted(b.SOURCES))\n'
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['bsr_spmm', 'cross_stencil', 'dia_spmv']"


# ----------------------------------------------------------------------
# structured factorizations
# ----------------------------------------------------------------------
def test_tridiag_solvers_match_jax():
    rng = np.random.default_rng(7)
    for n in (3, 8, 17, 64):
        lo, up, dg = rng.normal(size=n) * 0.3, rng.normal(size=n) * 0.3, 2.0 + rng.random(n)
        rhs = rng.normal(size=(2, n))
        for fn in ('tridiag_pcr_solve', 'tridiag_solve'):
            want = jax.jit(getattr(jb, fn))(*(jnp.asarray(a) for a in (lo, dg, up, rhs)))
            _close_solve(getattr(tb, fn)(*(_t(a) for a in (lo, dg, up, rhs))), want)
    n = 32
    lo, dg, up = -rng.random(n), 3.0 + rng.random(n), -rng.random(n)
    for rhs in (rng.normal(size=n), rng.normal(size=(3, n))):
        want = jax.jit(jb.cyclic_tridiag_solve)(jnp.asarray(lo), jnp.asarray(dg), jnp.asarray(up), -0.7, -0.3,
                                                jnp.asarray(rhs))
        _close_solve(tb.cyclic_tridiag_solve(_t(lo), _t(dg), _t(up), -0.7, -0.3, _t(rhs)), want)


def test_banded_solvers_match_jax():
    rng = np.random.default_rng(8)
    n = 40
    diags = [np.full(n, 0.2), -1 - rng.random(n), 4 + rng.random(n), -1 - rng.random(n), np.full(n, 0.3),
             np.full(n, -0.1)]
    A = js.CSR.diags(diags, [-2, -1, 0, 1, 2, 3], (n, n))
    bands, _ = A.to_banded()
    lb, ub = A.bandwidths()
    rhs = rng.normal(size=(2, n))
    jfac = jb.banded_factor(jnp.asarray(bands), lb, ub)
    tfac = tb.banded_factor(_t(bands), lb, ub)
    _close_solve(tfac, jfac)
    _close_solve(tb.banded_solve(tfac, lb, ub, _t(rhs)), jb.banded_solve(jfac, lb, ub, jnp.asarray(rhs)))
    want = jb.banded_shifted_solve(bands, lb, ub, jnp.asarray(rhs), 0.25)
    _close_solve(tb.banded_shifted_solve(bands, lb, ub, _t(rhs), 0.25), want)
    x = _n(tb.banded_shifted_solve(bands, lb, ub, _t(rhs[0]), 0.25))
    np.testing.assert_allclose((np.eye(n) - 0.25 * A.to_dense()) @ x, rhs[0], atol=1e-12)


def _block_system(rng, nb, b):
    sub = rng.normal(size=(nb, b, b)) * 0.1
    sup = rng.normal(size=(nb, b, b)) * 0.1
    dg = rng.normal(size=(nb, b, b)) * 0.2 + 3 * np.eye(b)[None]
    return sub, dg, sup


@pytest.mark.parametrize('nb, b', [(2, 3), (5, 2), (16, 4), (33, 4)])
def test_block_cr_matches_jax(nb, b):
    rng = np.random.default_rng(nb * b)
    sub, dg, sup = _block_system(rng, nb, b)
    rhs = rng.normal(size=(2, nb, b))
    jfac = jb.block_cr_factor(jnp.asarray(sub), jnp.asarray(dg), jnp.asarray(sup))
    tfac = tb.block_cr_factor(_t(sub), _t(dg), _t(sup))
    _close_solve(tfac['top_inv'], jfac['top_inv'])
    for jl, tl in zip(jfac['levels'], tfac['levels'], strict=True):
        for key in jl:
            _close_solve(tl[key], jl[key])
    _close_solve(tb.block_cr_solve(tfac, _t(rhs)), jb.block_cr_solve(jfac, jnp.asarray(rhs)))
    jsf = jb.block_cr_shifted_factor(sub, dg, sup, 0.05)
    tsf = tb.block_cr_shifted_factor(sub, dg, sup, 0.05, device='cpu')
    _close_solve(tb.block_cr_solve(tsf, _t(rhs)), jb.block_cr_solve(jsf, jnp.asarray(rhs)))


def test_block_tridiag_solvers_match_jax():
    m = 8
    jT = js.CSR.diags([np.ones(m), -4 * np.ones(m), np.ones(m)], [-1, 0, 1], (m, m))
    jS = js.CSR.diags([np.ones(m), np.zeros(m), np.ones(m)], [-1, 0, 1], (m, m))
    jA = jT.kron(js.CSR.eye(m)) + js.CSR.eye(m).kron(jS)
    tT = ts.CSR.diags([np.ones(m), -4 * np.ones(m), np.ones(m)], [-1, 0, 1], (m, m))
    tS = ts.CSR.diags([np.ones(m), np.zeros(m), np.ones(m)], [-1, 0, 1], (m, m))
    tA = tT.kron(ts.CSR.eye(m)) + ts.CSR.eye(m).kron(tS)
    jbands, tbands = jb.block_tridiag_from_csr(jA, m), tb.block_tridiag_from_csr(tA, m)
    for a, b in zip(jbands, tbands):
        np.testing.assert_array_equal(a, b)
    rhs = np.random.default_rng(9).normal(size=(2, m * m))
    want = jb.block_tridiag_shifted_solve(*jbands, jnp.asarray(rhs), 0.05)
    _close_solve(tb.block_tridiag_shifted_solve(*tbands, _t(rhs), 0.05), want)
    sub, dg, sup = (_t(x) for x in tbands)
    _close_solve(tb.block_tridiag_solve(sub, dg, sup, _t(rhs)),
                 jb.block_tridiag_solve(*(jnp.asarray(x) for x in jbands), jnp.asarray(rhs)))
    with pytest.raises(ProblemError):
        tb.block_tridiag_from_csr(tA, 3)


# ----------------------------------------------------------------------
# SparseOperator: every solver kind, PCG counts, prepared node factors
# ----------------------------------------------------------------------
def _operators(kind):
    """(JAX operator, port operator, grid shape) for each solver kind."""
    if kind == 'tridiag':
        a = lambda x: 1.0 + 0.8 * np.sin(2 * np.pi * x)  # noqa: E731
        return JaxVC1(nvars=40, coeff_fn=a).A, TorchVC1(nvars=40, coeff_fn=a, device='cpu').A, (40,)
    if kind == 'cyclic_tridiag':
        a = lambda x: 1.0 + 0.8 * np.sin(2 * np.pi * x)  # noqa: E731
        return (JaxVC1(nvars=40, coeff_fn=a, bc='periodic').A,
                TorchVC1(nvars=40, coeff_fn=a, bc='periodic', device='cpu').A, (40,))
    if kind == 'banded':
        params = dict(nvars=63, nu=0.1, freq=2, bc='dirichlet-zero', backend='sparse')
        return JaxHeat(**params).A, TorchHeat(**params, device='cpu').A, (63,)
    if kind in ('block_tridiag', 'pcg'):
        solver = 'auto' if kind == 'pcg' else kind
        return (JaxVC2(nvars=(16, 16), coeff_fn=_smooth, solver=solver).A,
                TorchVC2(nvars=(16, 16), coeff_fn=_smooth, solver=solver, device='cpu').A, (16, 16))
    # cg: a 2D Dirichlet FD matrix with no preconditioner and no block fallback
    per_dim = [dict(size=12, dx=1 / 13, derivative=2, order=2, bc='dirichlet-zero')] * 2
    return (jso.SparseFDOperator(per_dim, scale=0.1, solver='cg'),
            tso.SparseFDOperator(per_dim, scale=0.1, solver='cg', device='cpu'), (12, 12))


@pytest.mark.parametrize('kind', ['tridiag', 'cyclic_tridiag', 'banded', 'block_tridiag', 'pcg', 'cg'])
def test_solve_shifted_each_solver_kind_matches_jax(kind):
    jop, top, shape = _operators(kind)
    assert jop.solver_kind == top.solver_kind == kind
    rng = np.random.default_rng(11)
    rhs = rng.standard_normal((2,) + shape)
    x0 = rng.standard_normal(shape)
    jax_solve = jax.jit(lambda r, f, x0: jop.solve_shifted(r, f, x0=x0))
    for factor in (2e-3, 0.05):
        want = jax_solve(jnp.asarray(rhs), factor, None)
        _close_solve(top.solve_shifted(_t(rhs), factor), want, rtol=1e-11)
    want = jax_solve(jnp.asarray(rhs[0]), 0.01, jnp.asarray(x0))
    _close_solve(top.solve_shifted(_t(rhs[0]), 0.01, x0=_t(x0)), want, rtol=1e-11)
    _close_solve(top.apply(_t(rhs)), jop.apply(jnp.asarray(rhs)), rtol=1e-13)


@pytest.mark.parametrize('case', ['smooth', 'rough', 'heat-exact-precond', 'batched'])
def test_pcg_iteration_counts_match_jax(case):
    """solve_shifted_info: the same Krylov depth as the JAX package
    (tests/test_sparse.py:565-609); a batched RHS shares one Krylov space."""
    rhs = np.random.default_rng(42).normal(size=(32, 32))
    if case == 'heat-exact-precond':
        params = dict(nvars=(32, 32), nu=0.1, freq=2, bc='periodic', backend='sparse')
        jop, top, factor = JaxHeat(**params).A, TorchHeat(**params, device='cpu').A, 5e-4
    else:
        coeff = _rough if case == 'rough' else _smooth
        jop = JaxVC2(nvars=(32, 32), coeff_fn=coeff).A
        top = TorchVC2(nvars=(32, 32), coeff_fn=coeff, device='cpu').A
        factor = 1e-3
    if case == 'batched':
        rhs = np.stack([rhs, np.random.default_rng(43).normal(size=(32, 32))])
    assert top.solver_kind == 'pcg'
    xj, kj = jop.solve_shifted_info(jnp.asarray(rhs), factor)
    top.pcg_trace = []
    xt, kt = top.solve_shifted_info(_t(rhs), factor)
    assert kt == int(kj) and top.pcg_trace == [kt] and top.pcg_iterations == kt
    assert 0 < kt <= (2 if case == 'heat-exact-precond' else 80)
    _close_solve(xt, xj, rtol=1e-11)


def test_sparse_heat_matches_eigen_backend():
    """The sparse backend's apply and solves equal the eigen backend's."""
    for params in (dict(nvars=(32, 32), bc='periodic'), dict(nvars=64, bc='periodic'),
                   dict(nvars=63, bc='dirichlet-zero')):
        sp = TorchHeat(**params, nu=0.1, backend='sparse', device='cpu')
        ei = TorchHeat(**params, nu=0.1, device='cpu')
        u = _t(np.random.default_rng(2).standard_normal(sp.shape))
        np.testing.assert_allclose(_n(sp.eval_f(u, 0.0)), _n(ei.eval_f(u, 0.0)), rtol=0, atol=1e-9)
        np.testing.assert_allclose(_n(sp.solve_system(u, 5e-3, u, 0.0)), _n(ei.solve_system(u, 5e-3, u, 0.0)),
                                   rtol=0, atol=1e-10)


def test_prepared_node_factors_match_unprepared_path():
    """Node factors prepared at level setup reproduce the per-call
    factorization in a real sweep (tests/test_sparse.py:421-444)."""
    from pysdc_tpu_torch import GenericImplicit
    from pysdc_tpu_torch.core.level import Level

    n = 24
    prob = TorchVC2(nvars=(n, n), coeff_fn=_smooth, solver='block_tridiag', device='cpu')
    sweep = GenericImplicit({'num_nodes': 3, 'quad_type': 'RADAU-RIGHT', 'QI': 'LU'})
    Level(prob, sweep, {'dt': 1e-3, 'restol': 1e-12})
    assert prob.accepts_node_index and prob.A.solver_kind == 'block_tridiag'
    X, Y = prob.grids
    state = sweep.predict(prob, torch.sin(np.pi * X) * torch.sin(np.pi * Y), 0.0, 1e-3)
    before = prob.A.spmv_count
    s_prep = sweep.update_nodes(prob, state, 0.0, 1e-3, 0)
    # per node: one solve (one refinement residual) and one eval_f
    assert prob.A.spmv_count - before == 2 * 3
    prob.accepts_node_index = False
    s_plain = sweep.update_nodes(prob, state, 0.0, 1e-3, 0)
    assert float((s_prep.u - s_plain.u).abs().max()) < 1e-13


def test_prepared_factors_refine_on_shift_drift():
    """Prepared at one dt, solved at another: the refinement loop turns the
    stale factorization into a preconditioner (tests/test_sparse.py:447-460)."""
    n = 16
    coeff = lambda X, Y: 0.2 + 0.1 * X * Y  # noqa: E731
    prob = TorchVC2(nvars=(n, n), coeff_fn=coeff, device='cpu', solver='block_tridiag')
    jprob = JaxVC2(nvars=(n, n), coeff_fn=coeff, solver='block_tridiag')
    assert prob.A.prepare_node_shifts([1e-3]) and jprob.A.prepare_node_shifts([1e-3])
    rhs = np.random.default_rng(4).normal(size=(n, n))
    x = prob.A.solve_shifted(_t(rhs), 2.5e-3, node=0)
    res = rhs - (_n(x) - 2.5e-3 * _n(prob.A.apply(x)))
    assert np.abs(res).max() < 1e-10
    _close_solve(x, jprob.A.solve_shifted(jnp.asarray(rhs), jnp.asarray(2.5e-3), node=0), rtol=1e-11)
    # an operator without a prepared path says so
    assert not TorchVC2(nvars=(n, n), coeff_fn=coeff, device='cpu').A.prepare_node_shifts([1e-3])


def test_pallas_dia_toggle_and_counts():
    prob = TorchVC2(nvars=(16, 16), coeff_fn=_smooth, dtype=torch.float32, device='cpu')
    u = _t(np.random.default_rng(3).standard_normal((3, 16, 16)).astype(np.float32))
    want = _n(prob.A.apply(u))
    prob.A.disable_pallas_dia()
    got = _n(prob.A.apply(u))
    prob.A.enable_pallas_dia()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    assert prob.A.spmv_count == 2
    with pytest.raises(ProblemError, match='square'):
        tso.SparseOperator(ts.CSR.from_coo([0], [0], [1.0], (3, 4)), device='cpu')
    rng = np.random.default_rng(3)
    unstructured = ts.CSR.from_coo(rng.integers(0, 30, 200), rng.integers(0, 30, 200), rng.normal(size=200), (30, 30))
    with pytest.raises(ProblemError, match='DIA'):
        tso.SparseOperator(unstructured, solver='cg', device='cpu').enable_pallas_dia()


# ----------------------------------------------------------------------
# K3: the wrapper's choice of kernel and the stream path's work-item walk
# (pure functions, no card needed)
# ----------------------------------------------------------------------
@pytest.mark.parametrize('dims, B, itemsize, aligned, want', [
    ((256, 3, 256, 256), 4, 4, True, 'stream'),     # the design point
    ((256, 3, 256, 256), 4, 8, True, 'stream'),
    ((256, 3, 256, 256), 9, 4, True, 'stream'),
    ((16, 16, 8, 8), 5, 4, True, 'stream'),
    ((8, 1, 64, 64), 4, 4, True, 'stream'),         # kb = 1
    ((6, 2, 40, 64), 4, 4, True, 'stream'),         # a br that a slab's rows do not divide
    ((5, 2, 12, 6), 3, 8, True, 'stream'),          # 6 float64 are 48 bytes
    ((5, 2, 12, 6), 3, 4, True, 'general'),         # 6 float32 are 24 bytes: no multiple of 16
    ((5, 2, 12, 7), 3, 8, True, 'general'),
    ((256, 3, 256, 256), 4, 4, False, 'general'),   # a misaligned base
    ((4, 3, 256, 512), 4, 4, True, 'stream'),       # 64 KB slabs: three fit
    ((4, 3, 256, 1024), 4, 4, True, 'general'),     # 128 KB slabs: fewer than two fit
    ((4, 3, 256, 512), 4, 8, True, 'stream'),
    ((4, 40, 256, 256), 8, 4, True, 'general'),     # the staged segments leave no room for two slabs
], ids=str)
def test_bsr_choose_path(dims, B, itemsize, aligned, want):
    assert tbsr.choose_path(dims, B, itemsize, aligned) == want
    geometry = tbsr.stream_geometry(dims, B, itemsize)
    if want == 'stream':
        stages, grid_x, smem = geometry
        assert 2 <= stages <= tbsr.STREAM_MAX_STAGES and smem <= tbsr.SMEM_OPT_IN
        assert 1 <= grid_x <= min(tbsr.SM_COUNT, dims[0] * -(-dims[2] // tbsr.stream_rows(itemsize)))


def test_bsr_stream_geometry_at_the_design_point():
    stages, grid_x, smem = tbsr.stream_geometry((256, 3, 256, 256), 4, 4)
    # 4 slabs of 32 rows x 256 float32 (32 KB each), 4 batch rows of 3 x 256 values + 16 bytes, the header
    assert (stages, grid_x, smem) == (4, 132, 128 + 4 * 32768 + 4 * (3 * 256 * 4 + 16))
    assert tbsr.stream_geometry((256, 3, 256, 256), 4, 8)[0] == 4 and tbsr.stream_rows(8) == 16
    assert tbsr.stream_geometry((2, 1, 8, 8), 1, 4)[1] == 2  # never more thread blocks than work items


@pytest.mark.parametrize('B, want', [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (8, 8), (9, 8), (17, 8)])
def test_bsr_batch_tile(B, want):
    assert tbsr.batch_tile(B) == want


@pytest.mark.parametrize('dims, B, itemsize, grid_x', [
    ((4, 3, 64, 32), 4, 4, 5),      # several items a thread block, block rows shared between neighbours
    ((6, 2, 40, 64), 9, 4, 132),    # br that 32 rows do not divide; B chunked over 8 (8 + 1)
    ((6, 2, 40, 64), 5, 8, 7),      # float64: 16-row slabs, B = 5 in a tile of 8
    ((8, 1, 64, 64), 1, 4, 1),      # kb = 1, one persistent thread block
    ((3, 2, 8, 8), 2, 4, 3),        # br smaller than a slab
    ((5, 2, 12, 6), 3, 8, 4),
    ((16, 3, 256, 32), 8, 4, 132),
], ids=str)
def test_bsr_stream_walk_matches_einsum(dims, B, itemsize, grid_x):
    """The stream kernel's walk in numpy, with the wrapper's constants: each
    thread block takes its contiguous range of (block row, row group) items;
    an item is the sum over its kb slabs of slab @ staged segment, batch
    columns in chunks of ``CHUNK`` padded with zeros to ``batch_tile(B)``."""
    nb, kb, br, bc = dims
    rng = np.random.default_rng(sum(dims) + B)
    blocks = rng.standard_normal(dims)
    ncols = max(nb * br, 4 * bc)
    seg = rng.integers(0, ncols - bc + 1, size=(nb, kb))
    U = rng.standard_normal((ncols, B))
    geometry = tbsr.stream_geometry(dims, B, itemsize)
    grid_x = min(grid_x, geometry[1]) if grid_x == 132 else grid_x
    walk = tbsr.stream_items(dims, itemsize, grid_x)
    rows_per_slab = tbsr.stream_rows(itemsize)
    bt = tbsr.batch_tile(B)
    Y = np.full((nb * br, B), np.nan)
    chunks = range(0, B, tbsr.CHUNK)  # grid.y: each chunk of batch columns streams the blocks once
    written = np.zeros(nb * br, dtype=int)
    assert len(walk) == grid_x
    for b0 in chunks:
        cols = min(bt, B - b0)
        for mine in walk:
            staged_row, useg = -1, None
            for i, r0, rows in mine:
                assert 0 < rows <= rows_per_slab and r0 % rows_per_slab == 0 and r0 + rows <= br
                if i != staged_row:  # a new block row: stage its segments, transposed, zero-padded to the tile
                    useg = np.zeros((bt, kb * bc))
                    for j in range(kb):
                        useg[:cols, j * bc:(j + 1) * bc] = U[seg[i, j]:seg[i, j] + bc, b0:b0 + cols].T
                    staged_row = i
                acc = np.zeros((rows, bt))
                for j in range(kb):
                    slab = blocks[i, j, r0:r0 + rows]  # rows * bc contiguous values: one bulk copy
                    assert (rows * bc * itemsize) % tbsr.STREAM_COPY_BYTES == 0
                    acc += slab @ useg[:, j * bc:(j + 1) * bc].T
                Y[i * br + r0:i * br + r0 + rows, b0:b0 + cols] = acc[:, :cols]
                written[i * br + r0:i * br + r0 + rows] += 1
    assert (written == len(chunks)).all()  # every row of Y by exactly one item of each chunk
    sizes = [len(mine) for mine in walk]
    assert max(sizes) - min(sizes) <= 1 and sum(sizes) == nb * -(-br // rows_per_slab)
    idx = seg[..., None] + np.arange(bc)
    want = np.einsum('nkrc,nkcb->nrb', blocks, U[idx]).reshape(nb * br, B)
    np.testing.assert_allclose(Y, want, rtol=0, atol=1e-12 * np.abs(blocks).sum(axis=(1, 3)).max() * np.abs(U).max())
    # the port's plain version on the same matrix
    bsr = ts.BSR(blocks, seg, (nb * br, ncols), br, bc, device='cpu')
    np.testing.assert_allclose(_n(tbsr.bsr_spmm(bsr, _t(U), path='general')), want, rtol=0, atol=1e-12 * np.abs(want).max())
    assert tbsr.bsr_spmm.paths == {'stream': 0, 'general': 0}  # a CPU tensor launches nothing


# ----------------------------------------------------------------------
# operators and containers live on the card unless asked for the CPU
# ----------------------------------------------------------------------
def _default_device_cases():
    A = _var_coeff_2d_matrix(ts, 8)
    per_dim = [dict(size=8, dx=1 / 9, derivative=2, order=2, bc='dirichlet-zero')] * 2
    sub, dg, sup = _block_system(np.random.default_rng(0), 4, 2)
    dia = ts.DIA.from_csr(A, device='cpu')
    bsr = ts.BSR.from_csr(A, 8, 8, device='cpu')
    return {
        'SparseOperator': lambda **kw: tso.SparseOperator(A, grid_shape=(8, 8), **kw).device,
        'SparseFDOperator': lambda **kw: tso.SparseFDOperator(per_dim, scale=0.1, **kw).device,
        'ELL.from_csr': lambda **kw: ts.ELL.from_csr(A, **kw).vals.device,
        'DIA.from_csr': lambda **kw: ts.DIA.from_csr(A, **kw).data.device,
        'BSR.from_csr': lambda **kw: ts.BSR.from_csr(A, 8, 8, **kw).blocks.device,
        'ELL': lambda **kw: ts.ELL(np.ones((4, 1)), np.zeros((4, 1), dtype=np.int64), (4, 4), **kw).vals.device,
        'DIA': lambda **kw: ts.DIA(np.ones((1, 4)), [0], (4, 4), **kw).data.device,
        'BSR': lambda **kw: ts.BSR(np.ones((2, 1, 2, 2)), [[0], [2]], (4, 4), 2, 2, **kw).blocks.device,
        'block_cr_shifted_factor': lambda **kw: tb.block_cr_shifted_factor(sub, dg, sup, 0.05, **kw)['top_inv'].device,
        'dia_to_torch': lambda **kw: dia_to_torch(dia.data.numpy(), dia.offsets, dia.shape, **kw).data.device,
        'bsr_to_torch': lambda **kw: bsr_to_torch(bsr.blocks.numpy(), bsr.seg_starts.numpy(), bsr.shape, 8, 8,
                                                  **kw).blocks.device,
    }


@pytest.mark.parametrize('name', ['SparseOperator', 'SparseFDOperator', 'ELL.from_csr', 'DIA.from_csr', 'BSR.from_csr',
                                  'ELL', 'DIA', 'BSR', 'block_cr_shifted_factor', 'dia_to_torch', 'bsr_to_torch'])
def test_default_device_is_the_card(name):
    """Without ``device=`` the object lives on the card, and without a card
    that raises ``resolve_device``'s message; ``device='cpu'`` is as before."""
    make = _default_device_cases()[name]
    assert make(device='cpu').type == 'cpu'
    if torch.cuda.is_available():
        assert make().type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match="needs a CUDA card.*pass device='cpu'"):
            make()
