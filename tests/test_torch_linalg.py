"""The capturable dense solves of ``pysdc_tpu_torch/ops/linalg.py`` against ``torch.linalg.solve`` (CPU, float64 and
complex128).

On the card :func:`~pysdc_tpu_torch.ops.linalg.solve` takes two routes that torch does not choose by itself: a batch
padded so that torch's cuSOLVER preference lands on cuBLAS's batched LU and substitution (``_batched_solve``), and
from 512 rows on LAPACK's blocked right-looking LU with partial pivoting over the whole matrix (``_pivoted_solve``),
whose blocks two hand-written kernels factor on the card (the panel, then its row interchanges and ``U12``).  Both
are torch code around those kernels; on the CPU the kernels are their plain versions (LAPACK's ``getrf`` of the
panel; a gather and ``solve_triangular``), so the routes are held here: broadcast
batches, one matrix, one and two systems, several right-hand sides, and the large systems the port solves, several
of which need pivoting across the whole matrix (Rayleigh-Benard's modes, the Chebyshev heat and Burgers operators, a
matrix whose leading half is zero).  Each is gated at 1e-13 relative, or at 4 eps cond(A) where the matrix's
condition number makes two backward-stable solves differ by more.  The plain row interchanges and ``U12`` are held
against an explicit permutation product and ``torch.linalg.solve_triangular``.
"""

import numpy as np
import pytest
import torch

from pysdc_tpu_torch.models.heat import HeatND
from pysdc_tpu_torch.models.rayleigh_benard import RayleighBenard
from pysdc_tpu_torch.models.spectral_problems import Burgers1D, Heat2DChebyshev, HeatChebyshev1D
from pysdc_tpu_torch.ops import linalg
from pysdc_tpu_torch.ops.kernels import dense_lu

torch.set_num_threads(1)

RTOL = 1e-13


def _rel(got, want):
    assert got.shape == want.shape
    return float((got - want).abs().max() / want.abs().max())


def _random(rng, shape, complex_=True):
    x = rng.standard_normal(shape) + (1j * rng.standard_normal(shape) if complex_ else 0)
    return torch.as_tensor(x)


@pytest.mark.parametrize('shape_a, shape_b', [((2, 32, 32), (2, 32, 1)), ((1, 32, 32), (2, 1, 32, 1)),
                                              ((32, 32), (32, 1)), ((5, 16, 16), (5, 16, 3)),
                                              ((64, 8, 8), (4, 64, 8, 1)), ((2, 2), (3, 2, 1))])
def test_batched_route_equals_lapack(shape_a, shape_b):
    rng = np.random.default_rng(sum(shape_a))
    A = _random(rng, shape_a) + 4 * shape_a[-1] * torch.eye(shape_a[-1])
    B = _random(rng, shape_b)
    assert _rel(linalg._batched_solve(A, B), torch.linalg.solve(A, B)) < RTOL


def _linearized_lhs():
    """``I - dt D_m J`` of a linearized sweep on HeatND 32^2 (3 nodes x 4 steps), and a right-hand side."""
    prob = HeatND(nvars=(32, 32), nu=0.1, freq=2, bc='periodic', dtype=torch.float64, device='cpu')
    basis = torch.eye(1024, dtype=torch.float64).reshape(1024, 32, 32)
    J = prob.A.apply(basis).reshape(1024, 1024).T.to(torch.complex128)
    D = torch.tensor([0.2 + 0.1j, 0.3 - 0.2j, 0.5 + 0j], dtype=torch.complex128).reshape(3, 1, 1, 1)
    lhs = torch.eye(1024, dtype=torch.complex128) - 0.01 * D * J.expand(3, 4, 1024, 1024)
    return lhs, _random(np.random.default_rng(3), (3, 4, 1024, 1))


def _spectral_operator(problem, factor, rhs_batch=(2,)):
    """``problem``'s shifted spectral operator ``(M + factor L)`` with its tau rows, as ``solve_shifted`` builds it
    (one coupled block a Fourier mode), and a right-hand side."""
    spec = problem.spec
    like = torch.zeros((1,), dtype=torch.complex128)
    keep = torch.as_tensor(spec.keep_mask)
    A = (spec._dev('M_all', like) + factor * spec._dev('L_all', like)) * keep[:, :, None] + spec._dev('bc_rows', like)
    return A, _random(np.random.default_rng(4), rhs_batch + tuple(A.shape[:-1]) + (1,))


def _zero_leading_block():
    """``[[0, I + N1], [I + N2, N3]]`` of 512 rows, each ``N`` 0.1 x a Gaussian: its leading half is exactly zero,
    so every pivot of the first 256 columns lies in the lower half (cond about 9.6e3)."""
    rng = np.random.default_rng(1)
    h = 256
    N1, N2, N3 = (0.1 * rng.standard_normal((h, h)) for _ in range(3))
    eye = np.eye(h)
    A = torch.as_tensor(np.block([[np.zeros((h, h)), eye + N1], [eye + N2, N3]]))
    return A, torch.as_tensor(rng.standard_normal((3, 2 * h, 2)))


PIVOTED_CASES = {
    'linearized-heat-1024': _linearized_lhs,
    'heat2d-chebyshev-576': lambda: _spectral_operator(Heat2DChebyshev(nx=24, nz=24, device='cpu'), 0.015),
    'rbc-8x128-1e-2': lambda: _spectral_operator(RayleighBenard(nx=8, nz=128, device='cpu'), 1e-2),
    'rbc-8x128-0.25': lambda: _spectral_operator(RayleighBenard(nx=8, nz=128, device='cpu'), 0.25),
    'rbc-8x256-1e-3': lambda: _spectral_operator(RayleighBenard(nx=8, nz=256, device='cpu'), 1e-3, ()),
    'heat-chebyshev-512': lambda: _spectral_operator(HeatChebyshev1D(nvars=512, device='cpu'), 1e-2),
    'burgers-512': lambda: _spectral_operator(Burgers1D(nvars=512, device='cpu'), 1e-2),
    'zero-leading-block-512': _zero_leading_block,
}


@pytest.mark.parametrize('name', list(PIVOTED_CASES))
def test_pivoted_route_equals_lapack(name):
    """From PIVOTED_FROM rows on the blocked LU pivots over the whole matrix, as LAPACK does (block elimination over
    the halves, without pivoting across them, gave NaN or errors up to 1e176 on all but the first two cases)."""
    A, B = PIVOTED_CASES[name]()
    assert A.shape[-1] >= linalg.PIVOTED_FROM
    # two backward-stable solves differ by up to a few eps x cond(A)
    bound = 4 * torch.finfo(torch.float64).eps * float(torch.linalg.cond(A).max())
    assert _rel(linalg._pivoted_solve(A, B), torch.linalg.solve(A, B)) < max(RTOL, bound)


def test_pivoted_route_takes_lapacks_pivots():
    """The blocked factorization chooses the rows LAPACK's ``getrf`` chooses, and the same factors."""
    A, _ = _zero_leading_block()
    LU = A.unsqueeze(0).clone()
    perm = linalg._getrf(LU)
    want, pivots = torch.linalg.lu_factor(A)
    assert torch.equal(perm[0], dense_lu.permutation(pivots.unsqueeze(0), A.shape[-1])[0])
    assert _rel(LU[0], want) < RTOL


@pytest.mark.parametrize('shape_a, shape_b', [((512, 512), (512, 1)), ((2, 1, 520, 520), (2, 3, 520, 2)),
                                              ((1, 600, 600), (4, 1, 600, 1)), ((3, 530, 530), (530, 530))])
def test_pivoted_route_broadcasts(shape_a, shape_b):
    """Batch axes over which ``A`` is broadcast ride along as columns of the right-hand side; every other axis is a
    matrix of its own.  Random matrices: partial pivoting on every column."""
    rng = np.random.default_rng(sum(shape_a))
    A, B = _random(rng, shape_a), _random(rng, shape_b)
    bound = 4 * torch.finfo(torch.float64).eps * float(torch.linalg.cond(A).max())
    got, want = linalg._pivoted_solve(A, B), torch.linalg.solve(A, B)
    assert got.shape == want.shape
    assert _rel(got, want) < max(RTOL, bound)


def test_panel_widths_fit_the_kernel():
    """One panel launch covers a block of 64 columns, down the whole height; its sub-panels (the columns the kernel
    holds in shared memory at a time) narrow as rows and item size grow, and every one fits the budget."""
    assert linalg.BLOCK == dense_lu.MAX_WIDTH
    widths = {(m, size): dense_lu.panel_width(m, size) for m in (512, 600, 1024, 4096) for size in (4, 8, 16)}
    assert widths[(512, 4)] == dense_lu.MAX_WIDTH and widths[(512, 16)] == 16 and widths[(1024, 16)] == 8
    assert all(dense_lu.smem_bytes(m, w, size) <= dense_lu.SMEM_BUDGET for (m, size), w in widths.items())
    assert all(w & (w - 1) == 0 and (w == dense_lu.MAX_WIDTH or w <= 32) for w in widths.values())
    # the rows a panel moves (at most twice its width) are staged through one sub-panel's room
    assert all(min(2 * linalg.BLOCK, m) <= w * (m + 1) for (m, _), w in widths.items())
    assert dense_lu.swap_smem_bytes(2 * linalg.BLOCK, linalg.BLOCK, 16) <= dense_lu.SMEM_BUDGET


@pytest.mark.parametrize('m', [512, 600, 1024, 4096])
def test_swap_grid_covers_every_tile_once(m):
    """``lu_swap_trsm``'s host-side choices at every block of the route, for item sizes 4, 8 and 16 and batches 1, 12
    and 256 on 132 SMs: its shared memory fits a CTA of sm_90, its tiles cover each column outside the panel once
    (left of it ``0 .. j``, right of it ``j + jb .. m``), every CTA owns at least one tile, no tile is owned twice,
    and the grid (CTAs a matrix by the batch) stays within CUDA's limits."""
    for j in range(0, m, linalg.BLOCK):
        jb = min(linalg.BLOCK, m - j)
        for size in (4, 8, 16):
            assert dense_lu.swap_smem_bytes(m - j, jb, size) <= dense_lu.MAX_SMEM_BYTES
            for batch in (1, 12, 256):
                left, right, per_cta, ctas = dense_lu.swap_grid(m, m, j, jb, batch, size, 132)
                owned = [range(x * per_cta, min(left + right, (x + 1) * per_cta)) for x in range(ctas)]
                assert all(len(r) for r in owned) and [t for r in owned for t in r] == list(range(left + right))
                for first, tiles, end in ((0, left, j), (j + jb, right, m)):
                    spans = [(first + 32 * t, min(end, first + 32 * t + 32)) for t in range(tiles)]
                    assert [s for s, _ in spans] + [end] == [first] + [e for _, e in spans]  # each column once
                    assert all(0 < e - s <= dense_lu.SWAP_TILE for s, e in spans)
                assert 1 <= ctas < 2**31 and batch <= 65535
    # the batches the port's routes launch: RayleighBenard 256x128's modes take one CTA a matrix at 512 rows
    assert dense_lu.swap_grid(512, 512, 0, 64, 256, 16, 132)[2:] == (14, 1)


def _swap_trsm_case(case, dtype):
    """A batch whose block ``j`` (``jb`` columns) has been factored by the plain panel, with the permutation it gave:
    (2, 192, 192) unless the case says otherwise."""
    batch, n, j, jb = {'left-and-right': (2, 192, 64, 64), 'last-block': (2, 192, 128, 64),
                       'no-row-moves': (2, 192, 64, 64), 'ragged-last-block': (2, 216, 192, 24),
                       'ragged-block': (2, 192, 64, 24), 'batch-of-one': (1, 192, 64, 64)}[case]
    rng = np.random.default_rng(11)
    A = _random(rng, (batch, n, n), complex_=dtype == torch.complex128).to(dtype)
    if case == 'no-row-moves':
        A = A + 400 * torch.eye(n, dtype=dtype)
    rows = dense_lu.plain_panel(A[:, j:, j:j + jb])
    return A, j, jb, rows


@pytest.mark.parametrize('dtype', [torch.complex128, torch.float64])
@pytest.mark.parametrize('case', ['left-and-right', 'last-block', 'no-row-moves', 'ragged-last-block',
                                  'ragged-block', 'batch-of-one'])
def test_plain_swap_trsm_is_the_permutation_and_triangular_solve(case, dtype):
    """``lu_swap_trsm`` on a CPU tensor (its plain version): the panel's permutation as an explicit permutation
    matrix on the rows ``j..`` of each side, and ``U12`` by ``solve_triangular`` of the panel's unit lower top."""
    A, j, jb, rows = _swap_trsm_case(case, dtype)
    b, n = A.shape[0], A.shape[-1]
    moved = int((rows != torch.arange(n - j)).sum(-1).max())  # rows a matrix
    assert (moved == 0) == (case == 'no-row-moves') and moved <= 2 * jb
    P = torch.zeros((b, n - j, n - j), dtype=dtype).scatter_(2, rows.unsqueeze(-1), 1)  # P[r, rows[r]] = 1
    want = A.clone()
    want[:, j:, :j] = P @ A[:, j:, :j]
    want[:, j:, j + jb:] = P @ A[:, j:, j + jb:]
    if j + jb < n:
        L11 = torch.tril(A[:, j:j + jb, j:j + jb], -1) + torch.eye(jb, dtype=dtype)
        want[:, j:j + jb, j + jb:] = torch.linalg.solve_triangular(L11, want[:, j:j + jb, j + jb:], upper=False)
    got = A.clone()
    dense_lu.lu_swap_trsm(got, j, jb, rows)
    assert torch.equal(got[:, :, j:j + jb], A[:, :, j:j + jb]) and torch.equal(got[:, :j], A[:, :j])
    assert torch.equal(got[:, j:, :j], want[:, j:, :j])
    assert _rel(got, want) < RTOL


def test_inverse_and_cpu_route():
    rng = np.random.default_rng(9)
    A = _random(rng, (3, 6, 6), complex_=False) + 20 * torch.eye(6)
    assert _rel(linalg.inv(A), torch.linalg.inv(A)) < RTOL
    assert _rel(linalg._solve(A, torch.eye(6, dtype=A.dtype).expand(3, 6, 6)), torch.linalg.inv(A)) < RTOL
    B = _random(rng, (3, 6, 2), complex_=False)
    assert torch.equal(linalg.solve(A, B), torch.linalg.solve_ex(A, B)[0])  # a CPU tensor: LAPACK itself
