"""The capturable dense solves of ``pysdc_tpu_torch/ops/linalg.py`` against ``torch.linalg.solve`` (CPU, float64 and
complex128).

On the card :func:`~pysdc_tpu_torch.ops.linalg.solve` takes two routes that torch does not choose by itself: a batch
padded so that torch's cuSOLVER preference lands on cuBLAS's batched LU and substitution (``_batched_solve``), and
block elimination over the halves from 512 rows on (``_blocked_solve``).  Both are device-agnostic torch code, so
they are held here on the CPU: broadcast batches, one matrix, one and two systems, several right-hand sides, and the
two kinds of large systems the port solves (a linearized sweep's implicit stages on HeatND 32^2 and the
Heat2DChebyshev 24^2 tensor-product operator), each to 1e-13 relative, or to 4 eps cond(A) where the matrix's
condition number makes two backward-stable solves differ by more.
"""

import numpy as np
import pytest
import torch

from pysdc_tpu_torch.models.heat import HeatND
from pysdc_tpu_torch.models.spectral_problems import Heat2DChebyshev
from pysdc_tpu_torch.ops import linalg

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


def _spectral_operator():
    """Heat2DChebyshev 24^2's shifted operator with its tau rows (576 coupled unknowns), and a right-hand side."""
    spec = Heat2DChebyshev(nx=24, nz=24, device='cpu').spec
    like = torch.zeros((1,), dtype=torch.complex128)
    keep = torch.as_tensor(spec.keep_mask)
    A = (spec._dev('M_all', like) + 0.015 * spec._dev('L_all', like)) * keep[:, :, None] + spec._dev('bc_rows', like)
    return A, _random(np.random.default_rng(4), (2,) + tuple(A.shape[:-1]) + (1,))


@pytest.mark.parametrize('make', [_linearized_lhs, _spectral_operator], ids=['linearized-1024', 'spectral-576'])
def test_blocked_route_equals_lapack(make):
    A, B = make()
    assert A.shape[-1] >= linalg.BLOCKED_FROM
    # two backward-stable solves differ by up to a few eps x cond(A) (the spectral operator's cond is about 2.7e3)
    bound = 4 * torch.finfo(torch.float64).eps * float(torch.linalg.cond(A).max())
    assert _rel(linalg._blocked_solve(A, B), torch.linalg.solve(A, B)) < max(RTOL, bound)


def test_inverse_and_cpu_route():
    rng = np.random.default_rng(9)
    A = _random(rng, (3, 6, 6), complex_=False) + 20 * torch.eye(6)
    assert _rel(linalg.inv(A), torch.linalg.inv(A)) < RTOL
    assert _rel(linalg._solve(A, torch.eye(6, dtype=A.dtype).expand(3, 6, 6)), torch.linalg.inv(A)) < RTOL
    B = _random(rng, (3, 6, 2), complex_=False)
    assert torch.equal(linalg.solve(A, B), torch.linalg.solve_ex(A, B)[0])  # a CPU tensor: LAPACK itself
