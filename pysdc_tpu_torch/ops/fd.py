"""Finite-difference stencil generation.

Same mathematics as the reference's ``pySDC/helpers/problem_helper.py:42-245``
(Taylor-expansion stencils of arbitrary derivative/order, boundary handling by
shifted stencils), re-implemented for the port: the 1D operator is
produced both as a *stencil* (offsets + coefficients, for roll-based matrix-
free application on periodic grids) and as a dense numpy matrix (for the
tensor-product eigen-factorized direct solves in :mod:`pysdc_tpu_torch.ops.linop`).  A copy of ``pysdc_tpu/ops/fd.py``.
"""

from __future__ import annotations

import numpy as np
from scipy.special import factorial


def get_steps(derivative: int, order: int, stencil_type: str) -> tuple[int, np.ndarray]:
    """Offsets of the FD stencil for the requested type."""
    width = order + derivative
    if stencil_type == 'center':
        # symmetric stencils gain one order for even derivatives, so one
        # fewer point suffices there
        if derivative % 2 == 0:
            width -= 1
        steps = np.arange(width) - width // 2
    elif stencil_type == 'forward':
        steps = np.arange(width)
    elif stencil_type == 'backward':
        steps = -np.arange(width)
    elif stencil_type == 'upwind':
        if width <= 3:
            return get_steps(derivative, order, 'backward')
        # mostly-backward stencil with a single downwind point
        steps = np.concatenate([np.arange(-(width - 2), 1), [1]])
    else:
        raise ValueError(
            f'stencil must be of type "center", "forward", "backward" or "upwind", not {stencil_type}'
        )
    return width, steps


def get_finite_difference_stencil(derivative: int, order: int | None = None, stencil_type: str | None = None, steps=None):
    """FD weights from Taylor expansions; returns (coeffs, offsets) sorted by
    offset.  The weights solve the Vandermonde-type system
    ``sum_j c_j * s_j^i / i! = delta_{i,derivative}``."""
    if steps is not None:
        steps = np.asarray(steps)
        n = len(steps)
    else:
        n, steps = get_steps(derivative, order, stencil_type)

    # rows are Taylor terms s^i/i!; selecting the `derivative` unit vector
    # zeroes every other expansion term up to the achievable order
    powers = np.arange(n)[:, None]
    taylor = steps[None, :] ** powers / factorial(powers)
    unit = np.eye(n)[derivative]
    coeff = np.linalg.solve(taylor, unit)

    order_of = np.argsort(steps)
    return coeff[order_of], steps[order_of]


def fd_matrix_1d(
    derivative: int,
    order: int,
    size: int,
    dx: float,
    bc='periodic',
    stencil_type: str | None = None,
    steps=None,
    bc_params=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Dense 1D FD matrix with boundary conditions, plus the RHS boundary
    vector ``b`` (nonzero for inhomogeneous Dirichlet/Neumann).

    Follows the reference's construction (problem_helper.py:120-245): interior
    rows carry the requested stencil; near non-periodic boundaries rows use
    shifted (or order-reduced) one-sided stencils; Neumann conditions fold a
    one-sided first-derivative stencil into the boundary rows.
    """
    if stencil_type is None and steps is None:
        stencil_type = 'center'
    coeff, offs = get_finite_difference_stencil(derivative, order, stencil_type, steps)

    if not isinstance(bc, tuple):
        bc = (bc, bc)
    bc_params = bc_params if bc_params is not None else {}
    if not isinstance(bc_params, list):
        bc_params = [dict(bc_params), dict(bc_params)]

    A = np.zeros((size, size))
    b = np.zeros(size)

    if bc[0] == 'periodic':
        assert bc[1] == 'periodic', 'periodic BCs must be periodic on both sides'
        for c, s in zip(coeff, offs):
            A += c * np.eye(size, k=s)
            if s > 0:
                A += c * np.eye(size, k=-size + s)
            if s < 0:
                A += c * np.eye(size, k=size + s)
    else:
        for i in range(size):
            for c, s in zip(coeff, offs):
                j = i + s
                if 0 <= j < size:
                    A[i, j] = A[i, j] + c

        defaults = {'val': 0.0, 'neumann_bc_order': order, 'reduce': False}
        for iS in (0, 1):
            assert 'neumann' in bc[iS] or 'dirichlet' in bc[iS], f'unknown BC type: {bc[iS]}'
            par = {**defaults, **bc_params[iS]}
            val, reduce, n_order = par['val'], par['reduce'], par['neumann_bc_order']
            s_width = -int(offs.min()) if iS == 0 else int(offs.max())
            for i in range(s_width):
                i_line = i if iS == 0 else size - 1 - i
                if reduce:
                    b_coeff, b_steps = get_finite_difference_stencil(derivative, 2 * (i + 1), 'center')
                else:
                    if iS == 0:
                        b_steps = np.arange(-(i + 1), order + derivative - (i + 1))
                    else:
                        b_steps = np.arange(-(order + derivative) + (i + 2), (i + 2))
                    b_coeff, b_steps = get_finite_difference_stencil(derivative, steps=b_steps)

                A[i_line, :] = 0.0
                if iS == 0:
                    cols = np.arange(len(b_coeff) - 1)
                    A[i_line, cols] = b_coeff[1:]
                    edge_coeff = b_coeff[0]
                else:
                    cols = size - (len(b_coeff) - 1) + np.arange(len(b_coeff) - 1)
                    A[i_line, cols] = b_coeff[:-1]
                    edge_coeff = b_coeff[-1]

                if 'dirichlet' in bc[iS]:
                    b[i_line] = val * edge_coeff
                elif 'neumann' in bc[iS]:
                    n_coeff, _ = get_finite_difference_stencil(
                        1, n_order, 'forward' if iS == 0 else 'backward'
                    )
                    if iS == 0:
                        cols = np.arange(len(n_coeff) - 1)
                        A[i_line, cols] -= edge_coeff / n_coeff[0] * n_coeff[1:]
                    else:
                        cols = size - (len(n_coeff) - 1) + np.arange(len(n_coeff) - 1)
                        A[i_line, cols] -= edge_coeff / n_coeff[-1] * n_coeff[:-1]
                    b[i_line] = val * edge_coeff / (n_coeff[0] if iS == 0 else n_coeff[-1]) * dx

    return A / dx**derivative, b / dx**derivative


def stencil_symbol(coeff: np.ndarray, offs: np.ndarray, size: int, dx: float, derivative: int) -> np.ndarray:
    """Eigenvalues of the periodic (circulant) 1D stencil operator, ordered
    like ``numpy.fft.fftfreq``: lambda_k = sum_j c_j exp(2*pi*i*j*k/N) / dx^d."""
    k = np.arange(size)
    lam = np.zeros(size, dtype=complex)
    for c, s in zip(coeff, offs):
        lam += c * np.exp(2j * np.pi * s * k / size)
    return lam / dx**derivative


def get_1d_grid(size: int, bc, left: float = 0.0, right: float = 1.0) -> tuple[float, np.ndarray]:
    """Grid + spacing matching the reference (problem_helper.py ``get_1d_grid``):
    periodic grids exclude the right endpoint, Dirichlet/Neumann grids exclude
    both boundary points."""
    L = right - left
    bc0 = bc[0] if isinstance(bc, tuple) else bc
    if bc0 == 'periodic':
        dx = L / size
        x = np.arange(size) * dx + left
    else:
        dx = L / (size + 1)
        x = np.arange(1, size + 1) * dx + left
    return dx, x
