"""Quadrature-node generation for collocation methods.

Replacement for the coefficient layer the reference gets from the
``qmat`` package (see reference ``pySDC/core/collocation.py:73``).  Everything
here is plain float64 numpy, executed once at set-up time; the resulting small
dense matrices are copied to the device by the layers built on top.  A copy
of ``pysdc_tpu/ops/quadrature.py``.

Node families (``node_type``):
  - ``EQUID``     equidistant nodes
  - ``LEGENDRE``  Gauss nodes of the Legendre weight (w = 1)
  - ``CHEBY-1..4``Gauss nodes of the four Chebyshev weights

Quadrature types (``quad_type``):
  - ``GAUSS``       interior nodes only
  - ``RADAU-LEFT``  left endpoint included
  - ``RADAU-RIGHT`` right endpoint included
  - ``LOBATTO``     both endpoints included

Gauss nodes come from the Golub–Welsch eigenvalue problem on the Jacobi
(three-term recurrence) matrix; Radau/Lobatto nodes from Golub's modified
eigenvalue problems (W. Gautschi, *Orthogonal Polynomials: Computation and
Approximation*, radau/lobatto algorithms).
"""

from __future__ import annotations

import numpy as np

NODE_TYPES = ('EQUID', 'LEGENDRE', 'CHEBY-1', 'CHEBY-2', 'CHEBY-3', 'CHEBY-4')
QUAD_TYPES = ('GAUSS', 'RADAU-LEFT', 'RADAU-RIGHT', 'LOBATTO')

#: Jacobi-weight exponents (alpha, beta) for each polynomial node family.
_JACOBI_AB = {
    'LEGENDRE': (0.0, 0.0),
    'CHEBY-1': (-0.5, -0.5),
    'CHEBY-2': (0.5, 0.5),
    'CHEBY-3': (-0.5, 0.5),
    'CHEBY-4': (0.5, -0.5),
}


def jacobi_recurrence(n: int, alpha: float, beta: float) -> tuple[np.ndarray, np.ndarray]:
    """Three-term recurrence coefficients for monic Jacobi polynomials.

    Returns (a, b) with a[k], b[k] for k = 0..n-1 such that
    ``p_{k+1}(x) = (x - a[k]) p_k(x) - b[k] p_{k-1}(x)`` and ``b[0]`` is the
    zeroth moment of the weight on [-1, 1].
    """
    from scipy.special import gammaln

    a = np.zeros(n)
    b = np.zeros(n)
    apb = alpha + beta
    a[0] = (beta - alpha) / (apb + 2.0)
    # zeroth moment: 2^(a+b+1) * Gamma(a+1)Gamma(b+1)/Gamma(a+b+2)
    b[0] = np.exp(
        (apb + 1.0) * np.log(2.0) + gammaln(alpha + 1.0) + gammaln(beta + 1.0) - gammaln(apb + 2.0)
    )
    if n > 1:
        # k = 1 separately: the generic formula has a removable 0/0 when
        # alpha + beta = -1 (Chebyshev weights); cancel (1 + a + b) explicitly.
        a[1] = (beta**2 - alpha**2) / ((2.0 + apb) * (4.0 + apb))
        b[1] = 4.0 * (1.0 + alpha) * (1.0 + beta) / ((2.0 + apb) ** 2 * (3.0 + apb))
    for k in range(2, n):
        t = 2.0 * k + apb
        a[k] = (beta**2 - alpha**2) / (t * (t + 2.0))
        b[k] = 4.0 * k * (k + alpha) * (k + beta) * (k + apb) / (t**2 * (t + 1.0) * (t - 1.0))
    return a, b


def _gauss_from_recurrence(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Golub–Welsch: nodes are eigenvalues of the symmetric tridiagonal
    Jacobi matrix with diagonal ``a`` and off-diagonal ``sqrt(b[1:])``."""
    n = len(a)
    if n == 1:
        return a.copy()
    J = np.diag(a) + np.diag(np.sqrt(b[1:n]), 1) + np.diag(np.sqrt(b[1:n]), -1)
    return np.sort(np.linalg.eigvalsh(J))


def _monic_eval(a: np.ndarray, b: np.ndarray, deg: int, x: float) -> tuple[float, float]:
    """Evaluate monic orthogonal polynomials p_deg(x), p_{deg-1}(x)."""
    pm1, p = 0.0, 1.0
    for k in range(deg):
        pm1, p = p, (x - a[k]) * p - b[k] * pm1
    return p, pm1


def gauss_nodes(n: int, alpha: float, beta: float) -> np.ndarray:
    a, b = jacobi_recurrence(n, alpha, beta)
    return _gauss_from_recurrence(a, b)


def radau_nodes(n: int, alpha: float, beta: float, end: float) -> np.ndarray:
    """n nodes of the Gauss–Radau rule with one node fixed at ``end`` (±1)."""
    if n == 1:
        return np.array([end])
    a, b = jacobi_recurrence(n, alpha, beta)
    # modify last alpha so that `end` becomes an eigenvalue
    p, pm1 = _monic_eval(a, b, n - 1, end)
    a = a.copy()
    a[n - 1] = end - b[n - 1] * pm1 / p
    return _gauss_from_recurrence(a, b)


def lobatto_nodes(n: int, alpha: float, beta: float) -> np.ndarray:
    """n nodes of the Gauss–Lobatto rule with nodes fixed at -1 and +1."""
    if n < 2:
        raise ValueError('LOBATTO needs at least 2 nodes')
    if n == 2:
        return np.array([-1.0, 1.0])
    a, b = jacobi_recurrence(n, alpha, beta)
    endl, endr = -1.0, 1.0
    p1l, p0l = _monic_eval(a, b, n - 1, endl)
    p1r, p0r = _monic_eval(a, b, n - 1, endr)
    det = p1l * p0r - p1r * p0l
    a = a.copy()
    b = b.copy()
    a[n - 1] = (endl * p1l * p0r - endr * p1r * p0l) / det
    b[n - 1] = (endr - endl) * p1l * p1r / det
    return _gauss_from_recurrence(a, b)


def _equid_nodes(n: int, quad_type: str) -> np.ndarray:
    """Equidistant nodes on [-1, 1]; quad_type governs endpoint inclusion."""
    if quad_type == 'GAUSS':
        return np.linspace(-1.0, 1.0, n + 2)[1:-1]
    if quad_type == 'RADAU-LEFT':
        return np.linspace(-1.0, 1.0, n + 1)[:-1]
    if quad_type == 'RADAU-RIGHT':
        return np.linspace(-1.0, 1.0, n + 1)[1:]
    if quad_type == 'LOBATTO':
        return np.linspace(-1.0, 1.0, n)
    raise ValueError(f'unknown quad_type {quad_type!r}')


def nodes_on_unit(num_nodes: int, node_type: str = 'LEGENDRE', quad_type: str = 'RADAU-RIGHT') -> np.ndarray:
    """Collocation nodes on the reference interval [-1, 1]."""
    if node_type not in NODE_TYPES:
        raise ValueError(f'unknown node_type {node_type!r}, pick one of {NODE_TYPES}')
    if quad_type not in QUAD_TYPES:
        raise ValueError(f'unknown quad_type {quad_type!r}, pick one of {QUAD_TYPES}')
    if num_nodes < 1:
        raise ValueError('at least one quadrature node required')

    if node_type == 'EQUID':
        return _equid_nodes(num_nodes, quad_type)

    alpha, beta = _JACOBI_AB[node_type]
    if quad_type == 'GAUSS':
        x = gauss_nodes(num_nodes, alpha, beta)
    elif quad_type == 'RADAU-LEFT':
        x = radau_nodes(num_nodes, alpha, beta, -1.0)
    elif quad_type == 'RADAU-RIGHT':
        x = radau_nodes(num_nodes, alpha, beta, 1.0)
    else:  # LOBATTO
        x = lobatto_nodes(num_nodes, alpha, beta)
    # snap the fixed endpoints exactly
    if quad_type in ('RADAU-LEFT', 'LOBATTO'):
        x[0] = -1.0
    if quad_type in ('RADAU-RIGHT', 'LOBATTO'):
        x[-1] = 1.0
    return x


def nodes(
    num_nodes: int,
    node_type: str = 'LEGENDRE',
    quad_type: str = 'RADAU-RIGHT',
    tleft: float = 0.0,
    tright: float = 1.0,
) -> np.ndarray:
    """Collocation nodes mapped onto [tleft, tright]."""
    if not tleft < tright:
        raise ValueError(f'interval boundaries are corrupt, got {tleft} and {tright}')
    x = nodes_on_unit(num_nodes, node_type, quad_type)
    t = tleft + (x + 1.0) * 0.5 * (tright - tleft)
    if quad_type in ('RADAU-LEFT', 'LOBATTO'):
        t[0] = tleft
    if quad_type in ('RADAU-RIGHT', 'LOBATTO'):
        t[-1] = tright
    return t


def legendre_gauss_rule(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss–Legendre nodes and weights on [-1, 1] (used as the exact
    reference rule when integrating Lagrange polynomials)."""
    a, b = jacobi_recurrence(n, 0.0, 0.0)
    if n == 1:
        return a.copy(), np.array([b[0]])
    J = np.diag(a) + np.diag(np.sqrt(b[1:n]), 1) + np.diag(np.sqrt(b[1:n]), -1)
    lam, V = np.linalg.eigh(J)
    w = b[0] * V[0, :] ** 2
    idx = np.argsort(lam)
    return lam[idx], w[idx]
