"""Collocation tables: nodes, weights, Q and S matrices.

Equivalent of the reference's ``CollBase``
(``pySDC/core/collocation.py:9``) without the external ``qmat`` dependency.
All tables are small dense float64 numpy arrays computed once per
(M, node_type, quad_type, interval) and cached; sweepers copy them to the
device once per dtype.  A copy of ``pysdc_tpu/ops/collocation.py``.

Conventions follow the reference:
  - ``Qmat``/``Smat`` are (M+1, M+1) with a zero first row/column ("header"),
    so ``Qmat[m, j]`` weights node j in the integral from ``tleft`` to node m.
  - ``Smat`` rows are differences of consecutive ``Qmat`` rows (node-to-node).
  - ``delta_m[m]`` is the distance from the previous node (or ``tleft``).
The headerless (M, M) blocks are exposed as ``q``, ``s`` for the sweepers.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

from pysdc_tpu_torch.ops import quadrature
from pysdc_tpu_torch.ops.lagrange import integration_matrix


@dataclass(frozen=True, eq=False)
class Collocation:
    """Immutable collocation table (host-side constants).

    ``eq=False`` keeps identity hashing: ``get_collocation`` is memoized, so
    equal parameters always yield the *same* object and downstream caches
    (e.g. MIN-SR-S diagonals) can key on it directly.
    """

    num_nodes: int
    node_type: str
    quad_type: str
    tleft: float
    tright: float
    nodes: np.ndarray = field(repr=False)
    weights: np.ndarray = field(repr=False)
    Qmat: np.ndarray = field(repr=False)  # (M+1, M+1), header row/col of zeros
    Smat: np.ndarray = field(repr=False)  # (M+1, M+1)
    delta_m: np.ndarray = field(repr=False)
    order: int
    left_is_node: bool
    right_is_node: bool

    # --- headerless views used by the sweepers ---------------------------
    @property
    def q(self) -> np.ndarray:
        """(M, M) quadrature matrix: q[m, j] = integral tleft..node_m of l_j."""
        return self.Qmat[1:, 1:]

    @property
    def s(self) -> np.ndarray:
        return self.Smat[1:, 1:]

    def evaluate(self, weights: np.ndarray, data: np.ndarray) -> np.ndarray:
        """Quadrature over the full interval (reference CollBase.evaluate)."""
        if np.size(weights) != np.size(data):
            raise ValueError(f'input size does not match number of weights, got {np.size(data)}')
        return np.dot(weights, data)


def _empirical_order(nodes: np.ndarray, weights: np.ndarray, tleft: float, tright: float) -> int:
    """Algebraic order of the quadrature rule: largest d+1 such that the
    rule integrates monomials up to degree d exactly (probed on the actual
    interval to 1e-13 relative tolerance).

    Monomial exactness IS the definition of quadrature order, so for the
    non-Gaussian node families this probe returns the exact analytic value
    up to roundoff: any interpolatory rule on M nodes has order >= M, and
    rules with nodes symmetric about the interval midpoint (EQUID, all four
    CHEBY families) gain one extra degree when M is odd (odd-degree error
    moments cancel) — e.g. M=3 EQUID/LOBATTO is Simpson's rule, order 4.
    Gated against these closed forms in tests/test_collocation.py.  The
    value feeds error estimators (Adaptivity's dt exponent), matching the
    reference's per-family order attribute (core/collocation.py:9-141)."""
    max_deg = 2 * nodes.size + 1
    order = 0
    for d in range(max_deg + 1):
        approx = np.dot(weights, nodes**d)
        exact = (tright ** (d + 1) - tleft ** (d + 1)) / (d + 1)
        scale = max(abs(exact), 1.0)
        if abs(approx - exact) > 1e-13 * scale:
            break
        order = d + 1
    return order


def _fh_weights(nodes: np.ndarray, d: int) -> np.ndarray:
    """Blended Floater-Hormann barycentric weights for rational interpolation
    on equidistant nodes (RDC; reference projects/RDC/equidistant_RDC.py:74-105,
    after G. Klein).  ``d`` is the blending degree: d = M-1 recovers the
    polynomial barycentric weights."""
    n = nodes.size - 1
    w = np.zeros(n + 1)
    for k in range(n + 1):
        terms = []
        for i in range(max(k - d, 0), min(k, n - d) + 1):
            prod = 1.0
            for j in range(i, i + d + 1):
                if j != k:
                    prod *= nodes[k] - nodes[j]
            terms.append((-1.0) ** (i - 1) / prod)
        # summation in ascending magnitude for floating-point robustness
        w[k] = np.sum(sorted(terms, key=abs))
    return w


def _barycentric_basis_at(nodes: np.ndarray, w: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Evaluate all barycentric (rational) basis functions e_k at points x.

    Returns (len(nodes), len(x)); exact node hits handled by switching to the
    indicator row.  Second barycentric form: e_k(x) = (w_k/(x-x_k)) / sum_j."""
    x = np.asarray(x, float).ravel()
    diff = x[None, :] - nodes[:, None]
    exact = np.abs(diff) < 1e-14
    safe = np.where(exact, 1.0, diff)
    terms = w[:, None] / safe
    terms = np.where(exact, 0.0, terms)
    den = np.sum(terms, axis=0)
    hit_cols = exact.any(axis=0)
    vals = terms / np.where(hit_cols, 1.0, den)[None, :]
    vals[:, hit_cols] = exact[:, hit_cols].astype(float)
    return vals


def _rdc_collocation(M: int, tleft: float, tright: float, d: int | None = None) -> Collocation:
    """Equidistant-RDC collocation: rational (FH-blended) deferred corrections
    (reference Equidistant_RDC, projects/RDC/equidistant_RDC.py:19-168)."""
    nodes = np.linspace(tleft, tright, M)
    d = min(M - 1, 15) if d is None else min(M - 1, d)
    fh = _fh_weights(nodes, d)

    tau, omega = np.polynomial.legendre.leggauss(M)

    def integrate_rows(bs):
        """Integrals of every basis function from tleft to each b in bs."""
        out = np.zeros((len(bs), M))
        for r, b in enumerate(bs):
            phi = (b - tleft) / 2 * tau + (b + tleft) / 2
            vals = _barycentric_basis_at(nodes, fh, phi)
            out[r] = (b - tleft) / 2 * (vals @ omega)
        return out

    weights = integrate_rows([tright])[0]
    Q = np.zeros((M + 1, M + 1))
    Q[1:, 1:] = integrate_rows(nodes)
    S = np.zeros((M + 1, M + 1))
    S[1] = Q[1]
    S[2:] = np.diff(Q[1:], axis=0)
    delta = np.empty(M)
    delta[0] = nodes[0] - tleft
    delta[1:] = np.diff(nodes)
    return Collocation(
        num_nodes=M, node_type='EQUID-RDC', quad_type='LOBATTO',
        tleft=float(tleft), tright=float(tright),
        nodes=nodes, weights=weights, Qmat=Q, Smat=S, delta_m=delta,
        order=M, left_is_node=True, right_is_node=True,
    )


@functools.lru_cache(maxsize=None)
def get_collocation(
    num_nodes: int,
    node_type: str = 'LEGENDRE',
    quad_type: str = 'RADAU-RIGHT',
    tleft: float = 0.0,
    tright: float = 1.0,
) -> Collocation:
    M = int(num_nodes)
    if node_type == 'EQUID-RDC':
        return _rdc_collocation(M, tleft, tright)
    nodes = quadrature.nodes(M, node_type, quad_type, tleft, tright)

    # weights over the full interval + Q rows (tleft -> node_m), via exact
    # integration of the Lagrange basis
    intervals = [(tleft, tright)] + [(tleft, float(t)) for t in nodes]
    mats = integration_matrix(nodes, intervals)
    weights = mats[0]
    Q = np.zeros((M + 1, M + 1))
    Q[1:, 1:] = mats[1:]

    S = np.zeros((M + 1, M + 1))
    S[1, 1:] = Q[1, 1:]
    for m in range(2, M + 1):
        S[m, 1:] = Q[m, 1:] - Q[m - 1, 1:]

    delta = np.empty(M)
    delta[0] = nodes[0] - tleft
    delta[1:] = np.diff(nodes)

    # known analytic orders for LEGENDRE; empirical for the rest
    if node_type == 'LEGENDRE':
        order = {'GAUSS': 2 * M, 'RADAU-LEFT': 2 * M - 1, 'RADAU-RIGHT': 2 * M - 1, 'LOBATTO': 2 * M - 2}[quad_type]
        order = max(order, 1)
    else:
        order = max(_empirical_order(nodes, weights, tleft, tright), 1)

    return Collocation(
        num_nodes=M,
        node_type=node_type,
        quad_type=quad_type,
        tleft=float(tleft),
        tright=float(tright),
        nodes=nodes,
        weights=weights,
        Qmat=Q,
        Smat=S,
        delta_m=delta,
        order=order,
        left_is_node=quad_type in ('LOBATTO', 'RADAU-LEFT'),
        right_is_node=quad_type in ('LOBATTO', 'RADAU-RIGHT'),
    )
