"""Barycentric Lagrange interpolation / integration.

Replacement for ``qmat.lagrange.LagrangeApproximation`` used by the reference's
collocation-node transfer operators (reference ``pySDC/core/base_transfer.py:79``)
and polynomial error estimators.  Pure float64 numpy at set-up time.  A copy of
``pysdc_tpu/ops/lagrange.py``.
"""

from __future__ import annotations

import numpy as np

from pysdc_tpu_torch.ops.quadrature import legendre_gauss_rule


def barycentric_weights(nodes: np.ndarray) -> np.ndarray:
    """Barycentric weights for the given (distinct) nodes.

    Uses the rescaled product formula from Berrut & Trefethen (2004) for
    numerical stability.
    """
    nodes = np.asarray(nodes, dtype=float)
    n = nodes.size
    # scale differences to avoid overflow/underflow for many nodes
    scale = max((nodes.max() - nodes.min()) / 4.0, 1e-30)
    w = np.ones(n)
    for j in range(n):
        diff = (nodes[j] - nodes) / scale
        diff[j] = 1.0
        w[j] = 1.0 / np.prod(diff)
    return w / np.max(np.abs(w))


def interpolation_matrix(from_nodes: np.ndarray, to_points: np.ndarray) -> np.ndarray:
    """Matrix ``P`` with ``P @ f(from_nodes) = p(to_points)`` where p is the
    interpolating polynomial on ``from_nodes``.  Shape (len(to), len(from))."""
    from_nodes = np.asarray(from_nodes, dtype=float)
    to_points = np.atleast_1d(np.asarray(to_points, dtype=float))
    w = barycentric_weights(from_nodes)
    P = np.zeros((to_points.size, from_nodes.size))
    for i, x in enumerate(to_points):
        diff = x - from_nodes
        exact = np.isclose(diff, 0.0, atol=1e-14)
        if exact.any():
            P[i, np.argmax(exact)] = 1.0
        else:
            terms = w / diff
            P[i, :] = terms / np.sum(terms)
    return P


def evaluate(nodes: np.ndarray, values: np.ndarray, x: float) -> float:
    """Evaluate the interpolating polynomial at a single point."""
    return float(interpolation_matrix(nodes, np.array([x]))[0] @ values)


def integration_matrix(
    nodes: np.ndarray, intervals: list[tuple[float, float]], num_quad: int | None = None
) -> np.ndarray:
    """Row ``i`` integrates the interpolating polynomial on ``nodes`` over
    ``intervals[i]``: the workhorse behind the collocation Q/S/weights tables.

    Integration is exact for the polynomial degree at hand: each interval is
    mapped to a Gauss–Legendre rule with enough points.
    """
    nodes = np.asarray(nodes, dtype=float)
    M = nodes.size
    if num_quad is None:
        num_quad = (M + 1) // 2 + 2  # integrates degree 2*num_quad-1 >= M-1 exactly
    xg, wg = legendre_gauss_rule(num_quad)
    out = np.zeros((len(intervals), M))
    for i, (a, b) in enumerate(intervals):
        h = 0.5 * (b - a)
        pts = a + (xg + 1.0) * h
        P = interpolation_matrix(nodes, pts)  # (num_quad, M)
        out[i, :] = h * (wg @ P)
    return out
