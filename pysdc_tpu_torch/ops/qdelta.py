"""QDelta preconditioner generators for SDC sweeps.

Replacement for ``qmat.qdelta.QDELTA_GENERATORS`` (used by the
reference at ``pySDC/core/sweeper.py:100-123``).  All matrices follow the
pySDC convention: shape (M+1, M+1) with a zero "header" row/column for
implicit types, and the distance-to-first-node column stored in column 0 for
explicit types.

Implicit generators (lower triangular, zero first column):
  - ``IE``          implicit (backward) Euler node-to-node steps
  - ``LU``          Weiser's LU trick: transpose of U from LU(Q^T)
  - ``IEpar``       parallel implicit Euler: diag of distances tleft -> node
  - ``Qpar``        diagonal of Q
  - ``PIC``         Picard iteration (zeros)
  - ``TRAP``        trapezoidal rule (average of IE and EE within nodes)
  - ``MIN-SR-NS``   diag(nodes)/M, nilpotent in the non-stiff limit
  - ``MIN-SR-S``    diagonal making I - QDelta^{-1} Q nilpotent (stiff limit)
  - ``MIN-SR-FLEX`` sweep-dependent: diag(nodes)/k, then MIN-SR-S for k > M

Explicit generators (strictly lower triangular):
  - ``EE``          explicit (forward) Euler
  - ``PIC``         zeros

MIN-SR variants follow Čaklović, Lunet, Götschel & Ruprecht,
*Improving parallel efficiency of SDC with diagonal preconditioners* (2023).
"""

from __future__ import annotations

import functools

import numpy as np

from pysdc_tpu_torch.ops.collocation import Collocation

#: names whose coefficients change between sweeps (reference sweeper.py:262)
K_DEPENDENT = frozenset({'MIN-SR-FLEX'})

IMPLICIT_GENERATORS = ('IE', 'LU', 'IEpar', 'Qpar', 'PIC', 'TRAP', 'MIN-SR-NS', 'MIN-SR-S', 'MIN-SR-FLEX')
EXPLICIT_GENERATORS = ('EE', 'PIC')


def _ie_block(coll: Collocation) -> np.ndarray:
    """(M, M) implicit-Euler block: row m accumulates node distances."""
    M = coll.num_nodes
    out = np.zeros((M, M))
    for m in range(M):
        out[m, : m + 1] = coll.delta_m[: m + 1]
    return out


def _ee_block(coll: Collocation) -> tuple[np.ndarray, np.ndarray]:
    """(M, M) explicit-Euler strictly-lower block + the u0 column (dTau).

    Row m approximates the integral tleft..node_m with left endpoints:
    delta_0 * f(u0) + sum_{j<m-1} delta_{j+1} * f(u_j)."""
    M = coll.num_nodes
    out = np.zeros((M, M))
    for m in range(1, M):
        out[m, :m] = coll.delta_m[1 : m + 1]
    dtau = np.full(M, coll.delta_m[0])
    return out, dtau


def _lu_block(coll: Collocation) -> np.ndarray:
    """Weiser's LU trick: QDelta = U^T from LU decomposition of Q^T."""
    import scipy.linalg as sla

    Q = coll.q
    _, _, U = sla.lu(Q.T)
    return U.T


def _charpoly_coeffs(A: np.ndarray) -> np.ndarray:
    """Characteristic polynomial coefficients via Faddeev–LeVerrier
    (exact rational recurrences; more robust than eigenvalue round-trips)."""
    n = A.shape[0]
    c = np.zeros(n + 1)
    c[0] = 1.0
    Mk = np.zeros_like(A)
    for k in range(1, n + 1):
        Mk = A @ Mk + c[k - 1] * np.eye(n)
        c[k] = -np.trace(A @ Mk) / k
    return c


def _min_sr_s_diag(Q: np.ndarray, tau: np.ndarray) -> np.ndarray:
    """Diagonal d > 0 with all eigenvalues of diag(1/d) @ Q equal to 1,
    i.e. (I - D^{-1} Q)^M = 0.  Solved by rootfinding on the characteristic
    polynomial coefficients, starting from the non-stiff solution tau/M."""
    from scipy.optimize import root
    from scipy.special import comb

    M = Q.shape[0]
    target = np.array([(-1.0) ** k * comb(M, k, exact=True) for k in range(1, M + 1)], dtype=float)
    # scale conditions to comparable magnitude
    scale = np.abs(target)

    def F(d):
        A = Q / d[:, None]
        return (_charpoly_coeffs(A)[1:] - target) / scale

    best = None
    best_res = np.inf
    for guess_scale in (M, M + 1, M - 0.5, 2 * M, 1.0):
        d0 = tau / guess_scale
        sol = root(F, d0, method='hybr', tol=1e-14)
        d = sol.x
        if np.any(d <= 0):
            continue
        K = np.eye(M) - Q / d[:, None]
        res = np.linalg.norm(np.linalg.matrix_power(K, M), np.inf)
        if res < best_res:
            best_res, best = res, d
        if res < 1e-11:
            break
    if best is None:
        raise RuntimeError('MIN-SR-S computation failed: no positive diagonal found')
    return best


@functools.lru_cache(maxsize=None)
def _min_sr_s_block_cached(key) -> np.ndarray:
    """Cache keyed by the collocation identity tuple."""
    coll, = key
    M = coll.num_nodes
    tau = coll.nodes - coll.tleft
    if coll.left_is_node:
        # first node sits at tleft: d_0 = 0, solve on the reduced system
        d = np.zeros(M)
        if M > 1:
            d[1:] = _min_sr_s_diag(coll.q[1:, 1:], tau[1:])
        return np.diag(d)
    return np.diag(_min_sr_s_diag(coll.q, tau))


def _min_sr_s_block(coll: Collocation) -> np.ndarray:
    return _min_sr_s_block_cached((coll,))


def _implicit_block(coll: Collocation, name: str, k: int | None) -> np.ndarray:
    M = coll.num_nodes
    tau = coll.nodes - coll.tleft
    if name == 'IE':
        return _ie_block(coll)
    if name == 'LU':
        return _lu_block(coll)
    if name == 'IEpar':
        return np.diag(tau)
    if name == 'Qpar':
        return np.diag(np.diag(coll.q))
    if name == 'PIC':
        return np.zeros((M, M))
    if name == 'TRAP':
        ee, _ = _ee_block(coll)
        return 0.5 * (_ie_block(coll) + ee)
    if name == 'MIN-SR-NS':
        return np.diag(tau / M)
    if name == 'MIN-SR-S':
        return _min_sr_s_block(coll)
    if name == 'MIN-SR-FLEX':
        k = 1 if k is None else int(k)
        if k < 1:
            raise ValueError(f'MIN-SR-FLEX needs sweep index k >= 1, got {k}')
        if k <= M:
            return np.diag(tau / k)
        return _min_sr_s_block(coll)
    raise ValueError(f'unknown implicit QDelta type {name!r}, pick one of {IMPLICIT_GENERATORS}')


def qdelta_implicit(coll: Collocation, name: str, k: int | None = None) -> np.ndarray:
    """(M+1, M+1) lower-triangular QDelta matrix in pySDC convention
    (reference ``pySDC/core/sweeper.py:100``)."""
    M = coll.num_nodes
    out = np.zeros((M + 1, M + 1))
    out[1:, 1:] = _implicit_block(coll, name, k)
    if np.any(np.triu(out, k=1) != 0):
        raise ValueError(f'QDelta generator {name!r} produced a non-lower-triangular matrix')
    return out


def qdelta_explicit(coll: Collocation, name: str, k: int | None = None) -> np.ndarray:
    """(M+1, M+1) strictly-lower-triangular QDelta with the tleft->first-node
    distance in column 0 (reference ``pySDC/core/sweeper.py:112``)."""
    M = coll.num_nodes
    out = np.zeros((M + 1, M + 1))
    if name == 'EE':
        block, dtau = _ee_block(coll)
        out[1:, 1:] = block
        out[1:, 0] = dtau
    elif name == 'PIC':
        pass
    else:
        raise ValueError(f'unknown explicit QDelta type {name!r}, pick one of {EXPLICIT_GENERATORS}')
    if np.any(np.triu(out, k=0) != 0):
        raise ValueError(f'QDelta generator {name!r} produced a non-strictly-lower-triangular matrix')
    return out


def is_k_dependent(name: str) -> bool:
    return name in K_DEPENDENT


def is_diagonal(qd: np.ndarray) -> bool:
    """True if the sweep decouples across nodes (parallelizable, P4)."""
    return bool(np.allclose(np.diag(np.diag(qd)), qd))
