"""Multi-sweep SDC in the operator's diagonal basis (linear problems).

The counterpart of ``pysdc_tpu/ops/diag_sdc.py``.  For ``u' = A u`` with a
diagonalizable operator (all-periodic FD stencil -> Fourier basis,
tensor-product Dirichlet/Neumann -> eigenbasis), *every* piece of a
generic-implicit sweep (reference ``generic_implicit.py:51-103``) is
elementwise over the modes:

  f_m = lam * u_m                    (eval_f)
  integral = dt (Q - QI) f + u0 + tau
  u_m <- (integral_m + dt sum_{j<m} QI_mj f_j) / (1 - dt QI_mm lam)

so k sweeps need exactly one forward transform, k * O(M^2) elementwise
passes, and one backward transform — instead of 2k*M FFTs for the generic
path (each node solve is transform/divide/transform).

The result is mathematically identical to looping
``GenericImplicit.update_nodes`` (gated in tests/test_torch_sdc.py to float64
roundoff).  Callers pass the problem's ``diagonalizable_operator`` (``None``
where the problem has no such basis).

Who dispatches here: the block controller's coarse chain and burn-in
wavefront (``parallel/sharded.py``, ``coarse_mode='diag'``, which ``'auto'``
picks where the coarsest level is eligible) run ``_one_sweep_diag`` on the
whole block between one transform pair; replayed from the fused lane's CUDA
graphs that chain is the faster one on an H100 (PERF.md).  No sweeper
dispatches here: ``Sweeper.update_nodes_k`` stays the loop, which *eager* on
an H100 is the faster of the two and the one that runs the stencil kernel.
``uhat`` may carry a block's time axis behind the node axis.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.state import LevelState
from pysdc_tpu_torch.ops.qdelta import is_diagonal


def _one_sweep_diag(uhat, lam, dt, QI, W, qd, tauhat, dtQI=None):
    """One generic-implicit sweep on basis coefficients uhat (M+1, *modes);
    ``W`` is Q - QI in ``uhat``'s dtype, ``qd`` the diagonal of QI in ``lam``'s,
    ``dtQI`` the sweeper's ``scaled_table(dt, QI, ...)`` (made here for a host
    ``dt``; a caller with ``dt`` on the device makes it once for all its sweeps)."""
    M = W.shape[0]
    if dtQI is None:
        dtQI = dt * np.asarray(QI)
    entry = (lambda i, j: dtQI[i, j]) if isinstance(dtQI, torch.Tensor) else (lambda i, j: float(dtQI[i, j]))
    fhat = lam * uhat
    integral = dt * torch.tensordot(W, fhat[1:], dims=1) + uhat[0].unsqueeze(0) + tauhat

    if is_diagonal(QI):
        unew = integral / (1.0 - dt * qd.reshape((-1,) + (1,) * (integral.dim() - 1)) * lam)
    else:
        us, fs = [], []  # the new node values and their right-hand sides lam * u, each made once
        for m in range(M):
            rhs = integral[m]
            for j in range(1, m + 1):
                if QI[m + 1, j] != 0.0:
                    rhs = rhs + entry(m + 1, j) * fs[j - 1]
            us.append(rhs if QI[m + 1, m + 1] == 0.0 else rhs / (1.0 - entry(m + 1, m + 1) * lam))
            if m + 1 < M:
                fs.append(lam * us[m])
        unew = torch.stack(us)
    return torch.cat([uhat[:1], unew])


def diagonal_sweeps(op, sweeper, state: LevelState, t, dt, n_sweeps: int, k0: int = 0) -> LevelState:
    """Run ``n_sweeps`` generic-implicit sweeps entirely in ``op``'s diagonal
    basis and return the updated real-space :class:`LevelState`.

    ``op`` must expose ``diag_symbol_on`` / ``diag_forward`` / ``diag_backward``
    (SeparableFDOperator).  ``k0`` is the starting sweep index for
    k-dependent preconditioners (MIN-SR-FLEX).
    """
    real = not state.u.is_complex()
    uhat = op.diag_forward(state.u)
    lam = op.diag_symbol_on(uhat)  # in the state's precision, real when the symbol is
    tauhat = op.diag_forward(state.tau)
    q = sweeper.coll.q

    for k in range(k0, k0 + n_sweeps):
        QI = sweeper._qi(k)
        kk = k if sweeper.k_dependent else 0
        # tensordot does not mix a real table with complex coefficients: W takes uhat's dtype
        W = sweeper._coeff(('q-QI', kk), lambda: q - QI[1:, 1:], uhat)
        qd = sweeper._coeff(('diag QI', kk), lambda: np.diag(QI)[1:], lam)
        uhat = _one_sweep_diag(uhat, lam, dt, QI, W, qd, tauhat, sweeper.scaled_table(dt, QI, ('QI', kk)))

    u = op.diag_backward(uhat, state.u.dtype, real)
    f = op.diag_backward(lam * uhat, state.f.dtype, real)
    return LevelState(u=u, f=f, tau=state.tau)
