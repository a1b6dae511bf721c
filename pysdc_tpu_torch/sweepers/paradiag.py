"""ParaDiag inner sweepers: direct collocation solves via diagonalization.

The counterpart of ``pysdc_tpu/sweepers/paradiag.py`` (reference
``QDiagonalization`` / ``QDiagonalizationIMEX``,
``implementations/sweeper_classes/ParaDiagSweepers.py:11-170``): eigendecompose
``Q G^{-1} = S diag(w) S^{-1}``, solve M decoupled complex-shifted systems,
transform back.  In ParaDiag mode (``ignore_ic=True``) the input is the
node-local residual and the output an increment; in SDC mode
(``ignore_ic=False``) the collocation problem is solved directly from u0.

The node transforms are ``(M, M)`` complex products along the node axis, one
batched product each; the M shifted solves are one
``Problem.solve_jacobian_batched`` call.  The complex tables are kept on the
field's device in its complex precision (complex64 for float32 fields).
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.device import complex_dtype
from pysdc_tpu_torch.core.state import LevelState, map_components
from pysdc_tpu_torch.core.sweeper import Sweeper


def compute_diagonalization(A: np.ndarray):
    """A = S diag(w) S^{-1} (reference ParaDiagHelper.py:53-69)."""
    w, S = np.linalg.eig(A)
    S_inv = np.linalg.inv(S)
    assert np.allclose(S @ np.diag(w) @ S_inv, A)
    return w, S, S_inv


class QDiagonalization(Sweeper):
    """params: num_nodes, quad_type, G_inv (np matrix, default identity),
    ignore_ic (default True), update_f_evals (default False)."""

    def __init__(self, params: dict):
        params = dict(params)
        super().__init__(params)
        M = self.coll.num_nodes
        self.G_inv = np.asarray(params.get('G_inv', np.eye(M)))
        self.ignore_ic = params.get('ignore_ic', True)
        self.update_f_evals = params.get('update_f_evals', False)
        self.set_G_inv(self.G_inv)

    def set_G_inv(self, G_inv: np.ndarray):
        self.G_inv = G_inv
        self.w, self.S, self.S_inv = compute_diagonalization(self.coll.q @ G_inv)
        self._consts = {}

    def _table(self, name, like: torch.Tensor) -> torch.Tensor:
        """``S``, ``S_inv``, ``G_inv`` or ``w`` on ``like``'s device in its complex precision, made once and kept."""
        return self._coeff(name, lambda: getattr(self, name), like, complex_dtype(like.dtype))

    def _node_matmul(self, name, x):
        """The ``(M, M)`` complex table ``name`` applied along the leading node axis of ``x``."""
        return torch.tensordot(self._table(name, x), x, dims=1)

    def _solve_diagonal(self, prob, x1, u_avg, t, dt):
        """Per-node complex-shifted Jacobian solves, one batched call."""
        ts = np.asarray(t + dt * self.coll.nodes, dtype=float)
        return prob.solve_jacobian_batched(x1, dt * self._table('w', x1), u_avg, ts)

    def solve_increment(self, prob, residual, u_avg, t, dt):
        """ParaDiag mode: increment = G_inv S solve(S_inv residual)
        (reference ParaDiagSweepers.py:89-133)."""
        x1 = self._node_matmul('S_inv', residual.to(complex_dtype(residual.dtype)))
        x2 = self._solve_diagonal(prob, x1, u_avg, t, dt)
        return self._node_matmul('G_inv', self._node_matmul('S', x2))

    def update_nodes(self, prob, state: LevelState, t, dt, k: int = 0) -> LevelState:
        """SDC mode (ignore_ic=False): solve the collocation problem directly
        with u0 as the right-hand side for every node."""
        M = self.coll.num_nodes
        u0c = state.u[0].to(complex_dtype(state.u.dtype))
        rhs = u0c.unsqueeze(0).expand((M,) + tuple(u0c.shape))
        x1 = self._node_matmul('S_inv', rhs)
        x2 = self._solve_diagonal(prob, x1, None, t, dt)
        y = self._node_matmul('G_inv', self._node_matmul('S', x2))
        if not state.u.is_complex():
            y = y.real
        u = torch.cat([state.u[:1], y.to(state.u.dtype)])
        f_nodes = prob.eval_f_batched(u[1:], self.node_times(t, dt))
        f = map_components(lambda l0, ln: torch.cat([l0.unsqueeze(0), ln]), prob.eval_f(state.u[0], t), f_nodes)
        return LevelState(u=u, f=f, tau=state.tau)


class QDiagonalizationIMEX(QDiagonalization):
    """IMEX flavor: the residual integrates impl+expl (the base integral of
    ``f_total``), the solve shifts only the implicit part, which is what an
    IMEX problem's ``solve_system`` does (reference ParaDiagSweepers.py:165-170)."""
