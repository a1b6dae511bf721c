"""Generic implicit SDC sweeper.

The counterpart of ``pysdc_tpu/sweepers/generic_implicit.py`` (reference
``generic_implicit``, ``pySDC/implementations/sweeper_classes/generic_implicit.py:4-131``):
one sweep updates all collocation nodes with a lower-triangular (or
diagonal) QDelta preconditioner.

Structure of one sweep (mathematically identical to the reference):
  integral_m = u0 + tau_m + dt * ((Q - QI) f^k)_m            (one contraction)
  for m = 1..M:   u_m^{k+1} = solve(I - dt*qd_mm A,
                      integral_m + dt * sum_{j<m} QI_mj f_j^{k+1})

Diagonal QI (IEpar / MIN-SR-*): the inner loop disappears — all node solves
and RHS evaluations take the node axis as a leading batch axis.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.state import LevelState
from pysdc_tpu_torch.core.sweeper import Sweeper
from pysdc_tpu_torch.ops.qdelta import is_diagonal


class GenericImplicit(Sweeper):
    """params: num_nodes, quad_type, node_type, QI (default 'IE'), ..."""

    def __init__(self, params: dict):
        params = dict(params)
        params.setdefault('QI', 'IE')
        super().__init__(params)
        self.qi_type = params['QI']
        self.QI = self.get_Qdelta_implicit(self.qi_type)
        self.parallelizable = is_diagonal(self.QI)

    def _qi(self, k: int) -> np.ndarray:
        """Sweep-k coefficients (reference sweeper.py:262)."""
        if self.k_dependent and k > 0:
            return self.get_Qdelta_implicit(self.qi_type, k=k)
        return self.QI

    def update_nodes(self, prob, state: LevelState, t, dt, k: int = 0) -> LevelState:
        M = self.coll.num_nodes
        QI = self._qi(k)
        ts = self.node_times(t, dt)

        # (M, *shape): any tensor-valued RHS; problems with split RHS
        # (imex/comp2) pair with their dedicated sweepers
        ft = state.f[1:]
        kk = k if self.k_dependent else 0
        W = self._coeff(('q-QI', kk), lambda: self.coll.q - QI[1:, 1:], ft)
        integral = dt * torch.tensordot(W, ft, dims=1) + state.u[0].unsqueeze(0) + state.tau

        if is_diagonal(QI):
            u_new = prob.solve_system_batched(integral, self.scaled_table(dt, QI, ('QI', kk)).diagonal()[1:], state.u[1:], ts)
            f_new = prob.eval_f_batched(u_new, ts)
            u = torch.cat([state.u[:1], u_new])
            f = torch.cat([state.f[:1], f_new])
            return LevelState(u=u, f=f, tau=state.tau)

        # sequential Gauss-Seidel-style sweep over the M nodes
        u_list = list(state.u.unbind(0))
        f_list = list(state.f.unbind(0))
        dtQI = self.scaled_table(dt, QI, ('QI', kk))
        for m in range(M):
            rhs = integral[m]
            for j in range(1, m + 1):
                if QI[m + 1, j] != 0.0:
                    rhs = rhs + self.entry(dtQI, m + 1, j) * f_list[j]
            shift = self.entry(dtQI, m + 1, m + 1)
            if QI[m + 1, m + 1] == 0.0:
                u_list[m + 1] = rhs
            elif prob.accepts_node_index:
                # the node index selects the prepared factorization
                u_list[m + 1] = prob.solve_system(rhs, shift, u_list[m + 1], self.node_time(ts, m), node=m)
            else:
                u_list[m + 1] = prob.solve_system(rhs, shift, u_list[m + 1], self.node_time(ts, m))
            f_list[m + 1] = prob.eval_f(u_list[m + 1], self.node_time(ts, m))

        return LevelState(u=torch.stack(u_list), f=torch.stack(f_list), tau=state.tau)
