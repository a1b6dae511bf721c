"""Explicit SDC sweeper (forward-Euler-type preconditioner).

The counterpart of ``pysdc_tpu/sweepers/explicit.py`` (reference
``explicit``, ``pySDC/implementations/sweeper_classes/explicit.py``).  The
sweep is fully explicit: no solves, all new RHS values enter through the
strictly-lower triangular QE.
"""

from __future__ import annotations

import torch

from pysdc_tpu_torch.core.state import LevelState
from pysdc_tpu_torch.core.sweeper import Sweeper


class ExplicitSweeper(Sweeper):
    """params: num_nodes, quad_type, node_type, QE (default 'EE')."""

    def __init__(self, params: dict):
        params = dict(params)
        params.setdefault('QE', 'EE')
        super().__init__(params)
        self.qe_type = params['QE']
        self.QE = self.get_Qdelta_explicit(self.qe_type)

    def update_nodes(self, prob, state: LevelState, t, dt, k: int = 0) -> LevelState:
        M = self.coll.num_nodes
        QE = self.QE
        ts = self.node_times(t, dt)

        ft = state.f[1:]
        W = self._coeff('q-QE', lambda: self.coll.q - QE[1:, 1:], ft)
        integral = dt * torch.tensordot(W, ft, dims=1) + state.u[0].unsqueeze(0) + state.tau

        u_list = list(state.u.unbind(0))
        f_list = list(state.f.unbind(0))
        dtQE = self.scaled_table(dt, QE, 'QE')
        for m in range(M):
            rhs = integral[m]
            for j in range(1, m + 1):
                if QE[m + 1, j] != 0.0:
                    rhs = rhs + self.entry(dtQE, m + 1, j) * f_list[j]
            u_list[m + 1] = rhs
            f_list[m + 1] = prob.eval_f(u_list[m + 1], self.node_time(ts, m))

        return LevelState(u=torch.stack(u_list), f=torch.stack(f_list), tau=state.tau)
