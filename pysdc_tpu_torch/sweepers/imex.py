"""First-order IMEX SDC sweeper.

The counterpart of ``pysdc_tpu/sweepers/imex.py`` (reference
``imex_1st_order``, ``pySDC/implementations/sweeper_classes/imex_1st_order.py:6-187``):
the stiff part is handled with an implicit QDelta (QI), the non-stiff part
with an explicit one (QE, including the extra u0 column).  RHS values are
:class:`~pysdc_tpu_torch.core.state.IMEX` tuples with ``impl`` / ``expl`` fields.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.state import IMEX, LevelState, map_components
from pysdc_tpu_torch.core.sweeper import Sweeper
from pysdc_tpu_torch.ops.qdelta import is_diagonal, is_k_dependent


class IMEXSweeper(Sweeper):
    """params: num_nodes, quad_type, node_type, QI ('IE'), QE ('EE'), ..."""

    def __init__(self, params: dict):
        params = dict(params)
        params.setdefault('QI', 'IE')
        params.setdefault('QE', 'EE')
        super().__init__(params)
        self.qi_type = params['QI']
        self.qe_type = params['QE']
        self.QI = self.get_Qdelta_implicit(self.qi_type)
        self.QE = self.get_Qdelta_explicit(self.qe_type)
        self.parallelizable = is_diagonal(self.QI) and not np.any(self.QE[1:, 1:])

    def _coeffs(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Sweep-k coefficients (reference sweeper.py:262)."""
        QI, QE = self.QI, self.QE
        if self.k_dependent and k > 0:
            if is_k_dependent(self.qi_type):
                QI = self.get_Qdelta_implicit(self.qi_type, k=k)
            if is_k_dependent(self.qe_type):
                QE = self.get_Qdelta_explicit(self.qe_type, k=k)
        return QI, QE

    def update_nodes(self, prob, state: LevelState, t, dt, k: int = 0) -> LevelState:
        M = self.coll.num_nodes
        QI, QE = self._coeffs(k)
        ts = self.node_times(t, dt)
        kk = k if self.k_dependent else 0

        fi = state.f.impl[1:]
        fe = state.f.expl[1:]
        # known part: u0 + tau + dt*(Q(fi+fe) - QI fi - QE fe); only the
        # within-node columns of QI/QE enter here — the u0 column of QE is
        # not used by the sweep (reference imex_1st_order.py:76-88)
        WI = self._coeff(('q-QI', kk), lambda: self.coll.q - QI[1:, 1:], fi)
        WE = self._coeff(('q-QE', kk), lambda: self.coll.q - QE[1:, 1:], fe)
        integral = (
            dt * (torch.tensordot(WI, fi, dims=1) + torch.tensordot(WE, fe, dims=1))
            + state.u[0].unsqueeze(0)
            + state.tau
        )

        if is_diagonal(QI) and not np.any(QE[1:, 1:]):
            u_new = prob.solve_system_batched(integral, self.scaled_table(dt, QI, ('QI', kk)).diagonal()[1:], state.u[1:], ts)
            f_new = prob.eval_f_batched(u_new, ts)
            u = torch.cat([state.u[:1], u_new])
            f = map_components(lambda old, new: torch.cat([old[:1], new]), state.f, f_new)
            return LevelState(u=u, f=f, tau=state.tau)

        # sequential Gauss-Seidel-style sweep over the M nodes
        u_list = list(state.u.unbind(0))
        fi_list = list(state.f.impl.unbind(0))
        fe_list = list(state.f.expl.unbind(0))
        dtQI, dtQE = self.scaled_table(dt, QI, ('QI', kk)), self.scaled_table(dt, QE, ('QE', kk))
        for m in range(M):
            rhs = integral[m]
            for j in range(1, m + 1):
                if QI[m + 1, j] != 0.0:
                    rhs = rhs + self.entry(dtQI, m + 1, j) * fi_list[j]
                if QE[m + 1, j] != 0.0:
                    rhs = rhs + self.entry(dtQE, m + 1, j) * fe_list[j]
            alpha = self.entry(dtQI, m + 1, m + 1)
            if prob.accepts_node_index:
                # the node index selects the prepared factorization
                u_list[m + 1] = prob.solve_system(rhs, alpha, u_list[m + 1], self.node_time(ts, m), node=m)
            else:
                u_list[m + 1] = prob.solve_system(rhs, alpha, u_list[m + 1], self.node_time(ts, m))
            fm = prob.eval_f(u_list[m + 1], self.node_time(ts, m))
            fi_list[m + 1], fe_list[m + 1] = fm.impl, fm.expl

        f = IMEX(impl=torch.stack(fi_list), expl=torch.stack(fe_list))
        return LevelState(u=torch.stack(u_list), f=f, tau=state.tau)
