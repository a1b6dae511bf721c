"""Multi-implicit SDC sweeper: two implicit components, separate solves.

The counterpart of ``pysdc_tpu/sweepers/multi_implicit.py`` (reference
``multi_implicit``, ``implementations/sweeper_classes/multi_implicit.py``):
component 1 is preconditioned with Q1, component 2 with Q2; each node does two
implicit solves (``solve_system_1``, or ``solve_system`` where the problem
has no ``solve_system_1``, then ``solve_system_2``).  RHS values are
:class:`~pysdc_tpu_torch.core.state.Comp2` tuples.  On the periodic
Allen-Cahn problem the first solve is one cuFFT shifted solve, the second the
pointwise Newton, and ``eval_f`` applies the Laplacian through kernel K1.
"""

from __future__ import annotations

import torch

from pysdc_tpu_torch.core.state import Comp2, LevelState
from pysdc_tpu_torch.core.sweeper import Sweeper


class MultiImplicitSweeper(Sweeper):
    """params: num_nodes, quad_type, Q1 ('IE'), Q2 ('IE')."""

    def __init__(self, params: dict):
        params = dict(params)
        params.setdefault('Q1', 'IE')
        params.setdefault('Q2', 'IE')
        super().__init__(params)
        self.Q1 = self.get_Qdelta_implicit(params['Q1'])
        self.Q2 = self.get_Qdelta_implicit(params['Q2'])

    def update_nodes(self, prob, state: LevelState, t, dt, k: int = 0) -> LevelState:
        M = self.coll.num_nodes
        ts = self.node_times(t, dt)
        solve_1 = getattr(prob, 'solve_system_1', prob.solve_system)
        solve_2 = prob.solve_system_2

        f1 = state.f.comp1[1:]
        f2 = state.f.comp2[1:]
        W1 = self._coeff('q-Q1', lambda: self.coll.q - self.Q1[1:, 1:], f1)
        q = self._coeff('q', lambda: self.coll.q, f2)
        Q2 = self._coeff('Q2', lambda: self.Q2[1:, 1:], f2)
        # known part for the Q1 solve: u0 + tau + dt*(Q(f1+f2) - Q1 f1)
        integral = dt * (torch.tensordot(W1, f1, dims=1) + torch.tensordot(q, f2, dims=1)) \
            + state.u[0].unsqueeze(0) + state.tau
        # Q2-preconditioner part of the old iterate, subtracted later
        Q2int = dt * torch.tensordot(Q2, f2, dims=1)

        u_list = list(state.u.unbind(0))
        f1_list = list(state.f.comp1.unbind(0))
        f2_list = list(state.f.comp2.unbind(0))
        dtQ1, dtQ2 = self.scaled_table(dt, self.Q1, 'Q1'), self.scaled_table(dt, self.Q2, 'Q2')

        for m in range(M):
            tm = self.node_time(ts, m)
            rhs = integral[m]
            for j in range(1, m + 1):
                if self.Q1[m + 1, j] != 0.0:
                    rhs = rhs + self.entry(dtQ1, m + 1, j) * f1_list[j]
            u_mid = solve_1(rhs, self.entry(dtQ1, m + 1, m + 1), u_list[m + 1], tm)

            rhs = u_mid - Q2int[m]
            for j in range(1, m + 1):
                if self.Q2[m + 1, j] != 0.0:
                    rhs = rhs + self.entry(dtQ2, m + 1, j) * f2_list[j]
            u_list[m + 1] = solve_2(rhs, self.entry(dtQ2, m + 1, m + 1), u_mid, tm)

            fm = prob.eval_f(u_list[m + 1], tm)
            f1_list[m + 1], f2_list[m + 1] = fm.comp1, fm.comp2

        f = Comp2(comp1=torch.stack(f1_list), comp2=torch.stack(f2_list))
        return LevelState(u=torch.stack(u_list), f=f, tau=state.tau)
