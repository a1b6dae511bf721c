"""Fully-implicit and semi-implicit SDC sweepers for DAEs F(u, u', t) = 0.

The counterpart of ``pysdc_tpu/sweepers/dae.py`` (reference DAE project
sweepers, projects/DAE/sweepers/fullyImplicitDAE.py, semiImplicitDAE.py,
rungeKuttaDAE.py, built on Huang, Jia & Minion 2007): the unknowns at the
nodes are the *derivatives* U' (stored in the level's ``f`` slot); each node
solves

    0 = F(u_approx + dt*qd_mm * U'_m, U'_m, tau_m)

with u_approx accumulating the preconditioned integral, and the solution is
recovered as u = u0 + dt Q U'.  The residual is ||F(u, u')|| at the nodes,
one batched evaluation.  Node solves run the problem's Newton iteration with
the Jacobian by ``torch.func.jacfwd``.

The fused lanes' CUDA graphs do not hold these sweepers (``graph_capture_blocker``):
every node solve is a Newton loop that reads its stopping test on the host,
and the Runge-Kutta classes carry the step's initial derivative across steps
on the host, like the multistep sweepers.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.errors import ParameterError
from pysdc_tpu_torch.core.state import LevelState, norm_max
from pysdc_tpu_torch.core.sweeper import Sweeper
from pysdc_tpu_torch.sweepers import runge_kutta as rk

_BLOCKER = ('a DAE sweeper solves each node by Newton with a Jacobian by torch.func.jacfwd and reads its stopping '
            'test on the host: this configuration runs on the stage-machine path')


def _differential(x, nd):
    """``x`` with its algebraic components (the last axis from ``nd`` on) set to zero, as a new tensor."""
    return torch.cat([x[..., :nd], torch.zeros_like(x[..., nd:])], dim=-1)


class FullyImplicitDAE(Sweeper):
    graph_capture_blocker = _BLOCKER

    def __init__(self, params: dict):
        params = dict(params)
        params.setdefault('QI', 'IE')
        params.setdefault('initial_guess', 'spread')
        super().__init__(params)
        if self.coll.left_is_node:
            raise ParameterError(
                f"Quadrature type {params.get('quad_type')} is not implemented yet. Use 'RADAU-RIGHT' instead!"
            )
        self.QI = self.get_Qdelta_implicit(params['QI'])

    def _nodes(self, key, W, x):
        """The coefficient table ``W`` applied along the leading node axis of ``x``."""
        return torch.tensordot(self._coeff(key, lambda: W, x), x, dims=1)

    def predict(self, prob, u0, t, dt, random_val: float = 0.0) -> LevelState:
        """Spread u0; derivatives start at zero (reference :107-140)."""
        M = self.coll.num_nodes
        u = u0.unsqueeze(0).repeat((M + 1,) + (1,) * u0.dim())
        tau = torch.zeros((M,) + tuple(u0.shape), dtype=u0.dtype, device=u0.device)
        return LevelState(u=u, f=torch.zeros_like(u), tau=tau)

    def _solve_nodes(self, prob, state, t, dt, du, solve):
        """The node loop: each node's ``u_approx`` from the integral ``dt (Q - QI) du + u0 + tau`` and the
        derivatives already solved, then ``solve(u_approx, factor, guess, t_m)``."""
        M = self.coll.num_nodes
        ts = self.node_times(t, dt)
        integral = dt * self._nodes('Q-QI', self.coll.q - self.QI[1:, 1:], du) + state.u[0] + state.tau
        du_list = list(state.f.unbind(0))
        for m in range(M):
            u_approx = integral[m]
            for j in range(1, m + 1):
                if self.QI[m + 1, j] != 0.0:
                    u_approx = u_approx + dt * float(self.QI[m + 1, j]) * self._part(prob, du_list[j])
            du_list[m + 1] = solve(u_approx, dt * float(self.QI[m + 1, m + 1]), du_list[m + 1],
                                   self.node_time(ts, m))
        return torch.stack(du_list)

    def _part(self, prob, du):
        """What of a node's unknowns is integrated: all of them here."""
        return du

    def update_nodes(self, prob, state: LevelState, t, dt, k: int = 0) -> LevelState:
        f = self._solve_nodes(prob, state, t, dt, state.f[1:], prob.solve_system_dae)
        u_nodes = state.u[0] + dt * self._nodes('Q', self.coll.q, f[1:])
        return LevelState(u=torch.cat([state.u[:1], u_nodes]), f=f, tau=state.tau)

    def compute_residual(self, state: LevelState, dt, residual_type: str = 'full_abs', prob=None, t=0.0):
        """||F(u_m, u'_m, tau_m)|| over the nodes (reference :142-191), one evaluation for all nodes."""
        prob = prob if prob is not None else self.level.prob
        M = self.coll.num_nodes
        ts = t + dt * np.asarray(self.coll.nodes[-M:], dtype=float)
        res_nodes = prob.eval_f(state.u[1:], state.f[1:], ts)
        node_norms = res_nodes.abs().flatten(1).amax(dim=1)
        if residual_type == 'full_abs':
            norm = node_norms.amax()
        elif residual_type == 'last_abs':
            norm = node_norms[-1]
        elif residual_type == 'full_rel':
            norm = node_norms.amax() / norm_max(state.u[0])
        else:
            norm = node_norms[-1] / norm_max(state.u[0])
        return res_nodes, norm

    def compute_end_point(self, state: LevelState, t, dt):
        if not self.coll.right_is_node or self.do_coll_update:
            raise NotImplementedError()
        return state.u[-1]


class SemiImplicitDAE(FullyImplicitDAE):
    """Semi-explicit DAEs: differential variables integrated, algebraic
    variables solved directly (reference semiImplicitDAE.py).  The problem
    declares ``diff_nvars`` (leading components are differential); only the
    differential derivatives are integrated with Q."""

    def _part(self, prob, du):
        return _differential(du, prob.diff_nvars)

    def update_nodes(self, prob, state: LevelState, t, dt, k: int = 0) -> LevelState:
        nd = prob.diff_nvars
        f = self._solve_nodes(prob, state, t, dt, _differential(state.f[1:], nd), prob.solve_system_dae_semi)
        # differential components integrate; algebraic ones come from the solve
        u_nodes = state.u[0] + dt * self._nodes('Q', self.coll.q, _differential(f[1:], nd))
        u_nodes = torch.cat([u_nodes[..., :nd], f[1:, ..., nd:]], dim=-1)
        return LevelState(u=torch.cat([state.u[:1], u_nodes]), f=f, tau=state.tau)


class RungeKuttaDAE:
    """Runge-Kutta methods for fully-implicit DAEs ``0 = F(u, u', t)``
    (reference ``projects/DAE/sweepers/rungeKuttaDAE.py:11-183``).

    The stage unknowns are the derivatives ``U_m``; each stage solves

        0 = F(u0 + dt*sum_{j<=m} a_mj U_j, U_m, t + c_m dt)

    by the problem's DAE Newton (``solve_system_dae``), and the node values
    are recovered as ``u = u0 + dt A U``.  Mixed into a tableau class of
    :mod:`pysdc_tpu_torch.sweepers.runge_kutta` (see the *DAE classes below),
    as the reference composes ``RungeKuttaDAE`` with its tableau classes.

    Like the reference, the step's initial derivative ``f[0]`` is carried on
    the sweeper across steps (``du_init = U_M`` of the previous step; the
    first step uses ``prob.du_exact(t0)``): host state, so the sweeper is
    ``host_stateful`` like the multistep family.
    """

    #: carried initial derivative (reference rungeKuttaDAE.py:84-104)
    host_stateful = True
    graph_capture_blocker = _BLOCKER

    def __init__(self, params: dict):
        super().__init__(params)
        self.du_init = None

    def predict(self, prob, u0, t, dt, random_val: float = 0.0) -> LevelState:
        M = self.coll.num_nodes
        if self.du_init is None:
            self.du_init = prob.du_exact(float(t)).to(u0.dtype)
        zeros = torch.zeros((M,) + tuple(u0.shape), dtype=u0.dtype, device=u0.device)
        return LevelState(u=torch.cat([u0.unsqueeze(0), zeros]), f=torch.cat([self.du_init.unsqueeze(0), zeros]),
                          tau=zeros.clone())

    def update_nodes(self, prob, state: LevelState, t, dt, k: int = 0) -> LevelState:
        M = self.coll.num_nodes
        du_list = list(state.f.unbind(0))
        for m in range(M):
            u_approx = state.u[0]
            for j in range(1, m + 1):
                if self.QI[m + 1, j] != 0.0:
                    u_approx = u_approx + dt * float(self.QI[m + 1, j]) * du_list[j]
            # stage guess: the previous stage's derivative (reference :148)
            du_list[m + 1] = prob.solve_system_dae(
                u_approx, dt * float(self.QI[m + 1, m + 1]), du_list[m], t + dt * float(self.coll.nodes[m + 1]),
            )
        f = torch.stack(du_list)
        u_nodes = state.u[0] + dt * torch.tensordot(self._coeff('q', lambda: self.coll.q, f), f[1:], dims=1)
        self.du_init = f[-1]
        return LevelState(u=torch.cat([state.u[:1], u_nodes]), f=f, tau=state.tau)

    def compute_residual(self, state: LevelState, dt, residual_type: str = 'full_abs', prob=None, t=0.0):
        return FullyImplicitDAE.compute_residual(self, state, dt, residual_type, prob, t)


def _make_rk_dae(name, tableau_cls):
    cls = type(name, (RungeKuttaDAE, getattr(rk, tableau_cls)), {})
    cls.__doc__ = f"{tableau_cls} applied to 0 = F(u, u', t) (reference rungeKuttaDAE.py:170-183)."
    cls.__module__ = __name__
    return cls


BackwardEulerDAE = _make_rk_dae('BackwardEulerDAE', 'BackwardEuler')
TrapezoidalRuleDAE = _make_rk_dae('TrapezoidalRuleDAE', 'CrankNicolson')
DIRK43_2DAE = _make_rk_dae('DIRK43_2DAE', 'DIRK43_2')
EDIRK4DAE = _make_rk_dae('EDIRK4DAE', 'EDIRK4')
