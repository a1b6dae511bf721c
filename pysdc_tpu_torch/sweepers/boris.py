"""Boris-SDC sweeper for charged particles in electromagnetic fields.

The counterpart of ``pysdc_tpu/sweepers/boris.py`` (reference
``boris_2nd_order``, ``implementations/sweeper_classes/boris_2nd_order.py:6-314``):
node-to-node S/ST/SQ/Sx matrices derived from the Verlet Q-family, explicit
position update, and the Boris rotation for the velocity (velocity-dependent
Lorentz force handled without a linear solve).  The RHS container is the
problem's field type (e.g. :class:`~pysdc_tpu_torch.models.particles.EMFields`);
the problem provides ``build_f`` (fields -> acceleration, taking the node axis
as a leading batch axis) and ``boris_solver``.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.state import LevelState, map_components
from pysdc_tpu_torch.core.sweeper import Sweeper
from pysdc_tpu_torch.models.particles import Particles
from pysdc_tpu_torch.sweepers.verlet import particles_residual, spread_particles, zero_tau


class BorisSDC(Sweeper):
    def __init__(self, params: dict):
        params = dict(params)
        params.setdefault('QI', 'IE')
        params.setdefault('QE', 'EE')
        params.setdefault('quad_type', 'LOBATTO')
        super().__init__(params)

        QI = self.get_Qdelta_implicit(params['QI'])
        QE = self.get_Qdelta_explicit(params['QE'])
        coll = self.coll
        QT = 0.5 * (QI + QE)
        Qx = QE @ QT + 0.5 * QE * QE
        M = coll.num_nodes

        Sx = np.zeros_like(coll.Qmat)
        ST = np.zeros_like(coll.Qmat)
        S = np.zeros_like(coll.Qmat)
        Sx[0, :] = Qx[0, :]
        ST[0, :] = QT[0, :]
        S[0, :] = coll.Qmat[0, :]
        for m in range(M):
            Sx[m + 1, :] = Qx[m + 1, :] - Qx[m, :]
            ST[m + 1, :] = QT[m + 1, :] - QT[m, :]
            S[m + 1, :] = coll.Qmat[m + 1, :] - coll.Qmat[m, :]
        self.S, self.ST, self.Sx = S, ST, Sx
        self.SQ = S @ coll.Qmat
        self.QQ = coll.Qmat @ coll.Qmat
        self.QI, self.QT, self.Qx = QI, QT, Qx
        self.qQ = coll.weights @ coll.Qmat[1:, 1:]

    def _prob(self, prob):
        """The problem: passed explicitly or that of the level this sweeper is
        attached to (integrate, residual and end point take no problem in the
        base protocol)."""
        return prob if prob is not None else self.level.prob

    def _nm(self, key, W, x):
        return torch.tensordot(self._coeff(key, lambda: W, x), x, dims=1)

    # -- helpers ---------------------------------------------------------
    def _build_f_all(self, prob, state: LevelState, t, dt):
        """Accelerations at nodes 0..M from the stored fields (``build_f`` over the node axis)."""
        nodes_t = np.concatenate([[t], t + dt * np.asarray(self.coll.nodes)])
        return prob.build_f(state.f, state.u, nodes_t)

    def predict(self, prob, u0: Particles, t, dt, random_val: float = 0.0) -> LevelState:
        M = self.coll.num_nodes
        f0 = prob.eval_f(u0, t)
        return LevelState(u=spread_particles(u0, M + 1), f=spread_particles(f0, M + 1), tau=zero_tau(u0, M))

    def integrate(self, state: LevelState, dt, prob=None, t=0.0):
        """0-to-node integrals (reference boris_2nd_order.py:156-180)."""
        fa = self._build_f_all(self._prob(prob), state, t, dt)[1:]  # (M, 3, N)
        v0 = state.u.vel[0]
        rowsum = self._coeff('rowsum', lambda: self.coll.q.sum(axis=1), fa)
        pos = dt * (dt * self._nm('QQ', self.QQ[1:, 1:], fa))
        pos = pos + dt * rowsum.reshape((-1,) + (1,) * v0.dim()) * v0
        vel = dt * self._nm('q', self.coll.q, fa)
        return Particles(pos=pos, vel=vel)

    def update_nodes(self, prob, state: LevelState, t, dt, k: int = 0) -> LevelState:
        M = self.coll.num_nodes
        ts = self.node_times(t, dt)
        fa = self._build_f_all(prob, state, t, dt)  # (M+1, 3, N) accelerations

        # known parts: node-to-node integrals minus preconditioner parts
        int_pos = dt * (dt * self._nm('SQ-Sx', self.SQ[1:, :] - self.Sx[1:, :], fa)) + state.tau.pos
        int_vel = dt * self._nm('S-ST', self.S[1:, :] - self.ST[1:, :], fa) + state.tau.vel
        # tau is 0-to-node; convert to node-to-node (reference :124-127)
        int_pos = torch.cat([int_pos[:1], int_pos[1:] + (-state.tau.pos[:-1])])
        int_vel = torch.cat([int_vel[:1], int_vel[1:] + (-state.tau.vel[:-1])])

        pos_list = list(state.u.pos.unbind(0))
        vel_list = list(state.u.vel.unbind(0))
        f_list = [map_components(lambda leaf: leaf[m], state.f) for m in range(M + 1)]
        fa_new = list(fa.unbind(0))
        qi = np.diag(self.QI)

        for m in range(M):
            tmp_pos = int_pos[m]
            tmp_vel = int_vel[m]
            for j in range(m + 1):
                if self.Sx[m + 1, j] != 0.0:
                    tmp_pos = tmp_pos + dt * (dt * self.Sx[m + 1, j] * fa_new[j])
            pos_list[m + 1] = tmp_pos + pos_list[m] + dt * self.coll.delta_m[m] * vel_list[0]

            t_node = self.node_time(ts, m)
            f_list[m + 1] = prob.eval_f(Particles(pos=pos_list[m + 1], vel=vel_list[m + 1]), t_node)

            old_parts = Particles(pos=pos_list[m], vel=vel_list[m])
            vel_list[m + 1] = prob.boris_solver(tmp_vel, dt * qi[m + 1], f_list[m], f_list[m + 1], old_parts)
            fa_new[m + 1] = prob.build_f(f_list[m + 1], Particles(pos=pos_list[m + 1], vel=vel_list[m + 1]), t_node)

        u = Particles(pos=torch.stack(pos_list), vel=torch.stack(vel_list))
        f = map_components(lambda *leaves: torch.stack(leaves), *f_list)
        return LevelState(u=u, f=f, tau=state.tau)

    def compute_residual(self, state: LevelState, dt, residual_type: str = 'full_abs', prob=None, t=0.0):
        return particles_residual(self.integrate(state, dt, prob=prob, t=t), state, residual_type)

    def compute_end_point(self, state: LevelState, t, dt, prob=None):
        if self.coll.right_is_node and not self.do_coll_update:
            return map_components(lambda leaf: leaf[-1], state.u)
        fa = self._build_f_all(self._prob(prob), state, t, dt)[1:]
        x0, v0 = state.u.pos[0], state.u.vel[0]
        wsum = float(np.sum(self.coll.weights))
        pos = x0 + dt * (dt * torch.tensordot(self._coeff('qQ', lambda: self.qQ, fa), fa, dims=1)) + dt * wsum * v0
        vel = v0 + dt * torch.tensordot(self._coeff('weights', lambda: self.coll.weights, fa), fa, dims=1)
        return Particles(pos=pos + state.tau.pos[-1], vel=vel + state.tau.vel[-1])
