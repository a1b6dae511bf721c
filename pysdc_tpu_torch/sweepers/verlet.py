"""Velocity-Verlet SDC sweeper for second-order problems.

The counterpart of ``pysdc_tpu/sweepers/verlet.py`` (reference ``verlet``,
``implementations/sweeper_classes/verlet.py:6-207``): position/velocity
updates with the QQ (second-order collocation), QT (trapezoidal) and Qx
(Euler half-step) matrices from the Boris-SDC paper; Gauss-Lobatto nodes get
the symplectic IIIA/IIIB pairing trick.

State: ``u`` is a :class:`~pysdc_tpu_torch.models.particles.Particles` with
``(M+1)``-leading-axis leaves; ``f`` is the acceleration tensor.  The
integral, the residual and the end point are this sweeper's own: a
``Particles`` value never reaches ``f_total``.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.errors import ParameterError
from pysdc_tpu_torch.core.state import LevelState, map_components, norm_max
from pysdc_tpu_torch.core.sweeper import Sweeper
from pysdc_tpu_torch.models.particles import Particles


def spread_particles(u0: Particles, n: int) -> Particles:
    """``u0`` repeated along a new leading axis of ``n`` entries."""
    return map_components(lambda leaf: leaf.unsqueeze(0).repeat((n,) + (1,) * leaf.dim()), u0)


def zero_tau(u0: Particles, M: int) -> Particles:
    return map_components(lambda leaf: torch.zeros((M,) + tuple(leaf.shape), dtype=leaf.dtype, device=leaf.device),
                          u0)


def particles_residual(integral: Particles, state: LevelState, residual_type: str):
    """The residual ``integral + tau + u0 - u`` of a ``Particles`` state and its norm: per node the larger of the
    position's and the velocity's max norms (reference verlet.py / boris_2nd_order.py compute_residual)."""
    u = state.u
    res = Particles(pos=integral.pos + state.tau.pos + u.pos[0].unsqueeze(0) - u.pos[1:],
                    vel=integral.vel + state.tau.vel + u.vel[0].unsqueeze(0) - u.vel[1:])
    node_norms = torch.maximum(res.pos.abs().flatten(1).amax(dim=1), res.vel.abs().flatten(1).amax(dim=1))
    if residual_type == 'full_abs':
        norm = node_norms.amax()
    elif residual_type == 'last_abs':
        norm = node_norms[-1]
    elif residual_type in ('full_rel', 'last_rel'):
        norm = (node_norms.amax() if residual_type == 'full_rel' else node_norms[-1]) / norm_max(u)
    else:
        raise ParameterError(f'residual_type = {residual_type} not implemented, choose full_abs, last_abs, full_rel '
                             f'or last_rel')
    return res, norm


class VerletSweeper(Sweeper):
    def __init__(self, params: dict):
        params = dict(params)
        params.setdefault('QI', 'IE')
        params.setdefault('QE', 'EE')
        params.setdefault('node_type', 'LEGENDRE')
        params.setdefault('quad_type', 'LOBATTO')
        super().__init__(params)

        QI = self.get_Qdelta_implicit(params['QI'])
        QE = self.get_Qdelta_explicit(params['QE'])
        self.QT = 0.5 * (QI + QE)
        self.Qx = QE @ self.QT + 0.5 * QE * QE
        coll = self.coll
        QQ = np.zeros_like(coll.Qmat)
        if coll.node_type == 'LEGENDRE' and coll.quad_type == 'LOBATTO':
            # Lobatto IIIA/IIIB pairing: symplectic (reference verlet.py:63-71)
            M = coll.num_nodes
            for m in range(M):
                for n in range(M):
                    QQ[m + 1, n + 1] = coll.weights[n] * (1.0 - coll.Qmat[n + 1, m + 1] / coll.weights[m])
            QQ = coll.Qmat @ QQ
        else:
            QQ = coll.Qmat @ coll.Qmat
        self.QQ = QQ
        self.qQ = coll.weights @ coll.Qmat[1:, 1:]

    def _nm(self, key, W, x):
        """The coefficient table ``W`` applied along the leading node axis of ``x``."""
        return torch.tensordot(self._coeff(key, lambda: W, x), x, dims=1)

    # -- protocol -------------------------------------------------------
    def predict(self, prob, u0: Particles, t, dt, random_val: float = 0.0) -> LevelState:
        M = self.coll.num_nodes
        f0 = prob.eval_f(u0, t)
        f = f0.unsqueeze(0).repeat((M + 1,) + (1,) * f0.dim())
        return LevelState(u=spread_particles(u0, M + 1), f=f, tau=zero_tau(u0, M))

    def integrate(self, state: LevelState, dt):
        """Particles integral (reference verlet.py:151-173): positions get
        dt^2 QQ f + dt Q (column-sums) u0.vel, velocities dt Q f."""
        f = state.f[1:]
        v0 = state.u.vel[0]
        rowsum = self._coeff('rowsum', lambda: self.coll.q.sum(axis=1), f)
        pos = dt * (dt * self._nm('QQ', self.QQ[1:, 1:], f)) + dt * rowsum.reshape((-1,) + (1,) * v0.dim()) * v0
        vel = dt * self._nm('q', self.coll.q, f)
        return Particles(pos=pos, vel=vel)

    def update_nodes(self, prob, state: LevelState, t, dt, k: int = 0) -> LevelState:
        M = self.coll.num_nodes
        ts = self.node_times(t, dt)
        f = state.f[1:]
        integral = self.integrate(state, dt)
        # subtract preconditioner part of the old iterate, add u0 and tau
        pos_known = integral.pos - dt * (dt * self._nm('Qx', self.Qx[1:, 1:], f)) + state.u.pos[0] + state.tau.pos
        vel_known = integral.vel - dt * self._nm('QT', self.QT[1:, 1:], f) + state.u.vel[0] + state.tau.vel

        pos_list = list(state.u.pos.unbind(0))
        vel_list = list(state.u.vel.unbind(0))
        f_list = list(state.f.unbind(0))
        for m in range(M):
            pos_new = pos_known[m]
            vel_new = vel_known[m]
            for j in range(1, m + 1):
                if self.Qx[m + 1, j] != 0.0:
                    pos_new = pos_new + dt * (dt * self.Qx[m + 1, j] * f_list[j])
                if self.QT[m + 1, j] != 0.0:
                    vel_new = vel_new + dt * self.QT[m + 1, j] * f_list[j]
            pos_list[m + 1] = pos_new
            f_list[m + 1] = prob.eval_f(Particles(pos=pos_new, vel=vel_new), self.node_time(ts, m))
            vel_list[m + 1] = vel_new + dt * self.QT[m + 1, m + 1] * f_list[m + 1]

        u = Particles(pos=torch.stack(pos_list), vel=torch.stack(vel_list))
        return LevelState(u=u, f=torch.stack(f_list), tau=state.tau)

    def compute_residual(self, state: LevelState, dt, residual_type: str = 'full_abs', t=0.0):
        return particles_residual(self.integrate(state, dt), state, residual_type)

    def compute_end_point(self, state: LevelState, t, dt):
        if self.coll.right_is_node and not self.do_coll_update:
            return map_components(lambda leaf: leaf[-1], state.u)
        f = state.f[1:]
        x0, v0 = state.u.pos[0], state.u.vel[0]
        wsum = float(np.sum(self.coll.weights))
        pos = x0 + dt * (dt * torch.tensordot(self._coeff('qQ', lambda: self.qQ, f), f, dims=1)) + dt * wsum * v0
        vel = v0 + dt * torch.tensordot(self._coeff('weights', lambda: self.coll.weights, f), f, dims=1)
        return Particles(pos=pos + state.tau.pos[-1], vel=vel + state.tau.vel[-1])
