"""Runge-Kutta-Nystrom methods for second-order ODEs x'' = f(x, v).

The counterpart of ``pysdc_tpu/sweepers/rkn.py`` (reference
``RungeKuttaNystrom`` family,
``implementations/sweeper_classes/Runge_Kutta_Nystrom.py:10-245``): the
classical explicit RKN scheme (Hairer-Norsett-Wanner II.14) and
velocity-Verlet as one-sweep direct solvers on
:class:`~pysdc_tpu_torch.models.particles.Particles` states, on the port's
:class:`~pysdc_tpu_torch.sweepers.runge_kutta.RungeKutta`.  Two tableaus act at
once: ``matrix``/``weights`` advance velocities, ``matrix_bar``/``weights_bar``
advance positions with the dt^2-weighted accelerations.

Velocity arguments at the stages are built from the velocity tableau, so
mildly velocity-dependent forces (drag) are handled explicitly; strongly
velocity-dependent forces (Lorentz) belong to the Boris sweeper.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.state import LevelState, map_components
from pysdc_tpu_torch.models.particles import Particles
from pysdc_tpu_torch.sweepers.runge_kutta import RungeKutta
from pysdc_tpu_torch.sweepers.verlet import spread_particles, zero_tau


class RungeKuttaNystrom(RungeKutta):
    """Base RKN sweeper; subclasses define nodes/weights/matrix plus the
    position-update pair weights_bar/matrix_bar as class attrs."""

    weights_bar: np.ndarray = None
    matrix_bar: np.ndarray = None

    def predict(self, prob, u0: Particles, t, dt, random_val: float = 0.0) -> LevelState:
        s = self.coll.num_nodes
        f0 = prob.eval_f(u0, t)
        f = f0.unsqueeze(0).repeat((s + 1,) + (1,) * f0.dim())
        return LevelState(u=spread_particles(u0, s + 1), f=f, tau=zero_tau(u0, s))

    def update_nodes(self, prob, state: LevelState, t, dt, k: int = 0) -> LevelState:
        s = self.coll.num_nodes
        x0 = state.u.pos[0]
        v0 = state.u.vel[0]
        f_list = [state.f[0]]  # f_list[j + 1] is stage j's acceleration
        pos_list, vel_list = [x0], [v0]
        for m in range(s):
            c_m = self.coll.nodes[m + 1]
            pos = x0 + dt * c_m * v0
            vel = v0
            for j in range(m):
                if self.matrix_bar[m, j] != 0.0:
                    pos = pos + dt**2 * self.matrix_bar[m, j] * f_list[j + 1]
                if self.matrix[m, j] != 0.0:
                    vel = vel + dt * self.matrix[m, j] * f_list[j + 1]
            f_list.append(prob.eval_f(Particles(pos=pos, vel=vel), t + dt * c_m))
            pos_list.append(pos)
            vel_list.append(vel)

        # solution update from the stage accelerations
        fstack = torch.stack(f_list[1:])
        wb = self._coeff('weights_bar', lambda: self.weights_bar, fstack)
        w = self._coeff('weights', lambda: self.weights, fstack)
        pos_list[-1] = x0 + dt * v0 + dt**2 * torch.tensordot(wb, fstack, dims=1)
        vel_list[-1] = v0 + dt * torch.tensordot(w, fstack, dims=1)

        u = Particles(pos=torch.stack(pos_list), vel=torch.stack(vel_list))
        return LevelState(u=u, f=torch.stack(f_list), tau=state.tau)

    def integrate(self, state: LevelState, dt):
        f = state.f[1:]
        vel = dt * torch.tensordot(self._coeff('q', lambda: self.coll.q, f), f, dims=1)
        return Particles(pos=torch.zeros_like(vel), vel=vel)

    def compute_residual(self, state: LevelState, dt, residual_type='full_abs', t=0.0):
        # direct solver: the residual never gates anything (restol is forced
        # off by Level for is_direct_solver sweepers, reference-consistent)
        return state.tau, torch.zeros((), dtype=state.u.pos.dtype, device=state.u.pos.device)

    def compute_end_point(self, state: LevelState, t, dt):
        return map_components(lambda leaf: leaf[-1], state.u)


class RKN4(RungeKuttaNystrom):
    """Classical 4-stage, order-4 RKN method (reference
    Runge_Kutta_Nystrom.py:189-219: nodes [0, 1/2, 1/2, 1], velocity weights
    [1,2,2,1]/6, position weights [1,1,1,0]/6)."""

    nodes = np.array([0.0, 0.5, 0.5, 1.0])
    weights = np.array([1.0, 2.0, 2.0, 1.0]) / 6.0
    weights_bar = np.array([1.0, 1.0, 1.0, 0.0]) / 6.0
    matrix = np.zeros((4, 4))
    matrix[1, 0] = 0.5
    matrix[2, 1] = 0.5
    matrix[3, 2] = 1.0
    matrix_bar = np.zeros((4, 4))
    matrix_bar[1, 0] = 1.0 / 8.0
    matrix_bar[2, 0] = 1.0 / 8.0
    matrix_bar[3, 2] = 0.5


class VelocityVerletRKN(RungeKuttaNystrom):
    """Velocity-Verlet as a 2-stage RKN scheme (reference
    Runge_Kutta_Nystrom.py:222-245); explicit variant for
    velocity-independent or weakly velocity-dependent forces."""

    nodes = np.array([0.0, 1.0])
    weights = np.array([0.5, 0.5])
    weights_bar = np.array([0.5, 0.0])
    matrix = np.zeros((2, 2))
    matrix[1, 0] = 1.0
    matrix_bar = np.zeros((2, 2))
    matrix_bar[1, 0] = 0.5
