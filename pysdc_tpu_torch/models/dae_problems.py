"""DAE problems F(u, u', t) = 0.

The counterpart of ``pysdc_tpu/models/dae_problems.py`` (reference DAE
project problems, projects/DAE/problems/: simpleDAE.py, pendulum2D.py,
problematicF.py, discontinuousTestDAE.py, transistorAmplifier.py,
synchronousMachine.py, and the ProblemDAE base in
projects/DAE/misc/problemDAE.py).  The node solves run the port's Newton
iteration (:func:`pysdc_tpu_torch.models.odes.newton_solve`) with the
Jacobian of the residual by ``torch.func.jacfwd`` (the JAX package's
``jax.jacfwd``).  ``eval_f`` is written over the last axis, so the nodes of a
residual evaluation ride along as a batch; the unknowns of a node solve are
new tensors built by index arithmetic, never in-place writes.

``newton_trace``, when set to a list, receives the Newton iterations of each
solve (one list of host integers a solve).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pysdc_tpu_torch.core.problem import Problem, WorkCounter
from pysdc_tpu_torch.models.odes import newton_solve


def _time(t, u):
    """A time as the formulas take it: a host float, or times over the batch axes of ``u (..., n)`` (an array or a
    tensor) as a tensor in ``u``'s dtype that broadcasts against ``u[..., 0]``."""
    if isinstance(t, np.ndarray) and t.ndim > 0:
        t = torch.as_tensor(t, device=u.device)
    if isinstance(t, torch.Tensor):
        return t.to(u.dtype).reshape(tuple(t.shape) + (1,) * (u.dim() - 1 - t.dim()))
    return float(t)


def _elementwise(torch_fn, math_fn):
    return lambda t: torch_fn(t) if isinstance(t, torch.Tensor) else math_fn(t)


_exp = _elementwise(torch.exp, math.exp)
_sin = _elementwise(torch.sin, math.sin)
_cos = _elementwise(torch.cos, math.cos)


class DAEProblem(Problem):
    """Base: subclasses implement eval_f(u, du, t) -> residual tensor."""

    #: number of leading differential components (rest are algebraic)
    diff_nvars: int = None

    def __init__(self, nvars, newton_tol=1e-10, newton_maxiter=100, dtype=None, device='cuda'):
        super().__init__(shape=(nvars,), dtype=dtype, device=device)
        self._register(nvars=nvars, newton_tol=newton_tol, newton_maxiter=newton_maxiter)
        self.work_counters['rhs'] = WorkCounter()
        self.work_counters['newton'] = WorkCounter()
        self.newton_failed = torch.zeros((), dtype=torch.bool, device=self.device)
        self.newton_trace = None

    def eval_f(self, u, du, t):
        raise NotImplementedError

    def _vector(self, values):
        return torch.as_tensor(values, dtype=self.dtype, device=self.device)

    def _newton(self, G, w0):
        """Solve ``G(w) = 0`` from ``w0`` the way the JAX package does: Newton on ``w - 1 * (w - G(w)) = 0``, the
        Jacobian of ``w - G(w)`` by forward-mode differentiation."""

        def f(w):
            return w - G(w)

        return newton_solve(f, torch.func.jacfwd(f), torch.zeros_like(w0), 1.0, w0, self.newton_tol,
                            self.newton_maxiter, failed=self.newton_failed, trace=self.newton_trace)

    def solve_system_dae(self, u_approx, factor, du0, t):
        """Solve 0 = F(u_approx + factor*du, du, t) for du (fully implicit;
        reference problemDAE.py:39-80 uses scipy.optimize.root instead)."""
        return self._newton(lambda du: self.eval_f(u_approx + factor * du, du, t), du0)

    def solve_system_dae_semi(self, u_approx, factor, w0, t):
        """Semi-explicit solve: unknowns are the differential derivatives and
        the algebraic variables (reference semiImplicitDAE.py)."""
        nd = self.diff_nvars

        def G(w):
            u_cand = torch.cat([u_approx[..., :nd] + factor * w[..., :nd], w[..., nd:]], dim=-1)
            du_cand = torch.cat([w[..., :nd], torch.zeros_like(w[..., nd:])], dim=-1)
            return self.eval_f(u_cand, du_cand, t)

        return self._newton(G, w0)


class SimpleDAE(DAEProblem):
    """Smooth linear index-2 DAE with known solution (Ascher & Petzold,
    reference simpleDAE.py): u = (exp(t), exp(t)), z = -exp(t)/(2-t)."""

    diff_nvars = 2

    def __init__(self, newton_tol=1e-10, dtype=None, device='cuda'):
        super().__init__(nvars=3, newton_tol=newton_tol, dtype=dtype, device=device)
        self.a = 10.0

    def eval_f(self, u, du, t):
        a = self.a
        t = _time(t, u)
        et = _exp(t)
        return torch.stack(
            [
                -du[..., 0] + (a - 1 / (2 - t)) * u[..., 0] + (2 - t) * a * u[..., 2] + (3 - t) / (2 - t) * et,
                -du[..., 1] + (1 - a) / (t - 2) * u[..., 0] - u[..., 1] + (a - 1) * u[..., 2] + 2 * et,
                (t + 2) * u[..., 0] + (t**2 - 4) * u[..., 1] - (t**2 + t - 2) * et,
            ],
            dim=-1,
        )

    def u_exact(self, t, u_init=None, t_init=None):
        et = math.exp(float(t))
        return self._vector([et, et, -et / (2 - float(t))])

    def du_exact(self, t):
        et = math.exp(float(t))
        return self._vector([et, et, -et * (3 - float(t)) / (2 - float(t)) ** 2])


class Pendulum2D(DAEProblem):
    """Index-3 planar pendulum (reference pendulum2D.py):
    u = (x, y, vx, vy, lambda); constraint x^2 + y^2 = 1."""

    diff_nvars = 4
    g = 9.8

    def __init__(self, newton_tol=1e-10, dtype=None, device='cuda'):
        super().__init__(nvars=5, newton_tol=newton_tol, dtype=dtype, device=device)

    def eval_f(self, u, du, t):
        x, y, vx, vy, lam = u.unbind(-1)
        return torch.stack(
            [
                du[..., 0] - vx,
                du[..., 1] - vy,
                du[..., 2] + x * lam,
                du[..., 3] + y * lam + self.g,
                x**2 + y**2 - 1.0,
            ],
            dim=-1,
        )

    def u_exact(self, t, u_init=None, t_init=None):
        if float(t) != 0.0:
            raise NotImplementedError('initial condition only')
        return self._vector([-1.0, 0.0, 0.0, 0.0, 0.0])


class ProblematicF(DAEProblem):
    """Fully implicit index-2 DAE that defeats many integrators for eta >= 1
    (Ascher & Petzold p.264; reference problematicF.py):
    y + eta t z = sin t;  y' + eta t z' + (1+eta) z = cos t."""

    diff_nvars = 1

    def __init__(self, newton_tol=1e-10, eta=1.0, dtype=None, device='cuda'):
        super().__init__(nvars=2, newton_tol=newton_tol, dtype=dtype, device=device)
        self._register(eta=eta)

    def eval_f(self, u, du, t):
        eta = self.eta
        t = _time(t, u)
        return torch.stack(
            [
                u[..., 0] + eta * t * u[..., 1] - _sin(t),
                du[..., 0] + eta * t * du[..., 1] + (1 + eta) * u[..., 1] - _cos(t),
            ],
            dim=-1,
        )

    def u_exact(self, t, u_init=None, t_init=None):
        return self._vector([math.sin(float(t)), 0.0])

    def du_exact(self, t):
        return self._vector([math.cos(float(t)), 0.0])


class DiscontinuousTestDAE(DAEProblem):
    """Scalar discontinuous DAE with state function h(y) = 2y - 100
    (Lopez & Maset 2022; reference discontinuousTestDAE.py): before the event
    (y, z) = (cosh t, sinh t), frozen afterwards; event at t* = arccosh(50).
    The frozen branch makes a sliding mode: the node values touch the event
    without crossing it, which ``SwitchEstimator(contact_tol=...)`` detects.
    """

    diff_nvars = 1

    def __init__(self, newton_tol=1e-12, dtype=None, device='cuda'):
        super().__init__(nvars=2, newton_tol=newton_tol, dtype=dtype, device=device)
        self._register(t_switch=np.inf, nswitches=0)
        self.t_switch_exact = float(np.arccosh(50.0))

    def eval_f(self, u, du, t):
        y, z = u[..., 0], u[..., 1]
        dy = du[..., 0]
        h = 2.0 * y - 100.0
        stopped = (h >= 0.0) | (_time(t, u) >= self.t_switch)
        return torch.stack([torch.where(stopped, dy, dy - z), y**2 - z**2 - 1.0], dim=-1)

    def u_exact(self, t, u_init=None, t_init=None):
        ts = min(float(t), self.t_switch_exact)
        return self._vector([math.cosh(ts), math.sinh(ts)])

    def du_exact(self, t):
        ts = min(float(t), self.t_switch_exact)
        return self._vector([math.sinh(ts), math.cosh(ts)])

    def get_switching_info(self, u_nodes, t):
        u_nodes = [np.asarray(u.detach().cpu() if isinstance(u, torch.Tensor) else u) for u in u_nodes]
        switch_detected, m_guess = False, -100
        for m in range(1, len(u_nodes)):
            h_prev = 2.0 * u_nodes[m - 1][0] - 100.0
            h_curr = 2.0 * u_nodes[m][0] - 100.0
            if h_prev < 0 and h_curr >= 0:
                switch_detected = True
                m_guess = m - 1
                break
        state_function = [float(2.0 * u[0] - 100.0) for u in u_nodes]
        return switch_detected, m_guess, state_function

    def count_switches(self):
        self.nswitches += 1


def _transistor(u_in):
    return 1e-6 * (torch.exp(u_in / 0.026) - 1.0)


class OneTransistorAmplifier(DAEProblem):
    """One-transistor amplifier, index-1 DAE with 5 unknowns (Hairer/Wanner
    electrical-circuit benchmark; reference transistorAmplifier.py:14-139)."""

    diff_nvars = 5

    def __init__(self, newton_tol=1e-12, dtype=None, device='cuda'):
        super().__init__(nvars=5, newton_tol=newton_tol, dtype=dtype, device=device)

    def eval_f(self, u, du, t):
        u_b, alpha, r_0, r_k = 6.0, 0.99, 1000.0, 9000.0
        c_1, c_2, c_3 = 1e-6, 2e-6, 3e-6
        u_e = 0.4 * _sin(200 * np.pi * _time(t, u))
        tr = _transistor(u[..., 1] - u[..., 2])
        return torch.stack(
            [
                (u_e - u[..., 0]) / r_0 + c_1 * (du[..., 1] - du[..., 0]),
                (u_b - u[..., 1]) / r_k - u[..., 1] / r_k + c_1 * (du[..., 0] - du[..., 1]) - (1 - alpha) * tr,
                tr - u[..., 2] / r_k - c_2 * du[..., 2],
                (u_b - u[..., 3]) / r_k + c_3 * (du[..., 4] - du[..., 3]) - alpha * tr,
                -u[..., 4] / r_k + c_3 * (du[..., 3] - du[..., 4]),
            ],
            dim=-1,
        )

    def u_exact(self, t, u_init=None, t_init=None):
        if float(t) != 0.0:
            raise NotImplementedError('no closed-form solution; t=0 initial condition only')
        return self._vector([0.0, 3.0, 3.0, 6.0, 0.0])


class TwoTransistorAmplifier(DAEProblem):
    """Two-transistor amplifier, index-1 DAE with 8 unknowns (reference
    transistorAmplifier.py:141-280)."""

    diff_nvars = 8

    def __init__(self, newton_tol=1e-12, dtype=None, device='cuda'):
        super().__init__(nvars=8, newton_tol=newton_tol, dtype=dtype, device=device)

    def eval_f(self, u, du, t):
        u_b, alpha, r_0, r_k = 6.0, 0.99, 1000.0, 9000.0
        c_1, c_2, c_3, c_4, c_5 = 1e-6, 2e-6, 3e-6, 4e-6, 5e-6
        u_e = 0.1 * _sin(200 * np.pi * _time(t, u))
        tr_1 = _transistor(u[..., 1] - u[..., 2])
        tr_2 = _transistor(u[..., 4] - u[..., 5])
        return torch.stack(
            [
                (u_e - u[..., 0]) / r_0 - c_1 * (du[..., 0] - du[..., 1]),
                (u_b - u[..., 1]) / r_k - u[..., 1] / r_k + c_1 * (du[..., 0] - du[..., 1]) + (alpha - 1) * tr_1,
                tr_1 - u[..., 2] / r_k - c_2 * du[..., 2],
                (u_b - u[..., 3]) / r_k - c_3 * (du[..., 3] - du[..., 4]) - alpha * tr_1,
                (u_b - u[..., 4]) / r_k - u[..., 4] / r_k + c_3 * (du[..., 3] - du[..., 4]) + (alpha - 1) * tr_2,
                tr_2 - u[..., 5] / r_k - c_4 * du[..., 5],
                (u_b - u[..., 6]) / r_k - c_5 * (du[..., 6] - du[..., 7]) - alpha * tr_2,
                -u[..., 7] / r_k + c_5 * (du[..., 6] - du[..., 7]),
            ],
            dim=-1,
        )

    def u_exact(self, t, u_init=None, t_init=None):
        if float(t) != 0.0:
            raise NotImplementedError('no closed-form solution; t=0 initial condition only')
        return self._vector([0.0, 3.0, 3.0, 6.0, 3.0, 3.0, 6.0, 0.0])


class SynchronousMachineInfiniteBus(DAEProblem):
    """Synchronous generator (Kundur 7th-order machine model) connected to an
    infinite bus, index-1 DAE with 14 unknowns (reference
    projects/DAE/problems/synchronousMachine.py:27-330): 8 differential
    (fluxes, rotor angle, speed) + 6 algebraic (currents).  A mechanical
    torque step at t = 0.05 s perturbs the machine.  The line's complex
    voltage is computed on its real and imaginary parts.
    """

    diff_nvars = 8

    L_d, L_q, L_F, L_D = 1.8099, 1.76, 1.8247, 1.8312
    L_Q1, L_Q2, L_md, L_mq = 2.3352, 1.735, 1.6599, 1.61
    R_s, R_F, R_D, R_Q1, R_Q2 = 0.003, 0.0006, 0.0284, 0.0062, 0.0237
    omega_b = 376.9911184307752
    H_, K_D = 3.525, 0.0
    Z_line = -0.2688022164909709 - 0.15007173591230372j
    E_B, v_F = 0.7, 8.736809687330562e-4
    T_m0, T_m1 = 0.854, 0.354

    def __init__(self, newton_tol=1e-10, dtype=None, device='cuda'):
        super().__init__(nvars=14, newton_tol=newton_tol, dtype=dtype, device=device)

    def eval_f(self, u, du, t):
        psi_d, psi_q, psi_F, psi_D, psi_Q1, psi_Q2, delta_r, omega_m, i_d, i_q, i_F, i_D, i_Q1, i_Q2 = u.unbind(-1)
        t = _time(t, u)
        if isinstance(t, torch.Tensor):
            T_m = torch.where(t >= 0.05, torch.full_like(t, self.T_m1), torch.full_like(t, self.T_m0))
        else:
            T_m = self.T_m1 if t >= 0.05 else self.T_m0

        sin_d, cos_d = torch.sin(delta_r), torch.cos(delta_r)
        I_Re = i_d * sin_d + i_q * cos_d
        I_Im = -i_d * cos_d + i_q * sin_d
        # V = E_B - Z (-1) I, with the product (-Z) I written out on real and imaginary parts
        zr, zi = -self.Z_line.real, -self.Z_line.imag
        V_Re = self.E_B - (zr * I_Re - zi * I_Im)
        V_Im = -(zr * I_Im + zi * I_Re)
        v_d = V_Re * sin_d - V_Im * cos_d
        v_q = V_Re * cos_d + V_Im * sin_d

        wb = self.omega_b
        return torch.stack(
            [
                -du[..., 0] + wb * (v_d - self.R_s * i_d + omega_m * psi_q),
                -du[..., 1] + wb * (v_q - self.R_s * i_q - omega_m * psi_d),
                -du[..., 2] + wb * (self.v_F - self.R_F * i_F),
                -du[..., 3] - wb * self.R_D * i_D,
                -du[..., 4] - wb * self.R_Q1 * i_Q1,
                -du[..., 5] - wb * self.R_Q2 * i_Q2,
                -du[..., 6] + wb * (omega_m - 1.0),
                -du[..., 7] + 1.0 / (2 * self.H_) * (T_m - (psi_q * i_d - psi_d * i_q)
                                                     - self.K_D * wb * (omega_m - 1.0)),
                -psi_d + self.L_d * i_d + self.L_md * i_F + self.L_md * i_D,
                -psi_q + self.L_q * i_q + self.L_mq * i_Q1 + self.L_mq * i_Q2,
                -psi_F + self.L_md * i_d + self.L_F * i_F + self.L_md * i_D,
                -psi_D + self.L_md * i_d + self.L_md * i_F + self.L_D * i_D,
                -psi_Q1 + self.L_mq * i_q + self.L_Q1 * i_Q1 + self.L_mq * i_Q2,
                -psi_Q2 + self.L_mq * i_q + self.L_mq * i_Q1 + self.L_Q2 * i_Q2,
            ],
            dim=-1,
        )

    def u_exact(self, t, u_init=None, t_init=None):
        if float(t) != 0.0:
            raise NotImplementedError('steady-state initial condition only (reference :282-305)')
        return self._vector([
            0.7770802016688648, -0.6337183129426077, 1.152966888216155, 0.9129958488040036,
            -0.5797082294536264, -0.579708229453273,
            39.1 * np.pi / 180.0, 1.0,
            -0.9061043142342473, -0.36006722326230495, 1.45613494788927, 0.0, 0.0, 0.0,
        ])
