"""Power-electronics problems with discontinuous right-hand sides.

The counterpart of ``pysdc_tpu/models/power_electronics.py``; counterparts of
the reference ``Battery.py`` (battery / battery_implicit /
battery_n_capacitors), ``Piline.py`` and ``BuckConverter.py``
(implementations/problem_classes): piecewise-linear circuit ODEs whose
regime switches either on state thresholds (battery: capacitor voltage
crossing V_ref -> detected by the ``SwitchEstimator``) or on time (buck
converter duty cycle).

A circuit's state is the LAST axis of ``u``; every axis in front of it is a
batch (collocation nodes, the time steps of a block), so one call serves a
batch.  The regime is chosen per system with ``torch.where`` (both regimes
are tiny linear systems).  The event time ``t_switch`` is a host float, or a
``(P,)`` tensor with one entry per step of a block
(``ShardedController._block_overrides``).
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.problem import Problem, WorkCounter
from pysdc_tpu_torch.core.state import IMEX
from pysdc_tpu_torch.models.odes import _behind, _time, per_step


def _factor(factor, rhs):
    """A solve's factor (a number, or one per system of the batch) shaped against ``rhs (..., n)``."""
    if isinstance(factor, np.ndarray):
        factor = torch.as_tensor(factor, dtype=rhs.dtype, device=rhs.device)
    return _behind(factor, rhs, 1)


def _solve_shifted(A, factor, rhs):
    """``(I - factor A) x = rhs`` over the last axis; ``A (..., n, n)`` and
    ``factor`` per system of the batch."""
    n = rhs.shape[-1]
    eye = torch.eye(n, dtype=rhs.dtype, device=rhs.device)
    fac = factor.unsqueeze(-1) if isinstance(factor, torch.Tensor) and factor.dim() > 0 else factor
    lhs = (eye - fac * A.to(rhs.dtype)).expand(rhs.shape + (n,))
    return torch.linalg.solve(lhs, rhs)


class _Circuit(Problem):
    f_kind = 'imex'

    def _vector(self, values):
        return torch.tensor(values, dtype=self.dtype, device=self.device)

    def eval_f_batched(self, u, t):
        """``eval_f`` is written over the last axis: the node axis rides along."""
        return self.eval_f(u, t)


class Battery(_Circuit):
    """Battery drain model, one capacitor: u = [i_L, v_C]
    (reference Battery.py:303-430).  IMEX split like the reference."""

    def __init__(self, Vs=5.0, Rs=0.5, C=1.0, R=1.0, L=1.0, alpha=1.2, V_ref=1.0, dtype=None, device='cuda'):
        super().__init__(shape=(2,), dtype=dtype, device=device)
        C_arr = np.atleast_1d(C)
        V_arr = np.atleast_1d(V_ref)
        self._register(Vs=Vs, Rs=Rs, C=C_arr, R=R, L=L, alpha=alpha, V_ref=V_arr,
                       t_switch=np.inf, nswitches=0)
        self.work_counters['rhs'] = WorkCounter()

    def _regime(self, vC, t):
        """True once the capacitor is drained (switched to the source); ``vC (..., 1)``."""
        return (vC - float(self.V_ref[0]) <= 0) | (_time(t, vC) >= per_step(self.t_switch, 1))

    def eval_f(self, u, t):
        switched = self._regime(u[..., 1:], t)
        # regime 1 (capacitor): dvC/dt = -vC/(C R); regime 2: diL/dt = -(Rs+R)/L iL + Vs/L
        lam_src = torch.cat([-(self.Rs + self.R) / self.L * u[..., :1], 0.0 * u[..., 1:]], dim=-1)
        lam_cap = torch.cat([0.0 * u[..., :1], -1.0 / (float(self.C[0]) * self.R) * u[..., 1:]], dim=-1)
        impl = torch.where(switched, lam_src, lam_cap)
        expl = torch.where(switched, self._vector([self.Vs / self.L, 0.0]), torch.zeros_like(u))
        return IMEX(impl=impl, expl=expl)

    def solve_system(self, rhs, factor, u0, t):
        switched = self._regime(rhs[..., 1:], t)
        diag_src = self._vector([-(self.Rs + self.R) / self.L, 0.0])
        diag_cap = self._vector([0.0, -1.0 / (float(self.C[0]) * self.R)])
        return rhs / (1 - _factor(factor, rhs) * torch.where(switched, diag_src, diag_cap))

    def u_exact(self, t, u_init=None, t_init=None):
        assert float(t) == 0, 'u_exact only valid for t=0'
        return self._vector([0.0, self.alpha * float(self.V_ref[0])])

    # -- event interface (reference Battery.py:236-287) ------------------
    def get_switching_info(self, u_nodes, t):
        """u_nodes: the node values (numpy arrays or tensors).  Returns
        (switch_detected, m_guess, state_function values at the nodes)."""
        u_nodes = [np.asarray(u.detach().cpu() if isinstance(u, torch.Tensor) else u) for u in u_nodes]
        switch_detected, m_guess = False, -100
        for m in range(1, len(u_nodes)):
            h_prev = u_nodes[m - 1][1] - self.V_ref[0]
            h_curr = u_nodes[m][1] - self.V_ref[0]
            if h_prev > 0 and h_curr <= 0:
                switch_detected = True
                m_guess = m - 1
                break
        state_function = [float(u[1] - self.V_ref[0]) for u in u_nodes]
        return switch_detected, m_guess, state_function

    def count_switches(self):
        self.nswitches += 1


class Piline(_Circuit):
    """Pi-line RLC model, u = [v_C1, v_C2, i_Lp] (reference Piline.py):
    a plain linear system — useful as the smooth power-electronics baseline."""

    def __init__(self, Vs=100.0, Rs=1.0, C1=1.0, Rpi=0.2, C2=1.0, Lpi=1.0, Rl=5.0, dtype=None, device='cuda'):
        super().__init__(shape=(3,), dtype=dtype, device=device)
        self._register(Vs=Vs, Rs=Rs, C1=C1, Rpi=Rpi, C2=C2, Lpi=Lpi, Rl=Rl)
        A = np.array(
            [
                [-1 / (Rs * C1), 0.0, -1 / C1],
                [0.0, -1 / (Rl * C2), 1 / C2],
                [1 / Lpi, -1 / Lpi, -Rpi / Lpi],
            ]
        )
        self.A = torch.as_tensor(A, dtype=self.dtype, device=self.device)
        self.work_counters['rhs'] = WorkCounter()

    def eval_f(self, u, t):
        expl = torch.zeros_like(u)
        expl[..., 0] = self.Vs / (self.Rs * self.C1)
        return IMEX(impl=u @ self.A.to(u.dtype).T, expl=expl)

    def solve_system(self, rhs, factor, u0, t):
        return _solve_shifted(self.A, _factor(factor, rhs), rhs)

    def u_exact(self, t, u_init=None, t_init=0.0):
        """Steady state for t -> inf; initial condition at t=0
        (reference uses [0, 0, 0] start)."""
        if float(t) == 0.0:
            return torch.zeros(3, dtype=self.dtype, device=self.device)
        raise NotImplementedError('only the t=0 initial condition is provided')


class BuckConverter(_Circuit):
    """Buck (step-down) converter with time-based duty cycling
    (reference BuckConverter.py): switching between charging/discharging
    regimes at fixed fractions of the duty cycle period."""

    def __init__(self, duty=0.5, fsw=1e3, Vs=10.0, Rs=0.5, C1=1e-3, Rp=0.01, L1=1e-3,
                 C2=1e-3, Rl=10.0, dtype=None, device='cuda'):
        super().__init__(shape=(3,), dtype=dtype, device=device)
        self._register(duty=duty, fsw=fsw, Vs=Vs, Rs=Rs, C1=C1, Rp=Rp, L1=L1, C2=C2, Rl=Rl)
        # closed-switch system matrix (source connected)
        A1 = np.array(
            [
                [-1 / (Rs * C1), 0.0, -1 / C1],
                [0.0, -1 / (Rl * C2), 1 / C2],
                [1 / L1, -1 / L1, 0.0],
            ]
        )
        # open-switch matrix (freewheeling diode)
        A2 = np.array(
            [
                [-1 / (Rs * C1), 0.0, 0.0],
                [0.0, -1 / (Rl * C2), 1 / C2],
                [0.0, -1 / L1, 0.0],
            ]
        )
        self.A1 = torch.as_tensor(A1, dtype=self.dtype, device=self.device)
        self.A2 = torch.as_tensor(A2, dtype=self.dtype, device=self.device)
        self.work_counters['rhs'] = WorkCounter()

    def _A(self, t, like):
        """The system matrix per system of the batch, ``(..., 3, 3)``."""
        Tsw = 1.0 / self.fsw
        tt = _time(t, like)
        if isinstance(tt, torch.Tensor):
            closed = (torch.remainder(tt, Tsw) <= self.duty * Tsw).unsqueeze(-1)
            return torch.where(closed, self.A1, self.A2)
        return self.A1 if float(np.mod(tt, Tsw)) <= self.duty * Tsw else self.A2

    def eval_f(self, u, t):
        A = self._A(t, u).to(u.dtype)
        expl = torch.zeros_like(u)
        expl[..., 0] = self.Vs / (self.Rs * self.C1)
        return IMEX(impl=(A @ u.unsqueeze(-1)).squeeze(-1), expl=expl)

    def solve_system(self, rhs, factor, u0, t):
        return _solve_shifted(self._A(t, rhs), _factor(factor, rhs), rhs)

    def u_exact(self, t, u_init=None, t_init=None):
        assert float(t) == 0
        return torch.zeros(3, dtype=self.dtype, device=self.device)


class BatteryNCapacitors(_Circuit):
    """Battery drain with N capacitors (reference Battery.py:8-301):
    u = [i_L, v_C1..v_CN]; each capacitor discharges until its voltage hits
    V_ref, then the next one (finally the source) takes over."""

    def __init__(self, ncapacitors=2, Vs=5.0, Rs=0.5, C=None, R=1.0, L=1.0, alpha=1.2,
                 V_ref=None, dtype=None, device='cuda'):
        n = ncapacitors
        super().__init__(shape=(n + 1,), dtype=dtype, device=device)
        C_arr = np.ones(n) if C is None else np.atleast_1d(C)
        V_arr = np.ones(n) if V_ref is None else np.atleast_1d(V_ref)
        self._register(ncapacitors=n, Vs=Vs, Rs=Rs, C=C_arr, R=R, L=L, alpha=alpha,
                       V_ref=V_arr, t_switch=np.inf, nswitches=0)
        # per-regime system matrices (reference get_problem_dict)
        v = np.zeros(n + 1)
        v[0] = 1
        A_list, b_list = [], []
        for k in range(n):
            A_list.append(np.diag(-1 / (C_arr[k] * R) * np.roll(v, k + 1)))
            b_list.append(np.zeros(n + 1))
        A_list.append(np.diag(-(Rs + R) / L * v))
        b_list.append(Vs / L * v)
        self.A_all = torch.as_tensor(np.stack(A_list), dtype=self.dtype, device=self.device)
        self.b_all = torch.as_tensor(np.stack(b_list), dtype=self.dtype, device=self.device)
        self._V_ref = torch.as_tensor(V_arr, dtype=self.dtype, device=self.device)
        self.work_counters['rhs'] = WorkCounter()

    def _regime_index(self, u):
        """Number of drained capacitors = index of the active regime, per system of the batch."""
        return ((u[..., 1:] - self._V_ref.to(u.dtype)) <= 0).sum(dim=-1)

    def eval_f(self, u, t):
        k = self._regime_index(u)
        A = self.A_all[k].to(u.dtype)
        b = self.b_all[k].to(u.dtype)
        return IMEX(impl=(A @ u.unsqueeze(-1)).squeeze(-1), expl=b)

    def solve_system(self, rhs, factor, u0, t):
        return _solve_shifted(self.A_all[self._regime_index(rhs)], _factor(factor, rhs), rhs)

    def u_exact(self, t, u_init=None, t_init=None):
        assert float(t) == 0
        u = np.zeros(self.ncapacitors + 1)
        u[1:] = self.alpha * np.asarray(self.V_ref)
        return torch.as_tensor(u, dtype=self.dtype, device=self.device)

    def get_switching_info(self, u_nodes, t):
        u_nodes = [np.asarray(u.detach().cpu() if isinstance(u, torch.Tensor) else u) for u in u_nodes]
        switch_detected, m_guess, k_detected = False, -100, 1
        for m in range(1, len(u_nodes)):
            for k in range(1, self.ncapacitors + 1):
                h_prev = u_nodes[m - 1][k] - self.V_ref[k - 1]
                h_curr = u_nodes[m][k] - self.V_ref[k - 1]
                if h_prev > 0 and h_curr <= 0:
                    switch_detected, m_guess, k_detected = True, m - 1, k
                    break
            if switch_detected:
                break
        state_function = [float(u[k_detected] - self.V_ref[k_detected - 1]) for u in u_nodes]
        return switch_detected, m_guess, state_function

    def count_switches(self):
        self.nswitches += 1
