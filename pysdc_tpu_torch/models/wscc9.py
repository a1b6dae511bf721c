"""WSCC 9-bus / 3-machine power system as an index-1 DAE.

The counterpart of ``pysdc_tpu/models/wscc9.py`` (reference ``WSCC9BusSystem``,
projects/DAE/problems/wscc9BusSystem.py:576-1233): three 11th-order
synchronous machines (sub-transient model with IEEE type-1 exciters and
steam turbine/governor) coupled through the 9-bus network power-flow
equations — 33 differential + 24 algebraic unknowns.  A line outage (the
bus8-bus2 transformer branch) is applied at t >= 0.05 s, and the steam-valve
position of machine 1 saturates at ``psv_max`` (the event the
``SwitchEstimator`` hunts for).

As in the JAX package, the bus admittance matrices are assembled from the
MATPOWER case9 branch list (the post-event matrix in the reference's bus
order), the line outage and the valve limiter are selects (``torch.where``),
and the network sums are dense n x n contractions.  ``eval_f`` is written over
the last axis (the nodes of a residual evaluation ride along as a batch) and
builds its result from new tensors, so the DAE sweepers' Newton takes its
Jacobian by ``torch.func.jacfwd``.  Like every DAE of both packages it runs
through ``ControllerNonMPI(1, ...)``, on the host's numbers of 57 unknowns.

Machine/exciter/turbine data from Sauer & Pai, network data from MATPOWER
case9 (public standard test system).
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.device import cached_tensor
from pysdc_tpu_torch.models.dae_problems import DAEProblem, _time

# MATPOWER case9 branches: (from_bus, to_bus, r, x, b_charging) in p.u.
_BRANCHES = [
    (1, 4, 0.0, 0.0576, 0.0),
    (4, 5, 0.017, 0.092, 0.158),
    (5, 6, 0.039, 0.17, 0.358),
    (3, 6, 0.0, 0.0586, 0.0),
    (6, 7, 0.0119, 0.1008, 0.209),
    (7, 8, 0.0085, 0.072, 0.149),
    (8, 2, 0.0, 0.0625, 0.0),
    (8, 9, 0.032, 0.161, 0.306),
    (9, 4, 0.01, 0.085, 0.176),
]

# power-flow solution (MATPOWER case9): V magnitude (p.u.), angle (deg)
_V0 = np.array([1.0, 1.0, 1.0, 0.9870068523919054, 0.9754721770850531,
                1.0033754364528003, 0.9856448817249468, 0.9961852458090699,
                0.9576210404299043])
_TH0_DEG = np.array([0.0, 9.668741126628124, 4.771073237177319,
                     -2.40664391951941, -4.01726432670755, 1.9256016868285644,
                     0.6215445553889323, 3.7991201926923193, -4.349933576561007])
# generator dispatch (MW, MVAr) and loads (MW, MVAr), base 100 MVA
_PG_MW = np.array([71.0, 163.0, 85.0])
_QG_MVAR = np.array([24.0, 14.0, -3.0])
_PL_MW = np.array([0.0, 0.0, 0.0, 0.0, 90.0, 0.0, 100.0, 0.0, 125.0])
_QL_MVAR = np.array([0.0, 0.0, 0.0, 0.0, 30.0, 0.0, 35.0, 0.0, 50.0])


def _assemble_ybus(branches, n=9):
    """Standard Ybus assembly: series admittance + half line charging."""
    Y = np.zeros((n, n), complex)
    for f, t, r, x, b in branches:
        f, t = f - 1, t - 1
        y = 1.0 / (r + 1j * x)
        Y[f, f] += y + 1j * b / 2
        Y[t, t] += y + 1j * b / 2
        Y[f, t] -= y
        Y[t, f] -= y
    return Y


class WSCC9BusSystem(DAEProblem):
    """WSCC 9-bus 3-machine system, fully-implicit DAE F(u, u', t) = 0.

    State layout (m=3 machines, n=9 buses), flat vector of 57:
      diff (33): Eqp, Si1d, Edp, Si2q, Delta, w, Efd, RF, VR, TM, PSV (m each)
      alg  (24): Id, Iq (m each), V (n), TH (n)
    """

    m, n = 3, 9
    diff_nvars = 11 * 3

    def __init__(self, newton_tol=1e-10, newton_maxiter=100, dtype=None, device='cuda'):
        super().__init__(nvars=11 * self.m + 2 * self.m + 2 * self.n,
                         newton_tol=newton_tol, newton_maxiter=newton_maxiter, dtype=dtype, device=device)
        m, n = self.m, self.n
        self.ws = 2 * np.pi * 60
        self.baseMVA = 100.0

        # machine data (Sauer & Pai; reference wscc9BusSystem.py:781-812)
        self.H = np.array([23.640, 6.4000, 3.0100])
        self.Xd = np.array([0.1460, 0.8958, 1.3125])
        self.Xdp = np.array([0.0608, 0.1198, 0.1813])
        self.Xdpp = np.array([0.0489, 0.0881, 0.1133])
        self.Xq = np.array([0.0969, 0.8645, 1.2578])
        self.Xqp = np.array([0.0969, 0.1969, 0.2500])
        self.Xqpp = np.array([0.0396, 0.0887, 0.0833])
        self.Td0p = np.array([8.960000000000001, 6.0000, 5.8900])
        self.Td0pp = np.array([0.1150, 0.0337, 0.0420])
        self.Tq0p = np.array([0.3100, 0.5350, 0.6000])
        self.Tq0pp = np.array([0.0330, 0.0780, 0.1875])
        self.Rs = np.array([0.0041, 0.0026, 0.0035])
        self.Xls = np.array([0.1200, 0.1020, 0.0750])
        self.Dm = np.array([0.1, 0.2, 0.3]) * (2 * self.H) / self.ws
        # exciter (IEEE type 1) and turbine/governor data
        self.KA, self.TA = 20.0 * np.ones(m), 0.2 * np.ones(m)
        self.KE, self.TE = 1.0 * np.ones(m), 0.314 * np.ones(m)
        self.KF, self.TF = 0.063 * np.ones(m), 0.35 * np.ones(m)
        self.Ax, self.Bx = 0.0039 * np.ones(m), 1.555 * np.ones(m)
        self.TCH, self.TSV, self.RD = 0.1 * np.ones(m), 0.05 * np.ones(m), 0.05 * np.ones(m)
        self.MH = 2 * self.H / self.ws
        self.psv_max = 1.0

        # network: pre/post-event admittances
        Y0 = _assemble_ybus(_BRANCHES, n)
        Y_out = _assemble_ybus([b for i, b in enumerate(_BRANCHES) if i != 6], n)
        perm = np.argsort([0, 1, 2, 3, 5, 8, 7, 6, 4])  # reference export-tool ordering
        Y1 = Y_out[np.ix_(perm, perm)]
        self.Yabs = np.stack([np.abs(Y0), np.abs(Y1)])
        self.Yang = np.stack([np.angle(Y0), np.angle(Y1)])

        # loads and dispatch in p.u.
        self.PL = _PL_MW / self.baseMVA
        self.QL = _QL_MVAR / self.baseMVA
        self.PG = _PG_MW / self.baseMVA
        self.QG = _QG_MVAR / self.baseMVA
        self.V0 = _V0.copy()
        self.TH0 = np.deg2rad(_TH0_DEG)

        # steady-state machine initialization from the power-flow solution
        # (standard sub-transient model init; reference :920-960)
        Vph = self.V0[:m] * np.exp(1j * self.TH0[:m])
        Iph = np.conj((self.PG + 1j * self.QG) / Vph)
        E0 = Vph + (self.Rs + 1j * self.Xq) * Iph
        self.D0 = np.angle(E0)
        rot = np.exp(-1j * (self.D0 - np.pi / 2))
        self.Id0 = np.real(Iph * rot)
        self.Iq0 = np.imag(Iph * rot)
        self.Edp0 = (self.Xq - self.Xqp) * self.Iq0
        self.Si2q0 = (self.Xls - self.Xq) * self.Iq0
        self.Eqp0 = self.Rs * self.Iq0 + self.Xdp * self.Id0 + self.V0[:m] * np.cos(self.D0 - self.TH0[:m])
        self.Si1d0 = self.Eqp0 - (self.Xdp - self.Xls) * self.Id0
        self.Efd0 = self.Eqp0 + (self.Xd - self.Xdp) * self.Id0
        self.TM0 = (
            ((self.Xdpp - self.Xls) / (self.Xdp - self.Xls)) * self.Eqp0 * self.Iq0
            + ((self.Xdp - self.Xdpp) / (self.Xdp - self.Xls)) * self.Si1d0 * self.Iq0
            + ((self.Xqpp - self.Xls) / (self.Xqp - self.Xls)) * self.Edp0 * self.Id0
            - ((self.Xqp - self.Xqpp) / (self.Xqp - self.Xls)) * self.Si2q0 * self.Id0
            + (self.Xqpp - self.Xdpp) * self.Id0 * self.Iq0
        )
        self.VR0 = (self.KE + self.Ax * np.exp(self.Bx * self.Efd0)) * self.Efd0
        self.RF0 = (self.KF / self.TF) * self.Efd0
        self.Vref = self.V0[:m] + self.VR0 / self.KA
        self.PSV0 = self.TM0.copy()
        self.PC = self.PSV0.copy()

        # event time found by the SwitchEstimator; np.inf = "no event yet"
        self.t_switch = np.inf
        self._consts: dict = {}
        self.nswitches = 0

    # ------------------------------------------------------------------
    def _c(self, name, u):
        """The constant array ``name`` as a tensor in ``u``'s dtype on its device, made once and kept."""
        return cached_tensor(self._consts, name, lambda: np.asarray(getattr(self, name), dtype=float), u)

    def _split(self, u):
        m, n = self.m, self.n
        parts = [u[..., i * m:(i + 1) * m] for i in range(11)]
        Id = u[..., 11 * m:12 * m]
        Iq = u[..., 12 * m:13 * m]
        V = u[..., 13 * m:13 * m + n]
        TH = u[..., 13 * m + n:13 * m + 2 * n]
        return parts, Id, Iq, V, TH

    def eval_f(self, u, du, t):
        m = self.m
        c = lambda name: self._c(name, u)  # noqa: E731
        (Eqp, Si1d, Edp, Si2q, Delta, w, Efd, RF, VR, TM, PSV), Id, Iq, V, TH = self._split(u)
        (dEqp, dSi1d, dEdp, dSi2q, dDelta, dw, dEfd, dRF, dVR, dTM, dPSV), *_ = self._split(du)
        tt = _time(t, u)

        # line outage at t >= 0.05 (a select over the stacked Ybus pair)
        if isinstance(tt, torch.Tensor):
            sel = (tt >= 0.05).to(u.dtype).unsqueeze(-1).unsqueeze(-1)
        else:
            sel = float(tt >= 0.05)
        Yabs_all, Yang_all = c('Yabs'), c('Yang')
        Yabs = (1.0 - sel) * Yabs_all[0] + sel * Yabs_all[1]
        Yang = (1.0 - sel) * Yang_all[0] + sel * Yang_all[1]

        COI = (w * c('MH')).sum(-1, keepdim=True) / np.sum(self.MH)

        # network injections: P_i = sum_j V_i V_j |Y_ij| cos(TH_i - TH_j - ang_ij)
        ang = TH.unsqueeze(-1) - TH.unsqueeze(-2) - Yang
        mag = V.unsqueeze(-1) * V.unsqueeze(-2) * Yabs
        P_inj = (mag * torch.cos(ang)).sum(-1)
        Q_inj = (mag * torch.sin(ang)).sum(-1)

        VG, THG = V[..., :m], TH[..., :m]
        ad = Delta - THG

        Xd, Xdp, Xdpp, Xq, Xqp, Xqpp, Xls = (c(k) for k in ('Xd', 'Xdp', 'Xdpp', 'Xq', 'Xqp', 'Xqpp', 'Xls'))
        Rs = c('Rs')
        kd1 = (Xdpp - Xls) / (Xdp - Xls)
        kd2 = (Xdp - Xdpp) / (Xdp - Xls)
        kq1 = (Xqpp - Xls) / (Xqp - Xls)
        kq2 = (Xqp - Xqpp) / (Xqp - Xls)

        f_Eqp = (1.0 / c('Td0p')) * (
            -Eqp - (Xd - Xdp) * (
                Id - ((Xdp - Xdpp) / (Xdp - Xls) ** 2)
                * (Si1d + (Xdp - Xls) * Id - Eqp)
            ) + Efd
        ) - dEqp
        f_Si1d = (1.0 / c('Td0pp')) * (-Si1d + Eqp - (Xdp - Xls) * Id) - dSi1d
        f_Edp = (1.0 / c('Tq0p')) * (
            -Edp + (Xq - Xqp) * (
                Iq - ((Xqp - Xqpp) / (Xqp - Xls) ** 2)
                * (Si2q + (Xqp - Xls) * Iq + Edp)
            )
        ) - dEdp
        f_Si2q = (1.0 / c('Tq0pp')) * (-Si2q - Edp - (Xqp - Xls) * Iq) - dSi2q
        f_Delta = w - COI - dDelta
        f_w = (self.ws / (2.0 * c('H'))) * (
            TM - kd1 * Eqp * Iq - kd2 * Si1d * Iq - kq1 * Edp * Id + kq2 * Si2q * Id
            - (Xqpp - Xdpp) * Id * Iq - c('Dm') * (w - self.ws)
        ) - dw
        f_Efd = (1.0 / c('TE')) * (-(c('KE') + c('Ax') * torch.exp(c('Bx') * Efd)) * Efd + VR) - dEfd
        f_RF = (1.0 / c('TF')) * (-RF + (c('KF') / c('TF')) * Efd) - dRF
        f_VR = (1.0 / c('TA')) * (
            -VR + c('KA') * RF - (c('KA') * c('KF') / c('TF')) * Efd + c('KA') * (c('Vref') - VG)
        ) - dVR

        # valve limiter on machine 1: past the event (PSV_1 at its max, or the
        # detected switch time) the valve is pinned, dPSV_1 = 0
        f_PSV_free = (1.0 / c('TSV')) * (-PSV + c('PSV0') - (1.0 / c('RD')) * (w / self.ws - 1.0)) - dPSV
        f_PSV_limited = torch.cat([dPSV[..., :1], f_PSV_free[..., 1:]], dim=-1)
        limited = (PSV[..., 0] >= self.psv_max) | (tt >= self.t_switch)
        f_PSV = torch.where(limited.unsqueeze(-1), f_PSV_limited, f_PSV_free)
        f_TM = (1.0 / c('TCH')) * (-TM + PSV) - dTM

        # stator algebraic equations (reference eqs (12),(13))
        g_d = Rs * Id - Xqpp * Iq - kq1 * Edp + kq2 * Si2q + VG * torch.sin(ad)
        g_q = Rs * Iq + Xdpp * Id - kd1 * Eqp - kd2 * Si1d + VG * torch.cos(ad)
        # power balance at generator and load buses (eqs (14)-(17))
        PL, QL = c('PL'), c('QL')
        g_P = (Id * VG * torch.sin(ad) + Iq * VG * torch.cos(ad)) - PL[:m] - P_inj[..., :m]
        g_Q = (Id * VG * torch.cos(ad) - Iq * VG * torch.sin(ad)) - QL[:m] - Q_inj[..., :m]
        g_PL = -PL[m:] - P_inj[..., m:]
        g_QL = -QL[m:] - Q_inj[..., m:]

        return torch.cat([
            f_Eqp, f_Si1d, f_Edp, f_Si2q, f_Delta, f_w, f_Efd, f_RF, f_VR,
            f_PSV, f_TM,  # residual rows ordered as the reference's eqs list
            g_d, g_q, g_P, g_Q, g_PL, g_QL,
        ], dim=-1)

    def u_exact(self, t, u_init=None, t_init=None):
        if float(t) != 0.0:
            raise NotImplementedError('initial conditions only (reference :1151-1183)')
        m = self.m
        return self._vector(np.concatenate([
            self.Eqp0, self.Si1d0, self.Edp0, self.Si2q0, self.D0,
            self.ws * np.ones(m), self.Efd0, self.RF0, self.VR0, self.TM0, self.PSV0,
            self.Id0, self.Iq0, self.V0, self.TH0,
        ]))

    # -- event detection for the SwitchEstimator (reference :1185-1227) --
    def get_switching_info(self, u_nodes, t):
        u_nodes = [np.asarray(u.detach().cpu() if isinstance(u, torch.Tensor) else u) for u in u_nodes]
        idx = 10 * self.m  # PSV of machine 1
        switch_detected, m_guess = False, -100
        for k in range(1, len(u_nodes)):
            h_prev = u_nodes[k - 1][idx] - self.psv_max
            h_curr = u_nodes[k][idx] - self.psv_max
            if h_prev < 0 and h_curr >= 0:
                switch_detected = True
                m_guess = k - 1
                break
        state_function = [float(u[idx] - self.psv_max) for u in u_nodes]
        return switch_detected, m_guess, state_function

    def count_switches(self):
        self.nswitches += 1
