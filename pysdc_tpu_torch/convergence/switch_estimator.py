"""Event detection for discontinuous right-hand sides (switch estimator).

The counterpart of ``pysdc_tpu/convergence/switch_estimator.py``;
counterpart of the reference PinTSimE project's ``SwitchEstimator``
(projects/PinTSimE/switch_estimator.py:11-370): after convergence of a step,
the problem's state function is checked for a sign change across the
collocation nodes; if found, the event time is located by rootfinding on the
interpolating polynomial (scipy ``brentq`` on the host), the step size is
adapted to end exactly at the event, and the step restarts.  Once hit within
tolerance, the event time is stored on the problem (``t_switch``, a host
float the problem reads at each evaluation; the block controller hands it
to its batched functions as a ``(P,)`` tensor) and the switch counter
increments.  A check copies the node values to the host once.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import brentq

from pysdc_tpu_torch.convergence.check_convergence import CheckConvergence
from pysdc_tpu_torch.core.convergence import ConvergenceController
from pysdc_tpu_torch.ops.lagrange import interpolation_matrix
from pysdc_tpu_torch.utils.convert import to_numpy


class SwitchEstimator(ConvergenceController):
    def setup(self, controller, params, description, **kwargs):
        defaults = {
            # reference switch_estimator.py:50 runs the SE before
            # BasicRestarting (95) so the restart flag it raises is seen,
            # counted and clamped in the same pass
            'control_order': 0,
            'tol': description['level_params']['dt'] * 1e-2,
            'tol_zero': 2.5e-12,
            'alpha': 1.0,
            # detect boundary *contact* (state function touches zero without
            # crossing): when a frozen rhs branch creates a sliding mode the
            # node values never cross (e.g. DiscontinuousTestDAE), so the
            # crossing is extrapolated from the rising nodes instead.  The
            # step boundary then lands within O(1e-3) of the event; exact
            # event declaration requires a genuine sign change.  0 disables.
            'contact_tol': 0.0,
        }
        self.status = {'switch_detected': False, 't_switch': None, 'is_zero': None}
        return {**defaults, **super().setup(controller, params, description, **kwargs)}

    def reset_status_variables(self, controller, **kwargs):
        self.status = {'switch_detected': False, 't_switch': None, 'is_zero': None}

    @staticmethod
    def get_switch(t_interp, state_function, m_guess):
        """Root of the interpolating polynomial of the state function
        (reference :280-334; brentq on the bracketed interval)."""
        t_interp = np.asarray(t_interp, dtype=float)
        sf = np.asarray(state_function, dtype=float)

        def p(t):
            return float(interpolation_matrix(t_interp, np.array([t]))[0] @ sf)

        # bracket from the sign change
        sign_change = np.where(np.sign(sf[:-1]) != np.sign(sf[1:]))[0]
        i = sign_change[0] if sign_change.size else max(m_guess, 0)
        return brentq(p, t_interp[i], t_interp[i + 1], xtol=1e-14)

    @staticmethod
    def get_contact(t_interp, state_function):
        """Contact time for a sliding-mode boundary touch (state function
        rises toward zero but is clipped by the frozen branch before
        crossing): extrapolate the *rising* nodes — they follow the unfrozen
        dynamics — to their zero crossing."""
        t = np.asarray(t_interp, dtype=float)
        sf = np.asarray(state_function, dtype=float)
        i = int(sf.argmax())
        n_rise = i + 1  # nodes 0..i follow the rising branch
        deg = min(n_rise - 1, 2)
        if deg >= 1:
            coeffs = np.polynomial.polynomial.polyfit(t[:n_rise], sf[:n_rise], deg)
            roots = np.polynomial.polynomial.polyroots(coeffs)
            real = [float(r.real) for r in roots if abs(r.imag) < 1e-10 and r.real > t[max(i - 1, 0)]]
            if real:
                # nearest crossing ahead of the rising segment, kept inside
                # the step so the shrink-and-restart logic stays well-posed
                return min(min(real), t[-1])
        return t[i]

    def get_new_step_size(self, controller, S, **kwargs):
        L = S.levels[0]
        if not CheckConvergence.check_convergence(S):
            return

        u_nodes = list(to_numpy(L.state.u))
        switch_detected, m_guess, state_function = L.prob.get_switching_info(u_nodes, L.time)
        contact = False
        if not switch_detected and self.params.contact_tol > 0:
            sf = np.asarray(state_function, dtype=float)
            interior_max = sf.argmax() not in (0,)
            rises_then_falls = np.any(np.diff(sf) > 0) and np.any(np.diff(sf) < 0)
            if interior_max and rises_then_falls and sf.max() > -self.params.contact_tol and sf.max() < 0:
                switch_detected, contact = True, True
        self.status['switch_detected'] = switch_detected
        if not switch_detected:
            return

        nodes = L.sweep.coll.nodes
        t_interp = [float(L.time)] + [float(L.time) + float(L.dt) * float(n) for n in nodes]
        if L.sweep.coll.left_is_node:
            t_interp = t_interp[1:]
            state_function = state_function[1:]

        # event already resolved at an end point?
        if abs(state_function[0]) <= self.params.tol_zero or abs(state_function[-1]) <= self.params.tol_zero:
            L.prob.count_switches()
            self.status['is_zero'] = True
            self.status['switch_detected'] = False
            return

        if contact:
            t_switch = self.get_contact(t_interp, state_function)
        elif state_function[0] * state_function[-1] < 0:
            t_switch = self.get_switch(t_interp, state_function, m_guess)
        else:
            t_switch = None
        if t_switch is not None:
            self.status['t_switch'] = t_switch
            if L.time < t_switch < L.time + L.dt:
                dt_switch = (t_switch - float(L.time)) * self.params.alpha
                if (
                    abs(t_switch - float(L.time)) <= self.params.tol
                    or abs(float(L.time) + float(L.dt) - t_switch) <= self.params.tol
                ):
                    self.log(f'Switch located at time {t_switch:.15f}', S)
                    L.prob.t_switch = t_switch
                    L.prob.count_switches()
                    self.status['switch_detected'] = False
                else:
                    dt_planned = L.status.dt_new if L.status.dt_new is not None else L.params.dt
                    L.status.dt_new = min(dt_planned, dt_switch) if not switch_detected else dt_switch
            else:
                L.prob.count_switches()
                self.status['switch_detected'] = False
        else:
            self.status['switch_detected'] = False

    def determine_restart(self, controller, S, **kwargs):
        if self.status['switch_detected']:
            S.status.restart = True

    def post_step_processing(self, controller, S, **kwargs):
        L = S.levels[0]
        if L.status.dt_new is None:
            L.status.dt_new = L.params.dt_initial
