"""Taylor-extrapolation-based local error estimates.

The counterpart of ``pysdc_tpu/convergence/estimate_extrapolation_error.py``;
behavioral counterparts of the reference's ``estimate_extrapolation_error.py``
(:10 NonMPI across steps, :395 WithinQ inside the collocation rule):

- **across steps**: store (u, u') at the ends of previous steps, combine
  them with Taylor-cancellation weights into an extrapolated end value for
  the current step, and read the local error off the (scaled) difference.
  The stored samples are tensors on the level's device (at 2048² float64,
  32 MB each, ``2 n`` of them).
- **within Q**: collocation stages are themselves a time series — the
  solution at [t0, node_1 .. node_{M-1}] extrapolated to the last node has
  stage order M, so after the collocation problem has *converged* the
  difference to u[M] estimates the local error without storing anything
  across steps.  (The weight geometry is a fixed fraction of dt, so the
  weights are dt-invariant.)

Both share one weight builder (numpy on the host, a copy of the JAX
package's): find coefficients a_i (values) and b_i (derivatives) with
sum_i a_i u(t_i) + b_i u'(t_i) = u(t_eval) + O(h^K) by cancelling Taylor
terms of orders 1..K-1 around t_eval, and a prefactor that converts
|u_extrapolated - u_numeric| into a local-error scale by accounting for how
much accumulated error each stored value carries.  Each estimate is one host
read.
"""

from __future__ import annotations

import numpy as np
from scipy.special import factorial

from pysdc_tpu_torch.core.convergence import ConvergenceController
from pysdc_tpu_torch.core.errors import ParameterError
from pysdc_tpu_torch.core.state import f_total, norm_max


def taylor_combination_weights(times, dts, t_eval, K, n):
    """Weights (a, b, prefactor) for an order-K extrapolation to ``t_eval``.

    ``times``/``dts`` are the n sample times (sorted ascending here) and the
    step sizes that produced them.  K - n of the samples (the most recent
    ones) contribute their derivative as well as their value; K = n means a
    pure value combination (polynomial extrapolation).

    The prefactor: each stored value u_i carries the accumulated local
    errors of the steps up to i.  Modeling the per-step local error as
    phi * dt_i^(K-1) relative to the newest step's, the weighted combination
    minus the newest value carries ``sum_i a_i * acc_i - acc_last`` units of
    the newest step's local error, whose inverse magnitude rescales the raw
    difference into a local-error estimate.
    """
    order = np.argsort(np.asarray(times, dtype=float))
    delta = np.asarray(times, dtype=float)[order] - float(t_eval)
    n_f = K - n

    powers = np.arange(K)[:, None]
    value_rows = delta[None, :] ** powers / factorial(powers)
    system = value_rows
    if n_f > 0:
        deriv_rows = np.zeros((K, n_f))
        deriv_rows[1:, :] = delta[None, n - n_f:] ** (powers[1:] - 1) / factorial(powers[1:] - 1)
        system = np.concatenate([value_rows, deriv_rows], axis=1)
    weights = np.linalg.solve(system, np.eye(K)[0])

    a = weights[:n]
    b = np.zeros(n)
    if n_f > 0:
        b[n - n_f:] = weights[n:]

    dts_sorted = np.abs(np.asarray(dts, dtype=float))[-n:]
    rel_err_size = (dts_sorted / dts_sorted[-1]) ** (K - 1)
    # accumulated-error units carried by sample i (relative to the newest
    # step's local error); the newest sample carries acc[-1] + 1 of them
    acc = np.concatenate([[0.0], np.cumsum(rel_err_size[1:])])
    carried = float(np.dot(a, acc)) - (acc[-1] + 1.0)
    prefactor = 1.0 / abs(carried)
    return a, b, prefactor


class EstimateExtrapolationErrorNonMPI(ConvergenceController):
    """Across-steps flavor: a rolling store of step-end (u, u') samples."""

    def __init__(self, controller, params, description, **kwargs):
        super().__init__(controller, params, description, **kwargs)
        self._reset_store()
        self._weights = None  # (a, b, prefactor) once computed

    def _reset_store(self):
        n = self.params.n
        self.store = {'t': [None] * n, 'dt': [None] * n, 'u': [None] * n, 'f': [None] * n}

    def setup(self, controller, params, description, **kwargs):
        from pysdc_tpu_torch.convergence.adaptivity import Adaptivity
        from pysdc_tpu_torch.convergence.hotrod import HotRod

        requested = description.get('convergence_controllers', {})
        defaults = {
            'control_order': -75,
            'use_adaptivity': Adaptivity in requested,
            'use_HotRod': HotRod in requested,
            'order_time_marching': description['step_params']['maxiter'],
            'no_storage': False,
        }
        new = {**defaults, **super().setup(controller, params, description, **kwargs)}
        new['Taylor_order'] = new['order_time_marching'] + 2
        new['estimate_iter'] = new['order_time_marching'] - (1 if new['use_HotRod'] else 0)
        new['n'] = (new['Taylor_order'] + 1) // 2

        if description['level_params'].get('restol', -1.0) >= 0:
            raise ParameterError('Extrapolation error estimate needs restol < 0 (constant order in time)')
        return new

    def setup_status_variables(self, controller, **kwargs):
        self.add_status_variable_to_level('error_extrapolation_estimate')

    def store_values(self, S):
        """Overwrite the oldest slot with this step's end data (the tensors
        themselves: sweeps never write into a state in place)."""
        ts = self.store['t']
        empty = [i for i, t in enumerate(ts) if t is None]
        slot = empty[0] if empty else int(np.argmin(np.asarray(ts, dtype=float)))
        L = S.levels[0]
        self.store['u'][slot] = L.state.u[-1]
        self.store['f'][slot] = f_total(L.state.f)[-1]
        self.store['t'][slot] = float(S.time) + float(S.dt)
        self.store['dt'][slot] = float(S.dt)

    def _stored_complete(self):
        return None not in self.store['t']

    def _sorted_samples(self, t_eval):
        """The n most recent stored samples strictly before ``t_eval``."""
        order = np.argsort(np.asarray(self.store['t'], dtype=float))
        recent = [i for i in order if self.store['t'][i] < t_eval - 10 * np.finfo(float).eps]
        return recent[-self.params.n:]

    def post_iteration_processing(self, controller, S, **kwargs):
        if S.status.iter != self.params.estimate_iter:
            return
        t_eval = float(S.time) + float(S.dt)
        need_fresh = (
            self._weights is None
            or self.params.use_adaptivity
            or (not self.params.no_storage and S.status.time_size > 1)
        )
        if need_fresh and self._stored_complete() and t_eval > max(self.store['t']):
            self._weights = taylor_combination_weights(
                self.store['t'], self.store['dt'], t_eval,
                self.params.Taylor_order, self.params.n,
            )
        if self._weights is not None and self._stored_complete():
            picks = self._sorted_samples(t_eval)
            if len(picks) < self.params.n:
                return
            a, b, prefactor = self._weights
            u_ex = S.levels[0].state.u[-1] * 0.0
            for w_a, w_b, i in zip(a, b, picks):
                u_ex = u_ex + float(w_a) * self.store['u'][i] + float(w_b) * self.store['f'][i]
            S.levels[0].status.error_extrapolation_estimate = (
                float(norm_max(u_ex - S.levels[0].state.u[-1])) * prefactor
            )
        if self.params.no_storage:
            self.store_values(S)

    def prepare_next_block(self, controller, S, size, time, Tend, MS=None, **kwargs):
        if self.params.no_storage:
            self._reset_store()
            return
        flagged = [i for i, step in enumerate(MS) if step.status.restart]
        cut = flagged[0] if flagged else len(MS)
        if S.status.slot < cut:
            self.store_values(S)


class EstimateExtrapolationErrorWithinQ(ConvergenceController):
    """Within-collocation flavor (reference :395): once the collocation
    problem is converged, extrapolate [u(t0), u(node_1..M-1)] to the last
    node — the difference to u[M] has the stage order M.  Stateless across
    steps, dt-invariant weights, works for any converged run regardless of
    how it got there."""

    def setup(self, controller, params, description, **kwargs):
        defaults = {
            'control_order': -75,
            'high_Taylor_order': False,
            **super().setup(controller, params, description, **kwargs),
        }
        return defaults

    def dependencies(self, controller, description, **kwargs):
        from pysdc_tpu_torch.hooks.logging_hooks import LogExtrapolationErrorEstimate

        controller.add_hook(LogExtrapolationErrorEstimate)

    def setup_status_variables(self, controller, **kwargs):
        self.add_status_variable_to_level('error_extrapolation_estimate')

    def post_iteration_processing(self, controller, S, **kwargs):
        from pysdc_tpu_torch.convergence.check_convergence import CheckConvergence

        if not CheckConvergence.check_convergence(S):
            return
        L = S.levels[0]
        coll = L.sweep.coll
        dt = float(L.params.dt)
        node_times = np.asarray(coll.nodes, dtype=float) * dt
        sample_times = np.concatenate([[0.0], node_times[:-1]])
        spacings = np.diff(np.concatenate([[0.0], node_times]))
        n = len(sample_times)
        a, _, prefactor = taylor_combination_weights(
            sample_times, spacings, node_times[-1], K=n, n=n,
        )
        u_ex = L.state.u[-1] * 0.0
        for i in range(n):
            u_ex = u_ex + float(a[i]) * L.state.u[i]
        L.status.error_extrapolation_estimate = max(
            float(norm_max(u_ex - L.state.u[-1])) * prefactor, np.finfo(float).eps
        )
