"""Adaptive step-size selection from local error estimates.

The counterpart of ``pysdc_tpu/convergence/adaptivity.py``; behavioral
counterparts of the reference adaptivity family
(``convergence_controller_classes/adaptivity.py:8-940``).  All variants share
the classic controller ``dt* = beta * dt * (e_tol / e)^(1/k)`` and restart a
step whose local error overshoots the tolerance; they differ in where the
error estimate comes from (embedded sweep difference, embedded RK pair,
residual, left-out collocation node, within-Q extrapolation, or nested
quadrature rules).  Every estimate reaches the host as one float a step.
"""

from __future__ import annotations

import numpy as np

from pysdc_tpu_torch.core.convergence import ConvergenceController
from pysdc_tpu_torch.core.errors import ParameterError


def _controller_formula(beta, dt, e_tol, e, k):
    """Optimal next step size for an order-k local error model."""
    return beta * dt * (e_tol / e) ** (1.0 / k)


class AdaptivityBase(ConvergenceController):
    """Shared plumbing: the dt* formula, limiter forwarding, restart rule."""

    def setup(self, controller, params, description, **kwargs):
        mine = {'control_order': -50, 'beta': 0.9}
        return {**mine, **super().setup(controller, params, description, **kwargs)}

    def dependencies(self, controller, description, **kwargs):
        forwarded = {
            key: getattr(self.params, key)
            for key in ('dt_min', 'dt_max', 'dt_slope_min', 'dt_slope_max', 'dt_rel_min_slope')
            if hasattr(self.params, key)
        }
        if forwarded:
            from pysdc_tpu_torch.convergence.step_size_limiter import StepSizeLimiter

            controller.add_convergence_controller(StepSizeLimiter, params=forwarded, description=description)

    def _propose_dt(self, lvl, e, order, step):
        """Apply the controller formula and record the proposal."""
        lvl.status.dt_new = _controller_formula(
            self.params.beta, lvl.params.dt, self.params.e_tol, e, order
        )
        self.log(f'dt {lvl.params.dt:.2e} -> {lvl.status.dt_new:.2e} (e={e:.2e}, order {order})', step)

    # kept as a method so subclasses/tests may override the formula
    def compute_optimal_step_size(self, beta, dt, e_tol, e_est, order):
        return _controller_formula(beta, dt, e_tol, e_est, order)

    def get_local_error_estimate(self, controller, S, **kwargs):
        raise NotImplementedError('adaptivity flavors must supply a local error estimate')

    def _flag_restart(self, S, e, label='e'):
        S.status.restart = True
        self.log(f'Local error too large, restarting: {label}={e:.2e} >= e_tol={self.params.e_tol:.2e}', S)

    def determine_restart(self, controller, S, **kwargs):
        if S.status.iter >= S.params.maxiter:
            e = self.get_local_error_estimate(controller, S)
            if e >= self.params.e_tol:
                self._flag_restart(S, e)


class Adaptivity(AdaptivityBase):
    """Embedded-error adaptivity: the sweep-to-sweep difference at the last
    node is a local error estimate of order == iteration count
    (reference adaptivity.py:273)."""

    def setup(self, controller, params, description, **kwargs):
        mine = {'embedded_error_flavor': 'standard', 'rel_error': False}
        out = {**mine, **super().setup(controller, params, description, **kwargs)}
        if description.get('level_params', {}).get('restol', -1.0) >= 0:
            raise ParameterError(
                'embedded adaptivity requires a fixed iteration count: disable restol '
                '(set it negative) and control work via maxiter'
            )
        if 'e_tol' not in out:
            raise ParameterError("embedded adaptivity requires an 'e_tol' parameter")
        return out

    def dependencies(self, controller, description, **kwargs):
        from pysdc_tpu_torch.convergence.estimate_embedded_error import EstimateEmbeddedError

        super().dependencies(controller, description, **kwargs)
        flavor = EstimateEmbeddedError.get_implementation(self.params.embedded_error_flavor)
        controller.add_convergence_controller(
            flavor, description=description, params={'rel_error': self.params.rel_error}
        )

    def get_new_step_size(self, controller, S, **kwargs):
        if S.status.iter == S.params.maxiter:
            e = self.get_local_error_estimate(controller, S)
            self._propose_dt(S.levels[0], e, order=S.status.iter, step=S)

    def get_local_error_estimate(self, controller, S, **kwargs):
        return S.levels[0].status.error_embedded_estimate


class AdaptivityRK(Adaptivity):
    """Embedded RK pairs carry a fixed update order given by the tableau
    (reference adaptivity.py:422)."""

    def setup(self, controller, params, description, **kwargs):
        order = params.get('update_order', description['sweeper_class'].get_update_order())
        return {'update_order': order, **super().setup(controller, params, description, **kwargs)}

    def get_new_step_size(self, controller, S, **kwargs):
        if S.status.iter == S.params.maxiter:
            e = self.get_local_error_estimate(controller, S)
            self._propose_dt(S.levels[0], e, order=self.params.update_order, step=S)


class AdaptivityResidual(AdaptivityBase):
    """Bang-bang control on the SDC residual (reference adaptivity.py:458):
    halve dt when the residual exceeds e_tol, double it below max_restol."""

    def setup(self, controller, params, description, **kwargs):
        mine = {
            'control_order': -45,
            'e_tol': np.inf,
            'max_restol': 0,
            'allowed_modifications': ['increase', 'decrease'],
        }
        return {**mine, **super().setup(controller, params, description, **kwargs)}

    def dependencies(self, controller, description, **kwargs):
        pass

    def setup_status_variables(self, controller, **kwargs):
        pass

    def get_local_error_estimate(self, controller, S, **kwargs):
        return float(S.levels[0].status.residual)

    def get_new_step_size(self, controller, S, **kwargs):
        if S.status.iter != S.params.maxiter:
            return
        lvl = S.levels[0]
        res = self.get_local_error_estimate(controller, S)
        planned = lvl.status.dt_new if lvl.status.dt_new is not None else lvl.params.dt
        may = self.params.allowed_modifications
        if res > self.params.e_tol and 'decrease' in may:
            lvl.status.dt_new = min(planned, lvl.params.dt / 2.0)
            self.log(f'Residual {res:.2e} too large, halving dt to {lvl.status.dt_new:.2e}', S)
        elif res < self.params.max_restol and 'increase' in may:
            lvl.status.dt_new = max(planned, lvl.params.dt * 2.0)
            self.log(f'Residual {res:.2e} small, doubling dt to {lvl.status.dt_new:.2e}', S)

    def determine_restart(self, controller, S, **kwargs):
        if S.status.iter >= S.params.maxiter:
            res = self.get_local_error_estimate(controller, S)
            if res > self.params.e_tol:
                self._flag_restart(S, res, label='residual')


def _converged(S):
    from pysdc_tpu_torch.convergence.check_convergence import CheckConvergence

    return CheckConvergence.check_convergence(S)


class AdaptivityPolynomialError(AdaptivityBase):
    """Adaptivity from the left-out-node polynomial estimate of the
    *converged* collocation problem (reference adaptivity.py:831): iterate to
    restol, then choose dt from the order-M estimate, and tie the residual
    tolerance to the error target (inexactness)."""

    def setup(self, controller, params, description, **kwargs):
        mine = {
            'control_order': -50,
            'e_tol': params.get('e_tol'),
            'restol_rel': params.get('restol_rel', 1e-4),
            'restol_min': params.get('restol_min', 1e-12),
            'interpolate_between_restarts': False,
        }
        out = {**mine, **super().setup(controller, params, description, **kwargs)}
        if out['e_tol'] is None:
            raise ParameterError("polynomial-error adaptivity requires an 'e_tol' parameter")
        return out

    def dependencies(self, controller, description, **kwargs):
        from pysdc_tpu_torch.convergence.estimate_polynomial_error import EstimatePolynomialError

        super().dependencies(controller, description, **kwargs)
        controller.add_convergence_controller(EstimatePolynomialError, description=description)

    def get_local_error_estimate(self, controller, S, **kwargs):
        est = getattr(S.levels[0].status, 'error_embedded_estimate', None)
        return est if est is not None else 0.0

    def get_new_step_size(self, controller, S, **kwargs):
        if not _converged(S):
            return
        lvl = S.levels[0]
        e = getattr(lvl.status, 'error_embedded_estimate', None)
        order = getattr(lvl.status, 'order_embedded_estimate', None)
        if e is None or order is None:
            return
        self._propose_dt(lvl, e, order, S)
        lvl.params.restol = max(self.params.restol_rel * self.params.e_tol, self.params.restol_min)

    def determine_restart(self, controller, S, **kwargs):
        if _converged(S):
            e = self.get_local_error_estimate(controller, S)
            if e >= self.params.e_tol:
                self._flag_restart(S, e)


class AdaptivityExtrapolationWithinQ(AdaptivityBase):
    """Adaptivity from the within-collocation extrapolation estimate
    (reference adaptivity.py:740): iterate the collocation problem to
    convergence (restol/e_tol), then choose dt from the stage-order
    estimate of :class:`EstimateExtrapolationErrorWithinQ`.  The update
    order is the number of nodes (or nodes+1 with ``high_Taylor_order``)."""

    def setup(self, controller, params, description, **kwargs):
        mine = {'high_Taylor_order': False}
        out = {**mine, **super().setup(controller, params, description, **kwargs)}
        if 'e_tol' not in out:
            raise ParameterError("within-Q extrapolation adaptivity requires an 'e_tol' parameter")
        return out

    def dependencies(self, controller, description, **kwargs):
        from pysdc_tpu_torch.convergence.estimate_extrapolation_error import EstimateExtrapolationErrorWithinQ

        super().dependencies(controller, description, **kwargs)
        controller.add_convergence_controller(
            EstimateExtrapolationErrorWithinQ,
            description=description,
            params={'high_Taylor_order': self.params.high_Taylor_order},
        )

    def get_local_error_estimate(self, controller, S, **kwargs):
        est = getattr(S.levels[0].status, 'error_extrapolation_estimate', None)
        return est if est is not None else 0.0

    def get_new_step_size(self, controller, S, **kwargs):
        if not _converged(S):
            return
        lvl = S.levels[0]
        e = self.get_local_error_estimate(controller, S)
        if e > 0:
            order = lvl.sweep.coll.num_nodes + (1 if self.params.high_Taylor_order else 0)
            self._propose_dt(lvl, e, order, S)

    def determine_restart(self, controller, S, **kwargs):
        if _converged(S):
            e = self.get_local_error_estimate(controller, S)
            if e >= self.params.e_tol:
                self._flag_restart(S, e)


class AdaptivityCollocation(AdaptivityBase):
    """Nested-quadrature adaptivity (reference adaptivity.py:587-700): solve
    the same step under a sequence of collocation rules; the difference of
    consecutive converged solutions estimates a local error of order
    min(order_i, order_{i+1}) + 1."""

    def setup(self, controller, params, description, **kwargs):
        out = {
            'adaptive_coll_params': {},
            'restart_at_maxiter': True,
            **super().setup(controller, params, description, **kwargs),
            'control_order': 220,
        }
        if 'e_tol' not in out:
            raise ParameterError("collocation adaptivity requires an 'e_tol' parameter")
        self.num_colls = max(
            (len(v) for v in out['adaptive_coll_params'].values() if isinstance(v, list)),
            default=0,
        )
        self._errors = []
        self._orders = []
        return out

    def dependencies(self, controller, description, **kwargs):
        from pysdc_tpu_torch.convergence.estimate_embedded_error import EstimateEmbeddedErrorCollocation

        super().dependencies(controller, description, **kwargs)
        controller.add_convergence_controller(
            EstimateEmbeddedErrorCollocation,
            params={'adaptive_coll_params': self.params.adaptive_coll_params},
            description=description,
        )

    def reset_status_variables(self, controller, **kwargs):
        self._errors = []
        self._orders = []

    def get_convergence(self, controller, S, **kwargs):
        return len(self._orders) == self.num_colls

    def get_local_error_estimate(self, controller, S, **kwargs):
        if len(self._errors) > 1 and self._errors[-1] is not None:
            return self._errors[-1][1]
        return 0.0

    def post_iteration_processing(self, controller, S, **kwargs):
        if S.status.done:
            lvl = S.levels[0]
            self._errors.append(lvl.status.error_embedded_estimate_collocation)
            self._orders.append(lvl.sweep.coll.order)

    def get_new_step_size(self, controller, S, **kwargs):
        if not self.get_convergence(controller, S):
            return
        e = self.get_local_error_estimate(controller, S)
        if e > 0:
            self._propose_dt(S.levels[0], e, order=min(self._orders[-2:]) + 1, step=S)

    def determine_restart(self, controller, S, **kwargs):
        if self.get_convergence(controller, S):
            e = self.get_local_error_estimate(controller, S)
            if e >= self.params.e_tol:
                self._flag_restart(S, e)
