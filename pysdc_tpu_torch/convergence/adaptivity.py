"""Adaptive step-size selection from local error estimates.

The counterpart of ``pysdc_tpu/convergence/adaptivity.py``; behavioral
counterparts of the reference adaptivity family
(``convergence_controller_classes/adaptivity.py:8-940``).  All variants share
the classic controller ``dt* = beta * dt * (e_tol / e)^(1/k)`` and restart a
step whose local error overshoots the tolerance; they differ in where the
error estimate comes from.  Ported: the embedded sweep difference
(:class:`Adaptivity`, both estimator flavors) and the embedded Runge-Kutta
pair (:class:`AdaptivityRK`).  The residual, left-out-node, within-Q
extrapolation and nested-quadrature variants wait for their estimators
(ROADMAP queue 1, item 13); each of those raises by name.
"""

from __future__ import annotations

from pysdc_tpu_torch.core.convergence import ConvergenceController
from pysdc_tpu_torch.core.errors import ParameterError

ESTIMATORS_ITEM = 'ROADMAP queue 1, item 13'


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


def _not_ported(name, item, needs):
    """A class of the JAX package that raises on construction, naming its ROADMAP item."""

    def __init__(self, controller, params, description, **kwargs):
        raise NotImplementedError(f'{name} needs {needs}, not ported yet ({item})')

    return type(name, (AdaptivityBase,), {'__init__': __init__, '__doc__': f'Not ported yet ({item}): needs {needs}.'})


AdaptivityResidual = _not_ported('AdaptivityResidual', ESTIMATORS_ITEM, 'the remaining convergence controllers')
AdaptivityPolynomialError = _not_ported('AdaptivityPolynomialError', ESTIMATORS_ITEM, 'EstimatePolynomialError')
AdaptivityExtrapolationWithinQ = _not_ported(
    'AdaptivityExtrapolationWithinQ', ESTIMATORS_ITEM, 'EstimateExtrapolationErrorWithinQ'
)
AdaptivityCollocation = _not_ported('AdaptivityCollocation', ESTIMATORS_ITEM, 'EstimateEmbeddedErrorCollocation')
