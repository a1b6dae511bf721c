"""Embedded error estimates from order-mismatched solution pairs.

The counterpart of ``pysdc_tpu/convergence/estimate_embedded_error.py``;
behavioral counterparts of the reference's embedded-error family
(``convergence_controller_classes/estimate_embedded_error.py:9-363``).  An
"embedded" estimate reads the local error off two approximations of
different order that were computed anyway: for SDC, consecutive sweeps
(order grows by one per sweep, so the sweep-to-sweep difference at the last
node has the lower order); for embedded Runge-Kutta pairs, the two weight rows
of the tableau; for collocation switching, the converged solutions of two
successive quadrature rules.

Every estimate is one max-norm read on the host (``float`` of a 0-d tensor).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from pysdc_tpu_torch.core.convergence import ConvergenceController
from pysdc_tpu_torch.core.state import norm_max


def _order_gap(level, kind, rel):
    """The raw lower-vs-higher-order gap for one level, or None if the data
    it needs (previous-sweep snapshot / secondary end point) is absent."""
    if level.state is None:
        return None
    if kind == 'RK':
        level.compute_end_point()
        gap = norm_max(level.uend - level.uend_secondary)
        ref = level.uend
    else:  # SDC: StoreUOld keeps the previous sweep
        if level.uold is None:
            return None
        gap = norm_max(level.uold[-1] - level.state.u[-1])
        ref = level.state.u[-1]
    if rel:
        gap = gap / norm_max(ref)
    return float(gap)


def _floored(value):
    return max(value, np.finfo(float).eps)


class EstimateEmbeddedError(ConvergenceController):
    """Per-iteration embedded estimate -> ``level.status.error_embedded_estimate``
    (and ``increment``, which e_tol termination reads)."""

    @classmethod
    def get_implementation(cls, flavor='standard', useMPI=False):
        """Flavor registry (reference estimate_embedded_error.py:18-38)."""
        flavors = {
            'standard': EstimateEmbeddedError,
            'linearized': EstimateEmbeddedErrorLinearized,
            'collocation': EstimateEmbeddedErrorCollocation,
        }
        if flavor not in flavors:
            raise NotImplementedError(f'no embedded-error flavor named {flavor!r}')
        return flavors[flavor]

    def _is_rk(self, description):
        from pysdc_tpu_torch.sweepers.runge_kutta import RungeKutta

        return RungeKutta in description['sweeper_class'].__mro__

    def setup(self, controller, params, description, **kwargs):
        mine = {
            'control_order': -80,
            'sweeper_type': 'RK' if self._is_rk(description) else 'SDC',
            'rel_error': False,
        }
        return {**mine, **super().setup(controller, params, description, **kwargs)}

    def dependencies(self, controller, description, **kwargs):
        from pysdc_tpu_torch.hooks.logging_hooks import LogEmbeddedErrorEstimate

        if not self._is_rk(description):
            from pysdc_tpu_torch.convergence.store_uold import StoreUOld

            controller.add_convergence_controller(StoreUOld, description=description)
        controller.add_hook(LogEmbeddedErrorEstimate)

    def setup_status_variables(self, controller, **kwargs):
        self.add_status_variable_to_level('error_embedded_estimate')
        self.add_status_variable_to_level('increment')

    def _active(self, S):
        """RK pairs are valid from the first (only) iteration, the predictor's
        check #0 included; SDC needs a completed sweep to difference against."""
        return self.params.sweeper_type == 'RK' or S.status.iter > 0

    def post_iteration_processing(self, controller, S, **kwargs):
        if not self._active(S):
            return
        for level in S.levels:
            gap = _order_gap(level, self.params.sweeper_type, self.params.rel_error)
            if gap is None:
                continue
            level.status.error_embedded_estimate = _floored(gap)
            level.status.increment = level.status.error_embedded_estimate


class EstimateEmbeddedErrorLinearized(EstimateEmbeddedError):
    """Block-parallel variant (reference EstimateEmbeddedErrorLinearizedNonMPI,
    :154-229): in block Gauss-Seidel/Jacobi MSSDC the raw sweep difference on
    step j measures the error of the whole chain up to j; differencing
    against the predecessor's raw value recovers a per-step (local) quantity
    so adaptivity does not collapse dt on long blocks."""

    def __init__(self, controller, params, description, **kwargs):
        super().__init__(controller, params, description, **kwargs)
        self.buffers = SimpleNamespace(chain_gap=0.0)

    def setup(self, controller, params, description, **kwargs):
        return {'averaged': False, **super().setup(controller, params, description, **kwargs)}

    def reset_buffers_nonMPI(self, controller, **kwargs):
        self.buffers.chain_gap = 0.0

    def post_iteration_processing(self, controller, S, **kwargs):
        if len(S.levels) > 1 and len(controller.MS) > 1:
            raise NotImplementedError(
                'the linearized estimate supports either multiple levels or multiple steps, not both'
            )
        if not self._active(S):
            return
        scale = float(S.status.slot + 1) if self.params.averaged else 1.0
        newest = None
        for level in S.levels:
            raw = _order_gap(level, self.params.sweeper_type, self.params.rel_error)
            if raw is None:
                continue
            newest = raw
            local = abs(raw - self.buffers.chain_gap) / scale
            level.status.error_embedded_estimate = _floored(local)
            level.status.increment = level.status.error_embedded_estimate
        if newest is not None and not self.params.averaged:
            self.buffers.chain_gap = newest


class EstimateEmbeddedErrorCollocation(ConvergenceController):
    """Embedded error from switching quadrature rules: the difference between
    the converged solutions of two successive collocation problems (reference
    estimate_embedded_error.py:280-363).  Stored on the finest level as
    ``error_embedded_estimate_collocation = (iter, error)``; the switching
    itself is delegated to :class:`AdaptiveCollocation` (pass its parameters
    as ``adaptive_coll_params``)."""

    def setup(self, controller, params, description, **kwargs):
        self._converged_ends = []
        self._iters_used = []
        return {
            'control_order': 210,
            'adaptive_coll_params': {},
            **super().setup(controller, params, description, **kwargs),
        }

    def dependencies(self, controller, description, **kwargs):
        from pysdc_tpu_torch.convergence.adaptive_collocation import AdaptiveCollocation

        controller.add_convergence_controller(
            AdaptiveCollocation, params=dict(self.params.adaptive_coll_params), description=description
        )

    def setup_status_variables(self, controller, **kwargs):
        self.add_status_variable_to_level('error_embedded_estimate_collocation')

    def reset_status_variables(self, controller, **kwargs):
        self._converged_ends = []
        self._iters_used = []
        self.set_level_status_variable('error_embedded_estimate_collocation', None)

    def post_iteration_processing(self, controller, S, **kwargs):
        # runs before AdaptiveCollocation (210 < 300), so status.done still
        # marks "current collocation problem converged"
        if not S.status.done:
            return
        level = S.levels[0]
        level.compute_end_point()
        self._converged_ends.append(level.uend)
        self._iters_used.append(S.status.iter)
        if len(self._converged_ends) >= 2:
            pair_gap = float(norm_max(self._converged_ends[-1] - self._converged_ends[-2]))
            level.status.error_embedded_estimate_collocation = (
                self._iters_used[-2],
                _floored(pair_gap),
            )
