"""Iteration-count estimator-based stopping.

The counterpart of ``pysdc_tpu/convergence/check_iteration_estimator.py``;
mirrors the reference ``CheckIterationEstimatorNonMPI``
(convergence_controller_classes/check_iteration_estimator.py): estimate the
contraction of successive sweep increments and stop once the extrapolated
remaining error drops below the tolerance.  One host read an iteration.
"""

from __future__ import annotations

from pysdc_tpu_torch.core.convergence import ConvergenceController
from pysdc_tpu_torch.core.state import norm_max


class CheckIterationEstimatorNonMPI(ConvergenceController):
    def setup(self, controller, params, description, **kwargs):
        defaults = {'control_order': -50, 'errtol': 1e-5}
        return {**defaults, **super().setup(controller, params, description, **kwargs)}

    def dependencies(self, controller, description, **kwargs):
        from pysdc_tpu_torch.convergence.store_uold import StoreUOld

        controller.add_convergence_controller(StoreUOld, description=description)

    def setup_status_variables(self, controller, **kwargs):
        self.add_status_variable_to_level('diff_old_loc')
        self.add_status_variable_to_level('diff_first_loc')

    def check_iteration_status(self, controller, S, **kwargs):
        L = S.levels[0]
        if L.uold is None or S.status.iter <= 0:
            return
        diff_new = float(norm_max(L.uold[-1] - L.state.u[-1]))

        if S.status.iter == 1:
            L.status.diff_old_loc = diff_new
            L.status.diff_first_loc = diff_new
            return

        diff_old = L.status.diff_old_loc
        L.status.diff_old_loc = diff_new
        if diff_old is None or diff_old == 0 or diff_new == 0:
            return
        # contraction factor and geometric-series error bound
        alpha = min(1.0 - 1e-8, max(diff_new / diff_old, 1e-8))
        Ltol = alpha / (1.0 - alpha) * diff_new
        if Ltol < self.params.errtol:
            S.status.force_done = True
            self.log(
                f'Stopping iterations: estimated remaining error {Ltol:.2e} < {self.params.errtol:.2e}', S
            )
