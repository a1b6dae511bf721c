"""Link inner Newton tolerance to the SDC residual.

The counterpart of ``pysdc_tpu/convergence/inexactness.py``; mirrors
reference ``NewtonInexactness`` (convergence_controller_classes/inexactness.py):
after every iteration the problem's ``newton_tol`` becomes
``ratio * <SDC accuracy>``.  The problem reads its attribute at each solve,
so the new tolerance takes effect at the next sweep; the block controller
hands the steps' tolerances to its batched functions as one ``(P,)`` tensor
(``ShardedController._block_overrides``).  One host read of the residual an
iteration.
"""

from __future__ import annotations

from pysdc_tpu_torch.core.convergence import ConvergenceController


class NewtonInexactness(ConvergenceController):
    def setup(self, controller, params, description, **kwargs):
        defaults = {
            'control_order': 500,
            'ratio': 1e-2,
            'min_tol': 0.0,
            'max_tol': 1e99,
            'maxiter': None,
            'use_e_tol': 'e_tol' in description.get('level_params', {}),
            'initial_tol': 1e-3,
            **super().setup(controller, params, description, **kwargs),
        }
        if defaults['maxiter']:
            description.setdefault('problem_params', {})['newton_maxiter'] = defaults['maxiter']
        return defaults

    def dependencies(self, controller, description, **kwargs):
        if self.params.use_e_tol:
            from pysdc_tpu_torch.convergence.estimate_embedded_error import EstimateEmbeddedError

            controller.add_convergence_controller(EstimateEmbeddedError, description=description)

    def post_iteration_processing(self, controller, step, **kwargs):
        for lvl in step.levels:
            if self.params.use_e_tol:
                accuracy = getattr(lvl.status, 'error_embedded_estimate', None) or lvl.status.residual
            else:
                accuracy = lvl.status.residual
            accuracy = self.params.initial_tol if accuracy is None else float(accuracy)
            tol = max(min(accuracy * self.params.ratio, self.params.max_tol), self.params.min_tol)
            self.set_tolerance(lvl, tol)
            self.debug(f'Changed tolerance to {tol:.2e}', step)

    def set_tolerance(self, lvl, tol):
        lvl.prob.newton_tol = tol
