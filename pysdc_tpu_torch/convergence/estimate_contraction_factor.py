"""Per-iteration contraction factor estimate.

A copy of ``pysdc_tpu/convergence/estimate_contraction_factor.py``; mirrors
reference ``EstimateContractionFactor``
(convergence_controller_classes/estimate_contraction_factor.py): ratio of
embedded error estimates between iterations, plus a prediction of how many
more iterations are needed to reach ``e_tol``.  Host floats only.
"""

from __future__ import annotations

import numpy as np

from pysdc_tpu_torch.core.convergence import ConvergenceController


class EstimateContractionFactor(ConvergenceController):
    def setup(self, controller, params, description, **kwargs):
        return {'control_order': -75, 'e_tol': None, **super().setup(controller, params, description, **kwargs)}

    def dependencies(self, controller, description, **kwargs):
        from pysdc_tpu_torch.convergence.estimate_embedded_error import EstimateEmbeddedError

        controller.add_convergence_controller(EstimateEmbeddedError, description=description)

    def setup_status_variables(self, controller, **kwargs):
        self.add_status_variable_to_level('contraction_factor')
        self.add_status_variable_to_level('error_embedded_estimate_last_iter')
        if self.params.e_tol is not None:
            self.add_status_variable_to_level('iter_to_convergence')

    def post_iteration_processing(self, controller, S, **kwargs):
        for L in S.levels:
            e_last = getattr(L.status, 'error_embedded_estimate_last_iter', None)
            e_now = getattr(L.status, 'error_embedded_estimate', None)
            if e_last is not None and e_now is not None:
                L.status.contraction_factor = e_now / e_last
                if self.params.e_tol is not None and L.status.contraction_factor < 1:
                    L.status.iter_to_convergence = max(
                        0,
                        int(
                            np.ceil(
                                np.log(self.params.e_tol / e_now) / np.log(L.status.contraction_factor)
                            )
                        ),
                    )
            if e_now is not None:
                L.status.error_embedded_estimate_last_iter = e_now
