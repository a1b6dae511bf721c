"""Stop on residual tolerance / max iterations / e_tol.

The counterpart of ``pysdc_tpu/convergence/check_convergence.py``; mirrors
the reference ``CheckConvergence``
(``implementations/convergence_controller_classes/check_convergence.py:6-114``)
including the Gauss-Seidel ``prev_done`` forwarding semantics handled by the
controllers.
"""

from __future__ import annotations

import torch

from pysdc_tpu_torch.core.convergence import ConvergenceController


class CheckConvergence(ConvergenceController):
    def setup(self, controller, params, description, **kwargs):
        defaults = {'control_order': +200, 'use_e_tol': 'e_tol' in description.get('level_params', {})}
        return {**defaults, **super().setup(controller, params, description, **kwargs)}

    def dependencies(self, controller, description, **kwargs):
        super().dependencies(controller, description, **kwargs)
        if self.params.use_e_tol:
            from pysdc_tpu_torch.convergence.estimate_embedded_error import EstimateEmbeddedError

            controller.add_convergence_controller(EstimateEmbeddedError, description=description)

    @staticmethod
    def check_convergence(S, self=None):
        """Convergence verdict for one step (reference check_convergence.py:59):
        any of {iteration budget spent, residual under restol after at least
        one sweep, increment under e_tol, forced done} — unless the step is
        forced to continue."""
        if S.status.force_continue:
            return False
        if S.status.force_done or S.status.iter >= S.params.maxiter:
            return True

        L = S.levels[0]
        swept_at_all = S.status.iter > 0 or L.status.sweep > 0
        if L.status.residual is not None and swept_at_all:
            # the one host sync of a convergence check
            residual = L.status.residual
            if (residual.item() if isinstance(residual, torch.Tensor) else residual) <= L.params.restol:
                return True

        inc, e_tol = getattr(L.status, 'increment', None), L.params.e_tol
        return bool(inc is not None and e_tol is not None and 0 < e_tol and inc < e_tol)

    def check_iteration_status(self, controller, S, **kwargs):
        S.status.done = self.check_convergence(S, self)
        S.status.force_continue = False
