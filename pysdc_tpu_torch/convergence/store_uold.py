"""Store the previous iteration's solution (for embedded error / contraction).

A copy of ``pysdc_tpu/convergence/store_uold.py``; mirrors reference
``StoreUOld`` (convergence_controller_classes/store_uold.py).  The snapshot is
the state's ``u`` tensor itself: sweeps build new tensors and never write in
place, so no copy is needed.
"""

from __future__ import annotations

from pysdc_tpu_torch.core.convergence import ConvergenceController


class StoreUOld(ConvergenceController):
    def setup(self, controller, params, description, **kwargs):
        return {'control_order': +90, **super().setup(controller, params, description, **kwargs)}

    def post_iteration_processing(self, controller, S, **kwargs):
        for L in S.levels:
            if L.state is not None:
                L.uold = L.state.u

    def post_spread_processing(self, controller, S, **kwargs):
        self.post_iteration_processing(controller, S, **kwargs)
