"""Hot Rod soft-fault detector.

The counterpart of ``pysdc_tpu/convergence/hotrod.py``; mirrors the
reference ``HotRod`` (convergence_controller_classes/hotrod.py): compare the
embedded and extrapolation error estimates; a discrepancy above
``HotRod_tol`` flags a (soft) fault and triggers a restart.  The final sweep
is discarded (the level's state goes back to the previous sweep's ``u``,
which ``StoreUOld`` keeps) to keep the estimates consistent.  The two
estimates are host floats already; the detector itself reads nothing.
"""

from __future__ import annotations

import numpy as np

from pysdc_tpu_torch.core.convergence import ConvergenceController
from pysdc_tpu_torch.core.errors import ParameterError
from pysdc_tpu_torch.core.state import LevelState


class HotRod(ConvergenceController):
    def setup(self, controller, params, description, **kwargs):
        defaults = {'HotRod_tol': np.inf, 'control_order': -40, 'no_storage': False}
        out = {**defaults, **super().setup(controller, params, description, **kwargs)}
        if description['level_params'].get('restol', -1.0) >= 0:
            raise ParameterError('Hot Rod needs restol < 0 (constant order in time)')
        return out

    def dependencies(self, controller, description, **kwargs):
        from pysdc_tpu_torch.convergence.estimate_embedded_error import EstimateEmbeddedError
        from pysdc_tpu_torch.convergence.estimate_extrapolation_error import EstimateExtrapolationErrorNonMPI

        controller.add_convergence_controller(EstimateEmbeddedError, description=description)
        controller.add_convergence_controller(
            EstimateExtrapolationErrorNonMPI,
            description=description,
            params={'no_storage': self.params.no_storage},
        )

    def determine_restart(self, controller, S, MS=None, **kwargs):
        if S.status.iter < S.params.maxiter:
            return
        for L in S.levels:
            e_ex = getattr(L.status, 'error_extrapolation_estimate', None)
            e_em = getattr(L.status, 'error_embedded_estimate', None)
            if e_ex is not None and e_em is not None:
                diff = abs(e_ex - e_em)
                # a NaN discrepancy means the solution blew up entirely —
                # definitely a fault (nan > tol would silently be False)
                if diff > self.params.HotRod_tol or np.isnan(diff):
                    S.status.restart = True
                    self.log(
                        f'Triggering restart: e_em={e_em:.2e}, e_ex={e_ex:.2e} -> delta={diff:.2e}, '
                        f'tol={self.params.HotRod_tol:.2e}',
                        S,
                    )

    def post_iteration_processing(self, controller, S, **kwargs):
        """Throw away the final sweep to match the error estimates
        (reference hotrod.py:139-158)."""
        if S.status.iter == S.params.maxiter:
            for L in S.levels:
                if L.uold is not None and L.state is not None:
                    L.state = LevelState(u=L.uold, f=L.state.f, tau=L.state.tau)
