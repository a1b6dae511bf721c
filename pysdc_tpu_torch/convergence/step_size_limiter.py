"""Step-size clamping, slope limiting, and rounding policies.

A copy of ``pysdc_tpu/convergence/step_size_limiter.py``; behavioral
counterparts of the reference's step-size guards
(``convergence_controller_classes/step_size_limiter.py:5-159``): absolute
bounds, per-step relative-change (slope) bounds, and rounding to coarse
mantissa values.  All three are host arithmetic on the proposals.
"""

from __future__ import annotations

import numpy as np

from pysdc_tpu_torch.core.convergence import ConvergenceController


def _pending_proposals(step):
    """Yield each level that carries a freshly proposed step size."""
    for lvl in step.levels:
        if lvl.status.dt_new is not None:
            yield lvl


class StepSizeLimiter(ConvergenceController):
    """Clamp proposed step sizes into [dt_min, dt_max].

    Only adaptivity *proposals* pass through here — a user-supplied initial
    dt outside the bounds is not touched, and end-of-interval shortening may
    still undercut dt_min.
    """

    def setup(self, controller, params, description, **kwargs):
        mine = {'control_order': +92, 'dt_min': 0, 'dt_max': np.inf}
        return {**mine, **super().setup(controller, params, description, **kwargs)}

    def dependencies(self, controller, description, **kwargs):
        forwarded = {
            key: getattr(self.params, key)
            for key in ('dt_slope_min', 'dt_slope_max', 'dt_rel_min_slope')
            if hasattr(self.params, key)
        }
        if forwarded:
            forwarded['control_order'] = self.params.control_order - 1
            controller.add_convergence_controller(
                StepSizeSlopeLimiter, params=forwarded, description=description
            )

    def get_new_step_size(self, controller, S, **kwargs):
        lo, hi = self.params.dt_min, self.params.dt_max
        for lvl in _pending_proposals(S):
            clamped = min(max(lvl.status.dt_new, lo), hi)
            if clamped != lvl.status.dt_new:
                verb = 'raising' if clamped > lvl.status.dt_new else 'lowering'
                self.log(f'dt proposal {lvl.status.dt_new:.2e} outside bounds, {verb} to {clamped:.2e}', S)
                lvl.status.dt_new = clamped


class StepSizeSlopeLimiter(ConvergenceController):
    """Bound the relative change of dt between consecutive steps.

    ``dt_slope_min``/``dt_slope_max`` cap the ratio dt_new/dt; a change
    smaller than ``dt_rel_min_slope`` (relative) is discarded entirely so
    near-constant step sizes stay exactly constant.
    """

    def setup(self, controller, params, description, **kwargs):
        mine = {'control_order': 91, 'dt_slope_min': 0, 'dt_slope_max': np.inf, 'dt_rel_min_slope': 0}
        return {**mine, **super().setup(controller, params, description, **kwargs)}

    def get_new_step_size(self, controller, S, **kwargs):
        for lvl in _pending_proposals(S):
            here = lvl.params.dt
            ratio = lvl.status.dt_new / here
            if ratio < self.params.dt_slope_min:
                lvl.status.dt_new = here * self.params.dt_slope_min
            elif ratio > self.params.dt_slope_max:
                lvl.status.dt_new = here * self.params.dt_slope_max
            too_small_a_change = abs(lvl.status.dt_new - here) / here < self.params.dt_rel_min_slope
            if too_small_a_change and not S.status.restart:
                lvl.status.dt_new = here


class StepSizeRounding(ConvergenceController):
    """Snap dt proposals to a coarse grid of mantissa values.

    Keeping ``digits`` significant digits and flooring the last one to a
    multiple of ``fac`` yields human-friendly step sizes and a small set of
    distinct dt values over a run.
    """

    def setup(self, controller, params, description, **kwargs):
        mine = {'control_order': +93, 'digits': 1, 'fac': 5}
        return {**mine, **super().setup(controller, params, description, **kwargs)}

    @staticmethod
    def _quantize(dt, fac, digits):
        scale = 10.0 ** (np.log10(dt) // 1 - digits)
        return ((dt / scale) // fac) * fac * scale

    def get_new_step_size(self, controller, S, **kwargs):
        for lvl in _pending_proposals(S):
            snapped = self._quantize(lvl.status.dt_new, self.params.fac, self.params.digits)
            if snapped != lvl.status.dt_new:
                self.log(f'dt proposal {lvl.status.dt_new:.6e} snapped to {snapped:.6e}', S)
                lvl.status.dt_new = snapped
