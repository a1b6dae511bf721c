"""Distribute an adapted step size over the next block of virtual steps.

A copy of ``pysdc_tpu/convergence/spread_step_sizes.py``; behavioral
counterpart of the reference's ``SpreadStepSizesBlockwiseNonMPI``
(``convergence_controller_classes/spread_step_sizes.py:5-158``): after a
block finishes (or restarts), pick the donor step whose dt proposal should
seed the whole next block, optionally capping it so the run can still land
on Tend.
"""

from __future__ import annotations

import numpy as np

from pysdc_tpu_torch.core.convergence import ConvergenceController


class SpreadStepSizesBlockwise(ConvergenceController):
    def setup(self, controller, params, description, **kwargs):
        mine = {
            'control_order': +100,
            'spread_from_first_restarted': True,
            'overwrite_to_reach_Tend': True,
        }
        return {**mine, **super().setup(controller, params, description, **kwargs)}

    def _pick_donor(self, MS):
        """Choose (donor index, restart index) for the next block.

        Without restarts the last step donates.  With restarts, either the
        first restarted step donates, or — when configured — the restarted
        step holding the *smallest* proposal, so the retry cannot overshoot.
        """
        flagged = [i for i, step in enumerate(MS) if step.status.restart]
        if not flagged:
            tail = len(MS) - 1
            return tail, tail
        cut = flagged[0]
        if self.params.spread_from_first_restarted:
            return cut, cut
        proposals = [
            step.levels[0].status.dt_new if step.levels[0].status.dt_new else 1e9
            for step in MS
        ]
        return cut + int(np.argmin(proposals[cut:])), cut

    def prepare_next_block(self, controller, S, size, time, Tend, MS=None, **kwargs):
        if S not in MS:
            return
        donor_idx, cut = self._pick_donor(MS)

        if self.params.overwrite_to_reach_Tend:
            # remaining interval after the restart point, split over the block
            offsets = [0.0] + [step.dt for step in MS if not step.status.first]
            ceiling = (Tend - time[cut] - offsets[cut]) / size
        else:
            ceiling = np.inf

        donor = MS[donor_idx]
        chosen = []
        for i, lvl in enumerate(donor.levels):
            want = lvl.status.dt_new if lvl.status.dt_new is not None else lvl.params.dt
            got = min(want, max(ceiling, lvl.params.dt_initial))
            chosen.append(got)
            if got < want and i == 0 and lvl.status.dt_new is not None:
                self.log(f'Capping dt at {got:.2e} so the block can land on Tend={Tend:.2e}', S)

        for lvl, dt in zip(S.levels, chosen):
            lvl.params.dt = dt
