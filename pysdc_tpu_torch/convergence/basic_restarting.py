"""Block-restart propagation with a patience limit.

A copy of ``pysdc_tpu/convergence/basic_restarting.py``; behavioral
counterpart of the reference's ``BasicRestartingNonMPI``
(``convergence_controller_classes/basic_restarting.py:9-218``): once any step
in a block raises the restart flag, every later step in the block restarts
too, and a step that keeps getting restarted eventually either crashes the
run or is forced through, depending on ``crash_after_max_restarts``.
"""

from __future__ import annotations

from types import SimpleNamespace

from pysdc_tpu_torch.core.convergence import ConvergenceController
from pysdc_tpu_torch.core.errors import ConvergenceError


class BasicRestarting(ConvergenceController):
    """Propagate restart flags downstream within a block; limit repeats."""

    def __init__(self, controller, params, description, **kwargs):
        super().__init__(controller, params, description, **kwargs)
        # scratch shared across the block within one convergence check
        self.scratch = SimpleNamespace(cascade=False, patience_exhausted=False)
        self.buffers = self.scratch  # reset_buffers_nonMPI contract

    def setup(self, controller, params, description, **kwargs):
        mine = {
            'control_order': 95,
            'max_restarts': 10,
            'crash_after_max_restarts': True,
            'restart_from_first_step': False,
        }
        from pysdc_tpu_torch.hooks.logging_hooks import LogRestarts

        controller.add_hook(LogRestarts)
        return {**mine, **super().setup(controller, params, description, **kwargs)}

    def dependencies(self, controller, description, **kwargs):
        from pysdc_tpu_torch.convergence.spread_step_sizes import SpreadStepSizesBlockwise

        controller.add_convergence_controller(
            SpreadStepSizesBlockwise,
            description=description,
            params={'spread_from_first_restarted': not self.params.restart_from_first_step},
        )

    def setup_status_variables(self, controller, **kwargs):
        self.add_status_variable_to_step('restart', False)
        self.add_status_variable_to_step('restarts_in_a_row', 0)

    def reset_status_variables(self, controller, **kwargs):
        self.set_step_status_variable('restart', False)

    def reset_buffers_nonMPI(self, controller, **kwargs):
        self.scratch.cascade = False
        self.scratch.patience_exhausted = False

    def determine_restart(self, controller, S, MS=None, **kwargs):
        if S.status.first:
            self.scratch.patience_exhausted = S.status.restarts_in_a_row >= self.params.max_restarts
            if self.scratch.patience_exhausted and S.status.restart:
                if self.params.crash_after_max_restarts:
                    raise ConvergenceError(
                        f'Giving up after {S.status.restarts_in_a_row} consecutive restarts of the same step.'
                    )
                self.log(
                    f'{S.status.restarts_in_a_row} consecutive restarts hit the limit; accepting the step as is.',
                    S,
                )

        # a raised flag anywhere upstream cascades to this and later steps
        self.scratch.cascade = self.scratch.cascade or S.status.restart
        S.status.restart = self.scratch.cascade and not self.scratch.patience_exhausted

        if S.status.last and self.params.restart_from_first_step and not self.scratch.patience_exhausted:
            for other in MS:
                other.status.restart = self.scratch.cascade

    def prepare_next_block(self, controller, S, size, time, Tend, MS=None, **kwargs):
        """Carry each step's consecutive-restart counter to whichever slot
        will re-run its time point in the next block."""
        if S not in MS:
            return
        flagged = [other.status.slot for other in MS if other.status.restart]
        resume_at = min(flagged) if flagged else size - 1
        if S.status.slot < resume_at:
            # this step completed; its counter resets wherever it lands next
            MS[resume_at - S.status.slot].status.restarts_in_a_row = 0
        else:
            successor = MS[S.status.slot - resume_at]
            successor.status.restarts_in_a_row = (
                S.status.restarts_in_a_row + 1 if S.status.restart else 0
            )
