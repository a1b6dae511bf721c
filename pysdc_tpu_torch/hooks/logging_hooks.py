"""Logging hooks.

The counterpart of ``pysdc_tpu/hooks/logging_hooks.py``.  Ported:
``LogRestarts`` (reference ``implementations/hooks/log_restarts.py``), which
``BasicRestarting`` registers, and the hooks of the adaptive stack:
``LogSolution`` (log_solution.py), ``LogEmbeddedErrorEstimate``
(log_embedded_error_estimate.py, which ``EstimateEmbeddedError`` registers)
and ``LogStepSize`` (log_step_size.py).  The other logging hooks wait for
ROADMAP queue 1, item 13.  Stats keys and types match the reference.
"""

from __future__ import annotations

from pysdc_tpu_torch.core.hooks import Hooks
from pysdc_tpu_torch.utils.convert import to_numpy


def _entry_kwargs(step, level_number):
    lvl = step.levels[level_number]
    return dict(
        process=step.status.slot,
        process_sweeper=getattr(lvl.sweep, 'rank', 0),
        time=lvl.time,
        level=lvl.level_index,
        iter=step.status.iter,
        sweep=lvl.status.sweep,
    )


class LogSolution(Hooks):
    """Log u (and uend) after each step as type 'u' (a numpy array: one copy
    to the host per step)."""

    def post_step(self, step, level_number):
        super().post_step(step, level_number)
        lvl = step.levels[level_number]
        lvl.compute_end_point()
        kw = _entry_kwargs(step, level_number)
        kw['time'] = lvl.time + lvl.dt
        self.add_to_stats(value=to_numpy(lvl.uend), type='u', **kw)


class LogEmbeddedErrorEstimate(Hooks):
    """Log the embedded error estimate after each iteration/step."""

    def log_error(self, step, level_number, appendix=''):
        lvl = step.levels[level_number]
        est = getattr(lvl.status, 'error_embedded_estimate', None)
        if est is not None:
            self.add_to_stats(
                value=est, type=f'error_embedded_estimate{appendix}', **_entry_kwargs(step, level_number)
            )

    def post_iteration(self, step, level_number):
        super().post_iteration(step, level_number)
        self.log_error(step, level_number)

    def post_step(self, step, level_number):
        super().post_step(step, level_number)
        self.log_error(step, level_number, appendix='_post_step')


class LogStepSize(Hooks):
    def post_step(self, step, level_number):
        super().post_step(step, level_number)
        lvl = step.levels[level_number]
        self.add_to_stats(value=lvl.dt, type='dt', **_entry_kwargs(step, level_number))


class LogRestarts(Hooks):
    def post_step(self, step, level_number):
        super().post_step(step, level_number)
        self.add_to_stats(
            value=int(getattr(step.status, 'restart', False)),
            type='restart',
            **_entry_kwargs(step, level_number),
        )
