"""Logging hooks.

The counterpart of ``pysdc_tpu/hooks/logging_hooks.py``.  This slice ports
``LogRestarts`` (reference ``implementations/hooks/log_restarts.py``), which
``BasicRestarting`` registers; the other logging hooks wait for ROADMAP
queue 1, item 13.  Stats keys and types match the reference.
"""

from __future__ import annotations

from pysdc_tpu_torch.core.hooks import Hooks


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


class LogRestarts(Hooks):
    def post_step(self, step, level_number):
        super().post_step(step, level_number)
        self.add_to_stats(
            value=int(getattr(step.status, 'restart', False)),
            type='restart',
            **_entry_kwargs(step, level_number),
        )
