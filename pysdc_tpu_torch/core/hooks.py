"""Hooks and statistics.

The counterpart of ``pysdc_tpu/core/hooks.py``, with the same observability
contract as the reference (``pySDC/core/hooks.py:9-245``): 16 hook points
driven by the controllers, a stats dictionary keyed by the ``Entry``
namedtuple, and a default hook recording residuals and iteration counts.

Hooks are host-side observers.  A value recorded from the device (a 0-d
residual tensor) is kept as it is and read into a Python float only when
the stats are returned, so recording costs no host sync per sweep.
"""

from __future__ import annotations

import logging
import time as _time
from collections import namedtuple
from typing import Any, Dict

import torch

#: stats key (reference core/hooks.py:9-19)
Entry = namedtuple('Entry', ['process', 'process_sweeper', 'time', 'level', 'iter', 'sweep', 'type', 'num_restarts'])


def _to_float(value):
    """Device scalars become host floats for storage in stats."""
    if isinstance(value, torch.Tensor) and value.dim() == 0:
        return value.item()
    return value


class Hooks:
    """Base hook class; subclasses override any of the 16 hook points."""

    def __init__(self):
        self.logger = logging.getLogger('hooks')
        self.__num_restarts = 0
        self.__stats: Dict[Entry, Any] = {}
        self.__entry = Entry

    @property
    def num_restarts(self):
        return self.__num_restarts

    def _set_num_restarts(self, n):
        self.__num_restarts = n

    def _key(self, process, process_sweeper, time, level, iter, sweep, type):
        return self.__entry(
            process=process,
            process_sweeper=process_sweeper,
            time=time,
            level=level,
            iter=iter,
            sweep=sweep,
            type=type,
            num_restarts=self.__num_restarts,
        )

    def add_to_stats(self, value, process, time, level, iter, sweep, type, process_sweeper=0):
        """Add a value to the stats dict (reference hooks.py:52)."""
        self.__stats[self._key(process, process_sweeper, time, level, iter, sweep, type)] = value

    def increment_stats(self, value, initialize=None, process=None, time=None, level=None, iter=None, sweep=None, type=None, process_sweeper=0):
        """Add to an existing stats entry or initialize it (hooks.py:68)."""
        key = self._key(process, process_sweeper, time, level, iter, sweep, type)
        if key in self.__stats:
            self.__stats[key] = self.__stats[key] + value
        elif initialize is not None:
            self.__stats[key] = initialize
        else:
            self.__stats[key] = value

    def return_stats(self):
        """The stats, with device scalars read into floats (one sync here)."""
        self.__stats = {key: _to_float(value) for key, value in self.__stats.items()}
        return self.__stats

    def reset_stats(self):
        self.__stats = {}

    # -- the 16 hook points (reference hooks.py:106-245) ----------------
    def pre_setup(self, step, level_number):
        self._update_restarts(step)

    def pre_run(self, step, level_number):
        self._update_restarts(step)

    def pre_predict(self, step, level_number):
        self._update_restarts(step)

    def pre_step(self, step, level_number):
        self._update_restarts(step)

    def pre_iteration(self, step, level_number):
        self._update_restarts(step)

    def pre_sweep(self, step, level_number):
        self._update_restarts(step)

    def pre_comm(self, step, level_number):
        self._update_restarts(step)

    def post_comm(self, step, level_number, add_to_stats=False):
        self._update_restarts(step)

    def post_sweep(self, step, level_number):
        self._update_restarts(step)

    def post_iteration(self, step, level_number):
        self._update_restarts(step)

    def post_step(self, step, level_number):
        self._update_restarts(step)

    def post_predict(self, step, level_number):
        self._update_restarts(step)

    def post_run(self, step, level_number):
        self._update_restarts(step)

    def post_setup(self, step, level_number):
        self._update_restarts(step)

    def _update_restarts(self, step):
        if step is not None:
            self._set_num_restarts(getattr(step.status, 'restarts_in_a_row', 0))


class DefaultHooks(Hooks):
    """Records residuals and iteration counts, mirroring the reference
    ``DefaultHooks`` (implementations/hooks/default_hook.py)."""

    def post_sweep(self, step, level_number):
        super().post_sweep(step, level_number)
        lvl = step.levels[level_number]
        if self.logger.isEnabledFor(logging.INFO):  # the float() below syncs with the device
            self.logger.info(
                'Process %2i on time %8.6f at stage %15s: Level: %s -- Iteration: %2i -- Sweep: %2i -- residual: %12.8e',
                step.status.slot,
                lvl.time,
                step.status.stage,
                lvl.level_index,
                step.status.iter,
                lvl.status.sweep,
                float(lvl.status.residual) if lvl.status.residual is not None else float('nan'),
            )
        self.add_to_stats(
            process=step.status.slot,
            process_sweeper=lvl.sweep.rank if hasattr(lvl.sweep, 'rank') else 0,
            time=lvl.time,
            level=lvl.level_index,
            iter=step.status.iter,
            sweep=lvl.status.sweep,
            type='residual_post_sweep',
            value=lvl.status.residual,
        )

    def post_iteration(self, step, level_number):
        super().post_iteration(step, level_number)
        lvl = step.levels[level_number]
        self.add_to_stats(
            process=step.status.slot,
            process_sweeper=0,
            time=lvl.time,
            level=-1,
            iter=step.status.iter,
            sweep=lvl.status.sweep,
            type='residual_post_iteration',
            value=lvl.status.residual,
        )

    def post_step(self, step, level_number):
        super().post_step(step, level_number)
        lvl = step.levels[level_number]
        common = dict(
            process=step.status.slot,
            process_sweeper=0,
            time=lvl.time,
            level=lvl.level_index,
            iter=step.status.iter,
            sweep=lvl.status.sweep,
        )
        self.add_to_stats(type='niter', value=step.status.iter, **common)
        self.add_to_stats(type='residual_post_step', value=lvl.status.residual, **common)
        # fine-level dt actually used for this step
        self.add_to_stats(type='dt', value=lvl.dt, **common)


class CPUTimings(Hooks):
    """Wall-clock timings per run/step/iteration/sweep, mirroring the
    reference ``CPUTimings`` (implementations/hooks/log_timings.py:316).
    On the card they time the host's enqueue, not the device's work; use
    :class:`DeviceTimings` for the latter."""

    def __init__(self):
        super().__init__()
        self._t = {}

    def _start(self, key):
        self._t[key] = _time.perf_counter()

    def _stop(self, key):
        # unmatched stops (a post_* hook point whose pre_* never fired) report 0.0
        start = self._t.pop(key, None)
        return 0.0 if start is None else _time.perf_counter() - start

    def pre_run(self, step, level_number):
        super().pre_run(step, level_number)
        self._start('run')

    def post_run(self, step, level_number):
        super().post_run(step, level_number)
        lvl = step.levels[level_number]
        self.add_to_stats(
            process=step.status.slot, time=lvl.time, level=-1, iter=-1, sweep=-1, type='timing_run', value=self._stop('run')
        )

    def _timed_entry(self, step, level_number, type, key):
        lvl = step.levels[level_number]
        self.add_to_stats(
            process=step.status.slot,
            time=lvl.time,
            level=level_number,
            iter=step.status.iter,
            sweep=lvl.status.sweep,
            type=type,
            value=self._stop(key),
        )

    def pre_step(self, step, level_number):
        super().pre_step(step, level_number)
        self._start(('step', step.status.slot))

    def post_step(self, step, level_number):
        super().post_step(step, level_number)
        self._timed_entry(step, level_number, 'timing_step', ('step', step.status.slot))

    def pre_iteration(self, step, level_number):
        super().pre_iteration(step, level_number)
        self._start(('iter', step.status.slot))

    def post_iteration(self, step, level_number):
        super().post_iteration(step, level_number)
        self._timed_entry(step, level_number, 'timing_iteration', ('iter', step.status.slot))

    def pre_sweep(self, step, level_number):
        super().pre_sweep(step, level_number)
        self._start(('sweep', step.status.slot, level_number))

    def post_sweep(self, step, level_number):
        super().post_sweep(step, level_number)
        self._timed_entry(step, level_number, 'timing_sweep', ('sweep', step.status.slot, level_number))


class DeviceTimings(CPUTimings):
    """Per-stage timings that bound the device's work — the counterpart of
    the reference's ``GPUTimings`` (implementations/hooks/log_timings.py:328-340).
    PyTorch returns before the card finishes, so this hook calls
    ``torch.cuda.synchronize()`` at every pre/post boundary before reading
    the clock.  Opt-in: the syncs serialize the host and the card."""

    def _sync(self, step, level_number):
        if step is None:
            return
        try:
            device = step.levels[level_number].prob.device
        except (IndexError, TypeError):
            return
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    def pre_run(self, step, level_number):
        self._sync(step, level_number)
        super().pre_run(step, level_number)

    def post_run(self, step, level_number):
        self._sync(step, level_number)
        super().post_run(step, level_number)

    def pre_step(self, step, level_number):
        self._sync(step, level_number)
        super().pre_step(step, level_number)

    def post_step(self, step, level_number):
        self._sync(step, level_number)
        super().post_step(step, level_number)

    def pre_iteration(self, step, level_number):
        self._sync(step, level_number)
        super().pre_iteration(step, level_number)

    def post_iteration(self, step, level_number):
        self._sync(step, level_number)
        super().post_iteration(step, level_number)

    def pre_sweep(self, step, level_number):
        self._sync(step, level_number)
        super().pre_sweep(step, level_number)

    def post_sweep(self, step, level_number):
        self._sync(step, level_number)
        super().post_sweep(step, level_number)
