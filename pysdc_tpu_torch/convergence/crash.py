"""Crash/abort policies: stop on NaN/overflow or max runtime.

The counterpart of ``pysdc_tpu/convergence/crash.py``; mirrors reference
``StopAtNan`` / ``StopAtMaxRuntime`` (convergence_controller_classes/crash.py:40-140).
``StopAtNan`` reads two scalars a step on the host (all finite, max norm).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pysdc_tpu_torch.core.convergence import ConvergenceController
from pysdc_tpu_torch.core.errors import ConvergenceError
from pysdc_tpu_torch.core.state import norm_max


class CrashBase(ConvergenceController):
    def communicate_crash(self, crash, msg=''):
        if crash:
            raise ConvergenceError(msg)


class StopAtNan(CrashBase):
    def setup(self, controller, params, description, **kwargs):
        defaults = {'control_order': 94, 'thresh': np.inf}
        return {**defaults, **super().setup(controller, params, description, **kwargs)}

    def prepare_next_block(self, controller, S, *args, **kwargs):
        crash = False
        for lvl in S.levels:
            if lvl.state is None:
                continue
            isfinite = bool(torch.isfinite(lvl.state.u).all())
            below = float(norm_max(lvl.state.u)) < self.params.thresh if isfinite else False
            crash = not (isfinite and below)
            if crash:
                break
        self.communicate_crash(crash, msg=f'Solution exceeds bounds! Crashing code at {S.time}!')


class StopAtMaxRuntime(CrashBase):
    def setup(self, controller, params, description, **kwargs):
        defaults = {'control_order': 94, 'max_runtime': np.inf}
        self.t0 = time.perf_counter()
        return {**defaults, **super().setup(controller, params, description, **kwargs)}

    def prepare_next_block(self, controller, S, *args, **kwargs):
        crash = time.perf_counter() - self.t0 > self.params.max_runtime
        self.communicate_crash(
            crash, msg=f'Exceeding max. runtime of {self.params.max_runtime}s! Crashing code at {S.time}!'
        )
