"""Profiling hooks: ``torch.profiler`` traces of controller runs.

The counterpart of ``pysdc_tpu/hooks/profiling.py``.  The reference
instruments with Score-P in a patched controller
(projects/Performance/controller_MPI_scorep.py); here the run is recorded by
``torch.profiler`` (host activity and, where a card is present, its kernels)
and written as a Chrome trace under ``trace_dir``, viewable in Perfetto or
``chrome://tracing``.
"""

from __future__ import annotations

import os
import tempfile

import torch

from pysdc_tpu_torch.core.hooks import Hooks


class ProfilerHook(Hooks):
    """Traces the whole run into ``trace_dir`` (class attribute) as
    ``trace_<n>.json``, one file a run; the last one is ``ProfilerHook.last_trace``."""

    trace_dir = os.path.join(tempfile.gettempdir(), 'pysdc_tpu_torch_trace')
    _profiler = None
    last_trace = None

    def pre_run(self, step, level_number):
        super().pre_run(step, level_number)
        if ProfilerHook._profiler is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            ProfilerHook._profiler = torch.profiler.profile(activities=activities)
            ProfilerHook._profiler.__enter__()

    def post_run(self, step, level_number):
        super().post_run(step, level_number)
        prof = ProfilerHook._profiler
        if prof is not None:
            ProfilerHook._profiler = None
            prof.__exit__(None, None, None)
            os.makedirs(self.trace_dir, exist_ok=True)
            n = len([name for name in os.listdir(self.trace_dir) if name.startswith('trace_')])
            ProfilerHook.last_trace = os.path.join(self.trace_dir, f'trace_{n}.json')
            prof.export_chrome_trace(ProfilerHook.last_trace)
