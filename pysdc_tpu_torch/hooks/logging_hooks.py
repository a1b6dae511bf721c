"""Logging hooks: solutions, errors, work, step sizes, restarts.

The counterpart of ``pysdc_tpu/hooks/logging_hooks.py``; counterparts of the
reference hook library (``implementations/hooks/``): LogSolution,
LogSolutionAfterIteration, LogToPickleFile (log_solution.py),
LogGlobalErrorPostStep/PostIter, LogLocalErrorPostStep/PostIter
(log_errors.py), LogEmbeddedErrorEstimate (log_embedded_error_estimate.py),
LogExtrapolationErrorEstimate (log_extrapolated_error_estimate.py), LogWork /
LogSDCIterations (log_work.py), LogStepSize (log_step_size.py), LogRestarts
(log_restarts.py) and PlotPostStep (plotting.py).  Stats keys and value
types match the JAX package's: solutions are numpy arrays (one copy to the
host), errors host floats (one read each), work counts ints.
"""

from __future__ import annotations

import os
import pickle

from pysdc_tpu_torch.core.hooks import Hooks
from pysdc_tpu_torch.core.state import norm_max
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


class LogSolutionAfterIteration(Hooks):
    def post_iteration(self, step, level_number):
        super().post_iteration(step, level_number)
        lvl = step.levels[level_number]
        lvl.compute_end_point()
        kw = _entry_kwargs(step, level_number)
        kw['time'] = lvl.time + lvl.dt
        self.add_to_stats(value=to_numpy(lvl.uend), type='u', **kw)


class LogError(Hooks):
    """Base with global/local error computation (reference log_errors.py:5)."""

    def log_global_error(self, step, level_number, suffix=''):
        lvl = step.levels[level_number]
        lvl.compute_end_point()
        try:
            u_ref = lvl.prob.u_exact(lvl.time + lvl.dt)
        except NotImplementedError:
            return
        e = float(norm_max(lvl.uend - u_ref))
        kw = _entry_kwargs(step, level_number)
        kw['time'] = lvl.time + lvl.dt
        self.add_to_stats(value=e, type=f'e_global{suffix}', **kw)
        denom = float(norm_max(u_ref))
        if denom > 0:
            self.add_to_stats(value=e / denom, type=f'e_global_rel{suffix}', **kw)

    def log_local_error(self, step, level_number, suffix=''):
        lvl = step.levels[level_number]
        lvl.compute_end_point()
        try:
            u_loc = lvl.prob.u_exact(lvl.time + lvl.dt, u_init=lvl.u[0], t_init=lvl.time)
        except (NotImplementedError, TypeError):
            return
        e = float(norm_max(lvl.uend - u_loc))
        kw = _entry_kwargs(step, level_number)
        kw['time'] = lvl.time + lvl.dt
        self.add_to_stats(value=e, type=f'e_local{suffix}', **kw)


class LogGlobalErrorPostStep(LogError):
    def post_step(self, step, level_number):
        super().post_step(step, level_number)
        self.log_global_error(step, level_number, suffix='_post_step')


class LogGlobalErrorPostIter(LogError):
    def post_iteration(self, step, level_number):
        super().post_iteration(step, level_number)
        self.log_global_error(step, level_number, suffix='_post_iteration')


class LogLocalErrorPostStep(LogError):
    def post_step(self, step, level_number):
        super().post_step(step, level_number)
        self.log_local_error(step, level_number, suffix='_post_step')


class LogLocalErrorPostIter(LogError):
    def post_iteration(self, step, level_number):
        super().post_iteration(step, level_number)
        self.log_local_error(step, level_number, suffix='_post_iteration')


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


class LogWork(Hooks):
    """Log work counters per step (reference log_work.py:4-56): ``work_<key>``
    is what the problem's counter ``key`` gained during the step (the level
    counts M evaluations and M solves per sweep)."""

    def __init__(self):
        super().__init__()
        self.__work_last_step = {}

    def pre_step(self, step, level_number):
        super().pre_step(step, level_number)
        lvl = step.levels[level_number]
        self.__work_last_step[level_number] = {
            key: counter.niter for key, counter in lvl.prob.work_counters.items()
        }

    def post_step(self, step, level_number):
        super().post_step(step, level_number)
        lvl = step.levels[level_number]
        kw = _entry_kwargs(step, level_number)
        kw['time'] = lvl.time + lvl.dt
        for key, counter in lvl.prob.work_counters.items():
            self.add_to_stats(
                value=counter.niter - self.__work_last_step[level_number].get(key, 0),
                type=f'work_{key}',
                **kw,
            )


class LogSDCIterations(Hooks):
    """Log the number of SDC iterations per step as 'k'."""

    name = 'k'

    def post_step(self, step, level_number):
        super().post_step(step, level_number)
        lvl = step.levels[level_number]
        kw = _entry_kwargs(step, level_number)
        kw['time'] = lvl.time + lvl.dt
        self.increment_stats(value=step.status.iter, type=self.name, **kw)


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


class LogExtrapolationErrorEstimate(Hooks):
    """Log the Taylor-extrapolation error estimate
    (reference log_extrapolated_error_estimate.py: type
    'error_extrapolation_estimate', filled by EstimateExtrapolationError)."""

    def post_step(self, step, level_number):
        super().post_step(step, level_number)
        lvl = step.levels[level_number]
        est = getattr(lvl.status, 'error_extrapolation_estimate', None)
        if est is not None:
            self.add_to_stats(
                value=est, type='error_extrapolation_estimate', **_entry_kwargs(step, level_number)
            )


class LogToPickleFile(Hooks):
    """Pickle the solution after every step into ``path/file_name_<time>.pickle``
    (reference log_solution.py:73-130: LogToPickleFile).  Class attributes
    ``path``/``file_name``/``logging_condition`` configure it, matching the
    reference's classmethod-configured pattern; the pickled solution is a
    numpy array."""

    path = None
    file_name = 'solution'

    @staticmethod
    def logging_condition(lvl):
        return True

    @classmethod
    def process_solution(cls, lvl):
        return {'t': float(lvl.time + lvl.dt), 'u': to_numpy(lvl.uend)}

    def post_step(self, step, level_number):
        super().post_step(step, level_number)
        lvl = step.levels[level_number]
        if not type(self).logging_condition(lvl):
            return
        lvl.compute_end_point()
        path = type(self).path or '.'
        os.makedirs(path, exist_ok=True)
        data = type(self).process_solution(lvl)
        with open(os.path.join(path, f'{type(self).file_name}_{lvl.time + lvl.dt:.8f}.pickle'), 'wb') as fh:
            pickle.dump(data, fh)


class PlotPostStep(Hooks):
    """Render the solution after each (plot_every-th) step
    (reference implementations/hooks/plotting.py: PlotPostStep).  Uses the
    problem's ``plot`` protocol when present, else a line/imshow fallback;
    saves PNGs to ``save_plot`` if set (never blocks on a GUI).  matplotlib is
    imported at the first plot, not with the module."""

    save_plot = None  # path prefix; None -> keep figures in memory only
    plot_every = 1

    def __init__(self):
        super().__init__()
        self.__counter = 0

    def post_step(self, step, level_number):
        super().post_step(step, level_number)
        self.__counter += 1
        if self.__counter % type(self).plot_every:
            return
        import matplotlib

        matplotlib.use('Agg', force=False)
        import matplotlib.pyplot as plt

        lvl = step.levels[level_number]
        lvl.compute_end_point()
        prob = lvl.prob
        if hasattr(prob, 'plot'):
            fig = prob.plot(lvl.uend, t=lvl.time + lvl.dt)
        else:
            fig, ax = plt.subplots()
            u = to_numpy(lvl.uend)
            if u.ndim >= 2:
                ax.imshow(u.reshape(u.shape[-2], u.shape[-1]) if u.ndim > 2 else u)
            else:
                ax.plot(u)
            ax.set_title(f't = {lvl.time + lvl.dt:.4f}')
        if type(self).save_plot is not None:
            fig = fig if fig is not None else plt.gcf()
            fig.savefig(f'{type(self).save_plot}_{self.__counter:06d}.png', dpi=100)
        plt.close('all')
