"""Step: the level hierarchy of one time step.

The counterpart of ``pysdc_tpu/core/step.py`` (reference ``Step``,
``pySDC/core/step.py:45``): builds the levels from a user-supplied
``description`` dict and carries the status the controllers' stage machine
reads and writes (iter, stage, done, prev_done, ...).  This slice builds
single-level steps; multi-level hierarchies with their transfer operators
wait for ROADMAP queue 1, item 5.
"""

from __future__ import annotations

from types import SimpleNamespace

from pysdc_tpu_torch.core.errors import ParameterError
from pysdc_tpu_torch.core.level import Level


def _num_levels(description: dict) -> int:
    """Levels a description asks for: the longest per-level list
    (reference step.py:174 ``__dict_to_list``)."""
    n = 1
    for key in ('problem_params', 'sweeper_params', 'level_params'):
        for value in description.get(key, {}).values():
            if isinstance(value, list):
                n = max(n, len(value))
    if isinstance(description.get('problem_class'), list):
        n = max(n, len(description['problem_class']))
    return n


def _level_params(params: dict) -> dict:
    """A one-level description may still wrap values in one-entry lists."""
    return {key: value[0] if isinstance(value, list) else value for key, value in params.items()}


class Step:
    """One level + pipeline status."""

    def __init__(self, description: dict):
        self.params = SimpleNamespace(maxiter=description.get('step_params', {}).get('maxiter', 20))
        for key, value in description.get('step_params', {}).items():
            setattr(self.params, key, value)

        self.levels: list[Level] = []
        self.prev = None
        self.next = None
        self.description = description

        self.__generate_hierarchy(description)
        self.status = self._fresh_status()

    def __generate_hierarchy(self, description: dict):
        for key in ('problem_class', 'sweeper_class', 'level_params'):
            if key not in description:
                raise ParameterError(f'need {key!r} in the description dict')

        nlev = _num_levels(description)
        if nlev > 1:
            raise NotImplementedError(
                f'the description asks for {nlev} levels; multi-level steps (MLSDC/PFASST transfers) '
                'are not ported yet (ROADMAP queue 1, item 5)'
            )
        prob_class, sweep_class = description['problem_class'], description['sweeper_class']
        if isinstance(prob_class, (list, tuple)):
            prob_class = prob_class[0]
        if isinstance(sweep_class, (list, tuple)):
            sweep_class = sweep_class[0]

        problem = prob_class(**_level_params(description.get('problem_params', {})))
        sweeper = sweep_class(_level_params(description.get('sweeper_params', {})))
        self.levels.append(Level(problem, sweeper, _level_params(description['level_params']), level_index=0))

    # ------------------------------------------------------------------
    @staticmethod
    def _fresh_status():
        return SimpleNamespace(
            iter=0,
            stage='SPREAD',
            slot=None,
            first=True,
            last=True,
            done=False,
            prev_done=False,
            force_done=False,
            force_continue=False,
            restart=False,
            time_size=1,
        )

    def reset_step(self):
        """Reset all levels — NOT the step status, which persists across
        blocks (reference step.py:248-254; restart counters survive)."""
        for level in self.levels:
            level.reset_level()

    def init_step(self, u0):
        """Seed the finest level with the initial condition."""
        self._u0 = u0

    @property
    def u0(self):
        return self._u0

    @property
    def dt(self):
        return self.levels[0].params.dt

    @property
    def time(self):
        return self.levels[0].status.time

    def transfer(self, source: Level, target: Level):
        """Transfer data between consecutive levels (reference step.py:234)."""
        raise NotImplementedError('space-time transfers are not ported yet (ROADMAP queue 1, item 5)')
