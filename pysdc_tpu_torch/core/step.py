"""Step: the level hierarchy of one time step.

The counterpart of ``pysdc_tpu/core/step.py`` (reference ``Step``,
``pySDC/core/step.py:45``): builds the level list from a user-supplied
``description`` dict, connects consecutive levels with space-time transfer
operators (FAS), and carries the status the controllers' stage machine
reads and writes (iter, stage, done, prev_done, ...).
"""

from __future__ import annotations

from types import SimpleNamespace

from pysdc_tpu_torch.core.errors import ParameterError
from pysdc_tpu_torch.core.level import Level


def _per_level(params: dict, num_levels: int) -> list[dict]:
    """Expand dict values that are lists into per-level dicts; shorter lists
    repeat their last entry (reference step.py:174 ``__dict_to_list``)."""
    out = []
    for lvl in range(num_levels):
        d = {}
        for key, value in params.items():
            if isinstance(value, list):
                d[key] = value[min(lvl, len(value) - 1)]
            else:
                d[key] = value
        out.append(d)
    return out


def _num_levels(description: dict) -> int:
    n = 1
    for key in ('problem_params', 'sweeper_params', 'level_params'):
        for value in description.get(key, {}).values():
            if isinstance(value, list):
                n = max(n, len(value))
    if isinstance(description.get('problem_class'), list):
        n = max(n, len(description['problem_class']))
    return n


class Step:
    """Hierarchy of levels + transfer operators + pipeline status."""

    def __init__(self, description: dict):
        self.params = SimpleNamespace(maxiter=description.get('step_params', {}).get('maxiter', 20))
        for key, value in description.get('step_params', {}).items():
            setattr(self.params, key, value)

        self.levels: list[Level] = []
        self.base_transfers = []
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
        prob_classes = description['problem_class']
        if not isinstance(prob_classes, (list, tuple)):
            prob_classes = [prob_classes] * nlev
        sweep_classes = description['sweeper_class']
        if not isinstance(sweep_classes, (list, tuple)):
            sweep_classes = [sweep_classes] * nlev

        prob_params = _per_level(description.get('problem_params', {}), nlev)
        sweep_params = _per_level(description.get('sweeper_params', {}), nlev)
        level_params = _per_level(description.get('level_params', {}), nlev)

        for lvl in range(nlev):
            problem = prob_classes[lvl](**prob_params[lvl])
            sweeper = sweep_classes[lvl](sweep_params[lvl])
            self.levels.append(Level(problem, sweeper, level_params[lvl], level_index=lvl))

        # connect consecutive levels with base transfer (FAS) operators
        if nlev > 1:
            from pysdc_tpu_torch.transfer.base_transfer import BaseTransfer
            from pysdc_tpu_torch.transfer.space_mesh import MeshTransfer

            base_transfer_class = description.get('base_transfer_class', BaseTransfer)
            space_transfer_class = description.get('space_transfer_class', MeshTransfer)
            base_params = description.get('base_transfer_params', {})
            space_params = description.get('space_transfer_params', {})
            for lvl in range(nlev - 1):
                self.base_transfers.append(
                    base_transfer_class(
                        self.levels[lvl], self.levels[lvl + 1], base_params, space_transfer_class, space_params
                    )
                )

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
        si = source.level_index
        ti = target.level_index
        if ti == si + 1:
            self.base_transfers[si].restrict()
        elif ti == si - 1:
            self.base_transfers[ti].prolong()
        else:
            raise ParameterError(f'cannot transfer from level {si} to non-neighbor {ti}')
