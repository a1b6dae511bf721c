"""Controller base: hooks, logging, convergence-controller registry.

The counterpart of ``pysdc_tpu/parallel/controller.py``; mirrors the
reference ``Controller`` (``pySDC/core/controller.py:32-374``):
hook registration, ordered convergence-controller registry (sorted by
``control_order``), and stats merging.  Controllers orchestrate
the device work from the host; all policy logic stays in Python.
"""

from __future__ import annotations

import logging
import sys
from types import SimpleNamespace

import numpy as np

from pysdc_tpu_torch.core.errors import ControllerError, ParameterError
from pysdc_tpu_torch.core.hooks import CPUTimings, DefaultHooks
from pysdc_tpu_torch.convergence.check_convergence import CheckConvergence


class Controller:
    base_convergence_controllers = [CheckConvergence]

    def __init__(self, controller_params: dict, description: dict, useMPI: bool = False):
        self.useMPI = useMPI

        params = {
            'logger_level': 30,
            'log_to_file': False,
            'fname': 'run_pid' + str(0) + '.log',
            'dump_setup': False,
            'all_to_done': False,
            'predict_type': None,
            'mssdc_jac': True,
            'use_iteration_estimator': False,
            'hook_class': [],
            **controller_params,
        }
        self.params = SimpleNamespace(**params)

        # hooks: defaults + timings + user-specified (reference controller.py:50-58)
        hook_classes = [DefaultHooks, CPUTimings]
        user_hooks = params['hook_class']
        hook_classes += user_hooks if isinstance(user_hooks, (list, tuple)) else [user_hooks]
        self.hooks = [cls() for cls in hook_classes]

        self._setup_logging(params)

        # convergence controllers
        self.convergence_controllers = []
        self.convergence_controller_order = []
        self.description = description
        self.setup_convergence_controllers(description)

    # ------------------------------------------------------------------
    def _setup_logging(self, params):
        level = params['logger_level']
        for name in ('controller', 'step', 'level', 'sweeper', 'problem', 'hooks'):
            logging.getLogger(name).setLevel(level)
        if not logging.getLogger('controller').handlers:
            handler = logging.StreamHandler(sys.stdout)
            handler.setFormatter(
                logging.Formatter('%(asctime)s - %(name)s - %(levelname)s: %(message)s')
            )
            logging.getLogger('controller').addHandler(handler)
        self.logger = logging.getLogger('controller')

    def add_hook(self, hook_cls):
        """Add a hook class if not already present (reference controller.py:135)."""
        if hook_cls not in [type(h) for h in self.hooks]:
            self.hooks.append(hook_cls())

    # -- convergence controllers ----------------------------------------
    def setup_convergence_controllers(self, description):
        for cls, cls_params in description.get('convergence_controllers', {}).items():
            self.add_convergence_controller(cls, description, params=cls_params)
        for cls in self.base_convergence_controllers:
            self.add_convergence_controller(cls, description)

    def add_convergence_controller(self, cls, description, params=None):
        """Register a convergence controller once; order by control_order
        (reference controller.py:280-330)."""
        params = params or {}
        if cls not in [type(c) for c in self.convergence_controllers]:
            params['useMPI'] = self.useMPI
            self.convergence_controllers.append(cls(self, params, description))
            orders = [C.params.control_order for C in self.convergence_controllers]
            self.convergence_controller_order = list(np.argsort(orders, kind='stable'))

    def ordered_convergence_controllers(self):
        return [self.convergence_controllers[i] for i in self.convergence_controller_order]

    # ------------------------------------------------------------------
    def all_steps(self):
        raise NotImplementedError

    def return_stats(self):
        stats = {}
        for hook in self.hooks:
            stats = {**stats, **hook.return_stats()}
        return stats

    def run(self, u0, t0, Tend):
        raise NotImplementedError('controller has to implement run(u0, t0, Tend)')

    def dump_setup(self, step, controller_params, description):
        out = ['Controller setup:']
        out.append(f'  controller: {type(self).__name__}')
        out.append('  convergence controllers (ordered):')
        for C in self.ordered_convergence_controllers():
            out.append(f'    {C.params.control_order:+4d}: {type(C).__name__}')
        out.append(f'  levels: {len(step.levels)}')
        for lvl in step.levels:
            out.append(
                f'    level {lvl.level_index}: {type(lvl.prob).__name__} '
                f'{lvl.prob.shape} / {type(lvl.sweep).__name__} M={lvl.sweep.coll.num_nodes}'
            )
        self.logger.info('\n'.join(out))
