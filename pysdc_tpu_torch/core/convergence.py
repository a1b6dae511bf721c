"""Convergence-controller base: pluggable iteration policies.

A copy of ``pysdc_tpu/core/convergence.py``.

Same callback protocol and ordering semantics as the reference
(``pySDC/core/convergence_controller.py:35-494``): controllers register
policy modules sorted by ``control_order``; the time-loop controllers invoke
the callbacks at fixed points.  All policies are host-side — they read
device scalars (residuals, error estimates) once per iteration and steer the
sweeps via plain Python state.
"""

from __future__ import annotations

import logging
from types import SimpleNamespace


class Pars(SimpleNamespace):
    def __init__(self, params: dict):
        super().__init__(**params)

    def get(self, key, default=None):
        return getattr(self, key, default)


class ConvergenceController:
    """Base class; subclasses override any subset of the callbacks."""

    def __init__(self, controller, params: dict, description: dict, **kwargs):
        self.controller = controller
        self.params = Pars(self.setup(controller, params, description, **kwargs))
        if not hasattr(self.params, 'control_order'):
            self.params.control_order = 0
        self.logger = logging.getLogger(type(self).__name__)
        self.dependencies(controller, description, **kwargs)

    # -- configuration --------------------------------------------------
    def setup(self, controller, params: dict, description: dict, **kwargs) -> dict:
        """Merge user params over whatever was passed; manual registrations of
        the same class in ``description['convergence_controllers']`` take
        priority (reference convergence_controller.py:110-142).  Subclasses
        wrap this as ``{**defaults, **super().setup(...)}`` so their defaults
        lose only against explicit user choices."""
        user = {}
        for cls, cls_params in description.get('convergence_controllers', {}).items():
            if cls == type(self):
                user = dict(cls_params)
        return {'useMPI': False, **params, **user}

    def dependencies(self, controller, description: dict, **kwargs):
        pass

    # -- iteration-loop callbacks (invocation points match the reference)
    def check_iteration_status(self, controller, S, **kwargs):
        pass

    def get_new_step_size(self, controller, S, **kwargs):
        pass

    def determine_restart(self, controller, S, **kwargs):
        pass

    def reset_status_variables(self, controller, **kwargs):
        pass

    def setup_status_variables(self, controller, **kwargs):
        pass

    def reset_buffers_nonMPI(self, controller, **kwargs):
        pass

    def pre_iteration_processing(self, controller, S, **kwargs):
        pass

    def post_iteration_processing(self, controller, S, **kwargs):
        pass

    def post_step_processing(self, controller, S, **kwargs):
        pass

    def post_run_processing(self, controller, S, **kwargs):
        pass

    def prepare_next_block(self, controller, S, size, time, Tend, **kwargs):
        pass

    def post_spread_processing(self, controller, S, **kwargs):
        pass

    def convergence_control(self, controller, S, **kwargs):
        """Fixed sub-order within one iteration (reference :337-355)."""
        self.get_new_step_size(controller, S, **kwargs)
        self.determine_restart(controller, S, **kwargs)
        self.check_iteration_status(controller, S, **kwargs)

    # -- status-variable injection (reference :455-494) -----------------
    # injected variables are also recorded on the owning object so they
    # survive reset_level/reset_step across blocks
    def add_status_variable_to_step(self, name, init=None):
        for S in self.controller.all_steps():
            setattr(S.status, name, init)

    def set_step_status_variable(self, name, value):
        for S in self.controller.all_steps():
            setattr(S.status, name, value)

    def add_status_variable_to_level(self, name, init=None):
        for S in self.controller.all_steps():
            for L in S.levels:
                L.extra_status_vars[name] = init
                setattr(L.status, name, init)

    def set_level_status_variable(self, name, value):
        for S in self.controller.all_steps():
            for L in S.levels:
                setattr(L.status, name, value)

    # -- logging --------------------------------------------------------
    def log(self, msg, S=None, level=15):
        slot = S.status.slot if S is not None else '-'
        self.logger.log(level, f'Process {slot}: {msg}')

    def debug(self, msg, S=None):
        self.log(msg, S, level=logging.DEBUG)
