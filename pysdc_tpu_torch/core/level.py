"""Level: one (problem, sweeper) pair plus its device state.

The counterpart of ``pysdc_tpu/core/level.py`` (reference ``Level``,
``pySDC/core/level.py:42``).  The node data is one :class:`LevelState`, and
every protocol method calls the sweeper eagerly: PyTorch needs no tracing,
so the JAX package's jitted wrappers have no counterpart here.
"""

from __future__ import annotations

import logging
from types import SimpleNamespace

import numpy as np
import torch

from pysdc_tpu_torch.core.errors import ParameterError, UnlockError
from pysdc_tpu_torch.core.state import LevelState, map_components


class LevelParams(SimpleNamespace):
    def __init__(self, params: dict):
        if 'dt' not in params and params.get('require_dt', True):
            raise ParameterError("need 'dt' in level_params")
        super().__init__(
            dt=params.get('dt'),
            dt_initial=params.get('dt'),
            restol=params.get('restol', -1.0),
            e_tol=params.get('e_tol', -1.0),
            nsweeps=params.get('nsweeps', 1),
            residual_type=params.get('residual_type', 'full_abs'),
        )
        for key, value in params.items():
            if not hasattr(self, key):
                setattr(self, key, value)


def _fresh_status():
    return SimpleNamespace(residual=None, unlocked=False, updated=False, time=None, dt_new=None, sweep=1)


class Level:
    """Owns problem + sweeper + state; exposes the reference's level protocol."""

    def __init__(self, problem, sweeper, level_params: dict, level_index: int = 0):
        self.prob = problem
        self.sweep = sweeper
        self.sweep.level = self
        self.params = LevelParams(dict(level_params))
        self.level_index = level_index

        if getattr(sweeper, 'is_direct_solver', False) and self.params.restol > 0:
            # RK methods are direct solvers and may not compute a residual at
            # all (reference Runge_Kutta.py:322-328)
            logging.getLogger('level').warning('Overwriting residual tolerance with -1 because RK methods are direct!')
            self.params.restol = -1.0
        #: the sweeper keeps host state across steps (the multistep history): every level runs its sweeper
        #: eagerly, and the fused lanes, which capture sweeps into CUDA graphs, refuse it
        self.host_stateful = bool(getattr(sweeper, 'host_stateful', False))

        self.state: LevelState | None = None
        self.uend = None
        self.uend_secondary = None  # embedded RK lower-order end point
        self.uold = None  # u and f as restriction left them, for the FAS prolongation
        self.fold = None
        self.residual = None  # (M, *shape) node residuals of last computation

        self.extra_status_vars: dict = {}
        self.status = _fresh_status()
        self.tag = None

        # amortized shifted-solve factorizations: the QDelta diagonal and dt
        # are known here, so operators can factor once per run (the
        # reference's dt-keyed splu cache, generic_ND_FD.py:208-240)
        QI = getattr(self.sweep, 'QI', None)
        if QI is not None and self.params.dt is not None:
            self.prob.prepare_node_solvers(float(self.params.dt), np.diag(np.asarray(QI))[1:])

    # -- properties mirroring the reference's level surface ------------
    @property
    def time(self):
        return self.status.time

    @property
    def dt(self):
        return self.params.dt

    @property
    def u(self):
        return self.state.u if self.state is not None else None

    @property
    def f(self):
        return self.state.f if self.state is not None else None

    @property
    def tau(self):
        return self.state.tau if self.state is not None else None

    # -- protocol ------------------------------------------------------
    def reset_level(self, reset_status: bool = True):
        """Reset all level data (reference level.py:110)."""
        if reset_status:
            self.status = _fresh_status()
            for name, init in self.extra_status_vars.items():
                setattr(self.status, name, init)
        self.state = None
        self.uend = None
        self.uend_secondary = None
        self.uold = None
        self.fold = None
        self.residual = None
        self.tag = None

    def predict(self, u0):
        """Fill node values from u0 using the sweeper's initial guess."""
        rv = self.sweep.draw_random_val() if self.sweep.initial_guess == 'random' else 0.0
        self.state = self.sweep.predict(self.prob, u0, self.status.time, self.params.dt, rv)
        self.status.unlocked = True
        self.status.updated = True

    def update_nodes(self):
        """One sweep (reference sweeper protocol update_nodes)."""
        if not self.status.unlocked:
            raise UnlockError('level is still locked, cannot use data from there')
        k = self.status.sweep if self.sweep.k_dependent else 0
        self.state = self.sweep.update_nodes(self.prob, self.state, self.status.time, self.params.dt, k)
        self.status.updated = True

    def compute_residual(self, stage: str = ''):
        """Residual of the current state; ``status.residual`` is a 0-d tensor
        on the device, read on the host only where a policy needs it."""
        if stage in self.sweep.skip_residual_computation:
            self.status.residual = 0.0 if self.status.residual is None else self.status.residual
            return
        self.residual, self.status.residual = self.sweep.compute_residual(
            self.state, self.params.dt, residual_type=self.params.residual_type, t=self.status.time
        )
        self.status.updated = False

    def compute_end_point(self):
        if getattr(self.sweep, 'is_embedded', None) and self.sweep.is_embedded():
            self.uend, self.uend_secondary = self.sweep.compute_end_point_with_secondary(
                self.state, self.status.time, self.params.dt)
        else:
            self.uend = self.sweep.compute_end_point(self.state, self.status.time, self.params.dt)

    def integrate(self):
        return self.sweep.integrate(self.state, self.params.dt)

    def set_u0(self, u0, eval_f: bool = True):
        """Replace u[0] (and re-evaluate f[0]) — the "recv" of the pipeline
        (reference controller_nonMPI.py:269-284).  ``u`` may be a container
        of tensors (``Particles``), each with the node axis in front."""
        u = map_components(lambda leaf, new: torch.cat([new.unsqueeze(0), leaf[1:]]), self.state.u, u0)
        f = self.state.f
        if eval_f:
            f0 = self.prob.eval_f(u0, self.status.time)
            f = map_components(lambda leaf, new: torch.cat([new.unsqueeze(0), leaf[1:]]), f, f0)
        self.state = LevelState(u=u, f=f, tau=self.state.tau)
