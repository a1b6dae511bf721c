"""Interpolate the collocation polynomial as initial guess after restarts.

The counterpart of ``pysdc_tpu/convergence/interpolate_between_restarts.py``;
mirrors reference ``InterpolateBetweenRestarts``
(convergence_controller_classes/interpolate_between_restarts.py): when a step
is restarted with a smaller dt, the node values of the rejected attempt are
interpolated onto the new node positions and override the sweeper's
prediction.  The interpolation contracts the node axis (the first) with a
small host-built matrix.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from pysdc_tpu_torch.core.convergence import ConvergenceController
from pysdc_tpu_torch.core.state import LevelState, map_components
from pysdc_tpu_torch.ops.lagrange import interpolation_matrix


def _contract(P, leaf):
    return torch.tensordot(torch.as_tensor(P, dtype=leaf.dtype, device=leaf.device), leaf, dims=([1], [0]))


class InterpolateBetweenRestarts(ConvergenceController):
    def setup(self, controller, params, description, **kwargs):
        return {'control_order': 50, **super().setup(controller, params, description, **kwargs)}

    def setup_status_variables(self, controller, **kwargs):
        self.status = SimpleNamespace(u_inter=[], f_inter=[], perform_interpolation=False)

    def post_iteration_processing(self, controller, step, **kwargs):
        if step.status.restart and all(level.status.dt_new for level in step.levels):
            self.status.u_inter = []
            self.status.f_inter = []
            for level in step.levels:
                nodes_old = np.append(0, level.sweep.coll.nodes)
                nodes_new = np.append(0, level.sweep.coll.nodes * level.status.dt_new / level.params.dt)
                P = interpolation_matrix(nodes_old, nodes_new)
                self.status.u_inter.append(_contract(P, level.state.u))
                self.status.f_inter.append(map_components(lambda leaf: _contract(P, leaf), level.state.f))
                self.status.perform_interpolation = True
                self.log(
                    f'Interpolating before restart from dt={level.params.dt:.2e} to dt={level.status.dt_new:.2e}',
                    step,
                )
        else:
            self.status.perform_interpolation = False

    def post_spread_processing(self, controller, step, **kwargs):
        if self.status.perform_interpolation:
            for i, level in enumerate(step.levels):
                level.state = LevelState(
                    u=self.status.u_inter[i], f=self.status.f_inter[i], tau=level.state.tau
                )
            self.status.perform_interpolation = False
            self.status.u_inter = []
            self.status.f_inter = []
