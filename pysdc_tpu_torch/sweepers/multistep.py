"""Linear multistep methods as "sweepers".

The counterpart of ``pysdc_tpu/sweepers/multistep.py`` (reference
``MultiStep`` family, ``implementations/sweeper_classes/Multistep.py``): an
N-step method keeps a rolling window of previous (t, u, f) values on the host
(the values themselves are tensors on the problem's device); each step is one
Euleresque solve with the weighted history as right-hand side.  The history
makes this sweeper host-stateful: the level runs it eagerly (as every level of
this package does) and the fused lanes, which capture sweeps into CUDA graphs,
refuse it (a capture would freeze the window it read).
"""

from __future__ import annotations

from collections import deque

import torch

from pysdc_tpu_torch.core.state import LevelState
from pysdc_tpu_torch.core.sweeper import Sweeper


class History:
    """Rolling window of the last N accepted steps, oldest first."""

    def __init__(self, depth: int):
        self.depth = depth
        self._entries: deque = deque(maxlen=depth)  # (t, u, f) tuples

    def push(self, t, u, f):
        self._entries.append((t, u, f))

    @property
    def full(self) -> bool:
        return len(self._entries) == self.depth

    @property
    def empty(self) -> bool:
        return not self._entries

    def column(self, idx):
        """All stored values of one component: 0 = t, 1 = u, 2 = f."""
        return [entry[idx] for entry in self._entries]


class MultiStep(Sweeper):
    """Class attrs: alpha (N solution weights), beta (N+1 RHS weights, last
    one implicit).  First entries belong to the furthest past."""

    alpha: list = None
    beta: list = None

    #: the history lives on the host across steps
    host_stateful = True
    is_direct_solver = True
    graph_capture_blocker = ('a multistep sweeper keeps its history of earlier steps on the host, which a CUDA graph '
                             'would freeze at its capture: this configuration runs on the stage-machine path')

    def __init__(self, params: dict):
        params = dict(params)
        params['num_nodes'] = 1
        params['quad_type'] = 'RADAU-RIGHT'
        params.setdefault('skip_residual_computation', ('IT_CHECK', 'IT_FINE', 'IT_COARSE', 'IT_UP', 'IT_DOWN'))
        super().__init__(params)
        self.steps = len(self.alpha)
        self.history = History(self.steps)

    def predict(self, prob, u0, t, dt, random_val: float = 0.0) -> LevelState:
        f0 = prob.eval_f(u0, t)
        if self.history.empty:
            self.history.push(float(t), u0, f0)
        tau = torch.zeros((1,) + tuple(u0.shape), dtype=u0.dtype, device=u0.device)
        return LevelState(u=torch.stack([u0, u0]), f=torch.stack([f0, f0]), tau=tau)

    def compute_residual(self, state, dt, residual_type='full_abs', t=0.0, time_axis=False):
        return torch.zeros_like(state.tau), torch.zeros((), dtype=state.u.dtype, device=state.u.device)

    def update_nodes(self, prob, state: LevelState, t, dt, k: int = 0) -> LevelState:
        time = t + dt
        if not self.history.full:
            u1 = self.generate_starting_values(prob, state, t, dt)
        else:
            ts = self.history.column(0)
            us = self.history.column(1)
            fs = self.history.column(2)
            # spacing of each history point to its successor (the newest
            # pairs with the step being computed)
            spacings = [t1 - t0 for t0, t1 in zip(ts, ts[1:] + [float(time)])]
            accum = torch.zeros_like(state.u[0])
            for a, b, h, u_i, f_i in zip(self.alpha, self.beta, spacings, us, fs):
                accum = accum + h * b * f_i - a * u_i
            u1 = prob.solve_system(accum, dt * self.beta[-1], us[-1], time)

        f1 = prob.eval_f(u1, time)
        self.history.push(float(time), u1, f1)
        return LevelState(u=torch.stack([state.u[0], u1]), f=torch.stack([state.f[0], f1]), tau=state.tau)

    def generate_starting_values(self, prob, state, t, dt):
        raise NotImplementedError(
            f'{type(self).__name__} needs a starting procedure until its '
            f'{self.steps}-deep history is filled'
        )

    def reset_history(self):
        self.history = History(self.steps)


class AdamsBashforthExplicit1Step(MultiStep):
    """Forward Euler as a 1-step method."""

    alpha = [-1.0]
    beta = [1.0, 0.0]


class BackwardEulerMultiStep(MultiStep):
    alpha = [-1.0]
    beta = [0.0, 1.0]


class AdamsMoultonImplicit1Step(MultiStep):
    """Trapezoidal rule as a multistep method."""

    alpha = [-1.0]
    beta = [0.5, 0.5]


class AdamsMoultonImplicit2Step(MultiStep):
    """Third-order implicit Adams-Moulton."""

    alpha = [0.0, -1.0]
    beta = [-1.0 / 12.0, 8.0 / 12.0, 5.0 / 12.0]

    def generate_starting_values(self, prob, state, t, dt):
        """Trapezoidal-rule starting step (reference Multistep.py:232-245)."""
        rhs = state.u[0] + dt / 2 * state.f[0]
        return prob.solve_system(rhs, dt / 2.0, state.u[0], t + dt)
