"""2D Brusselator reaction-diffusion benchmark (Hairer-Wanner).

The counterpart of ``pysdc_tpu/models/brusselator.py`` (reference
``Brusselator``):

    u_t = alpha Lap(u) + 1 + u^2 v - 4.4 u + f(x, y, t)
    v_t = alpha Lap(v) + 3.4 u - u^2 v

on the periodic unit square, with the localized source f = 5 inside a disk
around (0.3, 0.6) for t >= 1.1.  Diffusion implicit (spectral), reaction and
source explicit.  The two components are stacked on the axis in front of the
grid; leading batch axes ride along.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.problem import Problem, WorkCounter
from pysdc_tpu_torch.core.state import IMEX
from pysdc_tpu_torch.ops.linop import SpectralOperator


class Brusselator(Problem):
    f_kind = 'imex'

    def __init__(self, nvars=(128, 128), alpha=0.1, dtype=None, device='cuda'):
        nvars = (nvars,) if isinstance(nvars, int) else tuple(nvars)
        super().__init__(shape=(2,) + nvars, dtype=dtype, device=device)
        self._register(nvars=nvars, alpha=alpha)
        self.lap = SpectralOperator(nvars, lengths=(1.0,) * len(nvars), scale=alpha)
        x = np.arange(nvars[0]) / nvars[0]
        self.X, self.Y = np.meshgrid(x, x, indexing='ij')
        self._mask = torch.as_tensor((self.X - 0.3) ** 2 + (self.Y - 0.6) ** 2 <= 0.1**2, dtype=self.dtype,
                                     device=self.device)
        self.work_counters['rhs'] = WorkCounter()

    def _parts(self, u):
        ax = u.dim() - len(self.nvars) - 1
        return u.select(ax, 0), u.select(ax, 1), ax

    def _source(self, t):
        """The source at time ``t``: a host number, or a tensor of times over the leading batch axes."""
        if isinstance(t, torch.Tensor):
            on = (t >= 1.1).to(self.dtype)
            return 5.0 * on.reshape(tuple(on.shape) + (1,) * len(self.nvars)) * self._mask
        return 5.0 * self._mask if float(t) >= 1.1 else 0.0 * self._mask

    def eval_f(self, u, t):
        u0, u1, ax = self._parts(u)
        impl = torch.stack([self.lap.apply(u0), self.lap.apply(u1)], dim=ax)
        ru = 1.0 + u0**2 * u1 - 4.4 * u0 + self._source(t)
        rv = 3.4 * u0 - u0**2 * u1
        return IMEX(impl=impl, expl=torch.stack([ru, rv], dim=ax))

    def solve_system(self, rhs, factor, u0, t):
        r0, r1, ax = self._parts(rhs)
        return torch.stack([self.lap.solve_shifted(r0, factor), self.lap.solve_shifted(r1, factor)], dim=ax)

    def u_exact(self, t, u_init=None, t_init=None):
        if float(t) != 0.0:
            raise NotImplementedError('initial condition only')
        X, Y = (torch.as_tensor(a, dtype=torch.float64, device=self.device) for a in (self.X, self.Y))
        u = 22.0 * Y * (1 - Y) ** 1.5
        v = 27.0 * X * (1 - X) ** 1.5
        return torch.stack([u, v]).to(self.dtype)
