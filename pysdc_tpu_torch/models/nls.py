"""Nonlinear Schroedinger equation, ND periodic spectral, IMEX.

The counterpart of ``pysdc_tpu/models/nls.py`` (reference
``nonlinearschroedinger_imex``, ``NonlinearSchroedinger_MPIFFT.py``):

    u_t = i Lap(u) + 2 c i N |u|^2 u     on [0, 2*pi]^N

with the exact (Akhmediev-breather-type) solution evaluated along the
diagonal, u(x, t) = u_1D(N*t, sum_d x_d).  The state is complex (complex128
by default).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pysdc_tpu_torch.core.errors import ProblemError
from pysdc_tpu_torch.core.problem import Problem, WorkCounter
from pysdc_tpu_torch.core.state import IMEX
from pysdc_tpu_torch.ops.linop import SpectralOperator


class NonlinearSchroedinger(Problem):
    f_kind = 'imex'

    def __init__(self, nvars=(128, 128), c=1.0, dtype=None, device='cuda'):
        nvars = (nvars,) if isinstance(nvars, int) else tuple(nvars)
        if c not in (0.0, 1.0):
            raise ProblemError(f'Setup not implemented, c has to be 0 or 1, got {c}')
        super().__init__(shape=nvars, dtype=torch.complex128 if dtype is None else dtype, device=device)
        self._register(nvars=nvars, c=c, L=2 * np.pi)
        self.lap = SpectralOperator(nvars, lengths=(self.L,) * len(nvars), scale=1.0)
        dx = self.L / nvars[0]
        self.xvalues = np.arange(nvars[0]) * dx
        self.work_counters['rhs'] = WorkCounter()

    @property
    def ndim(self):
        return len(self.nvars)

    @property
    def grids(self):
        x = torch.as_tensor(self.xvalues, dtype=torch.float64, device=self.device)
        return torch.meshgrid(*([x] * self.ndim), indexing='ij')

    def eval_f(self, u, t):
        impl = 1j * self.lap.apply(u)
        expl = self.ndim * self.c * 2j * torch.abs(u) ** 2 * u
        return IMEX(impl=impl, expl=expl)

    def solve_system(self, rhs, factor, u0, t):
        """(I - factor*i*Lap) u = rhs, exact in Fourier space."""
        axes = tuple(range(rhs.dim() - self.ndim, rhs.dim()))
        xhat = torch.fft.fftn(rhs, dim=axes) / (1.0 - factor * 1j * self.lap.symbol_on(rhs))
        return torch.fft.ifftn(xhat, dim=axes).to(rhs.dtype)

    def _exact_1d(self, t, x):
        if self.c == 0:
            return torch.sin(x) * complex(math.cos(t), -math.sin(t))
        ae = 1.0 / np.sqrt(2.0) * complex(math.cos(t), math.sin(t))
        return ae * (complex(math.cosh(t), math.sinh(t)) / (math.cosh(t) - 1.0 / np.sqrt(2.0) * torch.cos(x)) - 1.0)

    def u_exact(self, t, u_init=None, t_init=None):
        return self._exact_1d(self.ndim * float(t), sum(self.grids)).to(self.dtype)
