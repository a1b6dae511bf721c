"""1D advection-diffusion with IMEX splitting, spectral.

The counterpart of ``pysdc_tpu/models/advdiff.py`` (reference
``AdvectionDiffusionEquation_1D_FFT``): u_t + c u_x = nu u_xx on a periodic
interval; stiff diffusion implicit, advection explicit, both through
:class:`~pysdc_tpu_torch.ops.linop.SpectralOperator`.  Exact solution by
Fourier-mode decay and translation.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pysdc_tpu_torch.core.problem import Problem, WorkCounter
from pysdc_tpu_torch.core.state import IMEX
from pysdc_tpu_torch.ops.linop import SpectralOperator


class AdvectionDiffusion1D(Problem):
    f_kind = 'imex'

    def __init__(self, nvars=256, c=1.0, nu=0.02, freq=2, L=1.0, dtype=None, device='cuda'):
        super().__init__(shape=(nvars,), dtype=dtype, device=device)
        self._register(nvars=nvars, c=c, nu=nu, freq=freq, L=L)
        self.lap = SpectralOperator((nvars,), lengths=(L,), scale=nu)
        self.ddx = SpectralOperator((nvars,), lengths=(L,), symbol_fn=lambda k: 1j * k, scale=-c)
        self.xvalues = np.arange(nvars) * L / nvars
        self.work_counters['rhs'] = WorkCounter()

    @property
    def grid(self):
        return torch.as_tensor(self.xvalues, dtype=self.dtype, device=self.device)

    def eval_f(self, u, t):
        return IMEX(impl=self.lap.apply(u), expl=self.ddx.apply(u))

    def solve_system(self, rhs, factor, u0, t):
        return self.lap.solve_shifted(rhs, factor)

    def u_exact(self, t, u_init=None, t_init=0.0):
        k = 2 * np.pi * self.freq / self.L
        return (torch.sin(k * (self.grid - self.c * t)) * math.exp(-t * self.nu * k**2)).to(self.dtype)
