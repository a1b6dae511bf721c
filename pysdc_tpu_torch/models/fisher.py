"""Generalized Fisher equation: traveling-wave reaction-diffusion.

The counterpart of ``pysdc_tpu/models/fisher.py`` (reference
``GeneralizedFisher_1D_FD_implicit``): u_t = u_xx + lambda0^2 u (1 - u^nu) on
(-5, 5) with time-dependent Dirichlet boundary values from the exact traveling
wave.  Fully implicit through the shared Newton-Krylov solver
(:mod:`pysdc_tpu_torch.ops.solvers`) with the exact diffusion solve as the
preconditioner; the observers of the Allen-Cahn problems
(``solver_trace``, ``solver_applies``, ``host_reads``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pysdc_tpu_torch.models.allen_cahn import _NewtonPDE, _times
from pysdc_tpu_torch.ops.linop import SeparableFDOperator


class GeneralizedFisher1D(_NewtonPDE):
    def __init__(self, nvars=127, nu=1.0, lambda0=2.0, newton_maxiter=100, newton_tol=1e-12,
                 interval=(-5.0, 5.0), dtype=None, device='cuda'):
        if (nvars + 1) % 2:
            raise ValueError('setup requires nvars = 2^p - 1')
        super().__init__(shape=(nvars,), dtype=dtype, device=device)
        dx = (interval[1] - interval[0]) / (nvars + 1)
        self._register(nvars=(nvars,), nu=nu, lambda0=lambda0, newton_maxiter=newton_maxiter,
                       newton_tol=newton_tol, interval=interval, dx=dx)
        self.xvalues = np.array([(i + 1 - (nvars + 1) / 2) * dx for i in range(nvars)])
        self.A = SeparableFDOperator([dict(size=nvars, dx=dx, derivative=2, order=2, bc='dirichlet-zero')])
        # traveling-wave parameters (reference :143-150)
        self.lam1 = lambda0 / 2.0 * ((nu / 2.0 + 1) ** 0.5 + (nu / 2.0 + 1) ** (-0.5))
        self.sig1 = self.lam1 - np.sqrt(self.lam1**2 - lambda0**2)
        self._init_newton()

    def _wave(self, x, t):
        """The exact wave at ``x`` (a number or a tensor) and time ``t`` (a float or a tensor)."""
        arg = -self.nu / 2.0 * self.sig1 * (x + 2 * self.lam1 * t)
        ex = torch.exp(arg) if isinstance(arg, torch.Tensor) else math.exp(arg)
        return (1 + (2 ** (self.nu / 2.0) - 1) * ex) ** (-2.0 / self.nu)

    def _bc_term(self, t):
        t = _times(t, self.device)
        lead = tuple(t.shape) if isinstance(t, torch.Tensor) else ()
        out = torch.zeros(lead + self.shape, dtype=self.dtype, device=self.device)
        out[..., 0] = self._wave(self.interval[0], t) / self.dx**2
        out[..., -1] = self._wave(self.interval[1], t) / self.dx**2
        return out

    def _reaction(self, u):
        return self.lambda0**2 * u * (1.0 - torch.abs(u) ** self.nu)

    def _reaction_prime(self, u):
        return self.lambda0**2 * (1.0 - (self.nu + 1) * torch.abs(u) ** self.nu)

    def eval_f(self, u, t):
        return self.A.apply(u) + self._bc_term(t) + self._reaction(u)

    def solve_system(self, rhs, factor, u0, t):
        bc = self._bc_term(t)
        return self._newton(self.A.apply, self.A.solve_shifted, lambda u: self._reaction(u) + bc,
                            self._reaction_prime, rhs, factor, u0)

    def u_exact(self, t, u_init=None, t_init=None):
        x = torch.as_tensor(self.xvalues, dtype=torch.float64, device=self.device)
        return self._wave(x, float(t)).to(self.dtype)
