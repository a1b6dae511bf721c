"""N-dimensional advection equation, finite differences.

The counterpart of ``pysdc_tpu/models/advection.py`` (reference
``advectionNd``, ``AdvectionEquation_ND_FD.py``): periodic upwind/center
stencils, exact solution by translation of the initial data.  The circulant
direct solve handles the (complex-symbol) shifted systems exactly by FFT;
``solver_type='GMRES'|'CG'`` solve iteratively from the previous node value
(:mod:`pysdc_tpu_torch.ops.krylov`); ``backend='sparse'`` assembles the
operator (:class:`~pysdc_tpu_torch.ops.sparse_op.SparseFDOperator`).
"""

from __future__ import annotations

import math

import torch

from pysdc_tpu_torch.core.problem import Problem, WorkCounter
from pysdc_tpu_torch.models.heat import per_system
from pysdc_tpu_torch.ops.fd import get_1d_grid
from pysdc_tpu_torch.ops.linop import SeparableFDOperator


class AdvectionND(Problem):
    """u_t = -c * sum_d du/dx_d with periodic BCs."""

    def __init__(self, nvars=512, c=1.0, freq=2, stencil_type='center', order=2, lintol=1e-12, liniter=10000,
                 solver_type='direct', backend='eigen', dtype=None, device='cuda'):
        nvars = (nvars,) if isinstance(nvars, int) else tuple(nvars)
        freq = (freq,) * len(nvars) if isinstance(freq, int) else tuple(freq)
        super().__init__(shape=nvars, dtype=dtype, device=device)

        dx, xvals = get_1d_grid(nvars[0], 'periodic')
        per_dim = [
            dict(size=n, dx=dx, derivative=1, order=order, stencil_type=stencil_type, bc='periodic')
            for n in nvars
        ]
        if backend == 'sparse':
            from pysdc_tpu_torch.ops.sparse_op import SparseFDOperator

            self.A = SparseFDOperator(per_dim, scale=-c, device=self.device)
        else:
            self.A = SeparableFDOperator(per_dim, scale=-c)
        self._register(
            nvars=nvars, c=c, freq=freq, order=order, stencil_type=stencil_type,
            lintol=lintol, liniter=liniter, solver_type=solver_type, dx=dx, backend=backend,
        )
        self.xvals = xvals
        self.work_counters['rhs'] = WorkCounter()

    @property
    def ndim(self):
        return len(self.nvars)

    @property
    def grids(self):
        x = torch.as_tensor(self.xvals, dtype=self.dtype, device=self.device)
        if self.ndim == 1:
            return x
        return torch.meshgrid(*([x] * self.ndim), indexing='ij')

    @property
    def diagonalizable_operator(self):
        """Linear autonomous f = A@u: fused diagonal-basis sweeps apply; direct eigen solver only."""
        if self.backend != 'eigen':
            return None
        return self.A if self.solver_type == 'direct' else None

    def eval_f(self, u, t):
        return self.A.apply(u)

    def solve_system(self, rhs, factor, u0, t):
        if self.solver_type == 'direct':
            return self.A.solve_shifted(rhs, factor)
        solve = self.A.solve_shifted_gmres if self.solver_type == 'GMRES' else self.A.solve_shifted_cg
        return per_system(lambda r, f, u: solve(r, f, u, tol=self.lintol, maxiter=self.liniter), rhs, factor, u0,
                          self.shape)

    def u_exact(self, t, u_init=None, t_init=0.0):
        """Initial sine product translated by c*(t - t_init) in each dim."""
        shift = self.c * (t - t_init)
        if self.ndim == 1:
            return torch.sin(math.pi * self.freq[0] * (self.grids - shift))
        out = torch.ones(self.shape, dtype=self.dtype, device=self.device)
        for d, g in enumerate(self.grids):
            out = out * torch.sin(math.pi * self.freq[d] * (g - shift))
        return out
