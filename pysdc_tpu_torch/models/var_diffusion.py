"""Variable-coefficient diffusion — the sparse lane's problem.

The counterpart of ``pysdc_tpu/models/var_diffusion.py``:
``u_t = d/dx (a(x) du/dx) [+ d/dy (a(x,y) du/dy)]`` with a genuinely
non-separable operator, so the eigen/FFT lane cannot represent it.  It runs
on the sparse stack: conservative face-coefficient assembly into CSR
(:mod:`pysdc_tpu_torch.ops.sparse`), the DIA SpMV for ``eval_f`` (kernel K2
on the card), and structured factorization or spectrally preconditioned CG
for the shifted solves (:mod:`pysdc_tpu_torch.ops.sparse_op`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pysdc_tpu_torch.core.problem import Problem, WorkCounter
from pysdc_tpu_torch.core.state import IMEX
from pysdc_tpu_torch.ops.linop import SeparableFDOperator
from pysdc_tpu_torch.ops.sparse import CSR
from pysdc_tpu_torch.ops.sparse_op import SparseOperator, variable_diffusion_matrix


class VarCoeffDiffusion1D(Problem):
    """1D conservative variable-coefficient diffusion, Dirichlet-0 or periodic.

    ``coeff_fn(x)`` gives the diffusivity at face centers; params follow the
    JAX package, plus ``device`` (default ``'cuda'``).
    """

    def __init__(self, nvars=128, coeff_fn=None, nu=1.0, freq=2, bc='dirichlet', interval=(0.0, 1.0),
                 dtype=None, device='cuda'):
        super().__init__(shape=(nvars,), dtype=dtype, device=device)
        L = interval[1] - interval[0]
        if bc == 'periodic':
            dx = L / nvars
            x = interval[0] + dx * np.arange(nvars)
            faces = x - 0.5 * dx  # face i sits between nodes i-1 and i
            a_faces = np.concatenate([faces, [faces[0] + L]])
        else:
            dx = L / (nvars + 1)
            x = interval[0] + dx * np.arange(1, nvars + 1)
            a_faces = x[0] - 0.5 * dx + dx * np.arange(nvars + 1)
        coeff_fn = coeff_fn if coeff_fn is not None else (lambda xx: nu * np.ones_like(xx))
        a_vals = np.asarray(coeff_fn(a_faces), dtype=float)
        A = variable_diffusion_matrix(a_vals, dx, bc=bc)
        self.A = SparseOperator(A, grid_shape=(nvars,), device=self.device)
        self.xvals = x
        self._register(nvars=nvars, nu=nu, freq=freq, bc=bc, interval=interval, dx=dx)
        self.work_counters['rhs'] = WorkCounter()

    @property
    def grids(self):
        return torch.as_tensor(self.xvals, dtype=self.dtype, device=self.device)

    def eval_f(self, u, t):
        return self.A.apply(u)

    def eval_f_batched(self, u, t):
        """One apply over the leading node axis (one K2 launch on the card)."""
        return self.eval_f(u, t)

    def solve_system(self, rhs, factor, u0, t, node=None):
        return self.A.solve_shifted(rhs, factor, x0=u0, node=node)


class VarCoeffDiffusion2D(Problem):
    """2D conservative variable-coefficient diffusion with Dirichlet-0 BCs.

    Face-centered diffusivities from ``coeff_fn(x, y)``; the operator is a
    five-point stencil with spatially varying weights.  By default the shifted
    solves take the PCG lane, preconditioned by the nearest separable
    surrogate ``mean(a_x) d_xx + mean(a_y) d_yy`` (exact eigen-product solves);
    ``solver='block_tridiag'`` selects block cyclic reduction.  Params follow
    the JAX package, plus ``device`` (default ``'cuda'``).
    """

    def __init__(self, nvars=(32, 32), coeff_fn=None, nu=1.0, dtype=None, solver='auto', device='cuda'):
        nvars = (nvars, nvars) if isinstance(nvars, int) else tuple(nvars)
        super().__init__(shape=nvars, dtype=dtype, device=device)
        nx, ny = nvars
        dx = 1.0 / (nx + 1)
        dy = 1.0 / (ny + 1)
        x = dx * np.arange(1, nx + 1)
        y = dy * np.arange(1, ny + 1)
        coeff_fn = coeff_fn if coeff_fn is not None else (lambda xx, yy: nu * np.ones_like(xx))

        # face coefficients
        xf = dx * (np.arange(nx + 1) + 0.5)   # x-faces between rows i-1, i
        yf = dy * (np.arange(ny + 1) + 0.5)
        ax = np.asarray(coeff_fn(xf[:, None], y[None, :]), dtype=float)   # (nx+1, ny)
        ay = np.asarray(coeff_fn(x[:, None], yf[None, :]), dtype=float)   # (nx, ny+1)

        n = nx * ny
        idx = np.arange(n).reshape(nx, ny)
        rows, cols, vals = [], [], []

        def add(r, c, v):
            rows.append(r.ravel())
            cols.append(c.ravel())
            vals.append(v.ravel())

        # x-direction: (a_{i+1/2}(u_{i+1}-u_i) - a_{i-1/2}(u_i-u_{i-1}))/dx^2
        add(idx, idx, -(ax[1:, :] + ax[:-1, :]) / dx**2)
        add(idx[1:, :], idx[:-1, :], ax[1:-1, :] / dx**2)   # u_{i-1} in row i
        add(idx[:-1, :], idx[1:, :], ax[1:-1, :] / dx**2)   # u_{i+1} in row i
        # y-direction
        add(idx, idx, -(ay[:, 1:] + ay[:, :-1]) / dy**2)
        add(idx[:, 1:], idx[:, :-1], ay[:, 1:-1] / dy**2)
        add(idx[:, :-1], idx[:, 1:], ay[:, 1:-1] / dy**2)

        A = CSR.from_coo(np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), (n, n))
        # nearest separable surrogate mean(a_x) d_xx + mean(a_y) d_yy; the
        # per-dim coefficient folds into the eigen operator through dx -> dx/sqrt(a)
        precond = SeparableFDOperator(
            [
                dict(size=nx, dx=dx / np.sqrt(ax.mean()), derivative=2, order=2, bc='dirichlet'),
                dict(size=ny, dx=dy / np.sqrt(ay.mean()), derivative=2, order=2, bc='dirichlet'),
            ]
        )
        self.A = SparseOperator(A, grid_shape=nvars, block=ny, precond=precond, solver=solver, device=self.device)
        self.xvals, self.yvals = x, y
        self._register(nvars=nvars, nu=nu, dx=dx, dy=dy)
        self.work_counters['rhs'] = WorkCounter()

    @property
    def grids(self):
        x = torch.as_tensor(self.xvals, dtype=self.dtype, device=self.device)
        y = torch.as_tensor(self.yvals, dtype=self.dtype, device=self.device)
        return torch.meshgrid(x, y, indexing='ij')

    def eval_f(self, u, t):
        return self.A.apply(u)

    def eval_f_batched(self, u, t):
        """One apply over the leading node axis (one K2 launch on the card)."""
        return self.eval_f(u, t)

    def solve_system(self, rhs, factor, u0, t, node=None):
        # warm start: the previous sweep's node value cuts the Krylov depth
        return self.A.solve_shifted(rhs, factor, x0=u0, node=node)


class VarCoeffDiffusionForced1D(VarCoeffDiffusion1D):
    """IMEX forced variant with a known exact solution for order gates:
    with constant a = nu, ``u = sin(pi k x) cos(t)`` solves
    ``u_t = nu u_xx + f`` for ``f = sin(pi k x)(nu (pi k)^2 cos t - sin t)``.
    Works with variable coefficients too (the forcing is computed from the
    discrete operator, so the semi-discrete solution is exact)."""

    f_kind = 'imex'

    def __init__(self, nvars=128, coeff_fn=None, nu=1.0, freq=2, dtype=None, device='cuda'):
        super().__init__(nvars=nvars, coeff_fn=coeff_fn, nu=nu, freq=freq, bc='dirichlet', dtype=dtype,
                         device=device)
        self._mode = torch.as_tensor(np.sin(np.pi * freq * self.xvals), dtype=self.dtype, device=self.device)
        # discrete forcing: u_t - A u for u = mode * cos(t)
        self._Amode = self.A.apply(self._mode)

    def eval_f(self, u, t):
        forcing = -self._mode * math.sin(t) - self._Amode * math.cos(t)
        return IMEX(impl=self.A.apply(u), expl=forcing)

    def eval_f_batched(self, u, t):
        """One apply over the leading node axis (one K2 launch on the card);
        the forcing takes one time per node."""
        t = np.asarray(t, dtype=float)
        sin_t, cos_t = (torch.as_tensor(fn(t), dtype=u.dtype, device=u.device).unsqueeze(1) for fn in (np.sin, np.cos))
        return IMEX(impl=self.A.apply(u), expl=-sin_t * self._mode - cos_t * self._Amode)

    def solve_system(self, rhs, factor, u0, t, node=None):
        return self.A.solve_shifted(rhs, factor, node=node)

    def u_exact(self, t, u_init=None, t_init=None):
        return self._mode * math.cos(t)
