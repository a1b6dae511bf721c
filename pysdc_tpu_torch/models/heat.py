"""N-dimensional heat equation, finite differences.

The counterpart of ``pysdc_tpu/models/heat.py`` (reference ``heatNd_unforced``
and ``heatNd_forced``, ``pySDC/implementations/problem_classes/HeatEquation_ND_FD.py``):
the Laplacian is a separable stencil operator with FFT (periodic), sine
transform (order-2 Dirichlet) or eigen-product (other Dirichlet/Neumann)
direct shifted solves.  On the card a 2D
periodic Laplacian applies through kernel K1.  ``backend='sparse'`` assembles
the Laplacian as a CSR matrix instead (:mod:`pysdc_tpu_torch.ops.sparse_op`):
its apply is the DIA SpMV (kernel K2 on the card), its solves are structured
factorizations or PCG with the eigen operator as the exact preconditioner.
``solver_type='CG'|'GMRES'`` solves iteratively with ``jax.scipy``'s CG and
GMRES (:mod:`pysdc_tpu_torch.ops.krylov`) from the previous node value, to
``lintol`` in at most ``liniter`` iterations (GMRES: restarts), counted in the
``'CG'`` / ``'GMRES'`` work counter.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pysdc_tpu_torch.core.problem import Problem, WorkCounter
from pysdc_tpu_torch.core.state import IMEX
from pysdc_tpu_torch.ops.fd import get_1d_grid
from pysdc_tpu_torch.ops.linop import SeparableFDOperator


def per_system(solve, rhs, factor, u0, shape):
    """``solve(rhs, factor, u0)`` for one system of ``shape``, applied to each
    system of the leading batch axes of ``rhs`` in turn (the time steps of a
    block: an iterative solve's stopping test is per system, as under
    ``jax.vmap``)."""
    if rhs.dim() == len(shape):
        return solve(rhs, factor, u0)
    lead = rhs.shape[: rhs.dim() - len(shape)]
    out = [solve(r, factor, u) for r, u in zip(rhs.reshape((-1,) + tuple(shape)), u0.reshape((-1,) + tuple(shape)))]
    return torch.stack(out).reshape(lead + tuple(shape))


def node_shift_column(op, factor, rhs):
    """The per-node shifts ``factor`` (``(M,)``) as a column in ``rhs``'s
    precision that broadcasts against ``rhs (M, ..., *shape)``.  Shifts on
    the device (the product of a device ``dt`` with a constant table) are
    used as they are: nothing of their value is kept, so one captured graph
    serves every ``dt``.  Host shifts are copied to the device once per set
    of values and kept (a copy from the host is not allowed inside a graph
    capture)."""
    if isinstance(factor, torch.Tensor):
        shifts = factor.to(rhs.dtype)
    else:
        values = tuple(float(x) for x in np.asarray(factor, dtype=float))
        shifts = op._const(('shifts', values), values, rhs.dtype, rhs.device)
    return shifts.reshape((-1,) + (1,) * (rhs.dim() - 1))


class HeatND(Problem):
    """u_t = nu * Laplace(u); params follow the reference problem class,
    plus ``device`` (default ``'cuda'``)."""

    def __init__(
        self,
        nvars=512,
        nu=0.1,
        freq=2,
        stencil_type='center',
        order=2,
        lintol=1e-12,
        liniter=10000,
        solver_type='direct',
        bc='periodic',
        sigma=6e-2,
        backend='eigen',
        dtype=None,
        device='cuda',
    ):
        if backend not in ('eigen', 'sparse'):
            raise ValueError(f"unknown backend {backend!r}: 'eigen' or 'sparse'")
        nvars = (nvars,) if isinstance(nvars, int) else tuple(nvars)
        freq = (freq,) * len(nvars) if isinstance(freq, int) else tuple(freq)
        if len(nvars) > 1 and len(set(nvars)) > 1:
            raise ValueError('need identical nvars for each dimension')
        super().__init__(shape=nvars, dtype=dtype, device=device)

        dx, xvals = get_1d_grid(nvars[0], bc)
        per_dim = [
            dict(size=n, dx=dx, derivative=2, order=order, stencil_type=stencil_type, bc=bc)
            for n in nvars
        ]
        if backend == 'sparse':
            # assembled CSR + structured factorization; the separable eigen
            # twin rides along as the exact spectral preconditioner, so
            # large 2D grids take the PCG lane (one iteration: the surrogate
            # is the operator)
            from pysdc_tpu_torch.ops.sparse_op import SparseFDOperator

            self.A = SparseFDOperator(per_dim, scale=nu, precond=SeparableFDOperator(per_dim, scale=nu),
                                      device=self.device)
        else:
            self.A = SeparableFDOperator(per_dim, scale=nu)
        self._register(
            nvars=nvars, nu=nu, freq=freq, order=order, stencil_type=stencil_type,
            lintol=lintol, liniter=liniter, solver_type=solver_type, bc=bc, sigma=sigma, dx=dx,
            backend=backend,
        )
        self.xvals = xvals
        self.work_counters['rhs'] = WorkCounter()
        if solver_type != 'direct':
            self.work_counters[solver_type] = WorkCounter()

    @property
    def ndim(self):
        return len(self.nvars)

    @property
    def diagonalizable_operator(self):
        """eval_f is exactly A@u and the solves are exact diagonal-basis
        solves, so multi-sweep SDC may run fused in that basis
        (ops/diag_sdc.py).  Only for the direct eigen solver."""
        if self.backend != 'eigen':
            return None
        return self.A if self.solver_type == 'direct' else None

    @property
    def grids(self):
        """ND meshgrid tuple (matches reference generic_ND_FD.grids)."""
        x = torch.as_tensor(self.xvals, dtype=self.dtype, device=self.device)
        if self.ndim == 1:
            return x
        return torch.meshgrid(*([x] * self.ndim), indexing='ij')

    def eval_f(self, u, t):
        return self.A.apply(u)

    def eval_f_batched(self, u, t):
        """One apply over the leading node axis (one K1 launch on the card)."""
        return self.eval_f(u, t)

    def solve_system(self, rhs, factor, u0, t, node=None):
        if self.solver_type == 'direct':
            if self.backend == 'sparse':  # a block's leading time axis holds independent systems, as under jax.vmap
                return self.A.solve_shifted(rhs, factor, node=node, batch_ndim=rhs.dim() - len(self.shape))
            return self.A.solve_shifted(rhs, factor)
        if self.solver_type == 'CG':
            solve = self.A.solve_shifted_cg
        elif self.solver_type == 'GMRES':
            solve = self.A.solve_shifted_gmres
        else:
            raise ValueError(f'unknown solver_type {self.solver_type!r}')
        return per_system(lambda r, f, u: solve(r, f, u, tol=self.lintol, maxiter=self.liniter), rhs, factor, u0,
                          self.shape)

    def solve_system_batched(self, rhs, factor, u0, t):
        """One transform pair for all nodes; ``factor`` holds one shift per
        node (``rhs`` may carry a block's time axis behind the node axis).
        The sparse backend and the iterative solves go node by node."""
        if self.backend == 'sparse' or self.solver_type != 'direct':
            return super().solve_system_batched(rhs, factor, u0, t)
        return self.A.solve_shifted(rhs, node_shift_column(self.A, factor, rhs))

    def solve_jacobian_batched(self, rhs, factor, u=None, t=None):
        """ParaDiag's solves: ``factor`` holds one complex shift per system of the batch (``(L, M)``: steps and
        nodes); on the direct eigen backend one transform pair for the whole ``(L, M, *shape)`` block."""
        if self.backend == 'sparse' or self.solver_type != 'direct':
            return super().solve_jacobian_batched(rhs, factor, u, t)
        return self.A.solve_shifted(rhs, factor.reshape(tuple(factor.shape) + (1,) * self.ndim))

    def _sin_product(self):
        if self.ndim == 1:
            return torch.sin(float(np.pi * self.freq[0]) * self.grids)
        out = torch.ones(self.shape, dtype=self.dtype, device=self.device)
        for d, g in enumerate(self.grids):
            out = out * torch.sin(float(np.pi * self.freq[d]) * g)
        return out

    def _rho(self):
        """Discrete decay rate of the FD Laplacian on the initial mode
        (reference HeatEquation_ND_FD.py:105-123, 2nd-order only)."""
        dx = self.dx
        return float(sum((2.0 - 2.0 * np.cos(np.pi * f * dx)) / dx**2 for f in self.freq))

    def u_exact(self, t, u_init=None, t_init=None):
        decay = math.exp(-t * self.nu * self._rho())
        if self.ndim == 1 and self.freq[0] == -1:
            x = self.grids
            out = torch.exp(-0.5 * ((x - 0.5) / self.sigma) ** 2) * decay
        else:
            out = self._sin_product() * decay
        return out.to(self.dtype)


class HeatNDForced(HeatND):
    """IMEX-split forced heat equation; exact solution sin-product * cos(t)
    (reference ``heatNd_forced``)."""

    f_kind = 'imex'

    #: the forcing makes f nonautonomous: no fused diagonal-basis sweeps
    diagonalizable_operator = None

    def __init__(self, nvars=512, nu=0.1, freq=2, stencil_type='center', order=2,
                 lintol=1e-12, liniter=10000, solver_type='direct', bc='periodic',
                 backend='eigen', dtype=None, device='cuda'):
        super().__init__(nvars, nu, freq, stencil_type, order, lintol, liniter, solver_type, bc,
                         backend=backend, dtype=dtype, device=device)
        self._mode = self._sin_product()  # the spatial factor of forcing and solution, made once

    def _forcing_factor(self, t):
        """nu pi^2 |k|^2 cos t - sin t, for a time, an array of times or a
        tensor of times (computed where the tensor lives, in its precision)."""
        k2 = sum(f**2 for f in self.freq)
        if isinstance(t, torch.Tensor):
            return self.nu * np.pi**2 * k2 * torch.cos(t) - torch.sin(t)
        return self.nu * np.pi**2 * k2 * np.cos(t) - np.sin(t)

    def _forcing(self, t, u):
        """The explicit part for the fields ``u`` whose leading axes (nodes,
        steps) are the axes of the times ``t``.  Times on the device stay
        there: a host number would be frozen into a captured CUDA graph."""
        if isinstance(t, torch.Tensor):
            factor = self._forcing_factor(t).to(u.dtype)
        elif np.ndim(t) == 0:
            return self._mode * float(self._forcing_factor(t))
        else:
            factor = torch.as_tensor(self._forcing_factor(np.asarray(t, dtype=float)), dtype=u.dtype, device=u.device)
        return factor.reshape(tuple(factor.shape) + (1,) * self.ndim) * self._mode

    def eval_f(self, u, t):
        return IMEX(impl=self.A.apply(u), expl=self._forcing(t, u))

    def eval_f_batched(self, u, t):
        """One apply over the leading node axis (one K1 launch on the card);
        the forcing takes one time per node (and per step of a block)."""
        return IMEX(impl=self.A.apply(u), expl=self._forcing(t, u))

    def u_exact(self, t, u_init=None, t_init=None):
        return self._mode * math.cos(t)
