"""Allen-Cahn equation: the ND periodic variants.

The counterpart of ``pysdc_tpu/models/allen_cahn.py`` for the periodic circle
problems (reference ``AllenCahn_2D_FD.py`` / ``AllenCahn_MPIFFT.py``):
``AllenCahnPeriodicND`` (its operator, reaction terms and initial circle) and
the IMEX variant ``AllenCahnPeriodicSemiImplicitND``, whose solve is the plain
shifted solve.  The fully implicit solve needs the Newton-Krylov machinery of
``ops/solvers.py`` and waits, with the 1D front problems and the multi-implicit
class, for ROADMAP queue 1, item 9; it raises by name.

On the card the 2D Laplacian applies through kernel K1; the reaction is one
elementwise pass.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pysdc_tpu_torch.core.problem import Problem, WorkCounter
from pysdc_tpu_torch.core.state import IMEX
from pysdc_tpu_torch.models.heat import node_shift_column
from pysdc_tpu_torch.ops.linop import SeparableFDOperator

NEWTON_PDE_ITEM = 'ROADMAP queue 1, item 9'


class AllenCahnPeriodicND(Problem):
    """Periodic ND Allen-Cahn with shrinking-circle initial condition.

    u_t = Delta u - 2/eps^2 u (1-u)(1-2u); radius R(t) = sqrt(R0^2 - 2(d-1)t)
    (reference allencahn_periodic_* in AllenCahn_1D_FD.py / AllenCahn_2D_FD.py).
    Fully-implicit variant: ``eval_f`` is ported, ``solve_system`` is not yet.
    """

    def __init__(self, nvars=(128, 128), eps=0.04, radius=0.25, newton_maxiter=100,
                 newton_tol=1e-12, interval=(-0.5, 0.5), backend='eigen', dtype=None, device='cuda'):
        nvars = (nvars,) if isinstance(nvars, int) else tuple(nvars)
        super().__init__(shape=nvars, dtype=dtype, device=device)
        L = interval[1] - interval[0]
        dx = L / nvars[0]
        self._register(
            nvars=nvars, eps=eps, radius=radius, newton_maxiter=newton_maxiter,
            newton_tol=newton_tol, interval=interval, dx=dx, backend=backend,
        )
        self.xvalues = np.array([interval[0] + i * dx for i in range(nvars[0])])
        per_dim = [dict(size=n, dx=dx, derivative=2, order=2, bc='periodic') for n in nvars]
        if backend == 'sparse':
            # assembled 5-point stencil; periodic 1D solves use cyclic Thomas
            from pysdc_tpu_torch.ops.sparse_op import SparseFDOperator

            self.A = SparseFDOperator(per_dim, device=self.device)
        else:
            self.A = SeparableFDOperator(per_dim)
        self.work_counters['newton'] = WorkCounter()
        self.work_counters['rhs'] = WorkCounter()

    @property
    def ndim(self):
        return len(self.nvars)

    def _reaction(self, u):
        return -2.0 / self.eps**2 * u * (1.0 - u) * (1.0 - 2.0 * u)

    def _reaction_prime(self, u):
        return -2.0 / self.eps**2 * ((1.0 - u) * (1.0 - 2.0 * u) - u * (1.0 - 2.0 * u) - 2.0 * u * (1.0 - u))

    def eval_f(self, u, t):
        self.work_counters['rhs']()
        return self.A.apply(u) + self._reaction(u)

    def eval_f_batched(self, u, t):
        """One apply (one K1 launch on the card) and one reaction pass over the
        leading node axis (and the time axis of a block behind it)."""
        self.work_counters['rhs'](u.shape[0] - 1)
        return self.eval_f(u, t)

    def solve_system(self, rhs, factor, u0, t):
        raise NotImplementedError(
            f'the fully implicit Allen-Cahn solve needs newton_pde (ops/solvers.py), not ported yet '
            f'({NEWTON_PDE_ITEM}); AllenCahnPeriodicSemiImplicitND with IMEXSweeper is ported'
        )

    def u_exact(self, t, u_init=None, t_init=0.0):
        """Sharp-interface circle of radius R(t) (initial condition for t=0;
        approximation for t > 0 used only as a qualitative reference)."""
        x = torch.as_tensor(self.xvalues, dtype=torch.float64, device=self.device)
        grids = torch.meshgrid(*([x] * self.ndim), indexing='ij')
        r2 = sum(g**2 for g in grids)
        radius = math.sqrt(max(self.radius**2 - 2.0 * (self.ndim - 1) * t, 0.0))
        return (0.5 * (1.0 + torch.tanh((radius - torch.sqrt(r2)) / (math.sqrt(2.0) * self.eps)))).to(self.dtype)


class AllenCahnPeriodicSemiImplicitND(AllenCahnPeriodicND):
    """IMEX variant: diffusion implicit, reaction explicit
    (reference allencahn_periodic_semiimplicit / allencahn_imex)."""

    f_kind = 'imex'

    def eval_f(self, u, t):
        self.work_counters['rhs']()
        return IMEX(impl=self.A.apply(u), expl=self._reaction(u))

    def solve_system(self, rhs, factor, u0, t, node=None):
        return self.A.solve_shifted(rhs, factor)

    def solve_system_batched(self, rhs, factor, u0, t):
        """One transform pair for all nodes, one shift per node; the sparse
        backend solves node by node."""
        if self.backend == 'sparse':
            return super().solve_system_batched(rhs, factor, u0, t)
        return self.A.solve_shifted(rhs, node_shift_column(self.A, factor, rhs))
