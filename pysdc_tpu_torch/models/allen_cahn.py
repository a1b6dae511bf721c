"""Allen-Cahn equation: 1D traveling front and ND periodic variants.

The counterpart of ``pysdc_tpu/models/allen_cahn.py`` (reference
``AllenCahn_1D_FD.py``: fully implicit / semi-implicit / multi-implicit front
problems with driving force and exact tanh front, and ``AllenCahn_2D_FD.py`` /
``AllenCahn_MPIFFT.py``: periodic circle problems).  Implicit nonlinear solves
use the shared Newton-Krylov solver (:mod:`pysdc_tpu_torch.ops.solvers`) with
the exact linear shifted solve as the preconditioner.

On the card the 2D periodic Laplacian applies through kernel K1: in every
``eval_f``, every Newton residual and every PCG matvec; each preconditioner
solve is one cuFFT ``rfftn`` / ``irfftn`` pair.

The problems with a Newton solve keep two observers: ``solver_trace`` (when
set to a list, each solve appends one ``(Newton iterations, [PCG iterations
of each])`` per system, and ``solver_applies`` counts the operator applies the
solves made; inside a captured graph the device decides both, and nothing is
added) and ``host_reads`` (the reads of their loops).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pysdc_tpu_torch.core.errors import ProblemError
from pysdc_tpu_torch.core.problem import Problem, WorkCounter
from pysdc_tpu_torch.core.state import IMEX, Comp2
from pysdc_tpu_torch.models.heat import node_shift_column
from pysdc_tpu_torch.ops.linop import SeparableFDOperator
from pysdc_tpu_torch.ops.solvers import newton_pde


class _NewtonPDE(Problem):
    """The observers of a problem whose solves run :func:`newton_pde`."""

    def _init_newton(self):
        self.solver_trace = None
        self.solver_applies = 0
        self.host_reads = 0
        self.work_counters['newton'] = WorkCounter()
        self.work_counters['rhs'] = WorkCounter()

    def _newton(self, apply_A, solve_shifted, g, gprime, rhs, factor, u0):
        """``newton_pde`` on the systems of ``rhs`` (its leading axes in front of the problem's space axes)."""
        u, info = newton_pde(apply_A, solve_shifted, g, gprime, rhs, factor, u0, newton_tol=self.newton_tol,
                             newton_maxiter=self.newton_maxiter, batch_ndim=rhs.dim() - len(self.shape))
        self.host_reads += info.reads
        if info.applies is not None:
            self.solver_applies += info.applies
        if self.solver_trace is not None:
            self.solver_trace.extend(info.per_system())
        return u


def _times(t, device):
    """A time as a host float, or a tensor of times as float64 on ``device``."""
    if isinstance(t, torch.Tensor):
        return t.to(dtype=torch.float64, device=device)
    return float(t)


class AllenCahnFront1D(_NewtonPDE):
    """Fully-implicit 1D Allen-Cahn front with driving force.

    u_t = u_xx - 2/eps^2 u (1-u)(1-2u) - 6 dw u (1-u),
    inhomogeneous (time-dependent) Dirichlet BCs from the exact tanh front
    (reference AllenCahn_1D_FD.py:11-251).
    """

    def __init__(self, nvars=127, dw=-0.04, eps=0.04, newton_maxiter=100, newton_tol=1e-12,
                 interval=(-0.5, 0.5), stop_at_nan=True, dtype=None, device='cuda'):
        if (nvars + 1) % 2:
            raise ProblemError('setup requires nvars = 2^p - 1')
        super().__init__(shape=(nvars,), dtype=dtype, device=device)
        dx = (interval[1] - interval[0]) / (nvars + 1)
        self._register(
            nvars=(nvars,), dw=dw, eps=eps, newton_maxiter=newton_maxiter, newton_tol=newton_tol,
            interval=interval, stop_at_nan=stop_at_nan, dx=dx,
        )
        self.xvalues = np.array([(i + 1 - (nvars + 1) / 2) * dx for i in range(nvars)])
        # interior Dirichlet-zero Laplacian; boundary values enter via _bc_term
        self.A = SeparableFDOperator([dict(size=nvars, dx=dx, derivative=2, order=2, bc='dirichlet-zero')])
        self._init_newton()

    # -- helpers --------------------------------------------------------
    def _front_speed(self):
        return 3.0 * np.sqrt(2) * self.eps * self.dw

    def _front(self, x, t):
        """The exact tanh front at ``x`` (numbers or a tensor) and time ``t`` (a float or a tensor)."""
        arg = (x - self._front_speed() * t) / (np.sqrt(2) * self.eps)
        return 0.5 * (1 + (torch.tanh(arg) if isinstance(arg, torch.Tensor) else math.tanh(arg)))

    def _bc_term(self, t):
        """Contribution of the inhomogeneous boundary values to A @ u; a tensor of times gives one row per
        time, in front of the grid."""
        t = _times(t, self.device)
        lead = tuple(t.shape) if isinstance(t, torch.Tensor) else ()
        out = torch.zeros(lead + self.shape, dtype=self.dtype, device=self.device)
        out[..., 0] = self._front(self.interval[0], t) / self.dx**2
        out[..., -1] = self._front(self.interval[1], t) / self.dx**2
        return out

    def _reaction(self, u):
        eps2 = self.eps**2
        return -2.0 / eps2 * u * (1.0 - u) * (1.0 - 2.0 * u) - 6.0 * self.dw * u * (1.0 - u)

    def _reaction_prime(self, u):
        eps2 = self.eps**2
        d1 = -2.0 / eps2 * ((1.0 - u) * (1.0 - 2.0 * u) - u * ((1.0 - 2.0 * u) + 2.0 * (1.0 - u)))
        d2 = -6.0 * self.dw * ((1.0 - u) - u)
        return d1 + d2

    # -- protocol -------------------------------------------------------
    def eval_f(self, u, t):
        return self.A.apply(u) + self._bc_term(t) + self._reaction(u)

    def solve_system(self, rhs, factor, u0, t):
        bc = self._bc_term(t)
        return self._newton(
            self.A.apply,
            self.A.solve_shifted,
            lambda u: self._reaction(u) + bc,  # constant BC term: zero Jacobian
            self._reaction_prime,
            rhs,
            factor,
            u0,
        )

    def u_exact(self, t, u_init=None, t_init=None):
        x = torch.as_tensor(self.xvalues, dtype=torch.float64, device=self.device)
        return self._front(x, float(t)).to(self.dtype)


class AllenCahnFront1DSemiImplicit(AllenCahnFront1D):
    """IMEX split: Laplacian (+BC) implicit, reaction explicit
    (reference allencahn_front_semiimplicit, AllenCahn_1D_FD.py:253)."""

    f_kind = 'imex'

    def eval_f(self, u, t):
        return IMEX(impl=self.A.apply(u) + self._bc_term(t), expl=self._reaction(u))

    def solve_system(self, rhs, factor, u0, t):
        # (I - factor*A) u = rhs + factor*bc  (exact direct solve)
        return self.A.solve_shifted(rhs + factor * self._bc_term(t), factor)


class AllenCahnFront1DFinel(AllenCahnFront1D):
    """Finel's discretization trick for the traveling front (reference
    ``allencahn_front_finel``, AllenCahn_1D_FD.py:333-477).

    The double-well term is replaced by the lattice-compatible form

        g'(u) = 1/dx^2 * [ (1-a) / (1 - a (2u-1)^2) - 1 ] * (2u-1),
        a = tanh(dx / (sqrt(2) eps))^2,

    which makes the discrete traveling wave exact on the grid (no velocity
    pinning).  Fully implicit; same Newton machinery as the base class with
    the closed-form derivative of Finel's potential.
    """

    def _finel_a2(self):
        return float(np.tanh(self.dx / (np.sqrt(2) * self.eps)) ** 2)

    def _reaction(self, u):
        a2 = self._finel_a2()
        w = 2.0 * u - 1.0
        gprim = ((1.0 - a2) / (1.0 - a2 * w**2) - 1.0) * w / self.dx**2
        return -gprim - 6.0 * self.dw * u * (1.0 - u)

    def _reaction_prime(self, u):
        a2 = self._finel_a2()
        w = 2.0 * u - 1.0
        ratio = (1.0 - a2) / (1.0 - a2 * w**2)
        dgprim = (2.0 * (ratio - 1.0) + w**2 * (1.0 - a2) * 4.0 * a2 / (1.0 - a2 * w**2) ** 2) / self.dx**2
        return -dgprim - 6.0 * self.dw * (1.0 - 2.0 * u)


class AllenCahnPeriodicND(_NewtonPDE):
    """Periodic ND Allen-Cahn with shrinking-circle initial condition.

    u_t = Delta u - 2/eps^2 u (1-u)(1-2u); radius R(t) = sqrt(R0^2 - 2(d-1)t)
    (reference allencahn_periodic_* in AllenCahn_1D_FD.py / AllenCahn_2D_FD.py).
    Fully-implicit variant: each node solve is a Newton solve whose linear
    steps are PCG preconditioned by the exact shifted solve of the Laplacian
    (the eigen backend's FFT solve, or on ``backend='sparse'`` the sparse
    operator's own solve, CG on a 2D periodic grid).
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
            # assembled 5-point stencil; periodic 1D solves use cyclic Thomas, ND periodic fall to CG
            from pysdc_tpu_torch.ops.sparse_op import SparseFDOperator

            self.A = SparseFDOperator(per_dim, device=self.device)
        else:
            self.A = SeparableFDOperator(per_dim)
        self._init_newton()

    @property
    def ndim(self):
        return len(self.nvars)

    def _reaction(self, u):
        return -2.0 / self.eps**2 * u * (1.0 - u) * (1.0 - 2.0 * u)

    def _reaction_prime(self, u):
        return -2.0 / self.eps**2 * ((1.0 - u) * (1.0 - 2.0 * u) - u * (1.0 - 2.0 * u) - 2.0 * u * (1.0 - u))

    def eval_f(self, u, t):
        return self.A.apply(u) + self._reaction(u)

    def eval_f_batched(self, u, t):
        """One apply (one K1 launch on the card) and one reaction pass over the
        leading node axis (and the time axis of a block behind it)."""
        return self.eval_f(u, t)

    def _solve_shifted(self, rhs, factor):
        """The exact shifted solve of the Laplacian; on the sparse backend (CG on a 2D periodic grid) each system
        of the leading axes is solved on its own, as ``jax.vmap`` gives the JAX package's block."""
        if self.backend == 'sparse':
            return self.A.solve_shifted(rhs, factor, batch_ndim=rhs.dim() - len(self.shape))
        return self.A.solve_shifted(rhs, factor)

    def solve_system(self, rhs, factor, u0, t):
        return self._newton(self.A.apply, self._solve_shifted, self._reaction, self._reaction_prime,
                            rhs, factor, u0)

    def solve_system_batched(self, rhs, factor, u0, t):
        """All nodes in one Newton solve, each node (and each step of a block) its own system with its own
        shift; the sparse backend solves node by node."""
        if self.backend == 'sparse':
            return super().solve_system_batched(rhs, factor, u0, t)
        return self._newton(self.A.apply, self.A.solve_shifted, self._reaction, self._reaction_prime,
                            rhs, node_shift_column(self.A, factor, rhs), u0)

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
        return IMEX(impl=self.A.apply(u), expl=self._reaction(u))

    def solve_system(self, rhs, factor, u0, t, node=None):
        return self._solve_shifted(rhs, factor)

    def solve_system_batched(self, rhs, factor, u0, t):
        """One transform pair for all nodes, one shift per node; the sparse
        backend solves node by node."""
        if self.backend == 'sparse':
            return Problem.solve_system_batched(self, rhs, factor, u0, t)
        return self.A.solve_shifted(rhs, node_shift_column(self.A, factor, rhs))


class AllenCahnPeriodicMultiImplicitND(AllenCahnPeriodicND):
    """Multi-implicit variant: diffusion and reaction both implicit but
    solved separately (reference allencahn_periodic_multiimplicit /
    AllenCahn_1D_FD.py multi-implicit classes), with the Q1/Q2 split of
    :class:`~pysdc_tpu_torch.sweepers.multi_implicit.MultiImplicitSweeper`."""

    f_kind = 'comp2'

    def eval_f(self, u, t):
        return Comp2(comp1=self.A.apply(u), comp2=self._reaction(u))

    def solve_system(self, rhs, factor, u0, t):
        """Solve (I - factor*A) u = rhs (first component)."""
        return self._solve_shifted(rhs, factor)

    solve_system_batched = AllenCahnPeriodicSemiImplicitND.solve_system_batched

    def solve_system_2(self, rhs, factor, u0, t):
        """Solve u - factor*reaction(u) = rhs pointwise via Newton."""
        return self._newton(torch.zeros_like, lambda r, c: r, self._reaction, self._reaction_prime, rhs, factor, u0)
