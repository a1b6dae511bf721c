"""Small nonlinear ODE models.

The counterpart of ``pysdc_tpu/models/odes.py`` (reference
``implementations/problem_classes/Van_der_Pol_implicit.py``): the shared
Newton iteration, the ``NewtonODE`` base and ``VanDerPol``.  The other systems
of that file wait for ROADMAP queue 1, item 14.

A system's state is the LAST axis of ``u``; every axis in front of it is a
batch of independent systems (the collocation nodes of a diagonal sweep, the
time steps of a block).  ``eval_f`` is written over the last axis, so one call
serves a batch.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.problem import Problem, WorkCounter
from pysdc_tpu_torch.ops import loops
from pysdc_tpu_torch.ops.loops import CAPTURE_DEPTH, masked_loop


def _behind(x, like: torch.Tensor, trailing: int):
    """``x`` (a number, or a tensor over leading batch axes of ``like``) shaped
    to broadcast against ``like`` whose last ``trailing`` axes are not batch axes."""
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    return x.reshape(tuple(x.shape) + (1,) * (like.dim() - trailing - x.dim()) + (1,) * trailing)


def eliminate(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the small dense systems ``A x = b`` (``A (..., n, n)``, ``b (..., n)``)
    by Gaussian elimination with partial pivoting, written as tensor operations
    over the batch: ``torch.linalg.solve`` reads its error flag on the host,
    which a CUDA graph capture does not permit.  About ``10 n`` small kernels;
    meant for the few unknowns of an ODE system."""
    n = A.shape[-1]
    rows = torch.arange(n, device=A.device)
    M = torch.cat([A, b.unsqueeze(-1)], dim=-1)  # (..., n, n + 1)
    for k in range(n):
        # the row at or below k with the largest entry in column k comes to row k
        p = M[..., k:, k].abs().argmax(dim=-1) + k
        is_p = (rows == p.unsqueeze(-1)).unsqueeze(-1)
        row_k = M[..., k:k + 1, :]
        row_p = (M * is_p).sum(dim=-2, keepdim=True)
        M = torch.where(is_p, row_k, torch.where((rows == k).reshape(-1, 1), row_p, M))
        factors = torch.where(rows > k, M[..., :, k] / M[..., k:k + 1, k], torch.zeros_like(M[..., :, k]))
        M = M - factors.unsqueeze(-1) * M[..., k:k + 1, :]
    x = [None] * n
    for k in range(n - 1, -1, -1):
        acc = M[..., k, n]
        for j in range(k + 1, n):
            acc = acc - M[..., k, j] * x[j]
        x[k] = acc / M[..., k, k]
    return torch.stack(x, dim=-1)


def newton_solve(f, jac, rhs, factor, u0, tol, maxiter, failed=None):
    """Solve ``u - factor * f(u) = rhs`` with Newton for a batch of systems.

    ``u0`` and ``rhs`` are ``(..., n)``: the last axis is one system, the axes
    in front are a batch.  ``f(u)`` maps ``(..., n)`` to ``(..., n)`` and
    ``jac(u)`` to its Jacobians ``(..., n, n)``.  ``factor`` and ``tol`` are
    numbers or tensors over leading batch axes (one shift per node, one
    tolerance per time step).

    Each system carries its own stopping flag: it iterates while the 2-norm of
    its residual is above ``tol`` and fewer than ``maxiter`` iterations are
    done, and does not change after that (what ``jax.vmap`` of the JAX
    package's ``lax.while_loop`` does): the loop is a
    :func:`~pysdc_tpu_torch.ops.loops.masked_loop`, which reads the flags on
    the host every ``READ_EVERY`` iterations and stops with the last system.

    While a CUDA graph is being captured the host cannot read: the loop then
    runs ``min(maxiter, CAPTURE_DEPTH)`` masked iterations and solves its
    linear systems with :func:`eliminate` (``torch.linalg.solve`` reads its
    error flag on the host).  A system that is still above ``tol`` when the
    fixed depth ends, and that the eager loop would have gone on iterating,
    sets the device flag ``failed`` (a 0-d bool tensor made before the
    capture); the block's one host read fetches it and raises.
    """
    n = u0.shape[-1]
    factor = _behind(factor, u0, 1)
    tol = _behind(tol, u0, 1)
    if isinstance(tol, torch.Tensor) and tol.dim() > 0:
        tol = tol.squeeze(-1)  # against the (...,) residual norms
    eye = torch.eye(n, dtype=u0.dtype, device=u0.device)

    def g(u):
        return u - factor * f(u) - rhs

    fac = factor.unsqueeze(-1) if isinstance(factor, torch.Tensor) and factor.dim() > 0 else factor  # against (n, n)
    capture = loops.capturing(u0)

    def body(carry, flags):
        u, G = carry
        J = eye - fac * jac(u)
        du = eliminate(J, G) if capture else torch.linalg.solve(J, G.unsqueeze(-1)).squeeze(-1)
        u = u - du
        return u, g(u)

    out = masked_loop(body, lambda c: torch.linalg.vector_norm(c[1], dim=-1) > tol, (u0, g(u0)), int(maxiter),
                      depth=CAPTURE_DEPTH, failed=failed)
    return out.carry[0]


class NewtonODE(Problem):
    """Base for small ODE systems solved implicitly via Newton.

    ``newton_tol`` is a per-step problem scalar: the block controller sets it
    to a ``(P,)`` tensor for a sweep over a block (one tolerance per step).
    ``newton_failed`` is the device flag of :func:`newton_solve`."""

    def __init__(self, shape, newton_tol=1e-9, newton_maxiter=99, dtype=None, device='cuda'):
        super().__init__(shape=shape, dtype=dtype, device=device)
        self._register(newton_tol=newton_tol, newton_maxiter=newton_maxiter)
        self.work_counters['newton'] = WorkCounter()
        self.work_counters['rhs'] = WorkCounter()
        self.newton_failed = torch.zeros((), dtype=torch.bool, device=self.device)

    def eval_jacobian(self, u, t):
        """Jacobians ``(..., n, n)`` of ``eval_f`` at ``u (..., n)`` by forward-mode
        differentiation, one system at a time under ``vmap`` (a tensor ``t``
        gives one time per system).  Subclasses may give them by hand."""
        n = u.shape[-1]
        flat = u.reshape(-1, n)
        niter = self.work_counters['rhs'].niter
        if isinstance(t, torch.Tensor) and t.dim() > 0:
            tt = _behind(t, u, 1).expand(u.shape[:-1] + (1,)).reshape(-1)
            J = torch.func.vmap(torch.func.jacfwd(lambda v, s: self.eval_f(v, s)))(flat, tt)
        else:
            J = torch.func.vmap(torch.func.jacfwd(lambda v: self.eval_f(v, t)))(flat)
        self.work_counters['rhs'].niter = niter  # tracing is not an evaluation
        return J.reshape(u.shape + (n,))

    def eval_f_batched(self, u, t):
        """``eval_f`` is written over the last axis: the node axis rides along."""
        return self.eval_f(u, t)

    def solve_system(self, rhs, factor, u0, t):
        self.work_counters['newton']()
        return newton_solve(
            lambda u: self.eval_f(u, t), lambda u: self.eval_jacobian(u, t), rhs, factor, u0,
            self.newton_tol, self.newton_maxiter, failed=self.newton_failed,
        )

    def solve_system_batched(self, rhs, factor, u0, t):
        """All nodes in one Newton solve: ``factor`` holds one shift per node."""
        if not isinstance(factor, torch.Tensor):
            factor = torch.as_tensor(np.asarray(factor, dtype=float), dtype=rhs.dtype, device=rhs.device)
        tol = self.newton_tol
        if isinstance(tol, torch.Tensor) and tol.dim() > 0:
            tol = tol.unsqueeze(0)  # (P,) per step -> behind the node axis
        self.work_counters['newton'](rhs.shape[0])
        return newton_solve(
            lambda u: self.eval_f(u, t), lambda u: self.eval_jacobian(u, t), rhs, factor.to(rhs.dtype), u0,
            tol, self.newton_maxiter, failed=self.newton_failed,
        )


class VanDerPol(NewtonODE):
    """Van der Pol oscillator, implicit (reference Van_der_Pol_implicit.py)."""

    def __init__(self, u0=(2.0, 0.0), mu=5.0, newton_tol=1e-9, newton_maxiter=100, dtype=None, device='cuda'):
        super().__init__((2,), newton_tol, newton_maxiter, dtype, device)
        self._register(u0=u0, mu=mu)

    def eval_f(self, u, t):
        self.work_counters['rhs']()
        x, y = u[..., 0], u[..., 1]
        return torch.stack([y, self.mu * (1 - x**2) * y - x], dim=-1)

    def eval_jacobian(self, u, t):
        """By hand: [[0, 1], [-2 mu x y - 1, mu (1 - x^2)]]."""
        x, y = u[..., 0], u[..., 1]
        row0 = torch.stack([torch.zeros_like(x), torch.ones_like(x)], dim=-1)
        row1 = torch.stack([-2.0 * self.mu * x * y - 1.0, self.mu * (1 - x**2)], dim=-1)
        return torch.stack([row0, row1], dim=-2)

    def u_exact(self, t, u_init=None, t_init=0.0):
        if u_init is None:
            u_init = torch.as_tensor(np.asarray(self.u0, dtype=float), dtype=self.dtype, device=self.device)
        if float(t) == float(t_init):
            return u_init

        def rhs(tt, y):
            return self.eval_f(torch.as_tensor(y, dtype=torch.float64), tt).numpy()

        return self.generate_scipy_reference_solution(rhs, t, u_init, t_init)
