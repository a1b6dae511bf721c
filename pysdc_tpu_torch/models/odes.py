"""Small nonlinear ODE models.

The counterpart of ``pysdc_tpu/models/odes.py`` (reference ODE toy
problems, ``implementations/problem_classes/``: Van_der_Pol_implicit.py,
Lorenz.py, LogisticEquation.py, AuzingerImplicit.py, DiscontinuousTestODE.py,
odeScalar.py, odeSystem.py, nonlinear_ODE_1.py, polynomial_test_problem.py):
the shared Newton iteration, the ``NewtonODE`` base (with ``solve_jacobian``,
ParaDiag's inner solve) and every system of that file.

A system's state is the LAST axis of ``u``; every axis in front of it is a
batch of independent systems (the collocation nodes of a diagonal sweep, the
time steps of a block).  ``eval_f`` is written over the last axis, so one call
serves a batch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pysdc_tpu_torch.core.problem import Problem, WorkCounter
from pysdc_tpu_torch.core.state import IMEX
from pysdc_tpu_torch.ops import loops
from pysdc_tpu_torch.ops.loops import CAPTURE_DEPTH, masked_loop


def _behind(x, like: torch.Tensor, trailing: int):
    """``x`` (a number, or a tensor over leading batch axes of ``like``) shaped
    to broadcast against ``like`` whose last ``trailing`` axes are not batch axes."""
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    return x.reshape(tuple(x.shape) + (1,) * (like.dim() - trailing - x.dim()) + (1,) * trailing)


def _time(t, like: torch.Tensor):
    """A time as it enters a system's formula: a host float, or a tensor of
    times (one a system of the batch) shaped against ``like (..., n)`` in its dtype."""
    if isinstance(t, np.ndarray) and t.ndim > 0:
        t = torch.as_tensor(t, dtype=torch.float64, device=like.device)
    if isinstance(t, torch.Tensor):
        return _behind(t, like, 1).to(like.dtype)
    return float(t)


def _cos(t):
    return torch.cos(t) if isinstance(t, torch.Tensor) else math.cos(t)


def _sin(t):
    return torch.sin(t) if isinstance(t, torch.Tensor) else math.sin(t)


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


def newton_solve(f, jac, rhs, factor, u0, tol, maxiter, failed=None, trace=None):
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
    capture); the block's one host read fetches it and raises.  ``trace``,
    when a list, receives the iterations each system ran (host integers; None
    under a capture).
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
    if trace is not None:
        trace.append(out.host_counts)
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
        if isinstance(t, np.ndarray) and t.ndim > 0:
            t = torch.as_tensor(t, dtype=torch.float64, device=u.device)
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

    def _initial(self, u_init=None):
        """``u_init``, or the class's initial value ``u0`` as a tensor."""
        if u_init is None:
            return torch.as_tensor(np.asarray(self.u0, dtype=float), dtype=self.dtype, device=self.device)
        return u_init

    def _reference(self, t, u_init, t_init):
        """``u(t)`` from ``u_init`` at ``t_init`` by scipy's ``solve_ivp`` on the host (float64)."""

        def rhs(tt, y):
            return self.eval_f(torch.as_tensor(y, dtype=torch.float64), tt).numpy()

        return self.generate_scipy_reference_solution(rhs, t, u_init, t_init)

    def u_exact(self, t, u_init=None, t_init=0.0):
        """The initial value ``u0`` at ``t_init``, else the scipy reference from it (systems without a closed form)."""
        u_init = self._initial(u_init)
        if float(t) == float(t_init):
            return u_init
        return self._reference(t, u_init, t_init)

    jacobian_reads_state = True

    def _jacobian_at(self, rhs, u, lead, t):
        """``I - factor J`` needs J at the real state ``u`` (zeros when None, as in the JAX package), one Jacobian
        per system of the batch ``lead`` (each at its own time), in ``rhs``'s (complex) dtype."""
        u = torch.zeros(self.shape, dtype=self.dtype, device=rhs.device) if u is None else u
        u = u.real if u.is_complex() else u
        return self.eval_jacobian(u.expand(tuple(lead) + tuple(self.shape)), t).to(rhs.dtype)

    def solve_jacobian(self, rhs, factor, u=None, t=0.0):
        """``(I - factor * J(u)) x = rhs`` with the dense (possibly complex) Jacobian: ParaDiag's inner solve."""
        J = self._jacobian_at(rhs, u, (), t)
        A = torch.eye(J.shape[-1], dtype=rhs.dtype, device=rhs.device) - factor * J
        return torch.linalg.solve(A, rhs.unsqueeze(-1)).squeeze(-1)

    def solve_jacobian_batched(self, rhs, factor, u=None, t=None):
        """Every system of the batch (ParaDiag's ``(L, M)`` steps and nodes) in one batched complex
        ``torch.linalg.solve``; ``factor`` and ``t`` hold one shift and one time per system."""
        J = self._jacobian_at(rhs, u, factor.shape, t)
        A = torch.eye(J.shape[-1], dtype=rhs.dtype, device=rhs.device) - factor.to(rhs.dtype)[..., None, None] * J
        return torch.linalg.solve(A, rhs.unsqueeze(-1)).squeeze(-1)

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


class Lorenz(NewtonODE):
    """Lorenz attractor (reference Lorenz.py:7)."""

    def __init__(self, sigma=10.0, rho=28.0, beta=8.0 / 3.0, u0=(1, 1, 1), newton_tol=1e-9, newton_maxiter=99,
                 dtype=None, device='cuda'):
        super().__init__((3,), newton_tol, newton_maxiter, dtype, device)
        self._register(sigma=sigma, rho=rho, beta=beta, u0=u0)

    def eval_f(self, u, t):
        self.work_counters['rhs']()
        x, y, z = u[..., 0], u[..., 1], u[..., 2]
        return torch.stack([self.sigma * (y - x), self.rho * x - y - x * z, x * y - self.beta * z], dim=-1)


class Logistic(NewtonODE):
    """Logistic growth u' = lam * u * (1 - u) (reference LogisticEquation.py)."""

    def __init__(self, u0=0.5, lam=1.0, newton_tol=1e-12, newton_maxiter=100, dtype=None, device='cuda'):
        super().__init__((1,), newton_tol, newton_maxiter, dtype, device)
        self._register(u0=u0, lam=lam)

    def eval_f(self, u, t):
        self.work_counters['rhs']()
        return self.lam * u * (1.0 - u)

    def eval_jacobian(self, u, t):
        """By hand: lam (1 - 2 u), as a (..., 1, 1) Jacobian."""
        return (self.lam * (1.0 - 2.0 * u)).unsqueeze(-1)

    def u_exact(self, t, u_init=None, t_init=0.0):
        u0 = self.u0 if u_init is None else float(u_init.reshape(-1)[0])
        e = math.exp(self.lam * (float(t) - float(t_init)))
        return torch.full(self.shape, u0 * e / (1 - u0 + u0 * e), dtype=self.dtype, device=self.device)


class Auzinger(NewtonODE):
    """Auzinger test system with exact circular solution
    (reference AuzingerImplicit.py): u = (cos t, sin t)."""

    def __init__(self, newton_tol=1e-12, newton_maxiter=100, dtype=None, device='cuda'):
        super().__init__((2,), newton_tol, newton_maxiter, dtype, device)

    def eval_f(self, u, t):
        self.work_counters['rhs']()
        x, y = u[..., 0], u[..., 1]
        z = x**2 + y**2 - 1
        return torch.stack([-y + x * z, x + 3 * y * z], dim=-1)

    def u_exact(self, t, u_init=None, t_init=0.0):
        return torch.tensor([math.cos(t), math.sin(t)], dtype=self.dtype, device=self.device)


class DiscontinuousTestODE(NewtonODE):
    """Scalar ODE with one discrete event at t* = log(5)
    (reference DiscontinuousTestODE.py): u' = u while u < 5, then u' = 4/t*.
    Exact: u = exp(t) for t <= t*, u = 4 t / t* + 1 after."""

    t_star = float(np.log(5.0))

    def __init__(self, newton_tol=1e-12, newton_maxiter=100, dtype=None, device='cuda'):
        super().__init__((1,), newton_tol, newton_maxiter, dtype, device)
        self._register(t_switch=np.inf, nswitches=0)

    def _switched(self, x, t):
        """Where the event has happened: ``x - 5 >= 0`` (``x`` the value, ``(..., 1)``) or ``t >= t_switch``."""
        return (x - 5.0 >= 0) | (_time(t, x) >= self.t_switch)

    def eval_f(self, u, t):
        self.work_counters['rhs']()
        return torch.where(self._switched(u[..., :1], t), 4.0 / self.t_star * torch.ones_like(u), u)

    def solve_system(self, rhs, factor, u0, t):
        self.work_counters['newton']()
        factor = _behind(factor, rhs, 1)
        u_smooth = rhs / (1.0 - factor)
        u_switched = rhs + factor * 4.0 / self.t_star
        return torch.where(self._switched(rhs[..., :1], t), u_switched, u_smooth)

    def u_exact(self, t, u_init=None, t_init=0.0):
        t = float(t)
        val = math.exp(t) if t <= self.t_star else 4.0 * t / self.t_star + 1.0
        return torch.full((1,), val, dtype=self.dtype, device=self.device)

    def get_switching_info(self, u_nodes, t):
        u_nodes = [np.asarray(u.detach().cpu() if isinstance(u, torch.Tensor) else u) for u in u_nodes]
        switch_detected, m_guess = False, -100
        for m in range(1, len(u_nodes)):
            if u_nodes[m - 1][0] - 5.0 < 0 and u_nodes[m][0] - 5.0 >= 0:
                switch_detected = True
                m_guess = m - 1
                break
        state_function = [float(u[0] - 5.0) for u in u_nodes]
        return switch_detected, m_guess, state_function

    def count_switches(self):
        self.nswitches += 1


class ProtheroRobinson(NewtonODE):
    """Classic stiff Prothero-Robinson problem
    (reference parallelSDC_reloaded/protheroRobinson): u' = -(u - g(t))/eps + g'(t),
    exact solution u = g(t) = cos(t)."""

    def __init__(self, epsilon=1e-3, newton_tol=1e-12, newton_maxiter=100, dtype=None, device='cuda'):
        super().__init__((1,), newton_tol, newton_maxiter, dtype, device)
        self._register(epsilon=epsilon)

    def eval_f(self, u, t):
        self.work_counters['rhs']()
        t = _time(t, u)
        return -(u - _cos(t)) / self.epsilon - _sin(t)

    def u_exact(self, t, u_init=None, t_init=0.0):
        return torch.full((1,), math.cos(t), dtype=self.dtype, device=self.device)


class ProtheroRobinsonNonLinear(ProtheroRobinson):
    """Nonlinear Prothero-Robinson form (reference odeScalar.py:36,73-78 with
    ``nonLinear=True``): u' = -(u^3 - g(t)^3)/eps + g'(t), g = cos."""

    def eval_f(self, u, t):
        self.work_counters['rhs']()
        t = _time(t, u)
        return -(u**3 - _cos(t) ** 3) / self.epsilon - _sin(t)


class ProtheroRobinsonAutonomous(NewtonODE):
    """Autonomous Prothero-Robinson (reference odeSystem.py:21-238): the time
    variable becomes a second component v with v' = 1; ``non_linear``
    selects the cubic form."""

    def __init__(self, epsilon=1e-3, non_linear=False, newton_tol=1e-12, newton_maxiter=100, dtype=None,
                 device='cuda'):
        super().__init__((2,), newton_tol, newton_maxiter, dtype, device)
        self._register(epsilon=epsilon, non_linear=non_linear)

    def eval_f(self, u, t):
        self.work_counters['rhs']()
        x, v = u[..., 0], u[..., 1]
        g, dg = torch.cos(v), -torch.sin(v)
        if self.non_linear:
            fx = -(x**3 - g**3) / self.epsilon + dg
        else:
            fx = -(x - g) / self.epsilon + dg
        return torch.stack([fx, torch.ones_like(v)], dim=-1)

    def u_exact(self, t, u_init=None, t_init=0.0):
        return torch.tensor([math.cos(t), float(t)], dtype=self.dtype, device=self.device)


class Kaps(NewtonODE):
    """Kaps singular-perturbation problem (reference odeSystem.py:239-392):
    u' = -(2 + 1/eps) u + v^2/eps, v' = u - v(1+v); exact u = e^{-2t},
    v = e^{-t} independent of eps."""

    def __init__(self, epsilon=1e-3, newton_tol=5e-11, newton_maxiter=200, dtype=None, device='cuda'):
        super().__init__((2,), newton_tol, newton_maxiter, dtype, device)
        self._register(epsilon=epsilon)

    def eval_f(self, u, t):
        self.work_counters['rhs']()
        x, y = u[..., 0], u[..., 1]
        return torch.stack([-(2.0 + 1.0 / self.epsilon) * x + y**2 / self.epsilon, x - y * (1.0 + y)], dim=-1)

    def u_exact(self, t, u_init=None, t_init=0.0):
        return torch.tensor([math.exp(-2.0 * t), math.exp(-t)], dtype=self.dtype, device=self.device)


class ChemicalReaction3Var(NewtonODE):
    """Stiff 3-species chemical reaction (reference odeSystem.py:394-578,
    Van der Houwen & Sommeijer 1991); reference solution via scipy."""

    u0 = (0.990731920827, 1.009264413846, -0.366532612659e-5)

    def __init__(self, newton_tol=5e-11, newton_maxiter=200, dtype=None, device='cuda'):
        super().__init__((3,), newton_tol, newton_maxiter, dtype, device)

    def eval_f(self, u, t):
        self.work_counters['rhs']()
        c1, c2, c3 = u[..., 0], u[..., 1], u[..., 2]
        return -torch.stack([
            0.013 * c1 + 1000.0 * c3 * c1,
            2500.0 * c3 * c2,
            0.013 * c1 + 1000.0 * c1 * c3 + 2500.0 * c2 * c3,
        ], dim=-1)

    def u_exact(self, t, u_init=None, t_init=0.0):
        if float(t) == 0.0:
            return self._initial()
        return self._reference(t, self._initial(u_init), t_init)


class JacobiElliptic(NewtonODE):
    """Jacobi elliptic functions system (reference odeSystem.py:745-908):
    u' = vw, v' = -uw, w' = -0.51 uv with (0, 1, 1) start."""

    u0 = (0.0, 1.0, 1.0)

    def __init__(self, newton_tol=5e-11, newton_maxiter=200, dtype=None, device='cuda'):
        super().__init__((3,), newton_tol, newton_maxiter, dtype, device)

    def eval_f(self, u, t):
        self.work_counters['rhs']()
        x, y, z = u[..., 0], u[..., 1], u[..., 2]
        return torch.stack([y * z, -x * z, -0.51 * x * y], dim=-1)

    u_exact = ChemicalReaction3Var.u_exact


class NonlinearODE1(NewtonODE):
    """u' = sqrt(1 - u), u(0) = 0, exact u = t - t^2/4 — derivative singular
    at u = 1 (reference nonlinear_ODE_1.py:9-124)."""

    def __init__(self, u0=0.0, newton_tol=5e-11, newton_maxiter=200, dtype=None, device='cuda'):
        super().__init__((1,), newton_tol, newton_maxiter, dtype, device)
        self._register(u0=u0)

    def eval_f(self, u, t):
        self.work_counters['rhs']()
        return torch.sqrt(torch.clamp(1.0 - u, min=0.0))

    def u_exact(self, t, u_init=None, t_init=0.0):
        t = float(t)
        return torch.full((1,), t - t**2 / 4.0, dtype=self.dtype, device=self.device)


def _polyval(coef_high_first, t):
    """Horner's scheme, as ``jnp.polyval``: ``t`` a number or a tensor."""
    out = 0.0
    for c in coef_high_first:
        out = out * t + float(c)
    return out


class PolynomialTestEquation(Problem):
    """Dummy problem whose solution is a random-coefficient polynomial of
    ``t`` and whose ``solve_system`` returns the exact solution — for testing
    operations that are exact on polynomials, e.g. collocation transfer and
    polynomial error estimation (reference polynomial_test_problem.py:7-101).
    Values at a tensor of times (one a system of the batch) have the batch's shape."""

    def __init__(self, degree=1, seed=26266, dtype=None, device='cuda'):
        super().__init__(shape=(1,), dtype=dtype, device=device)
        self._register(degree=degree, seed=seed)
        rng = np.random.RandomState(seed=seed)
        self.coeffs = rng.rand(degree)
        self.poly = np.polynomial.Polynomial(self.coeffs)
        self.dpoly = self.poly.deriv(m=1)

    def _at(self, poly, t, like):
        return torch.ones_like(like) * _polyval(poly.coef[::-1], _time(t, like))

    def eval_f(self, u, t):
        return self._at(self.dpoly, t, u)

    def eval_f_batched(self, u, t):
        return self.eval_f(u, t)

    def solve_system(self, rhs, factor, u0, t):
        return self._at(self.poly, t, rhs)

    def u_exact(self, t, u_init=None, t_init=0.0):
        return torch.full((1,), _polyval(self.poly.coef[::-1], float(t)), dtype=self.dtype, device=self.device)


class PolynomialTestEquationIMEX(PolynomialTestEquation):
    """IMEX split: half the derivative implicit, half explicit
    (reference polynomial_test_problem.py:102-124)."""

    f_kind = 'imex'

    def eval_f(self, u, t):
        d = self._at(self.dpoly, t, u)
        return IMEX(impl=d / 2.0, expl=d / 2.0)
