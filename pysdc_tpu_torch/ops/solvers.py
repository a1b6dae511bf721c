"""Newton-Krylov for implicit PDE systems, on the masked loop.

The counterpart of ``pysdc_tpu/ops/solvers.py``: the common structure
``u - factor*(A u + g(u)) = rhs`` gets one shared Newton solver whose linear
steps are preconditioned CG with the operator's exact shifted solve
``(I - factor*A)^{-1}`` as the preconditioner.  Both loops are
:func:`~pysdc_tpu_torch.ops.loops.masked_loop`\\ s: the stopping tests stay on
the device, the host reads the flags every ``READ_EVERY`` iterations, and
under a CUDA graph capture nothing is read (PCG runs ``maxiter`` masked
iterations, which is exact: the JAX loop stops there too; Newton runs
``min(newton_maxiter, CAPTURE_DEPTH)`` and sets the device flag ``failed``
where that cut a system short).

The semantics are the JAX package's, to the iteration: PCG stops on the
absolute 2-norm of the residual over the whole system, ``z0 = M_inv(r0)`` is
made before the loop (``k`` iterations cost ``k + 1`` preconditioner solves);
Newton stops on ``max|G|`` and runs PCG to ``lin_tol`` 1e-13 in at most
``lin_maxiter`` 50 iterations.

Leading axes may be a batch of independent systems (``batch_ndim`` of them:
the collocation nodes, the time steps of a block): each system has its own
norms, flags and counts, as ``jax.vmap`` of the JAX functions gives.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pysdc_tpu_torch.ops.loops import CAPTURE_DEPTH, behind, masked_loop


def _space_dims(x: torch.Tensor, batch_ndim: int) -> tuple:
    return tuple(range(batch_ndim, x.dim()))


def _vdot(a: torch.Tensor, b: torch.Tensor, batch_ndim: int = 0) -> torch.Tensor:
    """``jnp.vdot`` per system: ``sum(conj(a) * b)`` over the axes behind the batch."""
    prod = a.conj() * b if a.is_complex() else a * b
    return prod.sum(dim=_space_dims(prod, batch_ndim))


def _norm2(x: torch.Tensor, batch_ndim: int = 0) -> torch.Tensor:
    """2-norm per system over the axes behind the batch."""
    return torch.linalg.vector_norm(x, dim=_space_dims(x, batch_ndim))


def _norm_max(x: torch.Tensor, batch_ndim: int = 0) -> torch.Tensor:
    """max-abs per system over the axes behind the batch."""
    return x.abs().amax(dim=_space_dims(x, batch_ndim))


class PCGInfo(NamedTuple):
    iterations: list | None  #: per system, host integers (None under a capture)
    steps: int  #: iterations computed, masked ones included
    reads: int  #: host reads


def pcg(matvec, b, x0, M_inv=None, tol=1e-12, maxiter=100, *, batch_ndim=0, active=None):
    """Preconditioned conjugate gradients, ``(x, PCGInfo)``.

    Stops where ``||r||_2 <= tol`` (absolute) or after ``maxiter``
    iterations, per system; ``active`` masks systems out from the start."""
    if M_inv is None:
        M_inv = lambda x: x  # noqa: E731

    def body(carry, flags):
        x, r, z, p, rz = carry
        Ap = matvec(p)
        alpha = behind(rz / _vdot(p, Ap, batch_ndim), p)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_inv(r)
        rz_new = _vdot(r, z, batch_ndim)
        p = z + behind(rz_new / rz, p) * p
        return x, r, z, p, rz_new

    def cond(carry):
        return _norm2(carry[1], batch_ndim) > tol

    r0 = b - matvec(x0)
    z0 = M_inv(r0)
    out = masked_loop(body, cond, (x0, r0, z0, z0, _vdot(r0, z0, batch_ndim)), maxiter, active=active)
    return out.carry[0], PCGInfo(out.host_counts, out.steps, out.reads)


class NewtonInfo(NamedTuple):
    iterations: list | None  #: Newton iterations per system (None under a capture)
    pcg: list  #: per Newton step computed (masked ones included), its PCGInfo
    steps: int  #: Newton steps computed, masked ones included
    reads: int  #: host reads, Newton's and every PCG's

    def per_system(self) -> list:
        """One ``(newton iterations, [PCG iterations of each])`` per system."""
        if self.iterations is None:
            return []
        return [(k, [info.iterations[s] for info in self.pcg[:k]]) for s, k in enumerate(self.iterations)]

    @property
    def applies(self) -> int:
        """Operator applies made: ``G(u0)``, then per Newton step ``G(u)``, ``J(x0)``, one a PCG step and ``G``
        of the update."""
        return 1 + sum(3 + info.steps for info in self.pcg)


def newton_pde(apply_A, solve_shifted, g, gprime, rhs, factor, u0, *, newton_tol=1e-11, newton_maxiter=50,
               lin_tol=1e-13, lin_maxiter=50, batch_ndim=0, failed=None):
    """Solve ``u - factor*(A u + g(u)) = rhs``: ``(u, NewtonInfo)``.

    ``apply_A`` / ``solve_shifted`` are the linear operator and its exact
    shifted inverse (the preconditioner), ``g`` / ``gprime`` the pointwise
    nonlinearity and its derivative.  ``factor`` is a number or a tensor that
    broadcasts against ``rhs``; ``newton_tol`` a number or a tensor of the
    batch shape.  ``failed`` (a 0-d bool tensor) is required inside a CUDA
    graph capture when ``newton_maxiter`` exceeds ``CAPTURE_DEPTH``."""

    def G(u):
        return u - factor * (apply_A(u) + g(u)) - rhs

    pcg_infos = []

    def body(carry, flags):
        u, _ = carry
        dg = gprime(u)

        def J(x):
            return x - factor * (apply_A(x) + dg * x)

        def M_inv(x):
            return solve_shifted(x, factor)

        du, info = pcg(J, G(u), torch.zeros_like(u), M_inv=M_inv, tol=lin_tol, maxiter=lin_maxiter,
                       batch_ndim=batch_ndim, active=flags)
        pcg_infos.append(info)
        u_new = u - du
        return u_new, _norm_max(G(u_new), batch_ndim)

    def cond(carry):
        return carry[1] > newton_tol

    out = masked_loop(body, cond, (u0, _norm_max(G(u0), batch_ndim)), newton_maxiter, depth=CAPTURE_DEPTH,
                      failed=failed)
    reads = out.reads + sum(info.reads for info in pcg_infos)
    return out.carry[0], NewtonInfo(out.host_counts, pcg_infos, out.steps, reads)
