"""CG and GMRES for the iterative linear solves, on the masked loop.

The port's own copy of the algorithms of ``jax.scipy.sparse.linalg`` (jax
0.9), which the JAX package calls for its ``solver_type='CG'|'GMRES'``
solves (``pysdc_tpu/ops/linop.py:272-290``, ``pysdc_tpu/ops/sparse_op.py:297,
439``), with the same tolerance rule: stop where ``norm(residual) <= max(tol *
norm(b), atol)`` (``atol`` 0 here).

- :func:`cg`: conjugate gradients, the stopping test on the recurrence's
  ``r.r`` against ``max(tol^2 b.b, atol^2)``; ``maxiter`` counts iterations.
- :func:`gmres`: restarted GMRES, ``solve_method='batched'``: each restart
  builds a Krylov space of dimension ``restart`` (20) by Arnoldi with one pass
  of classical Gram-Schmidt (jax's "twice" loop stops after the first at two
  iterations), stops early only at a breakdown, and solves the small least
  squares problem through the normal equations by Cholesky; ``maxiter``
  counts restarts, and the test between restarts is on the true residual.

Every loop is a :func:`~pysdc_tpu_torch.ops.loops.masked_loop`: the stopping
tests stay on the device and the host reads every ``READ_EVERY`` iterations.
``b`` is one system, whatever its shape (``jax.scipy`` flattens too).
Each function returns ``(x, info)`` with the counts a trace records.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pysdc_tpu_torch.ops.loops import masked_loop


def _vdot_real(x, y):
    """Real part of ``vdot(x, y)`` (jax's ``_vdot_real_part``)."""
    if x.is_complex() or y.is_complex():
        return (x.real * y.real).sum() + (x.imag * y.imag).sum()
    return (x * y).sum()


def _norm(x):
    return torch.sqrt(_vdot_real(x, x))


class KrylovInfo(NamedTuple):
    iterations: int | None  #: CG iterations, or GMRES restarts (None under a capture)
    arnoldi: list  #: GMRES: Arnoldi steps of each restart; CG: empty
    reads: int  #: host reads


def cg(A, b, x0=None, *, tol=1e-5, atol=0.0, maxiter=None, M=None):
    """``jax.scipy.sparse.linalg.cg``: ``(x, KrylovInfo)``."""
    x0 = torch.zeros_like(b) if x0 is None else x0
    if maxiter is None:
        maxiter = 10 * b.numel()
    identity = M is None
    M = (lambda v: v) if identity else M  # noqa: E731
    atol2 = torch.clamp(tol**2 * _vdot_real(b, b), min=atol**2)

    def body(carry, flags):
        x, r, gamma, p = carry
        Ap = A(p)
        alpha = gamma / _vdot_real(p, Ap).to(gamma.dtype)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        gamma_new = _vdot_real(r, z).to(gamma.dtype)
        p = z + (gamma_new / gamma) * p
        return x, r, gamma_new, p

    def cond(carry):
        rs = carry[2].real if identity else _vdot_real(carry[1], carry[1])
        return rs > atol2

    r0 = b - A(x0)
    z0 = M(r0)
    gamma0 = _vdot_real(r0, z0).to(z0.dtype)
    out = masked_loop(body, cond, (x0, r0, gamma0, z0), maxiter)
    return out.carry[0], KrylovInfo(None if out.host_counts is None else out.host_counts[0], [], out.reads)


def _safe_normalize(x, thresh=None):
    """``(x / |x|, |x|)``, or zeros and 0 where ``|x| <= thresh`` (default: the dtype's eps)."""
    n = _norm(x)
    if thresh is None:
        thresh = torch.finfo(n.dtype).eps
    use = n > thresh
    return torch.where(use, x / n, torch.zeros_like(x)), torch.where(use, n, torch.zeros_like(n))


def _lstsq(a, b):
    """Least squares through the normal equations, Cholesky (jax's ``_lstsq``); ``cholesky_ex`` reads no
    error flag on the host."""
    ah = a.T.conj()
    L, _ = torch.linalg.cholesky_ex(ah @ a)
    return torch.cholesky_solve((ah @ b).unsqueeze(-1), L).squeeze(-1)


def _gmres_restart(A, M, b, x0, unit_residual, residual_norm, restart, arnoldi):
    """One restart of batched GMRES (jax's ``_gmres_batched``); vectors are flat, ``A`` and ``M`` take ``b``'s
    shape.  Appends the restart's Arnoldi steps to ``arnoldi``."""
    shape = b.shape
    n = unit_residual.numel()
    dtype = b.dtype
    V = torch.zeros((restart + 1, n), dtype=dtype, device=b.device)
    V[0] = unit_residual.reshape(-1)
    H = torch.eye(restart, restart + 1, dtype=dtype, device=b.device)
    eps = torch.finfo(b.real.dtype if b.is_complex() else dtype).eps
    step = [0]

    def body(carry, flags):
        V, H, breakdown = carry
        k = step[0]
        step[0] += 1
        v = M(A(V[k].reshape(shape))).reshape(-1)
        _, v_norm_0 = _safe_normalize(v)
        h = V.conj() @ v  # projection on every column, one pass of classical Gram-Schmidt
        v = v - h @ V
        unit_v, v_norm_1 = _safe_normalize(v, thresh=eps * v_norm_0)
        h[k + 1] = v_norm_1.to(dtype)
        # rows k + 1 of V and k of H are written only here: in place, kept as they were where the step is masked
        V[k + 1] = torch.where(flags, unit_v, V[k + 1])
        H[k] = torch.where(flags, h, H[k])
        return V, H, v_norm_1 == 0

    out = masked_loop(body, lambda c: ~c[2], (V, H, torch.zeros((), dtype=torch.bool, device=b.device)), restart)
    arnoldi.append(out.host_counts[0] if out.host_counts is not None else None)
    V, H, _ = out.carry
    beta = torch.zeros(restart + 1, dtype=dtype, device=b.device)
    beta[0] = residual_norm.to(dtype)
    y = _lstsq(H.T, beta)
    x = x0 + (y @ V[:-1]).reshape(shape)
    unit, rnorm = _safe_normalize(M(b - A(x)))
    return (x, unit, rnorm), out.reads


def gmres(A, b, x0=None, *, tol=1e-5, atol=0.0, restart=20, maxiter=None, M=None):
    """``jax.scipy.sparse.linalg.gmres(..., solve_method='batched')``: ``(x, KrylovInfo)``."""
    x0 = torch.zeros_like(b) if x0 is None else x0
    M = (lambda v: v) if M is None else M  # noqa: E731
    size = b.numel()
    if maxiter is None:
        maxiter = 10 * size
    restart = min(restart, size)
    atol_t = torch.clamp(tol * _norm(b), min=atol)
    unit, rnorm = _safe_normalize(M(b - A(x0)))
    arnoldi = []
    inner_reads = [0]

    def body(carry, flags):
        new, reads = _gmres_restart(A, M, b, *carry, restart, arnoldi)
        inner_reads[0] += reads
        return new

    out = masked_loop(body, lambda c: c[2] > atol_t, (x0, unit, rnorm), maxiter)
    restarts = None if out.host_counts is None else out.host_counts[0]
    return out.carry[0], KrylovInfo(restarts, arnoldi[:restarts] if restarts is not None else arnoldi,
                                    out.reads + inner_reads[0])

