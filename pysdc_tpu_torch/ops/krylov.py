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
tests stay on the device and the host reads every ``READ_EVERY`` iterations;
inside a CUDA graph capture each loop is a device ``while`` (a restart's
Arnoldi loop a node inside the restart loop's body), so no body reads a host
counter: the Arnoldi index is a device counter and the rows it writes are
selected with index ops that take it, as ``jax.scipy`` does with
``dynamic_update_slice`` and a traced index.
``b`` is one system, whatever its shape (``jax.scipy`` flattens too).
Each function returns ``(x, info)`` with the counts a trace records.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pysdc_tpu_torch.ops.loops import behind, masked_loop


def _vdot_real(x, y, batch_ndim=0):
    """Real part of ``vdot(x, y)`` (jax's ``_vdot_real_part``), over the axes behind ``batch_ndim`` leading ones."""
    dims = tuple(range(batch_ndim, x.dim()))
    if x.is_complex() or y.is_complex():
        return (x.real * y.real).sum(dim=dims) + (x.imag * y.imag).sum(dim=dims)
    return (x * y).sum(dim=dims)


def _norm(x):
    return torch.sqrt(_vdot_real(x, x))


class KrylovInfo(NamedTuple):
    #: CG iterations (a list for several systems), or GMRES restarts; None under a capture
    iterations: int | list | None
    arnoldi: list  #: GMRES: Arnoldi steps of each restart; CG: empty
    reads: int  #: host reads


def cg(A, b, x0=None, *, tol=1e-5, atol=0.0, maxiter=None, M=None, batch_ndim=0):
    """``jax.scipy.sparse.linalg.cg``: ``(x, KrylovInfo)``.  ``batch_ndim`` leading axes of ``b`` are independent
    systems, each with its own inner products, stopping test and count (``jax.vmap`` of the solve); ``A`` and ``M``
    act on the whole batch."""
    x0 = torch.zeros_like(b) if x0 is None else x0
    if maxiter is None:
        maxiter = 10 * b[(0,) * batch_ndim].numel()
    identity = M is None
    M = (lambda v: v) if identity else M  # noqa: E731

    def dot(x, y):
        return _vdot_real(x, y, batch_ndim)

    atol2 = torch.clamp(tol**2 * dot(b, b), min=atol**2)

    def body(carry, flags):
        x, r, gamma, p = carry
        Ap = A(p)
        alpha = behind(gamma / dot(p, Ap).to(gamma.dtype), p)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        gamma_new = dot(r, z).to(gamma.dtype)
        p = z + behind(gamma_new / gamma, z) * p
        return x, r, gamma_new, p

    def cond(carry):
        rs = carry[2].real if identity else dot(carry[1], carry[1])
        return rs > atol2

    r0 = b - A(x0)
    z0 = M(r0)
    gamma0 = dot(r0, z0).to(z0.dtype)
    out = masked_loop(body, cond, (x0, r0, gamma0, z0), maxiter)
    counts = out.host_counts
    if counts is not None and batch_ndim == 0:
        counts = counts[0]
    return out.carry[0], KrylovInfo(counts, [], out.reads)


def _safe_norm(x, thresh=None):
    """``(|x|, |x| > thresh)``, the norm 0 where it is not (``thresh`` default: the dtype's eps)."""
    n = _norm(x)
    use = n > (torch.finfo(n.dtype).eps if thresh is None else thresh)
    return torch.where(use, n, 0.0), use


def _safe_normalize(x, thresh=None):
    """``(x / |x|, |x|)``, or zeros and 0 where ``|x| <= thresh`` (default: the dtype's eps)."""
    n, use = _safe_norm(x, thresh)
    return torch.where(use, x / n, 0.0), n


def _lstsq(a, b):
    """Least squares through the normal equations and their Cholesky factor (jax's ``_lstsq``): cuSOLVER's factor
    (``cholesky_ex``, which reads no error flag on the host) and cuBLAS's two triangular solves.  Not
    ``cholesky_solve``: in a GMRES restart, which a CUDA graph captures as the body of a conditional node holding
    the Arnoldi loop's node, it made the fused GMRES block's graph fail to instantiate (``cudaErrorInvalidValue``)
    on an H100 (CUDA 12.9, driver 13.0), while ``cholesky_ex`` and ``solve_triangular`` captured and replayed."""
    ah = a.T.conj()
    L, _ = torch.linalg.cholesky_ex(ah @ a)
    y = torch.linalg.solve_triangular(L, (ah @ b).unsqueeze(-1), upper=False)
    return torch.linalg.solve_triangular(L.mH, y, upper=True).squeeze(-1)


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
    zero = torch.zeros((), dtype=dtype, device=b.device)

    def body(carry, flags):
        # the Arnoldi index k lives on the device; k <= the iterations run before this one < restart
        V, H, breakdown, k = carry
        at, nxt = k.reshape(1), k + 1
        below = nxt.reshape(1)
        v = M(A(V.index_select(0, at).reshape(shape))).reshape(-1)
        v_norm_0, _ = _safe_norm(v)
        h = V.conj() @ v  # projection on every column, one pass of classical Gram-Schmidt
        v = v - h @ V
        unit_v, v_norm_1 = _safe_normalize(v, thresh=eps * v_norm_0)
        h.index_copy_(0, below, v_norm_1.to(dtype).reshape(1))  # h[k + 1]: the rows past k of V are still zero
        # rows k + 1 of V and k of H are written only here, in place.  Where the step is masked they keep what they
        # held: row k + 1 of V is still zero there (a system stops at a breakdown, whose unit vector is zero)
        V.index_copy_(0, below, torch.where(flags, unit_v, zero).unsqueeze(0))
        H.index_copy_(0, at, torch.where(flags, h, H.index_select(0, at)[0]).unsqueeze(0))
        return V, H, v_norm_1 == 0, nxt

    start = (V, H, torch.zeros((), dtype=torch.bool, device=b.device),
             torch.zeros((), dtype=torch.int64, device=b.device))
    out = masked_loop(body, lambda c: ~c[2], start, restart)
    arnoldi.append(out.host_counts[0] if out.host_counts is not None else None)
    V, H, _, _ = out.carry
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

