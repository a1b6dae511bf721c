"""Structured sparse factorization: parallel cyclic reduction, banded LU,
block cyclic reduction.

The counterpart of ``pysdc_tpu/ops/banded.py``: the answer to the reference's
cached ``splu`` of ``(I - dt*q*A)`` (``generic_ND_FD.py:208-240``).  The
shift is a plain number; every solver batches over leading axes of the RHS.

  - :func:`tridiag_pcr_solve` — parallel cyclic reduction (PCR): O(log n)
    full-width elementwise steps.
  - :func:`tridiag_solve` — the Thomas algorithm, a loop over the rows;
    the reference path PCR is held against.
  - :func:`banded_factor` / :func:`banded_solve` — LU without pivoting in
    band storage for small bandwidths (diagonally dominant shifted FD
    operators need no pivoting).  The elimination is sequential by nature
    and runs on the host in float64; the substitution runs on the RHS's
    device.
  - :func:`block_cr_factor` / :func:`block_cr_solve` — block cyclic
    reduction with dense ``(b, b)`` blocks: O(log nb) levels, each a batched
    inverse and batched products.  The factor/solve split lets a level
    factor once per run and serve every sweep by substitution.
  - :func:`block_tridiag_solve` — sequential block Thomas; the reference
    path block CR is held against.

Where the JAX package runs ``lax.scan`` the port runs a Python loop.  Dense
block inverses and products go to ``torch.linalg.inv`` and ``torch.matmul``
in full precision (TF32 is off, :mod:`pysdc_tpu_torch.core.precision`), as
the JAX package leaves them to XLA at ``Precision.HIGHEST``.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.device import resolve_device
from pysdc_tpu_torch.core.errors import ProblemError


# ----------------------------------------------------------------------
def _shift_last(x, s, fill=0.0):
    """x[..., i - s] with out-of-range entries replaced by ``fill``
    (s may be negative for a left shift; |s| < n)."""
    n = x.shape[-1]
    if s == 0:
        return x
    pad = torch.full(x.shape[:-1] + (abs(s),), fill, dtype=x.dtype, device=x.device)
    if s > 0:
        return torch.cat([pad, x[..., : n - s]], dim=-1)
    return torch.cat([x[..., -s:], pad], dim=-1)


def tridiag_pcr_solve(lower, diag, upper, rhs):
    """Parallel cyclic reduction for tridiagonal systems.

    ``lower[i]`` multiplies x[i-1], ``upper[i]`` multiplies x[i+1]; rhs
    batches over leading axes.  Every step eliminates both neighbours of
    every row at once with full-width elementwise arithmetic.  Stable for the
    diagonally dominant shifted operators SDC produces.
    """
    n = diag.shape[0]
    lo = lower.clone()
    lo[0] = 0.0
    up = upper.clone()
    up[-1] = 0.0
    dg = diag
    r = rhs
    s = 1
    while s < n:
        alpha = lo / _shift_last(dg, s, fill=1.0)
        gamma = up / _shift_last(dg, -s, fill=1.0)
        dg = dg - alpha * _shift_last(up, s) - gamma * _shift_last(lo, -s)
        r = r - alpha * _shift_last(r, s) - gamma * _shift_last(r, -s)
        lo, up = -alpha * _shift_last(lo, s), -gamma * _shift_last(up, -s)
        s *= 2
    return r / dg


def tridiag_solve(lower, diag, upper, rhs):
    """Solve a tridiagonal system by the Thomas algorithm.

    ``lower[i]`` multiplies x[i-1] in row i (lower[0] unused), ``upper[i]``
    multiplies x[i+1] (upper[-1] unused).  ``rhs`` may carry leading batch
    axes; the system axis is the last one.
    """
    n = diag.shape[0]
    lo = lower.clone()
    lo[0] = 0.0
    c_prev = torch.zeros((), dtype=diag.dtype, device=diag.device)
    d_prev = torch.zeros_like(rhs[..., 0])
    cs, ds = [], []
    for i in range(n):
        denom = diag[i] - lo[i] * c_prev
        c_prev = upper[i] / denom
        d_prev = (rhs[..., i] - lo[i] * d_prev) / denom
        cs.append(c_prev)
        ds.append(d_prev)
    x_next = torch.zeros_like(rhs[..., 0])
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        x_next = ds[i] - cs[i] * x_next
        xs[i] = x_next
    return torch.stack(xs, dim=-1)


def cyclic_tridiag_solve(lower, diag, upper, corner_lo, corner_up, rhs):
    """Periodic tridiagonal solve via Sherman-Morrison over PCR.

    ``corner_up`` is A[0, n-1] and ``corner_lo`` is A[n-1, 0].  One rank-1
    correction turns the cyclic system into two standard solves.
    """
    n = diag.shape[0]
    gamma = -diag[0]
    dmod = diag.clone()
    dmod[0] = dmod[0] + (-gamma)
    dmod[n - 1] = dmod[n - 1] + (-corner_up * corner_lo / gamma)
    y = tridiag_pcr_solve(lower, dmod, upper, rhs)
    u = torch.zeros(n, dtype=diag.dtype, device=diag.device)
    u[0] = gamma
    u[n - 1] = corner_lo
    z = tridiag_pcr_solve(lower, dmod, upper, u)
    # v = e_0 + (corner_up / gamma) e_{n-1}
    vy = y[..., 0] + corner_up / gamma * y[..., n - 1]
    vz = z[0] + corner_up / gamma * z[n - 1]
    return y - (vy / (1.0 + vz))[..., None] * z


# ----------------------------------------------------------------------
def banded_factor(bands, lower_bw, upper_bw):
    """LU (no pivoting) of a banded matrix in band storage.

    ``bands[j, i] = A[i, i + j - lower_bw]`` for j in 0..lower_bw+upper_bw.
    Returns the factored rows ``(n, lower_bw + upper_bw + 1)`` on ``bands``'
    device and in its dtype: multipliers stored below column ``lower_bw``,
    U at and above it.  The elimination runs on the host in float64.
    """
    lb, ub = lower_bw, upper_bw
    work = bands.detach().cpu().double().numpy().T.copy()  # (n, width) row-major
    n = work.shape[0]
    for i in range(n):
        pivot = work[i, lb]
        for r in range(1, lb + 1):
            row = i + r
            if row >= n:
                break
            mult = work[row, lb - r] / pivot
            for c in range(1, ub + 1):
                work[row, lb - r + c] = work[row, lb - r + c] - mult * work[i, lb + c]
            work[row, lb - r] = mult
    return torch.as_tensor(work, dtype=bands.dtype, device=bands.device)


def banded_solve(factored, lower_bw, upper_bw, rhs):
    """Solve with the output of :func:`banded_factor`.

    ``rhs`` batches over leading axes; the system axis is last.
    """
    n = factored.shape[0]
    lb, ub = lower_bw, upper_bw
    fac = factored.detach().cpu().double().tolist()
    ys = []
    # forward substitution: y[i] = b[i] - sum_r mult[i, r] * y[i - r]
    for i in range(n):
        acc = rhs[..., i]
        for r in range(1, min(lb, i) + 1):
            acc = acc - fac[i][lb - r] * ys[i - r]
        ys.append(acc)
    # back substitution: x[i] = (y[i] - sum_c U[i, c] * x[i + c]) / U[i, 0]
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        acc = ys[i]
        for c in range(1, min(ub, n - 1 - i) + 1):
            acc = acc - fac[i][lb + c] * xs[i + c]
        xs[i] = acc / fac[i][lb]
    return torch.stack(xs, dim=-1)


def banded_shifted_solve(bands_np, lower_bw, upper_bw, rhs, factor):
    """Solve ``(I - factor * A) x = rhs`` where A is given in band storage
    (numpy constants); the factorization of the shift runs per call."""
    shifted = -float(factor) * np.asarray(bands_np, dtype=float)
    shifted[lower_bw] = shifted[lower_bw] + 1.0
    fac = banded_factor(torch.as_tensor(shifted), lower_bw, upper_bw)
    return banded_solve(fac, lower_bw, upper_bw, rhs)


# ----------------------------------------------------------------------
def _bmm(A, B):
    """Batched (r, b, b) @ (r, b, b)."""
    return torch.matmul(A, B)


def _bmv(A, x):
    """(r, b, b) applied to (..., r, b) — batch axes lead."""
    return torch.einsum('rij,...rj->...ri', A, x)


def block_cr_factor(sub, diag, sup):
    """Factor a block-tridiagonal system by cyclic reduction.

    sub/diag/sup: (nb, b, b) dense block diagonals (sub[0], sup[-1]
    ignored).  Each level eliminates the odd block rows with batched
    inverses and Schur updates, so the depth is O(log2 nb).  Returns a
    factor dict for :func:`block_cr_solve`.
    """
    nb = diag.shape[0]
    sub = sub.clone()
    sub[0] = 0.0
    sup = sup.clone()
    sup[-1] = 0.0
    levels = []
    while nb > 1:
        d_e, d_o = diag[0::2], diag[1::2]
        s_e, s_o = sub[0::2], sub[1::2]
        c_e, c_o = sup[0::2], sup[1::2]
        n_e, n_o = d_e.shape[0], d_o.shape[0]
        Ainv_o = torch.linalg.inv(d_o)
        # E[r] = sub[2r] @ Ainv(odd 2r-1); E[0] = 0 (row 0 has no left)
        E = torch.zeros_like(d_e)
        E[1:] = _bmm(s_e[1:], Ainv_o[: n_e - 1])
        # F[r] = sup[2r] @ Ainv(odd 2r+1); zero beyond the last odd row
        F = torch.zeros_like(d_e)
        F[:n_o] = _bmm(c_e[:n_o], Ainv_o)
        diag_n = d_e.clone()
        diag_n[1:] = diag_n[1:] - _bmm(E[1:], c_o[: n_e - 1])
        diag_n[:n_o] = diag_n[:n_o] - _bmm(F[:n_o], s_o)
        sub_n = torch.zeros_like(d_e)
        sub_n[1:] = -_bmm(E[1:], s_o[: n_e - 1])
        sup_n = torch.zeros_like(d_e)
        sup_n[:n_o] = -_bmm(F[:n_o], c_o)
        levels.append(dict(Ainv=Ainv_o, E=E, F=F, sub_o=s_o, sup_o=c_o))
        sub, diag, sup, nb = sub_n, diag_n, sup_n, n_e
    top_inv = torch.linalg.inv(diag[0])
    return dict(levels=levels, top_inv=top_inv)


def block_cr_solve(factors, rhs):
    """Substitute through a :func:`block_cr_factor` result.

    ``rhs``: (..., nb, b), batch axes leading.  Forward: per level, reduce
    the kept (even) rows' RHS with the stored E/F products.  Back: recover
    the eliminated (odd) rows from their stored inverses.
    """
    levels, top_inv = factors['levels'], factors['top_inv']
    stack = []
    r = rhs
    for lv in levels:
        r_e, r_o = r[..., 0::2, :], r[..., 1::2, :]
        n_e, n_o = r_e.shape[-2], r_o.shape[-2]
        zero_row = torch.zeros(r_o.shape[:-2] + (1, r_o.shape[-1]), dtype=r.dtype, device=r.device)
        # left odd neighbour of even row r is odd index r-1; right is r
        r_o_left = torch.cat([zero_row, r_o[..., : n_e - 1, :]], dim=-2)
        r_o_right = r_o if n_e == n_o else torch.cat([r_o, zero_row], dim=-2)
        stack.append(r_o)
        r = r_e - _bmv(lv['E'], r_o_left) - _bmv(lv['F'], r_o_right)
    x = _bmv(top_inv[None], r)
    for lv, r_o in zip(reversed(levels), reversed(stack)):
        n_o = r_o.shape[-2]
        x_e = x
        zero_row = torch.zeros(x.shape[:-2] + (1, x.shape[-1]), dtype=x.dtype, device=x.device)
        x_right = torch.cat([x_e[..., 1:, :], zero_row], dim=-2)[..., :n_o, :]
        x_o = _bmv(lv['Ainv'], r_o - _bmv(lv['sub_o'], x_e[..., :n_o, :]) - _bmv(lv['sup_o'], x_right))
        nb = x_e.shape[-2] + n_o
        out = torch.zeros(x.shape[:-2] + (nb, x.shape[-1]), dtype=x.dtype, device=x.device)
        out[..., 0::2, :] = x_e
        out[..., 1::2, :] = x_o
        x = out
    return x


def block_cr_shifted_factor(sub_np, diag_np, sup_np, factor, dtype=torch.float64, device='cuda'):
    """Factor ``I - factor*A`` for a block-tridiagonal A (numpy band
    constants), in ``dtype`` on ``device`` (the card unless ``'cpu'`` is asked for)."""
    device = resolve_device(device)
    sub = -factor * torch.as_tensor(sub_np, dtype=dtype, device=device)
    sup = -factor * torch.as_tensor(sup_np, dtype=dtype, device=device)
    diag = -factor * torch.as_tensor(diag_np, dtype=dtype, device=device)
    b = diag.shape[-1]
    diag = diag + torch.eye(b, dtype=dtype, device=device)[None]
    return block_cr_factor(sub, diag, sup)


def block_tridiag_solve(sub, diag, sup, rhs):
    """Block Thomas: solve a block-tridiagonal system with dense blocks.

    sub/diag/sup: (nb, b, b) block diagonals (sub[0], sup[-1] ignored);
    rhs: (..., nb*b).  Every step is a dense (b, b) solve and product.
    """
    nb, b, _ = diag.shape
    flat_shape = rhs.shape
    rhs_moved = torch.movedim(rhs.reshape(rhs.shape[:-1] + (nb, b)), -2, 0)  # (nb, ..., b)
    C_prev = torch.zeros((b, b), dtype=diag.dtype, device=diag.device)
    d_prev = torch.zeros_like(rhs_moved[0])
    sub0 = sub.clone()
    sub0[0] = 0.0
    Cs, ds = [], []
    for i in range(nb):
        denom = diag[i] - sub0[i] @ C_prev
        C_prev = torch.linalg.solve(denom, sup[i])
        rhs_row = rhs_moved[i] - torch.einsum('ij,...j->...i', sub0[i], d_prev)
        d_prev = torch.linalg.solve(denom, rhs_row[..., None])[..., 0]
        Cs.append(C_prev)
        ds.append(d_prev)
    x_next = torch.zeros_like(rhs_moved[0])
    xs = [None] * nb
    for i in range(nb - 1, -1, -1):
        x_next = ds[i] - torch.einsum('ij,...j->...i', Cs[i], x_next)
        xs[i] = x_next
    return torch.movedim(torch.stack(xs), 0, -2).reshape(flat_shape)


def block_tridiag_from_csr(A, block):
    """Split a CSR matrix with block-tridiagonal structure into dense numpy
    (sub, diag, sup) block bands; raises if entries fall outside them."""
    n = A.shape[0]
    if n % block:
        raise ProblemError(f'block size {block} must divide n={n}')
    nb = n // block
    dense_rows, cols, vals = A.row_of(), A.indices.astype(np.int64), A.data
    br, bc = dense_rows // block, cols // block
    off = bc - br
    if np.any(np.abs(off) > 1):
        raise ProblemError('matrix is not block-tridiagonal at this block size')
    sub = np.zeros((nb, block, block))
    diag = np.zeros((nb, block, block))
    sup = np.zeros((nb, block, block))
    tgt = {-1: sub, 0: diag, 1: sup}
    for o in (-1, 0, 1):
        m = off == o
        tgt[o][br[m], dense_rows[m] % block, cols[m] % block] = vals[m]
    return sub, diag, sup


def block_tridiag_shifted_solve(sub_np, diag_np, sup_np, rhs, factor):
    """Solve ``(I - factor*A) x = rhs`` for a block-tridiagonal A."""
    sub = -factor * torch.as_tensor(sub_np, dtype=rhs.dtype, device=rhs.device)
    sup = -factor * torch.as_tensor(sup_np, dtype=rhs.dtype, device=rhs.device)
    diag = -factor * torch.as_tensor(diag_np, dtype=rhs.dtype, device=rhs.device)
    b = diag.shape[-1]
    diag = diag + torch.eye(b, dtype=rhs.dtype, device=rhs.device)[None]
    return block_tridiag_solve(sub, diag, sup, rhs)
