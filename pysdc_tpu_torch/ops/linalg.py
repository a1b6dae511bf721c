"""Batched dense solves and inverses that a CUDA graph can hold, inside a device ``while`` loop too.

``torch.linalg.solve_ex`` and ``inv_ex`` check nothing on the host, but which
library computes them is torch's choice, by shape, and not every choice can be
captured.  On an NVIDIA H100 with torch 2.11 and CUDA 12.9:

- by default a batch of more than a few matrices goes to MAGMA's batched LU,
  whose queue synchronizes: a capture that reaches it fails;
- asked for cuSOLVER, torch factors a batch of two or more matrices of fewer
  than 512 rows by cuBLAS's batched LU (``getrf_panel``, ``getrf_2x2``, ...)
  and substitutes a batch of three or more systems by cuBLAS's batched
  ``getrs``: both capture, in the body of a conditional WHILE node too;
- it sends one matrix, or any of 512 rows or more, to cuSOLVER's ``getrf``
  one at a time, and one or two systems of 64 rows or more to cuSOLVER's
  ``getrs``: those capture in a plain graph but not in a conditional node's
  body (``cudaErrorInvalidValue`` when the graph is made).

So on a CUDA tensor :func:`solve` and :func:`inv` ask torch for cuSOLVER for
their calls, pad a batch of one matrix with an identity and a batch of fewer
than three systems with copies (padding whose results are dropped), and solve
a matrix of 512 rows or more by block elimination over its halves
(:func:`_blocked_solve`: the halves' solves and products, the Schur complement
factored the same way), with partial pivoting inside each block of fewer than
512 rows.  Eager and captured take the same path, so the stage lane and the
fused lanes compute alike.  torch's library preference is a process-wide
setting: it is set for the call and restored after it.  On a CPU tensor
:func:`solve` is ``torch.linalg.solve_ex``.  ``chip_smoke.py`` phase 69 holds
the routes taken here inside a device ``while`` body, bit for bit against the
eager call, and ``tests/test_torch_linalg.py`` holds them against LAPACK.
"""

from __future__ import annotations

import contextlib

import torch

#: from this many rows torch factors one matrix at a time with cuSOLVER, which a conditional node's body does not hold
BLOCKED_FROM = 512


@contextlib.contextmanager
def _cusolver(x: torch.Tensor):
    """torch asked for cuSOLVER while ``x`` is on the card (nothing changes for a CPU tensor)."""
    if not x.is_cuda:
        yield
        return
    before = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library('cusolver')
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(before)


def _padded(x: torch.Tensor, count: int, fill: torch.Tensor) -> torch.Tensor:
    """``x`` (N, ...) with copies of ``fill`` (...) appended up to ``count`` entries."""
    extra = count - x.shape[0]
    return x if extra <= 0 else torch.cat([x, fill.expand((extra,) + tuple(fill.shape)).to(x.dtype)])


def _batched_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A^-1 B`` for fewer than :data:`BLOCKED_FROM` rows by cuBLAS's batched LU and substitution."""
    n, k = A.shape[-1], B.shape[-1]
    lead = tuple(A.shape[:-2])
    batch = torch.broadcast_shapes(lead, B.shape[:-2])
    flat = A.reshape((-1, n, n))
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    with _cusolver(A):
        LU, pivots, _ = torch.linalg.lu_factor_ex(_padded(flat, 2, eye))
        LU, pivots = LU[:flat.shape[0]].reshape(lead + (n, n)), pivots[:flat.shape[0]].reshape(lead + (n,))
        systems = int(torch.Size(batch).numel())
        if systems >= 3:
            return torch.linalg.lu_solve(LU, pivots, B)
        LU = LU.expand(batch + (n, n)).reshape((-1, n, n))
        pivots = pivots.expand(batch + (n,)).reshape((-1, n))
        rhs = B.expand(batch + (n, k)).reshape((-1, n, k))
        x = torch.linalg.lu_solve(_padded(LU, 3, eye), _padded(pivots, 3, pivots[0]), _padded(rhs, 3, rhs[0]))
    return x[:systems].reshape(batch + (n, k))


def _blocked_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A^-1 B`` by block elimination over the halves of ``A``: ``A11 [Y | y] = [A12 | B1]``, the Schur complement
    ``S = A22 - A21 Y`` solves ``S x2 = B2 - A21 y``, and ``x1 = y - Y x2``.  Each half's solve recurses until it
    has fewer than :data:`BLOCKED_FROM` rows; it pivots inside those blocks, not across them, which suits the
    diagonally dominant and well-conditioned systems of the port (the implicit stages of a linearized sweep, the
    tensor-product spectral operators)."""
    n = A.shape[-1]
    batch = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    A, B = A.expand(batch + A.shape[-2:]), B.expand(batch + B.shape[-2:])
    h = n // 2
    A11, A12, A21, A22 = A[..., :h, :h], A[..., :h, h:], A[..., h:, :h], A[..., h:, h:]
    Yy = _solve(A11, torch.cat([A12, B[..., :h, :]], dim=-1))
    Y, y = Yy[..., :n - h], Yy[..., n - h:]
    x2 = _solve(A22 - A21 @ Y, B[..., h:, :] - A21 @ y)
    return torch.cat([y - Y @ x2, x2], dim=-2)


def _solve(A, B):
    return _blocked_solve(A, B) if A.shape[-1] >= BLOCKED_FROM else _batched_solve(A, B)


def solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A^-1 B``, ``A (..., n, n)``, ``B (..., n, k)``, the batch axes broadcast; no error check on the host."""
    if not A.is_cuda:
        return torch.linalg.solve_ex(A, B)[0]
    return _solve(A, B)


def inv(A: torch.Tensor) -> torch.Tensor:
    """``A^-1`` over the leading batch axes; no error check on the host."""
    if not A.is_cuda:
        return torch.linalg.inv_ex(A)[0]
    n = A.shape[-1]
    return _solve(A, torch.eye(n, dtype=A.dtype, device=A.device).expand(tuple(A.shape[:-2]) + (n, n)))
