"""Batched dense solves and inverses that a CUDA graph can hold, inside a device ``while`` loop too.

The JAX package's dense solves are ``jnp.linalg.solve``: LU with partial
pivoting.  ``torch.linalg.solve_ex`` and ``inv_ex`` check nothing on the host,
but which library computes them is torch's choice, by shape, and not every
choice can be captured.  On an NVIDIA H100 with torch 2.11 and CUDA 12.9:

- by default a batch of more than a few matrices goes to MAGMA's batched LU,
  whose queue synchronizes: a capture that reaches it fails;
- asked for cuSOLVER, torch factors a batch of two or more matrices of fewer
  than 512 rows by cuBLAS's batched LU (``getrf_panel``, ``getrf_2x2``, ...)
  and substitutes a batch of three or more systems by cuBLAS's batched
  ``getrs``: both capture, in the body of a conditional WHILE node too;
- it sends one matrix, any of 512 rows or more, or a tall one, to cuSOLVER's
  ``getrf`` one at a time, and one or two systems of 64 rows or more to
  cuSOLVER's ``getrs``: those capture in a plain graph but not in a
  conditional node's body (``cudaErrorInvalidValue`` when the graph is made).

So on a CUDA tensor :func:`solve` and :func:`inv` take two routes:

- fewer than :data:`PIVOTED_FROM` rows (:func:`_batched_solve`): torch asked
  for cuSOLVER for the call, a batch of one matrix padded with an identity
  and a batch of fewer than three systems with copies (padding whose results
  are dropped).  torch's library preference is a process-wide setting: it is
  set for the call and restored after it;
- from :data:`PIVOTED_FROM` rows on (:func:`_pivoted_solve`): LAPACK's blocked
  right-looking ``getrf``, its loop unrolled here, with the pivots LAPACK
  chooses over the whole matrix.  Each block of :data:`BLOCK` columns takes
  two hand-written kernels and one GEMM:
  :func:`~pysdc_tpu_torch.ops.kernels.dense_lu.lu_panel` factors the block's
  columns down the whole remaining height in one launch,
  :func:`~pysdc_tpu_torch.ops.kernels.dense_lu.lu_swap_trsm` moves the rows its
  pivots moved in every other column and solves for ``U12``, and a batched
  GEMM with TF32 off updates the trailing matrix.  The substitution is the
  permutation's gather and triangular solves by blocks of :data:`BLOCK` rows.
  Nothing is read on the host.

Each route is two halves, :func:`lu_factor` (``A`` to its factors) and
:func:`lu_substitute` (the factors and ``B`` to ``x``), and :func:`solve` is
the one after the other: the same kernels, launches and bits as a solve that
never kept its factors.  This module keeps nothing between calls; a caller
that solves with one matrix again and again keeps the factors itself
(``ops/spectral.py``: one LU a collocation node, refreshed on the device only
when its shift changes, as the reference's ``GenericSpectralLinear`` keeps its
factorizations keyed by ``dt``, ``cached_direct``).

Eager and captured take the same path, so the stage lane and the fused lanes
compute alike.  On a CPU tensor :func:`solve` and :func:`inv` are LAPACK
(``solve_ex``, ``inv_ex``) and the halves ``lu_factor_ex`` and ``lu_solve``,
which compute what ``solve_ex`` computes; :func:`_pivoted_solve` on a CPU
tensor runs the same blocked loop with the kernels' plain versions (LAPACK's
``getrf`` of each panel, a gather and ``solve_triangular``), which
``tests/test_torch_linalg.py`` holds against LAPACK on matrices that need
pivoting (patching :func:`_lapack` sends every call on the CPU down the card's
routes).  ``chip_smoke.py`` holds both routes inside a device ``while`` body,
bit for bit against the eager call, and against LAPACK.
"""

from __future__ import annotations

import contextlib
import math

import torch

from pysdc_tpu_torch.ops.kernels.dense_lu import lu_panel, lu_swap_trsm
from pysdc_tpu_torch.utils import trace

#: from this many rows a solve on the card takes the pivoted blocked LU: torch would factor such a matrix with
#: cuSOLVER's ``getrf``, which a conditional node's body does not hold
PIVOTED_FROM = 512
#: the LU's block of columns (one panel launch, the trailing update's depth) and the substitution's block of rows
BLOCK = 64


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


@contextlib.contextmanager
def _full_precision():
    """Products in full float32 (no TF32) for the call; restored after it."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _padded(x: torch.Tensor, count: int, fill: torch.Tensor) -> torch.Tensor:
    """``x`` (N, ...) with copies of ``fill`` (...) appended up to ``count`` entries."""
    extra = count - x.shape[0]
    return x if extra <= 0 else torch.cat([x, fill.expand((extra,) + tuple(fill.shape)).to(x.dtype)])


def _lapack(x: torch.Tensor) -> bool:
    """True where the calls of this module are torch's own LAPACK calls: a tensor on the CPU.  The CPU tests patch
    it to run the card's routes there, with the kernels' plain versions."""
    return not x.is_cuda


def _batched_factor(A: torch.Tensor) -> tuple:
    """``(LU, pivots)`` of ``A`` for fewer than :data:`PIVOTED_FROM` rows by cuBLAS's batched LU (one matrix padded
    with an identity)."""
    n = A.shape[-1]
    lead = tuple(A.shape[:-2])
    flat = A.reshape((-1, n, n))
    with _cusolver(A):
        LU, pivots, _ = torch.linalg.lu_factor_ex(_padded(flat, 2, torch.eye(n, dtype=A.dtype, device=A.device)))
    return LU[:flat.shape[0]].reshape(lead + (n, n)), pivots[:flat.shape[0]].reshape(lead + (n,))


def _batched_substitute(LU: torch.Tensor, pivots: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``x`` from :func:`_batched_factor`'s factors by cuBLAS's batched substitution (fewer than three systems
    padded with copies)."""
    n, k = LU.shape[-1], B.shape[-1]
    batch = torch.broadcast_shapes(tuple(LU.shape[:-2]), B.shape[:-2])
    systems = int(torch.Size(batch).numel())
    with _cusolver(LU):
        if systems >= 3:
            return torch.linalg.lu_solve(LU, pivots, B)
        eye = torch.eye(n, dtype=LU.dtype, device=LU.device)
        LU = LU.expand(batch + (n, n)).reshape((-1, n, n))
        pivots = pivots.expand(batch + (n,)).reshape((-1, n))
        rhs = B.expand(batch + (n, k)).reshape((-1, n, k))
        x = torch.linalg.lu_solve(_padded(LU, 3, eye), _padded(pivots, 3, pivots[0]), _padded(rhs, 3, rhs[0]))
    return x[:systems].reshape(batch + (n, k))


def _batched_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A^-1 B`` for fewer than :data:`PIVOTED_FROM` rows by cuBLAS's batched LU and substitution."""
    return _batched_substitute(*_batched_factor(A), B)


def _getrf(A: torch.Tensor) -> torch.Tensor:
    """Factor ``A`` (a ``(batch, m, w)`` view, ``m >= w``) in place as ``P A = L U`` with partial pivoting, LAPACK's
    blocked right-looking ``getrf`` by blocks of :data:`BLOCK` columns: each block's panel by :func:`lu_panel`, its
    row interchanges and ``U12`` by :func:`lu_swap_trsm`, the trailing matrix by a batched GEMM.  Returns the
    permutation ``(batch, m)``: row r of the factored matrix is row ``perm[r]`` of the matrix given."""
    b, m, w = A.shape
    perm = torch.arange(m, device=A.device).expand(b, m).clone()
    for j in range(0, w, BLOCK):
        jb = min(BLOCK, w - j)
        rows = lu_panel(A[:, j:, j:j + jb])
        perm[:, j:] = perm[:, j:].gather(1, rows)
        lu_swap_trsm(A, j, jb, rows)
        if j + jb < w:
            A[:, j + jb:, j + jb:].baddbmm_(A[:, j + jb:, j:j + jb], A[:, j:j + jb, j + jb:], alpha=-1)
    return perm


def _substitute(LU: torch.Tensor, perm: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``x`` of ``L U x = B[perm]`` by blocks of :data:`BLOCK` rows: ``LU (b, n, n)``, ``perm (b, n)``, ``B (b, n, k)``."""
    n, k = LU.shape[-1], B.shape[-1]
    x = B.gather(1, perm.unsqueeze(-1).expand(perm.shape + (k,)))
    starts = list(range(0, n, BLOCK))
    for j in starts:
        jb = min(BLOCK, n - j)
        if j:
            x[:, j:j + jb].baddbmm_(LU[:, j:j + jb, :j], x[:, :j], alpha=-1)
        x[:, j:j + jb] = torch.linalg.solve_triangular(LU[:, j:j + jb, j:j + jb], x[:, j:j + jb], upper=False,
                                                       unitriangular=True)
    for j in reversed(starts):
        jb = min(BLOCK, n - j)
        if j + jb < n:
            x[:, j:j + jb].baddbmm_(LU[:, j:j + jb, j + jb:], x[:, j + jb:], alpha=-1)
        x[:, j:j + jb] = torch.linalg.solve_triangular(LU[:, j:j + jb, j:j + jb], x[:, j:j + jb], upper=True)
    return x


def _pivoted_factor(A: torch.Tensor, overwrite_a: bool = False) -> tuple:
    """``(LU, perm)`` of ``A`` by the blocked LU with partial pivoting over the whole matrix (:func:`_getrf`), for
    :data:`PIVOTED_FROM` rows and more on the card: ``LU`` shaped as ``A`` (``A`` itself, factored in place, where
    ``overwrite_a`` and ``A`` is contiguous), ``perm`` as ``A`` less its last axis."""
    n = A.shape[-1]
    lead = tuple(A.shape[:-2])
    LU = A.reshape((-1, n, n))
    if not (overwrite_a and A.is_contiguous()):
        LU = LU.clone(memory_format=torch.contiguous_format)
    with _full_precision():
        perm = _getrf(LU)
    return LU.reshape(lead + (n, n)), perm.reshape(lead + (n,))


def _pivoted_substitute(LU: torch.Tensor, perm: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``x`` from :func:`_pivoted_factor`'s factors (:func:`_substitute`).  Each matrix was factored once; the batch
    axes over which the factors are broadcast ride along as columns of the right-hand side."""
    n, k = LU.shape[-1], B.shape[-1]
    batch = torch.broadcast_shapes(tuple(LU.shape[:-2]), B.shape[:-2])
    lead = (1,) * (len(batch) - (LU.dim() - 2)) + tuple(LU.shape[:-2])
    moved = [i for i, (a, s) in enumerate(zip(lead, batch)) if a == 1 and s > 1]
    kept = [i for i in range(len(batch)) if i not in moved]
    kept_shape = tuple(batch[i] for i in kept)
    moved_shape = tuple(batch[i] for i in moved)
    order = kept + [len(batch)] + moved + [len(batch) + 1]
    rhs = B.expand(batch + (n, k)).permute(order).reshape((-1, n, math.prod(moved_shape) * k))
    with _full_precision():
        x = _substitute(LU.reshape((-1, n, n)), perm.reshape((-1, n)), rhs)
    x = x.reshape(kept_shape + (n,) + moved_shape + (k,))
    inverse = [order.index(i) for i in range(len(order))]
    return x.permute(inverse)


def _pivoted_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A^-1 B`` by the blocked LU with partial pivoting over the whole matrix, for :data:`PIVOTED_FROM` rows and
    more on the card."""
    return _pivoted_substitute(*_pivoted_factor(A), B)


def lu_factor(A: torch.Tensor, overwrite_a: bool = False) -> tuple:
    """``(LU, pivots)`` of ``A (..., n, n)``: the first half of :func:`solve`, on its route (LAPACK's
    ``lu_factor_ex`` on the CPU, cuBLAS's batched LU below :data:`PIVOTED_FROM` rows on the card, the pivoted
    blocked LU from there on).  ``overwrite_a`` lets the pivoted route factor a contiguous ``A`` in place.  The
    factors are for :func:`lu_substitute` only: what ``pivots`` holds differs between the routes."""
    if _lapack(A):
        LU, pivots, _ = torch.linalg.lu_factor_ex(A)
        return LU, pivots
    if A.shape[-1] >= PIVOTED_FROM:
        return _pivoted_factor(A, overwrite_a)
    return _batched_factor(A)


def lu_substitute(LU: torch.Tensor, pivots: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A^-1 B`` from :func:`lu_factor`'s factors of ``A``, the batch axes broadcast: the second half of
    :func:`solve`."""
    if _lapack(LU):
        return torch.linalg.lu_solve(LU, pivots, B)
    if LU.shape[-1] >= PIVOTED_FROM:
        return _pivoted_substitute(LU, pivots, B)
    return _batched_substitute(LU, pivots, B)


def _solve(A, B):
    """The card's route for ``A``'s rows, on any device."""
    return _pivoted_solve(A, B) if A.shape[-1] >= PIVOTED_FROM else _batched_solve(A, B)


def solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A^-1 B``, ``A (..., n, n)``, ``B (..., n, k)``, the batch axes broadcast; no error check on the host.  A
    device span ``linalg.solve`` while tracing is on (``utils/trace.py``)."""
    with trace.device_span('linalg.solve'):
        if _lapack(A):
            return torch.linalg.solve_ex(A, B)[0]
        return lu_substitute(*lu_factor(A), B)


def inv(A: torch.Tensor) -> torch.Tensor:
    """``A^-1`` over the leading batch axes; no error check on the host."""
    if _lapack(A):
        return torch.linalg.inv_ex(A)[0]
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(tuple(A.shape[:-2]) + (n, n))
    return lu_substitute(*lu_factor(A), eye)
