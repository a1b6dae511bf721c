"""Sparse linear algebra: host CSR assembly and the device formats.

The counterpart of ``pysdc_tpu/ops/sparse.py``.  The *assembly* algebra
(COO/CSR, add, scale, transpose, SpGEMM, Kronecker products, Galerkin RAP)
is a copy of the JAX package's vectorized numpy code: it runs on the host at
setup time and is independent of the array framework.  The *execution*
formats hold tensors on a device:

  - :class:`ELL` — padded fixed-width rows; SpMV is one gather and a
    multiply-reduce, for any sparsity pattern.
  - :class:`DIA` — the diagonals of an FD matrix; SpMV is a sum of shifted
    products.  On a CUDA tensor it runs as kernel K2
    (:func:`pysdc_tpu_torch.ops.kernels.dia.dia_spmv`); ``DIA.spmv`` is the
    plain version.
  - :class:`BSR` — block rows of dense ``(br, bc)`` blocks with contiguous
    column segments.  On a CUDA tensor the block product runs as kernel K3
    (:func:`pysdc_tpu_torch.ops.kernels.bsr.bsr_spmm`); ``BSR.spmv`` is the
    plain version.

Each format keeps its values as one float64 master tensor on the device it
was made for, and a copy per (dtype, device) of the fields it meets, made
once and kept, so a float32 state stays float32.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.device import resolve_device
from pysdc_tpu_torch.core.errors import ProblemError


# ======================================================================
# Host-side CSR container (setup-time algebra, pure numpy)
# ======================================================================
class CSR:
    """Compressed-sparse-row matrix with explicit, vectorized-numpy kernels.

    All entries are kept sorted by (row, col) with no duplicates and no
    explicit zeros unless requested.
    """

    __slots__ = ('data', 'indices', 'indptr', 'shape')

    def __init__(self, data, indices, indptr, shape):
        self.data = np.asarray(data, dtype=float)
        self.indices = np.asarray(indices, dtype=np.int32)
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.shape = tuple(shape)

    # -- constructors ---------------------------------------------------
    @classmethod
    def from_coo(cls, rows, cols, vals, shape, sum_duplicates=True):
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=float)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if sum_duplicates and len(rows):
            key_new = np.empty(len(rows), dtype=bool)
            key_new[0] = True
            key_new[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
            group = np.cumsum(key_new) - 1
            vals = np.bincount(group, weights=vals, minlength=group[-1] + 1)
            rows, cols = rows[key_new], cols[key_new]
        indptr = np.zeros(shape[0] + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)
        return cls(vals, cols, indptr, shape)

    @classmethod
    def from_dense(cls, A, tol=0.0):
        A = np.asarray(A, dtype=float)
        rows, cols = np.nonzero(np.abs(A) > tol)
        return cls.from_coo(rows, cols, A[rows, cols], A.shape)

    @classmethod
    def eye(cls, n, value=1.0):
        idx = np.arange(n)
        return cls(np.full(n, value), idx, np.arange(n + 1), (n, n))

    @classmethod
    def diags(cls, diagonals, offsets, shape):
        """Banded assembly from (diagonal values, offsets) pairs."""
        rows, cols, vals = [], [], []
        n, m = shape
        for diag, off in zip(diagonals, offsets):
            r0, c0 = (0, off) if off >= 0 else (-off, 0)
            length = min(n - r0, m - c0)
            if length <= 0:
                continue
            diag = np.asarray(diag, dtype=float)
            diag = diag[:length] if diag.ndim == 1 and diag.size > length else np.broadcast_to(diag, (length,))
            rows.append(np.arange(r0, r0 + length))
            cols.append(np.arange(c0, c0 + length))
            vals.append(diag)
        return cls.from_coo(np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), shape)

    # -- basic algebra ----------------------------------------------------
    @property
    def nnz(self):
        return len(self.data)

    @property
    def row_lengths(self):
        return np.diff(self.indptr)

    def row_of(self):
        """Expanded row index per stored entry."""
        return np.repeat(np.arange(self.shape[0], dtype=np.int64), self.row_lengths)

    def to_dense(self):
        out = np.zeros(self.shape)
        out[self.row_of(), self.indices] = self.data
        return out

    def diagonal(self):
        rows = self.row_of()
        mask = rows == self.indices
        out = np.zeros(min(self.shape))
        out[rows[mask]] = self.data[mask]
        return out

    def scale(self, alpha):
        return CSR(self.data * alpha, self.indices, self.indptr, self.shape)

    def __add__(self, other):
        if not isinstance(other, CSR) or self.shape != other.shape:
            raise ProblemError('CSR addition needs two equal-shape CSR matrices')
        rows = np.concatenate([self.row_of(), other.row_of()])
        cols = np.concatenate([self.indices, other.indices])
        vals = np.concatenate([self.data, other.data])
        return CSR.from_coo(rows, cols, vals, self.shape)

    def transpose(self):
        return CSR.from_coo(self.indices, self.row_of(), self.data, self.shape[::-1])

    @property
    def T(self):
        return self.transpose()

    def prune(self, tol=0.0):
        keep = np.abs(self.data) > tol
        return CSR.from_coo(self.row_of()[keep], self.indices[keep], self.data[keep], self.shape)

    # -- SpMV (host, for tests/reference) --------------------------------
    def dot_vec(self, x):
        x = np.asarray(x)
        return np.bincount(self.row_of(), weights=self.data * x[self.indices], minlength=self.shape[0])

    # -- SpGEMM -----------------------------------------------------------
    def matmul(self, other: 'CSR') -> 'CSR':
        """C = self @ other by row-expansion: every stored a_ik contributes
        a_ik * B[k, :]; contributions are merged coordinate-wise."""
        if self.shape[1] != other.shape[0]:
            raise ProblemError(f'SpGEMM shape mismatch: {self.shape} @ {other.shape}')
        k = self.indices.astype(np.int64)
        counts = other.row_lengths[k]
        if counts.sum() == 0:
            return CSR.from_coo([], [], [], (self.shape[0], other.shape[1]))
        out_rows = np.repeat(self.row_of(), counts)
        out_vals = np.repeat(self.data, counts)
        seg_starts = other.indptr[k]
        total = counts.sum()
        within = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
        pos = np.repeat(seg_starts, counts) + within
        out_cols = other.indices[pos].astype(np.int64)
        out_vals = out_vals * other.data[pos]
        return CSR.from_coo(out_rows, out_cols, out_vals, (self.shape[0], other.shape[1]))

    def __matmul__(self, other):
        return self.matmul(other)

    def kron(self, other: 'CSR') -> 'CSR':
        """Kronecker product — the assembly primitive for tensor-product ND
        operators (reference uses scipy.sparse.kron in problem_helper.py)."""
        ra, ca = self.row_of(), self.indices.astype(np.int64)
        rb, cb = other.row_of(), other.indices.astype(np.int64)
        na, ma = self.shape
        nb, mb = other.shape
        rows = (ra[:, None] * nb + rb[None, :]).ravel()
        cols = (ca[:, None] * mb + cb[None, :]).ravel()
        vals = (self.data[:, None] * other.data[None, :]).ravel()
        return CSR.from_coo(rows, cols, vals, (na * nb, ma * mb))

    # -- bandwidth info (feeds the banded factorization) ------------------
    def bandwidths(self):
        offs = self.indices.astype(np.int64) - self.row_of()
        if len(offs) == 0:
            return 0, 0
        return int(-offs.min()), int(offs.max())

    def to_banded(self):
        """Band storage: ``bands[j, i] = A[i, i + offsets[j]]`` with
        ``offsets = -lower..upper`` (rows padded with zeros out of range)."""
        lower, upper = self.bandwidths()
        n = self.shape[0]
        offsets = np.arange(-lower, upper + 1)
        bands = np.zeros((len(offsets), n))
        rows = self.row_of()
        offs = self.indices.astype(np.int64) - rows
        bands[offs + lower, rows] = self.data
        return bands, offsets

    def __repr__(self):
        return f'CSR(shape={self.shape}, nnz={self.nnz})'


def galerkin_product(P: CSR, A: CSR, R: CSR | None = None) -> CSR:
    """Coarse operator via the Galerkin triple product ``R A P`` (RAP);
    ``R`` defaults to ``P^T`` (variational coarsening)."""
    R = P.T if R is None else R
    return R.matmul(A).matmul(P).prune(1e-14)


# ======================================================================
# Device formats
# ======================================================================
def _master(x, dtype, device) -> torch.Tensor:
    """``x`` (numpy array, sequence or tensor) as a tensor of ``dtype`` on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=device)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


class _DeviceFormat:
    """Float64 master tensors on one device, cast once per (dtype, device).

    The containers live on the card unless the caller asks for the CPU
    (``device='cpu'``); without a card the default raises."""

    def _init_casts(self):
        self._casts: dict = {}
        #: per (dtype, device): what a kernel launch needs (kernels/dia.py, kernels/bsr.py)
        self._kernel_plans: dict = {}

    def _cast(self, name: str, like: torch.Tensor, dtype=None) -> torch.Tensor:
        """Tensor ``name`` in ``dtype`` (default: ``like``'s) on ``like``'s
        device, made once and kept."""
        dtype = like.dtype if dtype is None else dtype
        key = (name, dtype, like.device)
        t = self._casts.get(key)
        if t is None:
            t = self._casts[key] = getattr(self, name).to(dtype=dtype, device=like.device).contiguous()
        return t


class ELL(_DeviceFormat):
    """Padded fixed-width sparse rows.

    ``vals (n, k)`` and ``cols (n, k)`` with padding entries carrying value 0
    and an in-range column, so no masking is needed.  SpMV is
    ``(vals * u[..., cols]).sum(-1)``; leading axes of ``u`` batch.
    """

    def __init__(self, vals, cols, shape, nnz=None, device='cuda'):
        device = resolve_device(device)
        self.vals = _master(vals, torch.float64, device)
        self.cols = _master(cols, torch.int64, device)
        self.shape = tuple(shape)
        self.nnz = nnz if nnz is not None else int(self.vals.numel())
        self._init_casts()

    @classmethod
    def from_csr(cls, A: CSR, device='cuda'):
        n = A.shape[0]
        k = int(A.row_lengths.max()) if A.nnz else 1
        vals = np.zeros((n, k))
        cols = np.zeros((n, k), dtype=np.int64)
        lengths = A.row_lengths
        within = np.arange(A.nnz) - np.repeat(A.indptr[:-1], lengths)
        rows = A.row_of()
        vals[rows, within] = A.data
        cols[rows, within] = A.indices
        return cls(vals, cols, A.shape, nnz=A.nnz, device=device)

    def spmv(self, u):
        """y = A @ u over the trailing axis of u (leading axes batch)."""
        gathered = u[..., self._cast('cols', u, torch.int64)]                              # (..., n, k)
        return torch.sum(self._cast('vals', u) * gathered, dim=-1)


class DIA(_DeviceFormat):
    """Diagonal sparse storage — the format for FD matrices.

    ``offsets`` host ints and ``data (k, n)`` with
    ``data[j, i] = A[i, i + offsets[j]]`` (zero where the entry does not
    exist).  SpMV is ``sum_j data[j] * roll(u, -offsets[j])``.  The mod-n
    roll semantics are exact for every matrix: out-of-range positions have
    zero coefficients by construction, and periodic wrap-around entries live
    on their own +-(n-m) diagonals where the roll lands them correctly.
    Kernel K2 reads ``u[i + o]`` only inside [0, n) and gives the same
    result for the same reason.
    """

    def __init__(self, data, offsets, shape, nnz=None, grid=None, device='cuda'):
        device = resolve_device(device)
        self.data = _master(data, torch.float64, device)  # (k, n)
        self.offsets = tuple(int(o) for o in offsets)
        self.shape = tuple(shape)
        self.nnz = nnz if nnz is not None else int(self.data.numel())
        #: ((nr, nc), ((dr, dc), ...)) when the 2D-grid roll path is valid
        self.grid = grid
        self._init_casts()

    @classmethod
    def from_csr(cls, A: CSR, max_diags: int = 24, device='cuda'):
        """Convert when the matrix lives on at most ``max_diags`` diagonals
        (FD stencils do); returns None otherwise."""
        n = A.shape[0]
        rows = A.row_of()
        offs = A.indices.astype(np.int64) - rows
        uniq = np.unique(offs)
        if uniq.size > max_diags:
            return None
        data = np.zeros((uniq.size, n))
        for j, o in enumerate(uniq):
            m = offs == o
            data[j, rows[m]] = A.data[m]
        return cls(data, uniq, A.shape, nnz=A.nnz, device=device)

    def data_for(self, u: torch.Tensor) -> torch.Tensor:
        """The diagonals in ``u``'s dtype on ``u``'s device (made once, kept)."""
        return self._cast('data', u)

    def with_grid(self, grid_shape):
        """Validate and enable the 2D-grid roll form of the plain SpMV.

        On a 2D grid the diagonals decompose into (row, col) shifts
        ``k = dr*nc + dc`` of the (nr, nc) view.  The circular 2D roll reads
        a different element than the flat shift exactly where a shift
        crosses a grid-row (or top/bottom) boundary; the matrix rows there
        must carry zero coefficients.  Checked entry by entry here; returns
        self unchanged if any diagonal fails.
        """
        if len(grid_shape) != 2:
            return self
        nr, nc = int(grid_shape[0]), int(grid_shape[1])
        n = self.shape[0]
        if nr * nc != n:
            return self
        data_h = self.data.cpu().numpy()
        i = np.arange(n)
        r, c = i // nc, i % nc
        decomp = []
        for j, k in enumerate(self.offsets):
            dr = int(np.round(k / nc))
            dc = k - dr * nc
            if abs(dc) >= nc or abs(dr) > nr:
                return self
            flat_idx = (i + k) % n
            grid_idx = ((r + dr) % nr) * nc + (c + dc) % nc
            differs = flat_idx != grid_idx
            if np.any(data_h[j][differs] != 0.0):
                return self
            decomp.append((dr, dc))
        return DIA(self.data, self.offsets, self.shape, nnz=self.nnz, grid=((nr, nc), tuple(decomp)),
                   device=self.data.device)

    def spmv(self, u):
        """Plain version: y = A @ u over the trailing axis (leading axes
        batch), as a sum of rolls of the flat vector or of the 2D grid view."""
        data = self.data_for(u)
        if self.grid is not None:
            (nr, nc), decomp = self.grid
            x2 = u.reshape(u.shape[:-1] + (nr, nc))
            out = None
            for j, (dr, dc) in enumerate(decomp):
                d = data[j].reshape(nr, nc)
                v = x2
                if dr != 0:
                    v = torch.roll(v, -dr, dims=-2)
                if dc != 0:
                    v = torch.roll(v, -dc, dims=-1)
                term = d * v
                out = term if out is None else out + term
            return out.reshape(u.shape)
        out = None
        for j, o in enumerate(self.offsets):
            term = data[j] * (u if o == 0 else torch.roll(u, -o, dims=-1))
            out = term if out is None else out + term
        return out


class BSR(_DeviceFormat):
    """Block-sparse rows of dense blocks with *contiguous* column segments.

    Per block-row ``i`` there are up to ``kb`` dense ``(br, bc)`` blocks; the
    j-th block multiplies ``u[seg[i, j] : seg[i, j] + bc]`` (``seg`` holds
    element offsets, multiples of ``bc``).  Padding blocks are all-zero with
    segment start 0.
    """

    def __init__(self, blocks, seg_starts, shape, br, bc, nnz=None, device='cuda'):
        device = resolve_device(device)
        self.blocks = _master(blocks, torch.float64, device)  # (nb, kb, br, bc)
        self.seg_starts = _master(seg_starts, torch.int32, device)  # (nb, kb)
        self.shape = tuple(shape)
        self.br = int(br)
        self.bc = int(bc)
        self.nnz = nnz if nnz is not None else int(self.blocks.numel())
        # kernel K3 reads each segment without bounds checks: check them once here
        if self.seg_starts.numel() and (int(self.seg_starts.min()) < 0
                                        or int(self.seg_starts.max()) + self.bc > self.shape[1]):
            raise ProblemError(f'BSR column segments of width {self.bc} leave the {self.shape[1]} columns')
        self._init_casts()

    @classmethod
    def from_csr(cls, A: CSR, br: int, bc: int | None = None, device='cuda'):
        bc = br if bc is None else bc
        n, m = A.shape
        if n % br or m % bc:
            raise ProblemError(f'BSR blocking {br}x{bc} must divide the shape {A.shape}')
        nb = n // br
        rows, cols = A.row_of(), A.indices.astype(np.int64)
        brow, bcol = rows // br, cols // bc
        key = brow * (m // bc) + bcol
        uniq, inv = np.unique(key, return_inverse=True)
        ub_row, ub_col = uniq // (m // bc), uniq % (m // bc)
        counts = np.bincount(ub_row, minlength=nb)
        kb = int(counts.max()) if len(counts) else 1
        blocks = np.zeros((nb, kb, br, bc))
        segs = np.zeros((nb, kb), dtype=np.int32)
        # assign slots per block-row in column order (uniq is sorted by key)
        start = np.searchsorted(ub_row, np.arange(nb))
        slot_of = np.arange(len(uniq)) - start[ub_row]
        segs[ub_row, slot_of] = (ub_col * bc).astype(np.int32)
        blocks[ub_row[inv], slot_of[inv], rows % br, cols % bc] = A.data
        return cls(blocks, segs, A.shape, br, bc, nnz=A.nnz, device=device)

    def blocks_for(self, u: torch.Tensor) -> torch.Tensor:
        """The blocks in ``u``'s dtype on ``u``'s device (made once, kept)."""
        return self._cast('blocks', u)

    def seg_starts_for(self, u: torch.Tensor) -> torch.Tensor:
        """The int32 segment starts on ``u``'s device (made once, kept)."""
        return self._cast('seg_starts', u, torch.int32)

    def spmv(self, u):
        """Plain version: y = A @ u for ``u`` of shape (N,) or (N, B)."""
        idx = self.seg_starts_for(u).long()[..., None] + torch.arange(self.bc, device=u.device)
        useg = u[idx]                                        # (nb, kb, bc[, B])
        blocks = self.blocks_for(u)
        if u.dim() == 1:
            return torch.einsum('nkrc,nkc->nr', blocks, useg).reshape(self.shape[0])
        return torch.einsum('nkrc,nkcb->nrb', blocks, useg).reshape(self.shape[0], u.shape[1])
