"""Spatial mesh-to-mesh transfer via tensor-product Lagrange interpolation.

The counterpart of ``pysdc_tpu/transfer/space_mesh.py`` (reference
``mesh_to_mesh``, ``implementations/transfer_classes/TransferMesh.py``, and its
matrix factory, ``helpers/transfer_helper.py:91-240``): per-dimension
interpolation matrices built from barycentric Lagrange weights on k nearest
coarse neighbors (periodic wrap or Dirichlet ghost padding), restriction =
0.5 * P^T.  Unlike the reference's ND Kronecker sparse matrices, the ND
transfer is applied axis by axis.  The matrix construction is numpy at
set-up time; the applies are tensor operations on the field's device.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.device import cached_tensor
from pysdc_tpu_torch.core.errors import TransferError
from pysdc_tpu_torch.core.state import map_components
from pysdc_tpu_torch.ops.lagrange import interpolation_matrix as _lagrange_matrix


def _neighbors_periodic(p: float, grid: np.ndarray, k: int) -> list[int]:
    """Indices of the k grid points closest to p on the unit circle."""
    d = np.abs(grid - p)
    d = np.minimum(d, np.minimum(np.abs(grid - p + 1.0), np.abs(grid - p - 1.0)))
    return sorted(np.argsort(d, kind='stable')[:k])


def _continue_periodic(grid: np.ndarray, nn: list[int]) -> np.ndarray:
    """Unwrap the neighbor coordinates so they are monotone around p."""
    nn = np.asarray(nn)
    out = [grid[nn[0]]]
    shift = 0.0
    for n, d in zip(nn[1:], np.diff(nn)):
        if d != 1:
            shift = -1.0
        out.append(grid[n] + shift)
    return np.asarray(out)


def interpolation_matrix_1d(
    fine_grid: np.ndarray, coarse_grid: np.ndarray, k: int = 2, periodic: bool = False, pad: int = 1
) -> np.ndarray:
    """(n_fine, n_coarse) interpolation matrix, k-point barycentric Lagrange.

    Non-periodic grids are padded with one ghost point per side (the
    homogeneous-Dirichlet boundary values), whose columns are dropped."""
    n_f = fine_grid.size
    if periodic:
        M = np.zeros((n_f, coarse_grid.size))
        mean_f = np.mean(fine_grid)
        for i, p in enumerate(fine_grid):
            exact = np.isclose(coarse_grid, p, atol=1e-14)
            if exact.any():
                M[i, np.argmax(exact)] = 1.0
                continue
            nn = _neighbors_periodic(p, coarse_grid, k)
            pts = _continue_periodic(coarse_grid, nn)
            if p > mean_f and not (pts[0] <= p <= pts[-1]):
                pts = pts + 1.0
            M[i, nn] = _lagrange_matrix(pts, np.array([p]))[0]
        return M

    dxl = coarse_grid[1] - coarse_grid[0] if coarse_grid.size > 1 else coarse_grid[0]
    padded = np.concatenate([[coarse_grid[0] - dxl], coarse_grid, [coarse_grid[-1] + dxl]])
    M = np.zeros((n_f, padded.size))
    for i, p in enumerate(fine_grid):
        exact = np.isclose(padded, p, atol=1e-14)
        if exact.any():
            M[i, np.argmax(exact)] = 1.0
            continue
        nn = sorted(np.argsort(np.abs(padded - p), kind='stable')[:k])
        M[i, nn] = _lagrange_matrix(padded[nn], np.array([p]))[0]
    return M[:, pad:-pad] if pad > 0 else M


def _stride_circulant_stencil(M: np.ndarray, s: int, transpose_stride: bool):
    """Detect stride-circulant structure and extract the banded stencil.

    Prolongation (nf, nc) matrices on nested uniform periodic grids satisfy
    ``M[q*s + r] == roll(M[r], q)``: each of the s fine residues applies one
    fixed k-point stencil to the coarse array.  Restriction (nc, nf)
    matrices satisfy ``M[q] == roll(M[0], q*s)``.  Returns per-residue
    (offsets, weights) lists, or None when the structure does not hold
    (non-nested or Dirichlet grids fall back to the dense matmul)."""
    n_out, n_in = M.shape
    if transpose_stride:  # restriction: one residue, stride on the input axis
        if n_in % n_out or n_in // n_out != s:
            return None
        base = M[0]
        for q in range(1, n_out):
            if not np.allclose(M[q], np.roll(base, q * s), atol=1e-14):
                return None
        cols = np.nonzero(np.abs(base) > 1e-15)[0]
        if cols.size > 4 * s + 4:
            return None
        offs = np.where(cols > n_in // 2, cols - n_in, cols)  # centered wrap
        return [(offs, base[cols])]
    if n_out % n_in or n_out // n_in != s:
        return None
    stencils = []
    for r in range(s):
        base = M[r]
        for q in range(1, n_in):
            if not np.allclose(M[q * s + r], np.roll(base, q), atol=1e-14):
                return None
        cols = np.nonzero(np.abs(base) > 1e-15)[0]
        if cols.size > 8:
            return None
        offs = np.where(cols > n_in // 2, cols - n_in, cols)
        stencils.append((offs, base[cols]))
    return stencils


class MeshTransfer:
    """Space transfer with per-axis interpolation/restriction operators.

    On nested uniform periodic grids the Lagrange matrices are
    stride-circulant and are applied as k-term roll/stride stencils —
    O(n*k) per axis instead of the O(n_f*n_c) dense product, which at PFASST
    transfer time otherwise costs as much as a full sweep (the reference
    keeps them sparse for the same reason, helpers/transfer_helper.py:91).
    Non-nested or Dirichlet grids use the dense ``tensordot``, in full
    precision under :mod:`pysdc_tpu_torch.core.precision`; its matrices are
    copied to the field's device once per dtype and kept.

    params: iorder (default 2), rorder (2), periodic (False), pad (1).
    """

    def __init__(self, fine_prob, coarse_prob, params: dict):
        params = dict(params)
        self.iorder = params.get('iorder', 2)
        self.rorder = params.get('rorder', 2)
        self.periodic = params.get('periodic', getattr(fine_prob, 'bc', '') == 'periodic')
        if self.rorder % 2 != 0:
            raise TransferError('Need even order for restriction')
        if self.iorder % 2 != 0:
            raise TransferError('Need even order for interpolation')

        f_shape, c_shape = fine_prob.shape, coarse_prob.shape
        if len(f_shape) != len(c_shape):
            raise TransferError('fine and coarse problems need the same number of dimensions')
        self.fine_shape, self.coarse_shape = f_shape, c_shape

        self._consts: dict = {}
        self.P_1d, self.R_1d = [], []
        self.P_sten, self.R_sten = [], []  # (s, stencils) per axis, or None
        for nf, nc in zip(f_shape, c_shape):
            if nf == nc:
                self.P_1d.append(np.eye(nf))
                self.R_1d.append(np.eye(nf))
                self.P_sten.append(None)
                self.R_sten.append(None)
                continue
            if self.periodic:
                fine_grid = np.arange(nf) / nf
                coarse_grid = np.arange(nc) / nc
            else:
                fine_grid = np.arange(1, nf + 1) / (nf + 1)
                coarse_grid = np.arange(1, nc + 1) / (nc + 1)
            P = interpolation_matrix_1d(fine_grid, coarse_grid, k=self.iorder, periodic=self.periodic)
            if self.iorder == self.rorder:
                R = 0.5 * P.T
            else:
                R = 0.5 * interpolation_matrix_1d(
                    fine_grid, coarse_grid, k=self.rorder, periodic=self.periodic
                ).T
            self.P_1d.append(P)
            self.R_1d.append(R)
            s = nf // nc if (self.periodic and nf % nc == 0) else 0
            self.P_sten.append(
                (s, _stride_circulant_stencil(P, s, transpose_stride=False)) if s else None
            )
            self.R_sten.append(
                (s, _stride_circulant_stencil(R, s, transpose_stride=True)) if s else None
            )
            if self.P_sten[-1] and self.P_sten[-1][1] is None:
                self.P_sten[-1] = None
            if self.R_sten[-1] and self.R_sten[-1][1] is None:
                self.R_sten[-1] = None

    def disable_stencils(self):
        """Take the dense ``tensordot`` on every axis instead of the
        roll/stride stencils (the same operator, applied as a matrix)."""
        self.P_sten = [None] * len(self.P_sten)
        self.R_sten = [None] * len(self.R_sten)

    @staticmethod
    def _stencil_sum(offs, w, x, dim):
        """sum_j w_j x[(i + off_j) % n] along axis ``dim``."""
        acc = None
        for o, wj in zip(offs, w):
            term = float(wj) * torch.roll(x, -int(o), dims=dim)
            acc = term if acc is None else acc + term
        return acc

    @classmethod
    def _stencil_restrict_axis(cls, s, stencil, x, dim):
        """out[q] = sum_j w_j x[(q*s + off_j) % nf] along axis ``dim`` (>= 0)."""
        (offs, w), = stencil
        keep = (slice(None),) * dim + (slice(None, None, s),)
        return cls._stencil_sum(offs, w, x, dim)[keep]

    @classmethod
    def _stencil_prolong_axis(cls, s, stencils, x, dim):
        """out[q*s + r] = sum_j w_rj x[(q + off_rj) % nc] along axis ``dim`` (>= 0)."""
        stacked = torch.stack([cls._stencil_sum(offs, w, x, dim) for offs, w in stencils], dim=dim + 1)
        return stacked.reshape(x.shape[:dim] + (x.shape[dim] * s,) + x.shape[dim + 1:])

    def _apply_per_axis(self, kind, x):
        mats, stens = (self.R_1d, self.R_sten) if kind == 'restrict' else (self.P_1d, self.P_sten)
        offset = x.dim() - len(mats)
        for axis, (M, sten) in enumerate(zip(mats, stens)):
            ax = axis + offset
            if M.shape[0] == M.shape[1]:
                continue  # equal sizes along this axis: the identity
            if sten is not None:
                # along the axis where it lies: moving it to the end first would make every roll a transposing copy
                s, stencil = sten
                axis_op = self._stencil_restrict_axis if kind == 'restrict' else self._stencil_prolong_axis
                x = axis_op(s, stencil, x, ax)
            else:
                Mt = cached_tensor(self._consts, (kind, axis), lambda: M, x)
                x = torch.movedim(torch.tensordot(Mt, x, dims=([1], [ax])), 0, ax)
        return x.contiguous()

    def restrict(self, F):
        """Fine -> coarse on tensors or RHS containers with trailing space dims."""
        return map_components(lambda leaf: self._apply_per_axis('restrict', leaf), F)

    def prolong(self, G):
        return map_components(lambda leaf: self._apply_per_axis('prolong', leaf), G)
