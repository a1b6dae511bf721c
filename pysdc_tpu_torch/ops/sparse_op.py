"""Assembled sparse ND operators with structured direct and Krylov solves.

The counterpart of ``pysdc_tpu/ops/sparse_op.py``.  Where
:class:`~pysdc_tpu_torch.ops.linop.SeparableFDOperator` diagonalizes
separable tensor-product operators, this layer handles the general case —
variable coefficients, cross terms, any CSR matrix — the way the reference
does with scipy CSR + cached ``splu`` (``generic_ND_FD.py:17-240``):

  - the matrix is assembled on the host with the CSR algebra
    (:mod:`pysdc_tpu_torch.ops.sparse`), e.g. by Kronecker sums of 1D
    stencils;
  - ``apply`` is a DIA SpMV where the matrix lives on a few diagonals (FD
    matrices do) and an ELL gather otherwise.  On a CUDA tensor the DIA SpMV
    launches kernel K2 (:mod:`pysdc_tpu_torch.ops.kernels.dia`);
    ``apply_bsr`` applies the block-sparse form through kernel K3
    (:mod:`pysdc_tpu_torch.ops.kernels.bsr`);
  - ``solve_shifted`` picks a structured factorization by bandwidth:
    parallel cyclic reduction for tridiagonal (plain or periodic), banded LU
    for small bands, block cyclic reduction for block-tridiagonal, and
    spectrally preconditioned CG (PCG) when a separable surrogate is given;
    plain CG is the unstructured fallback;
  - ``prepare_node_shifts`` factors the M per-node shifts once at level
    setup, so every node solve is a substitution; a residual-refinement loop
    keeps the prepared path correct if the shift drifts from the prepared
    one (adaptive dt).

Where the JAX package runs a ``lax.while_loop`` (CG, PCG, refinement), the
port runs a :func:`~pysdc_tpu_torch.ops.loops.masked_loop`: the stopping test
stays on the device and the host reads it once every ``READ_EVERY``
iterations (a PCG solve of k iterations reads ``ceil(k / READ_EVERY) + 1``
times; ``host_reads`` counts them).  Inside a CUDA graph capture the loops
would unroll to their ``maxiter``, so the fused lanes refuse an operator whose
solve iterates (:attr:`SparseOperator.graph_capture_blocker`).

The DIA SpMV default differs from the JAX package on purpose: the JAX
package keeps XLA's fused rolls as the default and the Pallas kernel as an
opt-in (``enable_pallas_dia``), because XLA fuses the shifted reads into one
pass.  Eager PyTorch writes one rotated copy of the field per diagonal, so
the port launches K2 by default; ``disable_pallas_dia()`` routes the same
path through the plain rolls (``DIA.spmv``).
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.device import resolve_device
from pysdc_tpu_torch.core.errors import ProblemError
from pysdc_tpu_torch.ops import banded
from pysdc_tpu_torch.ops.fd import fd_matrix_1d
from pysdc_tpu_torch.ops.kernels.bsr import bsr_spmm
from pysdc_tpu_torch.ops.kernels.dia import dia_spmv
from pysdc_tpu_torch.ops.krylov import cg, gmres
from pysdc_tpu_torch.ops.loops import masked_loop
from pysdc_tpu_torch.ops.sparse import BSR, CSR, DIA, ELL


class SparseOperator:
    """A general sparse linear operator ``A`` with shifted solves.

    Parameters
    ----------
    A:          host CSR matrix (n x n), including any global scale.
    grid_shape: logical ND shape the flat operator acts on.
    bc_rhs:     optional inhomogeneous-boundary vector added by problems (numpy).
    block:      block size for the block-tridiagonal solve (defaults to the
                last grid dimension for 2D grids).
    solver:     'auto' | 'tridiag' | 'cyclic_tridiag' | 'banded' |
                'block_tridiag' | 'pcg' | 'cg'
    precond:    an operator with an exact ``solve_shifted(rhs, factor)`` on
                the same grid (the nearest separable surrogate); enables 'pcg'.
    device:     where the device formats keep their master tensors (the card
                unless ``'cpu'`` is asked for; without a card the default
                raises); fields on another device get a copy made once and kept.

    Counters: ``spmv_count`` counts every SpMV the operator makes (eval_f,
    Krylov matvecs, residuals, masked iterations included); ``pcg_solves`` /
    ``pcg_iterations`` count the PCG solves and their iterations, ``pcg_steps``
    the iterations computed (the masked ones past a stop included);
    ``pcg_trace``, when set to a list, receives the iteration count of each
    PCG solve; ``host_reads`` counts the reads of the Krylov and refinement
    loops.
    """

    def __init__(self, A: CSR, grid_shape=None, bc_rhs=None, block=None, solver='auto', precond=None,
                 device='cuda'):
        n = A.shape[0]
        if A.shape[0] != A.shape[1]:
            raise ProblemError('SparseOperator needs a square matrix')
        self.precond = precond
        self.A = A
        self.grid_shape = tuple(grid_shape) if grid_shape is not None else (n,)
        self.n = n
        self.device = device = resolve_device(device)
        self.bc_rhs = None if bc_rhs is None else np.asarray(bc_rhs)
        self.ell = ELL.from_csr(A, device=device)
        # FD matrices live on a handful of diagonals: DIA replaces ELL's
        # gather; on 2D grids the plain version rolls the grid view
        self.dia = DIA.from_csr(A, device=device)
        if self.dia is not None and grid_shape is not None and len(self.grid_shape) == 2:
            self.dia = self.dia.with_grid(self.grid_shape)
        self.nnz_per_dof = A.nnz / n
        self._consts: dict = {}
        self._pallas_dia = True
        self._bsr = None
        self.spmv_count = 0
        self.pcg_solves = 0
        self.pcg_iterations = 0
        self.pcg_steps = 0
        self.pcg_trace = None
        self.host_reads = 0

        lower, upper = A.bandwidths()
        self._solver = solver
        if solver == 'auto':
            rows = A.row_of()
            offs = A.indices.astype(np.int64) - rows
            in_band1 = np.abs(offs) <= 1
            corners = (~in_band1) & (
                ((rows == 0) & (offs == n - 1)) | ((rows == n - 1) & (offs == -(n - 1)))
            )
            if lower <= 1 and upper <= 1:
                self._solver = 'tridiag'
            elif np.all(in_band1 | corners) and corners.any():
                self._solver = 'cyclic_tridiag'
            elif lower <= 4 and upper <= 4:
                self._solver = 'banded'
            elif precond is not None:
                self._solver = 'pcg'
            else:
                base = block or (self.grid_shape[-1] if len(self.grid_shape) == 2 else None)
                self._solver = 'cg'
                if base:
                    # wider-bandwidth rows (e.g. one-sided boundary stencils)
                    # may need blocks spanning several grid lines
                    for mult in (1, 2, 4):
                        cand = base * mult
                        if n % cand == 0 and cand < n:
                            try:
                                banded.block_tridiag_from_csr(A, cand)
                                self._solver = 'block_tridiag'
                                block = cand
                                break
                            except ProblemError:
                                continue

        if self._solver in ('tridiag', 'cyclic_tridiag'):
            lo = np.zeros(n)
            dg = np.zeros(n)
            up = np.zeros(n)
            rows = A.row_of()
            offs = A.indices.astype(np.int64) - rows
            for o, tgt in ((-1, lo), (0, dg), (1, up)):
                m = offs == o
                tgt[rows[m]] = A.data[m]
            self._tri = (lo, dg, up)
            if self._solver == 'cyclic_tridiag':
                m_up = (rows == 0) & (offs == n - 1)
                m_lo = (rows == n - 1) & (offs == -(n - 1))
                c_lo = float(A.data[m_lo][0]) if m_lo.any() else 0.0
                c_up = float(A.data[m_up][0]) if m_up.any() else 0.0
                self._corners = (c_lo, c_up)  # (A[n-1,0], A[0,n-1])
        elif self._solver == 'banded':
            self._bands, _ = A.to_banded()
            self._bw = A.bandwidths()
        elif self._solver == 'block_tridiag':
            block = block or self.grid_shape[-1]
            self._blocks = banded.block_tridiag_from_csr(A, block)
            self._block = block

        #: prepared per-node factorizations: (shifts, [float64 factor dict per node]),
        #: and their copies per (node, dtype, device)
        self._prep = None
        self._prep_casts: dict = {}

    def _const(self, name: str, arr, like: torch.Tensor) -> torch.Tensor:
        """Host constant ``arr`` in ``like``'s dtype on its device (made once, kept)."""
        key = (name, like.dtype, like.device)
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = torch.as_tensor(np.asarray(arr), dtype=like.dtype, device=like.device)
        return t

    # -- prepared factorizations ----------------------------------------
    def prepare_node_shifts(self, shifts) -> bool:
        """Factor ``I - shift*A`` for each concrete shift in ``shifts``.

        Called at level setup with the M node shifts ``dt * diag(QDelta)``.
        Returns True if a prepared path exists for this operator's structure.
        The factors are float64 on the operator's device; a field of another
        dtype or device gets a copy made once and kept.
        """
        shifts = np.atleast_1d(np.asarray(shifts, dtype=float))
        if self._solver == 'block_tridiag':
            factors = [banded.block_cr_shifted_factor(*self._blocks, float(s), device=self.device) for s in shifts]
            self._prep = (shifts, factors)
            self._prep_casts.clear()
            return True
        return False

    def _prepared_factor(self, node: int, like: torch.Tensor) -> dict:
        key = (node, like.dtype, like.device)
        fac = self._prep_casts.get(key)
        if fac is None:
            def cast(t):
                return t.to(dtype=like.dtype, device=like.device)

            src = self._prep[1][node]
            fac = self._prep_casts[key] = dict(
                levels=[{k: cast(v) for k, v in lv.items()} for lv in src['levels']],
                top_inv=cast(src['top_inv']),
            )
        return fac

    def _prepared_solve(self, flat, factor, node):
        """Solve with the node's prepared factors + residual refinement.

        When ``factor`` equals the prepared shift (fixed dt) the refinement
        loop exits after one residual check; when adaptivity moved dt, the
        stale factorization acts as a preconditioner and the loop iterates to
        tolerance (at most 50 times)."""
        fac_m = self._prepared_factor(node, flat)
        nb = self.n // self._block
        shaped = flat.reshape(flat.shape[:-1] + (nb, self._block))

        def direct(r):
            return banded.block_cr_solve(fac_m, r)

        def residual(x):
            xf = x.reshape(flat.shape)
            return shaped - (xf - factor * self._mv(xf)).reshape(shaped.shape)

        def body(carry, flags):
            x = carry[0] + direct(carry[1])
            return x, residual(x)

        x = direct(shaped)
        bound = 50 * torch.finfo(flat.dtype).eps * (torch.linalg.vector_norm(flat) + 1e-30)
        out = masked_loop(body, lambda c: torch.linalg.vector_norm(c[1]) > bound, (x, residual(x)), 50)
        self.host_reads += out.reads
        return out.carry[0].reshape(flat.shape)

    # -- apply -----------------------------------------------------------
    def enable_pallas_dia(self):
        """Route the DIA SpMV through kernel K2 on CUDA tensors (the
        default; the name is kept from the JAX package)."""
        if self.dia is None:
            raise ProblemError('the DIA kernel apply needs a DIA-convertible matrix')
        self._pallas_dia = True
        return self

    def disable_pallas_dia(self):
        """Route the DIA SpMV through the plain rolls (``DIA.spmv``)."""
        self._pallas_dia = False
        return self

    def _mv(self, flat):
        """A @ flat over the trailing (flattened-grid) axis."""
        self.spmv_count += 1
        if self.dia is None:
            return self.ell.spmv(flat)
        if self._pallas_dia:
            return dia_spmv(self.dia, flat.contiguous())
        return self.dia.spmv(flat)

    def apply(self, u):
        """A @ u; trailing axes are the grid, leading axes batch."""
        flat = u.reshape(u.shape[: u.dim() - len(self.grid_shape)] + (self.n,))
        return self._mv(flat).reshape(u.shape)

    def apply_bsr(self, u, br=None):
        """Block-sparse apply; ``u`` (n,) or (n, B), operator axis first.

        ``br`` defaults to the largest of 256 and 128 that divides n (8
        otherwise).  The blocked operator is built once per block size and
        kept.  On a CUDA tensor this launches kernel K3; on a CPU tensor the
        plain ``BSR.spmv`` runs."""
        if br is None:
            br = next((b for b in (256, 128) if self.n % b == 0), 8)
        if self._bsr is None or self._bsr.br != br:
            self._bsr = BSR.from_csr(self.A, br, br, device=self.device)
        u2 = u[:, None] if u.dim() == 1 else u
        y = bsr_spmm(self._bsr, u2.contiguous())
        return y[:, 0] if u.dim() == 1 else y

    # -- shifted solve -----------------------------------------------------
    def solve_shifted(self, rhs, factor, x0=None, tol=1e-12, maxiter=1000, node=None):
        """Solve ``(I - factor*A) x = rhs`` for a scalar ``factor``.

        ``node`` selects a prepared per-node factorization when
        :meth:`prepare_node_shifts` ran — substitution only."""
        batch_shape = rhs.shape[: rhs.dim() - len(self.grid_shape)]
        flat = rhs.reshape(batch_shape + (self.n,))

        if self._solver == 'tridiag':
            lo, dg, up = (self._const(f'tri{i}', v, flat) for i, v in enumerate(self._tri))
            x = banded.tridiag_pcr_solve(-factor * lo, 1.0 - factor * dg, -factor * up, flat)
        elif self._solver == 'cyclic_tridiag':
            lo, dg, up = (self._const(f'tri{i}', v, flat) for i, v in enumerate(self._tri))
            c_lo, c_up = self._corners
            x = banded.cyclic_tridiag_solve(
                -factor * lo, 1.0 - factor * dg, -factor * up, -factor * c_lo, -factor * c_up, flat,
            )
        elif self._solver == 'banded':
            x = banded.banded_shifted_solve(self._bands, *self._bw, flat, factor)
        elif self._solver == 'block_tridiag':
            if node is not None and self._prep is not None:
                x = self._prepared_solve(flat, factor, node)
            else:
                fac = banded.block_cr_shifted_factor(*self._blocks, factor, dtype=flat.dtype, device=flat.device)
                nb = self.n // self._block
                shaped = flat.reshape(flat.shape[:-1] + (nb, self._block))
                x = banded.block_cr_solve(fac, shaped).reshape(flat.shape)
        elif self._solver == 'pcg':
            x, _ = self._pcg(flat, factor, tol, maxiter, x0)
        else:
            x0f = None if x0 is None else x0.reshape(batch_shape + (self.n,))
            # floor the tolerance at the dtype's reachable residual level:
            # the 1e-12 default would spin f32 solves to maxiter
            x = self._cg(flat, factor, max(tol, 50 * torch.finfo(rhs.dtype).eps), maxiter, x0f)
        return x.reshape(rhs.shape)

    def _shifted_mv(self, factor):
        return lambda v: v - factor * self._mv(v)

    def _cg(self, b, factor, tol, maxiter, x0=None):
        """Unpreconditioned CG on ``(I - factor*A) x = b``: ``jax.scipy``'s CG
        (:func:`pysdc_tpu_torch.ops.krylov.cg`) over the whole flattened batch."""
        x, info = cg(self._shifted_mv(factor), b, x0, tol=tol, maxiter=maxiter)
        self.host_reads += info.reads
        return x

    def _pcg(self, flat, factor, tol, maxiter, x0=None):
        """Preconditioned CG on ``(I - factor*A) x = flat``.

        The preconditioner is one exact spectral solve of the separable
        surrogate; the depth is set by the coefficient variation, not the
        grid.  Deferred-z order as in the JAX package: the preconditioner
        solve runs at the top of each iteration, so k iterations cost k
        solves; the inner products and the stopping norm run over the whole
        flattened batch.  Returns ``(x, iterations)`` (``None`` inside a CUDA
        graph capture, which reads nothing)."""
        tol = max(tol, 50 * torch.finfo(flat.dtype).eps)
        mv = self._shifted_mv(factor)

        def M(r):
            grid = r.reshape(r.shape[:-1] + self.grid_shape)
            return self.precond.solve_shifted(grid, factor).reshape(r.shape)

        if x0 is None:
            x = torch.zeros_like(flat)
            r = flat
        else:
            x = x0.reshape(flat.shape)
            r = flat - mv(x)
        bound = tol * torch.linalg.vector_norm(flat)
        step = [0]

        def body(carry, flags):
            x, r, p, rz_prev = carry
            z = M(r)
            rz = torch.sum(r * z)
            p = z if step[0] == 0 else z + (rz / rz_prev) * p
            step[0] += 1
            Ap = mv(p)
            alpha = rz / torch.sum(p * Ap)
            return x + alpha * p, r - alpha * Ap, p, rz

        out = masked_loop(body, lambda c: torch.linalg.vector_norm(c[1]) > bound,
                          (x, r, torch.zeros_like(flat), torch.ones((), dtype=flat.dtype, device=flat.device)),
                          maxiter)
        self.host_reads += out.reads
        k = None if out.host_counts is None else out.host_counts[0]
        self.pcg_solves += 1
        self.pcg_steps += out.steps
        if k is not None:
            self.pcg_iterations += k
            if self.pcg_trace is not None:
                self.pcg_trace.append(k)
        return out.carry[0], k

    def solve_shifted_info(self, rhs, factor, tol=1e-12, maxiter=1000):
        """Like :meth:`solve_shifted` but also returns the Krylov iteration
        count (0 for the direct lanes)."""
        if self._solver != 'pcg':
            return self.solve_shifted(rhs, factor), 0
        batch_shape = rhs.shape[: rhs.dim() - len(self.grid_shape)]
        flat = rhs.reshape(batch_shape + (self.n,))
        x, k = self._pcg(flat, factor, tol, maxiter)
        return x.reshape(rhs.shape), k

    @property
    def solver_kind(self):
        return self._solver

    @property
    def graph_capture_blocker(self):
        """Why a CUDA graph cannot hold this operator's solves (None where it can): an iterative solve to a
        tolerance would be captured as ``maxiter`` masked iterations."""
        if self._solver in ('pcg', 'cg'):
            return (f"SparseOperator(solver={self._solver!r}) iterates to a tolerance; inside a CUDA graph it would "
                    f"run its maxiter masked iterations: this configuration runs on the stage-machine path")
        if self._prep is not None:
            return ('the prepared block-tridiagonal solve refines to a tolerance (up to 50 masked iterations inside '
                    'a CUDA graph): this configuration runs on the stage-machine path')
        return None


def assemble_ndim_fd(per_dim: list[dict], scale: float = 1.0):
    """Kronecker-sum assembly of an ND FD operator as CSR.

    Same inputs as :class:`~pysdc_tpu_torch.ops.linop.SeparableFDOperator`;
    the result is the explicit sparse matrix (plus the flattened boundary
    RHS, numpy), built with the CSR algebra — the reference's scipy-kron
    construction (``problem_helper.py:42-245``) without scipy.
    """
    shape = tuple(d['size'] for d in per_dim)
    ndim = len(per_dim)
    n_total = int(np.prod(shape))
    A_total = None
    b_total = np.zeros(shape)

    for axis, d in enumerate(per_dim):
        A1, b1 = fd_matrix_1d(
            d.get('derivative', 2), d.get('order', 2), d['size'], d['dx'],
            bc=d.get('bc', 'periodic'), stencil_type=d.get('stencil_type', 'center'),
            steps=d.get('steps'), bc_params=d.get('bc_params'),
        )
        term = CSR.from_dense(A1, tol=1e-15)
        for left_ax in range(axis - 1, -1, -1):
            term = CSR.eye(shape[left_ax]).kron(term)
        for right_ax in range(axis + 1, ndim):
            term = term.kron(CSR.eye(shape[right_ax]))
        A_total = term if A_total is None else A_total + term
        shape_b = [1] * ndim
        shape_b[axis] = shape[axis]
        b_total = b_total + b1.reshape(shape_b)

    A_total = A_total.scale(scale).prune(0.0)
    bc_rhs = scale * b_total.reshape(n_total)
    return A_total, (bc_rhs if np.any(bc_rhs) else None)


class SparseFDOperator(SparseOperator):
    """Drop-in sparse counterpart of
    :class:`~pysdc_tpu_torch.ops.linop.SeparableFDOperator`: same ``per_dim``
    construction, same ``apply``/``solve_shifted``/``bc_rhs`` interface, but
    the operator is an assembled CSR matrix solved by structured
    factorization or PCG (``backend='sparse'`` on the FD problem classes)."""

    def __init__(self, per_dim: list[dict], scale: float = 1.0, solver='auto', block=None, precond=None,
                 device='cuda'):
        A, bc_rhs = assemble_ndim_fd(per_dim, scale=scale)
        shape = tuple(d['size'] for d in per_dim)
        if bc_rhs is not None:
            bc_rhs = bc_rhs.reshape(shape)
        super().__init__(A, grid_shape=shape, bc_rhs=bc_rhs, block=block, solver=solver, precond=precond,
                         device=device)
        self.ndim = len(shape)
        self.scale = float(scale)

    def solve_shifted_cg(self, rhs, factor, x0, tol=1e-12, maxiter=10000):
        return self.solve_shifted(rhs, factor, x0=x0, tol=tol, maxiter=maxiter)

    def solve_shifted_gmres(self, rhs, factor, x0, tol=1e-12, maxiter=100):
        """GMRES (``jax.scipy``'s, restart 20, ``maxiter`` restarts) on ``(I - factor*A) x = rhs`` over the
        whole flattened batch, from ``x0``."""
        batch_shape = rhs.shape[: rhs.dim() - len(self.grid_shape)]
        flat = rhs.reshape(batch_shape + (self.n,))
        x, info = gmres(self._shifted_mv(factor), flat, x0.reshape(flat.shape), tol=tol, maxiter=maxiter)
        self.host_reads += info.reads
        return x.reshape(rhs.shape)


def variable_diffusion_matrix(a_faces, dx, bc='dirichlet'):
    """1D conservative variable-coefficient diffusion: rows of
    ``d/dx(a(x) du/dx)`` with face-centered coefficients ``a_{i+1/2}``
    (``a_faces`` has size n+1).  Dirichlet (homogeneous) or periodic."""
    a = np.asarray(a_faces, dtype=float)
    n = len(a) - 1
    inv = 1.0 / dx**2
    lo = a[:-1] * inv          # multiplies u[i-1]
    up = a[1:] * inv           # multiplies u[i+1]
    dg = -(a[:-1] + a[1:]) * inv
    if bc == 'periodic':
        rows = np.concatenate([np.arange(n)] * 3)
        cols = np.concatenate([(np.arange(n) - 1) % n, np.arange(n), (np.arange(n) + 1) % n])
        vals = np.concatenate([lo, dg, up])
        return CSR.from_coo(rows, cols, vals, (n, n))
    return CSR.diags([lo[1:], dg, up[:-1]], [-1, 0, 1], (n, n))
