"""Separable finite-difference operators with exact direct shifted solves.

The counterpart of ``pysdc_tpu/ops/linop.py:SeparableFDOperator``.  The
reference assembles scipy sparse matrices and factorizes them with ``splu``
per (dt*q) shift (``generic_ND_FD.py:208-240``).  Here the tensor-product
structure is used directly:

  A = sum_d I (x) ... (x) A_d (x) ... (x) I

  - periodic dims: A_d is circulant -> matrix-free stencil application and
    exact direct solves by FFT diagonalization (cuFFT on the card).  A 2D
    all-periodic operator applies through kernel K1
    (:func:`pysdc_tpu_torch.ops.kernels.stencil.cross_stencil_2d`), complex
    fields too (on their interleaved real view).
  - general dims (Dirichlet/Neumann): A_d = V_d L_d V_d^{-1} eigen-factorized
    once on the host; applies and solves become dense per-axis products.

``(I - factor*A) x = rhs`` for any scalar ``factor`` (including 0) is thus
one transform, one elementwise divide, one inverse transform.  Constant
tensors are made once per (dtype, device) and kept.  The iterative solves of
``solver_type='CG'|'GMRES'`` are ``jax.scipy``'s CG and GMRES
(:mod:`pysdc_tpu_torch.ops.krylov`) on the shifted apply.
:class:`SpectralOperator` is the exact Fourier operator of the spectral
models (cuFFT on the card).  The halo apply waits for the mesh half of the
sharded controller (ROADMAP queue 1, item 10b).
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.device import complex_dtype
from pysdc_tpu_torch.core.errors import ProblemError
from pysdc_tpu_torch.ops.fd import fd_matrix_1d, get_finite_difference_stencil, stencil_symbol
from pysdc_tpu_torch.ops.krylov import cg, gmres


class SeparableFDOperator:
    """Sum of per-axis 1D FD operators with per-axis BCs.

    Parameters
    ----------
    per_dim:
        list over dimensions of dicts with keys
        ``size, dx, derivative, order, stencil_type, steps, bc, bc_params``.
        ``bc`` is 'periodic' or (anything containing) 'dirichlet'/'neumann'.
    scale:
        global prefactor (e.g. diffusion coefficient nu).

    Constant tensors follow the device and dtype of the fields they meet.
    ``krylov_trace``, when set to a list, receives ``(kind, iterations,
    Arnoldi steps per restart)`` of each CG / GMRES solve; ``host_reads``
    counts their loops' reads.
    """

    def __init__(self, per_dim: list[dict], scale: float = 1.0):
        self.ndim = len(per_dim)
        self.scale = float(scale)
        self.shape = tuple(d['size'] for d in per_dim)
        self._dims = []
        self._consts: dict = {}
        self.bc_rhs = None  # inhomogeneous-BC vector (sum over dims, scaled), numpy
        self.krylov_trace = None
        self.host_reads = 0
        nnz = 0

        bc_vec_total = np.zeros(self.shape)
        for axis, d in enumerate(per_dim):
            size, dx = d['size'], d['dx']
            bc = d.get('bc', 'periodic')
            bc0 = bc[0] if isinstance(bc, tuple) else bc
            derivative = d.get('derivative', 2)
            order = d.get('order', 2)
            stencil_type = d.get('stencil_type', 'center')
            steps = d.get('steps')
            if bc0 == 'periodic':
                coeff, offs = get_finite_difference_stencil(derivative, order, stencil_type, steps)
                lam = stencil_symbol(coeff, offs, size, dx, derivative)
                self._dims.append(
                    dict(kind='circulant', axis=axis, coeff=coeff / dx**derivative, offs=offs, lam=lam)
                )
                nnz += len(coeff)
            else:
                A1, b1 = fd_matrix_1d(
                    derivative, order, size, dx, bc=bc, stencil_type=stencil_type, steps=steps,
                    bc_params=d.get('bc_params'),
                )
                if np.allclose(A1, A1.T, atol=1e-14 * np.max(np.abs(A1))):
                    # symmetric (e.g. 2nd-order Dirichlet Laplacian): orthogonal
                    # eigenbasis, V^{-1} = V^T exactly — no conditioning loss
                    lam, V = np.linalg.eigh(A1)
                    Vinv = V.T
                else:
                    lam, V = np.linalg.eig(A1)
                    cond = np.linalg.cond(V)
                    if cond > 1e10:
                        raise ProblemError(
                            f'1D FD matrix along axis {axis} is too ill-conditioned for the eigen '
                            f'direct solver (cond(V)={cond:.1e}); use an iterative solver_type'
                        )
                    Vinv = np.linalg.inv(V)
                    if np.max(np.abs(lam.imag)) < 1e-12 * max(np.max(np.abs(lam.real)), 1.0):
                        lam, V, Vinv = lam.real, V.real, Vinv.real
                self._dims.append(dict(kind='dense', axis=axis, A=A1, lam=lam, V=V, Vinv=Vinv))
                nnz += int(np.mean(np.count_nonzero(A1, axis=1)))
                # broadcast the 1D boundary vector into the ND grid
                shape_b = [1] * self.ndim
                shape_b[axis] = size
                bc_vec_total = bc_vec_total + b1.reshape(shape_b)

        #: mean nonzeros per matrix row of the assembled ND operator
        self.nnz_per_dof = nnz
        if np.any(bc_vec_total):
            self.bc_rhs = self.scale * bc_vec_total

        #: full spectral grid Lambda = sum_d lam_d (broadcast), scaled
        lam_nd = np.zeros(self.shape, dtype=complex)
        for d in self._dims:
            shape_b = [1] * self.ndim
            shape_b[d['axis']] = self.shape[d['axis']]
            lam_nd = lam_nd + d['lam'].reshape(shape_b)
        if np.max(np.abs(lam_nd.imag)) < 1e-12 * max(np.max(np.abs(lam_nd.real)), 1.0):
            lam_nd = lam_nd.real
        self._lam_nd = lam_nd
        self.all_periodic = all(d['kind'] == 'circulant' for d in self._dims)
        # real-symbol all-periodic operators get a cheaper rfft solve path
        self._rfft_ok = self.all_periodic and not np.iscomplexobj(lam_nd)
        if self._rfft_ok:
            self._lam_rfft = lam_nd[..., : self.shape[-1] // 2 + 1]

        # 2D all-periodic operators apply through kernel K1: one pass over
        # device memory for all taps, the scale folded into the taps
        self._cross_terms = None
        if self.ndim == 2 and self.all_periodic:
            self._cross_terms = tuple(
                (tuple(float(self.scale * c) for c in d['coeff']), tuple(int(s) for s in d['offs']))
                for d in self._dims
            )
        self._pallas = True

    def _const(self, name: str, arr: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
        """``arr`` as a tensor of ``dtype`` on ``device``, made once and kept."""
        key = (name, dtype, device)
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = torch.as_tensor(np.asarray(arr), dtype=dtype, device=device)
        return t

    def _mat(self, name: str, mat: np.ndarray, x: torch.Tensor) -> torch.Tensor:
        """Constant ``mat`` in ``x``'s precision, complex if either is complex
        (float32 fields stay float32/complex64)."""
        complex_ = np.iscomplexobj(mat) or x.is_complex()
        dtype = complex_dtype(x.dtype) if complex_ else x.dtype
        return self._const(name, mat, dtype, x.device)

    def disable_rfft(self):
        """Route solves through the full complex-FFT path (mathematically
        identical, about twice the spectral traffic)."""
        self._rfft_ok = False

    def enable_rfft(self):
        """Re-enable the half-spectrum path when the operator supports it."""
        self._rfft_ok = self.all_periodic and hasattr(self, '_lam_rfft')

    def disable_pallas(self):
        """Route ``apply`` through the roll path instead of kernel K1 (the
        name is kept from the JAX package)."""
        self._pallas = False

    def enable_pallas(self):
        self._pallas = True

    # ------------------------------------------------------------------
    def apply(self, u):
        """A @ u, matrix-free.  2D all-periodic operators go through kernel
        K1 (its plain version on a CPU tensor; a complex field on its
        interleaved real view, as ParaDiag's state is); otherwise
        periodic axes use rolls and general axes one dense product each.
        The BC rhs vector is NOT included (matches the reference, which
        keeps b separate)."""
        if self._cross_terms is not None and self._pallas:
            from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

            return cross_stencil_2d(u, self._cross_terms)  # scale is in the taps
        offset = u.dim() - self.ndim  # support leading batch axes
        out = torch.zeros_like(u)
        for i, d in enumerate(self._dims):
            ax = d['axis'] + offset
            if d['kind'] == 'circulant':
                acc = torch.zeros_like(u)
                for c, s in zip(d['coeff'], d['offs']):
                    acc = acc + float(c) * torch.roll(u, -int(s), dims=ax)
                out = out + acc
            else:
                A = self._mat(f'A{i}', d['A'], u)
                out = out + torch.movedim(torch.tensordot(A, u, dims=([1], [ax])), 0, ax)
        return self.scale * out

    def _contract(self, name: str, mat: np.ndarray, x: torch.Tensor, ax: int) -> torch.Tensor:
        M = self._mat(name, mat, x)
        if M.is_complex() and not x.is_complex():
            x = x.to(M.dtype)
        return torch.movedim(torch.tensordot(M, x, dims=([1], [ax])), 0, ax)

    def _forward(self, x):
        """Transform to the operator's diagonal basis."""
        offset = x.dim() - self.ndim
        for i, d in enumerate(self._dims):
            ax = d['axis'] + offset
            if d['kind'] == 'circulant':
                x = torch.fft.fft(x, dim=ax)
            else:
                x = self._contract(f'Vinv{i}', d['Vinv'], x, ax)
        return x

    def _backward(self, x):
        offset = x.dim() - self.ndim
        for i, d in enumerate(self._dims):
            ax = d['axis'] + offset
            if d['kind'] == 'circulant':
                x = torch.fft.ifft(x, dim=ax)
            else:
                x = self._contract(f'V{i}', d['V'], x, ax)
        return x

    def solve_shifted(self, rhs, factor):
        """Exact direct solve of ``(I - factor * A) x = rhs``.

        ``factor`` is a float, or a tensor that broadcasts against the
        spectral grid (one shift per leading batch entry).  Real input on a
        real-symbol periodic operator takes the rfft path (half the spectral
        traffic)."""
        if self._rfft_ok and not rhs.is_complex():
            axes = tuple(range(rhs.dim() - self.ndim, rhs.dim()))
            rhat = torch.fft.rfftn(rhs, dim=axes)
            lam = self._const('lam_rfft', self._lam_rfft, rhs.dtype, rhs.device)
            denom = 1.0 - factor * self.scale * lam
            return torch.fft.irfftn(rhat / denom, s=self.shape, dim=axes)
        lam = self._mat('lam_nd', self._lam_nd, rhs)
        xhat = self._forward(rhs)
        xhat = xhat / (1.0 - factor * self.scale * lam)
        x = self._backward(xhat)
        if not rhs.is_complex() and x.is_complex():
            x = x.real
        return x.to(rhs.dtype).contiguous()

    def _krylov(self, kind, solve, rhs, factor, x0, tol, maxiter):
        x, info = solve(lambda x: x - factor * self.apply(x), rhs, x0, tol=tol, maxiter=maxiter)
        self.host_reads += info.reads
        if self.krylov_trace is not None:
            self.krylov_trace.append((kind, info.iterations, info.arnoldi))
        return x

    def solve_shifted_cg(self, rhs, factor, x0, tol=1e-12, maxiter=10000):
        """Iterative CG path (parity with reference solver_type='CG')."""
        return self._krylov('CG', cg, rhs, factor, x0, tol, maxiter)

    def solve_shifted_gmres(self, rhs, factor, x0, tol=1e-12, maxiter=100):
        """GMRES, restart 20, ``maxiter`` restarts (parity with reference solver_type='GMRES')."""
        return self._krylov('GMRES', gmres, rhs, factor, x0, tol, maxiter)

    @property
    def eigenvalues(self):
        """Full ND symbol (scaled) — useful for exact solutions/tests."""
        return self.scale * self._lam_nd

    # -- diagonal-basis interface (for the fused multi-sweep path) --------
    @property
    def diag_symbol(self):
        """Scaled symbol in the basis used by diag_forward (rfft-reduced
        when the operator is all-periodic with a real symbol), numpy."""
        return self.scale * (self._lam_rfft if self._rfft_ok else self._lam_nd)

    def diag_symbol_on(self, xhat):
        """``diag_symbol`` as a tensor on ``xhat``'s device in its precision
        (real when the symbol is real), made once and kept."""
        sym = self.diag_symbol
        cdtype = complex_dtype(xhat.dtype)
        dtype = cdtype if np.iscomplexobj(sym) else (torch.float32 if cdtype == torch.complex64 else torch.float64)
        return self._const('diag_rfft' if self._rfft_ok else 'diag_full', sym, dtype, xhat.device)

    def diag_forward(self, x):
        """Transform (trailing spatial axes; leading axes batch) to the
        operator's diagonal basis."""
        if self._rfft_ok and not x.is_complex():
            axes = tuple(range(x.dim() - self.ndim, x.dim()))
            return torch.fft.rfftn(x, dim=axes)
        return self._forward(x)

    def diag_backward(self, xhat, dtype, real: bool):
        if self._rfft_ok and real:
            axes = tuple(range(xhat.dim() - self.ndim, xhat.dim()))
            return torch.fft.irfftn(xhat, s=self.shape, dim=axes).to(dtype)
        x = self._backward(xhat)
        if real and x.is_complex():
            x = x.real
        return x.to(dtype)


class SpectralOperator:
    """Exact spectral differential operator on a periodic box.

    The counterpart of ``pysdc_tpu/ops/linop.py:SpectralOperator`` (reference
    ``generic_MPIFFT_Laplacian.py:10-177``): ``apply`` multiplies by the
    symbol in Fourier space, ``solve_shifted`` divides by ``1 - factor*symbol``
    (``torch.fft``, cuFFT on the card).  The symbol is kept in float64 (or
    complex128) on the host and meets a field in the field's own precision:
    float64 / complex128 on the CPU tests, the field's dtype on the card.

    Parameters
    ----------
    shape:     spatial grid shape.
    lengths:   box lengths per dimension (default 1.0 each).
    symbol_fn: maps the wavenumber grids (k_0, ..., k_{d-1}) to the symbol
               array (default the Laplacian, ``-sum k_i^2``).  Wavenumbers
               include the 2*pi/L factor.
    scale:     global prefactor.
    """

    def __init__(self, shape, symbol_fn=None, lengths=None, scale: float = 1.0):
        self.shape = tuple(shape)
        self.ndim = len(self.shape)
        self.scale = float(scale)
        self._consts: dict = {}
        lengths = (1.0,) * self.ndim if lengths is None else tuple(lengths)
        ks = [2.0 * np.pi * np.fft.fftfreq(n, d=1.0 / n) / L for n, L in zip(self.shape, lengths)]
        grids = np.meshgrid(*ks, indexing='ij')
        if symbol_fn is None:
            symbol_fn = lambda *k: -sum(ki**2 for ki in k)  # noqa: E731
        self.symbol = np.asarray(symbol_fn(*grids)) * self.scale
        self.nnz_per_dof = 2 * self.ndim + 1  # FD-equivalent accounting

    @property
    def symbol(self) -> np.ndarray:
        return self._symbol

    @symbol.setter
    def symbol(self, value):
        """A new symbol (a problem may shift it after construction) drops the tensors made of the old one."""
        self._symbol = np.asarray(value)
        self._consts = {}

    def _axes(self, u):
        return tuple(range(u.dim() - self.ndim, u.dim()))

    def _const(self, name, arr, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
        """``arr`` as a tensor of ``dtype`` on ``device``, made once and kept (the per-node shifts of a sweep)."""
        key = (name, dtype, device)
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = torch.as_tensor(np.asarray(arr), dtype=dtype, device=device)
        return t

    def symbol_on(self, x: torch.Tensor) -> torch.Tensor:
        """The symbol on ``x``'s device in ``x``'s precision (complex where the symbol is), made once and kept."""
        if np.iscomplexobj(self._symbol):
            dtype = complex_dtype(x.dtype)
        else:
            dtype = torch.float32 if x.dtype in (torch.float32, torch.complex64) else torch.float64
        key = (dtype, x.device)
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = torch.as_tensor(self._symbol, dtype=dtype, device=x.device)
        return t

    @staticmethod
    def _back(x, like):
        return (x.real if not like.is_complex() else x).to(like.dtype)

    def apply(self, u):
        axes = self._axes(u)
        out = torch.fft.ifftn(torch.fft.fftn(u, dim=axes) * self.symbol_on(u), dim=axes)
        return self._back(out, u)

    def solve_shifted(self, rhs, factor):
        """Exact solve of ``(I - factor * symbol) x = rhs``; ``factor`` a number or a tensor that broadcasts
        against the grid (one shift per leading batch entry)."""
        axes = self._axes(rhs)
        xhat = torch.fft.fftn(rhs, dim=axes) / (1.0 - factor * self.symbol_on(rhs))
        return self._back(torch.fft.ifftn(xhat, dim=axes), rhs)

    # -- diagonal-basis interface (ops/diag_sdc.py) --
    @property
    def diag_symbol(self):
        return self._symbol

    def diag_symbol_on(self, xhat):
        return self.symbol_on(xhat)

    def diag_forward(self, x):
        return torch.fft.fftn(x, dim=self._axes(x))

    def diag_backward(self, xhat, dtype, real: bool):
        x = torch.fft.ifftn(xhat, dim=self._axes(xhat))
        if real:
            x = x.real
        return x.to(dtype)
