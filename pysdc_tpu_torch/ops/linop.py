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
  - the order-2 Dirichlet second difference on a uniform grid,
    ``c tridiag(1, -2, 1)``: its orthonormal eigenvectors are the DST-I basis
    ``sqrt(2/(n+1)) sin(pi j k/(n+1))`` and its eigenvalues
    ``-4c sin^2(pi k/(2(n+1)))``, so solves transform by an FFT of length
    ``n+1`` of the axis's odd extension and keep no eigen tables.  On the card
    a 2D operator of two such axes solves by the sine kernels
    (:func:`pysdc_tpu_torch.ops.kernels.sine.sine_solve_2d`): the DST-I along
    y by cuFFT, a tridiagonal sweep along x for each sine mode.
  - other general dims (Dirichlet/Neumann): A_d = V_d L_d V_d^{-1}
    eigen-factorized once on the host; applies and solves become dense
    per-axis products.

``(I - factor*A) x = rhs`` for any scalar ``factor`` (including 0) is thus
one transform, one elementwise divide, one inverse transform.  Constant
tensors are made once per (dtype, device) and kept.  The iterative solves of
``solver_type='CG'|'GMRES'`` are ``jax.scipy``'s CG and GMRES
(:mod:`pysdc_tpu_torch.ops.krylov`) on the shifted apply.
:class:`SpectralOperator` is the exact Fourier operator of the spectral
models (cuFFT on the card).  On a mesh whose 'space' axis is sharded,
:meth:`SeparableFDOperator.enable_halo` routes the applies through the halo
exchange of :mod:`pysdc_tpu_torch.ops.halo` (one K1 launch per slab).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pysdc_tpu_torch.core.device import complex_dtype
from pysdc_tpu_torch.core.errors import ProblemError
from pysdc_tpu_torch.ops.fd import fd_matrix_1d, get_finite_difference_stencil, stencil_symbol
from pysdc_tpu_torch.ops.kernels.build import differentiated
from pysdc_tpu_torch.ops.kernels.sine import dst_rows
from pysdc_tpu_torch.ops.krylov import cg, gmres
from pysdc_tpu_torch.utils import trace


def second_difference_scale(A1: np.ndarray):
    """``c`` where ``A1`` is ``c tridiag(1, -2, 1)`` to 1e-14 of ``max |A1|`` (the order-2 Dirichlet second
    difference on a uniform grid), else ``None``."""
    n = A1.shape[0]
    c = -0.5 * A1[0, 0]
    T = c * (np.eye(n, k=-1) - 2.0 * np.eye(n) + np.eye(n, k=1))
    if c == 0 or np.max(np.abs(A1 - T)) > 1e-14 * np.max(np.abs(A1)):
        return None
    return c


def sine_transform(x: torch.Tensor, axis: int, cs: torch.Tensor, sn: torch.Tensor) -> torch.Tensor:
    """The orthonormal DST-I along ``axis`` (its own inverse), in ``x``'s precision:
    ``sqrt(2/(n+1)) sum_j x_j sin(pi j k/(n+1))`` for ``j, k = 1..n``, by the sine kernels' transform
    (:func:`pysdc_tpu_torch.ops.kernels.sine.dst_rows`: a complex FFT of length ``n+1`` of the odd extension, then
    its split); ``(cs, sn)`` ``(n,)`` hold the cosine and sine of ``pi k/(n+1)`` in ``x``'s real precision."""
    if x.is_complex():
        return torch.complex(sine_transform(x.real, axis, cs, sn), sine_transform(x.imag, axis, cs, sn))
    n = x.shape[axis]
    return dst_rows(x.movedim(axis, -1), cs, sn, math.sqrt(2.0 / (n + 1))).movedim(-1, axis)


def _eigen_tables(A1: np.ndarray, axis: int) -> dict:
    """``lam``, ``V`` and ``Vinv`` with ``A1 = V diag(lam) Vinv``, made once on the host."""
    if np.allclose(A1, A1.T, atol=1e-14 * np.max(np.abs(A1))):
        # symmetric: orthogonal eigenbasis, V^{-1} = V^T exactly — no
        # conditioning loss
        lam, V = np.linalg.eigh(A1)
        return dict(lam=lam, V=V, Vinv=V.T)
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
    return dict(lam=lam, V=V, Vinv=Vinv)


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
    counts their loops' reads.  A non-periodic axis whose matrix is the
    order-2 Dirichlet second difference (:func:`second_difference_scale`)
    takes the sine transform; every other one the dense eigen product.  With
    tracing on (:mod:`pysdc_tpu_torch.utils.trace`), each solve off the rfft
    path of an operator with a non-periodic axis tallies
    ``separable.eigen_solves``, ``separable.sine_solves`` where every such
    axis is a sine axis, and ``separable.sine_kernel_solves`` where the sine
    kernels served it.
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
                c = second_difference_scale(A1)
                if c is not None:
                    # the DST-I's mode order k = 1..n; no eigen tables
                    angle = np.pi * np.arange(1, size + 1) / (size + 1)
                    self._dims.append(dict(kind='sine', axis=axis, A=A1, lam=-4.0 * c * np.sin(angle / 2) ** 2, c=c,
                                           cs=np.cos(angle), sn=np.sin(angle)))
                else:
                    self._dims.append(dict(kind='dense', axis=axis, A=A1, **_eigen_tables(A1, axis)))
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
        self._all_sine = not self.all_periodic and all(d['kind'] in ('circulant', 'sine') for d in self._dims)
        # 2D with both axes sine and scale A negative definite (so that each mode's system is positive definite for
        # a shift >= 0, which the sweep needs: it does not pivot): the sine kernels' solve on the card (the x axis's
        # scale, the y axis's tables)
        self._sine_2d = None
        if self.ndim == 2 and all(d['kind'] == 'sine' and self.scale * d['c'] > 0 for d in self._dims):
            x_dim, y_dim = self._dims
            self._sine_2d = dict(cx=x_dim['c'], **{k: y_dim[k] for k in ('lam', 'cs', 'sn')})
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
        self._halo = None  # (mesh, axis) of the halo apply

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

    def enable_halo(self, mesh, axis: str = 'space'):
        """Space-decomposed apply: the field's first axis cut into one slab
        for each position along ``axis``, one ``rx``-deep halo copy each way
        and one K1 launch per slab
        (:func:`~pysdc_tpu_torch.ops.halo.halo_cross_apply_batched`).  For 2D
        all-periodic operators."""
        if self._cross_terms is None:
            raise ProblemError('halo apply needs a 2D all-periodic cross-stencil operator')
        self._halo = (mesh, axis)

    def disable_halo(self):
        self._halo = None

    # ------------------------------------------------------------------
    def apply(self, u):
        """A @ u, matrix-free.  2D all-periodic operators go through kernel
        K1 (its plain version on a CPU tensor; a complex field on its
        interleaved real view, as ParaDiag's state is); otherwise
        periodic axes use rolls and general axes one dense product each.
        The BC rhs vector is NOT included (matches the reference, which
        keeps b separate).  With :meth:`enable_halo`, a real field applies
        slab by slab over the mesh's space positions."""
        if self._halo is not None and not u.is_complex() and u.dim() >= 2:
            from pysdc_tpu_torch.ops.halo import halo_cross_apply_batched

            mesh, axis = self._halo
            return halo_cross_apply_batched(u, mesh, self._cross_terms, axis=axis)
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

    def _sine(self, i: int, d: dict, x: torch.Tensor, ax: int) -> torch.Tensor:
        real = x.real.dtype
        cs, sn = (self._const(f'{k}{i}', d[k], real, x.device) for k in ('cs', 'sn'))
        return sine_transform(x, ax, cs, sn)

    def _forward(self, x):
        """Transform to the operator's diagonal basis."""
        offset = x.dim() - self.ndim
        for i, d in enumerate(self._dims):
            ax = d['axis'] + offset
            if d['kind'] == 'circulant':
                x = torch.fft.fft(x, dim=ax)
            elif d['kind'] == 'sine':
                x = self._sine(i, d, x, ax)
            else:
                x = self._contract(f'Vinv{i}', d['Vinv'], x, ax)
        return x

    def _backward(self, x):
        offset = x.dim() - self.ndim
        for i, d in enumerate(self._dims):
            ax = d['axis'] + offset
            if d['kind'] == 'circulant':
                x = torch.fft.ifft(x, dim=ax)
            elif d['kind'] == 'sine':
                x = self._sine(i, d, x, ax)
            else:
                x = self._contract(f'V{i}', d['V'], x, ax)
        return x

    def solve_shifted(self, rhs, factor):
        """Exact direct solve of ``(I - factor * A) x = rhs``.

        ``factor`` is a float, or a tensor that broadcasts against the
        spectral grid (one shift per leading batch entry).  Real input on a
        real-symbol periodic operator takes the rfft path (half the spectral
        traffic); a real 2D field on the card of an operator whose two axes
        take the sine transform, with one real shift for each leading batch
        entry, takes the sine kernels (:meth:`_sine_kernel_solve`).  There a
        tensor ``factor`` has to be ``>= 0``, as the sweepers' and the PCG
        preconditioner's ``dt * qdelta`` shifts are: its sign is not read on
        the host, and the kernels' sweep does not pivot."""
        if self._rfft_ok and not rhs.is_complex():
            axes = tuple(range(rhs.dim() - self.ndim, rhs.dim()))
            rhat = torch.fft.rfftn(rhs, dim=axes)
            lam = self._const('lam_rfft', self._lam_rfft, rhs.dtype, rhs.device)
            denom = 1.0 - factor * self.scale * lam
            return torch.fft.irfftn(rhat / denom, s=self.shape, dim=axes)
        if not self.all_periodic:
            trace.tally('separable.eigen_solves', rhs)
            if self._all_sine:
                trace.tally('separable.sine_solves', rhs)
        if self._sine_2d is not None and rhs.is_cuda:
            x = self._sine_kernel_solve(rhs, factor)
            if x is not None:
                return x
        lam = self._mat('lam_nd', self._lam_nd, rhs)
        x = self._backward(self._forward(rhs) / (1.0 - factor * self.scale * lam))
        if not rhs.is_complex() and x.is_complex():
            x = x.real
        return x.to(rhs.dtype).contiguous()

    def _sine_kernel_solve(self, rhs, factor):
        """The solve by the sine kernels, or ``None`` where they do not apply: a complex or differentiated field, a
        complex shift, a shift that varies over the grid or widens the field's batch, an array, or a negative number
        (the sweep does not pivot, so a shift has to leave each mode's system positive definite; a tensor's sign is
        not read on the host, see :meth:`solve_shifted`).  Each solve it serves tallies
        ``separable.sine_kernel_solves``."""
        from pysdc_tpu_torch.ops.kernels.sine import sine_solve_2d

        if rhs.is_complex() or rhs.dtype not in (torch.float32, torch.float64) or differentiated(rhs):
            return None
        lead = rhs.shape[:-2]
        if torch.is_tensor(factor):
            if factor.is_complex() or factor.dim() > rhs.dim() or differentiated(factor):
                return None
            shape = (1,) * (rhs.dim() - factor.dim()) + tuple(factor.shape)
            # compared by hand: torch.broadcast_shapes imports sympy (seconds) on its first call
            if shape[-2:] != (1, 1) or any(f not in (1, n) for f, n in zip(shape[:-2], lead)):
                return None
            shifts = factor.reshape(shape[:-2]).expand(lead).reshape(-1)
        else:
            if np.ndim(factor) or np.iscomplexobj(factor) or factor < 0:
                return None
            shifts = float(factor)
        t = self._sine_2d
        lam, cs, sn = (self._const(f'{k}1', t[k], rhs.dtype, rhs.device) for k in ('lam', 'cs', 'sn'))  # y's
        x = sine_solve_2d(rhs.reshape((-1,) + self.shape), shifts, self.scale, t['cx'], lam, cs, sn)
        trace.tally('separable.sine_kernel_solves', rhs)
        return x.reshape(rhs.shape)

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
