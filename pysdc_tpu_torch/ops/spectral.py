"""Spectral bases and generic tensor-product linear problems on tensors.

The counterpart of ``pysdc_tpu/ops/spectral.py`` (reference
``helpers/spectral_helper.py``: ChebychevHelper, UltrasphericalHelper,
FFTHelper, SpectralHelper with ``add_axis``/``add_component``/``add_BC``/
``put_BCs_in_matrix``, and ``generic_spectral.py``: GenericSpectralLinear):

  - **Arbitrary tensor products.**  :class:`TensorProductSpectral` accepts
    any ordered mix of Fourier and ultraspherical axes.  Fourier axes stay
    diagonal and become one flattened, batched *mode* axis; all
    ultraspherical axes are Kronecker-coupled into dense per-mode blocks.
    The implicit solve is one batched
    :func:`pysdc_tpu_torch.ops.linalg.solve` over the modes (no error flag
    read on the host, a route that a CUDA graph capture takes: LAPACK's
    ``solve_ex`` on the CPU; on the card cuBLAS's batched LU below 512 rows
    a mode and the pivoted blocked LU with its panel kernel from 512 on);
    ``dt`` may be a float or a device tensor.
  - **One LU a collocation node, kept.**  A solve that names its node
    (``solve_shifted(rhs, factor, node=m)``, what a sweeper's node loop
    passes) keeps the factors of ``M + factor L`` in that node's slot, on the
    field's device, with the ``factor`` they were made from, and only
    substitutes while ``factor`` stays the same: the reference's
    ``GenericSpectralLinear`` keeps its LU factorizations keyed by ``dt``
    (``cached_direct``).  The check is made where ``factor`` lives: a host
    float on the host; a device tensor (the fused lanes' graphs read ``dt``,
    they do not hold it) on the device, as a device ``while`` of at most one
    trip that forms the operator into the slot, factors it in place and
    writes the new shift, so that a replay at an unchanged ``dt`` runs no
    trip.  The factors come from the same operator through the same
    kernels, so a slot's solve equals a fresh one bit for bit.  A solve
    without a node, with a factor that is not one real number, or under
    autograd factors afresh and keeps nothing.
  - **Automatic ultraspherical basis conversion.**  Operator terms are
    declared as derivative orders per axis; the engine computes the row
    basis C^(lambda) per (equation, axis) as the highest derivative order
    appearing in that equation and inserts the Olver--Townsend conversion
    ladders itself.
  - Chebyshev transforms are dense cosine matrices applied with
    ``tensordot``; Fourier transforms are ``torch.fft`` (cuFFT on the card).
  - Boundary conditions are declarative tau lines
    (:meth:`TensorProductSpectral.add_BC`: ``dirichlet``/``neumann``/
    ``integral``/raw row on any ultraspherical axis, with the reference's
    scalar-mode handling, spectral_helper.py:1275-1545): rows of
    (M + dt L) are masked and replaced at assembly time.

The operators are assembled on the host in numpy, once, exactly as in the JAX
package; each meets a field as a tensor in the field's complex precision on
its device, made once and kept.  A state is ``(C, N_0, N_1, ...)`` in axis
declaration order, with any leading batch axes in front (the nodes of a sweep,
the steps of a block): the transforms and solves count their axes from the end.
"""

from __future__ import annotations

import math
import numbers

import numpy as np
import torch

from pysdc_tpu_torch.core.device import cached_tensor
from pysdc_tpu_torch.ops import graph_loop, linalg, loops
from pysdc_tpu_torch.ops.kernels.build import differentiated
from pysdc_tpu_torch.utils import trace

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128,
            torch.complex64: torch.complex64, torch.complex128: torch.complex128}


def _along(mat: torch.Tensor, u: torch.Tensor, axis: int) -> torch.Tensor:
    """``mat`` (an (N', N) matrix) applied along ``axis`` of ``u``."""
    return torch.movedim(torch.tensordot(mat, u, dims=([1], [axis])), 0, axis)


def _zeros_along(u, axis, n):
    shape = list(u.shape)
    shape[axis] = n
    return torch.zeros(shape, dtype=u.dtype, device=u.device)


class FourierBase1D:
    """Periodic Fourier basis on [x0, x1)."""

    kind = 'fft'

    def __init__(self, N, x0=0.0, x1=1.0):
        self.N = N
        self.x0, self.x1 = float(x0), float(x1)
        self.L = self.x1 - self.x0
        self.nodes = self.x0 + np.arange(N) * self.L / N
        self.k = 2 * np.pi * np.fft.fftfreq(N, d=1.0 / N) / self.L

    def transform(self, u, axis):
        return torch.fft.fft(u, dim=axis, norm='forward')

    def itransform(self, u_hat, axis):
        return torch.fft.ifft(u_hat, dim=axis, norm='forward')

    def pad(self, u_hat, axis, factor):
        """Zero-pad the spectrum for dealiasing (3/2-rule)."""
        N = self.N
        Np = int(np.ceil(N * factor))
        lo = (Np - N) // 2
        u_shifted = torch.fft.fftshift(u_hat, dim=axis)
        padded = torch.cat([_zeros_along(u_hat, axis, lo), u_shifted, _zeros_along(u_hat, axis, Np - N - lo)],
                           dim=axis)
        return torch.fft.ifftshift(padded, dim=axis)

    def unpad(self, u_hat_pad, axis, factor):
        N = self.N
        Np = u_hat_pad.shape[axis]
        u_shifted = torch.fft.fftshift(u_hat_pad, dim=axis)
        return torch.fft.ifftshift(u_shifted.narrow(axis, (Np - N) // 2, N), dim=axis)

    def nyquist_index(self):
        return self.N // 2 if self.N % 2 == 0 else None


class UltrasphericalBase1D:
    """Chebyshev-T basis with ultraspherical differentiation on [x0, x1].

    Nodes are Chebyshev-Gauss points; transforms are dense cosine products.
    ``diff_matrix(p)`` maps T coefficients to C^(p) coefficients;
    ``conv_matrix(a, b)`` converts C^(a) -> C^(b) (a < b; T == C^(0) here,
    with the usual convention that "C^(0)" means the T basis).
    """

    kind = 'ultraspherical'

    def __init__(self, N, x0=-1.0, x1=1.0):
        self.N = N
        self.x0, self.x1 = float(x0), float(x1)
        self.L = self.x1 - self.x0
        # map reference x in [-1, 1] -> physical
        i = np.arange(N)
        theta = (2 * i + 1) * np.pi / (2 * N)
        self.x_ref = np.cos(theta)[::-1]  # ascending
        self.nodes = self.x0 + (self.x_ref + 1) / 2 * self.L
        # forward transform matrix: values at nodes -> T coefficients
        n = np.arange(N)
        C = np.cos(np.outer(n, np.arccos(self.x_ref)))  # C[n, i] = T_n(x_i)
        w = np.full(N, 2.0 / N)
        w[0] = 1.0 / N
        self._fwd = (C * w[:, None])  # a = fwd @ v
        self._bwd = C.T  # v = bwd @ a
        self._consts: dict = {}

    # -- transforms ------------------------------------------------------
    def transform(self, u, axis):
        return _along(cached_tensor(self._consts, 'fwd', lambda: self._fwd, u), u, axis)

    def itransform(self, u_hat, axis):
        return _along(cached_tensor(self._consts, 'bwd', lambda: self._bwd, u_hat), u_hat, axis)

    def pad(self, u_hat, axis, factor):
        Np = int(np.ceil(self.N * factor))
        return torch.cat([u_hat, _zeros_along(u_hat, axis, Np - self.N)], dim=axis)

    def padded_itransform_matrix(self, factor):
        """Backward transform evaluating padded coefficients on a finer
        Chebyshev grid (for dealiased products)."""
        Np = int(np.ceil(self.N * factor))
        i = np.arange(Np)
        theta = (2 * i + 1) * np.pi / (2 * Np)
        x = np.cos(theta)[::-1]
        n = np.arange(Np)
        return np.cos(np.outer(np.arccos(x), n))  # (Np, Np): v_pad = B @ a_pad

    def padded_transform_matrix(self, factor):
        Np = int(np.ceil(self.N * factor))
        i = np.arange(Np)
        theta = (2 * i + 1) * np.pi / (2 * Np)
        x = np.cos(theta)[::-1]
        n = np.arange(Np)
        C = np.cos(np.outer(n, np.arccos(x)))
        w = np.full(Np, 2.0 / Np)
        w[0] = 1.0 / Np
        return C * w[:, None]  # (Np, Np): a_pad = F @ v_pad

    # -- ultraspherical ladders (Olver & Townsend 2013) ------------------
    def diff_matrix(self, p=1):
        """d^p/dx^p : T -> C^(p); D[n-p, n] = 2^(p-1) (p-1)! n, scaled by
        the domain map (2/L)^p."""
        N = self.N
        D = np.zeros((N, N))
        for n in range(p, N):
            D[n - p, n] = 2.0 ** (p - 1) * math.factorial(p - 1) * n
        return D * (2.0 / self.L) ** p

    def conv_matrix(self, a=0, b=1):
        """Conversion C^(a) -> C^(b) for a <= b (a=0 means the T basis)."""
        N = self.N
        out = np.eye(N)
        for lam in range(a, b):
            S = np.zeros((N, N))
            if lam == 0:
                S[0, 0] = 1.0
                for n in range(1, N):
                    S[n, n] = 0.5
                for n in range(0, N - 2):
                    S[n, n + 2] = -0.5
            else:
                for n in range(N):
                    S[n, n] = lam / (n + lam)
                for n in range(0, N - 2):
                    S[n, n + 2] = -lam / (n + 2 + lam)
            out = S @ out
        return out

    def ladder_matrix(self, p, lam):
        """T-coefficient matrix for d^p/dx^p expressed in the C^(lam) row
        basis (p <= lam): conv(p, lam) @ diff(p)."""
        if p == 0:
            return self.conv_matrix(0, lam)
        mat = self.diff_matrix(p)
        if p < lam:
            mat = self.conv_matrix(p, lam) @ mat
        return mat

    def deriv_natural(self, p=1):
        """d^p/dx^p as a T -> T matrix (inverse-ladder back to Chebyshev-T;
        convenient for explicit derivative evaluation)."""
        return np.linalg.solve(self.conv_matrix(0, p), self.diff_matrix(p))

    # -- boundary rows ---------------------------------------------------
    def dirichlet_row(self, x):
        """Row evaluating a T series at physical x (x0 or x1 typically)."""
        x_ref = 2 * (x - self.x0) / self.L - 1.0
        n = np.arange(self.N)
        return np.cos(n * np.arccos(np.clip(x_ref, -1, 1)))

    def neumann_row(self, x):
        """Row evaluating the first derivative of a T series at physical x:
        T_n'(x) = n U_{n-1}(x), with U_{n-1}(cos t) = sin(n t)/sin(t) and
        T_n'(+-1) = (+-1)^(n+1) n^2; scaled by the domain map 2/L."""
        x_ref = float(np.clip(2 * (x - self.x0) / self.L - 1.0, -1.0, 1.0))
        n = np.arange(self.N)
        if x_ref >= 1.0:
            row = n.astype(float) ** 2
        elif x_ref <= -1.0:
            row = (-1.0) ** (n + 1) * n**2
        else:
            t = np.arccos(x_ref)
            row = n * np.sin(n * t) / np.sin(t)
        return row * (2.0 / self.L)

    def integral_row(self):
        """Row computing the integral of a T series over the domain."""
        n = np.arange(self.N)
        row = np.zeros(self.N)
        even = n % 2 == 0
        row[even] = 2.0 / (1.0 - n[even] ** 2)
        return row * self.L / 2.0


class _FactorSlot:
    """The LU factors of one collocation node's shifted operator, kept on the field's device: ``LU`` and ``pivots``
    as :func:`pysdc_tpu_torch.ops.linalg.lu_factor` made them, and ``shift`` (a float64 0-d tensor beside them) the
    factor they were made from.  While only host floats have met the slot, ``known`` is ``shift`` on the host; once
    a tensor has (a graph may write ``shift`` at any replay), ``known`` is ``None`` for good and the host reads
    ``shift``."""

    def __init__(self, LU, pivots, shift, known):
        self.LU, self.pivots, self.shift, self.known = LU, pivots, shift, known


class TensorProductSpectral:
    """Generic ``M u_t + L u = rhs`` problems on arbitrary tensor products
    of Fourier and ultraspherical axes with several components.

    Counterpart of the reference ``SpectralHelper``
    (helpers/spectral_helper.py:1054-2096) + ``GenericSpectralLinear``
    (generic_spectral.py:8-567).  Usage::

        spec = TensorProductSpectral()
        spec.add_axis('x', FourierBase1D(nx, 0, Lx))
        spec.add_axis('z', UltrasphericalBase1D(nz, 0, Lz))
        spec.add_component('u', 'p')
        spec.add_L_term('u', 'p', derivs={'x': 1})           # dp/dx
        spec.add_L_term('u', 'u', coeff=-nu, derivs={'z': 2})  # -nu u_zz
        spec.add_M_term('u', 'u')
        spec.add_BC('u', 'u', axis='z', kind='dirichlet', x=0.0, v=1.0, line=-1)
        spec.setup()

    State layout: ``(C, N_axis0, N_axis1, ...)`` in axis declaration order.
    Fourier axes are flattened into one batched *mode* axis; ultraspherical
    axes couple into dense blocks of size ``C * prod(N_ultra)``.  Basis
    conversion for the ultraspherical method is automatic: each equation
    row lives in C^(lambda) per axis, lambda = max derivative order among
    its L and M terms, and every term gets the appropriate conversion
    ladder.
    """

    def __init__(self):
        self.axis_names: list[str] = []
        self.bases: list = []
        self.components: list[str] = []
        self._L_terms: list[dict] = []
        self._M_terms: list[dict] = []
        self._bcs: list[dict] = []
        self._ready = False
        self._consts: dict = {}
        self._slots: dict = {}  # (node, complex dtype, device) -> _FactorSlot

    # -- declaration ------------------------------------------------------
    def add_axis(self, name, base):
        assert not self._ready, 'cannot add axes after setup()'
        assert name not in self.axis_names, f'duplicate axis {name!r}'
        self.axis_names.append(name)
        self.bases.append(base)
        return base

    def add_component(self, *names):
        assert not self._ready, 'cannot add components after setup()'
        for n in names:
            assert n not in self.components, f'duplicate component {n!r}'
            self.components.append(n)

    def index(self, comp):
        if isinstance(comp, (list, tuple)):
            return [self.components.index(c) for c in comp]
        return self.components.index(comp)

    def axis_index(self, name):
        return self.axis_names.index(name)

    def basis(self, name):
        return self.bases[self.axis_index(name)]

    def _add_term(self, store, equation, component, coeff, derivs, axis_mats):
        derivs = dict(derivs or {})
        axis_mats = {k: np.asarray(v) for k, v in (axis_mats or {}).items()}
        for a in list(derivs) + list(axis_mats):
            assert a in self.axis_names, f'unknown axis {a!r}'
            if a in axis_mats:
                assert derivs.get(a, 0) == 0, (
                    f'axis {a!r}: give either a derivative order or a natural '
                    f'T->T matrix, not both'
                )
        for a, p in derivs.items():
            if self.basis(a).kind == 'fft':
                continue
            assert p >= 0
        store.append(dict(equation=equation, component=component,
                          coeff=complex(coeff), derivs=derivs, axis_mats=axis_mats))

    def add_L_term(self, equation, component, coeff=1.0, derivs=None, axis_mats=None):
        """One additive term of L: ``coeff * prod_axes d^p/daxis^p`` acting
        on ``component``, entering equation row ``equation``.  ``axis_mats``
        supplies a natural (T -> T) matrix for an ultraspherical axis
        instead of a derivative (escape hatch for non-derivative couplings);
        it is converted to the row basis automatically."""
        self._add_term(self._L_terms, equation, component, coeff, derivs, axis_mats)

    def add_M_term(self, equation, component, coeff=1.0, derivs=None, axis_mats=None):
        """One additive term of the mass matrix M (usually the identity)."""
        self._add_term(self._M_terms, equation, component, coeff, derivs, axis_mats)

    def add_BC(self, component, equation, axis, kind, x=None, v=0.0, line=-1,
               scalar=False, skip_scalar=False, row=None):
        """Declarative tau line replacing coefficient line ``line`` of
        ``equation``'s block along ultraspherical ``axis``.

        kind: 'dirichlet' (value at ``x``), 'neumann' (derivative at ``x``),
        'integral' (integral over the axis domain), or 'row' with an
        explicit length-N coefficient row.  ``v`` enters the rhs at the
        zero Fourier mode.  ``scalar`` restricts the row to the zero mode,
        ``skip_scalar`` to every mode except zero (the reference's
        add_BC/remove_BC scalar dance, spectral_helper.py:1346-1428)."""
        base = self.basis(axis)
        assert base.kind == 'ultraspherical', 'BCs attach to non-periodic axes'
        if kind == 'dirichlet':
            row = base.dirichlet_row(x)
        elif kind == 'neumann':
            row = base.neumann_row(x)
        elif kind == 'integral':
            row = base.integral_row()
        elif kind == 'row':
            assert row is not None
        else:
            raise ValueError(f'unknown BC kind {kind!r}')
        self._bcs.append(dict(component=component, equation=equation, axis=axis,
                              row=np.asarray(row, complex), value=v, line=line,
                              scalar=scalar, skip_scalar=skip_scalar))

    # -- assembly ---------------------------------------------------------
    def _row_basis_orders(self):
        """lambda[equation][axis] = max derivative order over L+M terms."""
        lam = {e: {a: 0 for a in self.axis_names} for e in self.components}
        for term in self._L_terms + self._M_terms:
            for a, p in term['derivs'].items():
                if self.basis(a).kind == 'ultraspherical':
                    lam[term['equation']][a] = max(lam[term['equation']][a], p)
        return lam

    def _term_block(self, term, lam):
        """Constant Kronecker block (C*cd, C*cd) and per-mode Fourier factor
        (nmodes,) for one term."""
        C = len(self.components)
        cd = self._coupled_dim
        ie, ic = self.index(term['equation']), self.index(term['component'])
        # Fourier factor over the flattened mode axis
        fac = np.full(self._nmodes, term['coeff'], dtype=complex)
        for fpos, ai in enumerate(self._fourier_axes):
            p = term['derivs'].get(self.axis_names[ai], 0)
            if p > 0:
                fac = fac * (1j * self._mode_k[:, fpos]) ** p
        # Kronecker product over ultraspherical axes, in axis order
        kron = np.ones((1, 1))
        for ai in self._ultra_axes:
            name = self.axis_names[ai]
            base = self.bases[ai]
            lam_a = lam[term['equation']][name]
            if name in term['axis_mats']:
                mat = base.conv_matrix(0, lam_a) @ term['axis_mats'][name]
            else:
                mat = base.ladder_matrix(term['derivs'].get(name, 0), lam_a)
            kron = np.kron(kron, mat)
        block = np.zeros((C * cd, C * cd), dtype=complex)
        block[ie * cd : (ie + 1) * cd, ic * cd : (ic + 1) * cd] = kron
        return fac, block

    def setup(self):
        """Build stacked per-mode matrices + BC masks (host, once)."""
        assert not self._ready
        C = len(self.components)
        self._fourier_axes = [i for i, b in enumerate(self.bases) if b.kind == 'fft']
        self._ultra_axes = [i for i, b in enumerate(self.bases) if b.kind == 'ultraspherical']
        self._coupled_dim = int(np.prod([self.bases[i].N for i in self._ultra_axes], dtype=int))
        # flattened Fourier mode table, shape (nmodes, n_fourier_axes)
        ks = [self.bases[i].k for i in self._fourier_axes]
        if ks:
            self._mode_k = np.stack(np.meshgrid(*ks, indexing='ij'), axis=-1).reshape(-1, len(ks))
        else:
            self._mode_k = np.zeros((1, 0))
        self._nmodes = len(self._mode_k)
        cd, D = self._coupled_dim, C * self._coupled_dim

        lam = self._row_basis_orders()
        self._lam = lam

        L_all = np.zeros((self._nmodes, D, D), dtype=complex)
        M_all = np.zeros((self._nmodes, D, D), dtype=complex)
        for store, dest in ((self._L_terms, L_all), (self._M_terms, M_all)):
            for term in store:
                fac, block = self._term_block(term, lam)
                dest += fac[:, None, None] * block[None]

        zero_mode = 0 if self._nmodes == 1 else int(
            np.where((self._mode_k == 0).all(axis=1))[0][0]
        )
        self.zero_mode = zero_mode

        # BC machinery: keep_mask zeroes replaced lines; bc_rows holds the
        # constant rows; bc_rhs the per-mode right-hand-side values.  A BC
        # on axis `a` at coefficient line l claims, for every index of the
        # other coupled axes, the row (.., i_other, l, ..); already-claimed
        # rows (tau corners with several non-periodic axes) stay with the
        # first BC that claimed them.
        keep = np.ones((self._nmodes, D), dtype=bool)
        bc_rows = np.zeros((self._nmodes, D, D), dtype=complex)
        bc_rhs = np.zeros((self._nmodes, D), dtype=complex)
        ushapes = [self.bases[i].N for i in self._ultra_axes]
        for bc in self._bcs:
            ie, ic = self.index(bc['equation']), self.index(bc['component'])
            upos = self._ultra_axes.index(self.axis_index(bc['axis']))
            N_a = ushapes[upos]
            line = bc['line'] % N_a
            if bc['scalar']:
                modes = [zero_mode]
            elif bc['skip_scalar']:
                modes = [m for m in range(self._nmodes) if m != zero_mode]
            else:
                modes = range(self._nmodes)
            # all coupled-row indices with axis `upos` pinned at `line`
            ranges = [np.arange(n) if q != upos else np.asarray([line]) for q, n in enumerate(ushapes)]
            all_idx = np.stack(np.meshgrid(*ranges, indexing='ij'), axis=-1).reshape(-1, len(ushapes))
            for idx in all_idx:
                flat = 0
                for q, n in enumerate(ushapes):
                    flat = flat * n + int(idx[q])
                row_idx = ie * cd + flat
                # the BC row: e_{i_other} kron'd with the coefficient row
                full_row = np.ones(1, dtype=complex)
                for q, n in enumerate(ushapes):
                    if q == upos:
                        full_row = np.kron(full_row, bc['row'])
                    else:
                        e = np.zeros(n, dtype=complex)
                        e[int(idx[q])] = 1.0
                        full_row = np.kron(full_row, e)
                # rhs: value is constant along the other coupled axes ->
                # only their 0-th coefficient (T_0 = 1) carries it
                carries_value = all(int(idx[q]) == 0 for q in range(len(ushapes)) if q != upos)
                for m in modes:
                    if not keep[m, row_idx]:
                        continue  # tau corner: first claim wins
                    keep[m, row_idx] = False
                    bc_rows[m, row_idx, ic * cd : (ic + 1) * cd] = full_row
                    if m == zero_mode and carries_value:
                        bc_rhs[m, row_idx] = bc['value']

        # Nyquist modes of even Fourier axes: project out entirely
        # (the reference eliminates them, spectral_helper.py:1031-1043)
        for fpos, ai in enumerate(self._fourier_axes):
            nyq = self.bases[ai].nyquist_index()
            if nyq is None:
                continue
            k_nyq = self.bases[ai].k[nyq]
            hit = self._mode_k[:, fpos] == k_nyq
            keep[hit, :] = False
            bc_rows[hit] = np.eye(D)
            bc_rhs[hit] = 0.0

        # the assemblies stay numpy; each meets a field as a tensor in its
        # complex precision on its device (:meth:`_dev`), made once and kept
        self.L_all = np.asarray(L_all)
        self.M_all = np.asarray(M_all)
        self.keep_mask = keep
        self.bc_rows = np.asarray(bc_rows)
        self.bc_rhs_vec = np.asarray(bc_rhs)

        # natural-basis (Chebyshev-T rows) version of L, for eval_f:
        # row e is converted back by kron of inv(conv(0, lambda_{e,a}))
        S_inv_diag = np.zeros((D, D), dtype=complex)
        for e in self.components:
            ie = self.index(e)
            S = np.ones((1, 1))
            for ai in self._ultra_axes:
                name = self.axis_names[ai]
                S = np.kron(S, np.linalg.inv(self.bases[ai].conv_matrix(0, lam[e][name])))
            S_inv_diag[ie * cd : (ie + 1) * cd, ie * cd : (ie + 1) * cd] = S
        self.L_natural_all = np.asarray(S_inv_diag[None] @ L_all)

        self._ready = True
        return self

    # -- transforms over the full (..., C, N_0, N_1, ...) state --------------
    @property
    def shape(self):
        return (len(self.components),) + tuple(b.N for b in self.bases)

    def grids(self):
        """Physical meshgrid of all axes (each of shape N_0 x N_1 x ...)."""
        return np.meshgrid(*[b.nodes for b in self.bases], indexing='ij')

    def _dim(self, i):
        """The tensor dimension of base ``i``, counted from the end (leading batch axes ride along)."""
        return i - len(self.bases)

    def _dev(self, name, like):
        """Assembly ``name`` (a numpy array) in ``like``'s complex dtype on its device, made once and kept."""
        return cached_tensor(self._consts, name, lambda: getattr(self, name), like, _COMPLEX[like.dtype])

    def transform(self, u):
        """real space (..., C, N_0, ...) -> coefficients (complex)."""
        u_hat = u.to(_COMPLEX[u.dtype])
        for i, b in enumerate(self.bases):
            u_hat = b.transform(u_hat, axis=self._dim(i))
        return u_hat

    def itransform(self, u_hat):
        u = u_hat
        for i, b in reversed(list(enumerate(self.bases))):
            u = b.itransform(u, axis=self._dim(i))
        return u.real

    def _perm(self, lead):
        return tuple(range(lead)) + tuple(lead + 1 + i for i in self._fourier_axes) + (lead,) + tuple(
            lead + 1 + i for i in self._ultra_axes)

    def _flatten_modes(self, u_hat):
        """(..., C, N_0, ...) -> (..., nmodes, C * coupled_dim)."""
        lead = u_hat.dim() - 1 - len(self.bases)
        v = u_hat.permute(self._perm(lead))
        return v.reshape(tuple(u_hat.shape[:lead]) + (self._nmodes, len(self.components) * self._coupled_dim))

    def _unflatten_modes(self, v):
        C = len(self.components)
        lead = v.dim() - 2
        fshape = tuple(self.bases[i].N for i in self._fourier_axes)
        ushape = tuple(self.bases[i].N for i in self._ultra_axes)
        u = v.reshape(tuple(v.shape[:lead]) + fshape + (C,) + ushape)
        perm = self._perm(lead)
        return u.permute(tuple(int(q) for q in np.argsort(perm)))

    def apply_operator(self, Op_all, u_hat):
        """Apply a stacked per-mode operator (the name of an assembly, or a tensor) along the flattened mode axis.
        The leading batch axes ride as columns of one product a mode: a broadcast ``Op @ v[..., None]`` copies the
        operator once per batch entry (12 GiB for RayleighBenard 256x128's nodes and steps)."""
        Op = self._dev(Op_all, u_hat) if isinstance(Op_all, str) else Op_all
        v = self._flatten_modes(u_hat)
        return self._unflatten_modes(torch.einsum('mij,...mj->...mi', Op, v))

    def apply_axis_matrix(self, mat, u_hat, axis):
        """Apply an (N, N) coefficient-space matrix along named ``axis`` (or the JAX package's index ``1 + i`` of
        base ``i``)."""
        i = self.axis_index(axis) if isinstance(axis, str) else axis - 1
        self._consts.setdefault(('matrix', id(mat)), mat)  # kept, so that its id names it while its tensor is kept
        return _along(cached_tensor(self._consts, ('axis matrix', id(mat)), lambda: mat, u_hat), u_hat, self._dim(i))

    # -- the protocol used by Problem classes ------------------------------
    def _shifted_operator(self, factor, like, out=None):
        """``M + factor L`` a mode with the tau lines in place of the rows they replace, in ``like``'s complex dtype:
        a new tensor, or written into ``out``."""
        keep = cached_tensor(self._consts, 'keep_mask', lambda: self.keep_mask, like, torch.bool)[:, :, None]
        M, L, bc = (self._dev(name, like) for name in ('M_all', 'L_all', 'bc_rows'))
        if out is None:
            return (M + factor * L) * keep + bc
        torch.mul(L, factor, out=out)
        torch.add(M, out, out=out)
        return out.mul_(keep).add_(bc)

    def _keeps_factors(self, node, factor, rhs_hat) -> bool:
        """Whether this solve uses node ``node``'s slot: a node given, one real factor, nothing differentiated, and
        the slot made already or made now, outside any capture (its tensors then keep their addresses for every
        graph of the run)."""
        if node is None or differentiated(rhs_hat):
            return False
        if isinstance(factor, torch.Tensor):
            if factor.numel() != 1 or factor.is_complex() or differentiated(factor):
                return False
        elif not isinstance(factor, numbers.Real):
            return False
        return (node, rhs_hat.dtype, rhs_hat.device) in self._slots or not loops.capturing(rhs_hat)

    def _refresh(self, slot, factor, like) -> None:
        """Form the operator at ``factor`` into the slot's ``LU``, factor it there and keep ``factor`` as its
        shift."""
        trace.tally('spectral.refreshes', like)
        LU, pivots = linalg.lu_factor(self._shifted_operator(factor, like, out=slot.LU), overwrite_a=True)
        if LU.data_ptr() != slot.LU.data_ptr():
            slot.LU.copy_(LU)
        slot.pivots.copy_(pivots)
        if isinstance(factor, torch.Tensor):
            slot.shift.copy_(factor)
        else:
            slot.shift.fill_(factor)

    def _slot(self, node, factor, rhs_hat) -> _FactorSlot:
        """Node ``node``'s slot, its factors made at ``factor``: made at the node's first solve, refreshed where
        its shift differs from ``factor`` (on the host for a host float, on the device for a tensor)."""
        key = (node, rhs_hat.dtype, rhs_hat.device)
        slot = self._slots.get(key)
        if slot is None:
            trace.tally('spectral.refreshes', rhs_hat)
            LU, pivots = linalg.lu_factor(self._shifted_operator(factor, rhs_hat), overwrite_a=True)
            shift = (factor.detach().to(torch.float64).reshape(()).clone() if isinstance(factor, torch.Tensor)
                     else torch.full((), float(factor), dtype=torch.float64, device=rhs_hat.device))
            known = None if isinstance(factor, torch.Tensor) else float(factor)
            slot = self._slots[key] = _FactorSlot(LU.contiguous(), pivots.contiguous(), shift, known)
            return slot
        if not isinstance(factor, torch.Tensor):
            if (slot.known if slot.known is not None else float(slot.shift)) != float(factor):
                self._refresh(slot, factor, rhs_hat)
            if slot.known is not None:
                slot.known = float(factor)
            return slot
        slot.known = None
        loop = graph_loop.device_while if loops.capturing(rhs_hat) else graph_loop.plain_while
        loop(lambda c: slot.shift != c[0], lambda c: self._refresh(slot, c[0], rhs_hat) or c,
             (factor.detach().to(torch.float64).reshape(()),))
        return slot

    def solve_shifted(self, rhs, factor, node=None):
        """Solve (M + factor*L) u = M rhs with BC tau lines, batched over
        Fourier modes (and any leading batch axes).  ``factor`` is a float or
        a device tensor; rhs in real space.  With ``node`` (a collocation
        node's index) the factors are node ``node``'s slot's, refreshed only
        where ``factor`` changed (the module's docstring)."""
        rhs_hat = self.transform(rhs)
        b = self._flatten_modes(self.apply_operator('M_all', rhs_hat))
        keep = cached_tensor(self._consts, 'keep_mask', lambda: self.keep_mask, rhs_hat, torch.bool)
        b = torch.where(keep, b, self._dev('bc_rhs_vec', rhs_hat)).unsqueeze(-1)
        if self._keeps_factors(node, factor, rhs_hat):
            with trace.device_span('linalg.solve'):
                slot = self._slot(node, factor, rhs_hat)
                trace.tally('spectral.slot_solves', rhs_hat)
                x = linalg.lu_substitute(slot.LU, slot.pivots, b)
        else:
            x = linalg.solve(self._shifted_operator(factor, rhs_hat), b)
        return self.itransform(self._unflatten_modes(x.squeeze(-1)))

    def apply_L(self, u):
        """L @ u in real space with rows mapped back to the natural
        (Chebyshev-T) bases — the implicit RHS evaluation."""
        u_hat = self.transform(u)
        return self.itransform(self.apply_operator('L_natural_all', u_hat))

    # -- dealiased products ------------------------------------------------
    def pad_to_real(self, u_hat, factor):
        """coefficients (..., C, N_0, ...) -> padded real grid (3/2-rule)."""
        u = u_hat
        for i, b in enumerate(self.bases):
            u = b.pad(u, axis=self._dim(i), factor=factor)
        for i, b in reversed(list(enumerate(self.bases))):
            if b.kind == 'fft':
                u = torch.fft.ifft(u, dim=self._dim(i), norm='forward')
            else:
                B = cached_tensor(b._consts, ('pad bwd', factor), lambda: b.padded_itransform_matrix(factor), u)
                u = _along(B, u, self._dim(i))
        return u.real

    def real_to_unpad(self, u_pad, factor):
        """padded real grid -> unpadded coefficients."""
        u_hat = u_pad.to(_COMPLEX[u_pad.dtype])
        for i, b in enumerate(self.bases):
            if b.kind == 'fft':
                u_hat = torch.fft.fft(u_hat, dim=self._dim(i), norm='forward')
            else:
                F = cached_tensor(b._consts, ('pad fwd', factor), lambda: b.padded_transform_matrix(factor), u_hat)
                u_hat = _along(F, u_hat, self._dim(i))
        for i, b in enumerate(self.bases):
            if b.kind == 'fft':
                u_hat = b.unpad(u_hat, axis=self._dim(i), factor=factor)
            else:
                u_hat = u_hat.narrow(self._dim(i), 0, b.N)
        return u_hat
