"""Plain reference of the Rayleigh-Benard block: 2-D convection, Fourier in x, ultraspherical in z.

The equations (pySDC's ``RayleighBenard``, ``implementations/problem_classes/RayleighBenard.py``), for the
components ``u, v, T, p`` on ``[0, Lx) x [0, Lz]``::

    u_x + v_z = 0
    u_t - nu (u_xx + u_zz) + p_x     = -(u u_x + v u_z)
    v_t - nu (v_xx + v_zz) + p_z - T = -(u v_x + v v_z)
    T_t - kappa (T_xx + T_zz)        = -(u T_x + v T_z)

with ``kappa = (Ra Pr)^-1/2``, ``nu = (Ra / Pr)^-1/2``.  The linear terms are implicit, the convection explicit
with the 3/2 rule.  In z each equation is written in the ultraspherical basis ``C^(lambda)``, ``lambda`` the
highest z-derivative in that equation (2 for ``u, v, T``, 1 for the divergence), by Olver and Townsend's
derivative and conversion matrices; its last two coefficient lines are replaced by the boundary conditions
(no-slip, ``T = 1`` below and ``0`` above; the ``v`` condition at the bottom is left out at ``kx = 0``, where the
divergence row and the top condition fix it, and the divergence row of ``kx = 0`` takes the pressure's zero
mean), the Nyquist mode of x is held at 0.  An implicit solve is then, for each Fourier mode, one dense system
of ``4 nz`` rows, factored here once for each shift the sweeps use (``torch.linalg.lu_factor``) and solved by
substitution.  The block itself is :mod:`sdc`'s.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import sdc

#: the state's axis of the components u, v, T, p: the check compares each component against its own largest value
COMPONENT_AXIS = 0

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


# -- the z basis: Chebyshev T and its ultraspherical ladders on [z0, z0 + Lz] ------------------------------------
def cheb_nodes(N):
    """Chebyshev-Gauss points of [-1, 1], ascending."""
    return np.cos((2 * np.arange(N) + 1) * np.pi / (2 * N))[::-1]


def cheb_fwd(N):
    """Values at the N Chebyshev-Gauss points -> T coefficients."""
    C = np.cos(np.outer(np.arange(N), np.arccos(cheb_nodes(N))))
    w = np.full(N, 2.0 / N)
    w[0] = 1.0 / N
    return C * w[:, None]


def cheb_bwd(N, M=None):
    """M T coefficients (zero-padded from N to M) -> values at the M Chebyshev-Gauss points."""
    M = N if M is None else M
    return np.cos(np.outer(np.arccos(cheb_nodes(M)), np.arange(M)))


def diff_T_to_C(N, p, L):
    """d^p/dz^p from T coefficients to C^(p) coefficients on an interval of length L."""
    D = np.zeros((N, N))
    for n in range(p, N):
        D[n - p, n] = 2.0 ** (p - 1) * math.factorial(p - 1) * n
    return D * (2.0 / L) ** p


def convert(N, a, b):
    """C^(a) -> C^(b) coefficients (``a = 0``: Chebyshev T)."""
    out = np.eye(N)
    for lam in range(a, b):
        S = np.zeros((N, N))
        if lam == 0:
            S[0, 0] = 1.0
            S[np.arange(1, N), np.arange(1, N)] = 0.5
            S[np.arange(N - 2), np.arange(2, N)] = -0.5
        else:
            n = np.arange(N)
            S[n, n] = lam / (n + lam)
            S[np.arange(N - 2), np.arange(2, N)] = -lam / (np.arange(N - 2) + 2 + lam)
        out = S @ out
    return out


def ladder(N, p, lam, L):
    """d^p/dz^p from T coefficients into the C^(lam) rows (``p <= lam``)."""
    if p == 0:
        return convert(N, 0, lam)
    mat = diff_T_to_C(N, p, L)
    return convert(N, p, lam) @ mat if p < lam else mat


def value_row(N, x_ref):
    return np.cos(np.arange(N) * np.arccos(np.clip(x_ref, -1.0, 1.0)))


def integral_row(N, L):
    n = np.arange(N)
    row = np.zeros(N)
    even = n % 2 == 0
    row[even] = 2.0 / (1.0 - n[even] ** 2)
    return row * L / 2.0


class RBC2D:
    """The problem in ``dtype`` (float64 or float32) on ``device``; every constant worked out here."""

    U, V, T, P = range(4)

    def __init__(self, config: dict, dtype, device):
        nx, nz = config['nx'], config['nz']
        Lx, Lz, z0 = config['Lx'], config['Lz'], config['z0']
        Ra, Pr = config['Rayleigh'], config['Prandtl']
        bc = dict(T_top=0.0, T_bottom=1.0, u_top=0.0, u_bottom=0.0, v_top=0.0, v_bottom=0.0, p_integral=0.0)
        Ra = Ra / (max(abs(bc['T_top'] - bc['T_bottom']), np.finfo(float).eps) * Lz**3)
        self.kappa = (Ra * Pr) ** -0.5
        self.nu = (Ra / Pr) ** -0.5
        self.nx, self.nz, self.dealias = nx, nz, config['dealiasing']
        self.dtype, self.cdtype, self.device = dtype, _COMPLEX[dtype], device
        N, D = nz, 4 * nz
        k = 2 * np.pi * np.fft.fftfreq(nx, d=1.0 / nx) / Lx
        ik = 1j * k

        # blocks of L and M: (equation, component) -> (factor over the modes, z matrix)
        lam = {self.U: 2, self.V: 2, self.T: 2, self.P: 1}
        terms_L, terms_M = [], []
        nus = {self.U: self.nu, self.V: self.nu, self.T: self.kappa}
        for c, d in nus.items():
            terms_L.append((c, c, -d * ik**2, ladder(N, 0, 2, Lz)))
            terms_L.append((c, c, -d * np.ones(nx), ladder(N, 2, 2, Lz)))
            terms_M.append((c, c, np.ones(nx), ladder(N, 0, 2, Lz)))
        terms_L += [(self.P, self.U, ik, ladder(N, 0, lam[self.P], Lz)),
                    (self.P, self.V, np.ones(nx), ladder(N, 1, lam[self.P], Lz)),
                    (self.U, self.P, ik, ladder(N, 0, 2, Lz)),
                    (self.V, self.P, np.ones(nx), ladder(N, 1, 2, Lz)),
                    (self.V, self.T, -np.ones(nx), ladder(N, 0, 2, Lz))]

        def assemble(terms):
            out = torch.zeros((nx, D, D), dtype=torch.complex128, device=device)
            for e, c, fac, mat in terms:
                out[:, e * N:(e + 1) * N, c * N:(c + 1) * N] += (
                    torch.as_tensor(fac, dtype=torch.complex128, device=device)[:, None, None]
                    * torch.as_tensor(mat, dtype=torch.complex128, device=device)[None])
            return out

        self._L, self._M = assemble(terms_L), assemble(terms_M)

        # L with its rows back in the T basis, for the right-hand side
        Sinv = torch.zeros((D, D), dtype=torch.complex128, device=device)
        for e in range(4):
            Sinv[e * N:(e + 1) * N, e * N:(e + 1) * N] = torch.as_tensor(
                np.linalg.inv(convert(N, 0, lam[e])), dtype=torch.complex128, device=device)
        self.L_nat = (Sinv[None] @ self._L).to(self.cdtype)

        # boundary rows: (component, equation, row over the component's coefficients, value, line, modes)
        zero = 0
        top, bottom = value_row(N, 1.0), value_row(N, -1.0)
        every, not_zero = range(nx), [m for m in range(nx) if m != zero]
        bcs = [(self.P, self.P, integral_row(N, Lz), bc['p_integral'], N - 1, [zero]),
               (self.T, self.T, bottom, bc['T_bottom'], N - 1, every),
               (self.T, self.T, top, bc['T_top'], N - 2, every),
               (self.V, self.V, top, bc['v_top'], N - 1, every),
               (self.V, self.V, bottom, bc['v_bottom'], N - 2, not_zero),
               (self.U, self.U, top, bc['u_top'], N - 2, every),
               (self.U, self.U, bottom, bc['u_bottom'], N - 1, every)]
        keep = torch.ones((nx, D), dtype=torch.bool, device=device)
        rows = torch.zeros((nx, D, D), dtype=torch.complex128, device=device)
        rhs = torch.zeros((nx, D), dtype=torch.complex128, device=device)
        for c, e, row, value, line, modes in bcs:
            r, modes = e * N + line, torch.as_tensor(list(modes), device=device)
            keep[modes, r] = False
            rows[modes, r, c * N:(c + 1) * N] = torch.as_tensor(row, dtype=torch.complex128, device=device)
            if zero in modes:
                rhs[zero, r] = value
        nyq = nx // 2
        keep[nyq] = False
        rows[nyq] = torch.eye(D, dtype=torch.complex128, device=device)
        rhs[nyq] = 0.0
        self.keep, self.bc_rows, self.bc_rhs = keep, rows, rhs.to(self.cdtype)
        self.M_c = self._M.to(self.cdtype)

        # transforms and the dealiased products
        self.ik = torch.as_tensor(ik, dtype=self.cdtype, device=device)
        self.fwd = torch.as_tensor(cheb_fwd(N), dtype=self.cdtype, device=device)
        self.bwd = torch.as_tensor(cheb_bwd(N), dtype=self.cdtype, device=device)
        Np = int(np.ceil(N * self.dealias))
        self.Np_x = int(np.ceil(nx * self.dealias))
        self.bwd_pad = torch.as_tensor(cheb_bwd(N, Np)[:, :N], dtype=self.cdtype, device=device)
        self.fwd_pad = torch.as_tensor(cheb_fwd(Np)[:N], dtype=self.cdtype, device=device)
        self.Dz = torch.as_tensor(np.linalg.solve(convert(N, 0, 1), diff_T_to_C(N, 1, Lz)), dtype=self.cdtype,
                                  device=device)
        self._factors = {}

    # -- transforms ------------------------------------------------------------------------------------------
    def transform(self, u):
        """(..., 4, nx, nz) real -> coefficients."""
        u_hat = torch.fft.fft(u.to(self.cdtype), dim=-2, norm='forward')
        return u_hat @ self.fwd.T

    def itransform(self, u_hat):
        return torch.fft.ifft(u_hat @ self.bwd.T, dim=-2, norm='forward').real

    def to_padded_grid(self, u_hat):
        nx, Npx = self.nx, self.Np_x
        shifted = torch.fft.fftshift(u_hat, dim=-2)
        lo = (Npx - nx) // 2
        pad = torch.zeros(u_hat.shape[:-2] + (Npx, u_hat.shape[-1]), dtype=u_hat.dtype, device=u_hat.device)
        pad[..., lo:lo + nx, :] = shifted
        pad = torch.fft.ifftshift(pad, dim=-2)
        return torch.fft.ifft(pad @ self.bwd_pad.T, dim=-2, norm='forward').real

    def from_padded_grid(self, v):
        nx, Npx = self.nx, self.Np_x
        v_hat = torch.fft.fft(v.to(self.cdtype), dim=-2, norm='forward') @ self.fwd_pad.T
        shifted = torch.fft.fftshift(v_hat, dim=-2)
        lo = (Npx - nx) // 2
        return torch.fft.ifftshift(shifted[..., lo:lo + nx, :], dim=-2)

    # modes first: (..., 4, nx, nz) <-> (..., nx, 4 nz)
    def _modes(self, u_hat):
        return u_hat.transpose(-3, -2).reshape(u_hat.shape[:-3] + (self.nx, 4 * self.nz))

    def _fields(self, v):
        return v.reshape(v.shape[:-2] + (self.nx, 4, self.nz)).transpose(-3, -2)

    # -- the problem ------------------------------------------------------------------------------------------
    def f(self, u):
        u_hat = self.transform(u)
        impl = -self.itransform(self._fields(torch.einsum('mij,...mj->...mi', self.L_nat, self._modes(u_hat))))
        dx = u_hat * self.ik[:, None]
        dz = u_hat @ self.Dz.T
        up, dxp, dzp = self.to_padded_grid(u_hat), self.to_padded_grid(dx), self.to_padded_grid(dz)
        conv = [-(up[..., 0, :, :] * dxp[..., c, :, :] + up[..., 1, :, :] * dzp[..., c, :, :]) for c in range(3)]
        conv.append(torch.zeros_like(conv[0]))
        expl = self.itransform(self.from_padded_grid(torch.stack(conv, dim=-3)))
        return impl, expl

    def _factor(self, alpha):
        key = round(alpha, 15)
        if key not in self._factors:
            A = (self._M + alpha * self._L) * self.keep[:, :, None] + self.bc_rows
            self._factors[key] = torch.linalg.lu_factor(A.to(self.cdtype))
        return self._factors[key]

    def solve(self, rhs, alpha):
        """(M + alpha L) u = M rhs per mode, the boundary lines replaced."""
        b = torch.einsum('mij,...mj->...mi', self.M_c, self._modes(self.transform(rhs)))
        b = torch.where(self.keep, b, self.bc_rhs)
        lead = b.shape[:-2]
        cols = b.reshape((-1, self.nx, 4 * self.nz)).permute(1, 2, 0)  # (nx, D, batch)
        LU, piv = self._factor(float(alpha))
        x = torch.linalg.lu_solve(LU, piv, cols)
        return self.itransform(self._fields(x.permute(2, 0, 1).reshape(lead + (self.nx, 4 * self.nz))))


def conduction_state(config: dict, noise: torch.Tensor) -> torch.Tensor:
    """The conduction profile (``T`` from 1 below to 0 above, at rest) with ``noise`` (nx, nz), uniform in
    [0, 1), times ``noise_level z (Lz - z)`` added to ``T``: pySDC's initial state."""
    nz, z0, Lz = config['nz'], config['z0'], config['Lz']
    z = torch.as_tensor(z0 + (cheb_nodes(nz) + 1) / 2 * Lz, dtype=noise.dtype, device=noise.device)
    u = torch.zeros((4, config['nx'], nz), dtype=noise.dtype, device=noise.device)
    u[2] = (1.0 - (z - z0) / Lz) + config['noise_level'] * noise * (z - z0) * (z0 + Lz - z)
    return u


#: the control: the configuration states float64, so the control computes in float32 (complex64)
CONTROL = 'the reference in float32'

#: faults of the timed path that the check has to see, each the reference with one thing wrong, put in the
#: program's place: (what is wrong, keys of the configuration replaced)
FAULTS = {
    'no_dealiasing': ('the products on the grid of the modes, with no 3/2 padding', dict(dealiasing=1.0)),
    'three_iterations': ('three iterations a step where the configuration states four', dict(maxiter=3)),
}


class Reference:
    """The configuration's blocks in its precision on ``device`` (with ``control`` in float32, with ``fault``, a
    key of :data:`FAULTS`, one thing wrong); the problem and its factorizations are made once and serve every
    sample."""

    def __init__(self, config: dict, device, control: bool = False, fault: str | None = None):
        self.config = dict(config, **FAULTS[fault][1]) if fault else config
        self.dtype = torch.float32 if control else getattr(torch, config['dtype'])
        coll = sdc.Collocation.radau_right(config['num_nodes'], config['QI'], config['QE'])
        self.levels = [sdc.Level(RBC2D(self.config, self.dtype, device), coll, config['dt'])]

    def march(self, u0: torch.Tensor, niters, band: float = 0.0):
        """``len(niters)`` blocks from ``u0`` (4, nx, nz), block ``b`` taking the judged run's decisions
        ``niters[b]`` on ties within ``band`` (``None``: its own throughout).  Returns ``(uend, ties, niters
        taken, off)``, ``uend`` in ``u0``'s precision, ``off`` the decisions that differed from the judged run's
        and were no tie."""
        cfg = self.config
        u, ties, taken, off = u0.to(self.dtype), 0.0, [], 0
        for niter in niters:
            uend, its, t, o = sdc.block(self.levels, u, cfg['restol'], cfg['maxiter'], cfg['residual_type'],
                                        P=cfg['num_procs'], jacobi=cfg['mssdc_jac'], follow=niter, band=band)
            u, ties, off = uend[-1], max(ties, t), off + o
            taken.append(its)
        return u.to(u0.dtype), ties, taken, off
