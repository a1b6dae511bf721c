"""2D linearized Boussinesq equations (gravity + acoustic waves), IMEX.

The counterpart of ``pysdc_tpu/models/boussinesq.py`` (reference
``boussinesq_2d_imex``, ``implementations/problem_classes/Boussinesq_2D_FD_imex.py:14-298``
and its ``boussinesq_helpers``): variables (u, w, b, p) on an x-periodic channel,

    u_t = -U u_x            - p_x
    w_t = -U w_x  + b       - p_z
    b_t = -U b_x  - N^2 w
    p_t = -U p_x  - c^2 (u_x + w_z)

slow advection (order-5 upwind) explicit, fast wave operator implicit.
Discretization parity: centered order-4 first derivatives with the
reference's boundary-row modifications (buildFDMatrix.py:48-130), z-BCs
(neumann for u/p rows, dirichlet for w inside the pressure equation)
per buildBoussinesq2DMatrix.py:27-50.

The solve: where the reference runs restarted GMRES
(Boussinesq_2D_FD_imex.py:157-198), we solve (I - f M) exactly.  Per
x-Fourier mode k the centered-derivative symbol is i*mu_k; eliminating u and
b reduces the 4-field system to a pressure equation

    [(1 + f^2 c^2 mu_k^2) I - f^2 c^2 / (1 + f^2 N^2) * Az_dir Az_neu] p = r_k

whose matrix differs between modes only by the real scalar shift — one
eigendecomposition of Az_dir @ Az_neu at setup turns the whole solve into
FFTs in x (``torch.fft``, cuFFT on the card) plus dense z-eigenbasis
products with an elementwise division in the middle (zero iterations, no host
read).  Fields may carry leading batch axes in front of ``(4, nx, nz)``.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.device import cached_tensor
from pysdc_tpu_torch.core.errors import ParameterError
from pysdc_tpu_torch.core.problem import Problem, WorkCounter
from pysdc_tpu_torch.core.state import IMEX

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def first_derivative_matrix(N: int, dx: float, bc: str, order: int = 4) -> np.ndarray:
    """Centered first-derivative matrix with the reference's boundary rows
    (buildFDMatrix.py ``getMatrix``)."""
    if order == 2:
        taps, offs, coeff = [-1.0, 0.0, 1.0], [-1, 0, 1], 0.5
    elif order == 4:
        taps, offs, coeff = [1.0, -8.0, 0.0, 8.0, -1.0], [-2, -1, 0, 1, 2], 1.0 / 12.0
    else:
        raise ParameterError(f'order {order} not implemented')
    A = np.zeros((N, N))
    for tap, off in zip(taps, offs):
        if bc == 'periodic':
            for i in range(N):
                A[i, (i + off) % N] += tap
        else:
            A += tap * np.eye(N, k=off)
    if bc == 'neumann':
        A[0, :] = 0.0
        A[-1, :] = 0.0
        if order == 2:
            A[0, :2] = [-4.0 / 3.0, 4.0 / 3.0]
            A[-1, -2:] = [-4.0 / 3.0, 4.0 / 3.0]
        else:
            A[0, :2] = [-8.0, 8.0]
            A[1, 0] = -8.0 + 4.0 / 3.0
            A[1, 1] = -1.0 / 3.0
            A[-1, -2:] = [-8.0, 8.0]
            A[-2, -1] = 8.0 - 4.0 / 3.0
            A[-2, -2] = 1.0 / 3.0
    elif bc == 'dirichlet':
        if order == 4:
            A[0, :] = 0.0
            A[0, 1] = 6.0
            A[-1, :] = 0.0
            A[-1, -2] = -6.0
    elif bc != 'periodic':
        raise ParameterError(f'unknown BC {bc!r}')
    return coeff / dx * A


def upwind_taps(order: int):
    """Left-biased upwind first-derivative taps {offset: coeff}
    (buildFDMatrix.py ``getUpwindMatrix``)."""
    table = {
        1: ([-1.0, 1.0], 1, 1.0),
        2: ([1.0, -4.0, 3.0], 2, 0.5),
        3: ([1.0, -6.0, 3.0, 2.0], 2, 1.0 / 6.0),
        4: ([-5.0, 30.0, -90.0, 50.0, 15.0], 3, 1.0 / 60.0),
        5: ([3.0, -20.0, 60.0, -120.0, 65.0, 12.0], 4, 1.0 / 60.0),
    }
    if order not in table:
        raise ParameterError(f'upwind order {order} not implemented')
    taps, zero_idx, coeff = table[order]
    return {i - zero_idx: coeff * t for i, t in enumerate(taps)}


class Boussinesq2DIMEX(Problem):
    f_kind = 'imex'

    def __init__(self, nvars=(300, 30), c_s=0.3, u_adv=0.02, Nfreq=0.01,
                 x_bounds=(-150.0, 150.0), z_bounds=(0.0, 10.0),
                 order_upw=5, order=4, dtype=None, device='cuda'):
        nx, nz = nvars
        super().__init__(shape=(4, nx, nz), dtype=dtype, device=device)
        self._register(
            nvars=tuple(nvars), c_s=c_s, u_adv=u_adv, Nfreq=Nfreq,
            x_bounds=tuple(x_bounds), z_bounds=tuple(z_bounds),
            order_upw=order_upw, order=order,
        )
        # grids (build2DFDMatrix.py get2DMesh: periodic x, interior z)
        x = np.linspace(x_bounds[0], x_bounds[1], nx, endpoint=False)
        zfull = np.linspace(z_bounds[0], z_bounds[1], nz + 2, endpoint=True)
        z = zfull[1:-1]
        self.dx_, self.dz_ = x[1] - x[0], z[1] - z[0]
        self.xx, self.zz = np.meshgrid(x, z, indexing='ij')

        # x-derivative symbol (circulant first column -> exact FFT eigenvalues)
        cent = first_derivative_matrix(nx, self.dx_, 'periodic', order)[:, 0]
        self._dx_sym = np.fft.fft(cent)  # purely imaginary by antisymmetry
        self.taps_upw = upwind_taps(order_upw)

        # z-derivative matrices: neumann rows act on u/p, dirichlet on w
        self.Az_neu = first_derivative_matrix(nz, self.dz_, 'neumann', order)
        self.Az_dir = first_derivative_matrix(nz, self.dz_, 'dirichlet', order)

        # one-time eigendecomposition of the pressure operator's z-part
        C = self.Az_dir @ self.Az_neu
        lam, V = np.linalg.eig(C)
        self.C_lam = lam  # complex in general
        self.C_V = V
        self.C_Vinv = np.linalg.inv(V)
        self._consts: dict = {}
        self.work_counters['rhs'] = WorkCounter()
        self.work_counters['solves'] = WorkCounter()

    def _c(self, name, like):
        """The constant ``name`` (a numpy array) in ``like``'s dtype on its device, made once and kept."""
        return cached_tensor(self._consts, name, lambda: getattr(self, name), like)

    # -- derivative helpers ---------------------------------------------
    def _ddx_upwind(self, q):
        """Order-5 upwind x-derivative of (..., nx, nz) via rolls."""
        out = torch.zeros_like(q)
        for off, tap in self.taps_upw.items():
            out = out + tap * torch.roll(q, -off, dims=-2)
        return out / self.dx_

    def _ddx_centered_hat(self, q_hat):
        return self._c('_dx_sym', q_hat)[:, None] * q_hat

    def _ddz(self, q, name):
        """The z-derivative matrix ``name`` applied along the last axis (``...xj -> ...xi``)."""
        return q @ self._c(name, q).T

    # -- protocol -------------------------------------------------------
    def eval_f(self, q, t):
        u, w, b, p = q[..., 0, :, :], q[..., 1, :, :], q[..., 2, :, :], q[..., 3, :, :]
        hat = torch.fft.fft(q.to(_COMPLEX[q.dtype]), dim=-2)
        dx = torch.fft.ifft(self._ddx_centered_hat(hat), dim=-2).real.to(q.dtype)
        impl = torch.stack([
            -dx[..., 3, :, :],
            b - self._ddz(p, 'Az_neu'),
            -self.Nfreq**2 * w,
            -self.c_s**2 * (dx[..., 0, :, :] + self._ddz(w, 'Az_dir')),
        ], dim=-3)
        expl = -self.u_adv * self._ddx_upwind(q)
        return IMEX(impl=impl, expl=expl)

    def solve_system(self, rhs, factor, u0, t):
        """Exact direct solve of (I - factor*M) q = rhs (see module doc); ``factor`` a float or a device tensor."""
        f = factor
        c2, N2 = self.c_s**2, self.Nfreq**2
        hat = torch.fft.fft(rhs.to(_COMPLEX[rhs.dtype]), dim=-2)  # (..., 4, nx, nz)
        Ru, Rw, Rb, Rp = hat[..., 0, :, :], hat[..., 1, :, :], hat[..., 2, :, :], hat[..., 3, :, :]
        lam = self._c('_dx_sym', hat)[:, None]  # i*mu_k, (nx, 1)

        An, Ad = self._c('Az_neu', hat), self._c('Az_dir', hat)
        beta = 1.0 + f**2 * N2
        # pressure equation rhs: Rp - f c^2 lam Ru - f c^2/beta Ad (Rw + f Rb)
        rp = Rp - f * c2 * lam * Ru - (f * c2 / beta) * ((Rw + f * Rb) @ Ad.T)
        # shift per mode: (1 - f^2 c^2 lam^2) real since lam is imaginary
        shift = 1.0 - f**2 * c2 * lam**2  # (nx, 1) complex with zero imaginary part
        sigma = f**2 * c2 / beta
        # solve (shift*I - sigma*C) p per mode in C's eigenbasis
        rp_e = rp @ self._c('C_Vinv', hat).T
        p_e = rp_e / (shift - sigma * self._c('C_lam', hat)[None, :])
        p = p_e @ self._c('C_V', hat).T
        # back-substitution
        w = (Rw + f * Rb - f * (p @ An.T)) / beta
        u = Ru - f * lam * p
        b = Rb - f * N2 * w
        out = torch.stack([u, w, b, p], dim=-3)
        return torch.fft.ifft(out, dim=-2).real.to(rhs.dtype)

    def u_exact(self, t, u_init=None, t_init=None):
        """t=0 bubble of buoyancy (reference Boussinesq_2D_FD_imex.py:268-298)."""
        assert t == 0, 'u_exact only valid for t=0'
        dtheta, H, a, x_c = 0.01, 10.0, 5.0, -50.0
        b = dtheta * np.sin(np.pi * self.zz / H) / (1.0 + np.square(self.xx - x_c) / (a * a))
        out = np.zeros(self.shape)
        out[2] = b
        return torch.as_tensor(out, dtype=self.dtype, device=self.device)
