"""Incompressible Navier-Stokes, 2D periodic, vorticity-streamfunction form.

The counterpart of ``pysdc_tpu/models/navier_stokes.py`` (the reference's
incompressible-NSE capability, ``projects/StroemungsRaum``):

    w_t + u . grad(w) = nu Lap(w),   u = (psi_y, -psi_x),  Lap(psi) = -w

on [0, L)^2.  IMEX split: diffusion implicit (exact spectral division, ``dt``
a float or a device tensor), advection explicit with 2/3-rule dealiasing.
Every transform is ``torch.fft`` (cuFFT on the card, complex128 for float64
fields); fields may carry leading batch axes (the nodes of a sweep, the steps
of a block), the transforms run over the last two.

Taylor-Green vortices are an exact nonlinear solution (their advection term
vanishes identically), giving spectral-accuracy gates for the full IMEX
path; an optional random multi-mode initial condition drives real 2D
turbulence for decay studies.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pysdc_tpu_torch.core.device import cached_tensor
from pysdc_tpu_torch.core.problem import Problem, WorkCounter
from pysdc_tpu_torch.core.state import IMEX
from pysdc_tpu_torch.models.heat import node_shift_column

_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


class NavierStokesVorticity2D(Problem):
    """State: vorticity w of shape (nx, ny) (single component)."""

    f_kind = 'imex'

    def __init__(self, nvars=(128, 128), nu=1e-3, L=2 * np.pi, k_tg=1, dealias=True, dtype=None, device='cuda'):
        nvars = (nvars, nvars) if isinstance(nvars, int) else tuple(nvars)
        super().__init__(shape=nvars, dtype=dtype, device=device)
        self._register(nvars=nvars, nu=nu, L=L, k_tg=k_tg, dealias=dealias)

        nx, ny = nvars
        kx = 2 * np.pi * np.fft.fftfreq(nx, d=1.0 / nx) / L
        ky = 2 * np.pi * np.fft.fftfreq(ny, d=1.0 / ny) / L
        KX, KY = np.meshgrid(kx, ky, indexing='ij')
        K2 = KX**2 + KY**2
        # Poisson inverse: psi_hat = w_hat / k^2 (zero-mean gauge at k = 0)
        K2_safe = K2.copy()
        K2_safe[0, 0] = 1.0
        # 2/3-rule dealias mask for the quadratic advection term
        mask = (np.abs(KX) <= (2.0 / 3.0) * np.max(np.abs(kx))) & (np.abs(KY) <= (2.0 / 3.0) * np.max(np.abs(ky)))
        self._tables = dict(ikx=1j * KX, iky=1j * KY, k2=K2, inv_k2=1.0 / K2_safe,
                            dealias=(mask if dealias else np.ones_like(mask)).astype(float))
        self._k2_host = K2
        self._consts: dict = {}
        self.work_counters['rhs'] = WorkCounter()

    def _t(self, name, like):
        """Table ``name`` on the device of ``like`` (a spectrum): the 1j k tables in its complex dtype, the real ones
        in the real dtype of its precision; made once and kept."""
        arr = self._tables[name]
        dtype = like.dtype if np.iscomplexobj(arr) else _REAL[like.dtype]
        return cached_tensor(self._consts, name, lambda: arr, like, dtype)

    # -- grids / fields ---------------------------------------------------
    @property
    def grids(self):
        nx, ny = self.nvars
        x = torch.as_tensor(np.arange(nx) * self.L / nx, dtype=self.dtype, device=self.device)
        y = torch.as_tensor(np.arange(ny) * self.L / ny, dtype=self.dtype, device=self.device)
        return torch.meshgrid(x, y, indexing='ij')

    def _real(self, x_hat, dtype):
        return torch.fft.ifft2(x_hat).real.to(dtype)

    def velocity(self, w):
        """u = (psi_y, -psi_x) from vorticity (divergence-free by construction)."""
        w_hat = torch.fft.fft2(w)
        psi_hat = w_hat * self._t('inv_k2', w_hat)
        return self._real(self._t('iky', w_hat) * psi_hat, w.dtype), self._real(-self._t('ikx', w_hat) * psi_hat,
                                                                                  w.dtype)

    # -- protocol ----------------------------------------------------------
    def eval_f(self, w, t):
        w_hat = torch.fft.fft2(w)
        ikx, iky = self._t('ikx', w_hat), self._t('iky', w_hat)
        psi_hat = w_hat * self._t('inv_k2', w_hat)
        u = self._real(iky * psi_hat, w.dtype)
        v = self._real(-ikx * psi_hat, w.dtype)
        wx = self._real(ikx * w_hat, w.dtype)
        wy = self._real(iky * w_hat, w.dtype)
        adv_hat = torch.fft.fft2(u * wx + v * wy) * self._t('dealias', w_hat)
        expl = -self._real(adv_hat, w.dtype)
        impl = self.nu * self._real(-self._t('k2', w_hat) * w_hat, w.dtype)
        return IMEX(impl=impl, expl=expl)

    def eval_f_batched(self, u, t):
        """The nodes (and a block's steps behind them) in one evaluation: ``eval_f`` does not read ``t``."""
        return self.eval_f(u, t)

    def solve_system(self, rhs, factor, u0, t):
        """(I + factor*nu*k^2)^-1 in Fourier space; ``factor`` a float or a device tensor."""
        rhat = torch.fft.fft2(rhs)
        xhat = rhat / (1.0 + factor * self.nu * self._t('k2', rhat))
        return self._real(xhat, rhs.dtype)

    def solve_system_batched(self, rhs, factor, u0, t):
        """One transform pair for all nodes, one shift per node."""
        shifts = node_shift_column(self, factor, rhs)
        rhat = torch.fft.fft2(rhs)
        return self._real(rhat / (1.0 + shifts * self.nu * self._t('k2', rhat)), rhs.dtype)

    def _const(self, key, values, dtype, device):
        """``values`` as a tensor of ``dtype`` on ``device``, made once and kept (the shifts of a host ``dt``)."""
        full = (key, dtype, device)
        if full not in self._consts:
            self._consts[full] = torch.as_tensor(np.asarray(values), dtype=dtype, device=device)
        return self._consts[full]

    def u_exact(self, t, u_init=None, t_init=None, kind='taylor_green', seed=42, n_modes=6):
        """'taylor_green': exact nonlinear solution w = 2 k cos(kx) cos(ky) exp(-2 nu k^2 t); 'random': multi-mode
        turbulence seed (t = 0 only)."""
        X, Y = self.grids
        if kind == 'taylor_green':
            k = 2 * np.pi * self.k_tg / self.L
            decay = math.exp(-2.0 * self.nu * k**2 * float(t))
            return (2 * k * torch.cos(k * X) * torch.cos(k * Y) * decay).to(self.dtype)
        if float(t) != 0.0:
            raise NotImplementedError('random IC defined at t = 0 only')
        rng = np.random.default_rng(seed)
        w = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        for _ in range(n_modes):
            kx = float(2 * np.pi * rng.integers(1, 4) / self.L)
            ky = float(2 * np.pi * rng.integers(1, 4) / self.L)
            amp, ph1, ph2 = rng.standard_normal(), rng.uniform(0, 2 * np.pi), rng.uniform(0, 2 * np.pi)
            w = w + float(amp) * torch.cos(kx * X + float(ph1)) * torch.cos(ky * Y + float(ph2))
        return w.to(self.dtype)

    # -- diagnostics (StroemungsRaum-style observables) ---------------------
    def kinetic_energy(self, w):
        u, v = self.velocity(w)
        cell = (self.L / self.nvars[0]) * (self.L / self.nvars[1])
        return 0.5 * float((u**2 + v**2).sum()) * cell

    def enstrophy(self, w):
        cell = (self.L / self.nvars[0]) * (self.L / self.nvars[1])
        return 0.5 * float((w**2).sum()) * cell

    def energy_spectrum(self, w):
        """Isotropic kinetic-energy spectrum E(k) (integer-shell binning)."""
        w_hat = torch.fft.fft2(w) / (self.nvars[0] * self.nvars[1])
        psi_hat = w_hat * self._t('inv_k2', w_hat)
        e_density = 0.5 * self._t('k2', w_hat) * psi_hat.abs() ** 2
        k_int = np.rint(np.sqrt(self._k2_host) / (2 * np.pi / self.L)).astype(int)
        kmax = k_int.max()
        E = np.zeros(kmax + 1)
        np.add.at(E, k_int.ravel(), e_density.detach().cpu().numpy().ravel())
        return np.arange(kmax + 1), E

    def divergence(self, w):
        """Max |div u| — zero to roundoff by construction."""
        u, v = self.velocity(w)
        u_hat, v_hat = torch.fft.fft2(u), torch.fft.fft2(v)
        ux = torch.fft.ifft2(self._t('ikx', u_hat) * u_hat).real
        vy = torch.fft.ifft2(self._t('iky', v_hat) * v_hat).real
        return float((ux + vy).abs().max())
