"""Rayleigh-Benard convection: incompressible Navier-Stokes + temperature.

The counterpart of ``pysdc_tpu/models/rayleigh_benard.py`` (reference
``RayleighBenard``, ``implementations/problem_classes/RayleighBenard.py:1-643``,
and ``RayleighBenard3D``, ``RayleighBenard3D.py:12-481``):

    u_x + v_z = 0
    u_t - nu (u_xx + u_zz) + p_x     = -(u u_x + v u_z)
    v_t - nu (v_xx + v_zz) + p_z - T = -(u v_x + v v_z)
    T_t - kappa (T_xx + T_zz)        = -(u T_x + v T_z)

on [0, Lx) x [z0, z0+Lz], FFT in x, ultraspherical in z, Dirichlet plates,
pressure gauge via an integral tau line.  The stiff linear part (viscosity,
pressure, buoyancy, incompressibility) is implicit; convection is explicit
with 3/2 dealiasing.  The whole linear system is a declaration on the generic
tensor-product layer (:mod:`pysdc_tpu_torch.ops.spectral`): basis conversion,
tau lines and the batched per-Fourier-mode dense solves live there.  The fused
lanes capture these problems; ``CFLLimit`` runs on the stage machine, as in
the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.device import cached_tensor
from pysdc_tpu_torch.core.problem import WorkCounter
from pysdc_tpu_torch.core.state import IMEX
from pysdc_tpu_torch.models.spectral_problems import _SpectralProblem
from pysdc_tpu_torch.ops.spectral import FourierBase1D, TensorProductSpectral, UltrasphericalBase1D


class _Convection(_SpectralProblem):
    """What the 2D and 3D problems share: constants on the device and the z-derivative in T space."""

    f_kind = 'imex'

    def _ik(self, base, like):
        """1j k of a Fourier axis in ``like``'s complex dtype on its device."""
        return cached_tensor(self._consts, ('ik', id(base)), lambda: 1j * base.k, like)

    def _dz(self, u_hat):
        """The T-space z-derivative along the last axis."""
        return u_hat @ cached_tensor(self._consts, 'Dz_T^T', lambda: self._Dz_T.T, u_hat)

    def _noise(self, shape, seed):
        return torch.as_tensor(np.random.default_rng(seed).random(shape), dtype=self.dtype, device=self.device)

    def _nusselt(self, flux_hat):
        """V (the z-integral), t (top) and b (bottom) of the horizontal mean flux's T series."""
        zb = self.zb
        rows = cached_tensor(self._consts, 'nusselt rows', lambda: np.stack(
            [zb.integral_row(), zb.dirichlet_row(self.z0 + self.Lz), zb.dirichlet_row(self.z0)]), flux_hat)
        integ, nu_top, nu_bot = (rows @ flux_hat).real.tolist()
        return {'V': integ / self.Lz, 't': nu_top, 'b': nu_bot}


class RayleighBenard(_Convection):
    def __init__(self, Prandtl=1.0, Rayleigh=2e6, nx=64, nz=32, BCs=None, dealiasing=1.5,
                 Lx=4.0, Lz=1.0, z0=0.0, dtype=None, device='cuda'):
        BCs = {
            'T_top': 0, 'T_bottom': 1, 'v_top': 0, 'v_bottom': 0,
            'u_top': 0, 'u_bottom': 0, 'p_integral': 0,
            **(BCs or {}),
        }
        super().__init__(shape=(4, nx, nz), dtype=dtype, device=device)
        self._register(Prandtl=Prandtl, Rayleigh=Rayleigh, nx=nx, nz=nz, BCs=BCs,
                       dealiasing=dealiasing, Lx=Lx, Lz=Lz, z0=z0)

        # rescaled Rayleigh number -> diffusivities (reference :143-146)
        Ra = Rayleigh / (max(abs(BCs['T_top'] - BCs['T_bottom']), np.finfo(float).eps) * Lz**3)
        self.kappa = (Ra * Prandtl) ** (-0.5)
        self.nu = (Ra / Prandtl) ** (-0.5)

        spec = TensorProductSpectral()
        self.xb = spec.add_axis('x', FourierBase1D(nx, 0.0, Lx))
        self.zb = spec.add_axis('z', UltrasphericalBase1D(nz, z0, z0 + Lz))
        spec.add_component('u', 'v', 'T', 'p')

        # divergence-free constraint in the 'p' row
        spec.add_L_term('p', 'u', derivs={'x': 1})
        spec.add_L_term('p', 'v', derivs={'z': 1})
        # momentum and temperature rows: pressure gradient, diffusion, buoyancy
        for comp, diffusivity in (('u', self.nu), ('v', self.nu), ('T', self.kappa)):
            spec.add_L_term(comp, comp, coeff=-diffusivity, derivs={'x': 2})
            spec.add_L_term(comp, comp, coeff=-diffusivity, derivs={'z': 2})
            spec.add_M_term(comp, comp)
        spec.add_L_term('u', 'p', derivs={'x': 1})
        spec.add_L_term('v', 'p', derivs={'z': 1})
        spec.add_L_term('v', 'T', coeff=-1.0)

        z_top, z_bot = z0 + Lz, z0
        spec.add_BC('p', 'p', axis='z', kind='integral', v=BCs['p_integral'], line=-1, scalar=True)
        spec.add_BC('T', 'T', axis='z', kind='dirichlet', x=z_bot, v=BCs['T_bottom'], line=-1)
        spec.add_BC('T', 'T', axis='z', kind='dirichlet', x=z_top, v=BCs['T_top'], line=-2)
        spec.add_BC('v', 'v', axis='z', kind='dirichlet', x=z_top, v=BCs['v_top'], line=-1)
        # the v-bottom condition is redundant at kx=0 (divergence + v_top
        # pin v there); reference adds it then removes the kx=0 copy
        spec.add_BC('v', 'v', axis='z', kind='dirichlet', x=z_bot, v=BCs['v_bottom'], line=-2,
                    skip_scalar=True)
        spec.add_BC('u', 'u', axis='z', kind='dirichlet', x=z_top, v=BCs['u_top'], line=-2)
        spec.add_BC('u', 'u', axis='z', kind='dirichlet', x=z_bot, v=BCs['u_bottom'], line=-1)
        self.spec = spec.setup()

        # T-space first derivative for convection terms and diagnostics
        self._Dz_T = self.zb.deriv_natural(1)
        self._consts: dict = {}
        self.work_counters['rhs'] = WorkCounter()

    # -- grids ----------------------------------------------------------
    @property
    def X(self):
        return torch.as_tensor(self.spec.grids()[0], device=self.device)

    @property
    def Z(self):
        return torch.as_tensor(self.spec.grids()[1], device=self.device)

    # -- protocol --------------------------------------------------------
    def eval_f(self, u, t):
        spec = self.spec
        u_hat = spec.transform(u)
        impl = -spec.apply_L(u)

        # explicit part: dealiased convection
        Dx_u_hat = u_hat * self._ik(self.xb, u_hat)[:, None]
        Dz_u_hat = spec.apply_axis_matrix(self._Dz_T, u_hat, 'z')

        pad = self.dealiasing
        u_pad = spec.pad_to_real(u_hat, pad)
        Dx_pad = spec.pad_to_real(Dx_u_hat, pad)
        Dz_pad = spec.pad_to_real(Dz_u_hat, pad)

        def comp(x, c):
            return x[..., c, :, :]

        iu, iv, iT = 0, 1, 2
        conv = torch.stack(
            [
                -(comp(u_pad, iu) * comp(Dx_pad, iu) + comp(u_pad, iv) * comp(Dz_pad, iu)),
                -(comp(u_pad, iu) * comp(Dx_pad, iv) + comp(u_pad, iv) * comp(Dz_pad, iv)),
                -(comp(u_pad, iu) * comp(Dx_pad, iT) + comp(u_pad, iv) * comp(Dz_pad, iT)),
                torch.zeros_like(comp(u_pad, 0)),
            ],
            dim=-3,
        )
        expl = spec.itransform(spec.real_to_unpad(conv, pad))
        return IMEX(impl=impl, expl=expl)

    def u_exact(self, t=0, noise_level=1e-3, seed=99):
        assert float(t) == 0
        BCs, Lz, z0 = self.BCs, self.Lz, self.z0
        Z = self.Z
        me = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        # linear background profiles between the plate values
        for i, comp in enumerate(['u', 'v', 'T']):
            a = (BCs[f'{comp}_top'] - BCs[f'{comp}_bottom']) / Lz
            b = BCs[f'{comp}_bottom'] - a * z0
            me[i] = a * Z + b
        # temperature noise vanishing at the plates
        me[2] = me[2] + noise_level * self._noise((self.nx, self.nz), seed) * (Z - z0) * (z0 + Lz - Z)
        return me

    # -- diagnostics (reference RayleighBenard.py:417-495) ---------------
    def compute_Nusselt_numbers(self, u):
        """Nu = Lz * <vT/kappa - T_z>; conductive state gives Nu = 1
        (reference RayleighBenard.py:417-470); one read of three numbers."""
        u_hat = self.spec.transform(u)
        iv, iT = 1, 2
        Tz_hat = self._dz(u_hat[iT])
        vT_hat = self.spec.transform((u[iv] * u[iT])[None])[0]
        flux_hat = (vT_hat / self.kappa - Tz_hat) * self.Lz
        return self._nusselt(flux_hat[0])  # horizontal mean = kx=0 mode

    def compute_vorticity(self, u):
        u_hat = self.spec.transform(u)
        vx_hat = u_hat[1] * self._ik(self.xb, u_hat)[:, None]
        uz_hat = self._dz(u_hat[0])
        return self.spec.itransform((vx_hat - uz_hat)[None])[0]


class CFLLimit:
    """Convergence controller: dt limited by the convective CFL condition
    (reference RayleighBenard.py:495).  Usable with any controller."""

    def __new__(cls, *args, **kwargs):
        from pysdc_tpu_torch.core.convergence import ConvergenceController

        class _CFLLimit(ConvergenceController):
            def setup(self, controller, params, description, **kw):
                return {'control_order': -50, 'cfl': 0.4, 'dt_max': np.inf,
                        **super().setup(controller, params, description, **kw)}

            def post_step_processing(self, controller, S, **kw):
                L = S.levels[0]
                P = L.prob
                u = L.uend if L.uend is not None else L.state.u[-1]
                dx = P.Lx / P.nx
                dz_min = float(np.min(np.diff(np.asarray(P.zb.nodes))))
                umax, vmax = (max(float(x), 1e-10) for x in torch.stack([u[0].abs().max(), u[1].abs().max()]).tolist())
                dt_cfl = self.params.cfl * min(dx / umax, dz_min / vmax)
                L.status.dt_new = min(dt_cfl, self.params.dt_max)

        return _CFLLimit(*args, **kwargs)


class RayleighBenard3D(_Convection):
    """3D Rayleigh-Benard convection, components (u, v, w, T, p) on an
    (x, y)-periodic box with no-slip plates in z (reference
    ``RayleighBenard3D.py:12-481``): the same ultraspherical tau formulation as
    the 2D problem, with the Fourier mode axis extended to the flattened
    (kx, ky) grid — every implicit solve is one batched dense solve over nx*ny
    tau-conditioned blocks.
    """

    def __init__(self, Prandtl=1.0, Rayleigh=2e6, nx=32, ny=32, nz=16, BCs=None,
                 dealiasing=1.5, Lx=4.0, Ly=4.0, Lz=1.0, z0=0.0, dtype=None, device='cuda'):
        BCs = {
            'T_top': 0, 'T_bottom': 1, 'w_top': 0, 'w_bottom': 0,
            'u_top': 0, 'u_bottom': 0, 'v_top': 0, 'v_bottom': 0, 'p_integral': 0,
            **(BCs or {}),
        }
        super().__init__(shape=(5, nx, ny, nz), dtype=dtype, device=device)
        self._register(Prandtl=Prandtl, Rayleigh=Rayleigh, nx=nx, ny=ny, nz=nz,
                       BCs=BCs, dealiasing=dealiasing, Lx=Lx, Ly=Ly, Lz=Lz, z0=z0)

        Ra = Rayleigh / (max(abs(BCs['T_top'] - BCs['T_bottom']), np.finfo(float).eps) * Lz**3)
        self.kappa = (Ra * Prandtl) ** (-0.5)
        self.nu = (Ra / Prandtl) ** (-0.5)

        spec = TensorProductSpectral()
        self.xb = spec.add_axis('x', FourierBase1D(nx, 0.0, Lx))
        self.yb = spec.add_axis('y', FourierBase1D(ny, 0.0, Ly))
        self.zb = spec.add_axis('z', UltrasphericalBase1D(nz, z0, z0 + Lz))
        spec.add_component('u', 'v', 'w', 'T', 'p')

        spec.add_L_term('p', 'u', derivs={'x': 1})
        spec.add_L_term('p', 'v', derivs={'y': 1})
        spec.add_L_term('p', 'w', derivs={'z': 1})
        for comp, diffusivity in (('u', self.nu), ('v', self.nu), ('w', self.nu),
                                  ('T', self.kappa)):
            for ax in ('x', 'y', 'z'):
                spec.add_L_term(comp, comp, coeff=-diffusivity, derivs={ax: 2})
            spec.add_M_term(comp, comp)
        spec.add_L_term('u', 'p', derivs={'x': 1})
        spec.add_L_term('v', 'p', derivs={'y': 1})
        spec.add_L_term('w', 'p', derivs={'z': 1})
        spec.add_L_term('w', 'T', coeff=-1.0)

        z_top, z_bot = z0 + Lz, z0
        spec.add_BC('p', 'p', axis='z', kind='integral', v=BCs['p_integral'], line=-1, scalar=True)
        spec.add_BC('T', 'T', axis='z', kind='dirichlet', x=z_bot, v=BCs['T_bottom'], line=-1)
        spec.add_BC('T', 'T', axis='z', kind='dirichlet', x=z_top, v=BCs['T_top'], line=-2)
        spec.add_BC('w', 'w', axis='z', kind='dirichlet', x=z_top, v=BCs['w_top'], line=-1)
        spec.add_BC('w', 'w', axis='z', kind='dirichlet', x=z_bot, v=BCs['w_bottom'], line=-2,
                    skip_scalar=True)
        spec.add_BC('u', 'u', axis='z', kind='dirichlet', x=z_top, v=BCs['u_top'], line=-2)
        spec.add_BC('u', 'u', axis='z', kind='dirichlet', x=z_bot, v=BCs['u_bottom'], line=-1)
        spec.add_BC('v', 'v', axis='z', kind='dirichlet', x=z_top, v=BCs['v_top'], line=-2)
        spec.add_BC('v', 'v', axis='z', kind='dirichlet', x=z_bot, v=BCs['v_bottom'], line=-1)
        self.spec = spec.setup()

        self._Dz_T = self.zb.deriv_natural(1)
        self._consts: dict = {}
        self.work_counters['rhs'] = WorkCounter()

    @property
    def Z(self):
        z = torch.as_tensor(self.zb.nodes, device=self.device)
        return z[None, None, :].expand(self.nx, self.ny, self.nz)

    # -- protocol --------------------------------------------------------
    def eval_f(self, u, t):
        spec = self.spec
        u_hat = spec.transform(u)

        impl = -spec.apply_L(u)
        impl[..., 4, :, :, :] = 0.0  # divergence row carries no dynamics

        Dx_hat = u_hat * self._ik(self.xb, u_hat)[:, None, None]
        Dy_hat = u_hat * self._ik(self.yb, u_hat)[None, :, None]
        Dz_hat = self._dz(u_hat)

        pad = self.dealiasing
        u_pad = spec.pad_to_real(u_hat, pad)
        Dx_pad = spec.pad_to_real(Dx_hat, pad)
        Dy_pad = spec.pad_to_real(Dy_hat, pad)
        Dz_pad = spec.pad_to_real(Dz_hat, pad)

        def comp(x, c):
            return x[..., c, :, :, :]

        iu, iv, iw, iT = 0, 1, 2, 3

        def adv(c):
            return -(comp(u_pad, iu) * comp(Dx_pad, c) + comp(u_pad, iv) * comp(Dy_pad, c)
                     + comp(u_pad, iw) * comp(Dz_pad, c))

        conv = torch.stack([adv(iu), adv(iv), adv(iw), adv(iT), torch.zeros_like(comp(u_pad, 0))], dim=-4)
        expl = spec.itransform(spec.real_to_unpad(conv, pad))
        return IMEX(impl=impl, expl=expl)

    def u_exact(self, t=0, noise_level=1e-3, seed=99):
        assert float(t) == 0
        BCs, Lz, z0 = self.BCs, self.Lz, self.z0
        Z = self.Z
        me = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        for i, comp in enumerate(['u', 'v', 'w', 'T']):
            a = (BCs[f'{comp}_top'] - BCs[f'{comp}_bottom']) / Lz
            b = BCs[f'{comp}_bottom'] - a * z0
            me[i] = a * Z + b
        me[3] = me[3] + noise_level * self._noise((self.nx, self.ny, self.nz), seed) * (Z - z0) * (z0 + Lz - Z)
        return me

    def compute_Nusselt_numbers(self, u):
        """Nu = Lz * <wT/kappa - T_z>; conductive state gives 1 (reference RayleighBenard3D.py:303-399); one read
        of three numbers."""
        u_hat = self.spec.transform(u)
        iw, iT = 2, 3
        Tz_hat = self._dz(u_hat[iT])
        wT_hat = self.spec.transform((u[iw] * u[iT])[None])[0]
        flux_hat = (wT_hat / self.kappa - Tz_hat) * self.Lz
        return self._nusselt(flux_hat[0, 0])  # (kx, ky) = (0, 0) horizontal mean

    def compute_divergence(self, u):
        u_hat = self.spec.transform(u)
        div_hat = (
            u_hat[0] * self._ik(self.xb, u_hat)[:, None, None]
            + u_hat[1] * self._ik(self.yb, u_hat)[None, :, None]
            + self._dz(u_hat[2])
        )
        return self.spec.itransform(div_hat[None])[0]
