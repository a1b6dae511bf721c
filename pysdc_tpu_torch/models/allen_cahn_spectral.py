"""Allen-Cahn spectral variants: ND periodic IMEX, mass-conserving forcing,
2D circle problems, and the temperature-coupled two-component system.

The counterpart of ``pysdc_tpu/models/allen_cahn_spectral.py`` (reference
``allencahn_imex`` / ``allencahn_imex_timeforcing``, AllenCahn_MPIFFT.py:8,172;
``allencahn2d_imex`` / ``allencahn2d_imex_stab``, AllenCahn_2D_FFT.py:9,200;
``allencahn_temp_imex``, AllenCahn_Temp_MPIFFT.py:11).  The state lives in
real space and the Laplacian and its shifted solves go through one exact
:class:`~pysdc_tpu_torch.ops.linop.SpectralOperator` (cuFFT on the card); the
mass-conserving forcing's global sums are plain reductions.  The random
initial conditions are drawn from the numpy generators the JAX package seeds,
so both packages start from the same field.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pysdc_tpu_torch.core.errors import ProblemError
from pysdc_tpu_torch.core.problem import Problem, WorkCounter
from pysdc_tpu_torch.core.state import IMEX
from pysdc_tpu_torch.ops.linop import SpectralOperator


def _circle_blobs(grids, L, eps, ndim, rng_seed=1):
    """Sum of tanh blobs with random radii on an L x L tiling, scaled to [0,1]
    (reference AllenCahn_MPIFFT.py:140-166 ``circle_rand``)."""
    Li = int(L)
    rng = np.random.RandomState(rng_seed)
    lbound = 3.0 * eps
    ubound = 0.5 - eps
    rand_radii = (ubound - lbound) * rng.random_sample(size=(Li,) * ndim) + lbound
    if ndim != 2:
        raise NotImplementedError('circle_rand initial condition is 2D only')
    tmp = torch.zeros_like(grids[0])
    for i in range(Li):
        for j in range(Li):
            r2 = (grids[0] + i - Li + 0.5) ** 2 + (grids[1] + j - Li + 0.5) ** 2
            tmp = tmp + torch.tanh((float(rand_radii[i, j]) - torch.sqrt(r2)) / (np.sqrt(2) * eps)) + 1.0
    return tmp * 0.5


class AllenCahnSpectralND(Problem):
    """IMEX Allen-Cahn on the periodic box [0, L]^N with driving force:

        u_t = Lap(u) - 2/eps^2 u (1-u)(1-2u) - 6 dw u (1-u)

    diffusion implicit (exact spectral shifted solve), reaction explicit.
    Reference: ``allencahn_imex`` (AllenCahn_MPIFFT.py:8-170).
    """

    f_kind = 'imex'

    def __init__(self, nvars=(128, 128), eps=0.04, radius=0.25, dw=0.0, L=1.0, init_type='circle', dtype=None,
                 device='cuda'):
        nvars = (nvars,) if isinstance(nvars, int) else tuple(nvars)
        super().__init__(shape=nvars, dtype=dtype, device=device)
        self._register(nvars=nvars, eps=eps, radius=radius, dw=dw, L=L, init_type=init_type)
        self.lap = SpectralOperator(nvars, lengths=(L,) * len(nvars))
        self.dx = L / nvars[0]
        self.work_counters['rhs'] = WorkCounter()

    @property
    def ndim(self):
        return len(self.nvars)

    @property
    def grids(self):
        """Coordinates x_i = i * L / N on [0, L) per axis (reference local mesh,
        AllenCahn_Temp_MPIFFT.py:126-131)."""
        axes = [torch.arange(n, dtype=self.dtype, device=self.device) * (self.L / n) for n in self.nvars]
        return torch.meshgrid(*axes, indexing='ij')

    def _reaction(self, u, t):
        r = torch.zeros_like(u)
        if self.eps > 0:
            r = -2.0 / self.eps**2 * u * (1.0 - u) * (1.0 - 2.0 * u)
            r = r - 6.0 * self.dw * u * (1.0 - u)
        return r

    def eval_f(self, u, t):
        return IMEX(impl=self.lap.apply(u), expl=self._reaction(u, t))

    def solve_system(self, rhs, factor, u0, t):
        return self.lap.solve_shifted(rhs, factor)

    def _phase(self):
        gs = self.grids
        if self.init_type == 'circle':
            r2 = sum((g - 0.5) ** 2 for g in gs)
            return 0.5 * (1.0 + torch.tanh((self.radius - torch.sqrt(r2)) / (np.sqrt(2) * self.eps)))
        if self.init_type == 'circle_rand':
            return _circle_blobs(gs, self.L, self.eps, self.ndim)
        raise NotImplementedError(f'init_type {self.init_type!r} not implemented')

    def u_exact(self, t, u_init=None, t_init=None):
        if t != 0:
            raise ProblemError('u_exact only valid for t=0')
        return self._phase().to(self.dtype)


class AllenCahnSpectralTimeForcing(AllenCahnSpectralND):
    """Allen-Cahn with mass-conserving time-dependent driving force: dw(t) is
    chosen each RHS evaluation so the total mass production cancels,
    dw = sum(Lap u + reaction) / sum(6 u (1-u)).
    Reference: ``allencahn_imex_timeforcing`` (AllenCahn_MPIFFT.py:172-274).
    """

    def eval_f(self, u, t):
        impl = self.lap.apply(u)
        if self.eps > 0:
            expl = -2.0 / self.eps**2 * u * (1.0 - u) * (1.0 - 2.0 * u)
        else:
            expl = torch.zeros_like(u)
        space = tuple(range(u.dim() - self.ndim, u.dim()))  # one field's sums (a block's steps are batch axes)
        Rt = torch.sum(impl + expl, dim=space, keepdim=True)
        Ht = torch.sum(6.0 * u * (1.0 - u), dim=space, keepdim=True)
        dw = torch.where(Ht != 0.0, Rt / torch.where(Ht != 0.0, Ht, torch.ones_like(Ht)), torch.zeros_like(Ht))
        return IMEX(impl=impl, expl=expl - 6.0 * dw * u * (1.0 - u))


class AllenCahn2DSpectral(Problem):
    """2D IMEX Allen-Cahn with polynomial reaction on [-L/2, L/2]^2:

        u_t = Lap(u) + 1/eps^2 u (1 - u^nu)

    Reference: ``allencahn2d_imex`` (AllenCahn_2D_FFT.py:9-198).  Initial
    conditions: centered tanh circle, checkerboard, or seeded uniform noise.
    """

    f_kind = 'imex'

    def __init__(self, nvars=(128, 128), nu=2, eps=0.04, radius=0.25, L=1.0, init_type='circle', dtype=None,
                 device='cuda'):
        nvars = tuple(nvars)
        if len(nvars) != 2 or nvars[0] != nvars[1]:
            raise ProblemError(f'need a square 2D domain, got {nvars}')
        if nvars[0] % 2 != 0:
            raise ProblemError('the setup requires nvars = 2^p per dimension')
        super().__init__(shape=nvars, dtype=dtype, device=device)
        self._register(nvars=nvars, nu=nu, eps=eps, radius=radius, L=L, init_type=init_type)
        self.lap = SpectralOperator(nvars, lengths=(L, L))
        self.dx = L / nvars[0]
        self.xvalues = np.array([i * self.dx - L / 2.0 for i in range(nvars[0])])
        self.work_counters['rhs'] = WorkCounter()

    def _reaction(self, u):
        if self.eps > 0:
            return 1.0 / self.eps**2 * u * (1.0 - u**self.nu)
        return torch.zeros_like(u)

    def eval_f(self, u, t):
        return IMEX(impl=self.lap.apply(u), expl=self._reaction(u))

    def solve_system(self, rhs, factor, u0, t):
        return self.lap.solve_shifted(rhs, factor)

    def u_exact(self, t, u_init=None, t_init=None):
        if t != 0:
            raise ProblemError('u_exact only valid for t=0')
        x = torch.as_tensor(self.xvalues, dtype=self.dtype, device=self.device)
        X, Y = torch.meshgrid(x, x, indexing='ij')
        if self.init_type == 'circle':
            return torch.tanh((self.radius - torch.sqrt(X**2 + Y**2)) / (np.sqrt(2) * self.eps)).to(self.dtype)
        if self.init_type == 'checkerboard':
            return (torch.sin(2.0 * math.pi * X) * torch.sin(2.0 * math.pi * Y)).to(self.dtype)
        if self.init_type == 'random':
            rng = np.random.RandomState(1)
            return torch.as_tensor(rng.uniform(-1, 1, self.nvars), dtype=self.dtype, device=self.device)
        raise NotImplementedError(f'init_type {self.init_type!r} not implemented')


class AllenCahn2DSpectralStab(AllenCahn2DSpectral):
    """Stabilized splitting: the linear shift 2/eps^2 moves into the implicit
    operator, u_t = (Lap - 2/eps^2) u + [1/eps^2 u (1-u^nu) + 2/eps^2 u].
    Reference: ``allencahn2d_imex_stab`` (AllenCahn_2D_FFT.py:200-310).
    """

    def __init__(self, nvars=(256, 256), nu=2, eps=0.04, radius=0.25, L=1.0, init_type='circle', dtype=None,
                 device='cuda'):
        super().__init__(nvars, nu, eps, radius, L, init_type, dtype, device)
        self.lap.symbol = self.lap.symbol - 2.0 / self.eps**2

    def _reaction(self, u):
        return super()._reaction(u) + 2.0 / self.eps**2 * u


class AllenCahnTempSpectralND(Problem):
    """Temperature-coupled Allen-Cahn, two components stacked on the axis in
    front of the grid (phase u, temperature T):

        u_t = Lap(u) - 2/eps^2 u(1-u)(1-2u) - 6 dw (T-TM)/TM u(1-u)
        T_t = D Lap(T) + u_t

    Reference: ``allencahn_temp_imex`` (AllenCahn_Temp_MPIFFT.py:11-399).
    The temperature RHS's explicit part carries the full phase RHS
    (latent-heat release), as the reference composes
    ``f.expl[..., 1] = f.impl[..., 0] + f.expl[..., 0]``.
    """

    f_kind = 'imex'

    def __init__(self, nvars=(128, 128), eps=0.04, radius=0.25, TM=1.0, D=10.0, dw=0.0, L=1.0,
                 init_type='circle', dtype=None, device='cuda'):
        nvars = tuple(nvars)
        super().__init__(shape=(2,) + nvars, dtype=dtype, device=device)
        self._register(nvars=nvars, eps=eps, radius=radius, TM=TM, D=D, dw=dw, L=L, init_type=init_type)
        self.lap = SpectralOperator(nvars, lengths=(L,) * len(nvars))
        self.dx = L / nvars[0]
        self.work_counters['rhs'] = WorkCounter()

    @property
    def ndim(self):
        return len(self.nvars)

    grids = AllenCahnSpectralND.grids

    def _parts(self, u):
        ax = u.dim() - self.ndim - 1
        return u.select(ax, 0), u.select(ax, 1), ax

    def eval_f(self, u, t):
        phase, temp, ax = self._parts(u)
        impl_u = self.lap.apply(phase)
        impl_T = self.D * self.lap.apply(temp)
        if self.eps > 0:
            expl_u = -2.0 / self.eps**2 * phase * (1.0 - phase) * (1.0 - 2.0 * phase)
            expl_u = expl_u - 6.0 * self.dw * (temp - self.TM) / self.TM * phase * (1.0 - phase)
        else:
            expl_u = torch.zeros_like(phase)
        return IMEX(impl=torch.stack([impl_u, impl_T], dim=ax), expl=torch.stack([expl_u, impl_u + expl_u], dim=ax))

    def solve_system(self, rhs, factor, u0, t):
        r0, r1, ax = self._parts(rhs)
        return torch.stack([self.lap.solve_shifted(r0, factor), self.lap.solve_shifted(r1, factor * self.D)], dim=ax)

    def u_exact(self, t, u_init=None, t_init=None):
        if t != 0:
            raise ProblemError('u_exact only valid for t=0')
        phase = AllenCahnSpectralND._phase(self)
        return torch.stack([phase, torch.zeros_like(phase)]).to(self.dtype)
