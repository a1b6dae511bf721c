"""Spectral (Chebyshev/ultraspherical) problems: 1D heat, Burgers, and a
fully non-periodic 2D heat equation.

The counterparts of ``pysdc_tpu/models/spectral_problems.py`` (reference
``HeatEquation_Chebychev.py`` and ``Burgers.py``) on the generic
tensor-product spectral layer (:mod:`pysdc_tpu_torch.ops.spectral`).  Every
problem here is a pure declaration: the engine handles basis conversion, tau
lines and the batched solves (one :func:`pysdc_tpu_torch.ops.linalg.solve`
over the modes: LAPACK on the CPU, on the card cuBLAS's batched LU below 512
rows and the pivoted blocked LU from 512 on).  The fused lanes capture them.
"""

from __future__ import annotations

import inspect
import math

import numpy as np
import torch

from pysdc_tpu_torch.core.problem import Problem, WorkCounter
from pysdc_tpu_torch.core.state import IMEX
from pysdc_tpu_torch.ops.spectral import TensorProductSpectral, UltrasphericalBase1D

class _SpectralProblem(Problem):
    """What the problems on :class:`TensorProductSpectral` share."""

    def solve_system(self, rhs, factor, u0, t, node=None):
        """With ``node`` (a sweeper's node loop) the node's LU is kept and reused while its shift stays the same
        (``TensorProductSpectral.solve_shifted``)."""
        return self.spec.solve_shifted(rhs, factor, node=node)

    def prepare_node_solvers(self, dt: float, qd_diag) -> None:
        """Route the sweepers' node index to the solves: nothing is factored here, a node's first solve fills its
        slot on the field's device."""
        if 'node' in inspect.signature(self.solve_system).parameters:
            self.accepts_node_index = True

    def eval_f_batched(self, u, t):
        """The nodes (and a block's steps behind them) in one evaluation: ``eval_f`` does not read ``t``."""
        return self.eval_f(u, t)

    def solve_system_batched(self, rhs, factor, u0, t):
        """All nodes in one batched solve, one shift per node (``factor`` of the node axis's length)."""
        f = factor if isinstance(factor, torch.Tensor) else torch.as_tensor(np.asarray(factor, dtype=float))
        lead = rhs.dim() - len(self.shape)  # the node axis and any axes behind it
        return self.spec.solve_shifted(rhs, f.to(rhs.device).reshape((-1,) + (1,) * (lead - 1 + 3)))

    def _grid(self, base):
        return torch.as_tensor(base.nodes, dtype=torch.float64, device=self.device)


class HeatChebyshev1D(_SpectralProblem):
    """u_t = nu u_xx with Dirichlet BCs via the ultraspherical method
    (reference HeatEquation_Chebychev.py).  State shape: (1, nvars)."""

    def __init__(self, nvars=64, nu=1.0, a=0.0, b=0.0, freq=1, dtype=None, device='cuda'):
        super().__init__(shape=(1, nvars), dtype=dtype, device=device)
        self._register(nvars=nvars, nu=nu, a=a, b=b, freq=freq)
        spec = TensorProductSpectral()
        self.zb = spec.add_axis('z', UltrasphericalBase1D(nvars, -1.0, 1.0))
        spec.add_component('u')
        spec.add_L_term('u', 'u', coeff=-nu, derivs={'z': 2})
        spec.add_M_term('u', 'u')
        spec.add_BC('u', 'u', axis='z', kind='dirichlet', x=-1.0, v=a, line=-2)
        spec.add_BC('u', 'u', axis='z', kind='dirichlet', x=1.0, v=b, line=-1)
        self.spec = spec.setup()
        self.work_counters['rhs'] = WorkCounter()

    @property
    def grid(self):
        return self._grid(self.zb)

    def eval_f(self, u, t):
        return -self.spec.apply_L(u)

    def u_exact(self, t, u_init=None, t_init=None):
        """Decaying sine mode satisfying u(+-1)=0 for a=b=0."""
        x = self.grid
        lam = -self.nu * (np.pi * self.freq) ** 2
        prof = torch.sin(np.pi * self.freq * (x + 1) / 2.0) * math.exp(lam / 4.0 * float(t))
        return prof[None, :].to(self.dtype)


class Burgers1D(_SpectralProblem):
    """Viscous Burgers u_t = eps u_xx - u u_x on [-1, 1], Dirichlet BCs,
    IMEX split (reference Burgers.py Burgers1D): diffusion implicit,
    advection explicit.  State shape: (1, nvars)."""

    f_kind = 'imex'

    def __init__(self, nvars=64, epsilon=0.1, BCl=1.0, BCr=-1.0, dtype=None, device='cuda'):
        super().__init__(shape=(1, nvars), dtype=dtype, device=device)
        self._register(nvars=nvars, epsilon=epsilon, BCl=BCl, BCr=BCr)
        spec = TensorProductSpectral()
        self.zb = spec.add_axis('z', UltrasphericalBase1D(nvars, -1.0, 1.0))
        spec.add_component('u')
        spec.add_L_term('u', 'u', coeff=-epsilon, derivs={'z': 2})
        spec.add_M_term('u', 'u')
        spec.add_BC('u', 'u', axis='z', kind='dirichlet', x=-1.0, v=BCl, line=-2)
        spec.add_BC('u', 'u', axis='z', kind='dirichlet', x=1.0, v=BCr, line=-1)
        self.spec = spec.setup()
        self._Dz_T = self.zb.deriv_natural(1)
        self.work_counters['rhs'] = WorkCounter()

    @property
    def grid(self):
        return self._grid(self.zb)

    def eval_f(self, u, t):
        impl = -self.spec.apply_L(u)
        u_hat = self.spec.transform(u)
        ux = self.spec.itransform(self.spec.apply_axis_matrix(self._Dz_T, u_hat, 'z'))
        return IMEX(impl=impl, expl=-u * ux)

    def u_exact(self, t, u_init=None, t_init=None):
        if float(t) != 0.0:
            raise NotImplementedError('Burgers has no closed-form solution here; initial condition only')
        x = self.grid
        # initial condition matching the BCs: -x plus a sine perturbation
        u0 = self.BCl * (1 - x) / 2 + self.BCr * (1 + x) / 2 + 0.25 * torch.sin(np.pi * x)
        return u0[None, :].to(self.dtype)


class Heat2DChebyshev(_SpectralProblem):
    """u_t = nu (u_xx + u_zz) on [-1, 1]^2, homogeneous Dirichlet on all
    four walls, Chebyshev in BOTH directions (two Kronecker-coupled
    ultraspherical axes, tau corners resolved first-claim-wins; the reference
    covers this space via GenericSpectralLinear with two Chebychev axes,
    generic_spectral.py:8-567).  State shape: (1, nx, nz)."""

    def __init__(self, nx=32, nz=32, nu=1.0, dtype=None, device='cuda'):
        super().__init__(shape=(1, nx, nz), dtype=dtype, device=device)
        self._register(nx=nx, nz=nz, nu=nu)
        spec = TensorProductSpectral()
        self.xb = spec.add_axis('x', UltrasphericalBase1D(nx, -1.0, 1.0))
        self.zb = spec.add_axis('z', UltrasphericalBase1D(nz, -1.0, 1.0))
        spec.add_component('u')
        spec.add_L_term('u', 'u', coeff=-nu, derivs={'x': 2})
        spec.add_L_term('u', 'u', coeff=-nu, derivs={'z': 2})
        spec.add_M_term('u', 'u')
        for line, x in ((-1, 1.0), (-2, -1.0)):
            spec.add_BC('u', 'u', axis='x', kind='dirichlet', x=x, v=0.0, line=line)
            spec.add_BC('u', 'u', axis='z', kind='dirichlet', x=x, v=0.0, line=line)
        self.spec = spec.setup()
        self.work_counters['rhs'] = WorkCounter()

    def eval_f(self, u, t):
        return -self.spec.apply_L(u)

    def u_exact(self, t, u_init=None, t_init=None):
        """Separable decaying mode vanishing on all walls."""
        X, Z = (torch.as_tensor(g, device=self.device) for g in self.spec.grids())
        lam = -self.nu * np.pi**2 / 2.0  # (pi/2)^2 per direction
        prof = torch.sin(np.pi * (X + 1) / 2) * torch.sin(np.pi * (Z + 1) / 2)
        return (prof * math.exp(lam * float(t)))[None].to(self.dtype)
