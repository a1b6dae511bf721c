"""Gray-Scott reaction-diffusion system, ND periodic, spectral Laplacian.

The counterpart of ``pysdc_tpu/models/gray_scott.py`` (reference
``grayscott_imex_diffusion`` / ``grayscott_imex_linear`` /
``grayscott_mi_diffusion`` / ``grayscott_mi_linear``,
``GrayScott_MPIFFT.py``):

    u_t = Du Lap(u) - u v^2 + A (1 - u)
    v_t = Dv Lap(v) + u v^2 - B v

on [-L/2, L/2]^N.  The components are stacked on the axis in front of the
grid (leading batch axes ride along); the per-component diffusion solve
reuses one spectral operator with scaled shifts.  The multi-implicit classes
pair with :class:`~pysdc_tpu_torch.sweepers.multi_implicit.MultiImplicitSweeper`;
their pointwise Newton (:func:`_newton_2x2_pointwise`) runs on the masked loop
and takes one field (components on its first axis), one node at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.problem import Problem, WorkCounter
from pysdc_tpu_torch.core.state import IMEX, Comp2
from pysdc_tpu_torch.ops.linop import SpectralOperator
from pysdc_tpu_torch.ops.loops import CAPTURE_DEPTH, masked_loop


class GrayScott(Problem):
    f_kind = 'imex'

    def __init__(self, nvars=(128, 128), Du=1e-4, Dv=1e-5, A=0.04, B=0.1, L=2.0, num_blobs=1, dtype=None,
                 device='cuda'):
        nvars = (nvars,) if isinstance(nvars, int) else tuple(nvars)
        super().__init__(shape=(2,) + nvars, dtype=dtype, device=device)
        self._register(nvars=nvars, Du=Du, Dv=Dv, A=A, B=B, L=L, num_blobs=num_blobs)
        self.lap = SpectralOperator(nvars, lengths=(L,) * len(nvars))
        dx = L / nvars[0]
        self.xvalues = np.array([-L / 2 + i * dx for i in range(nvars[0])])
        self.work_counters['rhs'] = WorkCounter()

    @property
    def ndim(self):
        return len(self.nvars)

    @property
    def grids(self):
        x = torch.as_tensor(self.xvalues, dtype=self.dtype, device=self.device)
        return torch.meshgrid(*([x] * self.ndim), indexing='ij')

    def _parts(self, u):
        """The two components of ``u`` and the axis they are stacked on."""
        ax = u.dim() - self.ndim - 1
        return u.select(ax, 0), u.select(ax, 1), ax

    def _reaction(self, u):
        u0, u1, ax = self._parts(u)
        uv2 = u0 * u1**2
        return torch.stack([-uv2 + self.A * (1.0 - u0), uv2 - self.B * u1], dim=ax)

    def _diffusion(self, u):
        u0, u1, ax = self._parts(u)
        return torch.stack([self.Du * self.lap.apply(u0), self.Dv * self.lap.apply(u1)], dim=ax)

    def eval_f(self, u, t):
        return IMEX(impl=self._diffusion(u), expl=self._reaction(u))

    def solve_system(self, rhs, factor, u0, t):
        """(I - factor*D_c Lap) per component: same operator, scaled shift."""
        r0, r1, ax = self._parts(rhs)
        return torch.stack([self.lap.solve_shifted(r0, factor * self.Du),
                            self.lap.solve_shifted(r1, factor * self.Dv)], dim=ax)

    def u_exact(self, t, u_init=None, t_init=None):
        """Initial condition: u=1, v=0 with Gaussian blobs of v (reference
        GrayScott_MPIFFT initial data; the centers drawn as the JAX package
        draws them); no closed form for t>0."""
        if t > 0:
            raise NotImplementedError('GrayScott has no exact solution for t > 0')
        gs = self.grids
        u = torch.ones(self.nvars, dtype=self.dtype, device=self.device)
        v = torch.zeros(self.nvars, dtype=self.dtype, device=self.device)
        rng = np.random.default_rng(10700)
        centers = rng.uniform(-self.L * 0.3, self.L * 0.3, size=(max(self.num_blobs, 1), self.ndim))
        if self.num_blobs == 1:
            centers = np.zeros((1, self.ndim))
        width = 0.04 * self.L
        for c in centers:
            r2 = sum((g - float(cc)) ** 2 for g, cc in zip(gs, c))
            bump = torch.exp(-r2 / (2 * width**2))
            v = v + 0.5 * bump
            u = u - 0.5 * bump
        return torch.stack([u, v])


class GrayScottLinearIMEX(GrayScott):
    """Alternative splitting: diffusion + linear decay/feed implicit
    (reference grayscott_imex_linear)."""

    def eval_f(self, u, t):
        u0, u1, ax = self._parts(u)
        impl = torch.stack([self.Du * self.lap.apply(u0) - self.A * u0, self.Dv * self.lap.apply(u1) - self.B * u1],
                           dim=ax)
        uv2 = u0 * u1**2
        return IMEX(impl=impl, expl=torch.stack([-uv2 + self.A, uv2], dim=ax))

    def solve_system(self, rhs, factor, u0, t):
        # (I - factor*(Du Lap - A)) = (1 + factor*A)(I - factor/(1+factor*A) Du Lap)
        r0, r1, ax = self._parts(rhs)
        au = 1.0 + factor * self.A
        av = 1.0 + factor * self.B
        return torch.stack([self.lap.solve_shifted(r0 / au, factor * self.Du / au),
                            self.lap.solve_shifted(r1 / av, factor * self.Dv / av)], dim=ax)


def _newton_2x2_pointwise(rhs, factor, u0, residual_fn, jacobian_fn, tol, maxiter, failed=None):
    """Newton for a pointwise-coupled 2-component system, the Jacobian a field
    of 2x2 blocks inverted in closed form (the reference assembles a sparse
    block-diagonal matrix, GrayScott_MPIFFT.py:574-674).  One system: it stops
    on ``max(max|gu|, max|gv|) <= tol`` over the whole field.  ``u`` stacks the
    components on its first axis; returns ``(u, iterations)`` (``None`` under
    a capture)."""

    def res_of(gu, gv):
        return torch.maximum(gu.abs().amax(), gv.abs().amax())

    def body(carry, flags):
        u, _ = carry
        gu, gv = residual_fn(u)
        j00, j01, j10, j11 = jacobian_fn(u)
        det = j00 * j11 - j01 * j10
        du = (j11 * gu - j01 * gv) / det
        dv = (j00 * gv - j10 * gu) / det
        u = torch.stack([u[0] - du, u[1] - dv])
        return u, res_of(*residual_fn(u))

    out = masked_loop(body, lambda c: c[1] > tol, (u0, res_of(*residual_fn(u0))), int(maxiter),
                      depth=CAPTURE_DEPTH, failed=failed)
    return out.carry[0], (None if out.host_counts is None else out.host_counts[0])


class GrayScottMultiImplicit(GrayScott):
    """Multi-implicit splitting: diffusion (comp1, exact spectral solves)
    and reaction (comp2, pointwise 2x2 Newton) both implicit but solved
    separately (reference ``grayscott_mi_diffusion``,
    GrayScott_MPIFFT.py:429-672).  ``newton_failed`` is the device flag of a
    capture's fixed Newton depth; ``newton_trace``, when set to a list,
    receives each solve's Newton iterations."""

    f_kind = 'comp2'

    def __init__(self, nvars=(128, 128), Du=1e-4, Dv=1e-5, A=0.04, B=0.1, L=2.0, num_blobs=1,
                 newton_maxiter=100, newton_tol=1e-12, dtype=None, device='cuda'):
        super().__init__(nvars=nvars, Du=Du, Dv=Dv, A=A, B=B, L=L, num_blobs=num_blobs, dtype=dtype, device=device)
        self._register(newton_maxiter=newton_maxiter, newton_tol=newton_tol)
        self.work_counters['newton'] = WorkCounter()
        self.newton_failed = torch.zeros((), dtype=torch.bool, device=self.device)
        self.newton_trace = None

    def eval_f(self, u, t):
        return Comp2(comp1=self._diffusion(u), comp2=self._reaction(u))

    def _newton(self, rhs, factor, u0, residual, jacobian):
        u, k = _newton_2x2_pointwise(rhs, factor, u0, residual, jacobian, self.newton_tol, self.newton_maxiter,
                                     failed=self.newton_failed)
        if self.newton_trace is not None and k is not None:
            self.newton_trace.append(k)
        return u

    def solve_system_2(self, rhs, factor, u0, t):
        """comp2: u - factor * R(u) = rhs with the full reaction R."""
        A, B = self.A, self.B

        def residual(u):
            uv2 = u[0] * u[1] ** 2
            gu = u[0] - rhs[0] - factor * (-uv2 + A * (1.0 - u[0]))
            gv = u[1] - rhs[1] - factor * (uv2 - B * u[1])
            return gu, gv

        def jacobian(u):
            j00 = 1.0 - factor * (-(u[1] ** 2) - A)
            j01 = -factor * (-2.0 * u[0] * u[1])
            j10 = -factor * (u[1] ** 2)
            j11 = 1.0 - factor * (2.0 * u[0] * u[1] - B)
            return j00, j01, j10, j11

        return self._newton(rhs, factor, u0, residual, jacobian)


class GrayScottMultiImplicitLinear(GrayScottMultiImplicit):
    """Multi-implicit with the linear decay/feed terms folded into the
    diffusion component (reference ``grayscott_mi_linear``,
    GrayScott_MPIFFT.py:674-803): comp1 = D Lap - decay, comp2 = pure
    nonlinear reaction."""

    def eval_f(self, u, t):
        u0, u1, ax = self._parts(u)
        impl = torch.stack([self.Du * self.lap.apply(u0) - self.A * u0, self.Dv * self.lap.apply(u1) - self.B * u1],
                           dim=ax)
        uv2 = u0 * u1**2
        return Comp2(comp1=impl, comp2=torch.stack([-uv2 + self.A, uv2], dim=ax))

    solve_system = GrayScottLinearIMEX.solve_system

    def solve_system_2(self, rhs, factor, u0, t):
        A = self.A

        def residual(u):
            uv2 = u[0] * u[1] ** 2
            return u[0] - rhs[0] - factor * (-uv2 + A), u[1] - rhs[1] - factor * uv2

        def jacobian(u):
            j00 = 1.0 + factor * u[1] ** 2
            j01 = factor * 2.0 * u[0] * u[1]
            j10 = -factor * (u[1] ** 2)
            j11 = 1.0 - factor * 2.0 * u[0] * u[1]
            return j00, j01, j10, j11

        return self._newton(rhs, factor, u0, residual, jacobian)
