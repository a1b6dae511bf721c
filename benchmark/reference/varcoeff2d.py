"""Plain reference of the variable-coefficient diffusion block on the unit square.

``u_t = d/dx (a u_x) + d/dy (a u_y)`` with ``u = 0`` on the boundary and ``a(x, y) = mean (1 + amplitude sin 2 pi x
cos 2 pi y)``, on the ``nx x ny`` interior points ``(x_i, y_j) = ((i + 1) hx, (j + 1) hy)``, ``h = 1 / (n + 1)``.
The right-hand side is the conservative five-point form with ``a`` at the faces half a step between two points (or a
point and the wall)::

    f_ij = (a_{i+1/2,j} (u_{i+1,j} - u_ij) - a_{i-1/2,j} (u_ij - u_{i-1,j})) / hx^2 + (the same in y) / hy^2

computed by slicing the field padded with the walls' zeros.  The implicit solve ``(I - alpha A) x = rhs`` is conjugate
gradients in float64 on each system of the leading axes (a block's steps), preconditioned by the exact solve of the
mean-coefficient operator (``mean(a_x) d_xx + mean(a_y) d_yy``, diagonal in the orthonormal sine basis
``S_jk = sqrt(2 / (n + 1)) sin(pi j k / (n + 1))`` with eigenvalues ``(2 cos(pi k / (n + 1)) - 2) / h^2``), to a
relative residual of 1e-10, and rounded back to the field's precision: its error lies far below the program's own
stopping test.  The block itself is :mod:`sdc`'s.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import sdc

#: one field: the check compares it against its own largest value
COMPONENT_AXIS = None

#: the reference's stopping test of a shifted solve: each system's residual over its right-hand side, in 2-norm
SOLVE_TOL = 1e-10
#: conjugate-gradient iterations a solve may take (it needs about 20 at 1024^2)
SOLVE_MAXITER = 500


def _sine_basis(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The orthonormal sine matrix of ``n`` interior points (symmetric, its own inverse) and the eigenvalues of the
    Dirichlet second difference ``(u_{i-1} - 2 u_i + u_{i+1}) / h^2`` for its columns, float64."""
    k = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    S = math.sqrt(2.0 / (n + 1)) * torch.sin(math.pi * k[:, None] * k[None, :] / (n + 1))
    lam = (2.0 * torch.cos(math.pi * k / (n + 1)) - 2.0) * (n + 1) ** 2
    return S, lam


class VarDiffusion2D:
    """The problem in ``dtype`` on ``device``."""

    def __init__(self, nx: int, ny: int, mean: float, amplitude: float, dtype, device, separable: bool = False,
                 solve_tol: float = SOLVE_TOL, flux_tf32: bool = False):
        """Faults that the check has to see: ``separable`` puts the mean-coefficient operator in place of
        ``a(x, y)`` (in ``f`` and in the solve: a program that solved only its preconditioner); ``solve_tol`` stops
        each solve at that relative residual.  ``flux_tf32`` (the control) rounds the face fluxes' operands to TF32."""
        self.dtype, self.solve_tol, self.flux_tf32 = dtype, solve_tol, flux_tf32
        self.inv_hx2, self.inv_hy2 = float((nx + 1) ** 2), float((ny + 1) ** 2)
        x = torch.arange(1, nx + 1, dtype=torch.float64, device=device) / (nx + 1)
        y = torch.arange(1, ny + 1, dtype=torch.float64, device=device) / (ny + 1)
        xf = (torch.arange(nx + 1, dtype=torch.float64, device=device) + 0.5) / (nx + 1)
        yf = (torch.arange(ny + 1, dtype=torch.float64, device=device) + 0.5) / (ny + 1)

        def a(xx, yy):
            return mean * (1.0 + amplitude * torch.sin(2 * math.pi * xx) * torch.cos(2 * math.pi * yy))

        ax, ay = a(xf[:, None], y[None, :]), a(x[:, None], yf[None, :])  # (nx + 1, ny), (nx, ny + 1)
        if separable:
            ax, ay = torch.full_like(ax, float(ax.mean())), torch.full_like(ay, float(ay.mean()))
        self.faces = {torch.float64: (ax, ay), dtype: (ax.to(dtype), ay.to(dtype))}
        (self.Sx, lx), (self.Sy, ly) = _sine_basis(nx, device), _sine_basis(ny, device)
        self.lam = float(ax.mean()) * lx[:, None] + float(ay.mean()) * ly[None, :]

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """``A u`` over the two trailing axes, in ``u``'s precision."""
        ax, ay = self.faces[u.dtype]
        up = F.pad(u, (1, 1, 1, 1))
        gx, gy = up[..., 1:, 1:-1] - up[..., :-1, 1:-1], up[..., 1:-1, 1:] - up[..., 1:-1, :-1]
        if self.flux_tf32 and u.dtype == torch.float32:
            ax, ay, gx, gy = (sdc.tf32(t) for t in (ax, ay, gx, gy))
        flux_x = ax * gx  # across each x face: (nx + 1, ny)
        flux_y = ay * gy  # (nx, ny + 1)
        return (flux_x[..., 1:, :] - flux_x[..., :-1, :]) * self.inv_hx2 \
            + (flux_y[..., :, 1:] - flux_y[..., :, :-1]) * self.inv_hy2

    def f(self, u):
        return self.apply(u), None

    def _precond(self, r, alpha):
        """The mean-coefficient operator's exact solve: into the sine basis, divided, back."""
        return self.Sx @ ((self.Sx @ r @ self.Sy) / (1.0 - alpha * self.lam)) @ self.Sy

    def solve(self, rhs, alpha):
        """``x`` with ``x - alpha A x = rhs``, each system of the leading axes by preconditioned CG in float64."""
        b = rhs.to(torch.float64)

        def dot(p, q):
            return (p * q).sum(dim=(-2, -1), keepdim=True)

        x = torch.zeros_like(b)
        r = b.clone()
        stop = self.solve_tol * dot(b, b).sqrt()
        z = self._precond(r, alpha)
        p, rz = z, dot(r, z)
        for _ in range(SOLVE_MAXITER):
            active = dot(r, r).sqrt() > stop
            if not bool(active.any()):
                return x.to(rhs.dtype)
            Ap = p - alpha * self.apply(p)
            step = torch.where(active, rz / dot(p, Ap), torch.zeros_like(rz))
            x, r = x + step * p, r - step * Ap
            z = self._precond(r, alpha)
            rz_new = dot(r, z)
            beta = torch.where(active, rz_new / rz, torch.zeros_like(rz))
            p, rz = z + beta * p, torch.where(active, rz_new, rz)
        raise RuntimeError(f'reference CG did not reach {self.solve_tol:g} in {SOLVE_MAXITER} iterations')


#: the control: the configuration states float32 with TF32 off (the program's products are full float32 products),
#: so the control computes in TF32: the operands of every product rounded to a 10-bit mantissa, the node contractions'
#: and the face fluxes', its sums in float32
CONTROL = 'the reference in TF32: the node contractions and the face fluxes'

#: faults of the timed path that the check has to see, each the reference with one thing wrong, put in the
#: program's place: (what is wrong, keywords of the problem, changes to the configuration)
FAULTS = {
    'mean_coefficient': ('the separable mean-coefficient operator in place of a(x, y): only the preconditioner solved',
                         dict(separable=True), {}),
    'loose_solve': ('each shifted solve stopped at 1e-2 of its right-hand side', dict(solve_tol=1e-2), {}),
    'seven_sweeps': ('maxiter 7: one sweep too few a step', {}, dict(maxiter=7)),
}


class Reference:
    """The configuration's blocks in its precision on ``device``; with ``control`` in TF32 (:data:`CONTROL`), with
    ``fault`` (a key of :data:`FAULTS`) one thing wrong."""

    def __init__(self, config: dict, device, control: bool = False, fault: str | None = None):
        _, problem, changes = FAULTS[fault] if fault else (None, {}, {})
        self.config = dict(config, **changes)
        (nx, ny), = config['nvars']
        coeff = config['diffusivity']
        prob = VarDiffusion2D(nx, ny, coeff['mean'], coeff['amplitude'], getattr(torch, config['dtype']), device,
                              flux_tf32=control, **problem)
        coll = sdc.Collocation.radau_right(config['num_nodes'], config['QI'])
        self.levels = [sdc.Level(prob, coll, config['dt'], matmul_tf32=control)]

    def march(self, u0: torch.Tensor, niters, band: float = 0.0):
        """``len(niters)`` blocks from ``u0`` (``(nx, ny)``), block ``b`` taking the judged run's decisions
        ``niters[b]`` on ties within ``band`` (``None``: its own throughout).  Returns ``(uend, ties, niters
        taken, off)``: ``off`` the decisions that differed from the judged run's and were no tie."""
        cfg = self.config
        u, ties, taken, off = u0.to(self.levels[0].prob.dtype), 0.0, [], 0
        for niter in niters:
            uend, its, t, o = sdc.block(self.levels, u, cfg['restol'], cfg['maxiter'], cfg['residual_type'],
                                        P=cfg['num_procs'], jacobi=cfg['mssdc_jac'], follow=niter, band=band)
            u, ties, off = uend[-1], max(ties, t), off + o
            taken.append(its)
        return u, ties, taken, off
