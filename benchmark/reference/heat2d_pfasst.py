"""Plain reference of the two-level PFASST block on the periodic 2-D heat equation.

``u_t = nu (u_xx + u_yy)`` on the unit square, second-order central differences on an ``n x n`` periodic grid
(``x_i = i / n``).  The right-hand side is the five-point stencil by ``torch.roll``; the implicit solve
``(I - alpha A) u = rhs`` is exact in Fourier space, where the stencil's symbol is
``nu sum_d (2 cos(2 pi k_d / n) - 2) / dx^2``.  Space transfer between ``n`` and ``n / 2``: interpolation by
periodic Lagrange polynomials through the ``iorder`` nearest coarse points, restriction ``0.5 P^T`` of the
interpolation through the ``rorder`` nearest points (for 2 and 6: full weighting, and the six-point midpoint
rule ``(3, -25, 150, 150, -25, 3) / 256``).  The block itself is :mod:`sdc`'s.
"""

from __future__ import annotations

import numpy as np
import torch

from . import sdc

#: one field: the check compares each component against its own largest value
COMPONENT_AXIS = None


def _midpoint_weights(order: int):
    """(offsets, weights) of the periodic Lagrange interpolation at a coarse cell's midpoint through the
    ``order`` nearest coarse points (offsets relative to the cell's left point)."""
    offs = np.arange(-(order // 2) + 1, order // 2 + 1)
    return offs, sdc.lagrange_matrix(offs.astype(float), [0.5])[0]


class Heat2D:
    """The problem on one level, in ``dtype`` on ``device``."""

    def __init__(self, n: int, nu: float, dtype, device, iorder: int = 6, rorder: int = 2,
                 symbol: str = 'fd', prolong_shift: int = 0):
        """Faults that the check has to see: ``symbol='spectral'`` puts the exact Laplacian's symbol
        ``-(2 pi k)^2`` in place of the stencil's, in the right-hand side and the implicit solve;
        ``prolong_shift`` moves the interpolation's points by that many coarse points."""
        self.n, self.nu, self.dtype, self.device = n, float(nu), dtype, device
        dx = 1.0 / n
        self.inv_dx2 = 1.0 / dx**2
        k = torch.arange(n, dtype=torch.float64, device=device)
        sym_fd = (2.0 * torch.cos(2.0 * np.pi * k / n) - 2.0) * self.inv_dx2
        sym_exact = -(2.0 * np.pi * torch.fft.fftfreq(n, 1.0 / n, dtype=torch.float64, device=device)) ** 2

        def nu_symbol(sym_1d):
            return (self.nu * (sym_1d[:, None] + sym_1d[None, : n // 2 + 1])).to(dtype)

        self.spectral = symbol == 'spectral'
        self.symbol = nu_symbol(sym_exact if self.spectral else sym_fd)
        self.iorder, self.rorder, self.prolong_shift = iorder, rorder, prolong_shift

    def f(self, u):
        if self.spectral:
            return torch.fft.irfft2(torch.fft.rfft2(u) * self.symbol, s=u.shape[-2:]), None
        lap = (torch.roll(u, 1, -1) + torch.roll(u, -1, -1) + torch.roll(u, 1, -2) + torch.roll(u, -1, -2)
               - 4.0 * u) * self.inv_dx2
        return self.nu * lap, None

    def solve(self, rhs, alpha):
        r_hat = torch.fft.rfft2(rhs)
        return torch.fft.irfft2(r_hat / (1.0 - alpha * self.symbol), s=rhs.shape[-2:])

    # space transfer to and from the grid of half the points, axis by axis
    def _restrict_axis(self, x, dim):
        """``c[q] = 0.5 (f[2q] + sum_j w_j f[2 (q - o_j) + 1])``: 0.5 times the transpose of the ``rorder``-point
        interpolation, whose midpoint of cell ``p`` takes ``w_j`` of coarse point ``p + o_j``."""
        offs, w = _midpoint_weights(self.rorder)
        acc = x
        for o, wj in zip(offs, w):
            acc = acc + float(wj) * torch.roll(x, 2 * int(o) - 1, dims=dim)
        even = torch.arange(0, x.shape[dim], 2, device=x.device)
        return 0.5 * acc.index_select(dim, even)

    def _prolong_axis(self, c, dim):
        """``f[2q] = c[q]``, ``f[2q + 1] = sum_j w_j c[q + o_j]`` (the ``iorder``-point midpoint rule)."""
        offs, w = _midpoint_weights(self.iorder)
        mid = sum(float(wj) * torch.roll(c, -int(o) - self.prolong_shift, dims=dim) for o, wj in zip(offs, w))
        dim = dim % c.dim()
        shape = list(c.shape)
        shape[dim] *= 2
        return torch.stack([c, mid], dim=dim + 1).reshape(shape)

    def restrict(self, x):
        return self._restrict_axis(self._restrict_axis(x, -1), -2)

    def prolong(self, x):
        return self._prolong_axis(self._prolong_axis(x, -1), -2)


def levels(config: dict, dtype, device, matmul_tf32: bool = False, **problem):
    """The fine and the coarse level of ``config`` (``nvars`` [[n, n], [n/2, n/2]], ``nu``, ``num_nodes``,
    ``dt``, ``space_transfer``); ``problem`` overrides :class:`Heat2D`'s keywords (a fault)."""
    (nf, _), (nc, _) = config['nvars']
    st = config['space_transfer']
    out = []
    for n, M in zip((nf, nc), config['num_nodes']):
        kw = dict(dict(iorder=st['iorder'], rorder=st['rorder']), **problem)
        prob = Heat2D(n, config['nu'], dtype, device, **kw)
        out.append(sdc.Level(prob, sdc.Collocation.radau_right(M, config['QI'], 'PIC'), config['dt'], matmul_tf32))
    return out


#: the control: the configuration states float32 with TF32 off (the program's node contractions are full
#: float32 products), so the control computes them with TF32 on
CONTROL = 'the reference with its node contractions in TF32'

#: faults of the timed path that the check has to see, each the reference with one thing wrong, put in the
#: program's place: (what is wrong, keywords of the levels, factor on restol)
FAULTS = {
    'spectral_operator': ('the Laplacian by its exact symbol, not the stencil', dict(symbol='spectral'), 1.0),
    'prolong_shift': ("the interpolation's points one coarse point off", dict(prolong_shift=1), 1.0),
    'early_stop': ('a step done once its residual is at most 1.4 restol', {}, 1.4),
    'residual_half': ('the residual taken at half its size: a step done at 2 restol', {}, 2.0),
}


class Reference:
    """The configuration's blocks in its precision on ``device``; with ``control`` the node contractions in
    TF32, with ``fault`` (a key of :data:`FAULTS`) one thing wrong."""

    def __init__(self, config: dict, device, control: bool = False, fault: str | None = None):
        self.config = config
        _, problem, self.stop = FAULTS[fault] if fault else (None, {}, 1.0)
        self.levels = levels(config, getattr(torch, config['dtype']), device, matmul_tf32=control, **problem)

    def march(self, u0: torch.Tensor, niters, band: float = 0.0):
        """``len(niters)`` blocks from ``u0`` (``(n, n)``), block ``b`` taking the judged run's decisions
        ``niters[b]`` on ties within ``band`` (``None``: its own throughout).  Returns ``(uend, ties, niters
        taken, off)``: ``off`` the decisions that differed from the judged run's and were no tie."""
        cfg = self.config
        u, ties, taken, off = u0.to(self.levels[0].prob.dtype), 0.0, [], 0
        for niter in niters:
            uend, its, t, o = sdc.block(self.levels, u, cfg['restol'] * self.stop, cfg['maxiter'],
                                        cfg['residual_type'], P=cfg['num_procs'],
                                        burnin=cfg['predict_type'] == 'pfasst_burnin', follow=niter, band=band)
            u, ties, off = uend[-1], max(ties, t), off + o
            taken.append(its)
        return u, ties, taken, off
