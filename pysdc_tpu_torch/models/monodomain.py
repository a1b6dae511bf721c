"""Monodomain cardiac electrophysiology: diffusion + ionic membrane models.

The counterpart of ``pysdc_tpu/models/monodomain.py`` (reference Monodomain
project, projects/Monodomain/problem_classes/MonodomainODE.py + the C++ ionic
models): V_t = div(D grad V) + I_ion(y) + I_stim, gating variables evolve as
local ODEs.  IMEX split: diffusion of V implicit (FFT direct solve on the
periodic grid), ionic currents explicit; the three-way split for exponential
SDC treats the gating variables exponentially (Rush-Larsen).  The ionic RHS is
the torch implementation of :mod:`pysdc_tpu_torch.models.ionic`.

On the card a 2D grid's diffusion applies through kernel K1 on the potential
plane ``u[0]`` (contiguous in a step's state ``(size, nx, ny)``), once in every
``eval_f``; each implicit solve is one cuFFT ``rfftn`` / ``irfftn`` pair.

Fields may carry leading batch axes in front of ``(size, *grid)`` (the nodes of
a sweep, the steps of a block), with one time per batch entry: ``t`` is a host
float or a float64 tensor of the batch shape, and the stimulus's
``t < stim_dur`` is a ``torch.where`` on the device, never a host read.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.device import cached_tensor
from pysdc_tpu_torch.core.problem import Problem, WorkCounter
from pysdc_tpu_torch.core.state import IMEX, IMEXEXP
from pysdc_tpu_torch.models.ionic import TORCH_MODELS
from pysdc_tpu_torch.ops.linop import SeparableFDOperator


class MonodomainIMEX(Problem):
    """State shape: (model.size, *grid); component 0 is the potential V."""

    f_kind = 'imex'

    def __init__(self, nvars=256, ionic_model='hodgkinhuxley', diff=1.0e-1, L=10.0,
                 stim_dur=2.0, stim_ampl=80.0, stim_width=0.1, dtype=None, device='cuda'):
        self.model = TORCH_MODELS[ionic_model]()
        nvars = (nvars,) if isinstance(nvars, int) else tuple(nvars)
        super().__init__(shape=(self.model.size,) + nvars, dtype=dtype, device=device)
        self._register(nvars=nvars, ionic_model=ionic_model, diff=diff, L=L,
                       stim_dur=stim_dur, stim_ampl=stim_ampl, stim_width=stim_width)
        dx = L / nvars[0]
        self.dx = dx
        self.A = SeparableFDOperator(
            [dict(size=n, dx=dx, derivative=2, order=2, bc='periodic') for n in nvars], scale=diff
        )
        self.xvalues = np.arange(nvars[0]) * dx
        self._consts: dict = {}
        self.work_counters['rhs'] = WorkCounter()

    @property
    def grids(self):
        x = torch.as_tensor(self.xvalues, dtype=self.dtype, device=self.device)
        if len(self.nvars) == 1:
            return (x,)
        return torch.meshgrid(*([x] * len(self.nvars)), indexing='ij')

    # -- the component axis and the batch axes in front of it ---------------
    def _comp_axis(self, u):
        return u.dim() - 1 - len(self.nvars)

    def _potential(self, u):
        """V = component 0 of ``u`` (any leading batch axes kept), contiguous for K1."""
        return u.select(self._comp_axis(u), 0).contiguous()

    def _with_potential(self, u, v):
        """``u`` with component 0 replaced by ``v`` (a new tensor)."""
        out = u.clone()
        out.select(self._comp_axis(u), 0).copy_(v)
        return out

    def _model_frame(self, u):
        """``u`` with the component axis in front, as the ionic models index it (a view)."""
        return u.movedim(self._comp_axis(u), 0)

    def _from_model_frame(self, y, like):
        return y.movedim(0, self._comp_axis(like))

    def _bump(self, like):
        """The stimulus's Gaussian profile on the grid, made once per dtype and device."""
        def make():
            x = np.asarray(self.xvalues, dtype=np.float64)
            gs = np.meshgrid(*([x] * len(self.nvars)), indexing='ij')
            return np.exp(-sum((g / (self.stim_width * self.L)) ** 2 for g in gs))

        return cached_tensor(self._consts, 'bump', make, like)

    def _stimulus(self, t, like):
        """Stimulus applied near the left edge for stim_dur time: the grid's shape, with one leading entry per
        time of a tensor ``t``."""
        bump = self.stim_ampl * self._bump(like)
        if isinstance(t, torch.Tensor):
            on = t.to(device=like.device, dtype=torch.float64) < self.stim_dur
            return torch.where(on.reshape(tuple(t.shape) + (1,) * len(self.nvars)), bump, torch.zeros_like(bump))
        return bump if float(t) < self.stim_dur else torch.zeros_like(bump)

    def _add_stimulus(self, ion, t, like):
        """``ion`` (model frame) with the stimulus added to the potential's row."""
        ion[0] = ion[0] + self._stimulus(t, like)
        return ion

    def _impl(self, u):
        """Diffusion of V, zero on the other components."""
        impl = torch.zeros_like(u)
        impl.select(self._comp_axis(u), 0).copy_(self.A.apply(self._potential(u)))
        return impl

    @staticmethod
    def _times(t, device):
        """Times of a batch (a numpy array or a tensor) as a float64 tensor on ``device``; a host float stays one."""
        if isinstance(t, (torch.Tensor, np.ndarray)):
            return torch.as_tensor(t, dtype=torch.float64, device=device)
        return t

    # -- protocol -------------------------------------------------------
    def eval_f(self, u, t):
        impl = self._impl(u)
        y = self._model_frame(u)
        expl = self._add_stimulus(self.model.f(y), t, u)
        return IMEX(impl=impl, expl=self._from_model_frame(expl, u))

    def eval_f_batched(self, u, t):
        """All nodes (and the steps of a block behind them) in one evaluation: one K1 launch on the card."""
        return self.eval_f(u, self._times(t, u.device))

    def solve_system(self, rhs, factor, u0, t):
        """(I - factor*D Lap) on V only; gating variables are unchanged."""
        return self._with_potential(rhs, self.A.solve_shifted(self._potential(rhs), factor))

    def u_exact(self, t, u_init=None, t_init=None):
        if float(t) != 0.0:
            raise NotImplementedError('monodomain has no closed-form solution; t=0 only')
        y0 = self.model.initial_values().to(device=self.device, dtype=self.dtype)
        return y0.reshape((self.model.size,) + (1,) * len(self.nvars)).expand(self.shape).contiguous()


class MonodomainIMEXEXP(MonodomainIMEX):
    """Three-way splitting for exponential SDC (reference
    projects/Monodomain/problem_classes/MonodomainODE.py:280-420):
    diffusion on V implicit, ionic currents + stimulus on V explicit,
    gating variables exponential (Rush-Larsen): y' = lambda(V)(y - y_inf(V)).
    """

    f_kind = 'imexexp'

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        mask = np.zeros(self.model.size)
        for i in getattr(self.model, 'f_exp_indices', ()):
            mask[i] = 1.0
        self.exp_mask = mask
        nonstiff = np.zeros_like(mask)
        for i in getattr(self.model, 'f_expl_indices', (0,)):
            nonstiff[i] = 1.0
        self.nonstiff_mask = nonstiff

    def _mask(self, name, y):
        """Mask ``name`` over the component axis of ``y`` (model frame), broadcasting against it."""
        m = cached_tensor(self._consts, name, lambda: getattr(self, name), y)
        return m.reshape((-1,) + (1,) * (y.dim() - 1))

    def lmbda_eval(self, u, t):
        """Full-shape lambda; zero on non-exponential components."""
        y = self._model_frame(u)
        return self._from_model_frame(self.model.lmbda_exp(y) * self._mask('exp_mask', y), u)

    def eval_f(self, u, t):
        impl = self._impl(u)
        y = self._model_frame(u)
        lm, yinf = self.model.lmbda_yinf_exp(y)
        expl = self._add_stimulus(self.model.f_expl(y), t, u) * self._mask('nonstiff_mask', y)
        f_exp = lm * (y - yinf) * self._mask('exp_mask', y)
        return IMEXEXP(impl=impl, expl=self._from_model_frame(expl, u), exp=self._from_model_frame(f_exp, u))
