"""1D acoustic-advection (fast-wave slow-wave) problem, IMEX.

The counterpart of ``pysdc_tpu/models/acoustic.py`` (reference
``acoustic_1d_imex``, implementations/problem_classes/
AcousticAdvection_1D_FD_imex.py, and the FastWaveSlowWave project):
u = (p, v) on a periodic interval with

    p_t + c_adv p_x + c_s v_x = 0
    v_t + c_adv v_x + c_s p_x = 0

the stiff sound waves (c_s) implicit and the slow advection (c_adv)
explicit.  Spectral derivatives (``torch.fft``, cuFFT on the card); the
per-mode 2x2 implicit systems invert in closed form.  Exact solution by
characteristics.  Fields may carry leading batch axes in front of ``(2, nvars)``.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.device import cached_tensor
from pysdc_tpu_torch.core.problem import Problem, WorkCounter
from pysdc_tpu_torch.core.state import IMEX


class AcousticAdvection1D(Problem):
    f_kind = 'imex'

    def __init__(self, nvars=512, cs=0.5, cadv=0.1, waveno=5, dtype=None, device='cuda'):
        super().__init__(shape=(2, nvars), dtype=dtype, device=device)
        self._register(nvars=nvars, cs=cs, cadv=cadv, waveno=waveno)
        self.k = 2 * np.pi * np.fft.fftfreq(nvars, d=1.0 / nvars)
        self.xvalues = np.arange(nvars) / nvars
        self._consts: dict = {}
        self.work_counters['rhs'] = WorkCounter()

    @property
    def mesh(self):
        return torch.as_tensor(self.xvalues, dtype=self.dtype, device=self.device)

    def _ik(self, like):
        """1j k in ``like``'s complex dtype on its device, made once and kept."""
        return cached_tensor(self._consts, 'ik', lambda: 1j * self.k, like)

    def _dx(self, u):
        u_hat = torch.fft.fft(u)
        return torch.fft.ifft(self._ik(u_hat) * u_hat).real.to(u.dtype)

    def eval_f(self, u, t):
        p, v = u[..., 0, :], u[..., 1, :]
        impl = torch.stack([-self.cs * self._dx(v), -self.cs * self._dx(p)], dim=-2)
        expl = torch.stack([-self.cadv * self._dx(p), -self.cadv * self._dx(v)], dim=-2)
        return IMEX(impl=impl, expl=expl)

    def eval_f_batched(self, u, t):
        """The nodes (and a block's steps behind them) in one evaluation: ``eval_f`` does not read ``t``."""
        return self.eval_f(u, t)

    def solve_system(self, rhs, factor, u0, t):
        """(I + factor*cs*Dx_swap) solved per Fourier mode in closed form."""
        p_hat = torch.fft.fft(rhs[..., 0, :])
        v_hat = torch.fft.fft(rhs[..., 1, :])
        a = factor * self.cs * self._ik(p_hat)
        det = 1.0 - a**2
        p_new = (p_hat - a * v_hat) / det
        v_new = (v_hat - a * p_hat) / det
        return torch.stack([torch.fft.ifft(p_new).real, torch.fft.ifft(v_new).real], dim=-2).to(rhs.dtype)

    def u_exact(self, t, u_init=None, t_init=None):
        """d'Alembert characteristics (reference :195-222)."""

        def u_initial(x, k):
            return torch.sin(k * 2.0 * np.pi * x) + torch.sin(2.0 * np.pi * x)

        x = self.mesh
        k = self.waveno
        t = float(t)
        fast = u_initial(x - (self.cadv + self.cs) * t, k)
        slow = u_initial(x - (self.cadv - self.cs) * t, k)
        p = 0.5 * fast - 0.5 * slow
        v = 0.5 * fast + 0.5 * slow
        return torch.stack([p, v]).to(self.dtype)
