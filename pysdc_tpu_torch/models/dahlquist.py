"""Dahlquist test equation u' = lambda * u, batched over many lambdas.

The counterpart of ``pysdc_tpu/models/dahlquist.py`` (reference
``testequation0d`` / ``test_equation_IMEX``,
``pySDC/implementations/problem_classes/TestEquation_0D.py``): the state
vector holds one entry per lambda, so a whole stability-region scan is one
SDC run.  Complex lambdas give a complex state: complex128 unless the caller
asks for complex64.  Every method is elementwise over the last axis, so the
node axis of a sweep and the time axis of a block ride along.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.problem import Problem, WorkCounter
from pysdc_tpu_torch.core.state import IMEX


def _per_node(factor, rhs):
    """Per-system shifts (numbers or a tensor over the leading batch axes of ``rhs``: the nodes, or ParaDiag's
    steps and nodes) shaped to broadcast against ``rhs``.  Complex shifts stay complex."""
    if not isinstance(factor, torch.Tensor):
        factor = np.asarray(factor)
        factor = torch.as_tensor(factor.astype(complex if np.iscomplexobj(factor) else float), device=rhs.device)
    return factor.reshape(tuple(factor.shape) + (1,) * (rhs.dim() - factor.dim()))


class Dahlquist(Problem):
    """params: lambdas (array-like, may be complex), u0 (scalar), dtype, device."""

    def __init__(self, lambdas=None, u0=1.0, dtype=None, device='cuda'):
        lambdas = np.asarray([-1.0] if lambdas is None else lambdas)
        if dtype is None and np.iscomplexobj(lambdas):
            dtype = torch.complex128
        super().__init__(shape=lambdas.shape, dtype=dtype, device=device)
        self._register(lambdas=torch.as_tensor(lambdas, dtype=self.dtype, device=self.device), u0=u0)
        self.work_counters['rhs'] = WorkCounter()

    def eval_f(self, u, t):
        return self.lambdas * u

    def eval_f_batched(self, u, t):
        """Elementwise: the leading node axis rides along."""
        return self.eval_f(u, t)

    def solve_system(self, rhs, factor, u0, t):
        return rhs / (1.0 - factor * self.lambdas)

    def solve_system_batched(self, rhs, factor, u0, t):
        return self.solve_system(rhs, _per_node(factor, rhs), u0, t)

    def solve_jacobian_batched(self, rhs, factor, u=None, t=None):
        """Elementwise: one (complex) shift per system of the batch, one division."""
        return self.solve_system(rhs, _per_node(factor, rhs), rhs, t)

    def u_exact(self, t, u_init=None, t_init=0.0):
        u_init = self.u0 if u_init is None else u_init
        return u_init * torch.exp((float(t) - float(t_init)) * self.lambdas) * torch.ones(
            self.shape, dtype=self.dtype, device=self.device)


class DahlquistIMEX(Dahlquist):
    """IMEX split: ``u' = lambda_S * u + lambda_E * u``; the stiff part is
    implicit, matching the reference ``test_equation_IMEX``."""

    f_kind = 'imex'

    def __init__(self, lambdas_implicit=None, lambdas_explicit=None, u0=1.0, dtype=None, device='cuda'):
        li = np.asarray([-1.0] if lambdas_implicit is None else lambdas_implicit)
        le = np.asarray(np.zeros_like(li) if lambdas_explicit is None else lambdas_explicit)
        if li.shape != le.shape:
            raise ValueError('lambdas_implicit and lambdas_explicit must have equal shapes')
        if dtype is None and (np.iscomplexobj(li) or np.iscomplexobj(le)):
            dtype = torch.complex128
        Problem.__init__(self, shape=li.shape, dtype=dtype, device=device)
        self._register(
            lambdas=torch.as_tensor(li + le, device=self.device),
            lambdas_implicit=torch.as_tensor(li, dtype=self.dtype, device=self.device),
            lambdas_explicit=torch.as_tensor(le, dtype=self.dtype, device=self.device),
            u0=u0,
        )
        self.work_counters['rhs'] = WorkCounter()

    def eval_f(self, u, t):
        return IMEX(impl=self.lambdas_implicit * u, expl=self.lambdas_explicit * u)

    def solve_system(self, rhs, factor, u0, t):
        return rhs / (1.0 - factor * self.lambdas_implicit)

    def u_exact(self, t, u_init=None, t_init=0.0):
        u_init = self.u0 if u_init is None else u_init
        lam = self.lambdas_implicit + self.lambdas_explicit
        return u_init * torch.exp((float(t) - float(t_init)) * lam) * torch.ones(
            self.shape, dtype=self.dtype, device=self.device)

