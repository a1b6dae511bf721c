"""Quench: superconducting-magnet runaway heating, 1D Neumann heat + leak.

The counterpart of ``pysdc_tpu/models/quench.py`` (reference ``Quench`` /
``QuenchIMEX``, ``implementations/problem_classes/Quench.py:13-602``):
insulated 1D heat equation (Neumann-zero) with a localized leak that heats the
domain and a threshold nonlinearity that triggers the runaway once the
environment of the leak warms past ``u_thresh``.

The Neumann Laplacian is a :class:`~pysdc_tpu_torch.ops.linop.SeparableFDOperator`
(eigendecomposition direct solves, one dense product per transform), the
masked leak source is ``torch.where`` arithmetic, and the fully implicit solve
is the shared Newton-Krylov loop (:func:`~pysdc_tpu_torch.ops.solvers.newton_pde`)
preconditioned by the exact shifted linear inverse; as in the JAX package, the
reference's 'Gaussian' leak-transition Jacobian heuristic (Quench.py:282-286)
is replaced by the exact subgradient of the max().  Fields may carry leading
batch axes (the nodes of a sweep, the steps of a block).
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.device import cached_tensor
from pysdc_tpu_torch.core.problem import Problem, WorkCounter
from pysdc_tpu_torch.core.state import IMEX
from pysdc_tpu_torch.models.heat import node_shift_column
from pysdc_tpu_torch.ops.fd import get_1d_grid
from pysdc_tpu_torch.ops.linop import SeparableFDOperator
from pysdc_tpu_torch.ops.solvers import newton_pde


class Quench(Problem):
    """``solver_trace`` (when set to a list, each solve appends one ``(Newton iterations, [PCG iterations of
    each])`` per system) and ``host_reads`` observe the Newton solves."""

    def __init__(self, Cv=1000.0, K=1000.0, u_thresh=3e-2, u_max=6e-2, Q_max=1.0,
                 leak_range=(0.45, 0.55), leak_type='linear', leak_transition='step',
                 order=2, bc='neumann-zero', nvars=2**7, newton_tol=1e-8,
                 newton_maxiter=99, lin_maxiter=99, reference_sol_type='scipy', dtype=None, device='cuda'):
        super().__init__(shape=(nvars,), dtype=dtype, device=device)
        dx, xv = get_1d_grid(nvars, bc)
        self._register(
            Cv=Cv, K=K, u_thresh=u_thresh, u_max=u_max, Q_max=Q_max,
            leak_range=leak_range, leak_type=leak_type, leak_transition=leak_transition,
            order=order, bc=bc, nvars=nvars, newton_tol=newton_tol,
            newton_maxiter=newton_maxiter, lin_maxiter=lin_maxiter, dx=dx,
            reference_sol_type=reference_sol_type,
        )
        self.xv = xv
        self.A = SeparableFDOperator([dict(size=nvars, dx=dx, derivative=2, order=order, bc=bc)], scale=K / Cv)
        self.leak = np.logical_and(xv > leak_range[0], xv < leak_range[1])
        self._consts: dict = {}
        self.solver_trace = None
        self.host_reads = 0
        self.work_counters['newton'] = WorkCounter()
        self.work_counters['rhs'] = WorkCounter()

    def _gauss(self, like):
        return cached_tensor(self._consts, 'gauss', lambda: self.Q_max * np.exp(-((np.asarray(self.xv) - 0.5) ** 2)
                                                                             / 3e-2), like)

    def _leak(self, like):
        return cached_tensor(self._consts, 'leak', lambda: self.leak, like, torch.bool)

    # -- leak source ----------------------------------------------------
    def eval_f_non_linear(self, u, t):
        """Masked heat source (reference Quench.py:189-228)."""
        uth, umx, Q = self.u_thresh, self.u_max, self.Q_max
        if self.leak_type == 'linear':
            base = (u - uth) / (umx - uth) * Q
        elif self.leak_type == 'exponential':
            base = Q * (torch.exp(u) - np.exp(uth)) / (np.exp(umx) - np.exp(uth))
        else:
            raise NotImplementedError(f'Leak type {self.leak_type!r} not implemented!')
        me = torch.where(u < uth, torch.zeros_like(base), base)
        if self.leak_transition == 'step':
            me = torch.where(self._leak(u), torch.full_like(me, Q), me)
        elif self.leak_transition == 'Gaussian':
            me = torch.maximum(me, self._gauss(u))
        else:
            raise NotImplementedError(f'Leak transition {self.leak_transition!r} not implemented!')
        me = torch.where(u >= umx, torch.full_like(me, Q), me)
        return me / self.Cv

    def _non_linear_prime(self, u):
        """d/du of the leak source: exact subgradient of the masks."""
        uth, umx, Q = self.u_thresh, self.u_max, self.Q_max
        if self.leak_type == 'linear':
            base = torch.full_like(u, Q / (umx - uth))
            val = (u - uth) / (umx - uth) * Q
        else:
            base = Q * torch.exp(u) / (np.exp(umx) - np.exp(uth))
            val = Q * (torch.exp(u) - np.exp(uth)) / (np.exp(umx) - np.exp(uth))
        zero = torch.zeros_like(u)
        me = torch.where(u < uth, zero, base)
        val = torch.where(u < uth, zero, val)
        if self.leak_transition == 'step':
            me = torch.where(self._leak(u), zero, me)
        else:  # Gaussian: derivative only where the u-dependent branch wins
            me = torch.where(val >= self._gauss(u), me, zero)
        me = torch.where(u >= umx, zero, me)
        return me / self.Cv

    # -- protocol -------------------------------------------------------
    def eval_f(self, u, t):
        return self.A.apply(u) + self.eval_f_non_linear(u, t)

    def eval_f_batched(self, u, t):
        """The nodes (and a block's steps behind them) in one evaluation: ``eval_f`` does not read ``t``."""
        return self.eval_f(u, t)

    def _newton(self, rhs, factor, u0):
        u, info = newton_pde(
            self.A.apply, self.A.solve_shifted, lambda u: self.eval_f_non_linear(u, 0.0), self._non_linear_prime,
            rhs, factor, u0, newton_tol=self.newton_tol, newton_maxiter=self.newton_maxiter,
            lin_maxiter=self.lin_maxiter, batch_ndim=rhs.dim() - len(self.shape),
        )
        self.host_reads += info.reads
        if self.solver_trace is not None:
            self.solver_trace.extend(info.per_system())
        return u

    def solve_system(self, rhs, factor, u0, t):
        return self._newton(rhs, factor, u0)

    def solve_system_batched(self, rhs, factor, u0, t):
        """All nodes in one Newton solve, each node (and each step of a block) its own system with its own shift."""
        return self._newton(rhs, node_shift_column(self.A, factor, rhs), u0)

    def u_exact(self, t, u_init=None, t_init=None):
        """t=0: cold magnet; t>0: reference solution by ``reference_sol_type``
        — stiff scipy BDF, a tight fully-implicit SDC run, or adaptive DIRK
        (reference Quench.py:364-476)."""
        if isinstance(t, (int, float)) and t == 0:
            return torch.zeros(self.shape, dtype=self.dtype, device=self.device)

        u_init = torch.zeros(self.shape, dtype=self.dtype, device=self.device) if u_init is None else u_init
        t_init = 0.0 if t_init is None else t_init

        if self.reference_sol_type == 'scipy':
            def eval_rhs(tt, u):
                u = torch.as_tensor(u, dtype=self.dtype, device=self.device)
                return self.eval_f(u, tt).detach().cpu().numpy()

            return self.generate_scipy_reference_solution(eval_rhs, t, u_init, t_init, method='BDF')
        if self.reference_sol_type not in ('SDC', 'DIRK'):
            raise ValueError(f'unknown reference_sol_type {self.reference_sol_type!r}')

        from pysdc_tpu_torch.parallel.nonmpi import ControllerNonMPI

        desc = dict(
            # always the fully-implicit base problem: the IMEX subclass's split RHS would crash the
            # fully-implicit reference sweepers below (the reference pins Quench too, Quench.py:428)
            problem_class=Quench,
            problem_params=dict(
                Cv=self.Cv, K=self.K, u_thresh=self.u_thresh, u_max=self.u_max,
                Q_max=self.Q_max, leak_range=self.leak_range, leak_type=self.leak_type,
                leak_transition=self.leak_transition, order=self.order, bc=self.bc,
                nvars=self.nvars, newton_tol=1e-10, newton_maxiter=99, dtype=self.dtype, device=self.device,
            ),
        )
        if self.reference_sol_type == 'DIRK':
            from pysdc_tpu_torch.convergence.adaptivity import AdaptivityRK
            from pysdc_tpu_torch.sweepers.runge_kutta import DIRK43

            desc.update(
                sweeper_class=DIRK43, sweeper_params={},
                step_params=dict(maxiter=1),
                level_params=dict(dt=1e-4, restol=-1.0),
                convergence_controllers={AdaptivityRK: {'e_tol': 1e-9, 'update_order': 4}},
            )
        else:  # SDC
            from pysdc_tpu_torch.sweepers.generic_implicit import GenericImplicit

            desc.update(
                sweeper_class=GenericImplicit,
                sweeper_params=dict(num_nodes=3, QI='IE', quad_type='RADAU-RIGHT'),
                step_params=dict(maxiter=99),
                level_params=dict(dt=min(0.5, float(t) - float(t_init)), restol=1e-10),
            )
        ctrl = ControllerNonMPI(1, {'logger_level': 40, 'mssdc_jac': False}, desc)
        uend, _ = ctrl.run(u_init, float(t_init), float(t))
        return uend.to(self.dtype)


class QuenchIMEX(Quench):
    """Linear diffusion implicit (exact shifted solve), leak source explicit
    (reference Quench.py:477-602)."""

    f_kind = 'imex'

    def eval_f(self, u, t):
        return IMEX(impl=self.A.apply(u), expl=self.eval_f_non_linear(u, t))

    def solve_system(self, rhs, factor, u0, t):
        return self.A.solve_shifted(rhs, factor)

    def solve_system_batched(self, rhs, factor, u0, t):
        """One transform pair for all nodes, one shift per node."""
        return self.A.solve_shifted(rhs, node_shift_column(self.A, factor, rhs))
