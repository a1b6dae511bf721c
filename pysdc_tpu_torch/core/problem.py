"""Problem protocol: the model layer's contract with sweepers and levels.

The counterpart of ``pysdc_tpu/core/problem.py`` (reference
``pySDC/core/problem.py:43-215``).  A problem is a host object holding its
configuration plus constant tensors on its ``device``; its methods are eager
functions of ``(u, t)`` on tensors.

Key protocol (names follow the reference):
  - ``eval_f(u, t)``                      RHS evaluation -> tensor / IMEX / Comp2
  - ``solve_system(rhs, factor, u0, t)``  solve ``(I - factor*A) u = rhs``
  - ``solve_jacobian(rhs, factor, u, t)`` solve ``(I - factor*J(u)) x = rhs``
                                          (ParaDiag; ``factor`` may be complex)
  - ``u_exact(t)``                        exact/reference solution when known
  - ``u_init``                            zero state of the right shape/dtype

The batched variants take the collocation nodes as a leading axis of ``u``
(``(M, *shape)``).  The base versions loop over that axis; problems whose
operators take leading batch axes (``HeatND``) override them with one call.
"""

from __future__ import annotations

import inspect
from typing import Any

import numpy as np
import torch

from pysdc_tpu_torch.core.device import resolve_device
from pysdc_tpu_torch.core.errors import ParameterError, ProblemError
from pysdc_tpu_torch.core.state import IMEX, Comp2, map_components


class WorkCounter:
    """Host-side work counter (reference ``pySDC/core/problem.py:16-41``).

    Problems register counters but do not tick them per evaluation: the level
    adds the statically known work of each sweep (``Level._account_work``),
    as the JAX package does, so ``LogWork`` reports the same numbers there as
    on the JAX package's compiled runs."""

    def __init__(self):
        self.niter = 0

    def __call__(self, n=1):
        self.niter += n

    def decrement(self, n=1):
        self.niter -= n

    def __str__(self):
        return str(self.niter)


def count_work(prob, key: str, n: int = 1) -> None:
    """Tick ``prob``'s work counter ``key`` by ``n`` where it has one: for an
    evaluation made outside a sweep (a fault injector's, a collocation
    switch's), which the JAX package counts per call."""
    if key in prob.work_counters:
        prob.work_counters[key](n)


class Problem:
    """Base class for all problems."""

    #: 'single' | 'imex' | 'comp2' — shape of the RHS
    f_kind = 'single'

    def __init__(self, shape, dtype=None, device='cuda'):
        self.shape = tuple(shape)
        self.dtype = torch.float64 if dtype is None else dtype
        if self.dtype not in (torch.float32, torch.float64, torch.complex64, torch.complex128):
            raise ParameterError(f'dtype must be torch.float32, float64, complex64 or complex128, got {dtype!r}')
        self.device = resolve_device(device)
        self.work_counters: dict[str, WorkCounter] = {}
        self.params: dict[str, Any] = {}

    # -- parameter registration (reference RegisterParams, core/common.py:25)
    def _register(self, **kwargs):
        for key, value in kwargs.items():
            setattr(self, key, value)
            self.params[key] = value

    # ------------------------------------------------------------------
    @property
    def u_init(self):
        return torch.zeros(self.shape, dtype=self.dtype, device=self.device)

    @property
    def f_init(self):
        z = self.u_init
        if self.f_kind == 'imex':
            return IMEX(z, z.clone())
        if self.f_kind == 'comp2':
            return Comp2(z, z.clone())
        return z

    #: True once prepare_node_solvers installed per-node factorizations;
    #: sweepers then pass the collocation-node index to solve_system as
    #: ``node=`` so the prepared factors are selected
    accepts_node_index = False

    def prepare_node_solvers(self, dt: float, qd_diag) -> None:
        """Amortize shifted-solve factorizations across a run.

        Called at level setup with the step size and the QDelta diagonal:
        the per-node shifts ``dt*q_mm`` are then known, so operators with
        expensive structured factorizations (block cyclic reduction) can
        factor once and serve every sweep by substitution — the role of the
        reference's dt-keyed splu cache (``generic_ND_FD.py:208-240``).
        No-op unless ``self.A`` supports it.
        """
        A = getattr(self, 'A', None)
        if A is None or not hasattr(A, 'prepare_node_shifts'):
            return
        if 'node' not in inspect.signature(self.solve_system).parameters:
            return  # this problem's solve path cannot route the node index
        shifts = [float(dt) * float(q) for q in np.atleast_1d(qd_diag)]
        if A.prepare_node_shifts(shifts):
            self.accepts_node_index = True

    @property
    def graph_capture_blocker(self):
        """Why the fused lanes' CUDA graphs cannot hold this problem's solves, or None where they can: the
        operator ``A``'s own reason, where it gives one (the iterative solves to a tolerance are device ``while``
        loops there and need none)."""
        return getattr(getattr(self, 'A', None), 'graph_capture_blocker', None)

    # -- protocol ------------------------------------------------------
    def eval_f(self, u, t):
        raise NotImplementedError('problem has to implement eval_f(u, t)')

    def solve_system(self, rhs, factor, u0, t):
        raise NotImplementedError('problem has to implement solve_system(rhs, factor, u0, t)')

    #: True where :meth:`solve_jacobian` reads the state ``u`` it linearizes at (nonlinear problems): ParaDiag
    #: computes its averaged state only then
    jacobian_reads_state = False

    def solve_jacobian(self, rhs, factor, u=None, t=0.0):
        """Solve ``(I - factor * J(u)) x = rhs`` with the Jacobian taken at
        ``u`` (reference problem.py:198; ParaDiag's inner solve).  For linear
        problems this is exactly ``solve_system``; ``factor`` may be complex."""
        return self.solve_system(rhs, factor, rhs, t)

    def solve_jacobian_batched(self, rhs, factor, u=None, t=None):
        """:meth:`solve_jacobian` for a batch: ``factor`` is a tensor (complex
        allowed) and ``t`` a numpy array, both of the batch shape ``lead``;
        ``rhs`` is ``(*lead, *shape)``; ``u`` one state of ``shape`` (or None)
        for every system.  The base solves the systems one by one."""
        lead = tuple(factor.shape)
        flat = rhs.reshape((-1,) + tuple(rhs.shape[len(lead):]))
        fac, ts = factor.reshape(-1), np.asarray(t, dtype=float).reshape(-1)
        return torch.stack([self.solve_jacobian(flat[i], fac[i], u, float(ts[i])) for i in range(flat.shape[0])]
                           ).reshape(rhs.shape)

    def u_exact(self, t):
        raise NotImplementedError(f'{type(self).__name__} does not implement u_exact(t)')

    def generate_scipy_reference_solution(self, eval_rhs, t, u_init, t_init, **kwargs):
        """Accurate ODE reference via ``scipy.integrate.solve_ivp`` on the
        flattened system (host-side, float64); ``eval_rhs(t, y)`` takes and
        returns numpy arrays."""
        from scipy.integrate import solve_ivp

        kwargs = {'rtol': 1e-12, 'atol': 1e-12, 'method': 'DOP853', **kwargs}
        u_init = u_init.detach().cpu().numpy() if isinstance(u_init, torch.Tensor) else np.asarray(u_init)
        shape = u_init.shape

        def rhs_flat(tt, y):
            return np.asarray(eval_rhs(tt, y.reshape(shape))).ravel()

        sol = solve_ivp(rhs_flat, (float(t_init), float(t)), u_init.ravel(), **kwargs)
        if not sol.success:
            raise ProblemError(f'scipy reference solve failed: {sol.message}')
        return torch.as_tensor(sol.y[:, -1].reshape(shape), dtype=self.dtype, device=self.device)

    # -- batched-over-nodes variants -------------------------------------
    def eval_f_batched(self, u, t):
        """u: (M, *shape), t: (M,) -> RHS with a leading node axis."""
        parts = [self.eval_f(u[m], float(t[m])) for m in range(u.shape[0])]
        return map_components(lambda *xs: torch.stack(xs), *parts)

    def solve_system_batched(self, rhs, factor, u0, t):
        """rhs/u0: (M, *shape), factor/t: (M,) -> (M, *shape).  Entries of a device tensor stay on the device
        (0-d views): the fused lanes' graphs read them, they do not hold them."""

        def entry(a, m):
            return a[m] if isinstance(a, torch.Tensor) else float(a[m])

        return torch.stack(
            [self.solve_system(rhs[m], entry(factor, m), u0[m], entry(t, m)) for m in range(rhs.shape[0])]
        )

    def __repr__(self):
        return f'{type(self).__name__}(shape={self.shape}, dtype={self.dtype}, device={self.device})'
