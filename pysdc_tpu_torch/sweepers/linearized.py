"""Newton-linearized node-parallel SDC sweepers (the parallelSDC family).

The counterpart of ``pysdc_tpu/sweepers/linearized.py`` (reference
parallelSDC project sweepers, ``projects/parallelSDC/
linearized_implicit_parallel.py:6-95``, ``linearized_implicit_fixed_parallel.py:6-90``,
``linearized_implicit_fixed_parallel_prec.py:6-35``): instead of a
nonlinear Newton solve per node, one sweep linearizes the collocation
problem around the current iterate and solves the M node systems
simultaneously in the eigenbasis of the chosen node-coupling matrix:

    G(u)_m   = u0 + dt (Q f(u))_m - u_m + tau_m       (collocation residual)
    Gv       = V^-1 G(u)                               (complex transform)
    x_m      : (I - dt D_m J) x_m = Gv_m               (decoupled solves)
    u^{k+1}  = u^k + Re(V x)

where D, V come from ``eig(Q)`` (Jacobian frozen: the exact parallel
Newton-SDC of the "fixed" variant) or ``eig(QDelta)`` (the preconditioned
flavors), and J is the RHS Jacobian — frozen at one node, or evaluated
per node for the non-fixed variant.

The M complex dense solves are one batched
:func:`pysdc_tpu_torch.ops.linalg.solve` (no error flag read on the host, a
route that a CUDA graph capture takes: LAPACK's ``solve_ex`` on the CPU; on the
card cuBLAS's batched LU below 512 rows and the pivoted blocked LU with its
panel kernel from 512 rows on; complex128 for float64 fields, complex64 for
float32).  Jacobians come from the problem's
``eval_jacobian`` where it has one, else from ``torch.func.jacfwd`` of the
flattened RHS, one system at a time.  A dense Jacobian is for small systems;
where ``eval_f`` applies kernel K1 on the card, ``jacfwd`` reaches it through
K1's jvp and vmap rules: one batched launch a Jacobian.  Leading
axes in front of the problem's shape (a block's time axis) are independent
systems.  The fused lanes capture this sweeper.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.device import complex_dtype
from pysdc_tpu_torch.core.errors import ParameterError
from pysdc_tpu_torch.core.state import LevelState
from pysdc_tpu_torch.ops import linalg
from pysdc_tpu_torch.sweepers.generic_implicit import GenericImplicit


class LinearizedImplicitParallel(GenericImplicit):
    """params (on top of GenericImplicit's):

    - ``jacobian``: ``'per_node'`` — evaluate J at every node's current
      iterate (reference ``linearized_implicit_parallel``); or an int node
      index 0..M to freeze J at that node's iterate (reference
      ``fixed_time_in_jacobian``, default of the fixed variants).
    - ``basis``: ``'Q'`` — diagonalize the full collocation matrix (exact
      linearized collocation solve per sweep, reference
      ``linearized_implicit_fixed_parallel``); or ``'QI'`` — diagonalize
      the QDelta preconditioner (reference ``linearized_implicit_parallel``
      / ``..._fixed_parallel_prec``).
    """

    def __init__(self, params: dict):
        params = dict(params)
        params.setdefault('jacobian', 0)
        params.setdefault('basis', 'Q')
        super().__init__(params)
        self.jacobian = params['jacobian']
        self.basis = params['basis']
        M = self.coll.num_nodes
        if self.jacobian != 'per_node' and self.jacobian not in range(M + 1):
            raise ParameterError(f'jacobian must be "per_node" or a node index 0..{M}')
        if self.basis == 'Q':
            A = np.asarray(self.coll.q)
        elif self.basis == 'QI':
            A = np.asarray(self.QI[1:, 1:])
        else:
            raise ParameterError(f'basis must be "Q" or "QI", got {self.basis!r}')
        D, V = np.linalg.eig(A)
        self.D, self.V, self.Vi = D, V, np.linalg.inv(V)
        self.parallelizable = True  # node solves decouple in the eigenbasis

    @staticmethod
    def _jac(prob, u, t):
        """Jacobians ``(S, n, n)`` of the RHS at the ``S`` systems ``u (S, *shape)`` at times ``t`` (a number or
        ``S`` of them)."""
        S, n = u.shape[0], u[0].numel()
        if hasattr(prob, 'eval_jacobian'):
            return prob.eval_jacobian(u, t).reshape(S, n, n)
        times = t.reshape(-1) if isinstance(t, torch.Tensor) else np.broadcast_to(np.asarray(t, dtype=float), (S,))
        shape = u.shape[1:]
        out = []
        for s in range(S):
            ts = times[s] if isinstance(times, torch.Tensor) else float(times[s])
            out.append(torch.func.jacfwd(lambda v: prob.eval_f(v.reshape(shape), ts).reshape(-1))(u[s].reshape(-1)))
        return torch.stack(out)

    def _jacobians(self, prob, u_nodes, u0, ts, t, B):
        """``(M, B, n, n)`` Jacobians: at every node's iterate, or one frozen and broadcast over the nodes."""
        M = u_nodes.shape[0]
        shape = u0.shape[u0.dim() - len(prob.shape):]
        if self.jacobian == 'per_node':
            times = ts
            if isinstance(ts, torch.Tensor):
                times = ts.reshape(M, -1).expand(M, B).reshape(-1)
            elif B > 1:
                times = np.repeat(np.asarray(ts, dtype=float), B)
            J = self._jac(prob, u_nodes.reshape((M * B,) + tuple(shape)), times)
            return J.reshape((M, B) + J.shape[1:])
        u_fix = u0 if self.jacobian == 0 else u_nodes[self.jacobian - 1]
        t_fix = t if self.jacobian == 0 else self.node_time(ts, self.jacobian - 1)
        J = self._jac(prob, u_fix.reshape((B,) + tuple(shape)), t_fix)
        return J.unsqueeze(0).expand((M,) + tuple(J.shape))

    def update_nodes(self, prob, state: LevelState, t, dt, k: int = 0) -> LevelState:
        M = self.coll.num_nodes
        ts = self.node_times(t, dt)
        u0, u_nodes, f_nodes = state.u[0], state.u[1:], state.f[1:]
        n = int(np.prod(prob.shape))
        B = u0.numel() // n  # the systems of the leading axes (one for a step, P for a block)
        cdtype = complex_dtype(u0.dtype)

        # collocation residual at the current iterate (with FAS tau)
        q = self._coeff('q', lambda: self.coll.q, f_nodes)
        Gu = dt * torch.tensordot(q, f_nodes, dims=1) + u0.unsqueeze(0) + state.tau - u_nodes

        # forward transform into the eigenbasis (complex contraction over nodes)
        Vi = self._coeff('Vi', lambda: self.Vi, u0, dtype=cdtype)
        Gv = torch.tensordot(Vi, Gu.reshape(M, B, n).to(cdtype), dims=1)

        J = self._jacobians(prob, u_nodes, u0, ts, t, B).to(cdtype)
        eye = torch.eye(n, dtype=cdtype, device=u0.device)
        D = self._coeff('D', lambda: self.D.astype(np.complex128), u0, dtype=cdtype).reshape(M, 1, 1, 1)

        # M x B decoupled dense solves, one batched call
        lhs = eye - dt * D * J
        x = linalg.solve(lhs, Gv.unsqueeze(-1)).squeeze(-1)

        # backward transform + Newton update; re-evaluate the RHS
        V = self._coeff('V', lambda: self.V, u0, dtype=cdtype)
        du = torch.tensordot(V, x, dims=1).real.to(u0.dtype)
        u_new = u_nodes + du.reshape(u_nodes.shape)
        f_new = prob.eval_f_batched(u_new, ts)

        u = torch.cat([state.u[:1], u_new])
        f = torch.cat([state.f[:1], f_new])
        return LevelState(u=u, f=f, tau=state.tau)
