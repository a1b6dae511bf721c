"""Matrix-based MSSDC/MLSDC/PFASST controller (verification tool).

The counterpart of ``pysdc_tpu/parallel/matrix_controller.py`` (reference
``controller_matrix_nonMPI``,
``projects/matrixPFASST/controller_matrix_nonMPI.py:8-357``): the whole
space-time block iteration is assembled as one composite matrix

    C = I - dt (I_steps x Q x A) - (E x N x I_space)
    P = I - dt (I_steps x QDelta x A)                   (fine smoother)
    P_c likewise on the coarse level, with transfer T_cf/T_fc

and PFASST becomes the stationary iteration
``u += T_cf P_c^{-1} T_fc r;  r = u0 - C u;  u += P^{-1} r`` — exactly the
algorithm the step-based controller executes, so iteration counts and
solutions must match to round-off.

The operator ``A`` and the space transfers are materialised by
:func:`dense_from_apply`, ``torch.func.vmap`` of the apply over the identity:
on the card a 2D periodic ``A`` is one batched launch of kernel K1 through its
vmap rule.  The Kronecker products are assembled with ``torch.kron`` on the
problem's device, the preconditioners are LU-factorised once
(``torch.linalg.lu_factor``), and each iteration is a few dense products and
triangular solves there.  A dense matrix holds ``(nsteps M nspace)^2``
numbers: this is a tool for small grids.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.device import resolve_device
from pysdc_tpu_torch.core.errors import ControllerError
from pysdc_tpu_torch.parallel.nonmpi import ControllerNonMPI
from pysdc_tpu_torch.sweepers.generic_implicit import GenericImplicit


def dense_from_apply(apply_fn, n: int, dtype=torch.float64, device='cuda') -> torch.Tensor:
    """Materialize a dense matrix from a linear operator by applying it to
    the identity (columns batched through ``torch.func.vmap``) on ``device``,
    the card unless the caller asks for the CPU."""
    eye = torch.eye(n, dtype=dtype, device=resolve_device(device))
    cols = torch.func.vmap(apply_fn)(eye)  # row i of cols = A e_i
    return cols.T.contiguous()


def _solve(lu, rhs):
    return torch.linalg.lu_solve(lu[0], lu[1], rhs.unsqueeze(-1)).squeeze(-1)


class ControllerMatrixNonMPI(ControllerNonMPI):
    """Serial matrix-based controller; restrictions as in the reference:
    GenericImplicit sweeper, linear problems (operator ``prob.A``),
    right-is-node quadrature, <= 2 levels, constant dt."""

    def __init__(self, num_procs, controller_params, description):
        if description['sweeper_class'] is not GenericImplicit:
            raise ControllerError('matrix controller only works with GenericImplicit')
        controller_params = dict(controller_params)
        controller_params.setdefault('all_to_done', True)
        super().__init__(num_procs, controller_params, description)
        if self.params.predict_type is not None:
            raise ControllerError('matrix controller has no predictor')

        self.nsteps = len(self.MS)
        self.nlevels = len(self.MS[0].levels)
        if self.nlevels > 2:
            raise ControllerError('matrix-PFASST supports at most 2 levels')
        lvl = self.MS[0].levels[0]
        if not lvl.sweep.coll.right_is_node:
            raise ControllerError('need right_is_node quadrature (RADAU-RIGHT/LOBATTO)')
        self.nnodes = lvl.sweep.coll.num_nodes
        self.nspace = int(np.prod(lvl.prob.shape))
        self.dt = lvl.params.dt
        self.tol = lvl.params.restol
        self.maxiter = self.MS[0].params.maxiter

        prob = lvl.prob
        shape = prob.shape
        dtype, device = prob.dtype, prob.device
        self.dtype, self.device = dtype, device

        def const(arr):
            return torch.as_tensor(np.asarray(arr), dtype=dtype, device=device)

        def eye(n):
            return torch.eye(n, dtype=dtype, device=device)

        A = dense_from_apply(lambda v: prob.eval_f(v.reshape(shape), 0.0).reshape(-1), self.nspace, dtype, device)
        Q = const(lvl.sweep.coll.Qmat[1:, 1:])
        Qd = const(lvl.sweep.QI[1:, 1:])

        E = np.zeros((self.nsteps, self.nsteps))
        np.fill_diagonal(E[1:, :], 1)
        E = const(E)
        N = np.zeros((self.nnodes, self.nnodes))
        N[:, -1] = 1
        N = const(N)
        I_steps = eye(self.nsteps)

        I_big = eye(self.nsteps * self.nnodes * self.nspace)
        self.C = (
            I_big
            - self.dt * torch.kron(I_steps, torch.kron(Q, A))
            - torch.kron(E, torch.kron(N, eye(self.nspace)))
        )
        self.P = I_big - self.dt * torch.kron(I_steps, torch.kron(Qd, A))
        del I_big

        if self.nlevels > 1:
            lvl_c = self.MS[0].levels[1]
            prob_c = lvl_c.prob
            shape_c = prob_c.shape
            self.nspace_c = int(np.prod(shape_c))
            self.nnodes_c = lvl_c.sweep.coll.num_nodes
            Ac = dense_from_apply(
                lambda v: prob_c.eval_f(v.reshape(shape_c), 0.0).reshape(-1), self.nspace_c, dtype, device
            )
            Qdc = const(lvl_c.sweep.QI[1:, 1:])
            Nc = np.zeros((self.nnodes_c, self.nnodes_c))
            Nc[:, -1] = 1
            Nc = const(Nc)

            bt = self.MS[0].base_transfers[0]
            st = bt.space_transfer
            TcfA = dense_from_apply(
                lambda v: st.prolong(v.reshape(shape_c)).reshape(-1), self.nspace_c, dtype, device
            )  # (nspace, nspace_c) columns = prolong(e_i)
            TfcA = dense_from_apply(
                lambda v: st.restrict(v.reshape(shape)).reshape(-1), self.nspace, dtype, device
            )
            self.Tcf = torch.kron(I_steps, torch.kron(const(bt.Pcoll), TcfA))
            self.Tfc = torch.kron(I_steps, torch.kron(const(bt.Rcoll), TfcA))
            self.Pc = (
                eye(self.nsteps * self.nnodes_c * self.nspace_c)
                - self.dt * torch.kron(I_steps, torch.kron(Qdc, Ac))
                - torch.kron(E, torch.kron(Nc, eye(self.nspace_c)))
            )

        self._lu_P = torch.linalg.lu_factor(self.P)
        if self.nlevels > 1:
            self._lu_Pc = torch.linalg.lu_factor(self.Pc)

        self._nsweeps_f = lvl.params.nsweeps if hasattr(lvl.params, 'nsweeps') else 1
        self._nsweeps_c = (
            self.MS[0].levels[-1].params.nsweeps
            if self.nlevels > 1 and hasattr(self.MS[0].levels[-1].params, 'nsweeps')
            else 1
        )

    def _iterate(self, u, u0vec):
        """One iteration: the coarse correction(s), then the fine smoother."""
        res = u0vec - self.C @ u
        if self.nlevels > 1:
            for _ in range(self._nsweeps_c):
                u = u + self.Tcf @ _solve(self._lu_Pc, self.Tfc @ res)
                res = u0vec - self.C @ u
        for _ in range(self._nsweeps_f):
            u = u + _solve(self._lu_P, res)
            res = u0vec - self.C @ u
        return u, res

    # ------------------------------------------------------------------
    def run(self, u0, t0, Tend):
        for hook in self.hooks:
            hook.reset_stats()
        nblocks_f = (Tend - t0) / self.dt / self.nsteps
        if abs(nblocks_f - round(nblocks_f)) > 1e-8:
            raise ControllerError('dt, t0, Tend and num_procs do not divide the interval evenly')
        nblocks = int(round(nblocks_f))

        u0f = torch.as_tensor(u0, dtype=self.dtype, device=self.device).reshape(-1)
        spread = self.MS[0].levels[0].sweep.initial_guess == 'spread'

        for p, S in enumerate(self.MS):
            S.status.slot = p
            for hook in self.hooks:
                hook.pre_run(step=S, level_number=0)

        uend = u0f
        time = t0
        for _ in range(nblocks):
            u0vec = torch.cat([uend.repeat(self.nnodes), uend.new_zeros((self.nsteps - 1) * self.nnodes * self.nspace)])
            u = uend.repeat(self.nsteps * self.nnodes) if spread else u0vec

            for p, S in enumerate(self.MS):
                S.status.iter = 0
                for lvl in S.levels:
                    lvl.status.time = time + p * self.dt
                for hook in self.hooks:
                    hook.pre_step(step=S, level_number=0)

            niter = 0
            res_norm = float((u0vec - self.C @ u).abs().max())
            while res_norm > self.tol and niter < self.maxiter:
                niter += 1
                u, res = self._iterate(u, u0vec)
                per_step = res.reshape(self.nsteps, -1).abs().amax(dim=1).tolist()  # one read an iteration
                res_norm = max(per_step)
                for p, S in enumerate(self.MS):
                    S.status.iter = niter
                    S.levels[0].status.residual = per_step[p]
                    for hook in self.hooks:
                        hook.post_iteration(step=S, level_number=0)

            for p, S in enumerate(self.MS):
                for hook in self.hooks:
                    hook.post_step(step=S, level_number=0)

            # uend = last node of the last step (right_is_node)
            uend = u[-self.nspace:]
            time += self.nsteps * self.dt

        for S in self.MS:
            for hook in self.hooks:
                hook.post_run(step=S, level_number=0)

        stats = {}
        for hook in self.hooks:
            stats.update(hook.return_stats())
        return uend.reshape(self.MS[0].levels[0].prob.shape), stats

    # ------------------------------------------------------------------
    def build_propagation_matrix(self, niter: int) -> torch.Tensor:
        """Propagation matrix over one block for a fixed iteration count
        (reference controller_matrix_nonMPI.py:181-226), on the problem's
        device.  The reference's sum of matrix powers is taken from the left:
        only the last step's last node is read (``Treduce``), so each power is
        a product of ``nspace`` rows, not of the whole matrix."""
        n_f = self.nsteps * self.nnodes * self.nspace
        eye = torch.eye(n_f, dtype=self.dtype, device=self.device)
        Pinv = torch.linalg.inv(self.P)
        precond_smoother = Pinv.clone()
        iter_mat_smoother = eye - precond_smoother @ self.C
        for k in range(1, self._nsweeps_f):
            precond_smoother += torch.linalg.matrix_power(iter_mat_smoother, k) @ Pinv
        iter_mat_smoother = torch.linalg.matrix_power(iter_mat_smoother, self._nsweeps_f)

        if self.nlevels > 1:
            precond_cgc = self.Tcf @ torch.linalg.inv(self.Pc) @ self.Tfc
            iter_mat_cgc = eye - precond_cgc @ self.C
            iter_mat = iter_mat_smoother @ iter_mat_cgc
            precond = precond_smoother + precond_cgc - precond_smoother @ self.C @ precond_cgc
        else:
            iter_mat = iter_mat_smoother
            precond = precond_smoother
        del eye

        def const(arr):
            return torch.as_tensor(np.asarray(arr, dtype=float), dtype=self.dtype, device=self.device)

        I_space = torch.eye(self.nspace, dtype=self.dtype, device=self.device)
        Tspread = torch.kron(const(np.ones(self.nsteps * self.nnodes)), I_space).T
        Tnospread = torch.kron(
            const(np.concatenate([[1], [0] * (self.nsteps - 1)])),
            torch.kron(const(np.ones(self.nnodes)), I_space),
        ).T
        rows = torch.kron(const(np.concatenate([[0] * (self.nsteps * self.nnodes - 1), [1]])), I_space)  # Treduce

        precond_in = precond @ Tnospread
        mat = torch.zeros((self.nspace, self.nspace), dtype=self.dtype, device=self.device)
        for _ in range(niter):  # rows = Treduce iter_mat^k
            mat += rows @ precond_in
            rows = rows @ iter_mat
        T0 = Tspread if self.MS[0].levels[0].sweep.initial_guess == 'spread' else Tnospread
        return mat + rows @ T0
