"""Space-time transfer between two levels with FAS tau correction.

The counterpart of ``pysdc_tpu/transfer/base_transfer.py`` (reference
``BaseTransfer``, ``pySDC/core/base_transfer.py:25-251``): restriction builds
the FAS correction ``tau_G = R I_F(u_F) - I_G(R u_F)`` (plus restricted fine
tau), prolongation adds the interpolated coarse *increment*
``u_G - u_G^old`` and re-evaluates f on the fine level.  Collocation-node
transfer matrices come from barycentric Lagrange interpolation between node
sets.

Each direction is a sequence of eager tensor operations (restriction: 3
space transfers, node-matrix contractions, one coarse RHS evaluation at u0
and one over the nodes).
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.device import cached_tensor
from pysdc_tpu_torch.core.errors import TransferError, UnlockError
from pysdc_tpu_torch.core.state import LevelState, map_components
from pysdc_tpu_torch.ops.lagrange import interpolation_matrix


class BaseTransfer:
    def __init__(self, fine_level, coarse_level, base_transfer_params: dict,
                 space_transfer_class, space_transfer_params: dict):
        self.params = dict(base_transfer_params)
        self.finter = self.params.get('finter', False)
        self.fine = fine_level
        self.coarse = coarse_level
        self._consts: dict = {}

        fine_nodes = fine_level.sweep.coll.nodes
        coarse_nodes = coarse_level.sweep.coll.nodes
        self.same_nodes = len(fine_nodes) == len(coarse_nodes)
        if self.same_nodes:
            self.Pcoll = np.eye(len(fine_nodes))
            self.Rcoll = np.eye(len(fine_nodes))
        else:
            self.Pcoll = self.get_transfer_matrix_Q(fine_nodes, coarse_nodes)
            self.Rcoll = self.get_transfer_matrix_Q(coarse_nodes, fine_nodes)

        self.space_transfer = space_transfer_class(
            fine_prob=self.fine.prob, coarse_prob=self.coarse.prob, params=space_transfer_params
        )

        coarse_op = self.params.get('coarse_op', 'rediscretize')
        if coarse_op == 'galerkin':
            self._install_galerkin_coarse_operator()
        elif coarse_op != 'rediscretize':
            raise ValueError(f"coarse_op must be 'rediscretize' or 'galerkin', got {coarse_op!r}")

    def _install_galerkin_coarse_operator(self):
        """Replace the coarse level's re-discretized operator with the
        variational Galerkin product ``A_c = R A_f P``, assembled by SpGEMM
        (:func:`pysdc_tpu_torch.ops.sparse.galerkin_product`) from the
        transfer's own per-axis interpolation matrices (the sparse-P/R role
        of the reference's ``helpers/transfer_helper.py:91-139``): the coarse
        operator comes from the fine one algebraically instead of by
        re-discretization.  Requires both problems on the assembled-CSR
        backend (``backend='sparse'``) and a MeshTransfer space transfer."""
        from pysdc_tpu_torch.ops.sparse import CSR, galerkin_product
        from pysdc_tpu_torch.ops.sparse_op import SparseOperator

        st = self.space_transfer
        A_f = getattr(self.fine.prob, 'A', None)
        A_c_old = getattr(self.coarse.prob, 'A', None)
        if not (isinstance(A_f, SparseOperator) and isinstance(A_c_old, SparseOperator)):
            raise TransferError(
                "coarse_op='galerkin' needs assembled CSR operators on both levels "
                "(problem backend='sparse')"
            )
        if not hasattr(st, 'P_1d'):
            raise TransferError("coarse_op='galerkin' needs a MeshTransfer space transfer")
        if A_c_old.bc_rhs is not None and np.any(np.asarray(A_c_old.bc_rhs)):
            raise TransferError(
                "coarse_op='galerkin' supports homogeneous boundaries only "
                '(inhomogeneous bc_rhs would need its own restriction)'
            )

        P_nd = R_nd = None
        for P1, R1 in zip(st.P_1d, st.R_1d):
            Pc = CSR.from_dense(np.asarray(P1))
            Rc = CSR.from_dense(np.asarray(R1))
            P_nd = Pc if P_nd is None else P_nd.kron(Pc)
            R_nd = Rc if R_nd is None else R_nd.kron(Rc)

        A_c = galerkin_product(P_nd, A_f.A, R_nd)
        self.coarse.prob.A = SparseOperator(
            A_c, grid_shape=self.coarse.prob.shape, bc_rhs=None, device=self.coarse.prob.device
        )
        # the level factored (I - dt*q*A) for the old operator at setup;
        # redo it for the Galerkin one
        QI = getattr(self.coarse.sweep, 'QI', None)
        if QI is not None and self.coarse.params.dt is not None:
            self.coarse.prob.prepare_node_solvers(
                float(self.coarse.params.dt), np.diag(np.asarray(QI))[1:]
            )

    @staticmethod
    def get_transfer_matrix_Q(f_nodes, c_nodes) -> np.ndarray:
        """Lagrange interpolation from c_nodes to f_nodes
        (reference base_transfer.py:79-91)."""
        return interpolation_matrix(c_nodes, f_nodes)

    def _apply_node_matrix(self, name: str, x):
        """Apply ``Rcoll`` / ``Pcoll`` (an (n_to, n_from) matrix) along the
        leading node axis of a tensor or an RHS container, in full precision
        (core/precision.py).  Equal node sets make it the identity."""
        if self.same_nodes:
            return x
        return map_components(
            lambda leaf: torch.tensordot(
                cached_tensor(self._consts, name, lambda: getattr(self, name), leaf), leaf, dims=1
            ),
            x,
        )

    # -- the two directions, on states -----------------------------------
    def _restrict_state(self, F_state: LevelState, t_coarse, dt_coarse, dt_fine):
        SF, SG = self.fine.sweep, self.coarse.sweep
        PG = self.coarse.prob

        # restrict node values in space, then in collocation
        u_f_space = self.space_transfer.restrict(F_state.u)  # (Mf+1, *coarse_shape)
        u0_c = u_f_space[0]
        u_c_nodes = self._apply_node_matrix('Rcoll', u_f_space[1:])

        # re-evaluate f on the coarse level
        f0_c = PG.eval_f(u0_c, t_coarse)
        f_c_nodes = PG.eval_f_batched(u_c_nodes, SG.node_times(t_coarse, dt_coarse))

        u_c = torch.cat([u0_c.unsqueeze(0), u_c_nodes])
        f_c = map_components(lambda l0, ln: torch.cat([l0.unsqueeze(0), ln]), f0_c, f_c_nodes)

        # FAS: tau_G = R I_F(u_F) - I_G(R u_F) (+ R tau_F); the coarse
        # integral does not read tau, so the state below carries none
        tau_G = SG.integrate(LevelState(u=u_c, f=f_c, tau=None), dt_coarse)
        tau_F_int = SF.integrate(F_state, dt_fine)  # (Mf, *fine_shape)
        tau_FG = self._apply_node_matrix('Rcoll', self.space_transfer.restrict(tau_F_int))

        tau = tau_FG - tau_G
        # restrict any existing fine tau correction as well
        tau = tau + self._apply_node_matrix('Rcoll', self.space_transfer.restrict(F_state.tau))
        return LevelState(u=u_c, f=f_c, tau=tau)

    def _prolong_state(self, F_state: LevelState, G_state: LevelState, G_uold, t_fine, dt_fine):
        SF = self.fine.sweep
        PF = self.fine.prob

        diff = G_state.u[1:] - G_uold[1:]
        corr = self.space_transfer.prolong(self._apply_node_matrix('Pcoll', diff))
        u_nodes = F_state.u[1:] + corr

        f_nodes = PF.eval_f_batched(u_nodes, SF.node_times(t_fine, dt_fine))
        u = torch.cat([F_state.u[:1], u_nodes])
        f = map_components(lambda lf, ln: torch.cat([lf[:1], ln]), F_state.f, f_nodes)
        return LevelState(u=u, f=f, tau=F_state.tau)

    def _prolong_f_state(self, F_state: LevelState, G_state: LevelState, G_uold, G_fold):
        """Prolong both u and f corrections without re-evaluating f
        (reference base_transfer.py:217-251)."""
        diff_u = G_state.u[1:] - G_uold[1:]
        corr_u = self.space_transfer.prolong(self._apply_node_matrix('Pcoll', diff_u))
        u = torch.cat([F_state.u[:1], F_state.u[1:] + corr_u])

        diff_f = map_components(lambda a, b: a[1:] - b[1:], G_state.f, G_fold)
        corr_f = self.space_transfer.prolong(self._apply_node_matrix('Pcoll', diff_f))
        f = map_components(lambda lf, c: torch.cat([lf[:1], lf[1:] + c]), F_state.f, corr_f)
        return LevelState(u=u, f=f, tau=F_state.tau)

    # -- host protocol ---------------------------------------------------
    def restrict(self):
        F, G = self.fine, self.coarse
        if not F.status.unlocked:
            raise UnlockError('fine level is still locked, cannot use data from there')
        G.state = self._restrict_state(F.state, G.status.time, G.params.dt, F.params.dt)
        G.uold = G.state.u
        G.fold = G.state.f
        G.status.unlocked = True

    def prolong(self):
        F, G = self.fine, self.coarse
        if not G.status.unlocked:
            raise UnlockError('coarse level is still locked, cannot use data from there')
        if self.finter:
            F.state = self._prolong_f_state(F.state, G.state, G.uold, G.fold)
        else:
            F.state = self._prolong_state(F.state, G.state, G.uold, F.status.time, F.params.dt)

    def prolong_f(self):
        F, G = self.fine, self.coarse
        if not G.status.unlocked:
            raise UnlockError('coarse level is still locked, cannot use data from there')
        F.state = self._prolong_f_state(F.state, G.state, G.uold, G.fold)
