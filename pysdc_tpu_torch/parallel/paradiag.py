"""ParaDiag controller: all-at-once diagonalization in time.

The counterpart of ``pysdc_tpu/parallel/paradiag.py`` (reference
``controller_ParaDiag_nonMPI``,
``implementations/controller_classes/controller_ParaDiag_nonMPI.py:11-471``)
with the increment formulation of https://arxiv.org/abs/2103.12571:

  per iteration:
    (1) all-at-once residual (uend -> u0 chain + node-local residual)
    (2) alpha-weighted DFT across the L steps
    (3) per-step collocation solves, diagonalized via Q G_l^{-1} = S w S^{-1}
    (4) weighted inverse DFT; add the increment

The whole block lives in one complex tensor ``(L, M, *shape)``.  An iteration
is tensor code on it: one ``eval_f_batched`` over the ``L*M`` nodes (on a 2D
periodic heat block one K1 launch, on the interleaved real view of the complex
field), the weighted DFT in time as a dense ``(L, L)`` complex product, the
per-step ``S^{-1}``, ``S``, ``G^{-1}`` as batched ``(L, M, M)`` products and
the ``L*M`` complex-shifted solves as one ``solve_jacobian_batched`` call (one
transform pair over the block on ``HeatND``).  An iteration reads nothing on
the host; the controller reads the ``(L,)`` residual norms once an iteration.

The coefficient tables are device tensors, made once in the constructor in the
field's complex precision: complex128 for float64 fields, complex64 for
float32 ones (the JAX package's numpy tables are complex128 under x64).

Not ported: ``mesh=`` (the block's time axis sharded over devices) waits for
ROADMAP queue 1, item 10b, and raises by name.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.convergence.basic_restarting import BasicRestarting
from pysdc_tpu_torch.core.device import complex_dtype
from pysdc_tpu_torch.core.errors import ControllerError, ParameterError
from pysdc_tpu_torch.core.state import f_total
from pysdc_tpu_torch.core.step import Step
from pysdc_tpu_torch.parallel.controller import Controller
from pysdc_tpu_torch.sweepers.paradiag import QDiagonalization, compute_diagonalization

MESH_ITEM = 'ROADMAP queue 1, item 10b'


def get_fft_matrix(N: int) -> np.ndarray:
    """Ortho-normalized DFT matrix (reference ParaDiagHelper.py:4-20)."""
    idx = np.arange(N, dtype=complex)
    i1, i2 = np.meshgrid(idx, idx)
    return np.exp(-2 * np.pi * 1j * i1 * i2 / N) / np.sqrt(N)


def get_weighted_fft_matrices(L: int, alpha: float):
    """Weighted FFT/iFFT matrices for the alpha-circulant preconditioner."""
    gamma = alpha ** (-np.arange(L) / L)
    F = get_fft_matrix(L)
    W_fft = F @ np.diag(1 / gamma)
    W_ifft = np.diag(gamma) @ np.conjugate(F)
    return W_fft, W_ifft


def get_G_inv_matrices(L: int, M: int, alpha: float, coll) -> list[np.ndarray]:
    """Per-step G_l^{-1} (reference ParaDiagHelper.py:101-131)."""
    if not coll.right_is_node:
        raise ParameterError('ParaDiag needs RADAU-RIGHT-type collocation (uend = u_M)')
    H = np.zeros((M, M))
    H[:, -1] = 1.0
    gamma = alpha ** (-np.arange(L) / L)
    # first column of E_alpha is [0, -1, 0, ...]^T
    col = np.zeros(L, dtype=complex)
    if L > 1:
        col[1] = -1.0
    diags = np.fft.fft(col / gamma, norm='backward')
    return [np.linalg.inv(diags[l] * H + np.eye(M)) for l in range(L)]


class ParaDiagController(Controller):
    """nonMPI ParaDiag over a block of ``num_procs`` time steps.

    controller_params must contain ``alpha``; ``average_jacobian`` (default
    True) controls the Jacobian linearization point for nonlinear problems.
    """

    def __init__(self, num_procs: int, controller_params: dict, description: dict, mesh=None):
        if 'alpha' not in controller_params:
            raise ParameterError('Please supply alpha as a parameter to the ParaDiag controller!')
        if controller_params.get('all_to_done', True) is False:
            raise NotImplementedError('ParaDiag only implemented with option all_to_done=True')
        if mesh is not None:
            raise ControllerError(f'ParaDiagController(mesh=...) is not ported yet ({MESH_ITEM}: the block\'s time '
                                  f'axis sharded over devices)')
        controller_params = {'average_jacobian': True, 'all_to_done': True, **controller_params}

        description = dict(description)
        description['sweeper_class'] = description.get('sweeper_class', QDiagonalization)

        super().__init__(controller_params, description, useMPI=False)
        self.add_convergence_controller(BasicRestarting, description)

        self.n_steps = num_procs
        self.template = Step(description)
        #: shadow steps (one per time step) so the standard hook machinery
        #: sees real per-step status, as in the reference's ParaDiag
        #: controller (controller_ParaDiag_nonMPI.py:56-90)
        self.MS = [self.template] + [Step(description) for _ in range(num_procs - 1)]
        if len(self.template.levels) != 1:
            raise ControllerError('Multi-level SDC not implemented in ParaDiag')
        lvl = self.template.levels[0]
        if not isinstance(lvl.sweep, QDiagonalization):
            self.logger.warning(
                f'Your sweeper class {type(lvl.sweep).__name__} is not derived from QDiagonalization.'
            )
        self.maxiter = self.template.params.maxiter

        L, M = num_procs, lvl.sweep.coll.num_nodes
        alpha = self.params.alpha
        self.W_fft, self.W_ifft = get_weighted_fft_matrices(L, alpha)
        G_invs = get_G_inv_matrices(L, M, alpha, lvl.sweep.coll)
        # stacked per-step diagonalizations of Q G_l^{-1}
        ws, Ss, S_invs = zip(*(compute_diagonalization(lvl.sweep.coll.q @ G_inv) for G_inv in G_invs))
        self.w = np.stack(ws)  # (L, M)
        self.S = np.stack(Ss)  # (L, M, M)
        self.S_inv = np.stack(S_invs)
        self.G_inv = np.stack(G_invs)

        # the tables on the field's device in its complex precision, once
        prob = lvl.prob
        self.cdtype = complex_dtype(prob.dtype)

        def table(arr):
            return torch.as_tensor(np.asarray(arr, dtype=complex), dtype=self.cdtype, device=prob.device)

        self._tables = {name: table(getattr(self, name)) for name in ('W_fft', 'W_ifft', 'S', 'S_inv', 'G_inv', 'w')}
        self._tables['q'] = table(lvl.sweep.coll.q)

    def all_steps(self):
        return self.MS

    # ------------------------------------------------------------------
    def _node_times(self, t_arr, dt):
        """Times of the ``(L, M)`` nodes of the block, numpy float64."""
        return np.asarray(t_arr, dtype=float)[:, None] + dt * self.template.levels[0].sweep.coll.nodes

    def _iteration(self, u, u0, t_arr, dt):
        """One ParaDiag iteration on the block ``u (L, M, *shape)``; returns
        ``(u_new, residual_norms)``, the norms an ``(L,)`` tensor on the device."""
        prob = self.template.levels[0].prob
        tab = self._tables
        L, M = u.shape[:2]
        ts = self._node_times(t_arr, dt)

        f = prob.eval_f_batched(u.reshape((L * M,) + tuple(u.shape[2:])), ts.reshape(-1))
        ft = f_total(f).reshape(u.shape)
        # all-at-once residual: the u0 chain via uend = u[:, -1] (RADAU-RIGHT)
        u0_steps = torch.cat([u0.unsqueeze(0).to(u.dtype), u[:-1, -1]])
        integral = dt * torch.matmul(tab['q'], ft.reshape(L, M, -1)).reshape(u.shape)
        res = integral + u0_steps.unsqueeze(1) - u
        res_norms = torch.linalg.vector_norm(res.reshape(L, -1), ord=float('inf'), dim=1)

        # averaged state for the Jacobian's linearization, where the problem's solve reads one
        u_avg = None
        if self.params.average_jacobian and prob.jacobian_reads_state:
            u_avg = u.mean(dim=(0, 1)).real.to(prob.dtype)

        # weighted DFT in time: one dense (L, L) product over the step axis
        res_hat = torch.matmul(tab['W_fft'], res.reshape(L, -1))
        # per-step diagonalized solves: batched (L, M, M) node products around one batched solve
        x1 = torch.matmul(tab['S_inv'], res_hat.reshape(L, M, -1))
        x2 = prob.solve_jacobian_batched(x1.reshape(u.shape), dt * tab['w'], u_avg, ts)
        incr_hat = torch.matmul(tab['G_inv'], torch.matmul(tab['S'], x2.reshape(L, M, -1)))
        # weighted inverse DFT in time, add the increment
        incr = torch.matmul(tab['W_ifft'], incr_hat.reshape(L, -1))
        return u + incr.reshape(u.shape), res_norms

    def _predict(self, u0):
        """The block: ``u0`` at every step and node, in the field's complex precision."""
        L, M = self.n_steps, self.template.levels[0].sweep.coll.num_nodes
        return u0.to(self.cdtype).expand((L, M) + tuple(u0.shape)).clone()

    # ------------------------------------------------------------------
    def _fire(self, point, step, lvl, **kw):
        """Broadcast one hook point to every registered hook."""
        for hook in self.hooks:
            getattr(hook, point)(step=step, level_number=lvl, **kw)

    def _sync_shadows(self, u, res_norms, niter):
        """Refresh the shadow steps' status/uend so hooks read live data
        (``res_norms`` host floats; ``uend`` views of the block, no copy)."""
        is_complex = self.template.levels[0].prob.dtype.is_complex
        for j, step in enumerate(self.MS):
            step.status.iter = niter
            L0 = step.levels[0]
            L0.status.residual = res_norms[j]
            L0.status.updated = False
            ue = u[j, -1]
            L0.uend = ue if is_complex else ue.real.to(L0.prob.dtype)

    def run(self, u0, t0, Tend):
        """March ParaDiag blocks from t0 to Tend, firing the standard hook
        points per step (pre/post run, step, iteration — the reference's
        ParaDiag controller drives the same hooks machinery as the PFASST
        controllers, controller_ParaDiag_nonMPI.py:56-90)."""
        lvl = self.template.levels[0]
        prob = lvl.prob
        dt = lvl.params.dt
        restol = lvl.params.restol
        L = self.n_steps
        eps = max(10 * np.finfo(float).eps, 1e-12 * abs(Tend))

        for hook in self.hooks:
            hook.reset_stats()
        self._fire('post_setup', None, None)
        for step in self.MS:
            self._fire('pre_run', step, 0)

        t_block = float(t0)
        uend = u0
        while t_block < Tend - eps:
            t_arr = t_block + dt * np.arange(L)
            for j, step in enumerate(self.MS):
                step.reset_step()
                step.status.slot = j
                step.status.first = j == 0
                step.status.last = j == L - 1
                step.status.iter = 0
                step.status.stage = 'SPREAD'
                L0 = step.levels[0]
                L0.status.sweep = 1
                L0.status.time = float(t_arr[j])
                self._fire('pre_step', step, 0)

            for step in self.MS:
                self._fire('pre_predict', step, 0)
            u = self._predict(uend)
            for step in self.MS:
                self._fire('post_predict', step, 0)
                step.status.stage = 'IT_PARADIAG'

            niter = 0
            while niter < self.maxiter:
                for step in self.MS:
                    step.status.iter = niter + 1
                    self._fire('pre_iteration', step, 0)
                u, res_norms = self._iteration(u, uend, t_arr, dt)
                niter += 1
                norms = res_norms.tolist()  # the one host read of an iteration
                self._sync_shadows(u, norms, niter)
                for step in self.MS:
                    self._fire('post_iteration', step, 0)
                if max(norms) <= restol:
                    break

            for step in self.MS:
                step.status.done = True
                self._fire('post_step', step, 0)

            uend_c = u[-1, -1]
            uend = (uend_c if prob.dtype.is_complex else uend_c.real).to(prob.dtype).clone()
            t_block = float(t_arr[-1]) + dt

        for step in self.MS:
            self._fire('post_run', step, 0)
        return uend, self.return_stats()
