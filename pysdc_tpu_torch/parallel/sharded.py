"""Block PFASST controller: the time axis as a tensor axis, on one card.

The counterpart of ``pysdc_tpu/parallel/sharded.py`` for ``mesh=None``.  The
whole block of ``num_procs`` time steps lives in single tensors with a time
axis, and every sweep, residual and transfer serves all steps with one call:

  - "send/recv" of ``uend -> u0``  = a shift along the time axis;
  - sweeps/residuals/transfers     = the one-step functions of the sweepers,
    problems and transfers on tensors with one more batch axis (what
    ``jax.vmap`` does in the JAX package, written out: the kernels of this
    package are launched through ``ctypes`` and cannot be traced);
  - the serialized coarse chain    = a loop over the steps ('replicated' and
    'pipelined' differ only across devices and are one loop here), or the same
    chain in the operator's diagonal basis ('diag': one batched transform of
    the block in, P elementwise sweep links, one transform out);
  - converged steps are frozen by where-masks.

Layout: a block's :class:`LevelState` has leaves ``(M+1, P, *shape)`` (node
axis first, then time), so the node contractions and the contiguous slices
the stencil kernel needs stay what they are for one step; ``uend`` blocks are
``(P, *shape)`` and the step times a ``(P,)`` float64 tensor on the device.
The JAX package keeps ``(P, M+1, *shape)``; what the entry points take and
return is the same.

The policy layer is not reimplemented: :class:`ShardedController` derives
from the virtual controller and inherits its loop over blocks, every hook point
and the ordered convergence-controller stack.  Only the stage handlers are
overridden: each one runs the batched functions and then refreshes per-step
*shadow views* (slices of the block) on the ``Step``/``Level`` objects that
hooks and policies read.  Iteration counts and the stats dictionary match the
virtual controller entry for entry (gated in tests/test_torch_sharded.py).

Per-step problem scalars (``newton_tol``, ``t_switch``, which policies such as
``NewtonInexactness`` and ``SwitchEstimator`` write per step) enter the batched
functions as ``(P,)`` float64 tensors on the device (``overrides``); the
problems broadcast them against the block's ``(M+1, P, *shape)`` fields.

Not ported: the mesh half (a ``mesh`` other than ``None``, the owner-computes
chain) waits for ROADMAP queue 1, item 10b, and raises by name.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from pysdc_tpu_torch.core.errors import ControllerError
from pysdc_tpu_torch.core.state import LevelState, map_components
from pysdc_tpu_torch.parallel.nonmpi import ControllerNonMPI

MESH_ITEM = 'ROADMAP queue 1, item 10b'


def _where_mask(mask, new, old, axis=0):
    """Per-step merge: ``mask`` (P,) selects leaves from ``new`` against
    ``old``; the leaves' time axis is ``axis`` (0 for ``uend`` blocks, 1 for
    the leaves of a block state).  A masked-out step keeps its data bit for bit."""

    def sel(n, o):
        if n is o:
            return o  # a leaf handed through (tau under a sweep): nothing to choose
        m = mask.reshape((1,) * axis + (-1,) + (1,) * (n.dim() - axis - 1))
        return torch.where(m, n, o)

    if isinstance(new, LevelState):
        return _map_state(sel, new, old)
    return map_components(sel, new, old)


def _map_state(fn, *states: LevelState) -> LevelState:
    """``fn`` leaf by leaf over block (or step) states of the same kind."""
    return LevelState(u=fn(*(s.u for s in states)), f=map_components(fn, *(s.f for s in states)),
                      tau=fn(*(s.tau for s in states)))


def _step_of(state: LevelState, j: int) -> LevelState:
    """Step ``j`` of a block state: views ``(M+1, *shape)`` of its leaves."""
    return _map_state(lambda a: a[:, j], state)


class _BlockLevel:
    """One level's device data for ALL steps of the block: a LevelState with
    a time axis behind the node axis + the batched functions on it."""

    def __init__(self, level, num_procs, mesh=None):
        if mesh is not None:
            raise ControllerError(f'a device mesh is not ported yet ({MESH_ITEM}: the mesh half of sharded.py)')
        self.level = level  # template Level (holds problem + sweeper + params)
        self.P = num_procs
        self.mesh = None
        self.state: LevelState | None = None
        self.uend = None  # (P, *shape)
        self.uold = None
        self.fold = None
        self._build_kernels()

    # -- kernels --------------------------------------------------------
    def _build_kernels(self):
        prob, sweep = self.level.prob, self.level.sweep
        P = self.P
        ndim = len(prob.shape)

        def predict(u0_block, t_arr, dt):
            return sweep.predict(prob, u0_block, t_arr, dt, 0.0)

        # mutable problem scalars (newton_tol, t_switch, written per step by NewtonInexactness and
        # SwitchEstimator) enter the batched functions as (P,)-shaped arguments: the problem reads them
        # where it would read its own attribute (the batched Newton takes one tolerance per step, the
        # regime tests one event time per step)
        self.traced_keys = tuple(k for k in ('newton_tol', 't_switch') if hasattr(prob, k))

        def _with_ov(fn, ov):
            old = {key: getattr(prob, key) for key in ov}
            for key, val in ov.items():
                setattr(prob, key, val)
            try:
                return fn()
            finally:
                for key, val in old.items():
                    setattr(prob, key, val)

        def do_sweep(states, t_arr, dt, active, k, overrides=None):
            new = _with_ov(lambda: sweep.update_nodes(prob, states, t_arr, dt, k), overrides or {})
            return _where_mask(active, new, states, axis=1)

        def residual(states, dt):
            _, norms = sweep.compute_residual(states, dt, self.level.params.residual_type, time_axis=True)
            return norms

        def endpoint(states, t_arr, dt, active, uend_old):
            new = sweep.compute_end_point(states, t_arr, dt)
            return _where_mask(active, new, uend_old)

        def set_u0_one(s, u0, t, m):
            """u[0] <- u0 and f[0] evaluated again where ``m``; for one step
            (``m`` 0-d) or a block (``m`` (P,), fields with the time axis first)."""
            mm = m.reshape(tuple(m.shape) + (1,) * ndim)
            u_first = torch.where(mm, u0, s.u[0])
            f0 = prob.eval_f(u_first, t)
            u = torch.cat([u_first.unsqueeze(0), s.u[1:]])
            f = map_components(
                lambda leaf, new0: torch.cat([torch.where(mm, new0, leaf[0]).unsqueeze(0), leaf[1:]]), s.f, f0
            )
            return LevelState(u=u, f=f, tau=s.tau)

        def shift_recv(states, uend, t_arr, recv_mask):
            """u0[j] <- uend[j-1] on masked steps (a shift along the time axis)."""
            u0_cand = torch.cat([states.u[0, :1], uend[:-1]])
            return set_u0_one(states, u0_cand, t_arr, recv_mask)

        def coarse_chain_serial(states, uend, t_arr, dt, recv_mask, active, k, overrides=None):
            """Serial Gauss-Seidel chain over the time axis: step q takes the
            end point its predecessor just produced, sweeps, hands forward.
            Inactive steps keep their data (the sweep is computed and masked:
            under a CUDA graph there is no branch to skip it)."""
            carry = states.u[0, 0]
            new_u, new_f, new_uend = [], [], []
            for q in range(P):
                t_q, act_q = t_arr[q], active[q]
                s_q = set_u0_one(_step_of(states, q), carry, t_q, recv_mask[q] & act_q)
                ov_q = {key: v[q] for key, v in (overrides or {}).items()}
                s_sw = _with_ov(lambda: sweep.update_nodes(prob, s_q, t_q, dt, k), ov_q)
                ue_sw = sweep.compute_end_point(s_sw, t_q, dt)
                new_u.append(torch.where(act_q, s_sw.u, s_q.u))
                new_f.append(map_components(lambda a, b: torch.where(act_q, a, b), s_sw.f, s_q.f))
                carry = torch.where(act_q, ue_sw, uend[q])
                new_uend.append(carry)
            new = LevelState(u=torch.stack(new_u, dim=1),
                             f=map_components(lambda *leaves: torch.stack(leaves, dim=1), *new_f), tau=states.tau)
            return new, torch.stack(new_uend)

        # -- diagonal-basis serial chains (linear diagonalizable problems) --
        # The Gauss-Seidel chain and the burn-in wavefront are the Amdahl
        # term of PFASST: serialized in time-rank, they do not divide by P.
        # When the level's operator is diagonalizable (all-periodic FD,
        # tensor-product eigenbasis — ops/diag_sdc.py), the WHOLE serial chain
        # runs in the operator's diagonal basis: one batched transform of the
        # full block in, P elementwise sweeps, one batched transform out —
        # instead of 2*M transforms per step per link.
        from pysdc_tpu_torch.ops.diag_sdc import _one_sweep_diag
        from pysdc_tpu_torch.sweepers.generic_implicit import GenericImplicit

        diag_op = getattr(prob, 'diagonalizable_operator', None)
        self._diag_eligible = (
            diag_op is not None
            # exactly GenericImplicit: subclasses override update_nodes with different sweep math
            and type(sweep) is GenericImplicit
            and not sweep.k_dependent
        )

        def _hat_setup(states, k):
            uhat = diag_op.diag_forward(states.u)
            tauhat = diag_op.diag_forward(states.tau)
            lam = diag_op.diag_symbol_on(uhat)
            QI = sweep._qi(k)
            W = sweep._coeff(('q-QI', 0), lambda: sweep.coll.q - QI[1:, 1:], uhat)
            qd = sweep._coeff(('diag QI', 0), lambda: np.diag(QI)[1:], lam)
            return uhat, tauhat, lam, (QI, W, qd)

        def _dt_table(dt, k):
            """``dt * QI`` once for all links of a chain (one product where ``dt`` is on the device)."""
            return sweep.scaled_table(dt, sweep._qi(k), ('QI', 0))

        def _endpoint_hat(uh, th, lam, dt):
            """compute_end_point in the diagonal basis (linear in uhat)."""
            if sweep.coll.right_is_node and not sweep.do_coll_update:
                return uh[-1]
            w = sweep._coeff('weights', lambda: sweep.coll.weights, uh)
            return uh[0] + dt * torch.tensordot(w, lam * uh[1:], dims=1) + th[-1]

        def _hat_teardown(states, uend, uhat_new, uendhat_new, lam, mask):
            """Back to real space; masked steps keep their exact old data
            (a transform round-trip would perturb frozen steps by roundoff)."""
            real = not states.u.is_complex()
            u = diag_op.diag_backward(uhat_new, states.u.dtype, real)
            f = diag_op.diag_backward(lam * uhat_new, states.f.dtype, real)
            new = _where_mask(mask, LevelState(u=u, f=f, tau=states.tau), states, axis=1)
            ue = diag_op.diag_backward(uendhat_new, uend.dtype, real)
            return new, _where_mask(mask, ue, uend)

        def coarse_chain_diag(states, uend, t_arr, dt, recv_mask, active, k, overrides=None):
            """Serial Gauss-Seidel chain entirely in the diagonal basis.
            ``overrides`` is accepted for signature parity and ignored: the
            diag chain is an exact linear solve (no Newton, no switching)."""
            uhat, tauhat, lam, (QI, W, qd) = _hat_setup(states, k)
            uendhat = diag_op.diag_forward(uend)
            dtQI = _dt_table(dt, k)
            carry = uhat[0, 0]
            new_uhat, new_uendhat = [], []
            for q in range(P):
                act_q, th = active[q], tauhat[:, q]
                uh = uhat[:, q]
                uh = torch.cat([torch.where(recv_mask[q] & act_q, carry, uh[0]).unsqueeze(0), uh[1:]])
                uh_new = torch.where(act_q, _one_sweep_diag(uh, lam, dt, QI, W, qd, th, dtQI), uh)
                carry = torch.where(act_q, _endpoint_hat(uh_new, th, lam, dt), uendhat[q])
                new_uhat.append(uh_new)
                new_uendhat.append(carry)
            return _hat_teardown(states, uend, torch.stack(new_uhat, dim=1), torch.stack(new_uendhat), lam, active)

        # made here, not at first use: a tensor first made inside a graph capture holds nothing until a replay
        ar = torch.arange(P, device=prob.device)

        def wavefront(states, uend, t_arr, dt, window, n_rounds):
            """Burn-in staggered coarse wavefront (nonmpi.py _burnin): round q
            sweeps slots >= q and shifts uend forward.  ``n_rounds`` is a host
            integer; rounds past the window's length are masked out whole, so
            a caller that cannot know the length on the host passes P."""
            for q in range(n_rounds):
                m = (ar >= q) & window
                states = do_sweep(states, t_arr, dt, m, 0)
                uend = endpoint(states, t_arr, dt, m, uend)
                states = shift_recv(states, uend, t_arr, (ar >= q + 1) & window)
            return states, uend

        def wavefront_diag(states, uend, t_arr, dt, window, n_rounds):
            """The same wavefront with ALL rounds in the diagonal basis."""
            uhat, tauhat, lam, (QI, W, qd) = _hat_setup(states, 0)
            uendhat = diag_op.diag_forward(uend)
            dtQI = _dt_table(dt, 0)
            for q in range(n_rounds):
                m = (ar >= q) & window
                uhat = _where_mask(m, _one_sweep_diag(uhat, lam, dt, QI, W, qd, tauhat, dtQI), uhat, axis=1)
                uendhat = _where_mask(m, _endpoint_hat(uhat, tauhat, lam, dt), uendhat)
                recv = ((ar >= q + 1) & window).reshape((-1,) + (1,) * (uendhat.dim() - 1))
                u0c = torch.cat([uhat[0, :1], uendhat[:-1]])
                uhat = torch.cat([torch.where(recv, u0c, uhat[0]).unsqueeze(0), uhat[1:]])
            return _hat_teardown(states, uend, uhat, uendhat, lam, window)

        self.predict = predict
        self.sweep = do_sweep
        self.residual = residual
        self.endpoint = endpoint
        self.shift_recv = shift_recv
        self._coarse_serial = coarse_chain_serial
        self._coarse_diag = coarse_chain_diag
        self.coarse_chain = coarse_chain_serial

        # the same building blocks under the names the fused lane composes
        # (parallel/fused.py); nothing is jitted here, so ``raw`` holds the
        # functions themselves
        self.raw = SimpleNamespace(
            predict=predict,
            sweep=do_sweep,
            residual=residual,
            endpoint=endpoint,
            shift_recv=shift_recv,
            # one card: both names of the JAX package give the serial loop
            coarse_replicated=coarse_chain_serial,
            coarse_pipelined=coarse_chain_serial,
            coarse_diag=coarse_chain_diag,
            wavefront=wavefront,
            wavefront_diag=wavefront_diag,
            # resolved by select_coarse_impl: the burn-in implementation the fused lane uses
            wavefront_active=wavefront,
        )

    def select_coarse_impl(self, mode='auto'):
        """Pick the Gauss-Seidel chain implementation.

        'diag' runs the whole serial chain (and the burn-in wavefront) in
        the operator's diagonal basis — one batched transform in/out, P
        elementwise sweep links — for linear diagonalizable coarse problems.
        'replicated' and 'pipelined' are the serial loop over the steps (they
        differ only across devices).  'owner' needs a mesh.  'auto' prefers
        'diag' where the level is eligible, else 'replicated'."""
        if mode == 'auto':
            mode = 'diag' if self._diag_eligible else 'replicated'
        if mode == 'owner':
            raise ControllerError(f'the owner-computes coarse chain needs a device mesh, not ported yet ({MESH_ITEM})')
        if mode == 'diag' and not self._diag_eligible:
            raise ControllerError(
                'diag coarse chain needs a diagonalizable operator and a fixed-QI generic-implicit sweeper'
            )
        if mode not in ('diag', 'replicated', 'pipelined'):
            raise ControllerError(f'unknown coarse_mode {mode!r}')
        self.coarse_chain = self._coarse_diag if mode == 'diag' else self._coarse_serial
        self.raw.wavefront_active = self.raw.wavefront_diag if mode == 'diag' else self.raw.wavefront
        return mode

    def reset(self):
        prob = self.level.prob
        self.state = None
        self.uend = torch.zeros((self.P,) + prob.shape, dtype=prob.dtype, device=prob.device)
        self.uold = None
        self.fold = None


class _BlockTransfer:
    """Batched FAS transfer between two block levels: ``BaseTransfer``'s
    state functions on blocks (the time axis rides behind the node axis
    through the space transfers, the node matrices and the coarse ``eval_f``)."""

    def __init__(self, base_transfer, fine_block, coarse_block):
        self.bt = base_transfer
        self.fine = fine_block
        self.coarse = coarse_block
        bt = base_transfer

        def restrict(F_states, t_arr, dt_c, dt_f):
            G = bt._restrict_state(F_states, t_arr, dt_c, dt_f)
            return G, G.u, G.f

        def prolong(F_states, G_states, G_uold, t_arr, dt_f):
            return bt._prolong_state(F_states, G_states, G_uold, t_arr, dt_f)

        self.restrict = self.restrict_raw = restrict
        self.prolong = self.prolong_raw = prolong


class ShardedController(ControllerNonMPI):
    """Block PFASST with the time axis as a tensor axis, with the complete
    hook and convergence-controller stack of the virtual controller."""

    def __init__(self, num_procs: int, controller_params: dict, description: dict, mesh=None,
                 coarse_mode: str = 'auto'):
        if mesh is not None:
            raise ControllerError(
                f'ShardedController(mesh=...) is not ported yet ({MESH_ITEM}: the mesh half of sharded.py, '
                'parallel/mesh.py and the halo applies on torch.distributed); pass mesh=None for one card'
            )
        self.mesh = None
        super().__init__(num_procs, controller_params, description)

        template = self.MS[0]
        self.num_procs = num_procs
        self.blocks = [_BlockLevel(lvl, num_procs) for lvl in template.levels]
        self.transfers = [
            _BlockTransfer(bt, self.blocks[i], self.blocks[i + 1])
            for i, bt in enumerate(template.base_transfers)
        ]
        #: resolved Gauss-Seidel chain strategy on the coarsest level
        self.coarse_mode = self.blocks[-1].select_coarse_impl(coarse_mode)
        #: device values read on the host by a fused lane's last run: ``cont`` flags and fetches (of iteration
        #: counts and residual histories; on the adaptive lane one per block, with the error estimates), by kind
        self.host_reads = {'cont': 0, 'fetch': 0}

    @property
    def template(self):
        return self.MS[0]

    @property
    def device(self):
        return self.MS[0].levels[0].prob.device

    def run(self, u0, t0, Tend, lane='auto'):
        """Single entry point, like the reference's one ``run()``
        (controller_nonMPI.py:85).  ``lane='auto'`` (default) picks the
        fastest eligible execution path: the fused device-resident block
        runner (parallel/fused.py), its adaptive sibling (embedded-error
        adaptivity + restarts, one host read per block), or the stage
        machine as the general fallback.  The chosen lane is logged and
        recorded in stats as a ``type='lane'`` entry.  Pass ``lane='stage'``
        to force the stage machine (e.g. for per-sweep diagnostics) or
        ``lane='fused'``/``'fused_adaptive'`` to require a fast lane."""
        from pysdc_tpu_torch.parallel import fused

        if lane == 'auto':
            try:
                fused.check_fused_eligibility(self)
                lane = 'fused'
            except ControllerError:
                try:
                    fused.check_fused_adaptive_eligibility(self)
                    lane = 'fused_adaptive'
                except ControllerError:
                    lane = 'stage'

        if lane == 'fused':
            uend, _ = fused.run_fused(self, u0, t0, Tend)
        elif lane == 'fused_adaptive':
            uend, _ = fused.run_fused_adaptive(self, u0, t0, Tend)
        elif lane == 'stage':
            uend, _ = super().run(u0, t0, Tend)
        else:
            raise ControllerError(f'unknown execution lane {lane!r}')
        self.logger.info(f'execution lane: {lane}')
        self.hooks[0].add_to_stats(
            process=-1, time=t0, level=-1, iter=-1, sweep=-1, type='lane', value=lane
        )
        return uend, self.return_stats()

    def _advance(self, block):
        if getattr(self, '_fused_adaptive', False):
            from pysdc_tpu_torch.parallel.fused import advance_fused_adaptive

            return advance_fused_adaptive(self, block)
        return super()._advance(block)

    def run_fused(self, u0, t0, Tend):
        """Whole-block device-resident run (parallel/fused.py): on the card
        the PFASST iterate-until-converged loop of a block is a few captured
        CUDA graphs replayed by a short host loop.  Same uend and iteration
        counts as :meth:`run` (gated in tests/test_torch_fused.py); stats
        carry the default entries only.  Adaptive configurations route to
        the device-resident adaptive lane.  Raises ControllerError for
        configurations needing the stage machine (k-dependent
        preconditioners, hooks needing per-sweep data, ...)."""
        from pysdc_tpu_torch.parallel import fused

        try:
            fused.check_fused_eligibility(self)
        except ControllerError as plain_err:
            try:
                fused.check_fused_adaptive_eligibility(self)
            except ControllerError as adaptive_err:
                # raise the error for whichever lane the config is shaped for
                if float(self.MS[0].levels[0].params.restol) < 0:
                    raise adaptive_err
                raise plain_err
            return fused.run_fused_adaptive(self, u0, t0, Tend)
        return fused.run_fused(self, u0, t0, Tend)

    # -- helpers ----------------------------------------------------------
    def _mask_tensor(self, values):
        return torch.as_tensor(np.asarray(values, dtype=bool), device=self.device)

    def _mask_of(self, steps):
        m = np.zeros(self.num_procs, bool)
        for s in steps:
            m[s.status.slot] = True
        return self._mask_tensor(m)

    def _recv_mask_of(self, running):
        m = np.zeros(self.num_procs, bool)
        for s in running:
            m[s.status.slot] = (not s.status.first) and (not s.status.prev_done)
        return self._mask_tensor(m)

    def _block_times(self):
        return torch.as_tensor(
            [s.levels[0].status.time if s.levels[0].status.time is not None else 0.0 for s in self.MS],
            dtype=torch.float64, device=self.device,
        )

    def _block_dt(self, running, lvl_idx=0):
        """One dt per block per level (levels may carry different dts after
        adaptive restarts: only the finest level gets a dt_new proposal)."""
        dts = {float(s.levels[lvl_idx].params.dt) for s in running}
        if len(dts) != 1:
            raise ControllerError(
                f'sharded block kernels need one dt per block, got {sorted(dts)} '
                '(SpreadStepSizesBlockwise keeps blocks uniform — is a policy '
                'assigning per-step step sizes?)'
            )
        return dts.pop()

    def _block_overrides(self, lvl_idx):
        """(P,)-shaped per-step problem scalars (newton_tol, t_switch) read
        from the shadow steps, as float64 tensors on the device: policies
        write them per step, the batched functions consume them as arguments."""
        keys = getattr(self.blocks[lvl_idx], 'traced_keys', ())
        if not keys:
            return None
        return {
            key: torch.as_tensor([float(getattr(S.levels[lvl_idx].prob, key)) for S in self.MS],
                                 dtype=torch.float64, device=self.device)
            for key in keys
        }

    def _sync_level(self, running, lvl_idx):
        """Refresh shadow views: each step's Level points at its slice of the
        block state, so hooks and convergence policies read live data."""
        blk = self.blocks[lvl_idx]
        for step in running:
            j = step.status.slot
            L = step.levels[lvl_idx]
            L.state = _step_of(blk.state, j)
            if blk.uend is not None:
                L.uend = blk.uend[j]
            L.status.unlocked = True

    def _set_residuals(self, running, lvl_idx, stage, norms, read=False):
        """Mirror Level.compute_residual's stage-skip semantics per step.
        The norms stay on the device (0-d views, read when the stats are
        returned) unless ``read``: a convergence check needs them on the
        host, and one read of the block's norms serves all its steps."""
        values = norms.tolist() if read else norms
        for step in running:
            L = step.levels[lvl_idx]
            if stage in L.sweep.skip_residual_computation:
                if L.status.residual is None:
                    L.status.residual = 0.0
            else:
                L.status.residual = values[step.status.slot]
                L.status.updated = False

    def _comm_hooks(self, steps, lvl, record=False):
        """Fire the pre/post comm hook pair for each step (the batched shift
        is the actual transport)."""
        for step in steps:
            with self._comm_scope(step, lvl, record):
                pass

    def _exchange(self, running, lvl_idx, record=False):
        """Batched uend -> u0 pipeline exchange on one level + comm hooks."""
        blk = self.blocks[lvl_idx]
        t_arr, dt = self._block_times(), self._block_dt(running, lvl_idx)
        mask = self._mask_of(running)
        self._comm_hooks(running, lvl_idx)  # send side
        blk.uend = blk.endpoint(blk.state, t_arr, dt, mask, blk.uend)
        recv = self._recv_mask_of(running)
        blk.state = blk.shift_recv(blk.state, blk.uend, t_arr, recv)
        self._comm_hooks(running, lvl_idx, record=record)  # recv side

    def _masked_sweeps(self, running, lvl_idx, nsweeps, stage, record_last=True):
        """nsweeps batched sweeps on one level with exchanges and hooks,
        matching the virtual controller's per-level sweep loops."""
        blk = self.blocks[lvl_idx]
        t_arr, dt = self._block_times(), self._block_dt(running, lvl_idx)
        mask = self._mask_of(running)
        sweep = blk.level.sweep
        for k in range(nsweeps):
            if lvl_idx == 0:
                for step in running:
                    step.levels[0].status.sweep += 1
            self._exchange(running, lvl_idx, record=(record_last and k == nsweeps - 1))
            for step in running:
                self._fire('pre_sweep', step, lvl_idx)
            kk = running[0].levels[lvl_idx].status.sweep if sweep.k_dependent else 0
            blk.state = blk.sweep(blk.state, t_arr, dt, mask, kk, self._block_overrides(lvl_idx))
            norms = blk.residual(blk.state, dt)
            self._sync_level(running, lvl_idx)
            self._set_residuals(running, lvl_idx, stage, norms)
            for step in running:
                self._fire('post_sweep', step, lvl_idx)

    # -- stage handlers (device-batched versions of the inherited ones) ---
    def _spread(self, running):
        for step in running:
            self._fire('pre_step', step, 0)

        dt = self._block_dt(running)
        t_arr = self._block_times()
        fine = self.blocks[0]
        for b in self.blocks:
            b.reset()
        u0 = running[0].u0
        u0_block = u0.unsqueeze(0).expand((self.num_procs,) + tuple(u0.shape)).contiguous()
        fine.state = fine.predict(u0_block, t_arr, dt)
        mask = self._mask_of(running)
        fine.uend = fine.endpoint(fine.state, t_arr, dt, mask, fine.uend)
        self._sync_level(running, 0)

        for step in running:
            step.status.stage = 'PREDICT' if len(step.levels) > 1 else 'IT_CHECK'
            for policy in self._policies():
                policy.post_spread_processing(self, step, MS=running)

    def _predict(self, running):
        for step in running:
            self._fire('pre_predict', step, 0)

        kind = self.params.predict_type
        if kind is None:
            pass
        elif kind == 'fine_only':
            # one sweep without exchange or sweep hooks, as the virtual controller's predictor does it (the
            # JAX package's block controller goes through _masked_sweeps here and so records one
            # residual_post_sweep entry per step more than its virtual twin; the numbers are the same,
            # the exchange hands on what the spread put there)
            fine = self.blocks[0]
            kk = running[0].levels[0].status.sweep if fine.level.sweep.k_dependent else 0
            fine.state = fine.sweep(fine.state, self._block_times(), self._block_dt(running), self._mask_of(running), kk)
            self._sync_level(running, 0)
        elif kind == 'pfasst_burnin':
            self._burnin(running)
        elif kind == 'fmg':
            self._full_multigrid(running)
        else:
            raise ControllerError(f'unrecognized predict_type {kind!r}')

        for step in running:
            self._fire('post_predict', step, 0)
            step.status.stage = 'IT_CHECK'

    def _restrict_block(self, lvl, t_arr, dt_c, dt_f):
        F, G = self.blocks[lvl], self.blocks[lvl + 1]
        G.state, G.uold, G.fold = self.transfers[lvl].restrict(F.state, t_arr, dt_c, dt_f)

    def _burnin(self, running):
        """Batched pfasst_burnin: staggered coarse wavefront via masks."""
        t_arr = self._block_times()
        dts = [self._block_dt(running, l) for l in range(self.nlevels)]
        slots = np.array([s.status.slot for s in running])

        for lvl in range(len(self.transfers)):
            self._restrict_block(lvl, t_arr, dts[lvl + 1], dts[lvl])

        coarse = self.blocks[-1]
        dt = dts[-1]
        coarse_idx = self.nlevels - 1
        ov_coarse = self._block_overrides(coarse_idx)
        for q in range(len(running)):
            sweep_mask = self._mask_tensor(np.isin(np.arange(self.num_procs), slots[q:]))
            coarse.state = coarse.sweep(coarse.state, t_arr, dt, sweep_mask, 0, ov_coarse)
            self._comm_hooks(running[q:], coarse_idx)
            coarse.uend = coarse.endpoint(coarse.state, t_arr, dt, sweep_mask, coarse.uend)
            recv_np = np.isin(np.arange(self.num_procs), slots[q + 1:])
            for j, step in enumerate(running[q + 1:], start=q + 1):
                recv_np[step.status.slot] &= not step.status.prev_done and not step.status.first
                with self._comm_scope(step, coarse_idx, record=(j == len(running) - 1)):
                    pass
            coarse.state = coarse.shift_recv(coarse.state, coarse.uend, t_arr, self._mask_tensor(recv_np))

        for lvl in range(self.nlevels - 1, 0, -1):
            tr = self.transfers[lvl - 1]
            F, G = self.blocks[lvl - 1], self.blocks[lvl]
            F.state = tr.prolong(F.state, G.state, G.uold, t_arr, dts[lvl - 1])

        self._exchange(running, 0)
        fine = self.blocks[0]
        fine.state = fine.sweep(fine.state, t_arr, dts[0], self._mask_of(running), 0)
        self._sync_level(running, 0)

    def _full_multigrid(self, running):
        """Batched FMG predictor (see the virtual twin for the algorithm)."""
        t_arr = self._block_times()
        dts = [self._block_dt(running, l) for l in range(self.nlevels)]
        mask = self._mask_of(running)

        for lvl in range(len(self.transfers)):
            self._restrict_block(lvl, t_arr, dts[lvl + 1], dts[lvl])

        coarse = self.blocks[-1]
        coarse_idx = self.nlevels - 1
        self._comm_hooks(running, coarse_idx)
        recv = self._recv_mask_of(running)
        coarse.state, coarse.uend = coarse.coarse_chain(
            coarse.state, coarse.uend, t_arr, dts[-1], recv, mask, 0,
            self._block_overrides(coarse_idx),
        )
        self._comm_hooks(running, coarse_idx)

        for l in range(self.nlevels - 1, 0, -1):
            tr = self.transfers[l - 1]
            F, G = self.blocks[l - 1], self.blocks[l]
            F.state = tr.prolong(F.state, G.state, G.uold, t_arr, dts[l - 1])
            if l - 1 > 0:
                F.state = F.sweep(F.state, t_arr, dts[l - 1], mask, 0)

        self._exchange(running, 0)
        fine = self.blocks[0]
        fine.state = fine.sweep(fine.state, t_arr, dts[0], mask, 0)
        self._sync_level(running, 0)

    def _measure_at_check(self, running):
        """IT_CHECK entry: batched boundary exchange + residuals; the policy
        sequence that follows is inherited unchanged."""
        self._exchange(running, 0)
        fine = self.blocks[0]
        norms = fine.residual(fine.state, self._block_dt(running, 0))
        self._sync_level(running, 0)
        self._set_residuals(running, 0, 'IT_CHECK', norms, read=True)

    def _fine_sweeps(self, running):
        for step in running:
            step.levels[0].status.sweep = 0
        self._masked_sweeps(running, 0, self.nsweeps[0], 'IT_FINE')
        for step in running:
            step.status.stage = 'IT_CHECK'

    def _restrict_cascade(self, running):
        t_arr = self._block_times()
        for lvl in range(len(self.transfers)):
            if lvl > 0:
                self._masked_sweeps(running, lvl, self.nsweeps[lvl], 'IT_DOWN', record_last=False)
            self._restrict_block(lvl, t_arr, self._block_dt(running, lvl + 1), self._block_dt(running, lvl))
            self._sync_level(running, lvl + 1)
        for step in running:
            step.status.stage = 'IT_COARSE'

    def _coarse_chain(self, running):
        coarse = self.blocks[-1]
        coarse_idx = self.nlevels - 1
        t_arr, dt = self._block_times(), self._block_dt(running, coarse_idx)
        mask = self._mask_of(running)
        recv = self._recv_mask_of(running)

        self._comm_hooks(running, coarse_idx)  # pull side
        for step in running:
            self._fire('pre_sweep', step, coarse_idx)
        coarse.state, coarse.uend = coarse.coarse_chain(
            coarse.state, coarse.uend, t_arr, dt, recv, mask, 0,
            self._block_overrides(coarse_idx),
        )
        norms = coarse.residual(coarse.state, dt)
        self._sync_level(running, coarse_idx)
        self._set_residuals(running, coarse_idx, 'IT_COARSE', norms)
        for step in running:
            self._fire('post_sweep', step, coarse_idx)
        self._comm_hooks(running, coarse_idx, record=True)  # push side

        for step in running:
            step.status.stage = 'IT_UP' if self.nlevels > 1 else 'IT_CHECK'

    def _prolong_cascade(self, running):
        t_arr = self._block_times()
        for l in range(self.nlevels - 1, 0, -1):
            tr = self.transfers[l - 1]
            F, G = self.blocks[l - 1], self.blocks[l]
            # done steps were masked out of every sweep since restriction, so
            # their prolongation correction is exactly zero — no mask needed
            F.state = tr.prolong(F.state, G.state, G.uold, t_arr, self._block_dt(running, l - 1))
            self._sync_level(running, l - 1)
            if l - 1 > 0:
                self._masked_sweeps(running, l - 1, self.nsweeps[l - 1], 'IT_UP')
        for step in running:
            step.status.stage = 'IT_FINE'
