"""Block PFASST controller: the time axis as a tensor axis, on one card or a mesh.

The counterpart of ``pysdc_tpu/parallel/sharded.py``.  The whole block of
``num_procs`` time steps lives in tensors with a time axis, and every sweep,
residual and transfer serves all steps with one call:

  - "send/recv" of ``uend -> u0``  = a shift along the time axis;
  - sweeps/residuals/transfers     = the one-step functions of the sweepers,
    problems and transfers on tensors with one more batch axis (what
    ``jax.vmap`` does in the JAX package, written out: the kernels of this
    package are launched through ``ctypes`` and cannot be traced);
  - the serialized coarse chain    = a loop over the steps ('replicated' and
    'pipelined' differ only on a mesh), the owner-computes chain on a
    time-sharded mesh ('owner'), or the same chain in the operator's diagonal
    basis ('diag': one batched transform of the block in, P elementwise sweep
    links, one transform out);
  - converged steps are frozen by where-masks.

Layout: a block's :class:`LevelState` has leaves ``(M+1, P, *shape)`` (node
axis first, then time), so the node contractions and the contiguous slices
the stencil kernel needs stay what they are for one step; ``uend`` blocks are
``(P, *shape)`` and the step times a ``(P,)`` float64 tensor on the device.
The JAX package keeps ``(P, M+1, *shape)``; what the entry points take and
return is the same.

On a mesh (:func:`pysdc_tpu_torch.parallel.mesh.make_mesh`, one controller
for all positions): the time axis splits into ``n_time`` contiguous shards of
``P / n_time`` steps, a :class:`~pysdc_tpu_torch.parallel.mesh.TimeShards`
whose part ``c`` lives on the first position of time row ``c``, and every
batched function runs once per shard on its device (what ``shard_map`` runs
once per device).  The ``uend -> u0`` shift across a shard boundary copies
one field to the next shard; residual norms are gathered into one ``(P,)``
tensor on the controller's device; the 'replicated' chain gathers the coarse
block onto that device, the 'pipelined' chain moves one step's state there
per link, and the 'owner' chain lets only the shard owning a step sweep it
while ``uend`` rides the ring to the next shard.  Along 'space', each
operator apply of a shard runs the halo exchange over its time row's space
positions (:mod:`pysdc_tpu_torch.ops.halo`: one K1 launch per slab);
everything else of a shard (the FFT solves, the node contractions) runs whole
on the shard's device, which is where a gather of its slabs would put it.  A
node axis is accepted and kept in the layout (:meth:`_BlockLevel._spec`);
the node contractions need every node, so its positions compute nothing
apart.  The mesh's ``traffic`` counts the copies and gathers.

The policy layer is not reimplemented: :class:`ShardedController` derives
from the virtual controller and inherits its loop over blocks, every hook point
and the ordered convergence-controller stack.  Only the stage handlers are
overridden: each one runs the batched functions and then refreshes per-step
*shadow views* (slices of the block) on the ``Step``/``Level`` objects that
hooks and policies read.  Iteration counts and the stats dictionary match the
virtual controller entry for entry (gated in tests/test_torch_sharded.py and,
on meshes, tests/test_torch_sharded_mesh.py).

Per-step problem scalars (``newton_tol``, ``t_switch``, which policies such as
``NewtonInexactness`` and ``SwitchEstimator`` write per step) enter the batched
functions as ``(P,)`` float64 tensors on the device (``overrides``); the
problems broadcast them against the block's ``(M+1, P, *shape)`` fields.  The
owner-computes chain takes them too (the JAX package's keeps the template
values there).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from pysdc_tpu_torch.core.errors import ControllerError
from pysdc_tpu_torch.core.state import LevelState, map_components
from pysdc_tpu_torch.parallel.mesh import Mesh, PartitionSpec, TimeShards
from pysdc_tpu_torch.parallel.nonmpi import ControllerNonMPI
from pysdc_tpu_torch.utils import trace


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
    a time axis behind the node axis (on a mesh, one such state per time
    shard) + the batched functions on it."""

    def __init__(self, level, num_procs, mesh=None):
        self.level = level  # template Level (holds problem + sweeper + params)
        self.P = num_procs
        self.mesh = mesh
        self.state: LevelState | TimeShards | None = None
        self.uend = None  # (P, *shape), or its time shards
        self.uold = None
        self.fold = None
        if mesh is not None:
            self.n_time = mesh.shape['time']
            self.B = num_procs // self.n_time  # steps of a time shard
            self.homes = [mesh.row_device(c) for c in range(self.n_time)]
        self._build_kernels()
        if mesh is not None:
            self._build_mesh_kernels()

    # -- sharding -------------------------------------------------------
    def _spec(self, leaf):
        """The leaf's layout on the mesh, for this package's leaves: ``(M+1, P,
        *shape)`` block leaves get ('node', 'time', 'space', ...), with the
        node axis only where the mesh has one and the node count divides;
        ``(P, *shape)`` leaves get ('time', 'space', ...)."""
        ndim_space = len(self.level.prob.shape)
        mid = leaf.dim() - ndim_space
        axes = [None] * mid
        axes[mid - 1] = 'time'
        names = self.mesh.axis_names
        if 'node' in names and mid >= 2:
            n_node = self.mesh.shape['node']
            if n_node > 1 and leaf.shape[0] % n_node == 0:
                axes[0] = 'node'
        if ndim_space > 0 and 'space' in names:
            axes += ['space'] + [None] * (ndim_space - 1)
        else:
            axes += [None] * ndim_space
        return PartitionSpec(*axes)

    def _part(self, leaf, c):
        """Time shard ``c`` of a whole leaf: a contiguous copy of steps
        ``c B .. (c+1) B - 1`` on time row ``c``'s device."""
        axis = self._spec(leaf).index('time')
        return self.mesh.copy_to(leaf.narrow(axis, c * self.B, self.B).contiguous(), self.homes[c])

    def _shard(self, leaf):
        """The leaf's time shards."""
        return TimeShards(self._part(leaf, c) for c in range(self.n_time))

    def shard_tree(self, tree):
        """A whole block (a state or a tensor) split into its time shards."""
        if self.mesh is None:
            return tree
        if isinstance(tree, LevelState):
            return TimeShards(_map_state(lambda a, c=c: self._part(a, c), tree) for c in range(self.n_time))
        return self._shard(tree)

    def whole(self, tree):
        """The whole block of time shards, gathered on the controller's device."""
        if not isinstance(tree, TimeShards):
            return tree
        device = self.level.prob.device
        if isinstance(tree[0], LevelState):
            return _map_state(lambda *parts: self.mesh.gather(parts, device, dim=1), *tree)
        return self.mesh.gather(tree, device, dim=0)

    def last_node(self, state):
        """``u[-1]`` of every step, ``(P, *shape)`` on the controller's device."""
        if isinstance(state, TimeShards):
            return self.mesh.gather([s.u[-1] for s in state], self.level.prob.device)
        return state.u[-1]

    def step_state(self, j):
        """Views of step ``j``'s leaves."""
        if self.mesh is None:
            return _step_of(self.state, j)
        c, i = divmod(j, self.B)
        return _step_of(self.state[c], i)

    def step_uend(self, j):
        if self.mesh is None:
            return self.uend[j]
        c, i = divmod(j, self.B)
        return self.uend[c][i]

    def new_uend(self, dtype=None):
        """Zero end points of the block (of its time shards on a mesh)."""
        prob = self.level.prob
        dtype = prob.dtype if dtype is None else dtype
        if self.mesh is None:
            return torch.zeros((self.P,) + prob.shape, dtype=dtype, device=prob.device)
        return TimeShards(torch.zeros((self.B,) + prob.shape, dtype=dtype, device=d) for d in self.homes)

    # the arguments of shard c of a per-shard call: control vectors (times, masks, per-step scalars) sliced and
    # moved plainly (they are not fields, and the mesh's traffic does not count them), a 0-d dt tensor moved
    def ctl(self, x, c):
        return x[c * self.B:(c + 1) * self.B].to(self.homes[c])

    def scal(self, x, c):
        return x.to(self.homes[c]) if isinstance(x, torch.Tensor) else x

    def ovs(self, overrides, c):
        return {key: self.ctl(v, c) for key, v in (overrides or {}).items()}

    def per_shard(self, fn, *args):
        """``[fn(c, *args) for each shard c]``, each call as time row ``c``."""
        out = []
        for c in range(self.n_time):
            with self.mesh.time_row(c):
                out.append(fn(c, *args))
        return out

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

        def link(s_q, carry, t_q, recv_q, act_q, ov_q, ue_old, dt, k):
            """One link of the Gauss-Seidel chain: step ``s_q`` takes ``carry``
            as its u0, sweeps and hands its end point on.  Returns the step's
            new ``u`` and ``f`` and the carry.  An inactive step keeps its
            data (the sweep is computed and masked: under a CUDA graph there
            is no branch to skip it)."""
            s_q = set_u0_one(s_q, carry, t_q, recv_q & act_q)
            s_sw = _with_ov(lambda: sweep.update_nodes(prob, s_q, t_q, dt, k), ov_q)
            ue_sw = sweep.compute_end_point(s_sw, t_q, dt)
            u = torch.where(act_q, s_sw.u, s_q.u)
            f = map_components(lambda a, b: torch.where(act_q, a, b), s_sw.f, s_q.f)
            return u, f, torch.where(act_q, ue_sw, ue_old)

        def stack_steps(us, fs, tau):
            return LevelState(u=torch.stack(us, dim=1),
                              f=map_components(lambda *leaves: torch.stack(leaves, dim=1), *fs), tau=tau)

        def coarse_chain_serial(states, uend, t_arr, dt, recv_mask, active, k, overrides=None, carry=None):
            """Serial Gauss-Seidel chain over the block's steps: step q takes
            the end point its predecessor just produced, sweeps, hands forward.
            ``carry`` is the first step's u0 candidate (default: its own u0)."""
            carry = states.u[0, 0] if carry is None else carry
            us, fs, ues = [], [], []
            for q in range(states.u.shape[1]):
                ov_q = {key: v[q] for key, v in (overrides or {}).items()}
                u, f, carry = link(_step_of(states, q), carry, t_arr[q], recv_mask[q], active[q], ov_q, uend[q],
                                   dt, k)
                us.append(u)
                fs.append(f)
                ues.append(carry)
            return stack_steps(us, fs, states.tau), torch.stack(ues)

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
            and self.mesh is None
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
        self._ar = ar = torch.arange(P, device=prob.device)

        def wavefront_diag(states, uend, t_arr, dt, window, n_rounds):
            """The burn-in wavefront with ALL rounds in the diagonal basis."""
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

        self._coarse_serial = coarse_chain_serial
        # what the time shards' functions call once per shard (_build_mesh_kernels)
        self._one = SimpleNamespace(predict=predict, sweep=do_sweep, residual=residual, endpoint=endpoint,
                                    set_u0_one=set_u0_one, link=link, stack_steps=stack_steps,
                                    coarse_serial=coarse_chain_serial)
        self._install(predict, do_sweep, residual, endpoint, shift_recv,
                      coarse_chain_serial, coarse_chain_serial, None, coarse_chain_diag, wavefront_diag)

    def _install(self, predict, sweep, residual, endpoint, shift_recv, replicated, pipelined, owner, diag=None,
                 wavefront_diag=None):
        """The batched functions under the names the stage machine and the fused lane (parallel/fused.py)
        call; nothing is jitted here, so ``raw`` holds the functions themselves."""
        ar = self._ar

        def wavefront(states, uend, t_arr, dt, window, n_rounds):
            """Burn-in staggered coarse wavefront (nonmpi.py _burnin): round q
            sweeps slots >= q and shifts uend forward.  ``n_rounds`` is a host
            integer; rounds past the window's length are masked out whole, so
            a caller that cannot know the length on the host passes P."""
            for q in range(n_rounds):
                m = (ar >= q) & window
                states = sweep(states, t_arr, dt, m, 0)
                uend = endpoint(states, t_arr, dt, m, uend)
                states = shift_recv(states, uend, t_arr, (ar >= q + 1) & window)
            return states, uend

        self.predict = predict
        self.sweep = sweep
        self.residual = residual
        self.endpoint = endpoint
        self.shift_recv = shift_recv
        self._coarse_replicated = replicated
        self._coarse_pipelined = pipelined
        self._coarse_owner = owner
        self._coarse_diag = diag
        self.coarse_chain = replicated
        self.raw = SimpleNamespace(
            predict=predict,
            sweep=sweep,
            residual=residual,
            endpoint=endpoint,
            shift_recv=shift_recv,
            coarse_replicated=replicated,
            coarse_pipelined=pipelined,
            coarse_owner=owner,
            coarse_diag=diag,
            wavefront=wavefront,
            wavefront_diag=wavefront_diag,
            # resolved by select_coarse_impl: the burn-in implementation the fused lane uses
            wavefront_active=wavefront,
        )

    def _build_mesh_kernels(self):
        """The batched functions on the time shards: each single-card function
        once per shard, as that shard's time row, with the copies between
        shards that the JAX package's collectives make."""
        one, B, homes = self._one, self.B, self.homes
        ctl, scal, ovs, per_shard = self.ctl, self.scal, self.ovs, self.per_shard
        device = self.level.prob.device  # the controller's device: where gathers land

        def predict(u0_block, t_arr, dt):
            u0s = self._shard(u0_block)
            return TimeShards(per_shard(lambda c: one.predict(u0s[c], ctl(t_arr, c), scal(dt, c))))

        def do_sweep(states, t_arr, dt, active, k, overrides=None):
            return TimeShards(per_shard(
                lambda c: one.sweep(states[c], ctl(t_arr, c), scal(dt, c), ctl(active, c), k, ovs(overrides, c))))

        def residual(states, dt):
            return self.mesh.gather(per_shard(lambda c: one.residual(states[c], scal(dt, c))), device)

        def endpoint(states, t_arr, dt, active, uend_old):
            return TimeShards(per_shard(
                lambda c: one.endpoint(states[c], ctl(t_arr, c), scal(dt, c), ctl(active, c), uend_old[c])))

        def shift_recv(states, uend, t_arr, recv_mask):
            """u0[j] <- uend[j-1]: within a shard a shift, across a shard
            boundary one field copied to the next shard (the ``ppermute``)."""

            def shard(c):
                left = states[0].u[0, :1] if c == 0 else self.mesh.copy_to(uend[c - 1][-1:], homes[c])
                return one.set_u0_one(states[c], torch.cat([left, uend[c][:-1]]), ctl(t_arr, c), ctl(recv_mask, c))

            return TimeShards(per_shard(shard))

        def coarse_replicated(states, uend, t_arr, dt, recv_mask, active, k, overrides=None):
            """The whole coarse block gathered on the controller's device, the
            serial chain computed there (as time row 0), the result split again."""
            with self.mesh.time_row(0):
                s, ue = one.coarse_serial(self.whole(states), self.whole(uend), t_arr.to(device), scal(dt, 0),
                                          recv_mask.to(device), active.to(device), k, overrides)
            return self.shard_tree(s), self.shard_tree(ue)

        def coarse_pipelined(states, uend, t_arr, dt, recv_mask, active, k, overrides=None):
            """One step's state per link moved to the controller's device,
            swept there (as time row 0) and handed back to its shard: the
            block stays sharded, one step is ever whole in one place."""
            carry = self.mesh.copy_to(states[0].u[0, 0], device)
            us, fs, ues = [[] for _ in homes], [[] for _ in homes], [[] for _ in homes]
            t_arr, recv_mask, active = t_arr.to(device), recv_mask.to(device), active.to(device)
            for q in range(self.P):
                c, j = divmod(q, B)
                s_q = _map_state(lambda a: self.mesh.copy_to(a[:, j], device), states[c])
                ov_q = {key: v[q].to(device) for key, v in (overrides or {}).items()}
                with self.mesh.time_row(0):
                    u, f, carry = one.link(s_q, carry, t_arr[q], recv_mask[q], active[q], ov_q,
                                           self.mesh.copy_to(uend[c][j], device), scal(dt, 0), k)
                us[c].append(self.mesh.copy_to(u, homes[c]))
                fs[c].append(map_components(lambda a, c=c: self.mesh.copy_to(a, homes[c]), f))
                ues[c].append(self.mesh.copy_to(carry, homes[c]))
            return (TimeShards(one.stack_steps(us[c], fs[c], states[c].tau) for c in range(self.n_time)),
                    TimeShards(torch.stack(ue) for ue in ues))

        def coarse_owner(states, uend, t_arr, dt, recv_mask, active, k, overrides=None):
            """Owner-computes chain: shard ``c`` sweeps its own steps in turn,
            starting from the end point its predecessor handed over the ring;
            no step is swept twice and the block never leaves its shards."""
            new_s, new_ue = [], []
            carry = states[0].u[0, 0]
            for c in range(self.n_time):
                if c > 0:
                    carry = self.mesh.copy_to(new_ue[-1][-1], homes[c])
                with self.mesh.time_row(c):
                    s, ue = one.coarse_serial(states[c], uend[c], ctl(t_arr, c), scal(dt, c), ctl(recv_mask, c),
                                              ctl(active, c), k, ovs(overrides, c), carry=carry)
                new_s.append(s)
                new_ue.append(ue)
            return TimeShards(new_s), TimeShards(new_ue)

        self._install(predict, do_sweep, residual, endpoint, shift_recv, coarse_replicated, coarse_pipelined,
                      coarse_owner)

    def _owner_chain_eligible(self):
        """The owner-computes chain needs the block time-sharded on a
        time-only mesh."""
        m = self.mesh
        return (
            m is not None
            and 'time' in m.axis_names
            and m.shape['time'] > 1
            and self.P % m.shape['time'] == 0
            and all(m.shape[ax] == 1 for ax in m.axis_names if ax != 'time')
        )

    def select_coarse_impl(self, mode='auto', threshold_bytes=4 << 20):
        """Pick the Gauss-Seidel chain implementation.

        'diag' runs the whole serial chain (and the burn-in wavefront) in
        the operator's diagonal basis — one batched transform in/out, P
        elementwise sweep links — for linear diagonalizable coarse problems
        without a mesh.  'owner' keeps the block time-sharded and only the
        owning shard sweeps each step (uend rides the ring to the successor).
        'replicated' gathers the coarse block once per chain and computes the
        chain on the controller's device; 'pipelined' moves one step's state
        there per link.  Without a mesh the last two are the same serial loop.
        'auto' prefers 'diag', then 'owner' on eligible meshes, then sizes
        between the other two via ``threshold_bytes``."""
        if mode == 'auto':
            if self._diag_eligible:
                mode = 'diag'
            elif self._owner_chain_eligible():
                mode = 'owner'
            else:
                prob = self.level.prob
                M = self.level.sweep.coll.num_nodes
                itemsize = torch.empty((), dtype=prob.dtype).element_size()
                est = self.P * int(np.prod(prob.shape)) * itemsize * (3 * M + 2)
                mode = 'pipelined' if est > threshold_bytes else 'replicated'
        if mode == 'owner' and not self._owner_chain_eligible():
            raise ControllerError('owner coarse chain needs a time-only mesh dividing P')
        if mode == 'diag' and not self._diag_eligible:
            raise ControllerError(
                'diag coarse chain needs a diagonalizable operator, a fixed-QI generic-implicit sweeper, '
                'and no device mesh'
            )
        chains = {'owner': self._coarse_owner, 'pipelined': self._coarse_pipelined,
                  'replicated': self._coarse_replicated, 'diag': self._coarse_diag}
        if mode not in chains:
            raise ControllerError(f'unknown coarse_mode {mode!r}')
        self.coarse_chain = chains[mode]
        self.raw.wavefront_active = self.raw.wavefront_diag if mode == 'diag' else self.raw.wavefront
        return mode

    def reset(self):
        self.state = None
        self.uend = self.new_uend()
        self.uold = None
        self.fold = None


class _BlockTransfer:
    """Batched FAS transfer between two block levels: ``BaseTransfer``'s
    state functions on blocks (the time axis rides behind the node axis
    through the space transfers, the node matrices and the coarse ``eval_f``);
    on a mesh once per time shard."""

    def __init__(self, base_transfer, fine_block, coarse_block):
        self.bt = base_transfer
        self.fine = fine_block
        self.coarse = coarse_block
        bt = base_transfer
        blk = fine_block

        def restrict(F_states, t_arr, dt_c, dt_f):
            if blk.mesh is None:
                G = bt._restrict_state(F_states, t_arr, dt_c, dt_f)
                return G, G.u, G.f
            Gs = TimeShards(blk.per_shard(lambda c: bt._restrict_state(
                F_states[c], blk.ctl(t_arr, c), blk.scal(dt_c, c), blk.scal(dt_f, c))))
            return Gs, TimeShards(G.u for G in Gs), TimeShards(G.f for G in Gs)

        def prolong(F_states, G_states, G_uold, t_arr, dt_f):
            if blk.mesh is None:
                return bt._prolong_state(F_states, G_states, G_uold, t_arr, dt_f)
            return TimeShards(blk.per_shard(lambda c: bt._prolong_state(
                F_states[c], G_states[c], G_uold[c], blk.ctl(t_arr, c), blk.scal(dt_f, c))))

        self.restrict = self.restrict_raw = restrict
        self.prolong = self.prolong_raw = prolong


class ShardedController(ControllerNonMPI):
    """Block PFASST with the time axis as a tensor axis, with the complete
    hook and convergence-controller stack of the virtual controller."""

    def __init__(self, num_procs: int, controller_params: dict, description: dict, mesh=None,
                 coarse_mode: str = 'auto'):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise ControllerError(f'mesh must be a pysdc_tpu_torch.parallel.mesh.Mesh (make_mesh), got {mesh!r}')
        self.mesh = mesh
        super().__init__(num_procs, controller_params, description)

        if mesh is not None:
            self._fit_to_mesh(mesh, num_procs)

        template = self.MS[0]
        self.num_procs = num_procs
        self.blocks = [_BlockLevel(lvl, num_procs, mesh) for lvl in template.levels]
        self.transfers = [
            _BlockTransfer(bt, self.blocks[i], self.blocks[i + 1])
            for i, bt in enumerate(template.base_transfers)
        ]
        #: resolved Gauss-Seidel chain strategy on the coarsest level
        self.coarse_mode = self.blocks[-1].select_coarse_impl(coarse_mode)
        #: device values read on the host by a fused lane's last run: ``cont`` flags and fetches (of iteration
        #: counts and residual histories; on the adaptive lane one per block, with the error estimates), by kind
        self.host_reads = {'cont': 0, 'fetch': 0}

    def _fit_to_mesh(self, mesh, num_procs):
        """Check the mesh against the problem and set the operators up for it:
        full complex FFT solves where the space axis is sharded (as the JAX
        package's GSPMD workaround), the halo apply on space-sharded meshes
        without a node axis where the slabs are at least one stencil radius
        deep, and the dense space transfers there.  The applies of each shard
        stay on K1: a shard is a plain tensor on its device, so nothing forces
        the rolls that GSPMD forced in the JAX package (``disable_pallas``)."""
        from pysdc_tpu_torch.ops.linop import SeparableFDOperator
        from pysdc_tpu_torch.transfer.space_mesh import MeshTransfer

        device = self.MS[0].levels[0].prob.device
        for d in mesh.device_set:
            if d.type != device.type:
                raise ControllerError(f'the problem lives on {device} and the mesh has a position on {d}: build the '
                                      'problem on the devices of the mesh')
        n_time = mesh.shape['time']
        if num_procs % n_time:
            raise ControllerError(f'{num_procs} steps do not divide over the {n_time} time positions of the mesh')
        n_sp = mesh.shape.get('space', 1)
        space_sharded = n_sp > 1
        space_only = space_sharded and mesh.shape.get('node', 1) == 1
        for S in self.MS:
            for lvl in S.levels:
                for attr in vars(lvl.prob).values():
                    if isinstance(attr, SeparableFDOperator):
                        if space_sharded:
                            attr.disable_rfft()
                        if (
                            space_only
                            and attr._cross_terms is not None
                            and attr.shape[-2] % n_sp == 0
                            and attr.shape[-2] // n_sp >= max(abs(s) for c, o in attr._cross_terms for s in o)
                        ):
                            attr.enable_halo(mesh)
            if space_sharded:
                for bt in S.base_transfers:
                    if isinstance(bt.space_transfer, MeshTransfer):
                        bt.space_transfer.disable_stencils()

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

        with trace.march(lane == 'fused'):  # the fused lane's host span (utils/trace.py), while tracing is on
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
        a block is one captured CUDA graph, its PFASST iterate-until-converged
        loop a device ``while``, and the march reads the host once, at its
        fetch.  Same uend and iteration counts as :meth:`run` (gated in
        tests/test_torch_fused.py); stats carry the default entries only.  Adaptive configurations route to
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
            L.state = blk.step_state(j)
            if blk.uend is not None:
                L.uend = blk.step_uend(j)
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
