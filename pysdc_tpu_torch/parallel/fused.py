"""Device-resident PFASST block execution (the production fast lane).

The counterpart of ``pysdc_tpu/parallel/fused.py`` (the plain lane).  The
stage-machine controllers interleave Python dispatch with device work: every
stage is a chain of small launches and every check reads residuals on the
host.  This module composes one ENTIRE block solve — SPREAD, the predictor,
and the iterate-until-converged PFASST loop with Gauss-Seidel convergence
forwarding — from the block controller's batched functions
(``parallel/sharded.py``), with the convergence flags, the iteration counts
and the residual history kept on the device.

In the JAX package a block is one ``lax.while_loop`` program and a march one
``lax.scan``.  Here a block is one program too, over one carry of static
buffers: ``start`` (spread and predictor), one ``check`` (IT_CHECK), then
``while cont: work, check`` (``work`` is one iteration's sweeps and
transfers) as a device ``while`` (:func:`pysdc_tpu_torch.ops.graph_loop.device_while`,
a CUDA conditional WHILE node).  As under the JAX ``lax.cond(cont, work)``, the
work after a check that ends the loop is not run.  The loop stops at
``maxiter + 2`` checks at the latest; a block that ends there with a step not
done raises ``ControllerError`` after the march's fetch.

- on a CUDA tensor the block is ONE captured CUDA graph
  (``torch.cuda.CUDAGraph``), replayed once a block.  The step times, the
  window of active slots, ``u0`` and the per-level step sizes ``dts`` (one
  float64 tensor of ``nlevels`` entries) are input buffers written before a
  replay: the pieces read ``dt`` from the device, so ONE program serves every
  step size, as the JAX program takes ``dts`` as a traced array.  A capture
  that fails raises: there is no return to eager on the card;
- on a CPU tensor the same function runs eagerly, the device ``while`` as its
  plain version (that is what the tests drive).

The iterative solves inside the block (PCG, CG, GMRES, the Newton loops, the
refinement of a prepared factorization) are device ``while`` loops nested in
the block's: each replay runs them to tolerance, or to their ``maxiter``,
exactly as the stage lane and the JAX package's ``lax.while_loop`` do.

A march reads nothing on the host until its end and never waits on the card:
every input is made on the device (the block starts once a march, ``dts`` once
a run, the tail's window as ``arange < n``), ``uend`` stays on the device from
block to block, and each block's iteration counts, residual history and cap
flag are copied into buffers made once a march and fetched in one transfer at
its end.  On the card the march runs under ``set_sync_debug_mode('error')``
from its first replay to the fetch.  ``ctrl.host_reads`` counts ``cont`` (0:
nothing reads it) and ``fetch`` (1 a march).  The march is a host loop of one
replay a block, not one graph as the JAX ``lax.scan`` is: the host needs
microseconds to enqueue a block, the card milliseconds to run it.

Semantics are pinned to the stage machine (``parallel/nonmpi.py``): the
per-iteration order is IT_CHECK (boundary exchange, residual, convergence
flags with prev_done forwarding) -> IT_DOWN (restrict cascade with
intermediate sweeps) -> IT_COARSE (serialized Gauss-Seidel chain) -> IT_UP
(prolong cascade) -> IT_FINE (nsweeps fine sweeps with exchanges).
``tests/test_torch_fused.py`` gates uend and per-step iteration counts against
the virtual controllers of both packages.

On a mesh the block runs its functions on its time shards (the carry's
buffers are the shards' tensors, the copies between shards are captured with
the rest).  A capture is one device's: a mesh whose positions
span more than one device is refused by name, and ``lane='auto'`` takes the
stage machine for it.

Eligibility is checked (ineligible raises ControllerError so callers fall
back to the stage-machine path), including the registered hooks: only hooks
whose entries the fused lane actually produces are allowed.  Per-sweep
residual/timing entries are not recorded — the device loop does not compute
them.

The adaptive lane (``run_fused_adaptive``) runs the embedded-error adaptivity
stack.  ``Adaptivity`` needs ``restol < 0``, so every step runs exactly
``maxiter`` iterations and a block is three graphs, ``start``, ``maxiter`` x
(``check``, ``work``) and a final ``check``, with no ``cont`` read at all, then ONE fetch
of the residual history and the error-estimate history.  The hook points and the genuine IT_CHECK policy sequence (dt
proposal, limiters, restart cascade) are then replayed on the host from the
fetched histories through the same policy objects as the stage machine.  The
final check's estimator reads its own norm (one small read per step of the
block, counted under ``ctrl.host_reads['estimate']``).
"""

from __future__ import annotations

import contextlib
import gc
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from pysdc_tpu_torch.convergence.basic_restarting import BasicRestarting
from pysdc_tpu_torch.convergence.check_convergence import CheckConvergence
from pysdc_tpu_torch.convergence.spread_step_sizes import SpreadStepSizesBlockwise
from pysdc_tpu_torch.core.errors import ControllerError
from pysdc_tpu_torch.ops import graph_loop
from pysdc_tpu_torch.parallel.mesh import TimeShards
from pysdc_tpu_torch.utils import trace


class _Carry(NamedTuple):
    states: tuple  # LevelState per level, leaves (M+1, P, *shape) (on a mesh: TimeShards of them)
    uends: tuple  # (P, *shape_l) per level (on a mesh: TimeShards)
    done: torch.Tensor  # (P,) bool
    iters: torch.Tensor  # (P,) int32
    res_hist: torch.Tensor  # (maxiter+2, P) residuals at each IT_CHECK
    k: torch.Tensor  # scalar int32: IT_CHECK counter
    cont: torch.Tensor  # scalar bool: keep iterating


def _plain_hook_allowlist():
    from pysdc_tpu_torch.core.hooks import CPUTimings, DefaultHooks
    from pysdc_tpu_torch.hooks.logging_hooks import LogRestarts

    return (DefaultHooks, CPUTimings, LogRestarts)


class _AdaptiveCarry(NamedTuple):
    states: tuple  # LevelState per level, leaves (M+1, P, *shape) (on a mesh: TimeShards of them)
    uends: tuple  # (P, *shape_l) per level (on a mesh: TimeShards)
    res_hist: torch.Tensor  # (maxiter+1, P) residuals at each IT_CHECK
    e_hist: torch.Tensor  # (maxiter+1, P) embedded estimates at each IT_CHECK
    prev_last: torch.Tensor  # (P, *shape): the last node's value before the latest iteration's work
    k: torch.Tensor  # scalar int32: IT_CHECK counter


def _adaptive_hook_allowlist():
    from pysdc_tpu_torch.hooks.logging_hooks import LogEmbeddedErrorEstimate, LogSolution, LogStepSize

    return _plain_hook_allowlist() + (LogEmbeddedErrorEstimate, LogStepSize, LogSolution)


def _check_hooks(ctrl, allowed, lane):
    for hook in ctrl.hooks:
        if not isinstance(hook, allowed):
            raise ControllerError(
                f'hook {type(hook).__name__} needs per-sweep data the {lane} lane does not '
                f'record; this configuration runs on the stage-machine path'
            )


def _shared_eligibility(ctrl):
    """Constraints common to both fused lanes."""
    if ctrl.params.use_iteration_estimator:
        raise ControllerError('fused block execution does not support the iteration estimator')
    for lvl in ctrl.MS[0].levels:
        if lvl.sweep.k_dependent:
            raise ControllerError(
                'fused block execution needs iteration-independent preconditioners '
                '(k-dependent QI/QE change coefficients per sweep)'
            )
    if ctrl.params.predict_type not in (None, 'fine_only', 'pfasst_burnin', 'fmg'):
        raise ControllerError(f'unknown predict_type {ctrl.params.predict_type!r}')
    if ctrl.mesh is not None and len(ctrl.mesh.device_set) > 1:
        raise ControllerError(
            f'fused block execution captures one CUDA graph per piece on one device; this mesh spans '
            f'{len(ctrl.mesh.device_set)} devices: run it with lane=\'stage\''
        )
    for lvl in ctrl.MS[0].levels:
        reason = lvl.prob.graph_capture_blocker
        if reason is not None:
            raise ControllerError(f'fused block execution captures the solves into CUDA graphs: {reason}')
        reason = lvl.sweep.graph_capture_blocker
        if reason is not None:
            raise ControllerError(f'fused block execution captures the sweeps into CUDA graphs: {reason}')


def check_fused_eligibility(ctrl):
    """Raise ControllerError when the configuration needs another path."""
    # the default stack: CheckConvergence + BasicRestarting and its
    # SpreadStepSizesBlockwise dependency (a no-op at fixed dt)
    allowed = (CheckConvergence, BasicRestarting, SpreadStepSizesBlockwise)
    for C in ctrl.convergence_controllers:
        if type(C) not in allowed:
            raise ControllerError(
                f'fused block execution supports only restol/maxiter termination; '
                f'{type(C).__name__} needs the adaptive fused lane or the stage-machine path'
            )
    lvl0 = ctrl.MS[0].levels[0]
    e_tol = getattr(lvl0.params, 'e_tol', None)
    if e_tol is not None and e_tol > 0:
        raise ControllerError('fused block execution does not support e_tol termination')
    for lvl in ctrl.MS[0].levels:
        if float(lvl.params.dt) != float(lvl0.params.dt):
            raise ControllerError('fused block execution needs one dt across levels')
    _shared_eligibility(ctrl)
    _check_hooks(ctrl, _plain_hook_allowlist(), 'fused')


def check_fused_adaptive_eligibility(ctrl):
    """Eligibility of the device-resident adaptive lane.

    Supported: the embedded-error production stack — ``Adaptivity`` (both
    estimator flavors) or ``AdaptivityRK`` (embedded Runge-Kutta pairs: the
    estimator reads the synced shadow state's secondary end point at the final
    check) + ``EstimateEmbeddedError`` + ``StoreUOld`` +
    ``BasicRestarting``/``SpreadStepSizesBlockwise`` + the step-size
    limiter/rounding family — under maxiter-only termination (``Adaptivity``
    itself enforces restol < 0).  Everything else raises and runs the stage
    machine.
    """
    from pysdc_tpu_torch.convergence.adaptivity import Adaptivity, AdaptivityRK
    from pysdc_tpu_torch.convergence.estimate_embedded_error import (
        EstimateEmbeddedError,
        EstimateEmbeddedErrorLinearized,
    )
    from pysdc_tpu_torch.convergence.step_size_limiter import (
        StepSizeLimiter,
        StepSizeRounding,
        StepSizeSlopeLimiter,
    )
    from pysdc_tpu_torch.convergence.store_uold import StoreUOld

    allowed = (
        CheckConvergence,
        BasicRestarting,
        SpreadStepSizesBlockwise,
        Adaptivity,
        AdaptivityRK,
        EstimateEmbeddedError,
        EstimateEmbeddedErrorLinearized,
        StoreUOld,
        StepSizeLimiter,
        StepSizeSlopeLimiter,
        StepSizeRounding,
    )
    for C in ctrl.convergence_controllers:
        # exact-type matching: subclasses carry different semantics the device program does not implement
        if type(C) not in allowed:
            raise ControllerError(
                f'{type(C).__name__} is not supported by the adaptive fused lane; '
                f'this configuration runs on the stage-machine path'
            )
    lvl0 = ctrl.MS[0].levels[0]
    if float(lvl0.params.restol) >= 0:
        raise ControllerError(
            'the adaptive fused lane runs a fixed-depth device loop and needs '
            'maxiter-only termination (restol < 0)'
        )
    e_tol = getattr(lvl0.params, 'e_tol', None)
    if e_tol is not None and e_tol > 0:
        raise ControllerError('the adaptive fused lane does not support e_tol termination')
    _shared_eligibility(ctrl)
    _check_hooks(ctrl, _adaptive_hook_allowlist(), 'adaptive fused')


def _build_parts(ctrl):
    """Shared building blocks of the whole-block device programs."""
    blocks = ctrl.blocks
    transfers = ctrl.transfers
    nlevels = ctrl.nlevels
    nsweeps = ctrl.nsweeps
    P = ctrl.num_procs
    predict_type = ctrl.params.predict_type
    mssdc_jac = bool(ctrl.params.mssdc_jac)
    coarse_raw = {
        'owner': blocks[-1].raw.coarse_owner,
        'pipelined': blocks[-1].raw.coarse_pipelined,
        'replicated': blocks[-1].raw.coarse_replicated,
        'diag': blocks[-1].raw.coarse_diag,
    }[ctrl.coarse_mode]
    device = ctrl.device
    arange = torch.arange(P, device=device)
    no_prev = torch.zeros((P,), dtype=torch.bool, device=device)

    def shifted(done):
        """prev_done per slot: done flag of the predecessor (False at slot 0)."""
        return torch.cat([no_prev[:1], done[:-1]])

    def exchange(lvl, state, uend, t_arr, dts, active, prev_done):
        raw = blocks[lvl].raw
        uend = raw.endpoint(state, t_arr, dts[lvl], active, uend)
        recv = active & (arange > 0) & ~prev_done
        state = raw.shift_recv(state, uend, t_arr, recv)
        return state, uend

    def sweep_rounds(lvl, state, uend, t_arr, dts, active, prev_done, n):
        """n x (exchange + masked sweep) — the _masked_sweeps loop body."""
        raw = blocks[lvl].raw
        for _ in range(n):
            state, uend = exchange(lvl, state, uend, t_arr, dts, active, prev_done)
            state = raw.sweep(state, t_arr, dts[lvl], active, 0)
        return state, uend

    def restrict_all(states, t_arr, dts):
        """Restrict fine -> coarsest through every level; keep uolds."""
        states = list(states)
        uolds = [None] * nlevels
        for l, tr in enumerate(transfers):
            Gs, Guold, _ = tr.restrict_raw(states[l], t_arr, dts[l + 1], dts[l])
            states[l + 1] = Gs
            uolds[l + 1] = Guold
        return states, uolds

    # -- predictors ------------------------------------------------------
    def predict_burnin(states, uends, t_arr, dts, window):
        """Staggered coarse wavefront (nonmpi.py _burnin, batched via masks);
        the wavefront is the diag-basis one when select_coarse_impl resolved
        'diag'.  The window's length is a device value, so the wavefront runs
        P rounds, those past the window masked out whole."""
        states, uolds = restrict_all(states, t_arr, dts)
        craw = blocks[-1].raw
        with trace.device_span('block.coarse'):
            cst, cuend = craw.wavefront_active(states[-1], uends[-1], t_arr, dts[-1], window, P)
        states[-1] = cst
        uends = list(uends)
        uends[-1] = cuend

        for l in range(nlevels - 1, 0, -1):
            states[l - 1] = transfers[l - 1].prolong_raw(
                states[l - 1], states[l], uolds[l], t_arr, dts[l - 1]
            )
        states[0], uends[0] = exchange(0, states[0], uends[0], t_arr, dts, window, no_prev)
        states[0] = blocks[0].raw.sweep(states[0], t_arr, dts[0], window, 0)
        return states, uends

    def predict_fmg(states, uends, t_arr, dts, window):
        """FMG predictor (nonmpi.py _full_multigrid, batched)."""
        states, uolds = restrict_all(states, t_arr, dts)
        uends = list(uends)
        recv = window & (arange > 0)
        with trace.device_span('block.coarse'):
            states[-1], uends[-1] = coarse_raw(
                states[-1], uends[-1], t_arr, dts[-1], recv, window, 0
            )
        for l in range(nlevels - 1, 0, -1):
            states[l - 1] = transfers[l - 1].prolong_raw(
                states[l - 1], states[l], uolds[l], t_arr, dts[l - 1]
            )
            if l - 1 > 0:
                states[l - 1] = blocks[l - 1].raw.sweep(states[l - 1], t_arr, dts[l - 1], window, 0)
        states[0], uends[0] = exchange(0, states[0], uends[0], t_arr, dts, window, no_prev)
        states[0] = blocks[0].raw.sweep(states[0], t_arr, dts[0], window, 0)
        return states, uends

    # -- one PFASST iteration of work (post IT_CHECK) --------------------
    def iteration_work(states, uends, t_arr, dts, active, prev_done):
        states = list(states)
        uends = list(uends)
        if nlevels == 1:  # the one level's iteration is its fine sweeps
            with trace.device_span('block.fine'):
                if P == 1 or mssdc_jac:
                    states[0], uends[0] = sweep_rounds(
                        0, states[0], uends[0], t_arr, dts, active, prev_done, nsweeps[0]
                    )
                else:  # Gauss-Seidel MSSDC: serialized single-level chain
                    recv = active & (arange > 0) & ~prev_done
                    states[0], uends[0] = coarse_raw(
                        states[0], uends[0], t_arr, dts[0], recv, active, 0
                    )
            return tuple(states), tuple(uends)

        # IT_DOWN: intermediate-level sweeps + restriction cascade
        uolds = [None] * nlevels
        with trace.device_span('block.down'):
            for l, tr in enumerate(transfers):
                if l > 0:
                    states[l], uends[l] = sweep_rounds(
                        l, states[l], uends[l], t_arr, dts, active, prev_done, nsweeps[l]
                    )
                Gs, Guold, _ = tr.restrict_raw(states[l], t_arr, dts[l + 1], dts[l])
                states[l + 1] = Gs
                uolds[l + 1] = Guold

        # IT_COARSE: serialized Gauss-Seidel chain over the time axis
        with trace.device_span('block.coarse'):
            recv = active & (arange > 0) & ~prev_done
            states[-1], uends[-1] = coarse_raw(
                states[-1], uends[-1], t_arr, dts[-1], recv, active, 0
            )

        # IT_UP: prolongation cascade (+ intermediate sweeps)
        with trace.device_span('block.up'):
            for l in range(nlevels - 1, 0, -1):
                states[l - 1] = transfers[l - 1].prolong_raw(
                    states[l - 1], states[l], uolds[l], t_arr, dts[l - 1]
                )
                if l - 1 > 0:
                    states[l - 1], uends[l - 1] = sweep_rounds(
                        l - 1, states[l - 1], uends[l - 1], t_arr, dts, active, prev_done,
                        nsweeps[l - 1],
                    )

        # IT_FINE
        with trace.device_span('block.fine'):
            states[0], uends[0] = sweep_rounds(
                0, states[0], uends[0], t_arr, dts, active, prev_done, nsweeps[0]
            )
        return tuple(states), tuple(uends)

    # the burn-in and FMG predictors restrict through every level themselves
    predictor_restricts = nlevels > 1 and predict_type in ('pfasst_burnin', 'fmg')

    def spread(u0, t_arr, dts):
        """SPREAD + coarse-carry materialization."""
        u0_block = u0.unsqueeze(0).expand((P,) + tuple(u0.shape)).contiguous()
        states = [blocks[0].raw.predict(u0_block, t_arr, dts[0])]
        uends = [blocks[0].new_uend(u0.dtype)]
        # materialize coarse-level carries (overwritten by every restriction).  Where the predictor
        # restricts anyway, that restriction is the one kept: XLA drops the dead one from the JAX
        # package's program, here it is left out by hand
        for l in range(1, nlevels):
            Gs = None
            if not predictor_restricts:
                Gs, _, _ = transfers[l - 1].restrict_raw(states[l - 1], t_arr, dts[l], dts[l - 1])
            states.append(Gs)
            uends.append(blocks[l].new_uend(u0.dtype))
        return states, uends

    def predict(states, uends, t_arr, dts, window):
        if predict_type == 'pfasst_burnin' and nlevels > 1:
            states, uends = predict_burnin(states, uends, t_arr, dts, window)
        elif predict_type == 'fmg' and nlevels > 1:
            states, uends = predict_fmg(states, uends, t_arr, dts, window)
        elif predict_type == 'fine_only':
            states = list(states)
            states[0], uends[0] = sweep_rounds(0, states[0], uends[0], t_arr, dts, window, no_prev, 1)
        return states, uends

    return SimpleNamespace(
        P=P,
        arange=arange,
        shifted=shifted,
        exchange=exchange,
        sweep_rounds=sweep_rounds,
        iteration_work=iteration_work,
        spread=spread,
        predict=predict,
    )


# -- the carry as a flat list of buffers ---------------------------------
def _leaves(tree) -> list:
    """The tensors of a carry (nested tuples of tensors), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for part in tree for leaf in _leaves(part)]


def _rebuild(template, leaves):
    """A tree shaped like ``template`` from the iterator ``leaves``."""
    if isinstance(template, torch.Tensor):
        return next(leaves)
    parts = [_rebuild(part, leaves) for part in template]
    if isinstance(template, TimeShards):
        return TimeShards(parts)
    return type(template)(*parts) if hasattr(template, '_fields') else tuple(parts)


class _BlockProgram:
    """One block program for one state dtype, shape and device, over static
    buffers: the graphs named by ``pieces.graphs``, captured once on the card;
    the plain functions on the CPU.  ``inputs`` are ``(u0, t_arr, window,
    dts)``: a piece named in ``pieces.from_inputs`` takes them all, the others
    the carry and all but ``u0``.  The caller writes the input buffers before
    it runs a piece; a piece leaves its result in :attr:`carry`.  A piece named
    in ``pieces.traced`` is a device span of its name (``utils/trace.py``),
    first node to last, while tracing is on."""

    def __init__(self, pieces, *inputs):
        self.pieces = pieces
        self.inputs = tuple(x.clone() for x in inputs)
        self.u0, self.t_arr, self.window, self.dts = self.inputs
        self.on_card = self.u0.device.type == 'cuda'
        self.carry = None
        if self.on_card:
            trace.count('fused.captures')
            with trace.span('march.capture'):
                self._capture()

    def _span(self, name):
        return trace.device_span(name) if name in self.pieces.traced else contextlib.nullcontext()

    def write(self, *inputs):
        for buf, value in zip(self.inputs, inputs):
            buf.copy_(value)

    def _call(self, name, carry):
        fn = getattr(self.pieces, name)
        return fn(*self.inputs) if name in self.pieces.from_inputs else fn(carry, *self.inputs[1:])

    def _capture(self):
        """Warm up on a side stream (FFT plans, launch plans and the constant
        tables are made at first use, which a capture does not allow), give
        the carry its buffers, then capture each graph: it computes from the
        buffers and copies its results back into them."""
        inputs = self.inputs
        side = torch.cuda.Stream(device=self.u0.device)
        side.wait_stream(torch.cuda.current_stream(self.u0.device))
        with torch.cuda.stream(side):
            carry = self.pieces.warm(*inputs)
            self.carry = _rebuild(carry, iter([leaf.clone() for leaf in _leaves(carry)]))
            del carry
        torch.cuda.current_stream(self.u0.device).wait_stream(side)
        torch.cuda.synchronize(self.u0.device)

        # the device loops' library, body streams and pools: a capture may not make them
        graph_loop.prepare(self.u0.device)
        # a CUDA graph that is garbage (an earlier controller's program) must go now: the collector could
        # otherwise destroy it in the middle of a capture, which CUDA does not permit and which ends the capture
        gc.collect()
        buffers = _leaves(self.carry)
        owned = {b.untyped_storage().data_ptr() for b in buffers}
        pool = torch.cuda.graph_pool_handle()
        self.graphs = {}
        for name in self.pieces.graphs:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool), self._span(name):
                new = self._call(name, self.carry)
                # results that are views of a buffer are read before any buffer is written
                pairs = [
                    (old, leaf.clone() if leaf.untyped_storage().data_ptr() in owned else leaf)
                    for old, leaf in zip(buffers, _leaves(new))
                    if leaf is not old  # else: passed through untouched
                ]
                for old, leaf in pairs:
                    old.copy_(leaf)
            self.graphs[name] = graph

    def run(self, piece):
        if self.on_card:
            self.graphs[piece].replay()
        else:
            with self._span(piece):
                self.carry = self._call(piece, self.carry)


class _Programs:
    """The block programs of one controller, one per state dtype, shape,
    device and tracing state (:func:`pysdc_tpu_torch.utils.trace.key`: a
    program captured while tracing is on holds its stamps): the step sizes are
    inputs, so nothing of ``dt`` is in the key."""

    def __init__(self, ctrl):
        self.ctrl = ctrl
        self.parts = _build_parts(ctrl)
        self.maxiter = int(ctrl.MS[0].params.maxiter)
        self._programs = {}

    def _program(self, u0, t_arr, window, dts):
        key = (u0.dtype, u0.device, tuple(u0.shape), trace.key())
        prog = self._programs.get(key)
        if prog is None:
            # a program traced under an earlier trace.enable() stamps a table that is gone
            self._programs = {k: p for k, p in self._programs.items() if k[-1] is None}
            prog = self._programs[key] = _BlockProgram(self._pieces(), u0, t_arr, window, dts)
        return prog

    def _inputs(self, u0, t_arr, window, dts):
        """The inputs as tensors on ``u0``'s device; ``dts`` a host number (one
        ``dt`` on every level, filled on the device), a sequence of per-level
        numbers or a tensor.  Tensors on the device pass through untouched: a
        march that gives them makes no copy from the host."""
        device = u0.device
        nlevels = self.ctrl.nlevels
        t_arr = torch.as_tensor(t_arr, dtype=torch.float64, device=device)
        window = torch.as_tensor(window, dtype=torch.bool, device=device)
        if isinstance(dts, (int, float)):
            dts = torch.full((nlevels,), float(dts), dtype=torch.float64, device=device)
        elif not isinstance(dts, torch.Tensor):
            dts = np.broadcast_to(np.asarray(dts, dtype=np.float64), (nlevels,)).copy()
        dts = torch.as_tensor(dts, dtype=torch.float64, device=device).expand(nlevels)
        return u0, t_arr, window, dts


class _FusedBlock(_Programs):
    """``fused(u0, t_arr, dt, window)`` of :func:`build_fused_block`."""

    def _pieces(self):
        """The JAX package's block: ``start``, one ``check``, then ``while cont:
        work, check`` as a device ``while`` (``block``, one graph)."""
        ctrl, parts = self.ctrl, self.parts
        blocks = ctrl.blocks
        P = ctrl.num_procs
        restol = float(ctrl.MS[0].levels[0].params.restol)
        maxiter = self.maxiter
        all_to_done = bool(ctrl.params.all_to_done)
        rows = torch.arange(maxiter + 2, device=ctrl.device).unsqueeze(1)

        def start(u0, t_arr, window, dts):
            with trace.device_span('block.start'):
                dts = dts.unbind(0)  # per level, 0-d views of the input buffer (the plain lane: one dt on every level)
                states, uends = parts.spread(u0, t_arr, dts)
                states, uends = parts.predict(states, uends, t_arr, dts, window)
                return _Carry(
                    states=tuple(states),
                    uends=tuple(uends),
                    done=~window,
                    iters=torch.zeros((P,), dtype=torch.int32, device=u0.device),
                    res_hist=torch.zeros((maxiter + 2, P), dtype=u0.dtype, device=u0.device),
                    k=torch.zeros((), dtype=torch.int32, device=u0.device),
                    cont=torch.ones((), dtype=torch.bool, device=u0.device),
                )

        def check(c, t_arr, window, dts):
            # IT_CHECK: exchange + residual + convergence flags
            with trace.device_span('block.check'):
                dts = dts.unbind(0)
                active = window & ~c.done
                prev_done = parts.shifted(c.done)
                states = list(c.states)
                uends = list(c.uends)
                states[0], uends[0] = parts.exchange(0, states[0], uends[0], t_arr, dts, active, prev_done)
                res = blocks[0].raw.residual(states[0], dts[0])
                # row k of the history, active steps only (k lives on the device)
                res_hist = torch.where((rows == c.k) & active, res.to(c.res_hist.dtype), c.res_hist)

                raw_done = (res <= restol) | (c.iters >= maxiter)
                done = c.done | (active & raw_done) | ~window
                # Gauss-Seidel forwarding: done[j] requires done[j-1] (prefix AND)
                done = torch.cumprod(done.to(torch.int32), dim=0).bool() | ~window
                if all_to_done:
                    done = done.all() | ~window
                iters = torch.where(window & ~done, c.iters + 1, c.iters)
                cont = ~done.all()
                return _Carry(tuple(states), tuple(uends), done, iters, res_hist, c.k + c.cont.to(torch.int32), cont)

        def work(c, t_arr, window, dts):
            active = window & ~c.done
            states, uends = parts.iteration_work(c.states, c.uends, t_arr, dts.unbind(0), active,
                                                 parts.shifted(c.done))
            return c._replace(states=states, uends=uends)

        def block(u0, t_arr, window, dts):
            # the JAX package's lax.while_loop with its lax.cond(cont, work): the work after a check that ends
            # the loop is not run.  At most maxiter + 2 checks: the last trip starts at k = maxiter + 1
            first = check(start(u0, t_arr, window, dts), t_arr, window, dts)

            def again(leaves):  # k and cont are the carry's last two fields
                return leaves[-1] & (leaves[-2] <= maxiter + 1)

            def trip(leaves):
                c = _rebuild(first, iter(leaves))
                return _leaves(check(work(c, t_arr, window, dts), t_arr, window, dts))

            leaves, _ = graph_loop.device_while(again, trip, tuple(_leaves(first)))
            return _rebuild(first, iter(leaves))

        def warm(u0, t_arr, window, dts):
            """The block's pieces one after another, eager: what the capture finds made."""
            c = check(start(u0, t_arr, window, dts), t_arr, window, dts)
            return check(work(c, t_arr, window, dts), t_arr, window, dts)

        return SimpleNamespace(start=start, check=check, work=work, block=block, warm=warm, graphs=('block',),
                               from_inputs=('block',), traced=('block',))

    def replay(self, u0, t_arr, dt, window):
        """One block from ``u0``: the program's carry, valid until the next call (no copy, no host read)."""
        inputs = self._inputs(u0, t_arr, window, dt)
        prog = self._program(*inputs)
        with trace.replay():
            prog.write(*inputs)
            prog.run('block')
        return prog.carry

    def __call__(self, u0, t_arr, dt, window):
        """One block from ``u0``: ``(uend_block, iters, res_hist, n_checks,
        cont)``, tensors on ``u0``'s device (copies: the next call reuses the
        buffers).  ``cont`` is set where the block ended on its trip cap, a step
        not done."""
        c = self.replay(u0, t_arr, dt, window)
        return (self.ctrl.blocks[0].whole(c.uends[0]).clone(), c.iters.clone(), c.res_hist.clone(), c.k.clone(),
                c.cont.clone())


def build_fused_block(ctrl):
    """The whole-block PFASST solve for a ShardedController.

    Returns ``fused(u0, t_arr, dt, window) -> (uend_block, iters, res_hist,
    n_checks, cont)`` where ``window`` is the (P,) prefix mask of active
    slots.  On the card the first call captures the block's graph; it serves
    every ``dt`` (a host number or a 0-d tensor).
    """
    return _FusedBlock(ctrl)


class _FusedAdaptiveBlock(_Programs):
    """``fused_adaptive(u0, t_arr, dts, window)`` of :func:`build_fused_adaptive_block`."""

    def __init__(self, ctrl):
        super().__init__(ctrl)
        from pysdc_tpu_torch.convergence.estimate_embedded_error import EstimateEmbeddedError

        self.rel_error = False
        for C in ctrl.convergence_controllers:
            if isinstance(C, EstimateEmbeddedError):
                self.rel_error = bool(C.params.rel_error)

    def _pieces(self):
        ctrl, parts = self.ctrl, self.parts
        blocks = ctrl.blocks
        P = ctrl.num_procs
        maxiter = self.maxiter
        rel_error = self.rel_error
        rows = torch.arange(maxiter + 1, device=ctrl.device).unsqueeze(1)
        no_prev = torch.zeros((P,), dtype=torch.bool, device=ctrl.device)

        def step_norm(x):
            """Per-step max-abs over everything but the leading (P,) axis."""
            return x.abs().flatten(1).amax(dim=1) if x.dim() > 1 else x.abs()

        def start(u0, t_arr, window, dts):
            dts = dts.unbind(0)
            states, uends = parts.spread(u0, t_arr, dts)
            states, uends = parts.predict(states, uends, t_arr, dts, window)
            hist = torch.zeros((maxiter + 1, P), dtype=u0.dtype, device=u0.device)
            return _AdaptiveCarry(
                states=tuple(states),
                uends=tuple(uends),
                res_hist=hist,
                e_hist=hist.clone(),
                prev_last=blocks[0].last_node(states[0]).clone(),
                k=torch.zeros((), dtype=torch.int32, device=u0.device),
            )

        def check(c, t_arr, window, dts):
            dts = dts.unbind(0)
            states = list(c.states)
            uends = list(c.uends)
            states[0], uends[0] = parts.exchange(0, states[0], uends[0], t_arr, dts, window, no_prev)
            res = blocks[0].raw.residual(states[0], dts[0])
            row = (rows == c.k) & window
            res_hist = torch.where(row, res.to(c.res_hist.dtype), c.res_hist)
            cur = blocks[0].last_node(states[0])
            e = step_norm(cur - c.prev_last)
            if rel_error:
                # an inactive step's norm may be 0: mask before dividing
                e = e / torch.where(window, step_norm(cur), torch.ones_like(e))
            e_hist = torch.where(row, e.to(c.e_hist.dtype), c.e_hist)
            return c._replace(states=tuple(states), uends=tuple(uends), res_hist=res_hist, e_hist=e_hist, k=c.k + 1)

        def work(c, t_arr, window, dts):
            # prev_last entering the final check = u^{maxiter-1}[-1]: the host injects it as L.uold so the
            # genuine EstimateEmbeddedError policy computes the final estimate itself (advance_fused_adaptive)
            prev_last = blocks[0].last_node(c.states[0])
            states, uends = parts.iteration_work(c.states, c.uends, t_arr, dts.unbind(0), window, no_prev)
            return c._replace(states=states, uends=uends, prev_last=prev_last)

        def warm(u0, t_arr, window, dts):
            return work(check(start(u0, t_arr, window, dts), t_arr, window, dts), t_arr, window, dts)

        return SimpleNamespace(start=start, check=check, work=work, warm=warm, graphs=('start', 'check', 'work'),
                               from_inputs=('start',), traced=())

    def __call__(self, u0, t_arr, dts, window):
        """One block of exactly ``maxiter`` iterations from ``u0``:
        ``(fine_state, uend_block, res_hist, e_hist, prev_last)``.
        No host read; the tensors are the program's own buffers, valid until
        the next call."""
        inputs = self._inputs(u0, t_arr, window, dts)
        prog = self._program(*inputs)
        prog.write(*inputs)
        prog.run('start')
        for _ in range(self.maxiter):
            prog.run('check')
            prog.run('work')
        prog.run('check')
        c = prog.carry
        return c.states[0], c.uends[0], c.res_hist, c.e_hist, c.prev_last


def build_fused_adaptive_block(ctrl):
    """Fixed-depth whole-block program for the adaptive stack.

    With restol disabled (Adaptivity's contract) every step runs exactly
    ``maxiter`` iterations, so the block is a loop of fixed depth — no
    convergence flags, no early exit, no ``cont`` read.  Besides the residual
    history the program tracks the embedded error estimate on the device: at
    IT_CHECK k the sweep-to-sweep difference at the last collocation node
    ``|u^k[-1] - u^{k-1}[-1]|`` (the reference's ``EstimateEmbeddedError``
    from ``StoreUOld`` snapshots, estimate_embedded_error.py:9-150).

    Returns ``fused_adaptive(u0, t_arr, dts, window) -> (fine_state,
    uend_block, res_hist, e_hist, prev_last)`` with histories
    shaped (maxiter+1, P) and ``dts`` the per-level step sizes.
    """
    return _FusedAdaptiveBlock(ctrl)


def build_fused_many(ctrl, fused):
    """March the single-block program over consecutive FULL blocks.

    ``fused_many(u0, dt, starts, dts=None)``: ``starts`` the block start
    times (a float64 tensor on ``u0``'s device, or numbers), ``dts`` the
    per-level step sizes on the device (filled from ``dt`` when not given).
    Every input is made on the device, the uend -> next-u0 chain stays there
    and each block's iteration counts, residual history and cap flag are
    copied into buffers made once a march: the march reads nothing on the host
    and never waits on the card.  Returns ``(uend, iters (n, P), res_hist (n,
    maxiter + 2, P), cont (n,))`` on the device."""
    P = ctrl.num_procs

    def fused_many(u0, dt, starts, dts=None):
        device = u0.device
        starts = torch.as_tensor(starts, dtype=torch.float64, device=device)
        if dts is None:
            dts = torch.full((ctrl.nlevels,), float(dt), dtype=torch.float64, device=device)
        t_all = starts.unsqueeze(1) + dt * torch.arange(P, dtype=torch.float64, device=device)
        window = torch.ones((P,), dtype=torch.bool, device=device)
        n = starts.shape[0]
        iters_all = torch.empty((n, P), dtype=torch.int32, device=device)
        res_all = torch.empty((n, fused.maxiter + 2, P), dtype=u0.dtype, device=device)
        cont_all = torch.empty((n,), dtype=torch.bool, device=device)
        uend = u0
        for b in range(n):
            c = fused.replay(uend, t_all[b], dts, window)
            iters_all[b].copy_(c.iters)
            res_all[b].copy_(c.res_hist)
            cont_all[b].copy_(c.cont)
            uend = ctrl.blocks[0].whole(c.uends[0])[P - 1]  # the next block's write copies it into u0's buffer
        return uend.clone(), iters_all, res_all, cont_all

    return fused_many


def _fetch(tensors) -> list:
    """The tensors on the host in one transfer (their bytes in one buffer), each back in its dtype and shape as a
    numpy array."""
    flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        out.append(flat[at:at + n].view(np.dtype(str(t.dtype).removeprefix('torch.'))).reshape(tuple(t.shape)))
        at += n
    return out


@contextlib.contextmanager
def _no_sync(device):
    """On the card, a synchronizing call (a read on the host, a copy from pageable memory) raises inside: the
    march never waits on the card."""
    if device.type != 'cuda':
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode('error')
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def run_fused(ctrl, u0, t0, Tend):
    """Whole-block device-resident run loop for a ShardedController.

    Mirrors ControllerNonMPI.run's block marching (without restarts, which
    eligibility excludes) and returns ``(uend, stats)`` with the default
    stats entries synthesized, as host floats, from the iteration counts and
    residual histories fetched once at the end of the march.  On the card the
    block's graph is captured before the march, and from the first replay to
    the fetch the march runs under ``torch.cuda.set_sync_debug_mode('error')``.
    While tracing is on (``utils/trace.py``) the spans ``march.enqueue``,
    ``march.fetch`` and ``march.stats`` are kept, and the fetch brings the
    blocks' stamps home with the counts.
    """
    from pysdc_tpu_torch.parallel.nonmpi import _horizon_slack

    check_fused_eligibility(ctrl)
    if getattr(ctrl, '_fused_fn', None) is None:
        ctrl._fused_fn = build_fused_block(ctrl)
        ctrl._fused_many_fn = build_fused_many(ctrl, ctrl._fused_fn)

    for hook in ctrl.hooks:
        hook.reset_stats()
    hooks0 = ctrl.hooks[0]
    ctrl.host_reads = {'cont': 0, 'fetch': 0}

    P = ctrl.num_procs
    dt = float(ctrl.MS[0].levels[0].params.dt)
    maxiter = int(ctrl.MS[0].params.maxiter)
    nsw = ctrl.nsweeps[0]
    slack = _horizon_slack(Tend)

    converged = True

    def emit_stats(t_block, iters_h, res_h, n_active):
        nonlocal converged
        for p in range(n_active):
            t_p = float(t_block + dt * p)
            niter = int(iters_h[p])
            converged = converged and niter < maxiter
            for it in range(1, niter + 1):
                hooks0.add_to_stats(
                    process=p, time=t_p, level=-1, iter=it, sweep=nsw,
                    type='residual_post_iteration', value=float(res_h[it, p]),
                )
            final_sweep = nsw if niter > 0 else 1
            for typ, val in (
                ('niter', niter),
                ('residual_post_step', float(res_h[niter, p])),
                ('dt', dt),
                ('restart', 0),  # restarts are ineligible here; LogRestarts parity
            ):
                hooks0.add_to_stats(
                    process=p, time=t_p, level=0, iter=niter, sweep=final_sweep,
                    type=typ, value=val,
                )

    device = u0.device
    n_steps = int(np.ceil((Tend - t0 - slack) / dt))
    n_full = n_steps // P
    # the inputs on the device, made once a run: no copy from the host inside the march
    dts = torch.full((ctrl.nlevels,), dt, dtype=torch.float64, device=device)
    slots = torch.arange(P, device=device)
    if n_steps > 0:  # capture (on the card) before the march, which may not synchronize
        ctrl._fused_fn._program(*ctrl._fused_fn._inputs(u0, t0 + dt * slots.to(torch.float64), slots < P, dts))

    uend = u0
    t = t0
    marched = []  # (block start, iters, res_hist, cont, active steps), the middle three on the device
    with trace.enqueue(), _no_sync(device):
        if n_full > 0:
            starts = t0 + dt * P * torch.arange(n_full, dtype=torch.float64, device=device)
            uend, iters_all, res_all, cont_all = ctrl._fused_many_fn(uend, dt, starts, dts)
            marched += [(t0 + b * P * dt, iters_all[b], res_all[b], cont_all[b], P) for b in range(n_full)]
            t = t0 + n_full * P * dt

        while t < Tend - slack:  # partial tail block (prefix window)
            n_active = min(P, int(np.ceil((Tend - t - slack) / dt)))
            uend_block, iters, res_hist, _, cont = ctrl._fused_fn(uend, t + dt * slots.to(torch.float64), dts,
                                                                  slots < n_active)
            marched.append((t, iters, res_hist, cont, n_active))
            uend = uend_block[n_active - 1]
            t += n_active * dt

    if marched:  # the one fetch of the march: counts, histories and cap flags (and the stamps) in one transfer
        with trace.span('march.fetch'):
            ctrl.host_reads['fetch'] += 1
            iters = torch.stack([b[1] for b in marched])
            res = torch.stack([b[2] for b in marched])
            cont = torch.stack([b[3] for b in marched])
            iters_h, res_h, cont_h, *stamps = _fetch([iters, res, cont] + trace.fetch_parts())
            trace.fetched(stamps)
        if cont_h.any():
            raise ControllerError('fused block did not terminate within maxiter + 1 checks')
        with trace.span('march.stats'):
            for (t_block, _, _, _, n_active), it_b, res_b in zip(marched, iters_h.astype(np.int64), res_h):
                emit_stats(t_block, it_b, res_b, n_active)

    ctrl._fused_converged = converged
    return uend, ctrl.return_stats()


def advance_fused_adaptive(ctrl, block):
    """One whole-block device call replacing the entire stage machine.

    Runs the fixed-depth adaptive block program, then replays the hook
    points and the genuine IT_CHECK policy sequence on the shadow steps from
    the fetched histories — adaptivity's dt proposal, limiter clamping,
    restart cascading and stats entries all run through the SAME policy
    objects as the stage machine (``nonmpi.py _route_after_check``).
    Returns True (the block is complete) for the inherited ``run`` loop.
    """
    from pysdc_tpu_torch.convergence.estimate_embedded_error import EstimateEmbeddedErrorLinearized

    stages = {s.status.stage for s in block}
    if stages != {'SPREAD'}:
        raise ControllerError(f'adaptive fused block must start at SPREAD, got {sorted(stages)}')

    for step in block:
        ctrl._fire('pre_step', step, 0)
        for policy in ctrl._policies():
            policy.post_spread_processing(ctrl, step, MS=block)

    # per-level dts: after adaptive restarts only the finest level carries
    # the new dt; coarser levels keep theirs (reference per-level spreading,
    # spread_step_sizes.py:133-154)
    dts = [ctrl._block_dt(block, l) for l in range(ctrl.nlevels)]
    fine_state, uend_block, res_hist, e_hist, prev_last = ctrl._fused_adaptive_fn(
        block[0].u0, ctrl._block_times(), dts, ctrl._mask_of(block)
    )
    ctrl.blocks[0].state = fine_state
    ctrl.blocks[0].uend = uend_block
    # the ONE fetch of the block: both histories in one transfer
    ctrl.host_reads['fetch'] += 1
    fetched = torch.cat([res_hist.flatten(), e_hist.flatten()]).cpu().numpy().astype(np.float64)
    n = res_hist.numel()
    res_h = fetched[:n].reshape(tuple(res_hist.shape))
    e_h = fetched[n:].reshape(tuple(e_hist.shape))

    maxiter = int(ctrl.MS[0].params.maxiter)
    nsw = ctrl.nsweeps[0]
    eps = np.finfo(float).eps

    # the linearized flavor displays the chain-differenced estimate
    # |raw_j - raw_{j-1}| per check (estimate_embedded_error.py); raws come
    # straight from the device history, the differencing is host arithmetic
    linearized = next(
        (C for C in ctrl.convergence_controllers if type(C) is EstimateEmbeddedErrorLinearized), None
    )

    def displayed_estimates(k):
        raws = e_h[k]
        if linearized is None:
            return raws
        out = np.empty_like(raws)
        prev = 0.0
        for j in range(len(raws)):
            scale = (j + 1) if linearized.params.averaged else 1.0
            out[j] = abs(raws[j] - prev) / scale
            if not linearized.params.averaged:
                prev = raws[j]
        return out

    def set_check_status(step, k):
        j = step.status.slot
        step.status.iter = k
        L = step.levels[0]
        L.status.sweep = nsw
        if 'IT_CHECK' in L.sweep.skip_residual_computation:
            # sweepers that skip residuals; mirror _set_residuals
            if L.status.residual is None:
                L.status.residual = 0.0
        else:
            L.status.residual = float(res_h[k, j])
            L.status.updated = False

    # replay iterations 1..maxiter-1 (hook entries only; no policy acts
    # before the final iteration in this stack).  The embedded-error status
    # is updated AFTER firing post_iteration — the stage machine's hook
    # logs the previous check's estimate because the estimator policy runs
    # after the hook (nonmpi.py _route_after_check ordering).
    for k in range(1, maxiter):
        shown = displayed_estimates(k)
        for step in block:
            set_check_status(step, k)
            ctrl._fire('pre_iteration', step, 0)
            ctrl._fire('post_iteration', step, 0)
            L = step.levels[0]
            L.status.error_embedded_estimate = max(float(shown[step.status.slot]), eps)
            L.status.increment = L.status.error_embedded_estimate

    # final IT_CHECK through the genuine hook + policy sequence: the shadow
    # levels get live state views plus an uold whose last node is the
    # device-tracked pre-final-iteration snapshot, so EstimateEmbeddedError
    # itself computes the estimate Adaptivity acts on (one norm read per step)
    ctrl._sync_level(block, 0)
    for step in block:
        set_check_status(step, maxiter)
        L = step.levels[0]
        L.uold = torch.cat([L.state.u[:-1], prev_last[step.status.slot].unsqueeze(0)])
        if maxiter == 1 and getattr(L.sweep, 'is_embedded', None) and L.sweep.is_embedded():
            # check-#0 parity for direct embedded (RK) sweepers: the estimator also runs at iter=0 there, and
            # from the spread predictor both weight rows contract identical f's, so the raw gap is exactly
            # zero -> the eps floor the stage machine stores (the hook of the final check logs it)
            L.status.error_embedded_estimate = eps
            L.status.increment = eps
    ctrl.host_reads['estimate'] += len(block)
    ctrl._route_after_check(block)
    if not all(s.status.done for s in block):
        raise ControllerError('adaptive fused block did not complete at maxiter')
    return True


def run_fused_adaptive(ctrl, u0, t0, Tend):
    """Device-resident run loop for adaptive configurations.

    Reuses the inherited loop over blocks (``ControllerNonMPI.run``: restart
    cuts, window bookkeeping, prepare_next_block ordering, Tend landing)
    verbatim; only the inner stage machine is replaced by
    :func:`advance_fused_adaptive` via the ``_fused_adaptive`` mode flag.
    One device program + one fetch per block instead of per-sweep syncs; on
    the card the program's three graphs are captured once and serve every
    step size the march takes.
    """
    from pysdc_tpu_torch.parallel.nonmpi import ControllerNonMPI

    check_fused_adaptive_eligibility(ctrl)
    if getattr(ctrl, '_fused_adaptive_fn', None) is None:
        ctrl._fused_adaptive_fn = build_fused_adaptive_block(ctrl)
    ctrl.host_reads = {'cont': 0, 'fetch': 0, 'estimate': 0}
    ctrl._fused_adaptive = True
    try:
        uend, stats = ControllerNonMPI.run(ctrl, u0, t0, Tend)
    finally:
        ctrl._fused_adaptive = False
    # uend is a view of the program's buffers, which the next run overwrites
    return uend.clone(), stats
