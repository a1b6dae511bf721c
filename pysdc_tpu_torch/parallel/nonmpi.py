"""Virtual-parallel PFASST/MLSDC/SDC/MSSDC controller.

The counterpart of ``pysdc_tpu/parallel/nonmpi.py``: the whole stage machine,
for single-level steps (SDC, multi-step SDC) and level hierarchies (MLSDC,
PFASST) with any ``num_procs``.

Host-side orchestration of a *block* of ``num_procs`` virtual time steps that
march in lockstep through the PFASST stage machine

    SPREAD -> [PREDICT] -> IT_CHECK -> {IT_FINE | IT_DOWN -> IT_COARSE ->
    IT_UP} -> IT_CHECK -> ... -> DONE

"Communication" between neighbouring steps is a stamped handoff of ``uend``
into the successor's ``u[0]``.  Behaviorally equivalent to the reference's
single-process controller (``controller_nonMPI.py:12-689``) — it serves as
the iteration-count oracle for the sharded device-mesh controller, the same
invariant the reference pins in ``tests/test_tutorials/test_step_6.py:26-42``.
All numerics (sweeps, residuals, transfers) run in the levels on the
device; nothing numerical happens in this file.

Beyond the reference: the FMG predictor is actually implemented here (the
reference leaves it as a commented sketch + NotImplementedError,
``controller_nonMPI.py:463-477``).
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np

from pysdc_tpu_torch.convergence.basic_restarting import BasicRestarting
from pysdc_tpu_torch.core.errors import CommunicationError, ControllerError
from pysdc_tpu_torch.core.step import Step
from pysdc_tpu_torch.parallel.controller import Controller


def _horizon_slack(Tend):
    """Tolerance for "t has reached Tend".

    Absolute 10*eps (as the reference uses) is overtaken by accumulated
    dt-rounding drift after a few dozen steps; blending in a relative term
    keeps drift from scheduling a phantom extra step while staying orders of
    magnitude below any usable dt.
    """
    return max(10 * np.finfo(float).eps, 1e-12 * abs(Tend))


class ControllerNonMPI(Controller):
    """Block-synchronous virtual time-parallel controller."""

    def __init__(self, num_procs: int, controller_params: dict, description: dict):
        if 'predict' in controller_params:
            raise ControllerError("the boolean 'predict' option was retired; select a predict_type")
        super().__init__(controller_params, description, useMPI=False)

        self.MS = [Step(description) for _ in range(num_procs)]

        self.base_convergence_controllers = self.base_convergence_controllers + [BasicRestarting]
        self.add_convergence_controller(BasicRestarting, description)

        if self.params.dump_setup:
            self.dump_setup(self.MS[0], controller_params, description)

        self._validate_block(num_procs)

        for policy in self.ordered_convergence_controllers():
            policy.reset_buffers_nonMPI(self)
            policy.setup_status_variables(self, MS=self.MS)

    def _validate_block(self, num_procs):
        depth = len(self.MS[0].levels)
        if depth == 0:
            raise ControllerError('a step needs at least one level')
        self.nlevels = depth
        self.nsweeps = [lvl.params.nsweeps for lvl in self.MS[0].levels]

        if num_procs > 1 and depth > 1:
            bad = any(
                not lvl.sweep.coll.right_is_node for step in self.MS for lvl in step.levels
            )
            if bad:
                raise ControllerError(
                    'PFASST requires collocation rules whose final node sits at the '
                    'right interval end (uend == u_M)'
                )
        if depth > 1 and self.nsweeps[-1] > 1:
            raise ControllerError('multiple coarsest-level sweeps are not supported here')

    # -- small orchestration helpers -------------------------------------
    def all_steps(self):
        return self.MS

    def _fire(self, point, step, lvl, **kw):
        """Broadcast one hook point to every registered hook."""
        for hook in self.hooks:
            getattr(hook, point)(step=step, level_number=lvl, **kw)

    def _policies(self):
        return self.ordered_convergence_controllers()

    @contextmanager
    def _comm_scope(self, step, lvl, record=False):
        """Bracket a virtual exchange with pre/post comm hooks."""
        self._fire('pre_comm', step, lvl)
        yield
        self._fire('post_comm', step, lvl, add_to_stats=record)

    # -- virtual point-to-point ------------------------------------------
    def _push_boundary(self, step, lvl, record=False):
        """Finalize uend on ``lvl`` and stamp it for the successor.

        Behavioral twin of the reference's one-sided send
        (controller_nonMPI.py:226-257).
        """
        with self._comm_scope(step, lvl, record):
            if not step.status.last:
                out = step.levels[lvl]
                out.compute_end_point()
                out.tag = (lvl, step.status.iter, step.status.slot)

    def _pull_boundary(self, step, lvl, record=False):
        """Adopt the predecessor's uend as u[0], re-evaluating f[0].

        Stamp mismatches indicate a stage-machine bug and raise
        (reference controller_nonMPI.py:259-295).
        """
        with self._comm_scope(step, lvl, record):
            if step.status.first or step.status.prev_done:
                return
            upstream = step.prev.levels[lvl]
            want = (lvl, step.status.iter, step.prev.status.slot)
            if upstream.tag != want:
                raise CommunicationError(
                    f'stale boundary stamp: found {upstream.tag}, expected {want}'
                )
            step.levels[lvl].set_u0(upstream.uend)

    # -- block lifecycle ---------------------------------------------------
    def run(self, u0, t0, Tend):
        """March blocks of steps from t0 to Tend; returns (uend, stats)."""
        for hook in self.hooks:
            hook.reset_stats()

        nsteps = len(self.MS)
        slack = _horizon_slack(Tend)
        starts = np.cumsum([t0] + [s.dt for s in self.MS[:-1]]).tolist()
        window = [p for p in range(nsteps) if starts[p] < Tend - slack]
        if not window:
            raise ControllerError('empty schedule — verify t0, dt and Tend')

        self._seed_block(window, starts, u0)

        self._fire('post_setup', None, None)
        for step in self.MS:
            self._fire('pre_run', step, 0)

        uend = None
        while window:
            block = [self.MS[p] for p in window]
            while not self._advance(block):
                pass

            flagged = [s.status.restart for s in block]
            cut = flagged.index(True) if any(flagged) else len(block)
            if cut < len(block):
                uend = self.MS[cut].levels[0].u[0]
                starts[window[0]] = starts[cut]
                self.logger.info(f'Block restart: resuming from the state of step {cut}')
            else:
                tail = self.MS[window[-1]]
                uend = tail.levels[0].uend
                starts[window[0]] = starts[window[-1]] + tail.dt

            for step in block[:cut]:
                for policy in self._policies():
                    policy.post_step_processing(self, step, MS=block)

            for policy in self._policies():
                for step in self.MS:
                    policy.prepare_next_block(self, step, len(window), starts, Tend, MS=block)

            for i in range(1, len(window)):
                starts[window[i]] = starts[window[i] - 1] + self.MS[window[i] - 1].dt

            window = [p for p in range(nsteps) if starts[p] < Tend - slack]
            self._seed_block(window, starts, uend)

        for step in self.MS:
            self._fire('post_run', step, 0)
        for step in self.MS:
            for policy in self._policies():
                policy.post_run_processing(self, step, MS=block)

        return uend, self.return_stats()

    def _seed_block(self, window, starts, u0):
        """(Re)initialize the active steps for the next block of work."""
        for j, p in enumerate(window):
            step = self.MS[p]
            step.status.slot = p
            step.prev = self.MS[window[j - 1]]
            step.reset_step()
            step.status.first = j == 0
            step.status.last = j == len(window) - 1
            step.init_step(u0)
            step.status.done = False
            step.status.prev_done = False
            step.status.iter = 0
            step.status.stage = 'SPREAD'
            step.status.force_done = False
            step.status.time_size = len(window)
            for lvl in step.levels:
                lvl.tag = None
                lvl.status.sweep = 1
                lvl.status.time = starts[p]

        for policy in self._policies():
            policy.reset_status_variables(self, active_slots=window)

    # -- stage machine ------------------------------------------------------
    def _advance(self, block):
        """Run one lockstep stage over the block; True once every step is done."""
        pending = [s for s in block if s.status.stage != 'DONE']
        labels = {s.status.stage for s in pending}
        if len(labels) > 1:
            raise ControllerError(f'block lost lockstep, stages diverged: {sorted(labels)}')

        if pending:
            handlers = {
                'SPREAD': self._spread,
                'PREDICT': self._predict,
                'IT_CHECK': self._check,
                'IT_FINE': self._fine_sweeps,
                'IT_DOWN': self._restrict_cascade,
                'IT_COARSE': self._coarse_chain,
                'IT_UP': self._prolong_cascade,
            }
            label = labels.pop()
            handler = handlers.get(label)
            if handler is None:
                raise ControllerError(f'stage machine has no handler for {label!r}')
            handler(pending)

        return all(s.status.done for s in block)

    def _sweep_once(self, step, lvl, stage):
        """One preconditioned sweep + residual, bracketed by sweep hooks."""
        self._fire('pre_sweep', step, lvl)
        step.levels[lvl].update_nodes()
        step.levels[lvl].compute_residual(stage=stage)
        self._fire('post_sweep', step, lvl)

    def _spread(self, running):
        for step in running:
            self._fire('pre_step', step, 0)
            step.levels[0].predict(step.u0)
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
            for step in running:
                step.levels[0].update_nodes()
        elif kind == 'pfasst_burnin':
            self._burnin(running)
        elif kind == 'fmg':
            self._full_multigrid(running)
        else:
            raise ControllerError(f'unrecognized predict_type {kind!r}')

        for step in running:
            self._fire('post_predict', step, 0)
            step.status.stage = 'IT_CHECK'

    def _burnin(self, running):
        """PFASST burn-in: staggered coarse sweeps building up the pipeline."""
        coarse = self.nlevels - 1
        for step in running:
            for l in range(1, self.nlevels):
                step.transfer(source=step.levels[l - 1], target=step.levels[l])

        # Wavefront: round q sweeps steps q..end on the coarsest level, then
        # steps q+1..end absorb what their predecessor just produced.
        for q in range(len(running)):
            for step in running[q:]:
                step.levels[coarse].update_nodes()
                self._push_boundary(step, coarse)
            for j, step in enumerate(running[q + 1 :], start=q + 1):
                self._pull_boundary(step, coarse, record=(j == len(running) - 1))

        for step in running:
            for l in range(self.nlevels - 1, 0, -1):
                step.transfer(source=step.levels[l], target=step.levels[l - 1])
            self._push_boundary(step, 0)
            self._pull_boundary(step, 0)

        for step in running:
            step.levels[0].update_nodes()

    def _full_multigrid(self, running):
        """FMG predictor: serialized coarse chain, then sweep on every level
        of the way back up.  Implements what the reference only sketches
        (controller_nonMPI.py:380-423, commented out there).
        """
        for step in running:
            for l in range(1, self.nlevels):
                step.transfer(source=step.levels[l - 1], target=step.levels[l])

        coarse = self.nlevels - 1
        for step in running:
            self._pull_boundary(step, coarse)
            step.levels[coarse].update_nodes()
            self._push_boundary(step, coarse)

        for l in range(self.nlevels - 1, 0, -1):
            for step in running:
                step.transfer(source=step.levels[l], target=step.levels[l - 1])
                if l - 1 > 0:
                    step.levels[l - 1].update_nodes()

        for step in running:
            self._push_boundary(step, 0)
            self._pull_boundary(step, 0)
            step.levels[0].update_nodes()

    def _check(self, running):
        """Convergence assessment and routing to the next stage."""
        self._measure_at_check(running)
        self._route_after_check(running)

    def _measure_at_check(self, running):
        """Refresh boundaries and residuals entering IT_CHECK.  (Overridden
        by the sharded controller with batched device work.)"""
        for step in running:
            self._push_boundary(step, 0)
            self._pull_boundary(step, 0)
            step.levels[0].compute_residual(stage='IT_CHECK')

    def _route_after_check(self, running):
        """Hook + convergence-policy sequence of IT_CHECK — shared verbatim
        by the virtual and sharded controllers (the semantics the reference
        runs on both its controllers, controller_MPI.py:403-460)."""
        for step in running:
            if step.status.iter > 0:
                self._fire('post_iteration', step, 0)
            for policy in self._policies():
                policy.post_iteration_processing(self, step, MS=running)
                policy.convergence_control(self, step, MS=running)

        for step in running:
            if not step.status.first:
                with self._comm_scope(step, 0, record=True):
                    step.status.prev_done = step.prev.status.done
                step.status.done = step.status.done and step.status.prev_done

            if self.params.all_to_done:
                with self._comm_scope(step, 0, record=True):
                    step.status.done = all(s.status.done for s in running)

            if step.status.done:
                step.levels[0].compute_end_point()
                self._fire('post_step', step, 0)
                step.status.stage = 'DONE'
                continue

            step.status.iter += 1
            self._fire('pre_iteration', step, 0)
            for policy in self._policies():
                policy.pre_iteration_processing(self, step, MS=running)

            if len(step.levels) > 1:
                step.status.stage = 'IT_DOWN'
            elif len(running) == 1 or self.params.mssdc_jac:
                step.status.stage = 'IT_FINE'
            else:
                # single-level multi-step SDC, Gauss-Seidel flavor
                step.status.stage = 'IT_COARSE'

        for policy in self._policies():
            policy.reset_buffers_nonMPI(self)

    def _fine_sweeps(self, running):
        for step in running:
            step.levels[0].status.sweep = 0

        final = self.nsweeps[0] - 1
        for k in range(self.nsweeps[0]):
            for step in running:
                step.levels[0].status.sweep += 1
            for step in running:
                self._push_boundary(step, 0)
                self._pull_boundary(step, 0, record=(k == final))
            for step in running:
                self._sweep_once(step, 0, 'IT_FINE')

        for step in running:
            step.status.stage = 'IT_CHECK'

    def _restrict_cascade(self, running):
        """Walk down the hierarchy, sweeping on each intermediate level."""
        for step in running:
            step.transfer(source=step.levels[0], target=step.levels[1])

        for l in range(1, self.nlevels - 1):
            for _ in range(self.nsweeps[l]):
                for step in running:
                    self._push_boundary(step, l)
                    self._pull_boundary(step, l)
                for step in running:
                    self._sweep_once(step, l, 'IT_DOWN')
            for step in running:
                step.transfer(source=step.levels[l], target=step.levels[l + 1])

        for step in running:
            step.status.stage = 'IT_COARSE'

    def _coarse_chain(self, running):
        """Serialized coarsest-level solve: pull, sweep, hand forward."""
        coarse = self.nlevels - 1
        for step in running:
            self._pull_boundary(step, coarse)
            self._sweep_once(step, coarse, 'IT_COARSE')
            self._push_boundary(step, coarse, record=True)
            step.status.stage = 'IT_UP' if self.nlevels > 1 else 'IT_CHECK'

    def _prolong_cascade(self, running):
        """Walk back up, correcting and sweeping on each intermediate level."""
        for l in range(self.nlevels - 1, 0, -1):
            for step in running:
                step.transfer(source=step.levels[l], target=step.levels[l - 1])

            if l - 1 > 0:
                final = self.nsweeps[l - 1] - 1
                for k in range(self.nsweeps[l - 1]):
                    for step in running:
                        self._push_boundary(step, l - 1)
                        self._pull_boundary(step, l - 1, record=(k == final))
                    for step in running:
                        self._sweep_once(step, l - 1, 'IT_UP')

        for step in running:
            step.status.stage = 'IT_FINE'
