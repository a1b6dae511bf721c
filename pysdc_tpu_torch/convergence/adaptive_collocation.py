"""Switch the collocation rule between iterations within one step.

The counterpart of ``pysdc_tpu/convergence/adaptive_collocation.py``;
counterpart of the reference ``AdaptiveCollocation``
(``implementations/convergence_controller_classes/adaptive_collocation.py:7-245``):
a list of collocation configurations is solved in sequence — whenever the
current collocation problem reaches ``restol``, the solution is interpolated
onto the next rule's nodes (barycentric Lagrange, a small node-axis
contraction), the right-hand side is re-evaluated, and iteration continues.
The step ends once the last configuration converges.

Every configuration's sweeper is built once and kept, and switching installs
it on the level.  Nothing keyed on the node count outlives a switch: each
sweeper holds its own coefficient tables (``Sweeper.scaled_table``, its
``cached_tensor`` cache), the level's ``(M+1, *shape)`` state is rebuilt at the
new M, the heat problem's batched solve takes its shifts from the table it is
handed, the stencil's launch plans are keyed by shape, and a problem that
prepared per-node factorizations (``prepare_node_solvers``) prepares them
again for the new nodes.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.convergence import ConvergenceController
from pysdc_tpu_torch.core.errors import ParameterError
from pysdc_tpu_torch.core.problem import count_work
from pysdc_tpu_torch.core.state import LevelState, map_components
from pysdc_tpu_torch.ops.lagrange import interpolation_matrix

_ALLOWED_SWEEPER_KEYS = ('quad_type', 'num_nodes', 'node_type', 'do_coll_update')
_ALLOWED_LEVEL_KEYS = ('restol',)


class AdaptiveCollocation(ConvergenceController):
    def setup(self, controller, params, description, **kwargs):
        defaults = {
            'control_order': 300,
            **super().setup(controller, params, description, **kwargs),
        }
        self.vary_keys_sweeper = []
        self.vary_keys_level = []
        self.num_colls = 0
        for key, val in params.items():
            if isinstance(val, list):
                if key in _ALLOWED_SWEEPER_KEYS:
                    self.vary_keys_sweeper.append(key)
                elif key in _ALLOWED_LEVEL_KEYS:
                    self.vary_keys_level.append(key)
                else:
                    raise ParameterError(f"Don't know what to do with key {key} here!")
                self.num_colls = max(self.num_colls, len(val))
        self.sweeper_params = dict(description['sweeper_params'])
        self.sweeper_class = description['sweeper_class']
        if description['level_params'].get('restol', -1.0) <= 1e-16:
            raise ParameterError(
                'Switching collocation problems requires an attainable restol in the level params'
            )
        self._variants = None  # lazily built per level: list of dicts
        self.active_coll = 0
        return defaults

    # -- variant cache --------------------------------------------------
    def _build_variants(self, S):
        self._variants = []
        for _ in S.levels:
            variants = []
            for i in range(self.num_colls):
                sp = dict(self.sweeper_params)
                for key in self.vary_keys_sweeper:
                    sp[key] = self.params.get(key)[i]
                lp = {key: self.params.get(key)[i] for key in self.vary_keys_level}
                variants.append(dict(sweep=self.sweeper_class(sp), level_overrides=lp))
            self._variants.append(variants)

    def _activate(self, S, idx, interpolate):
        for lvl, variants in zip(S.levels, self._variants):
            var = variants[idx]
            old_nodes = np.append(0, lvl.sweep.coll.nodes)
            old_state = lvl.state

            lvl.sweep = var['sweep']
            var['sweep'].level = lvl
            for key, val in var['level_overrides'].items():
                setattr(lvl.params, key, val)
            QI = getattr(lvl.sweep, 'QI', None)
            if lvl.prob.accepts_node_index and QI is not None:
                lvl.prob.prepare_node_solvers(float(lvl.params.dt), np.diag(np.asarray(QI))[1:])

            if interpolate and old_state is not None:
                new_nodes = np.append(0, lvl.sweep.coll.nodes)
                I = interpolation_matrix(old_nodes, new_nodes)
                u_new = map_components(
                    lambda leaf: torch.tensordot(torch.as_tensor(I, dtype=leaf.dtype, device=leaf.device), leaf,
                                                 dims=([1], [0])),
                    old_state.u,
                )
                # re-evaluate the rhs at the interpolated values (reference
                # adaptive_collocation.py:163-166 uses the step time)
                t = lvl.status.time
                M_new = lvl.sweep.coll.num_nodes
                f_new = lvl.prob.eval_f_batched(u_new, np.full(M_new + 1, float(t)))
                count_work(lvl.prob, 'rhs', M_new + 1)
                tau_new = map_components(lambda leaf: torch.zeros_like(leaf[1:]), u_new)
                lvl.state = LevelState(u=u_new, f=f_new, tau=tau_new)
                lvl.status.unlocked = True
                lvl.status.updated = True

    # -- controller hooks ------------------------------------------------
    def reset_status_variables(self, controller, **kwargs):
        self.active_coll = 0

    def post_spread_processing(self, controller, S, **kwargs):
        self.active_coll = 0
        if self._variants is None:
            self._build_variants(S)
        # re-predict (only levels that hold state, i.e. the fine level) with
        # the first collocation configuration
        u0s = [map_components(lambda leaf: leaf[0], lvl.state.u) if lvl.state is not None else None
               for lvl in S.levels]
        self._activate(S, 0, interpolate=False)
        for lvl, u0 in zip(S.levels, u0s):
            if u0 is not None:
                lvl.predict(u0)

    def post_iteration_processing(self, controller, S, **kwargs):
        if self.active_coll < self.num_colls - 1 and S.status.done:
            self.active_coll += 1
            S.status.done = False
            self.log(f'Switching to collocation {self.active_coll + 1} of {self.num_colls}', S)
            self._activate(S, self.active_coll, interpolate=True)
