"""Sweeper base: SDC sweeps as eager functions on tensors.

The counterpart of ``pysdc_tpu/core/sweeper.py`` (reference
``pySDC/core/sweeper.py:33`` and its plugin protocol ``predict /
update_nodes / integrate / compute_residual / compute_end_point``,
sweeper.py:125-233).  All node data lives in one
:class:`~pysdc_tpu_torch.core.state.LevelState` with a leading node axis;
integrals are small dense contractions along that axis (``torch.tensordot``),
in full precision under :mod:`pysdc_tpu_torch.core.precision`.  The coefficient tables are copied
to the field's device once per dtype and kept.

A block of P time steps is the same state with a time axis right behind the
node axis, ``(M+1, P, *shape)``, and ``t`` a ``(P,)`` float64 tensor on the
fields' device (the counterpart of ``jax.vmap`` over the steps, written out as
a batch axis).  Every protocol function takes either form: the node
contractions run over axis 0 and the problems' solves and applies over the
trailing space axes, so the time axis rides along.  Only the residual norm has
to be told (``time_axis=True``: one norm per step).
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.device import cached_tensor
from pysdc_tpu_torch.core.errors import ParameterError
from pysdc_tpu_torch.core.state import LevelState, f_total, map_components, norm_max
from pysdc_tpu_torch.ops.collocation import get_collocation
from pysdc_tpu_torch.ops.qdelta import is_diagonal, is_k_dependent, qdelta_explicit, qdelta_implicit

RESIDUAL_TYPES = ('full_abs', 'last_abs', 'full_rel', 'last_rel')


class Sweeper:
    """Base sweeper: collocation tables + predictor + residual machinery."""

    #: set True by subclasses whose update_nodes decouples across nodes
    parallelizable = False

    #: why the fused lanes' CUDA graphs cannot hold this sweeper's sweeps (a
    #: host read inside a sweep, host state across steps), or None where they can
    graph_capture_blocker = None

    def __init__(self, params: dict):
        if 'num_nodes' not in params:
            raise ParameterError(f"need 'num_nodes' to instantiate sweeper, only got {list(params)}")
        self.params = dict(params)
        self.coll = get_collocation(
            params['num_nodes'],
            params.get('node_type', 'LEGENDRE'),
            params.get('quad_type', 'RADAU-RIGHT'),
        )
        self.initial_guess = params.get('initial_guess', 'spread')
        if self.initial_guess not in ('spread', 'copy', 'zero', 'random'):
            raise ParameterError(f'initial_guess option {self.initial_guess} not implemented')
        self.random_seed = params.get('random_seed', 1984)
        self._rng = np.random.RandomState(self.random_seed)
        self.skip_residual_computation = tuple(params.get('skip_residual_computation', ()))

        self.do_coll_update = params.get('do_coll_update', False)
        if not self.coll.right_is_node and not self.do_coll_update:
            # same auto-correction as reference sweeper.py:87-90
            self.do_coll_update = True
        self._consts: dict = {}

    # -- coefficient helpers -------------------------------------------
    def get_Qdelta_implicit(self, qd_type: str, k: int | None = None) -> np.ndarray:
        QD = qdelta_implicit(self.coll, qd_type, k=k)
        if is_diagonal(QD):
            self.parallelizable = True
        return QD

    def get_Qdelta_explicit(self, qd_type: str, k: int | None = None) -> np.ndarray:
        QD = qdelta_explicit(self.coll, qd_type, k=k)
        if is_diagonal(QD):
            self.parallelizable = True
        return QD

    @property
    def k_dependent(self) -> bool:
        """True if any preconditioner coefficients change between sweeps."""
        return any(is_k_dependent(self.params.get(name, '')) for name in ('QI', 'QE'))

    def node_times(self, t, dt):
        """Times of the M nodes: a numpy ``(M,)`` for a host ``t`` and ``dt``;
        where either is a tensor (one step's 0-d time or a block's ``(P,)``,
        a 0-d ``dt`` on the device) a float64 tensor ``(M, *t.shape)`` on its
        device, so that no host number is frozen into a captured CUDA graph."""
        if isinstance(dt, torch.Tensor) and not isinstance(t, torch.Tensor):
            t = torch.as_tensor(t, dtype=torch.float64, device=dt.device)
        if isinstance(t, torch.Tensor):
            nodes = self._coeff('nodes', lambda: self.coll.nodes, t)
            return t.unsqueeze(0) + dt * nodes.reshape((-1,) + (1,) * t.dim())
        return t + dt * self.coll.nodes

    def scaled_table(self, dt, QD: np.ndarray, key):
        """``dt * QD`` as a table to take entries from with :meth:`entry` (and,
        for a batched solve, the per-node shifts ``.diagonal()[1:]``): numpy
        for a host ``dt``; for a 0-d ``dt`` on the device one float64 tensor
        there, the product of ``dt`` with a constant table (one small product
        a sweep, its entries are views): the graphs of the fused lanes read
        ``dt``, they do not hold it."""
        if isinstance(dt, torch.Tensor):
            return dt * self._coeff(('table', key), lambda: QD, dt)
        return dt * np.asarray(QD)

    @staticmethod
    def entry(table, i: int, j: int):
        """Entry ``(i, j)`` of a :meth:`scaled_table`: a host float, or a 0-d tensor."""
        return table[i, j] if isinstance(table, torch.Tensor) else float(table[i, j])

    @staticmethod
    def node_time(ts, m: int):
        """Entry ``m`` of :meth:`node_times`: a host float, or a tensor slice."""
        return ts[m] if isinstance(ts, torch.Tensor) else float(ts[m])

    def _coeff(self, key, make, like: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        """The coefficient table ``make()`` on ``like``'s device, in ``dtype``
        (default: ``like``'s), made once per (key, dtype, device) and kept."""
        return cached_tensor(self._consts, key, make, like, dtype)

    # -- protocol ------------------------------------------------------
    def predict(self, prob, u0, t, dt, random_val: float = 0.0) -> LevelState:
        """Initial guess at the collocation nodes (reference sweeper.py:125).

        ``random_val`` carries the host-generated random fill value for the
        'random' initial guess."""
        M = self.coll.num_nodes
        f0 = prob.eval_f(u0, t)
        if self.initial_guess in ('spread', 'copy'):
            u = u0.unsqueeze(0).repeat((M + 1,) + (1,) * u0.dim())
        else:
            fill = 0.0 if self.initial_guess == 'zero' else random_val
            u = torch.full((M + 1,) + tuple(u0.shape), fill, dtype=u0.dtype, device=u0.device)
            u[0] = u0
        if self.initial_guess == 'spread':
            f_nodes = prob.eval_f_batched(u[1:], self.node_times(t, dt))
            f = map_components(lambda l0, ln: torch.cat([l0.unsqueeze(0), ln]), f0, f_nodes)
        elif self.initial_guess == 'copy':
            f = map_components(lambda l0: l0.unsqueeze(0).repeat((M + 1,) + (1,) * l0.dim()), f0)
        else:
            fill = 0.0 if self.initial_guess == 'zero' else random_val

            def filled(l0):
                out = torch.full((M + 1,) + tuple(l0.shape), fill, dtype=l0.dtype, device=l0.device)
                out[0] = l0
                return out

            f = map_components(filled, f0)
        tau = torch.zeros((M,) + tuple(u0.shape), dtype=u0.dtype, device=u0.device)
        return LevelState(u=u, f=f, tau=tau)

    def draw_random_val(self) -> float:
        return float(self._rng.rand(1)[0])

    def update_nodes_k(self, prob, state: LevelState, t, dt, n_sweeps: int, k0: int = 0) -> LevelState:
        """``n_sweeps`` consecutive sweeps, each one ``update_nodes`` (on 2D
        periodic grids through the stencil kernel).  The same sweeps in a
        linear operator's diagonal basis are ``ops.diag_sdc.diagonal_sweeps``,
        which the caller picks by name: eager on an H100 it is slower than this
        loop (PERF.md), so no sweeper dispatches to it (the block controller's
        coarse chain does, under the fused lane's CUDA graphs)."""
        for k in range(k0, k0 + n_sweeps):
            state = self.update_nodes(prob, state, t, dt, k)
        return state

    def integrate(self, state: LevelState, dt) -> torch.Tensor:
        """dt * Q @ f over the node axis -> (M, *shape)
        (reference generic_implicit.py:29-48)."""
        ft = f_total(state.f)[1:]
        return dt * torch.tensordot(self._coeff('q', lambda: self.coll.q, ft), ft, dims=1)

    def compute_residual(self, state: LevelState, dt, residual_type: str = 'full_abs', t=0.0,
                         time_axis: bool = False):
        """Collocation residual and its norm (reference sweeper.py:164-222).

        Returns ``(residual_nodes, norm)`` with residual_nodes (M, *shape)
        and norm a 0-d tensor on the field's device (read it with ``.item()``).
        With ``time_axis=True`` the state is a block ``(M+1, P, *shape)`` and
        ``norm`` has one entry per step, shape ``(P,)``.
        """
        res = self.integrate(state, dt) + state.tau + state.u[0].unsqueeze(0) - state.u[1:]
        lead = 2 if time_axis else 1  # axes in front of the space axes: nodes[, steps]
        node_norms = res.abs().flatten(lead).amax(dim=-1) if res.dim() > lead else res.abs()
        if residual_type.endswith('_rel'):
            u0 = state.u[0]
            u0_norm = (u0.abs().flatten(1).amax(dim=-1) if u0.dim() > 1 else u0.abs()) if time_axis else norm_max(u0)
        if residual_type == 'full_abs':
            norm = node_norms.amax(dim=0)
        elif residual_type == 'last_abs':
            norm = node_norms[-1]
        elif residual_type == 'full_rel':
            norm = node_norms.amax(dim=0) / u0_norm
        elif residual_type == 'last_rel':
            norm = node_norms[-1] / u0_norm
        else:
            raise ParameterError(
                f'residual_type = {residual_type} not implemented, choose full_abs, last_abs, full_rel or last_rel'
            )
        return res, norm

    def compute_end_point(self, state: LevelState, t, dt):
        """u at the right interval end (reference generic_implicit.py:105-131)."""
        if self.coll.right_is_node and not self.do_coll_update:
            return state.u[-1]
        ft = f_total(state.f)[1:]
        w = self._coeff('weights', lambda: self.coll.weights, ft)
        return state.u[0] + dt * torch.tensordot(w, ft, dims=1) + state.tau[-1]

    def update_nodes(self, prob, state: LevelState, t, dt, k: int = 0) -> LevelState:
        raise NotImplementedError('sweeper has to implement update_nodes')
