"""Runge-Kutta methods as one-sweep "sweepers".

The counterpart of ``pysdc_tpu/sweepers/runge_kutta.py`` (reference
``RungeKutta`` / ``RungeKuttaIMEX`` family,
``implementations/sweeper_classes/Runge_Kutta.py:10-819``): a lower
triangular Butcher tableau plays the role of the collocation + QDelta pair,
stages are computed by forward substitution in a single sweep, and embedded
pairs expose a secondary (lower-order) end point for adaptivity.

The tableaus are numpy tables on the host, this module's own copies of the
JAX package's (each a standard published method or a construction pinned by
its order conditions; ``tests/test_torch_runge_kutta.py`` holds them equal to
the JAX package's and gates every empirical order).  The stage loop is the
JAX loop: the zero pattern of the coefficients decides which terms exist.
The step-size products ``dt * A[i, j]`` come from :meth:`Sweeper.scaled_table`,
so a step size on the device (the fused lanes' input) is read, not frozen.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.errors import ParameterError
from pysdc_tpu_torch.core.state import LevelState, f_total, map_components
from pysdc_tpu_torch.core.sweeper import Sweeper


class ButcherTableau:
    """Lower-triangular Butcher tableau exposing the slice of the collocation
    interface the framework uses (reference Runge_Kutta.py:10-77)."""

    def __init__(self, weights, nodes, matrix):
        self.check_method(weights, nodes, matrix)
        stages = matrix.shape[0]
        self.tleft, self.tright = 0.0, 1.0
        self.num_nodes = stages
        self.weights = np.asarray(weights, dtype=float)

        # node 0 is the interval start, as in the collocation convention
        self.nodes = np.concatenate(([0.0], np.asarray(nodes, dtype=float)))
        Q = np.zeros((stages + 1, stages + 1))
        Q[1:, 1:] = matrix
        self.Qmat = Q

        self.left_is_node = True
        self.right_is_node = self.nodes[-1] == self.tright
        self.node_type = self.quad_type = 'BUTCHER'

        self.delta_m = np.diff(self.nodes) if stages > 1 else np.array([0.0])
        self.delta_m[0] = self.nodes[1] - self.tleft

        self.implicit = bool(np.diagonal(matrix).any())

    def check_method(self, weights, nodes, matrix):
        if not (isinstance(matrix, np.ndarray) and matrix.ndim == 2 and matrix.shape[0] == matrix.shape[1]):
            raise ParameterError('a Butcher matrix must be a square 2D numpy array')
        if not (isinstance(nodes, np.ndarray) and nodes.ndim == 1 and nodes.size == matrix.shape[0]):
            raise ParameterError(f'a {matrix.shape[0]}-stage tableau needs {matrix.shape[0]} abscissae as a 1D array')
        if np.any(np.triu(matrix, k=1) != 0):
            raise ParameterError('only lower-triangular (DIRK-type) tableaus are supported')
        self.check_weights(weights, nodes, matrix)

    def check_weights(self, weights, nodes, matrix):
        if not (isinstance(weights, np.ndarray) and weights.ndim == 1 and weights.size == matrix.shape[0]):
            raise ParameterError(f'a {matrix.shape[0]}-stage tableau needs {matrix.shape[0]} weights as a 1D array')

    @property
    def q(self):
        return self.Qmat[1:, 1:]

    @property
    def globally_stiffly_accurate(self):
        return np.allclose(self.Qmat[-1, 1:], self.weights)


class ButcherTableauEmbedded(ButcherTableau):
    """weights has two rows: [main, embedded] (reference Runge_Kutta.py:78)."""

    def check_weights(self, weights, nodes, matrix):
        if not (isinstance(weights, np.ndarray) and weights.shape == (2, matrix.shape[0])):
            raise ParameterError(f'an embedded pair needs a (2, {matrix.shape[0]}) weight array')

    @property
    def globally_stiffly_accurate(self):
        return np.allclose(self.Qmat[-1, 1:], self.weights[0])


class RungeKutta(Sweeper):
    """Base RK sweeper; subclasses define nodes/weights/matrix class attrs."""

    nodes: np.ndarray = None
    weights: np.ndarray = None
    matrix: np.ndarray = None
    ButcherTableauClass = ButcherTableau

    #: RK methods are direct solvers: residual/restol logic is bypassed
    is_direct_solver = True

    def __init__(self, params: dict):
        # not Sweeper.__init__: the tableau takes the place of the collocation rule
        params = dict(params)
        self.coll = self.get_Butcher_tableau()
        self.params = params
        self.initial_guess = 'zero'
        self.random_seed = 1984
        self._rng = np.random.RandomState(self.random_seed)
        self.skip_residual_computation = tuple(
            params.get('skip_residual_computation', ('IT_CHECK', 'IT_FINE', 'IT_COARSE', 'IT_UP', 'IT_DOWN'))
        )
        self.do_coll_update = False
        self.parallelizable = False
        self.QI = self.coll.Qmat
        self._consts = {}

    @classmethod
    def get_Butcher_tableau(cls):
        return cls.ButcherTableauClass(cls.weights, cls.nodes, cls.matrix)

    @classmethod
    def get_update_order(cls):
        """Order of the embedded (update) scheme, for AdaptivityRK."""
        raise NotImplementedError(
            f'There is no update order for RK scheme {cls.__name__!r}. Maybe it is not embedded?'
        )

    @classmethod
    def is_embedded(cls):
        return cls.ButcherTableauClass == ButcherTableauEmbedded

    @property
    def k_dependent(self):
        return False

    # -- protocol -------------------------------------------------------
    def predict(self, prob, u0, t, dt, random_val: float = 0.0) -> LevelState:
        """u0 and f(u0) at the interval start, zeros at the stages."""
        M = self.coll.num_nodes
        f0 = prob.eval_f(u0, t)

        def stacked(l0):
            return torch.cat([l0.unsqueeze(0), torch.zeros((M,) + tuple(l0.shape), dtype=l0.dtype, device=l0.device)])

        tau = torch.zeros((M,) + tuple(u0.shape), dtype=u0.dtype, device=u0.device)
        return LevelState(u=stacked(u0), f=map_components(stacked, f0), tau=tau)

    def _stage_rhs_terms(self, m, f_list, dtA):
        """Sum of dt*A[m,j]*f_j for the already-computed stages j <= m."""
        terms = 0.0
        for j in range(1, m + 1):
            if self.QI[m + 1, j] != 0.0:
                terms = terms + self.entry(dtA, m + 1, j) * f_total(f_list[j])
        return terms

    def _solve_stage(self, prob, rhs, dtA, m, u_prev, t_stage):
        """The stage value: the implicit solve where the diagonal entry is not 0, else ``rhs`` itself."""
        if self.QI[m + 1, m + 1] != 0.0:
            return prob.solve_system(rhs, self.entry(dtA, m + 1, m + 1), u_prev, t_stage)
        return rhs

    def update_nodes(self, prob, state: LevelState, t, dt, k: int = 0) -> LevelState:
        M = self.coll.num_nodes
        u_list = list(state.u.unbind(0))
        f_list = [map_components(lambda leaf: leaf[m], state.f) for m in range(M + 1)]
        ts = self.node_times(t, dt)  # the interval start, then the M stage times
        dtA = self.scaled_table(dt, self.QI, 'A')

        for m in range(M):
            rhs = u_list[0] + self._stage_rhs_terms(m, f_list, dtA)
            t_stage = self.node_time(ts, m + 1)
            u_list[m + 1] = self._solve_stage(prob, rhs, dtA, m, u_list[m], t_stage)
            if m < M - 1 or not self.coll.globally_stiffly_accurate or self.is_embedded():
                f_list[m + 1] = prob.eval_f(u_list[m + 1], t_stage)

        f = map_components(lambda *leaves: torch.stack(leaves), *f_list)
        return LevelState(u=torch.stack(u_list), f=f, tau=state.tau)

    def _contract(self, key, w, ft):
        """``w @ ft`` over the stage axis, the weights ``w`` kept on ``ft``'s device."""
        return torch.tensordot(self._coeff(key, lambda: w, ft), ft, dims=1)

    def compute_end_point(self, state: LevelState, t, dt):
        uend, _ = self.compute_end_point_with_secondary(state, t, dt)
        return uend

    def compute_end_point_with_secondary(self, state: LevelState, t, dt):
        """(uend, u_secondary) — secondary is the embedded lower-order result
        (reference Runge_Kutta.py:277-302)."""
        ft = f_total(state.f)[1:]
        u0 = state.u[0]
        w = self.coll.weights
        secondary = None
        if self.coll.globally_stiffly_accurate:
            uend = state.u[-1]
            if self.is_embedded():
                secondary = u0 + dt * self._contract(('weights', 1), w[1], ft)
        elif self.is_embedded():
            uend = u0 + dt * self._contract(('weights', 0), w[0], ft)
            secondary = u0 + dt * self._contract(('weights', 1), w[1], ft)
        else:
            uend = u0 + dt * self._contract('weights', w, ft)
        return uend, secondary


class RungeKuttaIMEX(RungeKutta):
    """IMEX split RK: implicit tableau for f.impl, explicit for f.expl.
    Both parts must share nodes and weights (reference Runge_Kutta.py:346).
    A class without ``weights_explicit`` takes ``weights`` for both parts (the
    JAX package writes that onto the class at construction; here the explicit
    tableau is built from it and the class is left as it is)."""

    matrix_explicit: np.ndarray = None
    weights_explicit: np.ndarray = None

    def __init__(self, params: dict):
        super().__init__(params)
        self.coll_explicit = self.get_Butcher_tableau_explicit()
        self.QE = self.coll_explicit.Qmat

    @classmethod
    def get_Butcher_tableau_explicit(cls):
        weights = cls.weights_explicit if cls.weights_explicit is not None else cls.weights
        return cls.ButcherTableauClass(weights, cls.nodes, cls.matrix_explicit)

    def update_nodes(self, prob, state: LevelState, t, dt, k: int = 0) -> LevelState:
        M = self.coll.num_nodes
        u_list = list(state.u.unbind(0))
        fi_list = list(state.f.impl.unbind(0))
        fe_list = list(state.f.expl.unbind(0))
        ts = self.node_times(t, dt)
        dtA, dtE = self.scaled_table(dt, self.QI, 'A'), self.scaled_table(dt, self.QE, 'A explicit')

        for m in range(M):
            rhs = u_list[0]
            for j in range(1, m + 1):
                if self.QI[m + 1, j] != 0.0:
                    rhs = rhs + self.entry(dtA, m + 1, j) * fi_list[j]
                if self.QE[m + 1, j] != 0.0:
                    rhs = rhs + self.entry(dtE, m + 1, j) * fe_list[j]
            t_stage = self.node_time(ts, m + 1)
            u_list[m + 1] = self._solve_stage(prob, rhs, dtA, m, u_list[m], t_stage)
            fm = prob.eval_f(u_list[m + 1], t_stage)
            fi_list[m + 1], fe_list[m + 1] = fm.impl, fm.expl

        f = type(state.f)(impl=torch.stack(fi_list), expl=torch.stack(fe_list))
        return LevelState(u=torch.stack(u_list), f=f, tau=state.tau)

    def compute_end_point_with_secondary(self, state: LevelState, t, dt):
        fi = state.f.impl[1:]
        fe = state.f.expl[1:]
        u0 = state.u[0]
        wi, we = self.coll.weights, self.coll_explicit.weights
        if self.is_embedded():
            uend = u0 + dt * (self._contract(('weights', 0), wi[0], fi) + self._contract(('explicit', 0), we[0], fe))
            secondary = u0 + dt * (self._contract(('weights', 1), wi[1], fi)
                                   + self._contract(('explicit', 1), we[1], fe))
            return uend, secondary
        uend = u0 + dt * (self._contract('weights', wi, fi) + self._contract('explicit', we, fe))
        return uend, None


# ---------------------------------------------------------------------------
# Named methods (standard published tableaus; orders pinned by tests)
# ---------------------------------------------------------------------------


class ForwardEuler(RungeKutta):
    """Explicit Euler, order 1."""

    nodes = np.array([0.0])
    weights = np.array([1.0])
    matrix = np.array([[0.0]])


class BackwardEuler(RungeKutta):
    """Implicit Euler, order 1, stiffly accurate."""

    nodes = np.array([1.0])
    weights = np.array([1.0])
    matrix = np.array([[1.0]])


class CrankNicolson(RungeKutta):
    """Implicit trapezoidal rule, order 2."""

    nodes = np.array([0.0, 1.0])
    weights = np.array([0.5, 0.5])
    matrix = np.array([[0.0, 0.0], [0.5, 0.5]])


class ExplicitMidpointMethod(RungeKutta):
    """Explicit midpoint, order 2."""

    nodes = np.array([0.0, 0.5])
    weights = np.array([0.0, 1.0])
    matrix = np.array([[0.0, 0.0], [0.5, 0.0]])


class ImplicitMidpointMethod(RungeKutta):
    """Implicit midpoint (Gauss, 1 stage), order 2."""

    nodes = np.array([0.5])
    weights = np.array([1.0])
    matrix = np.array([[0.5]])


class RK4(RungeKutta):
    """The classic explicit fourth-order method."""

    nodes = np.array([0.0, 0.5, 0.5, 1.0])
    weights = np.array([1.0, 2.0, 2.0, 1.0]) / 6.0
    matrix = np.zeros((4, 4))
    matrix[1, 0] = 0.5
    matrix[2, 1] = 0.5
    matrix[3, 2] = 1.0


class Heun_Euler(RungeKutta):
    """Heun's second-order method with embedded Euler (order 2(1))."""

    nodes = np.array([0.0, 1.0])
    weights = np.array([[0.5, 0.5], [1.0, 0.0]])
    matrix = np.zeros((2, 2))
    matrix[1, 0] = 1.0
    ButcherTableauClass = ButcherTableauEmbedded

    @classmethod
    def get_update_order(cls):
        return 2


class Cash_Karp(RungeKutta):
    """Cash-Karp 5(4) embedded explicit pair (Cash & Karp 1990)."""

    nodes = np.array([0, 0.2, 0.3, 0.6, 1.0, 7.0 / 8.0])
    weights = np.array(
        [
            [37.0 / 378.0, 0.0, 250.0 / 621.0, 125.0 / 594.0, 0.0, 512.0 / 1771.0],
            [2825.0 / 27648.0, 0.0, 18575.0 / 48384.0, 13525.0 / 55296.0, 277.0 / 14336.0, 0.25],
        ]
    )
    matrix = np.zeros((6, 6))
    matrix[1, 0] = 1.0 / 5.0
    matrix[2, :2] = [3.0 / 40.0, 9.0 / 40.0]
    matrix[3, :3] = [0.3, -0.9, 1.2]
    matrix[4, :4] = [-11.0 / 54.0, 5.0 / 2.0, -70.0 / 27.0, 35.0 / 27.0]
    matrix[5, :5] = [
        1631.0 / 55296.0,
        175.0 / 512.0,
        575.0 / 13824.0,
        44275.0 / 110592.0,
        253.0 / 4096.0,
    ]
    ButcherTableauClass = ButcherTableauEmbedded

    @classmethod
    def get_update_order(cls):
        return 5


class CrouzeixDIRK4(RungeKutta):
    """Crouzeix's 3-stage DIRK of order 4 (A-stable).

    gamma = (1/sqrt(3)) cos(pi/18) + 1/2; delta = 1/(6 (2 gamma - 1)^2).
    Known as DIRK43 in the reference's naming (Runge_Kutta.py:626).
    """

    _gamma = np.cos(np.pi / 18.0) / np.sqrt(3.0) + 0.5
    _delta = 1.0 / (6.0 * (2.0 * _gamma - 1.0) ** 2)
    nodes = np.array([_gamma, 0.5, 1.0 - _gamma])
    weights = np.array([_delta, 1.0 - 2.0 * _delta, _delta])
    matrix = np.array(
        [
            [_gamma, 0.0, 0.0],
            [0.5 - _gamma, _gamma, 0.0],
            [2.0 * _gamma, 1.0 - 4.0 * _gamma, _gamma],
        ]
    )




class ARK324L2SAESDIRK(RungeKutta):
    """Implicit (ESDIRK) part of Kennedy & Carpenter's ARK3(2)4L[2]SA
    (Appl. Numer. Math. 44, 2003) — order 3, stiffly accurate, embedded 2nd
    order weights."""

    _g = 1767732205903.0 / 4055673282236.0
    nodes = np.array([0.0, 2 * _g, 3.0 / 5.0, 1.0])
    _b = np.array(
        [
            1471266399579.0 / 7840856788654.0,
            -4482444167858.0 / 7529755066697.0,
            11266239266428.0 / 11593286722821.0,
            _g,
        ]
    )
    _bhat = np.array(
        [
            2756255671327.0 / 12835298489170.0,
            -10771552573575.0 / 22201958757719.0,
            9247589265047.0 / 10645013368117.0,
            2193209047091.0 / 5459859503100.0,
        ]
    )
    weights = np.array([_b, _bhat])
    matrix = np.zeros((4, 4))
    matrix[1, :2] = [_g, _g]
    matrix[2, :3] = [2746238789719.0 / 10658868560708.0, -640167445237.0 / 6845629431997.0, _g]
    matrix[3, :] = _b
    ButcherTableauClass = ButcherTableauEmbedded

    @classmethod
    def get_update_order(cls):
        return 3


class ARK324L2SAERK(RungeKutta):
    """Explicit part of Kennedy & Carpenter's ARK3(2)4L[2]SA — order 3."""

    _g = ARK324L2SAESDIRK._g
    nodes = ARK324L2SAESDIRK.nodes
    weights = ARK324L2SAESDIRK.weights
    matrix = np.zeros((4, 4))
    matrix[1, 0] = 2 * _g
    matrix[2, :2] = [5535828885825.0 / 10492691773637.0, 788022342437.0 / 10882634858940.0]
    matrix[3, :3] = [
        6485989280629.0 / 16251701735622.0,
        -4246266847089.0 / 9704473918619.0,
        10755448449292.0 / 10357097424841.0,
    ]
    ButcherTableauClass = ButcherTableauEmbedded

    @classmethod
    def get_update_order(cls):
        return 3


class ARK32(RungeKuttaIMEX):
    """Kennedy & Carpenter ARK3(2)4L[2]SA additive IMEX pair."""

    nodes = ARK324L2SAESDIRK.nodes
    weights = ARK324L2SAESDIRK.weights
    matrix = ARK324L2SAESDIRK.matrix
    matrix_explicit = ARK324L2SAERK.matrix
    ButcherTableauClass = ButcherTableauEmbedded

    @classmethod
    def get_update_order(cls):
        return 3


class IMEXEuler(RungeKuttaIMEX):
    """First-order IMEX Euler: implicit Euler for the stiff part, explicit
    Euler for the rest (reference Runge_Kutta.py:519)."""

    nodes = np.array([0.0, 1.0])
    weights = np.array([0.0, 1.0])
    matrix = np.zeros((2, 2))
    matrix[1, 1] = 1.0
    matrix_explicit = np.zeros((2, 2))
    matrix_explicit[1, 0] = 1.0


class IMEXEulerStifflyAccurate(RungeKuttaIMEX):
    """Stiffly accurate IMEX Euler: u = fI^{-1}(u0 + dt*fE(u0)) — the last
    stage is the solution, suitable for DAE limits
    (reference Runge_Kutta.py:527-540)."""

    nodes = np.array([0.0, 1.0])
    weights = np.array([0.0, 1.0])
    weights_explicit = np.array([1.0, 0.0])
    matrix = np.array([[0.0, 0.0], [0.0, 1.0]])
    matrix_explicit = np.array([[0.0, 0.0], [1.0, 0.0]])


class DIRK43_2(RungeKutta):
    """L-stable DIRK with four stages of order 3 (classic tableau, see the
    Wikipedia list of RK methods; reference Runge_Kutta.py:626-633)."""

    nodes = np.array([0.5, 2.0 / 3.0, 0.5, 1.0])
    weights = np.array([3.0 / 2.0, -3.0 / 2.0, 0.5, 0.5])
    matrix = np.array(
        [
            [0.5, 0.0, 0.0, 0.0],
            [1.0 / 6.0, 0.5, 0.0, 0.0],
            [-0.5, 0.5, 0.5, 0.0],
            [3.0 / 2.0, -3.0 / 2.0, 0.5, 0.5],
        ]
    )


def _embedded_weights_order3(A: np.ndarray, c: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Order-3 embedded weights for a given tableau: perturb b inside the
    null space of the order-{1,2,3} condition matrix, breaking one order-4
    condition so the pair is genuinely 4(3).  (The reference takes the
    published embedded weights from qmat; deriving them from the order
    conditions gives an equally valid order-3 companion and is pinned by the
    embedded-order test.)"""
    C = np.vstack([np.ones_like(c), c, c**2, A @ c])
    _, _, Vt = np.linalg.svd(C)
    null = Vt[4:]  # (s-4, s) basis of the nullspace
    # direction that maximally violates b.c^3 = 1/4 within the nullspace
    viol = null @ c**3
    d = null.T @ viol
    d = d / (d @ c**3)  # normalize: bhat.c^3 - 1/4 = -0.05
    return b - 0.05 * d


class ESDIRK43(RungeKutta):
    """ESDIRK4(3)6L[2]SA: stiffly accurate, L-stable, stage order 2,
    gamma = 1/4 (Kennedy & Carpenter, NASA/TM-2016-219173; reference
    Runge_Kutta.py:661-674).  Main weights are the published closed forms —
    verified against all eight order-4 conditions in tests."""

    _s2 = np.sqrt(2.0)
    _g = 0.25
    nodes = np.array([0.0, 0.5, (2.0 - _s2) / 4.0, 5.0 / 8.0, 26.0 / 25.0, 1.0])
    _b = np.array(
        [
            (1181.0 - 987.0 * _s2) / 13782.0,
            (1181.0 - 987.0 * _s2) / 13782.0,
            47.0 * (-267.0 + 1783.0 * _s2) / 273343.0,
            -16.0 * (-22922.0 + 3525.0 * _s2) / 571953.0,
            -15625.0 * (97.0 + 376.0 * _s2) / 90749876.0,
            _g,
        ]
    )
    matrix = np.zeros((6, 6))
    matrix[1, :2] = [_g, _g]
    matrix[2, :3] = [(1.0 - _s2) / 8.0, (1.0 - _s2) / 8.0, _g]
    matrix[3, :4] = [(5.0 - 7.0 * _s2) / 64.0, (5.0 - 7.0 * _s2) / 64.0, 7.0 * (1.0 + _s2) / 32.0, _g]
    matrix[4, :5] = [
        (-13796.0 - 54539.0 * _s2) / 125000.0,
        (-13796.0 - 54539.0 * _s2) / 125000.0,
        (506605.0 + 132109.0 * _s2) / 437500.0,
        166.0 * (-97.0 + 376.0 * _s2) / 109375.0,
        _g,
    ]
    matrix[5, :] = _b
    weights = np.array([_b, _embedded_weights_order3(matrix, nodes, _b)])
    ButcherTableauClass = ButcherTableauEmbedded

    @classmethod
    def get_update_order(cls):
        return 4


class EDIRK4(RungeKutta):
    """Stiffly accurate 4-stage EDIRK of order 4 with an explicit first stage
    (Kennedy & Carpenter, NASA/TM-2016-219173 eq. (216), second variant;
    reference Runge_Kutta.py:636-643).  All four classical order-4 scalar
    conditions hold exactly for these rationals (checked in tests)."""

    nodes = np.array([0.0, 3.0 / 2.0, 7.0 / 5.0, 1.0])
    weights = np.array([13.0, 84.0, -125.0, 70.0]) / 42.0
    matrix = np.array(
        [
            [0.0, 0.0, 0.0, 0.0],
            [3.0 / 4.0, 3.0 / 4.0, 0.0, 0.0],
            [447.0 / 675.0, -357.0 / 675.0, 855.0 / 675.0, 0.0],
            [13.0 / 42.0, 84.0 / 42.0, -125.0 / 42.0, 70.0 / 42.0],
        ]
    )


class DIRK43(RungeKutta):
    """Embedded A-stable (L-stable) DIRK pair of orders 4 and 3 (role of
    reference Runge_Kutta.py:610-623).  The reference uses the Cash pair via
    qmat; here the classic Hairer & Wanner SDIRK4 (Solving ODEs II,
    Table IV.6.5; gamma = 1/4, stiffly accurate, published embedded order-3
    weights) fills the same slot — both tableaus verified against all
    order-4/order-3 conditions in tests."""

    nodes = np.array([0.25, 0.75, 11.0 / 20.0, 0.5, 1.0])
    _b = np.array([25.0 / 24.0, -49.0 / 48.0, 125.0 / 16.0, -85.0 / 12.0, 0.25])
    _bhat = np.array([59.0 / 48.0, -17.0 / 96.0, 225.0 / 32.0, -85.0 / 12.0, 0.0])
    weights = np.array([_b, _bhat])
    matrix = np.array(
        [
            [0.25, 0.0, 0.0, 0.0, 0.0],
            [0.5, 0.25, 0.0, 0.0, 0.0],
            [17.0 / 50.0, -1.0 / 25.0, 0.25, 0.0, 0.0],
            [371.0 / 1360.0, -137.0 / 2720.0, 15.0 / 544.0, 0.25, 0.0],
            [25.0 / 24.0, -49.0 / 48.0, 125.0 / 16.0, -85.0 / 12.0, 0.25],
        ]
    )
    ButcherTableauClass = ButcherTableauEmbedded

    @classmethod
    def get_update_order(cls):
        return 4


# ---------------------------------------------------------------------------
# Kennedy & Carpenter ARK5(4)8L[2]SA (Appl. Numer. Math. 44, 2003): the
# classic 8-stage additive IMEX pair of orders 5(4).  Implicit part is a
# stiffly accurate, L-stable ESDIRK with gamma = 41/200; both parts share
# nodes and weights.  Reference: Runge_Kutta.py:676-715.  Every rational
# below is validated in tests against all seventeen order-5 conditions and
# the embedded order-4 conditions (max residual < 1e-12).
# ---------------------------------------------------------------------------

_ARK548_G = 41.0 / 200.0
_ARK548_NODES = np.array(
    [
        0.0,
        41.0 / 100.0,
        2935347310677.0 / 11292855782101.0,
        1426016391358.0 / 7196633302097.0,
        92.0 / 100.0,
        24.0 / 100.0,
        3.0 / 5.0,
        1.0,
    ]
)
_ARK548_B = np.array(
    [
        -872700587467.0 / 9133579230613.0,
        0.0,
        0.0,
        22348218063261.0 / 9555858737531.0,
        -1143369518992.0 / 8141816002931.0,
        -39379526789629.0 / 19018526304540.0,
        32727382324388.0 / 42900044865799.0,
        _ARK548_G,
    ]
)
_ARK548_BHAT = np.array(
    [
        -975461918565.0 / 9796059967033.0,
        0.0,
        0.0,
        78070527104295.0 / 32432590147079.0,
        -548382580838.0 / 3424219808633.0,
        -33438840321285.0 / 15594753105479.0,
        3629800801594.0 / 4656183773603.0,
        4035322873751.0 / 18575991585200.0,
    ]
)


def _ark548_implicit_matrix():
    g = _ARK548_G
    A = np.zeros((8, 8))
    A[1, :2] = [g, g]
    A[2, :3] = [41.0 / 400.0, -567603406766.0 / 11931857230679.0, g]
    A[3, 0] = 683785636431.0 / 9252920307686.0
    A[3, 2:4] = [-110385047103.0 / 1367015193373.0, g]
    A[4, 0] = 3016520224154.0 / 10081342136671.0
    A[4, 2:5] = [30586259806659.0 / 12414158314087.0, -22760509404356.0 / 11113319521817.0, g]
    A[5, 0] = 218866479029.0 / 1489978393911.0
    A[5, 2:6] = [
        638256894668.0 / 5436446318841.0,
        -1179710474555.0 / 5321154724896.0,
        -60928119172.0 / 8023461067671.0,
        g,
    ]
    A[6, 0] = 1020004230633.0 / 5715676835656.0
    A[6, 2:7] = [
        25762820946817.0 / 25263940353407.0,
        -2161375909145.0 / 9755907335909.0,
        -211217309593.0 / 5846859502534.0,
        -4269925059573.0 / 7827059040749.0,
        g,
    ]
    A[7, :] = _ARK548_B
    return A


def _ark548_explicit_matrix():
    A = np.zeros((8, 8))
    A[1, 0] = 41.0 / 100.0
    A[2, :2] = [367902744464.0 / 2072280473677.0, 677623207551.0 / 8224143866563.0]
    A[3, 0] = 1268023523408.0 / 10340822734521.0
    A[3, 2] = 1029933939417.0 / 13636558850479.0
    A[4, 0] = 14463281900351.0 / 6315353703477.0
    A[4, 2:4] = [66114435211212.0 / 5879490589093.0, -54053170152839.0 / 4284798021562.0]
    A[5, 0] = 14090043504691.0 / 34967701212078.0
    A[5, 2:5] = [
        15191511035443.0 / 11219624916014.0,
        -18461159152457.0 / 12425892160975.0,
        -281667163811.0 / 9011619295870.0,
    ]
    A[6, 0] = 19230459214898.0 / 13134317526959.0
    A[6, 2:6] = [
        21275331358303.0 / 2942455364971.0,
        -38145345988419.0 / 4862620318723.0,
        -1.0 / 8.0,
        -1.0 / 8.0,
    ]
    A[7, 0] = -19977161125411.0 / 11928030595625.0
    A[7, 2:7] = [
        -28101048343015.0 / 4398046511104.0,
        380703258247096.0 / 25911928827351.0,
        7065827460283.0 / 74639363344426.0,
        -651687813460299.0 / 90372153019216.0,
        0.0,
    ]
    # the last entry closes the row sum (c_8 = 1); the seven entries above
    # were pinned by the order-5 + additive coupling conditions (the scheme
    # has exactly one free direction in this row, fixed by a_{81})
    A[7, 6] = 1.0 - A[7, :6].sum()
    return A


class ARK548L2SAERK(RungeKutta):
    """Explicit part of ARK5(4)8L[2]SA (Kennedy & Carpenter 2003; reference
    Runge_Kutta.py:676-687): ERK of order 5 with embedded order-4 weights."""

    nodes = _ARK548_NODES
    weights = np.array([_ARK548_B, _ARK548_BHAT])
    matrix = _ark548_explicit_matrix()
    ButcherTableauClass = ButcherTableauEmbedded

    @classmethod
    def get_update_order(cls):
        return 5


class ARK548L2SAESDIRK(RungeKutta):
    """Implicit part of ARK5(4)8L[2]SA: stiffly accurate L-stable ESDIRK of
    order 5, gamma = 41/200 (reference Runge_Kutta.py:690-696)."""

    nodes = _ARK548_NODES
    weights = np.array([_ARK548_B, _ARK548_BHAT])
    matrix = _ark548_implicit_matrix()
    ButcherTableauClass = ButcherTableauEmbedded

    @classmethod
    def get_update_order(cls):
        return 5


class ARK54(RungeKuttaIMEX):
    """ARK5(4)8L[2]SA additive IMEX pair: ESDIRK for the stiff part, ERK for
    the rest, shared nodes/weights (reference Runge_Kutta.py:699-715)."""

    nodes = _ARK548_NODES
    weights = np.array([_ARK548_B, _ARK548_BHAT])
    matrix = _ark548_implicit_matrix()
    matrix_explicit = _ark548_explicit_matrix()
    ButcherTableauClass = ButcherTableauEmbedded

    @classmethod
    def get_update_order(cls):
        return 5


# ---------------------------------------------------------------------------
# Kennedy & Carpenter ARK5(4)8L[2]SAb (Appl. Numer. Math. 136, 2019): the
# newer 5(4) additive pair with gamma = 2/9.  Reference:
# Runge_Kutta.py:718-763.  The implicit tableau below is the published one
# (validated against all order-5/embedded-4 conditions in tests).
# ---------------------------------------------------------------------------

_ARK548B_G = 2.0 / 9.0
_ARK548B_NODES = np.array(
    [
        0.0,
        4.0 / 9.0,
        6456083330201.0 / 8509243623797.0,
        1632083962415.0 / 14158861528103.0,
        6365430648612.0 / 17842476412687.0,
        18.0 / 25.0,
        191.0 / 200.0,
        1.0,
    ]
)
_ARK548B_B = np.array(
    [
        0.0,
        0.0,
        3517720773327.0 / 20256071687669.0,
        4569610470461.0 / 17934693873752.0,
        2819471173109.0 / 11655438449929.0,
        3296210113763.0 / 10722700128969.0,
        -1142099968913.0 / 5710983926999.0,
        _ARK548B_G,
    ]
)
_ARK548B_BHAT = np.array(
    [
        0.0,
        0.0,
        520639020421.0 / 8300446712847.0,
        4550235134915.0 / 17827758688493.0,
        1482366381361.0 / 6201654941325.0,
        5551607622171.0 / 13911031047899.0,
        -5266607656330.0 / 36788968843917.0,
        1074053359553.0 / 5740751784926.0,
    ]
)


def _ark548b_implicit_matrix():
    g = _ARK548B_G
    A = np.zeros((8, 8))
    A[1, :2] = [g, g]
    A[2, :3] = [2366667076620.0 / 8822750406821.0, 2366667076620.0 / 8822750406821.0, g]
    A[3, :4] = [
        -257962897183.0 / 4451812247028.0,
        -257962897183.0 / 4451812247028.0,
        128530224461.0 / 14379561246022.0,
        g,
    ]
    A[4, :5] = [
        -486229321650.0 / 11227943450093.0,
        -486229321650.0 / 11227943450093.0,
        -225633144460.0 / 6633558740617.0,
        1741320951451.0 / 6824444397158.0,
        g,
    ]
    A[5, :6] = [
        621307788657.0 / 4714163060173.0,
        621307788657.0 / 4714163060173.0,
        -125196015625.0 / 3866852212004.0,
        940440206406.0 / 7593089888465.0,
        961109811699.0 / 6734810228204.0,
        g,
    ]
    A[6, :7] = [
        2036305566805.0 / 6583108094622.0,
        2036305566805.0 / 6583108094622.0,
        -3039402635899.0 / 4450598839912.0,
        -1829510709469.0 / 31102090912115.0,
        -286320471013.0 / 6931253422520.0,
        8651533662697.0 / 9642993110008.0,
        g,
    ]
    A[7, :] = _ARK548B_B
    return A


class ARK548L2SAESDIRK2(RungeKutta):
    """Implicit part of ARK5(4)8L[2]SAb (Kennedy & Carpenter 2019): stiffly
    accurate, L-stable, singly diagonal (gamma = 2/9) embedded ESDIRK pair of
    orders 5 and 4 with explicit first stage (reference
    Runge_Kutta.py:718-731)."""

    nodes = _ARK548B_NODES
    weights = np.array([_ARK548B_B, _ARK548B_BHAT])
    matrix = _ark548b_implicit_matrix()
    ButcherTableauClass = ButcherTableauEmbedded

    @classmethod
    def get_update_order(cls):
        return 5


# ---------------------------------------------------------------------------
# Ascher-Ruuth-Spiteri IMEX pairs (Appl. Numer. Math. 25, 1997) with both
# parts globally stiffly accurate — usable on simple DAEs.  Reference:
# Runge_Kutta.py:796-824 (ARK2 = ARS(2,2,2), ARK3 = ARS(4,4,3)).
# ---------------------------------------------------------------------------


class ARK2(RungeKuttaIMEX):
    """ARS(2,2,2): 2nd-order, two implicit stages, SDIRK gamma = 1 - 1/sqrt(2),
    explicit first stage; implicit and explicit parts both stiffly accurate
    (reference Runge_Kutta.py:796-806)."""

    _g = 1.0 - 1.0 / np.sqrt(2.0)
    _d = 1.0 - 1.0 / (2.0 * _g)
    nodes = np.array([0.0, _g, 1.0])
    weights = np.array([0.0, 1.0 - _g, _g])
    weights_explicit = np.array([_d, 1.0 - _d, 0.0])
    matrix = np.array([[0.0, 0.0, 0.0], [0.0, _g, 0.0], [0.0, 1.0 - _g, _g]])
    matrix_explicit = np.array([[0.0, 0.0, 0.0], [_g, 0.0, 0.0], [_d, 1.0 - _d, 0.0]])


class ARK3(RungeKuttaIMEX):
    """ARS(4,4,3): 3rd-order, four implicit stages (gamma = 1/2), explicit
    first stage; both parts stiffly accurate (reference
    Runge_Kutta.py:809-824)."""

    nodes = np.array([0.0, 0.5, 2.0 / 3.0, 0.5, 1.0])
    weights = np.array([0.0, 1.5, -1.5, 0.5, 0.5])
    weights_explicit = np.array([0.25, 7.0 / 4.0, 0.75, -7.0 / 4.0, 0.0])
    matrix = np.array(
        [
            [0.0, 0.0, 0.0, 0.0, 0.0],
            [0.0, 0.5, 0.0, 0.0, 0.0],
            [0.0, 1.0 / 6.0, 0.5, 0.0, 0.0],
            [0.0, -0.5, 0.5, 0.5, 0.0],
            [0.0, 1.5, -1.5, 0.5, 0.5],
        ]
    )
    matrix_explicit = np.array(
        [
            [0.0, 0.0, 0.0, 0.0, 0.0],
            [0.5, 0.0, 0.0, 0.0, 0.0],
            [11.0 / 18.0, 1.0 / 18.0, 0.0, 0.0, 0.0],
            [5.0 / 6.0, -5.0 / 6.0, 0.5, 0.0, 0.0],
            [0.25, 7.0 / 4.0, 0.75, -7.0 / 4.0, 0.0],
        ]
    )


class ESDIRK53(RungeKutta):
    """Embedded ESDIRK pair of orders 5 and 3 (role of reference
    Runge_Kutta.py:646-657, ESDIRK5(3)6L[2]SA).  The reference takes the
    published Kennedy & Carpenter tableau from qmat (unavailable offline);
    this tableau was re-derived from scratch under the same design
    constraints — 6 stages, explicit first stage, singly diagonal
    (gamma ~ 0.27732), stage order 2 (C(2)), stiffly accurate, main method
    order 5, L-stable AND A-stable with strong stiff damping
    (max |R(z)| ~ 0.12 on the negative real axis); the embedded order-3
    companion is L-stable (R(-inf) = 0 exactly).  All 17 order-5 conditions
    hold to 1e-12 (gated in tests)."""

    _g = 0.2773200854868669
    nodes = np.array(
        [
            0.0,
            0.5546401709737337,
            1.0753383900348419,
            0.6739411517145879,
            0.170795598795235,
            1.0,
        ]
    )
    _b = np.array(
        [
            0.04242302157443839,
            0.3706833749818705,
            -0.10139933312718763,
            0.11116120406444384,
            0.299811647019568,
            _g,
        ]
    )
    _bhat = np.array(
        [
            -0.030673740012807316,
            0.540161825096044,
            -0.16548269482454633,
            -0.16815870714627812,
            0.400950351967545,
            0.4232029649200427,
        ]
    )
    weights = np.array([_b, _bhat])
    matrix = np.array(
        [
            [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [_g, _g, 0.0, 0.0, 0.0, 0.0],
            [0.2932524997234106, 0.5047658048245643, _g, 0.0, 0.0, 0.0],
            [0.2943605792663334, 0.13398107517718352, -0.03172058821579595, _g, 0.0, 0.0],
            [-0.13822912292999423, 0.7882596764582929, 0.099386861282229, -0.8559419015021594, _g, 0.0],
            [
                0.04242302157443839,
                0.3706833749818705,
                -0.10139933312718763,
                0.11116120406444384,
                0.299811647019568,
                _g,
            ],
        ]
    )
    ButcherTableauClass = ButcherTableauEmbedded

    @classmethod
    def get_update_order(cls):
        return 4


def _ark548b_explicit_matrix():
    """Explicit companion of ARK5(4)8L[2]SAb.  The published KC2019 explicit
    tableau is qmat-only (unavailable offline); this matrix was re-derived
    as an exact completion of the published implicit tableau/nodes/weights:
    it satisfies ALL 187 two-color (additive) order conditions up to order 5
    with the implicit part, plus all 43 embedded order-4 coupling conditions
    and the row-sum constraints, to 1e-14 (gated in tests).  Coefficients
    differ from KC's published optimization inside the same solution
    manifold; orders and structure are identical."""
    return np.array(
        [
            [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [4.44444444444444420e-01, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [1.11111111111111438e-01, 6.47603013860687415e-01, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [-2.01899884285121539e-01, 7.44574915892404987e-01, -4.27405597043241492e-01, 0.0, 0.0, 0.0, 0.0, 0.0],
            [
                5.69847816987718803e-01,
                -3.50577331404979875e-01,
                3.16424965629250987e-01,
                -1.78938322807671440e-01,
                0.0,
                0.0,
                0.0,
                0.0,
            ],
            [
                5.63924322840501646e-01,
                -9.36726144985437825e-01,
                3.65557760488018135e-01,
                -5.74436690489319335e-01,
                1.30168075214623746e00,
                0.0,
                0.0,
                0.0,
            ],
            [
                1.10509020795647306e00,
                6.64523613926599044e00,
                -2.22410919930402384e00,
                -2.76704650370791461e00,
                -2.22439611010240590e00,
                4.20225465891880923e-01,
                0.0,
                0.0,
            ],
            [
                -2.61244772954547622e-01,
                6.29783169887776939e00,
                -2.17305191702849854e00,
                -4.86316322927428046e-01,
                -3.10222310188204542e00,
                7.65500982996915047e-01,
                -4.04965670821648485e-02,
                0.0,
            ],
        ]
    )


class ARK548L2SAERK2(RungeKutta):
    """Explicit part of ARK5(4)8L[2]SAb (reference Runge_Kutta.py:733-740):
    ERK of order 5 sharing nodes and (embedded) weights with
    ARK548L2SAESDIRK2.  See ``_ark548b_explicit_matrix`` for provenance."""

    nodes = _ARK548B_NODES
    weights = np.array([_ARK548B_B, _ARK548B_BHAT])
    matrix = _ark548b_explicit_matrix()
    ButcherTableauClass = ButcherTableauEmbedded

    @classmethod
    def get_update_order(cls):
        return 5


class ARK548L2SA(RungeKuttaIMEX):
    """ARK5(4)8L[2]SAb additive IMEX pair of order 5 (Kennedy & Carpenter
    2019; reference Runge_Kutta.py:743-763): ESDIRK2 for the stiff part,
    the derived ERK2 companion for the rest."""

    nodes = _ARK548B_NODES
    weights = np.array([_ARK548B_B, _ARK548B_BHAT])
    matrix = _ark548b_implicit_matrix()
    matrix_explicit = _ark548b_explicit_matrix()
    ButcherTableauClass = ButcherTableauEmbedded

    @classmethod
    def get_update_order(cls):
        return 5
