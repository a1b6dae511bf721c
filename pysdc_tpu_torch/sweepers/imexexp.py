"""Exponential SDC (ESDC) sweeper with IMEX-EXP splitting.

The counterpart of ``pysdc_tpu/sweepers/imexexp.py`` (reference Monodomain
project's ``imexexp_1st_order``, ``projects/Monodomain/sweeper_classes/
exponential_runge_kutta/imexexp_1st_order.py:10-301``): the base integrator is
an implicit/explicit/exponential Euler (Rush-Larsen), the collocation integral
of the exponential terms is evaluated through phi-functions, and the result is
an exponential Runge-Kutta collocation method solved by SDC iterations.

  - phi_k(z) come from the same 12-node Gauss rule of the integral
    representation as in the JAX package, but the sum over the Gauss nodes is a
    loop that accumulates into the ``(F, K, *shape)`` table: one exponential
    field of ``F`` factors at a time, where the JAX package's einsum holds all
    ``12 F`` of them (4.8 GB for Hodgkin-Huxley at 2048^2 in float64).
  - ``lambda(u0)`` and the phi tables are recomputed where the JAX package
    recomputes them: in ``update_nodes`` (``lambda`` and ``phi_1`` at the QI
    diagonal) and in ``integrate`` (``lambda``, the phi table and the
    exponential quadrature tensor), so twice a sweep and once more a residual.
    The JAX package's ``_lambda_phi_qmat`` is two functions here,
    ``_lambda_phi_one`` and ``_lambda_qmat``: each computes only what its caller
    reads, as XLA's dead-code elimination leaves it in the JAX package.
  - ``dt`` may be a 0-d tensor on the device (the fused lanes): the factors of
    the phi tables and the products with the QI diagonal are made from it on
    the device, nothing of it is read on the host.
  - The Fornberg derivative weights w[k,j] (p^(k)(0) = sum_j w[k,j] p(c_j))
    come from inverting the scaled Vandermonde V[j,k] = c_j^k / k! at setup.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pysdc_tpu_torch.core.state import IMEXEXP, LevelState
from pysdc_tpu_torch.core.sweeper import Sweeper


def derivative_weights_at_zero(c: np.ndarray) -> np.ndarray:
    """w with p^(k)(0) = sum_j w[k, j] p(c_j) for polynomials of degree < M
    (the reference uses numdifftools.fornberg; inverting the Taylor-scaled
    Vandermonde is equivalent for the small M used here)."""
    M = len(c)
    V = np.array([[cj**k / math.factorial(k) for k in range(M)] for cj in c])
    return np.linalg.inv(V)


class IMEXEXPSweeper(Sweeper):
    """Exponential SDC sweeper; problems must provide ``lmbda_eval`` and an
    ``IMEXEXP`` right-hand side with full-shape masked components."""

    def __init__(self, params: dict):
        params = dict(params)
        params.setdefault('QI', 'IE')
        params.setdefault('quad_type', 'RADAU-RIGHT')
        super().__init__(params)
        self.QI = self.get_Qdelta_implicit(params['QI'])
        self.delta = np.diagonal(self.QI)[1:]
        self.w = derivative_weights_at_zero(self.coll.nodes)
        # Gauss-Legendre rule on [0, 1] for the phi_k integrals (12 nodes, as
        # the JAX package: accurate out to z ~ -30, stiff gates at large dt)
        x, wq = np.polynomial.legendre.leggauss(12)
        self._gl_nodes = 0.5 * (x + 1.0)
        self._gl_weights = 0.5 * wq

    # -- phi machinery --------------------------------------------------
    def _factors(self, dt, table, key, like):
        """``dt * table`` (a numpy vector), made in float64 on ``like``'s device from a kept copy of the table (no
        host copy a call), in ``like``'s dtype."""
        return (dt * self._coeff(key, lambda: table, like, torch.float64)).to(like.dtype)

    def _phi_eval(self, factors, K, lmbda):
        """phi[i, k-1] = phi_k(factors[i] * lmbda) for k = 1..K, shape ``(F, K, *lmbda.shape)``.

        phi_k(z) = int_0^1 e^{(1-s) z} s^{k-1}/(k-1)! ds by the 12-node Gauss
        rule, summed node by node (reference imexexp_1st_order.py:48-78)."""
        ks = np.arange(1, K + 1)
        km1_fac = np.array([math.factorial(k - 1) for k in ks])
        wgt = (self._gl_weights[:, None] * self._gl_nodes[:, None] ** (ks[None, :] - 1)) / km1_fac[None, :]  # (J, K)
        f_ = torch.as_tensor(factors, dtype=lmbda.dtype, device=lmbda.device).reshape((-1, 1) + (1,) * lmbda.dim())
        out = None
        for j, s in enumerate(1.0 - self._gl_nodes):
            e = torch.exp((float(s) * f_) * lmbda.unsqueeze(0))  # (F, 1, *shape)
            w = self._coeff(('phi weights', K, j), lambda j=j: wgt[j], lmbda).reshape((1, K) + (1,) * lmbda.dim())
            out = w * e if out is None else out + w * e
        return out

    def _lambda_qmat(self, prob, u0, t, dt):
        """lambda(u0) and the exponential quadrature tensor
        Qmat_exp[i, j] = sum_k w[k, j] c_i^{k+1} phi_{k+1}(dt c_i lambda) (reference :80-119), what ``integrate``
        reads of the JAX package's ``_lambda_phi_qmat``."""
        M = self.coll.num_nodes
        lmbda = prob.lmbda_eval(u0, t)
        c = self.coll.nodes
        phi = self._phi_eval(self._factors(dt, c, 'nodes', lmbda), M, lmbda)  # (M, M, *shape)
        k = np.arange(M)
        cw = np.asarray(c)[:, None] ** (k[None, :] + 1)  # (M, M) = c_i^{k+1}
        wgt = self._coeff('qmat weights', lambda: cw[:, :, None] * np.asarray(self.w)[None, :, :], lmbda)  # (i,k,j)
        tail = (1,) * lmbda.dim()
        Qmat_exp = None
        for kk in range(M):
            term = wgt[:, kk].reshape((M, M) + tail) * phi[:, kk].unsqueeze(1)
            Qmat_exp = term if Qmat_exp is None else Qmat_exp + term
        return lmbda, Qmat_exp

    def _lambda_phi_one(self, prob, u0, t, dt):
        """lambda(u0) and the phi_1 table at the QI diagonal, shape ``(M, *shape)``: what ``update_nodes`` reads of
        the JAX package's ``_lambda_phi_qmat``."""
        lmbda = prob.lmbda_eval(u0, t)
        return lmbda, self._phi_eval(self._factors(dt, self.delta, 'delta', lmbda), 1, lmbda)[:, 0]

    @staticmethod
    def _exp_term(f_exp, lmbda, u0, u):
        """f_exp + lambda (u0 - u): the node's exponential increment."""
        return f_exp + lmbda * (u0 - u)

    # -- protocol -------------------------------------------------------
    def integrate(self, state: LevelState, dt, t=0.0, prob=None):
        prob = prob if prob is not None else self.level.prob
        M = self.coll.num_nodes
        u0 = state.u[0]
        lmbda, Qmat_exp = self._lambda_qmat(prob, u0, t, dt)
        fs = state.f.impl[1:] + state.f.expl[1:]
        base = torch.tensordot(self._coeff('q', lambda: self.coll.q, fs), fs, dims=1)
        exp_part = None
        for j in range(M):
            term = Qmat_exp[:, j] * self._exp_term(state.f.exp[j + 1], lmbda, u0, state.u[j + 1]).unsqueeze(0)
            exp_part = term if exp_part is None else exp_part + term
        return dt * (base + exp_part)

    def update_nodes(self, prob, state: LevelState, t, dt, k: int = 0) -> LevelState:
        M = self.coll.num_nodes
        ts = self.node_times(t, dt)
        u0 = state.u[0]
        lmbda, phi_one = self._lambda_phi_one(prob, u0, t, dt)
        dtQI = self.scaled_table(dt, self.QI, 'QI')

        integral = self.integrate(state, dt, t=t, prob=prob) + state.tau
        # node-to-node increments
        integral = torch.cat([integral[:1], integral[1:] - integral[:-1]])
        # subtract the old iterate's preconditioner terms (reference :183-196)
        prep = []
        for m in range(M):
            dd = dt * float(self.delta[m])
            term = integral[m]
            term = term - dd * state.f.impl[m + 1]
            term = term - dd * state.f.expl[m]
            term = term - dd * phi_one[m] * self._exp_term(state.f.exp[m], lmbda, u0, state.u[m])
            prep.append(term)

        u_list = list(state.u.unbind(0))
        f_list = [IMEXEXP(impl=state.f.impl[m], expl=state.f.expl[m], exp=state.f.exp[m]) for m in range(M + 1)]
        for m in range(M):
            dd = dt * float(self.delta[m])
            tmp = u_list[m] + prep[m]
            tmp = tmp + dd * phi_one[m] * self._exp_term(f_list[m].exp, lmbda, u0, u_list[m])
            tmp = tmp + dd * f_list[m].expl
            tm = self.node_time(ts, m)
            u_list[m + 1] = prob.solve_system(tmp, self.entry(dtQI, m + 1, m + 1), u_list[m + 1], tm)
            f_list[m + 1] = prob.eval_f(u_list[m + 1], tm)

        f = IMEXEXP(*(torch.stack([getattr(fm, name) for fm in f_list]) for name in IMEXEXP._fields))
        return LevelState(u=torch.stack(u_list), f=f, tau=state.tau)

    def compute_end_point(self, state: LevelState, t, dt):
        if self.coll.right_is_node and not self.do_coll_update:
            return state.u[-1]
        raise NotImplementedError('ESDC requires right_is_node quadrature')
