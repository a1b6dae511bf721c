"""Plain SDC and PFASST block arithmetic: the reference that the benchmark holds the program's blocks against.

Written from the method's definitions (Gauss-Radau collocation, Weiser's LU preconditioner, the FAS coarse
correction, multi-step SDC with Jacobi or Gauss-Seidel coupling), in plain torch on tensors, with no import of
the program.  A problem hands this module three things: ``f(u) -> (impl, expl)`` (``expl`` may be ``None``),
``solve(rhs, alpha)``, the ``u`` with ``u - alpha impl(u) = rhs``, and, for a two-level block, ``restrict`` and
``prolong`` in space.

A block holds ``P`` consecutive steps in tensors ``(M+1, P, *shape)`` (node axis first).  The block follows the
PFASST iteration of pySDC's controllers:

  spread -> [burn-in predictor] -> check -> (work -> check)*  until every step is done;

``check`` hands each active step its predecessor's end point, computes the collocation residual and decides
which steps are done (a step is done once its residual is at most ``restol`` or it has had ``maxiter``
iterations, and only once its predecessor is done).  The reference takes those decisions itself; where the run it
judges decided otherwise on a residual that lies within rounding of ``restol`` (a tie), it follows that run, so
that a tie does not part the two marches (:func:`block` with ``follow``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.linalg as sla
import torch


# -- collocation ------------------------------------------------------------------------------------------------
def radau_right_nodes(M: int) -> np.ndarray:
    """Gauss-Radau nodes on [0, 1] with the right end point, from the roots of ``P_{M-1}(x) - P_M(x)``."""
    from numpy.polynomial import legendre as leg

    c = np.zeros(M + 1)
    c[M - 1], c[M] = 1.0, -1.0
    x = np.sort(np.real(leg.legroots(c)))
    x[-1] = 1.0
    return (x + 1.0) / 2.0


def _lagrange_basis_integrals(nodes: np.ndarray, a: float, b: float) -> np.ndarray:
    """Row ``j``: the integral over [a, b] of the Lagrange polynomial of ``nodes`` that is 1 at node ``j``."""
    n = len(nodes)
    out = np.empty(n)
    for j in range(n):
        others = np.delete(nodes, j)
        poly = np.poly1d(np.poly(others) / np.prod(nodes[j] - others))
        antider = np.polyint(poly)
        out[j] = antider(b) - antider(a)
    return out


def lagrange_matrix(from_nodes: np.ndarray, to_points: np.ndarray) -> np.ndarray:
    """``P @ f(from_nodes)`` = the interpolating polynomial at ``to_points``; shape (len(to), len(from))."""
    from_nodes, to_points = np.asarray(from_nodes, float), np.atleast_1d(np.asarray(to_points, float))
    out = np.zeros((len(to_points), len(from_nodes)))
    for i, x in enumerate(to_points):
        for j, xj in enumerate(from_nodes):
            others = np.delete(from_nodes, j)
            out[i, j] = np.prod((x - others) / (xj - others))
    return out


@dataclass
class Collocation:
    """Radau-right collocation on the unit interval: ``nodes`` (M,), ``q`` (M, M) with ``q[m, j]`` the integral
    from 0 to node m of basis polynomial j, ``QI`` the (M, M) LU preconditioner ``U^T`` of ``q^T = P L U``, and
    ``QE`` the explicit preconditioner (Picard: zero)."""

    nodes: np.ndarray
    q: np.ndarray
    QI: np.ndarray
    QE: np.ndarray

    @classmethod
    def radau_right(cls, M: int, qi: str = 'LU', qe: str = 'PIC') -> 'Collocation':
        if qi != 'LU' or qe != 'PIC':
            raise ValueError(f'the reference knows QI LU and QE PIC, not {qi} / {qe}')
        nodes = radau_right_nodes(M)
        q = np.stack([_lagrange_basis_integrals(nodes, 0.0, t) for t in nodes])
        _, _, U = sla.lu(q.T)
        return cls(nodes=nodes, q=q, QI=U.T, QE=np.zeros((M, M)))


# -- precision of the node contractions ---------------------------------------------------------------------------
def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to the nearest, as a tensor core reads a float32 operand
    with TF32 on."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000 + ((bits >> 13) & 1) - 1) & ~0x1FFF
    return rounded.view(torch.float32)


def contract(W: np.ndarray, x: torch.Tensor, matmul_tf32: bool = False) -> torch.Tensor:
    """``W`` (m, n) applied along the node axis (axis 0) of ``x`` (n, ...), in ``x``'s precision; with
    ``matmul_tf32`` both operands read as TF32 (a float32 product with TF32 on)."""
    Wt = torch.as_tensor(W, dtype=x.dtype, device=x.device)
    if matmul_tf32 and x.dtype == torch.float32:
        Wt, x = tf32(Wt), tf32(x)
    return torch.tensordot(Wt, x, dims=1)


# -- a level and its state ----------------------------------------------------------------------------------------
@dataclass
class State:
    u: torch.Tensor  # (M+1, P, *shape)
    fi: torch.Tensor  # (M+1, P, *shape)
    fe: torch.Tensor | None
    tau: torch.Tensor  # (M, P, *shape)


class Level:
    """One level of the block: a problem (``f``, ``solve``, and where it is the finer of two levels,
    ``restrict`` / ``prolong`` in space), its collocation and step size."""

    def __init__(self, prob, coll: Collocation, dt: float, matmul_tf32: bool = False):
        self.prob, self.coll, self.dt = prob, coll, float(dt)
        self.M = len(coll.nodes)
        self.matmul_tf32 = matmul_tf32

    def f(self, u):
        return self.prob.f(u)

    def ftot(self, s: State):
        """``f`` at the nodes, the parts summed."""
        return s.fi[1:] if s.fe is None else s.fi[1:] + s.fe[1:]

    def integrate(self, s: State) -> torch.Tensor:
        """``dt Q f`` over the nodes, (M, P, *shape)."""
        return self.dt * contract(self.coll.q, self.ftot(s), self.matmul_tf32)

    def spread(self, u0_block: torch.Tensor) -> State:
        M = self.M
        u = u0_block.unsqueeze(0).expand((M + 1,) + tuple(u0_block.shape)).clone()
        fi, fe = self.f(u)
        return State(u=u, fi=fi, fe=fe, tau=torch.zeros_like(u[1:]))

    def sweep(self, s: State, active: torch.Tensor) -> State:
        """One SDC sweep of every step, kept where ``active``: node by node with the lower-triangular ``QI``."""
        c, dt = self.coll, self.dt
        integral = dt * contract(c.q - c.QI, s.fi[1:], self.matmul_tf32) + s.u[0].unsqueeze(0) + s.tau
        if s.fe is not None:
            integral = integral + dt * contract(c.q - c.QE, s.fe[1:], self.matmul_tf32)
        u, fi = list(s.u.unbind(0)), list(s.fi.unbind(0))
        fe = None if s.fe is None else list(s.fe.unbind(0))
        for m in range(self.M):
            rhs = integral[m]
            for j in range(m):
                if c.QI[m, j] != 0.0:
                    rhs = rhs + dt * float(c.QI[m, j]) * fi[j + 1]
            u[m + 1] = self.prob.solve(rhs, dt * float(c.QI[m, m]))
            fi[m + 1], fe_m = self.f(u[m + 1])
            if fe is not None:
                fe[m + 1] = fe_m
        new = State(u=torch.stack(u), fi=torch.stack(fi), fe=None if fe is None else torch.stack(fe), tau=s.tau)
        return masked(active, new, s)

    def endpoint(self, s: State) -> torch.Tensor:
        return s.u[-1]  # Radau-right: the last node is the end point

    def residual(self, s: State, kind: str) -> torch.Tensor:
        """One norm a step: the collocation residual's largest entry over nodes and space (``full_abs``), over
        that step's ``max |u0|`` too (``full_rel``)."""
        res = self.integrate(s) + s.tau + s.u[0].unsqueeze(0) - s.u[1:]
        norm = res.abs().transpose(0, 1).flatten(1).amax(dim=1)
        if kind == 'full_rel':
            norm = norm / s.u[0].abs().flatten(1).amax(dim=1)
        elif kind != 'full_abs':
            raise ValueError(f'residual type {kind!r}')
        return norm

    def take_u0(self, s: State, u0_new: torch.Tensor, mask: torch.Tensor) -> State:
        """Node 0 of the masked steps set to ``u0_new`` and its ``f`` evaluated again."""
        m = _bcast(mask, u0_new.dim() - 1)
        u0 = torch.where(m, u0_new, s.u[0])
        fi0, fe0 = self.f(u0)
        fi = torch.cat([torch.where(m, fi0, s.fi[0]).unsqueeze(0), s.fi[1:]])
        fe = None if s.fe is None else torch.cat([torch.where(m, fe0, s.fe[0]).unsqueeze(0), s.fe[1:]])
        return State(u=torch.cat([u0.unsqueeze(0), s.u[1:]]), fi=fi, fe=fe, tau=s.tau)


def _bcast(mask, trailing):
    return mask.reshape((-1,) + (1,) * trailing)


def masked(mask: torch.Tensor, new: State, old: State) -> State:
    """Per step: ``new`` where ``mask`` (P,), else ``old``."""
    def sel(a, b):
        return torch.where(_bcast(mask, a.dim() - 2).unsqueeze(0), a, b)

    return State(u=sel(new.u, old.u), fi=sel(new.fi, old.fi),
                 fe=None if new.fe is None else sel(new.fe, old.fe), tau=new.tau)


# -- two levels ---------------------------------------------------------------------------------------------------
class Transfer:
    """FAS transfer between a fine and a coarse level: space by the fine problem's ``restrict`` / ``prolong``,
    nodes by Lagrange interpolation between the two node sets."""

    def __init__(self, fine: Level, coarse: Level):
        self.fine, self.coarse = fine, coarse
        self.Rcoll = lagrange_matrix(fine.coll.nodes, coarse.coll.nodes)  # (Mc, Mf)
        self.Pcoll = lagrange_matrix(coarse.coll.nodes, fine.coll.nodes)  # (Mf, Mc)

    def restrict(self, F: State):
        """The coarse state with its tau correction, and its ``u`` (the old values the prolongation needs)."""
        sp, G, tf = self.fine.prob, self.coarse, self.fine.matmul_tf32
        u_sp = sp.restrict(F.u)
        u = torch.cat([u_sp[:1], contract(self.Rcoll, u_sp[1:], tf)])
        fi, fe = G.f(u)
        Gs = State(u=u, fi=fi, fe=fe, tau=torch.zeros_like(u[1:]))
        tau = contract(self.Rcoll, sp.restrict(self.fine.integrate(F)), tf) - G.integrate(Gs)
        tau = tau + contract(self.Rcoll, sp.restrict(F.tau), tf)
        Gs.tau = tau
        return Gs, u

    def prolong(self, F: State, G: State, G_uold: torch.Tensor) -> State:
        corr = self.fine.prob.prolong(contract(self.Pcoll, G.u[1:] - G_uold[1:], self.fine.matmul_tf32))
        u_nodes = F.u[1:] + corr
        fi, fe = self.fine.f(u_nodes)
        return State(u=torch.cat([F.u[:1], u_nodes]), fi=torch.cat([F.fi[:1], fi]),
                     fe=None if F.fe is None else torch.cat([F.fe[:1], fe]), tau=F.tau)


# -- the block ----------------------------------------------------------------------------------------------------
def _exchange(lv: Level, s: State, uend, active, prev_done):
    uend = torch.where(_bcast(active, uend.dim() - 1), lv.endpoint(s), uend)
    ar = torch.arange(len(active), device=active.device)
    recv = active & (ar > 0) & ~prev_done
    return lv.take_u0(s, torch.cat([s.u[0, :1], uend[:-1]]), recv), uend


def _shifted(done):
    return torch.cat([torch.zeros_like(done[:1]), done[:-1]])


def _serial_chain(lv: Level, s: State, uend, recv, active):
    """Gauss-Seidel across the steps: step q takes its predecessor's new end point, sweeps and hands on."""
    P = s.u.shape[1]
    carry = s.u[0, 0]
    us, fis, fes, ues = [], [], [], []
    for q in range(P):
        sq = State(u=s.u[:, q:q + 1], fi=s.fi[:, q:q + 1], fe=None if s.fe is None else s.fe[:, q:q + 1],
                   tau=s.tau[:, q:q + 1])
        sq = lv.take_u0(sq, carry.unsqueeze(0), (recv & active)[q:q + 1])
        sw = lv.sweep(sq, active[q:q + 1])
        carry = torch.where(active[q], lv.endpoint(sw)[0], uend[q])
        us.append(sw.u)
        fis.append(sw.fi)
        if sw.fe is not None:
            fes.append(sw.fe)
        ues.append(carry)
    new = State(u=torch.cat(us, dim=1), fi=torch.cat(fis, dim=1), fe=torch.cat(fes, dim=1) if fes else None,
                tau=s.tau)
    return new, torch.stack(ues)


def block(levels: list[Level], u0: torch.Tensor, restol: float, maxiter: int, residual_type: str = 'full_abs',
          P: int = 1, burnin: bool = False, jacobi: bool = True, follow=None, band: float = 0.0):
    """One block of ``P`` steps from ``u0``.  Returns ``(uend (P, *shape), niter (P,) list, ties, off)``.

    The block decides by its own residuals which steps are done.  Given ``follow``, the iteration counts (P,) of
    the run it judges, it takes that run's decision instead where the two differ and its own residual lies within
    ``band`` of ``restol`` (``|r / restol - 1| <= band``): a tie that rounding decides.  ``ties`` is the largest
    ``|r / restol - 1|`` of the decisions so taken (0 where there was none); ``off`` counts the checks at which a
    step's decision differed from the judged run's and was no tie (the block then keeps its own)."""
    fine = levels[0]
    device = u0.device
    two = len(levels) == 2
    transfer = Transfer(levels[0], levels[1]) if two else None
    ar = torch.arange(P, device=device)
    window = torch.ones(P, dtype=torch.bool, device=device)
    none_done = torch.zeros(P, dtype=torch.bool, device=device)

    S = fine.spread(u0.unsqueeze(0).expand((P,) + tuple(u0.shape)).contiguous())
    uend = torch.zeros((P,) + tuple(u0.shape), dtype=u0.dtype, device=device)
    if two and burnin:
        coarse = levels[1]
        G, G_uold = transfer.restrict(S)
        guend = torch.zeros_like(G.u[0])
        for q in range(P):
            m = ar >= q
            G = coarse.sweep(G, m)
            guend = torch.where(_bcast(m, guend.dim() - 1), coarse.endpoint(G), guend)
            G = coarse.take_u0(G, torch.cat([G.u[0, :1], guend[:-1]]), ar >= q + 1)
        S = transfer.prolong(S, G, G_uold)
        S, uend = _exchange(fine, S, uend, window, none_done)
        S = fine.sweep(S, window)

    judged = None if follow is None else torch.as_tensor(np.asarray(follow), device=device)
    done = torch.zeros(P, dtype=torch.bool, device=device)
    iters = torch.zeros(P, dtype=torch.int64, device=device)
    ties, off = 0.0, 0
    k = 0
    while True:
        # check: hand on the end points, the residuals, the decisions (a step is done only after its predecessor)
        active = ~done
        S, uend = _exchange(fine, S, uend, active, _shifted(done))
        res = fine.residual(S, residual_type)
        raw = (res <= restol) | (iters >= maxiter)
        theirs = None if judged is None else judged <= k
        if theirs is not None and restol > 0:
            closeness = (res / restol - 1.0).abs()
            tie = active & (iters < maxiter) & (theirs != raw) & (closeness <= band)
            if bool(tie.any()):
                ties = max(ties, float(closeness[tie].max()))
                raw = torch.where(tie, theirs, raw)
        done = torch.cumprod((done | (active & raw)).to(torch.int64), dim=0).bool()
        if theirs is not None:
            off += int((active & (done != theirs)).sum())
        iters = torch.where(~done, iters + 1, iters)
        if bool(done.all()) or k > maxiter + 1:
            break
        k += 1
        # work: one iteration of the steps not done
        active = ~done
        prev_done = _shifted(done)
        if not two:
            if jacobi:
                S, uend = _exchange(fine, S, uend, active, prev_done)
                S = fine.sweep(S, active)
            else:
                S, uend = _serial_chain(fine, S, uend, active & (ar > 0) & ~prev_done, active)
        else:
            coarse = levels[1]
            G, G_uold = transfer.restrict(S)
            G, _ = _serial_chain(coarse, G, torch.zeros_like(G.u[-1]), active & (ar > 0) & ~prev_done, active)
            S = transfer.prolong(S, G, G_uold)
            S, uend = _exchange(fine, S, uend, active, prev_done)
            S = fine.sweep(S, active)
    return uend, iters.tolist(), ties, off
