"""The Newton-Krylov solvers of the PyTorch port (``ops/solvers.py`` on the
masked loop of ``ops/loops.py``) against the JAX package's ``pcg`` and
``newton_pde`` (float64, CPU), and the masked loop itself.

The JAX loops are ``lax.while_loop``\\ s, whose iteration counts they do not
return: the JAX side here counts them with ordered ``jax.debug.callback``\\ s
in the operator apply and the preconditioner solve it is given (a solve is
``A`` for ``G(u0)``, then per Newton step ``A A M`` for ``G(u)``, ``J(x0)`` and
``z0``, one ``A M`` per PCG iteration and ``A`` for ``G`` of the update), so
each solve's Newton count and each Newton step's PCG count compare exactly.
Gates: equal counts, fields to 1e-11 relative; the masked loop with
``READ_EVERY`` 1 (the module's value: a read an iteration) and 2 or 3 bit for
bit equal, with ``ceil(k / R) + 1`` host reads a loop; the sparse lane's PCG
and CG counts as the JAX package's.
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysdc_tpu.ops.solvers as jsolvers
from pysdc_tpu.models.allen_cahn import AllenCahnPeriodicND as JaxAllenCahn
from pysdc_tpu.models.var_diffusion import VarCoeffDiffusion2D as JaxVC2
from pysdc_tpu_torch.models.allen_cahn import AllenCahnPeriodicND
from pysdc_tpu_torch.models.var_diffusion import VarCoeffDiffusion2D
from pysdc_tpu_torch.ops import loops, solvers
from pysdc_tpu_torch.utils.convert import to_numpy

# small fields: one thread does them fastest, and several test workers with a thread pool each oversubscribe the cores
torch.set_num_threads(1)

N = 32
FACTOR = 0.3 * 2e-4 * 5  # a shift of the main path's order (dt * qd) with room for Newton to work
RTOL = 1e-11


# -- counting the JAX package's loops --------------------------------------------------------------------------------
@contextlib.contextmanager
def jax_solve_events(module, name='newton_pde'):
    """Replace ``module.<name>`` (a JAX ``newton_pde`` as a module sees it) by one that logs, in order, 'S' at each
    solve, 'A' at each operator apply and 'M' at each preconditioner solve; yields the list of events."""
    events = []
    orig = getattr(module, name)

    def log(tag):
        jax.debug.callback(lambda: events.append(tag), ordered=True)

    def traced(apply_A, solve_shifted, *args, **kwargs):
        log('S')

        def A(u):
            log('A')
            return apply_A(u)

        def M(r, f):
            log('M')
            return solve_shifted(r, f)

        return orig(A, M, *args, **kwargs)

    setattr(module, name, traced)
    try:
        yield events
    finally:
        setattr(module, name, orig)


def parse_newton_events(events) -> list:
    """The events of :func:`jax_solve_events` as one ``(Newton iterations, [PCG iterations of each])`` a solve."""
    out, i = [], 0
    while i < len(events):
        assert events[i:i + 2] == ['S', 'A'], events[i:i + 2]
        i += 2
        pcg = []
        while events[i:i + 3] == ['A', 'A', 'M']:
            i += 3
            k = 0
            while events[i:i + 2] == ['A', 'M']:
                i += 2
                k += 1
            assert events[i] == 'A'
            i += 1
            pcg.append(k)
        out.append((len(pcg), pcg))
    return out


def close(got, want, rtol=RTOL):
    """``got`` (a tensor) against ``want`` within ``rtol`` of ``max|want|``."""
    want = np.asarray(want)
    np.testing.assert_allclose(to_numpy(got), want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


# -- the inputs --------------------------------------------------------------------------------------------------------
def _problems(eps=0.04):
    return (JaxAllenCahn(nvars=(N, N), eps=eps, radius=0.25),
            AllenCahnPeriodicND(nvars=(N, N), eps=eps, radius=0.25, device='cpu'))


def _fields(seed=3):
    """The initial circle and a perturbation of it, from a numpy seed."""
    jprob, _ = _problems()
    u = np.asarray(jprob.u_exact(0.0))
    rng = np.random.default_rng(seed)
    return u, u + 0.05 * rng.standard_normal(u.shape)


def test_pcg_matches_jax_on_the_allen_cahn_operator():
    """One Jacobian system of the 32^2 Allen-Cahn Newton step, PCG preconditioned by the exact shifted solve."""
    jprob, tprob = _problems()
    u, rhs = _fields()
    jdg, tdg = jprob._reaction_prime(jnp.asarray(u)), tprob._reaction_prime(torch.as_tensor(u))
    calls = []

    def jJ(x):
        return x - FACTOR * (jprob.A.apply(x) + jdg * x)

    def jM(x):
        jax.debug.callback(lambda: calls.append(1), ordered=True)
        return jprob.A.solve_shifted(x, FACTOR)

    want = jax.jit(lambda b: jsolvers.pcg(jJ, b, jnp.zeros_like(b), M_inv=jM, tol=1e-13, maxiter=50))(jnp.asarray(rhs))
    jax.effects_barrier()
    got, info = solvers.pcg(lambda x: x - FACTOR * (tprob.A.apply(x) + tdg * x), torch.as_tensor(rhs),
                            torch.zeros(N, N, dtype=torch.float64), M_inv=lambda x: tprob.A.solve_shifted(x, FACTOR),
                            tol=1e-13, maxiter=50)
    assert info.iterations == [len(calls) - 1] and 3 <= info.iterations[0] < 50  # k iterations: k + 1 solves
    close(got, want)


@pytest.mark.parametrize('eps', [0.04, 0.1])
def test_newton_pde_matches_jax(eps):
    jprob, tprob = _problems(eps)
    u, rhs = _fields()
    kw = dict(newton_tol=1e-10, newton_maxiter=100)
    with jax_solve_events(jsolvers) as events:
        want = jax.jit(lambda r, x: jsolvers.newton_pde(jprob.A.apply, jprob.A.solve_shifted, jprob._reaction,
                                                        jprob._reaction_prime, r, FACTOR, x, **kw))(
            jnp.asarray(rhs), jnp.asarray(u))
        jax.effects_barrier()
    got, info = solvers.newton_pde(tprob.A.apply, tprob.A.solve_shifted, tprob._reaction, tprob._reaction_prime,
                                   torch.as_tensor(rhs), FACTOR, torch.as_tensor(u), **kw)
    assert info.per_system() == parse_newton_events(events)
    assert info.iterations[0] >= 2
    close(got, want)


def _masked_newton(monkeypatch, read_every, batch=False):
    monkeypatch.setattr(loops, 'READ_EVERY', read_every)
    _, tprob = _problems()
    u, rhs = _fields()
    u, rhs = torch.as_tensor(u), torch.as_tensor(rhs)
    if batch:  # two systems, the second solved by its start: its own flag stops it at once
        rhs = torch.stack([rhs, u - FACTOR * (tprob.A.apply(u) + tprob._reaction(u))])
        u = torch.stack([u, u])
    return solvers.newton_pde(tprob.A.apply, tprob.A.solve_shifted, tprob._reaction, tprob._reaction_prime, rhs,
                              FACTOR, u, newton_tol=1e-10, newton_maxiter=100, batch_ndim=1 if batch else 0)


@pytest.mark.parametrize('R', [2, 3])
@pytest.mark.parametrize('batch', [False, True])
def test_masked_loop_reads_every_R_iterations_and_changes_nothing(monkeypatch, batch, R):
    """``READ_EVERY`` 1 (the module's value: a read an iteration) and 2 or 3 give bit-for-bit equal fields and
    equal counts; each loop reads ceil(k / R) + 1 times and computes the iterations up to its next read."""
    assert loops.READ_EVERY == 1
    u1, info1 = _masked_newton(monkeypatch, 1, batch)
    u2, info2 = _masked_newton(monkeypatch, R, batch)
    assert torch.equal(u1, u2)
    assert info1.per_system() == info2.per_system()
    k_newton = max(info2.iterations)
    pcg = [max(p.iterations) for p in info2.pcg]
    assert info2.steps == min(100, R * math.ceil(k_newton / R))
    masked = info2.steps - k_newton  # Newton steps past the stop: their PCG reads once and computes nothing
    assert info2.reads == math.ceil(k_newton / R) + 1 + sum(math.ceil(k / R) + 1 for k in pcg[:k_newton]) + masked
    assert info2.reads < info1.reads
    assert info1.reads == k_newton + 1 + sum(max(p.iterations) + 1 for p in info1.pcg)
    assert [p.steps for p in info2.pcg] == [min(50, R * math.ceil(k / R)) for k in pcg]
    if batch:
        counts = info2.per_system()
        assert counts[0][0] >= 2 and counts[1] == (0, [])  # each system stops on its own flag
        single, _ = _masked_newton(monkeypatch, R)
        close(u2[0], to_numpy(single), rtol=1e-13)  # the batch's reductions may sum in another order


def test_masked_loop_counts_and_host_counts():
    """A plain countdown: counts per system on the device and on the host, and the computed steps."""
    start = torch.tensor([3.0, 0.0, 5.0])
    out = loops.masked_loop(lambda c, flags: (c[0] - 1,), lambda c: c[0] > 0, (start,), 10)
    assert out.host_counts == [3, 0, 5] and out.counts.tolist() == [3, 0, 5]
    assert out.carry[0].tolist() == [0.0, 0.0, 0.0]
    assert out.steps == loops.READ_EVERY * math.ceil(5 / loops.READ_EVERY) and out.reads == math.ceil(5 / loops.READ_EVERY) + 1
    capped = loops.masked_loop(lambda c, flags: (c[0] - 1,), lambda c: c[0] > 0, (start,), 4)
    assert capped.host_counts == [3, 0, 4] and capped.steps == 4


def test_capture_runs_a_fixed_depth_and_sets_the_flag(monkeypatch):
    """Inside a CUDA graph capture nothing is read, and Newton and each PCG run as device ``while`` loops to
    their tolerance (the name is kept from the fixed depth and the ``failed`` flag this replaced): the steps
    computed equal the eager counts and the result equals the eager one bit for bit.  A solve cut by
    ``newton_maxiter`` ends there, as eager does, and raises nothing.  The capture is simulated on the CPU
    through ``loops.capturing`` (the device loop's plain version)."""
    _, tprob = _problems()
    u, rhs = (torch.as_tensor(x) for x in _fields())

    def solve(maxiter):
        return solvers.newton_pde(tprob.A.apply, tprob.A.solve_shifted, tprob._reaction, tprob._reaction_prime,
                                  rhs, FACTOR, u, newton_tol=1e-10, newton_maxiter=maxiter)

    eager, info = solve(100)
    short, short_info = solve(info.iterations[0] - 1)
    monkeypatch.setattr(loops, 'capturing', lambda x: True)
    captured, cinfo = solve(100)
    assert cinfo.reads == 0 and cinfo.iterations is None
    assert cinfo.steps == info.steps == info.iterations[0] > 1
    assert [p.steps for p in cinfo.pcg] == [p.steps for p in info.pcg] == [p.iterations[0] for p in info.pcg]
    assert all(0 < p.steps < 50 for p in cinfo.pcg)
    assert torch.equal(captured, eager)
    cut, cut_info = solve(info.iterations[0] - 1)
    assert cut_info.steps == short_info.steps == info.iterations[0] - 1 and torch.equal(cut, short)


# -- the sparse lane's loops, repaired ---------------------------------------------------------------------------------
def _coeff(X, Y):
    return 0.1 * (1.0 + 0.5 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y))


@pytest.mark.parametrize('solver', ['pcg', 'cg'])
def test_sparse_lane_counts_equal_jax_and_survive_the_repair(monkeypatch, solver):
    """The sparse lane's PCG (deferred-z order, the separable preconditioner) and its plain CG (jax.scipy's rule)
    on VarCoeffDiffusion2D 24^2: each solve's iterations equal the JAX package's, for READ_EVERY 1 and 2."""
    params = dict(nvars=(24, 24), coeff_fn=_coeff, **({} if solver == 'pcg' else dict(solver='cg')))
    jop = JaxVC2(**params).A
    rng = np.random.default_rng(5)
    rhs = [rng.standard_normal((24, 24)) for _ in range(3)]
    factors = (1e-3, 4e-3, 2e-2)
    if solver == 'pcg':
        want = [int(jop.solve_shifted_info(jnp.asarray(r), f)[1]) for r, f in zip(rhs, factors)]
    else:
        want = []
        for r, f in zip(rhs, factors):
            calls = []
            orig = jop._mv

            def mv(v, orig=orig):
                jax.debug.callback(lambda: calls.append(1), ordered=True)
                return orig(v)

            jop._mv = mv
            jax.block_until_ready(jop.solve_shifted(jnp.asarray(r), f))
            jax.effects_barrier()
            del jop._mv
            want.append(len(calls) - 1)  # r0 = b - A x0, then one matvec an iteration
        wantx = [np.asarray(jop.solve_shifted(jnp.asarray(r), f)) for r, f in zip(rhs, factors)]
    for R in (1, 2):
        monkeypatch.setattr(loops, 'READ_EVERY', R)
        top = VarCoeffDiffusion2D(device='cpu', **params).A
        assert top.solver_kind == solver
        if solver == 'pcg':
            top.pcg_trace = []
            got = [top.solve_shifted_info(torch.as_tensor(r), f)[1] for r, f in zip(rhs, factors)]
            assert got == top.pcg_trace == want
        else:
            reads = []
            for r, f, wx in zip(rhs, factors, wantx):
                before = top.host_reads
                close(top.solve_shifted(torch.as_tensor(r), f), wx, rtol=1e-10)
                reads.append(top.host_reads - before)
            assert reads == [math.ceil(k / R) + 1 for k in want]
        assert min(want) >= 2
