"""The iterative linear solves of the PyTorch port (``ops/krylov.py``: the
algorithms of ``jax.scipy.sparse.linalg.cg`` / ``gmres``) against the JAX
package's, which call ``jax.scipy`` (float64, CPU).

``jax.scipy`` returns no iteration count: the JAX side counts its operator
applies with a debug callback (CG: one for ``r0`` and one an iteration; GMRES:
two, then one an Arnoldi step and one a restart's residual).  Gates: equal
counts, solutions to 1e-11 relative; ``HeatND(solver_type='CG'|'GMRES')`` and
``AdvectionND`` (direct, GMRES, CG, sparse) through ``ControllerNonMPI`` with
equal ``niter`` and ``uend`` to 1e-11 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysdc_tpu
import pysdc_tpu_torch
from pysdc_tpu.models.advection import AdvectionND as JaxAdvection
from pysdc_tpu.models.heat import HeatND as JaxHeat
from pysdc_tpu.ops.linop import SeparableFDOperator as JaxSep
from pysdc_tpu.ops.sparse_op import SparseFDOperator as JaxSparseFD
from pysdc_tpu_torch.models.advection import AdvectionND
from pysdc_tpu_torch.models.heat import HeatND
from pysdc_tpu_torch.ops import krylov
from pysdc_tpu_torch.ops.linop import SeparableFDOperator
from pysdc_tpu_torch.ops.sparse_op import SparseFDOperator
from test_torch_solvers import close

torch.set_num_threads(1)

OPERATORS = {
    'periodic-2d': [dict(size=32, dx=1 / 32, derivative=2, order=2, bc='periodic')] * 2,
    'dirichlet-1d': [dict(size=63, dx=1 / 64, derivative=2, order=2, bc='dirichlet-zero')],
    'dirichlet-2d': [dict(size=24, dx=1 / 25, derivative=2, order=4, bc='dirichlet-zero')] * 2,
    'advection-1d': [dict(size=64, dx=1 / 64, derivative=1, order=2, stencil_type='upwind', bc='periodic')],
}


def _rhs(shape, seed=4):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape), 0.1 * rng.standard_normal(shape)


def _counted_jax_solve(jop, method, rhs, factor, x0, **kw):
    """The JAX operator's ``solve_shifted_<method>`` with its applies counted."""
    calls = []
    orig = jop.apply

    def apply(u):
        jax.debug.callback(lambda: calls.append(1), ordered=True)
        return orig(u)

    jop.apply = apply
    try:
        x = getattr(jop, f'solve_shifted_{method}')(jnp.asarray(rhs), factor, jnp.asarray(x0), **kw)
        jax.block_until_ready(x)
        jax.effects_barrier()
    finally:
        del jop.apply
    return np.asarray(x), len(calls)


@pytest.mark.parametrize('method', ['cg', 'gmres'])
@pytest.mark.parametrize('name', ['periodic-2d', 'dirichlet-1d', 'dirichlet-2d'])
def test_separable_operator_iterative_solves_match_jax_scipy(name, method):
    per_dim = OPERATORS[name]
    jop, top = JaxSep(per_dim, scale=0.1), SeparableFDOperator(per_dim, scale=0.1)
    rhs, x0 = _rhs(jop.shape)
    want, calls = _counted_jax_solve(jop, method, rhs, 0.02, x0, tol=1e-10)
    top.krylov_trace = []
    got = getattr(top, f'solve_shifted_{method}')(torch.as_tensor(rhs), 0.02, torch.as_tensor(x0), tol=1e-10)
    close(got, want)
    [(kind, k, arnoldi)] = top.krylov_trace
    assert kind == method.upper() and k >= 1
    if method == 'cg':
        assert calls == 1 + k
    else:
        assert len(arnoldi) == k and calls == 2 + sum(a + 1 for a in arnoldi)


def test_gmres_over_several_restarts():
    """A non-symmetric operator (periodic upwind advection) at a large shift needs more than one restart of 20; the
    residual test between restarts is the true residual's, and each restart builds its full space."""
    per_dim = OPERATORS['advection-1d']
    jop, top = JaxSep(per_dim, scale=-1.0), SeparableFDOperator(per_dim, scale=-1.0)
    rhs, x0 = _rhs(jop.shape, seed=8)
    want, calls = _counted_jax_solve(jop, 'gmres', rhs, 0.5, x0, tol=1e-12)
    top.krylov_trace = []
    got = top.solve_shifted_gmres(torch.as_tensor(rhs), 0.5, torch.as_tensor(x0), tol=1e-12)
    close(got, want)
    [(_, restarts, arnoldi)] = top.krylov_trace
    assert restarts >= 2 and arnoldi[0] == 20 and calls == 2 + sum(a + 1 for a in arnoldi)


def test_gmres_breakdown_and_restart_cap_match_jax_scipy():
    """A breakdown (``2 I`` on a constant vector: the first Arnoldi vector is orthogonalized to zero, the restart
    ends after one step and solves exactly) and a cap of one restart of 3 on a diagonal system."""
    for d, restart, maxiter, arnoldi in ((np.full(16, 2.0), 20, None, [1]),
                                         (np.array([1.0, 2.0, 4.0, 8.0] * 4), 3, 1, [3])):
        b = np.ones(16)
        calls = []

        def mv(x, d=d):
            jax.debug.callback(lambda: calls.append(1), ordered=True)
            return jnp.asarray(d) * x

        want, _ = jax.scipy.sparse.linalg.gmres(mv, jnp.asarray(b), tol=1e-14, restart=restart, maxiter=maxiter)
        jax.effects_barrier()
        got, info = krylov.gmres(lambda x, d=d: torch.as_tensor(d) * x, torch.as_tensor(b), tol=1e-14,
                                 restart=restart, maxiter=maxiter)
        close(got, np.asarray(want))
        assert info.iterations == 1 and info.arnoldi == arnoldi and len(calls) == 2 + arnoldi[0] + 1


def test_complex_cg_matches_jax_scipy():
    """CG on a complex Hermitian positive definite system (jax's real-part inner products)."""
    rng = np.random.default_rng(2)
    B = rng.standard_normal((12, 12)) + 1j * rng.standard_normal((12, 12))
    A = B @ B.conj().T / 12 + np.eye(12)
    b = rng.standard_normal(12) + 1j * rng.standard_normal(12)
    want, _ = jax.scipy.sparse.linalg.cg(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), tol=1e-12)
    got, info = krylov.cg(lambda x: torch.as_tensor(A) @ x, torch.as_tensor(b), tol=1e-12)
    close(got, np.asarray(want))
    assert info.iterations >= 5


def test_sparse_operator_gmres_matches_jax():
    """``SparseFDOperator.solve_shifted_gmres``: GMRES on the assembled operator over the flattened batch."""
    per_dim = OPERATORS['dirichlet-2d']
    jop, top = JaxSparseFD(per_dim, scale=0.1), SparseFDOperator(per_dim, scale=0.1, device='cpu')
    rhs, x0 = _rhs((2, 24, 24), seed=6)
    want = jop.solve_shifted_gmres(jnp.asarray(rhs), 0.02, jnp.asarray(x0), tol=1e-10)
    reads = top.host_reads
    got = top.solve_shifted_gmres(torch.as_tensor(rhs), 0.02, torch.as_tensor(x0), tol=1e-10)
    close(got, np.asarray(want))
    assert top.host_reads > reads


# -- through the controller ------------------------------------------------------------------------------------------
HEAT = dict(nvars=(24, 24), nu=0.1, freq=2, bc='dirichlet-zero', lintol=1e-11)
ADV = dict(nvars=64, c=1.0, freq=2, stencil_type='center', order=2, lintol=1e-11)
# name -> (JAX class, port class, problem_params, dt, Tend)
RUNS = {
    'heat-CG': (JaxHeat, HeatND, dict(HEAT, solver_type='CG'), 0.01, 0.03),
    'heat-GMRES': (JaxHeat, HeatND, dict(HEAT, solver_type='GMRES'), 0.01, 0.03),
    'heat-sparse-CG': (JaxHeat, HeatND, dict(HEAT, solver_type='CG', backend='sparse'), 0.01, 0.03),
    'advection-direct': (JaxAdvection, AdvectionND, ADV, 0.005, 0.015),
    'advection-GMRES': (JaxAdvection, AdvectionND, dict(ADV, solver_type='GMRES'), 0.005, 0.015),
    'advection-CG': (JaxAdvection, AdvectionND, dict(ADV, solver_type='CG', stencil_type='upwind', order=1,
                                                     lintol=1e-8), 0.005, 0.01),
    'advection-sparse': (JaxAdvection, AdvectionND, dict(ADV, backend='sparse'), 0.005, 0.015),
}


def _description(pkg, cls, params, dt):
    return dict(problem_class=cls, problem_params=params, sweeper_class=pkg.GenericImplicit,
                sweeper_params=dict(num_nodes=3, quad_type='RADAU-RIGHT', QI='LU'),
                level_params=dict(dt=dt, restol=1e-10), step_params=dict(maxiter=20))


@functools.lru_cache(maxsize=None)
def _run(package, name, num_procs=1):
    jcls, tcls, params, dt, Tend = RUNS[name]
    if package == 'jax':
        pkg, desc = pysdc_tpu, _description(pysdc_tpu, jcls, dict(params), dt)
    else:
        pkg, desc = pysdc_tpu_torch, _description(pysdc_tpu_torch, tcls, dict(params, device='cpu'), dt)
    ctrl = (pkg.ControllerNonMPI if num_procs == 1 else pkg.ShardedController)(num_procs, {'logger_level': 40}, desc)
    prob = ctrl.MS[0].levels[0].prob
    uend, stats = ctrl.run(prob.u_exact(0.0), 0.0, Tend)
    niter = [v for _, v in pkg.get_sorted(stats, type='niter', sortby='time')]
    lane = [v for k, v in stats.items() if k.type == 'lane']
    return np.asarray(uend.numpy() if isinstance(uend, torch.Tensor) else uend), niter, prob, lane


@pytest.mark.parametrize('name', list(RUNS))
def test_iterative_problems_match_live_jax_run(name):
    want, want_niter, jprob, _ = _run('jax', name)
    got, niter, tprob, _ = _run('torch', name)
    assert niter == want_niter and len(niter) >= 2 and max(niter) <= 20  # CG on upwind advection stalls
    close(got, want)
    kind = tprob.solver_type
    if kind != 'direct' and isinstance(tprob, HeatND):
        assert tprob.work_counters[kind].niter == 3 * sum(niter) > 0  # one solve a node and sweep
    assert tprob.graph_capture_blocker is None if (kind == 'direct' and tprob.backend == 'eigen') else True


def test_iterative_solve_is_per_step_on_the_block_controller():
    """``HeatND(solver_type='CG')`` through ``ShardedController(2)``: the fused lane refuses the iterative solve by
    name (``'auto'`` takes the stage lane), whose solves run step by step, each with its own stopping test, as
    ``jax.vmap`` gives the JAX package's block (there on its fused lane)."""
    want, want_niter, _, want_lane = _run('jax', 'heat-CG', 2)
    got, niter, tprob, lane = _run('torch', 'heat-CG', 2)
    assert want_lane == ['fused'] and lane == ['stage']
    assert niter == want_niter
    close(got, want)
    assert 'CG' in tprob.graph_capture_blocker
