"""The first-order sweepers of the PyTorch port against the JAX package (float64, CPU).

``MultiImplicitSweeper`` on the multi-implicit Allen-Cahn and Gray-Scott
problems at 32^2 (equal ``niter``, ``uend`` to 1e-10), and through the block
controller's fused lane; ``LinearizedImplicitParallel`` in the three
configurations of tests/test_linearized_sweeper.py:42-46 and its fixed-point
case (:32); each multistep class on ``Logistic``; ``ExplicitSweeper`` on
``Dahlquist`` and ``HeatND`` 32^2; each ODE of ``models/odes.py`` that came
with this slice (and ``Dahlquist``): ``eval_f`` and ``solve_system`` at a
seeded state.  The fused lanes refuse the sweepers whose sweeps a CUDA graph
cannot hold, by name.
"""

import numpy as np
import pytest
import torch

import pysdc_tpu
import pysdc_tpu_torch
from pysdc_tpu.models import allen_cahn as jac
from pysdc_tpu.models import dahlquist as jdahl
from pysdc_tpu.models import fisher as jfisher
from pysdc_tpu.models import gray_scott as jgs
from pysdc_tpu.models import heat as jheat
from pysdc_tpu.models import odes as jodes
from pysdc_tpu.sweepers import multistep as jms
from pysdc_tpu.sweepers.explicit import ExplicitSweeper as JaxExplicit
from pysdc_tpu.sweepers.linearized import LinearizedImplicitParallel as JaxLinearized
from pysdc_tpu.sweepers.multi_implicit import MultiImplicitSweeper as JaxMultiImplicit
from pysdc_tpu_torch import ExplicitSweeper, GenericImplicit, LinearizedImplicitParallel, MultiImplicitSweeper
from pysdc_tpu_torch.core.errors import ControllerError, ParameterError, ProblemError
from pysdc_tpu_torch.models import allen_cahn as tac
from pysdc_tpu_torch.models import dahlquist as tdahl
from pysdc_tpu_torch.models import fisher as tfisher
from pysdc_tpu_torch.models import gray_scott as tgs
from pysdc_tpu_torch.models import heat as theat
from pysdc_tpu_torch.models import odes as todes
from pysdc_tpu_torch.ops.kernels import stencil
from pysdc_tpu_torch.parallel import fused
from pysdc_tpu_torch.sweepers import multistep as tms
from pysdc_tpu_torch.utils.convert import to_numpy, to_torch

torch.set_num_threads(1)

MULTI = dict(num_nodes=3, quad_type='RADAU-RIGHT', Q1='LU', Q2='LU')


def _desc(pkg, problem_class, problem_params, sweeper_class, sweeper_params, level_params, maxiter):
    if pkg is pysdc_tpu_torch:
        problem_params = dict(problem_params, device='cpu')
    return dict(problem_class=problem_class, problem_params=problem_params, sweeper_class=sweeper_class,
                sweeper_params=sweeper_params, level_params=level_params, step_params=dict(maxiter=maxiter))


def _run(pkg, classes, problem_params, sweeper_classes, sweeper_params, level_params, Tend, maxiter=1):
    """``ControllerNonMPI(1)`` of ``pkg`` on the problem and sweeper of ``classes`` / ``sweeper_classes`` (the JAX
    package's first, the port's second): ``(uend, niter)``."""
    side = 0 if pkg is pysdc_tpu else 1
    desc = _desc(pkg, classes[side], problem_params, sweeper_classes[side], sweeper_params, level_params, maxiter)
    ctrl = pkg.ControllerNonMPI(1, {'logger_level': 40}, desc)
    prob = ctrl.MS[0].levels[0].prob
    uend, stats = ctrl.run(prob.u_exact(0.0), 0.0, Tend)
    return np.asarray(to_numpy(uend)), [v for _, v in pkg.get_sorted(stats, type='niter')]


def _parity(classes, problem_params, sweepers, sweeper_params, level_params, Tend, maxiter=1, tol=1e-10):
    want, it_want = _run(pysdc_tpu, classes, problem_params, sweepers, sweeper_params, level_params, Tend, maxiter)
    got, it_got = _run(pysdc_tpu_torch, classes, problem_params, sweepers, sweeper_params, level_params, Tend, maxiter)
    assert it_got == it_want and len(it_got) >= 2
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    return got, it_got


# -- multi-implicit ----------------------------------------------------------
@pytest.mark.parametrize('name, classes, params, level, Tend', [
    # examples/step_20_allen_cahn_campaign.py:65 at 32^2
    ('allen-cahn', (jac.AllenCahnPeriodicMultiImplicitND, tac.AllenCahnPeriodicMultiImplicitND),
     dict(nvars=(32, 32), eps=0.04, radius=0.25, newton_tol=1e-10), dict(dt=2e-4, restol=1e-8), 8e-4),
    # examples/step_14_sdc_showdown.py:69-74 at 32^2
    ('gray-scott', (jgs.GrayScottMultiImplicit, tgs.GrayScottMultiImplicit),
     dict(nvars=(32, 32), newton_tol=1e-11), dict(dt=1.0, restol=1e-9), 2.0),
    ('gray-scott-linear', (jgs.GrayScottMultiImplicitLinear, tgs.GrayScottMultiImplicitLinear),
     dict(nvars=(32, 32), newton_tol=1e-11), dict(dt=1.0, restol=1e-9), 2.0),
])
def test_multi_implicit_matches_jax(name, classes, params, level, Tend):
    _, niter = _parity(classes, params, (JaxMultiImplicit, MultiImplicitSweeper), MULTI, level, Tend, maxiter=50)
    assert 1 < max(niter) < 50


def test_multi_implicit_allen_cahn_block_fused_lane():
    """``ShardedController(4).run``: ``'auto'`` takes the fused lane, as the JAX package does for this
    configuration, and it equals the stage lane."""
    desc = _desc(pysdc_tpu_torch, None, dict(nvars=(32, 32), eps=0.04, radius=0.25, newton_tol=1e-10), MultiImplicitSweeper,
                 MULTI, dict(dt=2e-4, restol=1e-8), 12)
    desc['problem_class'] = tac.AllenCahnPeriodicMultiImplicitND
    runs = {}
    for lane in ('auto', 'stage'):
        ctrl = pysdc_tpu_torch.ShardedController(4, {'logger_level': 40}, desc)
        uend, stats = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, 8e-4, lane=lane)
        runs[lane] = (uend, stats)
    lanes = [v for k, v in runs['auto'][1].items() if k.type == 'lane']
    niter = {lane: [v for _, v in pysdc_tpu_torch.get_sorted(s, type='niter')] for lane, (_, s) in runs.items()}
    assert lanes == ['fused'] and niter['auto'] == niter['stage'] and len(niter['auto']) == 4
    assert float((runs['auto'][0] - runs['stage'][0]).abs().max()) <= 1e-10


# -- Newton-linearized ---------------------------------------------------------------
FISHER = dict(nvars=127, nu=1.0, lambda0=2.0, newton_tol=1e-12)


@pytest.mark.parametrize('cfg', [
    dict(jacobian=0, basis='Q'),  # linearized_implicit_fixed_parallel
    dict(jacobian=0, basis='QI', QI='LU'),  # ..._fixed_parallel_prec
    dict(jacobian='per_node', basis='QI', QI='LU'),  # linearized_implicit_parallel
])
def test_linearized_fisher_matches_jax(cfg):
    got, niter = _parity((jfisher.GeneralizedFisher1D, tfisher.GeneralizedFisher1D), FISHER,
                         (JaxLinearized, LinearizedImplicitParallel), dict(num_nodes=3, quad_type='RADAU-RIGHT', **cfg),
                         dict(dt=0.01, restol=1e-10), 0.05, maxiter=50)
    prob = tfisher.GeneralizedFisher1D(device='cpu', **FISHER)
    assert max(niter) < 50 and np.abs(got - to_numpy(prob.u_exact(0.05))).max() < 5e-6


def test_linearized_fixed_point_matches_jax_and_generic_implicit():
    """tests/test_linearized_sweeper.py:32: Newton-SDC and LU-SDC reach the same collocation solution."""
    classes = (jodes.VanDerPol, todes.VanDerPol)
    pp = dict(mu=2.0, newton_tol=1e-12)
    level = dict(dt=0.05, restol=1e-10)
    got, _ = _parity(classes, pp, (JaxLinearized, LinearizedImplicitParallel),
                     dict(num_nodes=3, quad_type='RADAU-RIGHT', jacobian=0, basis='Q'), level, 0.25, maxiter=50)
    ref, _ = _run(pysdc_tpu_torch, classes, pp, (None, GenericImplicit), dict(num_nodes=3, quad_type='RADAU-RIGHT',
                                                                               QI='LU'), level, 0.25, maxiter=50)
    assert np.abs(got - ref).max() < 1e-8


def test_linearized_rejects_bad_params_and_names_eval_jacobian(monkeypatch):
    with pytest.raises(ParameterError):
        LinearizedImplicitParallel(dict(num_nodes=3, jacobian=7))
    with pytest.raises(ParameterError):
        LinearizedImplicitParallel(dict(num_nodes=3, basis='S'))
    # on the card K1 refuses a torch.func transform's tensor: stand that refusal in for the CPU's plain version
    plain = stencil._roll_cross_2d

    def refusing(u, terms):
        if stencil._is_traced(u):
            raise stencil.KernelTraceError('K1 under a transform')
        return plain(u, terms)

    monkeypatch.setattr(stencil, '_roll_cross_2d', refusing)
    prob = tac.AllenCahnPeriodicSemiImplicitND(nvars=(16, 16), device='cpu')
    u = prob.u_exact(0.0)
    assert torch.equal(prob.A.apply(u), plain(u, prob.A._cross_terms))

    class NoJacobian:
        def __init__(self, prob):
            self.prob, self.shape = prob, prob.shape

        def eval_f(self, u, t):
            return self.prob.A.apply(u)

    with pytest.raises(ProblemError, match='eval_jacobian'):
        LinearizedImplicitParallel._jac(NoJacobian(prob), u.unsqueeze(0), 0.0)


# -- multistep -------------------------------------------------------------------------
@pytest.mark.parametrize('name', ['AdamsBashforthExplicit1Step', 'BackwardEulerMultiStep', 'AdamsMoultonImplicit1Step',
                                  'AdamsMoultonImplicit2Step'])
def test_multistep_logistic_matches_jax(name):
    got, _ = _parity((jodes.Logistic, todes.Logistic), dict(u0=0.5, lam=2.0, newton_tol=1e-14),
                     (getattr(jms, name), getattr(tms, name)), {}, dict(dt=0.1), 1.0, tol=1e-13)
    exact = to_numpy(todes.Logistic(u0=0.5, lam=2.0, device='cpu').u_exact(1.0))
    assert np.abs(got - exact).max() < 0.05


def test_multistep_history_and_level_flags():
    sweep = tms.AdamsMoultonImplicit2Step({})
    assert sweep.host_stateful and sweep.is_direct_solver and sweep.steps == 2 and sweep.coll.num_nodes == 1
    desc = _desc(pysdc_tpu_torch, todes.Logistic, dict(u0=0.5, lam=2.0), tms.AdamsMoultonImplicit2Step, {},
                 dict(dt=0.1, restol=1e-10), 1)
    ctrl = pysdc_tpu_torch.ControllerNonMPI(1, {'logger_level': 40}, desc)
    lvl = ctrl.MS[0].levels[0]
    assert lvl.host_stateful and lvl.params.restol == -1.0
    ctrl.run(lvl.prob.u_exact(0.0), 0.0, 0.3)
    times = lvl.sweep.history.column(0)
    assert lvl.sweep.history.full and np.allclose(times, [0.2, 0.3])
    lvl.sweep.reset_history()
    assert lvl.sweep.history.empty


@pytest.mark.parametrize('kind', ['multistep', 'linearized'])
def test_fused_lanes_refuse_what_a_graph_cannot_hold(kind):
    """The JAX package's fused lanes take these sweepers; the port's refuse them by name before any capture and
    ``run()`` takes the stage lane (ROADMAP queue 3)."""
    if kind == 'multistep':
        desc = _desc(pysdc_tpu_torch, todes.Logistic, dict(u0=0.5, lam=2.0), tms.BackwardEulerMultiStep, {},
                     dict(dt=0.1), 1)
        match = 'multistep'
    else:
        desc = _desc(pysdc_tpu_torch, todes.VanDerPol, dict(mu=2.0), LinearizedImplicitParallel,
                     dict(num_nodes=3, quad_type='RADAU-RIGHT'), dict(dt=0.05, restol=1e-10), 10)
        match = 'torch.linalg.solve'
    ctrl = pysdc_tpu_torch.ShardedController(1, {'logger_level': 40}, desc)
    with pytest.raises(ControllerError, match=match):
        fused.check_fused_eligibility(ctrl)
    with pytest.raises(ControllerError, match=match):
        ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, 0.2, lane='fused')
    _, stats = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, 0.2)
    assert [v for k, v in stats.items() if k.type == 'lane'] == ['stage']


# -- explicit --------------------------------------------------------------------------
@pytest.mark.parametrize('name, classes, params, level, Tend', [
    ('dahlquist', (jdahl.Dahlquist, tdahl.Dahlquist), dict(lambdas=np.array([-1.0 + 1j, -0.5, -2.0j])),
     dict(dt=0.1, restol=1e-12), 0.5),
    ('heat', (jheat.HeatND, theat.HeatND), dict(nvars=(32, 32), nu=0.1, freq=2, bc='periodic'),
     dict(dt=1e-4, restol=1e-10), 4e-4),
])
def test_explicit_matches_jax(name, classes, params, level, Tend):
    _parity(classes, params, (JaxExplicit, ExplicitSweeper), dict(num_nodes=3, quad_type='RADAU-RIGHT'), level, Tend,
            maxiter=30, tol=1e-11)


# -- the ODEs of models/odes.py and the Dahlquist problems ---------------------------
ODES = {
    'Lorenz': {}, 'Logistic': dict(lam=2.0), 'Auzinger': {}, 'DiscontinuousTestODE': {}, 'ProtheroRobinson': {},
    'ProtheroRobinsonNonLinear': {}, 'ProtheroRobinsonAutonomous': dict(non_linear=True), 'Kaps': {},
    'ChemicalReaction3Var': {}, 'JacobiElliptic': {}, 'NonlinearODE1': {}, 'PolynomialTestEquation': dict(degree=3),
    'PolynomialTestEquationIMEX': dict(degree=3),
}
SCIPY = ('Lorenz', 'ChemicalReaction3Var', 'JacobiElliptic')


@pytest.mark.parametrize('name', sorted(ODES))
def test_ode_eval_f_and_solve_match_jax(name):
    jprob = getattr(jodes, name)(**ODES[name])
    tprob = getattr(todes, name)(device='cpu', **ODES[name])
    rng = np.random.default_rng(sum(map(ord, name)))
    u = np.asarray(jprob.u_exact(0.0)) + 0.05 * rng.standard_normal(jprob.shape)
    if name == 'NonlinearODE1':
        u = np.abs(u)  # below u = 1, where the root is smooth
    t, factor = 0.3, 0.02
    want, got = jprob.eval_f(u, t), tprob.eval_f(to_torch(u, 'cpu'), t)
    for a, b in zip(want if isinstance(want, tuple) else (want,), got if isinstance(got, tuple) else (got,)):
        np.testing.assert_allclose(to_numpy(b), np.asarray(a), rtol=1e-14, atol=1e-14)
    rhs = u + 0.01 * rng.standard_normal(u.shape)
    want = np.asarray(jprob.solve_system(rhs, factor, u, t))
    got = to_numpy(tprob.solve_system(to_torch(rhs, 'cpu'), factor, to_torch(u, 'cpu'), t))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # the scipy references (Lorenz, ChemicalReaction3Var, JacobiElliptic) are held at their start only
    for s in (0.0,) if name in SCIPY else (0.0, 0.7):
        np.testing.assert_allclose(to_numpy(tprob.u_exact(s)), np.asarray(jprob.u_exact(s)), rtol=1e-12, atol=1e-14)


def test_ode_batches_and_switching():
    """eval_f over a batch of systems with one time each (a block's time axis) equals the systems one by one; the
    event of DiscontinuousTestODE shows in its switching information."""
    prob = todes.ProtheroRobinsonAutonomous(device='cpu')
    u = torch.as_tensor(np.random.default_rng(2).standard_normal((4, 2)))
    t = torch.linspace(0.0, 0.3, 4, dtype=torch.float64)
    batched = prob.eval_f(u, t)
    assert torch.allclose(batched, torch.stack([prob.eval_f(u[i], float(t[i])) for i in range(4)]), atol=0, rtol=0)
    pr = todes.ProtheroRobinson(device='cpu')
    batched = pr.eval_f(u[:, :1], t)
    assert torch.allclose(batched, torch.stack([pr.eval_f(u[i, :1], float(t[i])) for i in range(4)]), rtol=1e-15)
    disc = todes.DiscontinuousTestODE(device='cpu')
    nodes = [torch.tensor([4.0]), torch.tensor([4.9]), torch.tensor([5.2])]
    assert disc.get_switching_info(nodes, 0.0)[:2] == (True, 1)
    assert float(disc.eval_f(torch.tensor([5.5]), 0.0)) == pytest.approx(4.0 / disc.t_star)


@pytest.mark.parametrize('imex', [False, True])
def test_dahlquist_matches_jax(imex):
    rng = np.random.default_rng(5)
    lam = rng.uniform(-3, 0, 6) + 1j * rng.uniform(-2, 2, 6)
    if imex:
        jprob, tprob = jdahl.DahlquistIMEX(lam, 0.5j * lam.imag), tdahl.DahlquistIMEX(lam, 0.5j * lam.imag, device='cpu')
    else:
        jprob, tprob = jdahl.Dahlquist(lam), tdahl.Dahlquist(lam, device='cpu')
    assert tprob.dtype == torch.complex128
    u = rng.standard_normal(6) + 1j * rng.standard_normal(6)
    want, got = jprob.eval_f(u, 0.0), tprob.eval_f(to_torch(u, 'cpu'), 0.0)
    for a, b in zip(want if imex else (want,), got if imex else (got,)):
        np.testing.assert_allclose(to_numpy(b), np.asarray(a), rtol=1e-15)
    np.testing.assert_allclose(to_numpy(tprob.solve_system(to_torch(u, 'cpu'), 0.1, None, 0.0)),
                               np.asarray(jprob.solve_system(u, 0.1, None, 0.0)), rtol=1e-15)
    np.testing.assert_allclose(to_numpy(tprob.u_exact(0.7)), np.asarray(jprob.u_exact(0.7)), rtol=1e-14)
    rhs = to_torch(np.stack([u, 2 * u]), 'cpu')
    batched = tprob.solve_system_batched(rhs, np.array([0.1, 0.2]), rhs, None)
    assert torch.allclose(batched[1], tprob.solve_system(rhs[1], 0.2, None, 0.0), rtol=1e-15)
    assert tdahl.Dahlquist(lam, dtype=torch.complex64, device='cpu').u_exact(0.1).dtype == torch.complex64
