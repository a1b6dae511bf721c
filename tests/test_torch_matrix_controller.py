"""``parallel/matrix_controller.py`` of the port against the JAX package's (tests/test_matrix_controller.py).

The four cases of ``tests/test_matrix_controller.py`` run through both
packages on the CPU, float64: the matrix controller's ``niter`` equals the JAX
matrix controller's and the port's step-based controller's exactly, and
``uend`` agrees with both to roundoff; the propagation matrix (assembled on the
problem's device with ``torch.kron``) reproduces the run and the JAX matrix.
The JAX runs are made once, in one module fixture.
"""

import numpy as np
import pytest
import torch

from pysdc_tpu.models.heat import HeatND as JaxHeat
from pysdc_tpu.parallel.matrix_controller import ControllerMatrixNonMPI as JaxMatrix
from pysdc_tpu.sweepers.generic_implicit import GenericImplicit as JaxImplicit
from pysdc_tpu.utils.stats import get_sorted as jax_sorted
from pysdc_tpu_torch.core.errors import ControllerError
from pysdc_tpu_torch.models.heat import HeatND
from pysdc_tpu_torch.parallel.matrix_controller import ControllerMatrixNonMPI, dense_from_apply
from pysdc_tpu_torch.parallel.nonmpi import ControllerNonMPI
from pysdc_tpu_torch.sweepers.generic_implicit import GenericImplicit
from pysdc_tpu_torch.sweepers.imex import IMEXSweeper
from pysdc_tpu_torch.utils.stats import get_sorted

torch.set_num_threads(1)

CP = {'logger_level': 40, 'all_to_done': True, 'mssdc_jac': True}
ROUNDOFF = 1e-12


def _desc(problem_class, sweeper_class, problem=None, **over):
    d = dict(
        problem_class=problem_class,
        problem_params=dict(nvars=[63, 31], nu=0.1, freq=4, bc='dirichlet-zero', **(problem or {})),
        sweeper_class=sweeper_class,
        sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=[3], QI='LU', initial_guess='spread'),
        level_params=dict(restol=1e-8, dt=0.25),
        step_params=dict(maxiter=50),
        space_transfer_params=dict(rorder=2, iorder=2),
    )
    d.update(over)
    return d


def _niter(stats, sort):
    return [v for _, v in sort(stats, type='niter')]


CASES = {
    'pfasst': (4, {}),
    'single': (1, dict(problem_params=dict(nvars=63, nu=0.1, freq=4, bc='dirichlet-zero'))),
    'propagation': (4, dict(level_params=dict(restol=-1, dt=0.25), step_params=dict(maxiter=5))),
}


def _torch_desc(over):
    over = dict(over)
    if 'problem_params' in over:
        over['problem_params'] = dict(over['problem_params'], device='cpu')
        return _desc(HeatND, GenericImplicit, **over)
    return _desc(HeatND, GenericImplicit, problem=dict(device='cpu'), **over)


@pytest.fixture(scope='module')
def jax_runs():
    out = {}
    for name, (procs, over) in CASES.items():
        cm = JaxMatrix(procs, CP, _desc(JaxHeat, JaxImplicit, **over))
        P = cm.MS[0].levels[0].prob
        uend, stats = cm.run(P.u_exact(0.0), 0.0, 1.0)
        out[name] = (np.asarray(uend), _niter(stats, jax_sorted))
        if name == 'propagation':
            out['matrix'] = cm.build_propagation_matrix(niter=5)
    return out


def _matrix_and_step_runs(name):
    procs, over = CASES[name]
    desc = _torch_desc(over)
    cm = ControllerMatrixNonMPI(procs, CP, desc)
    P = cm.MS[0].levels[0].prob
    um, sm = cm.run(P.u_exact(0.0), 0.0, 1.0)
    cs = ControllerNonMPI(procs, CP, desc)
    us, ss = cs.run(P.u_exact(0.0), 0.0, 1.0)
    return cm, P, (um, _niter(sm, get_sorted)), (us, _niter(ss, get_sorted))


def test_matrix_pfasst_matches_step_controller(jax_runs):
    _, P, (um, niter_m), (us, niter_s) = _matrix_and_step_runs('pfasst')
    want_u, want_niter = jax_runs['pfasst']
    assert niter_m == niter_s == want_niter
    assert float((um - us).abs().max()) < ROUNDOFF
    np.testing.assert_allclose(um.numpy(), want_u, rtol=0, atol=ROUNDOFF)
    assert float((um - P.u_exact(1.0)).abs().max()) < 1e-5


def test_matrix_sdc_single_level_single_step(jax_runs):
    _, _, (um, niter_m), (us, niter_s) = _matrix_and_step_runs('single')
    want_u, want_niter = jax_runs['single']
    assert niter_m == niter_s == want_niter
    assert float((um - us).abs().max()) < ROUNDOFF
    np.testing.assert_allclose(um.numpy(), want_u, rtol=0, atol=ROUNDOFF)


def test_propagation_matrix_reproduces_run(jax_runs):
    procs, over = CASES['propagation']
    cm = ControllerMatrixNonMPI(procs, CP, _torch_desc(over))
    P = cm.MS[0].levels[0].prob
    uend, stats = cm.run(P.u_exact(0.0), 0.0, 1.0)
    assert _niter(stats, get_sorted) == [5, 5, 5, 5] == jax_runs['propagation'][1]
    mat = cm.build_propagation_matrix(niter=5)
    assert float((mat @ P.u_exact(0.0).reshape(-1) - uend.reshape(-1)).abs().max()) < ROUNDOFF
    np.testing.assert_allclose(mat.numpy(), jax_runs['matrix'], rtol=0, atol=ROUNDOFF)
    np.testing.assert_allclose(uend.numpy(), jax_runs['propagation'][0], rtol=0, atol=ROUNDOFF)


def test_matrix_controller_rejects_wrong_sweeper():
    with pytest.raises(ControllerError, match='GenericImplicit'):
        ControllerMatrixNonMPI(2, CP, _desc(HeatND, IMEXSweeper, problem=dict(device='cpu')))
    with pytest.raises(ControllerError, match='predictor'):
        ControllerMatrixNonMPI(2, dict(CP, predict_type='pfasst_burnin'), _torch_desc({}))


def test_dense_from_apply_of_a_k1_operator_is_one_batched_launch(monkeypatch):
    """On a 2D periodic problem the operator's columns come from one mapped apply (K1's vmap rule)."""
    from pysdc_tpu_torch.ops.kernels import stencil

    shapes = []
    plain = stencil._plain

    def counting(u, terms, path=None):
        shapes.append(tuple(u.shape))
        return plain(u, terms, path)

    monkeypatch.setattr(stencil, '_plain', counting)
    prob = HeatND(nvars=(8, 8), nu=0.1, freq=2, bc='periodic', device='cpu')
    A = dense_from_apply(lambda v: prob.eval_f(v.reshape(8, 8), 0.0).reshape(-1), 64, device='cpu')
    assert shapes == [(64, 8, 8)]
    eye = torch.eye(64, dtype=torch.float64).reshape(64, 8, 8)
    assert torch.equal(A, plain(eye, prob.A._cross_terms).reshape(64, 64).T)


def test_dense_from_apply_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """Like every entry point of the port, ``dense_from_apply`` defaults to CUDA: without a card it raises
    instead of building the identity on the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dense_from_apply(lambda v: 2.0 * v, 4)
    assert torch.equal(dense_from_apply(lambda v: 2.0 * v, 4, device='cpu'), 2.0 * torch.eye(4, dtype=torch.float64))
