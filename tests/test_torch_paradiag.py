"""ParaDiag of the PyTorch port against the JAX package (float64, CPU).

Each case of tests/test_paradiag.py (the mesh case is in
tests/test_torch_mesh.py) and the golden configuration of
tests/test_golden_regression.py:138-153 run through both packages'
``ParaDiagController``: equal ``niter`` per step, ``uend`` to 1e-12, and the
stats entries equal by type, step and iteration (residuals to rtol 1e-8 above
an absolute floor of 1e-12: the weighted DFT scales step l of the block by
alpha^(-l/L), up to 1e3 at alpha 1e-4 and L 4, and back, so the residual of a
converged O(1) block is rounding of some 1e-13; 4.8e-13 apart at most here).  The coefficient
tables against the JAX functions to 1e-14; the batched complex solves against
the JAX ``solve_jacobian``; the complex route of kernel K1 (the interleaved
real view with doubled y taps, through the plain version on the CPU) against
complex rolls to 1e-15 relative.
"""

import functools

import numpy as np
import pytest
import torch

import pysdc_tpu
import pysdc_tpu_torch
from pysdc_tpu.models import dahlquist as jdahl
from pysdc_tpu.models import heat as jheat
from pysdc_tpu.models import odes as jodes
from pysdc_tpu.parallel import paradiag as jpd
from pysdc_tpu.sweepers.paradiag import QDiagonalization as JaxQDiag
from pysdc_tpu_torch import ControllerNonMPI, GenericImplicit, ParaDiagController, QDiagonalization
from pysdc_tpu_torch.core.errors import ControllerError, ParameterError
from pysdc_tpu_torch.models import dahlquist as tdahl
from pysdc_tpu_torch.models import heat as theat
from pysdc_tpu_torch.models import odes as todes
from pysdc_tpu_torch.ops.collocation import get_collocation
from pysdc_tpu_torch.ops.fd import get_finite_difference_stencil
from pysdc_tpu_torch.ops.kernels import stencil
from pysdc_tpu_torch.parallel import paradiag as tpd
from pysdc_tpu_torch.utils.convert import to_numpy, to_torch

torch.set_num_threads(1)

LAMS = tuple(np.linspace(-8, -0.2, 16))
# name -> (problem classes (JAX, port), problem params, L, alpha, dt, restol, maxiter, Tend, sweeper class given)
CASES = {
    # tests/test_paradiag.py:29
    'dahlquist': ((jdahl.Dahlquist, tdahl.Dahlquist), dict(lambdas=np.array(LAMS), u0=1.0), 4, 1e-4, 0.1, 1e-10, 20,
                  0.4, True),
    # tests/test_paradiag.py:47
    'heat': ((jheat.HeatND, theat.HeatND), dict(nvars=64, nu=0.1, freq=2, bc='periodic'), 4, 1e-4, 0.05, 1e-10, 20,
             0.2, True),
    # tests/test_paradiag.py:57, both alphas
    'rate-1e-2': ((jdahl.Dahlquist, tdahl.Dahlquist), dict(lambdas=np.linspace(-4, -0.5, 8), u0=1.0), 4, 1e-2, 0.1,
                  1e-11, 20, 0.4, True),
    'rate-1e-6': ((jdahl.Dahlquist, tdahl.Dahlquist), dict(lambdas=np.linspace(-4, -0.5, 8), u0=1.0), 4, 1e-6, 0.1,
                  1e-11, 20, 0.4, True),
    # tests/test_paradiag.py:70
    'van-der-pol': ((jodes.VanDerPol, todes.VanDerPol), dict(mu=1.0, u0=(2.0, 0.0), newton_tol=1e-12), 4, 1e-3, 0.02,
                    1e-10, 50, 0.4, True),
    # tests/test_golden_regression.py:138-153: the controller's default sweeper class
    'golden-heat': ((jheat.HeatND, theat.HeatND), dict(nvars=64, nu=0.1, freq=2, bc='periodic'), 4, 1e-4, 0.05, 1e-10,
                    50, 0.2, False),
    # the 2D periodic block: the operator applies through K1's complex route (its plain version here), 2 blocks
    'heat-2d': ((jheat.HeatND, theat.HeatND), dict(nvars=(16, 16), nu=0.1, freq=4, bc='periodic'), 4, 1e-4, 0.01,
                1e-10, 20, 0.08, True),
}


def _description(pkg, case):
    classes, params, L, alpha, dt, restol, maxiter, Tend, with_sweeper = CASES[case]
    side = 0 if pkg is pysdc_tpu else 1
    if side:
        params = dict(params, device='cpu')
    desc = dict(problem_class=classes[side], problem_params=params,
                sweeper_params=dict(num_nodes=3, quad_type='RADAU-RIGHT'),
                level_params=dict(dt=dt, restol=restol), step_params=dict(maxiter=maxiter))
    if with_sweeper:
        desc['sweeper_class'] = JaxQDiag if side == 0 else QDiagonalization
    return desc


@functools.lru_cache(maxsize=None)
def _run(package, case):
    pkg = pysdc_tpu if package == 'jax' else pysdc_tpu_torch
    classes, params, L, alpha, dt, restol, maxiter, Tend, _ = CASES[case]
    ctrl = pkg.ParaDiagController(L, {'logger_level': 40, 'alpha': alpha}, _description(pkg, case))
    prob = ctrl.template.levels[0].prob
    u0 = _run('jax', case)['u0'] if package == 'torch' else np.asarray(prob.u_exact(0.0))
    uend, stats = ctrl.run(to_torch(u0, 'cpu') if package == 'torch' else u0, 0.0, Tend)
    exact = prob.u_exact(Tend) if case in ('heat', 'golden-heat', 'heat-2d', 'van-der-pol') else None
    entries = {(k.type, k.process, k.iter, round(k.time, 12)): v for k, v in stats.items()}
    return dict(u0=u0, uend=np.asarray(to_numpy(uend)), niter=[v for _, v in pkg.get_sorted(stats, type='niter')],
                entries=entries, exact=None if exact is None else np.asarray(to_numpy(exact)))


@pytest.mark.parametrize('case', list(CASES))
def test_paradiag_matches_jax(case):
    want, got = _run('jax', case), _run('torch', case)
    assert got['niter'] == want['niter'] and len(got['niter']) >= 4
    np.testing.assert_allclose(got['uend'], want['uend'], rtol=0, atol=1e-12)
    assert set(got['entries']) == set(want['entries'])
    for key, value in want['entries'].items():
        if key[0] in ('niter', 'restart', 'dt'):
            assert got['entries'][key] == value, key
        elif key[0].startswith('residual'):
            np.testing.assert_allclose(got['entries'][key], value, rtol=1e-8, atol=1e-12)


def test_paradiag_gates_of_the_reference_tests():
    """What tests/test_paradiag.py asserts, on the port's runs."""
    assert max(_run('torch', 'dahlquist')['niter']) <= 5
    for case, bound in (('heat', 1e-7), ('van-der-pol', 1e-6)):
        run = _run('torch', case)
        assert np.abs(run['uend'] - run['exact']).max() < bound, case
    assert max(_run('torch', 'heat')['niter']) <= 5
    assert max(_run('torch', 'rate-1e-6')['niter']) < max(_run('torch', 'rate-1e-2')['niter'])
    run = _run('torch', 'golden-heat')
    assert np.abs(run['uend'] - run['exact']).max() < 1e-7


def test_paradiag_matches_serial_sdc():
    """tests/test_paradiag.py:29-44 on the port: ParaDiag and serial SDC (GenericImplicit, M=3 LU) agree."""
    desc = _description(pysdc_tpu_torch, 'dahlquist')
    desc.update(sweeper_class=GenericImplicit, sweeper_params=dict(num_nodes=3, QI='LU'))
    serial = ControllerNonMPI(1, {'logger_level': 40}, desc)
    us, _ = serial.run(to_torch(_run('jax', 'dahlquist')['u0'], 'cpu'), 0.0, 0.4)
    assert np.abs(_run('torch', 'dahlquist')['uend'] - us.numpy()).max() < 1e-9


def test_paradiag_parameters_and_the_mesh():
    desc = _description(pysdc_tpu_torch, 'dahlquist')
    with pytest.raises(ParameterError):
        ParaDiagController(4, {'logger_level': 40}, desc)
    with pytest.raises(NotImplementedError):
        ParaDiagController(4, {'logger_level': 40, 'alpha': 1e-4, 'all_to_done': False}, desc)
    with pytest.raises(ControllerError, match='mesh must be a pysdc_tpu_torch.parallel.mesh.Mesh'):
        ParaDiagController(4, {'logger_level': 40, 'alpha': 1e-4}, desc, mesh='a mesh')
    with pytest.raises(ControllerError):
        ParaDiagController(4, {'logger_level': 40, 'alpha': 1e-4},
                           dict(desc, sweeper_params=dict(num_nodes=[3, 2], quad_type='RADAU-RIGHT')))
    with pytest.raises(ParameterError):
        tpd.get_G_inv_matrices(4, 3, 1e-4, get_collocation(3, 'LEGENDRE', 'RADAU-LEFT'))
    # the default sweeper class, and the tables on the field's device in its complex precision
    desc32 = _description(pysdc_tpu_torch, 'heat')
    desc32.pop('sweeper_class')
    desc32['problem_params'] = dict(desc32['problem_params'], dtype=torch.float32)
    ctrl = ParaDiagController(4, {'logger_level': 40, 'alpha': 1e-4}, desc32)
    assert isinstance(ctrl.template.levels[0].sweep, QDiagonalization)
    assert {t.dtype for t in ctrl._tables.values()} == {torch.complex64}


@pytest.mark.parametrize('L, alpha, M, quad', [(4, 1e-4, 3, 'RADAU-RIGHT'), (8, 1e-2, 2, 'RADAU-RIGHT'),
                                               (5, 1e-6, 4, 'LOBATTO')])
def test_coefficient_tables_match_jax(L, alpha, M, quad):
    from pysdc_tpu.ops.collocation import get_collocation as jax_collocation

    np.testing.assert_allclose(tpd.get_fft_matrix(L), jpd.get_fft_matrix(L), rtol=0, atol=1e-14)
    for got, want in zip(tpd.get_weighted_fft_matrices(L, alpha), jpd.get_weighted_fft_matrices(L, alpha)):
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)
    got = tpd.get_G_inv_matrices(L, M, alpha, get_collocation(M, 'LEGENDRE', quad))
    want = jpd.get_G_inv_matrices(L, M, alpha, jax_collocation(M, 'LEGENDRE', quad))
    assert len(got) == len(want) == L
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-14, atol=1e-14)


def test_batched_jacobian_solves_match_jax():
    """``solve_jacobian_batched`` (one complex shift and time per step and node) against the JAX package's
    ``solve_jacobian`` system by system: HeatND 2D (one transform pair), Dahlquist, VanDerPol (one batched
    complex solve, the Jacobian at the averaged state) to 1e-13."""
    rng = np.random.default_rng(11)
    L, M = 3, 2
    factors = 0.01 * (rng.standard_normal((L, M)) + 1j * rng.standard_normal((L, M)))
    ts = rng.uniform(0, 1, (L, M))
    cases = [
        (jheat.HeatND(nvars=(8, 8), nu=0.1), theat.HeatND(nvars=(8, 8), nu=0.1, device='cpu'), None),
        (jdahl.Dahlquist(lambdas=np.array(LAMS)), tdahl.Dahlquist(lambdas=np.array(LAMS), device='cpu'), None),
        (jodes.VanDerPol(mu=1.0), todes.VanDerPol(mu=1.0, device='cpu'), np.array([0.7, -0.3])),
    ]
    for jprob, tprob, u in cases:
        shape = jprob.shape
        rhs = rng.standard_normal((L, M) + shape) + 1j * rng.standard_normal((L, M) + shape)
        got = tprob.solve_jacobian_batched(torch.as_tensor(rhs), torch.as_tensor(factors),
                                           None if u is None else torch.as_tensor(u), ts)
        looped = super(type(tprob), tprob).solve_jacobian_batched(
            torch.as_tensor(rhs), torch.as_tensor(factors), None if u is None else torch.as_tensor(u), ts)
        for i in range(L):
            for j in range(M):
                want = np.asarray(jprob.solve_jacobian(rhs[i, j], factors[i, j], u, ts[i, j]))
                np.testing.assert_allclose(got[i, j].numpy(), want, rtol=0, atol=1e-13)
                np.testing.assert_allclose(looped[i, j].numpy(), want, rtol=0, atol=1e-13)


def test_qdiagonalization_as_direct_sdc_solver():
    """tests/test_paradiag.py:88-100: one update in SDC mode (ignore_ic=False) solves the collocation problem;
    its node states equal the JAX sweeper's to 1e-13."""
    from pysdc_tpu.core.level import Level as JaxLevel
    from pysdc_tpu_torch.core.level import Level

    params = {'num_nodes': 3, 'quad_type': 'RADAU-RIGHT', 'ignore_ic': False, 'update_f_evals': True}
    lams = np.linspace(-3, -0.5, 8)
    out = []
    for level_cls, prob, sweep in ((JaxLevel, jdahl.Dahlquist(lambdas=lams, u0=1.0), JaxQDiag(params)),
                                   (Level, tdahl.Dahlquist(lambdas=lams, u0=1.0, device='cpu'),
                                    QDiagonalization(params))):
        lvl = level_cls(prob, sweep, dict(dt=0.2, restol=1e-12))
        lvl.status.time = 0.0
        lvl.predict(prob.u_exact(0.0))
        lvl.update_nodes()
        lvl.compute_residual()
        assert float(lvl.status.residual) < 1e-12, float(lvl.status.residual)
        out.append((np.asarray(to_numpy(lvl.u)), np.asarray(to_numpy(lvl.f))))
    for got, want in zip(out[1], out[0]):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)


def test_increment_mode_matches_jax():
    """``solve_increment`` (ParaDiag mode) on HeatND 2D from a seeded complex residual, against the JAX sweeper."""
    rng = np.random.default_rng(5)
    jprob, tprob = jheat.HeatND(nvars=(8, 8), nu=0.1), theat.HeatND(nvars=(8, 8), nu=0.1, device='cpu')
    G_inv = np.linalg.inv(np.eye(3) + 0.3 * np.outer(np.ones(3), [0, 0, 1.0]))
    jsw = JaxQDiag({'num_nodes': 3, 'G_inv': G_inv})
    tsw = QDiagonalization({'num_nodes': 3, 'G_inv': G_inv})
    res = rng.standard_normal((3, 8, 8)) + 1j * rng.standard_normal((3, 8, 8))
    want = np.asarray(jsw.solve_increment(jprob, res, None, 0.1, 0.02))
    got = tsw.solve_increment(tprob, torch.as_tensor(res), None, 0.1, 0.02)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)


# -- kernel K1 on complex fields ---------------------------------------------
def _tables():
    out = {}
    for order in (2, 4, 6):
        c, s = get_finite_difference_stencil(2, order, 'center')
        axis = (tuple(float(x) for x in c), tuple(int(x) for x in s))
        out[f'order{order}'] = (axis, axis)
    out['asymmetric'] = (((0.5, -2.0, 1.5), (-2, -1, 0)), ((1.0, -0.25), (1, -3)))
    return out


@pytest.mark.parametrize('name', list(_tables()))
@pytest.mark.parametrize('dtype', [torch.complex128, torch.complex64])
@pytest.mark.parametrize('shape', [(8, 16), (2, 3, 12, 10), (5, 7)])
def test_complex_route_matches_complex_rolls(name, dtype, shape, monkeypatch):
    """The complex route (interleaved real view, doubled y taps) through the plain version against the plain
    complex rolls: 1e-15 relative to sum|c| max|u| (the zero taps add exact zeros, so equal in practice)."""
    terms = _tables()[name]
    gen = torch.Generator().manual_seed(3)
    u = torch.randn(shape, dtype=dtype, generator=gen)
    seen = []
    plain = stencil._roll_cross_2d
    monkeypatch.setattr(stencil, '_roll_cross_2d', lambda v, t: seen.append((v.dtype, tuple(v.shape), t)) or plain(v, t))
    got = stencil.cross_stencil_2d(u, terms)
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    assert seen == [(real, shape[:-1] + (2 * shape[-1],), stencil.interleaved_terms(terms))]
    want = plain(u, terms)
    scale = sum(abs(c) for coeff, _ in terms for c in coeff) * u.abs().max().item()
    assert got.dtype == dtype and got.shape == u.shape
    assert (got - want).abs().max().item() <= 1e-15 * scale


def test_interleaved_tables_and_paths():
    """A centred table of radius r becomes the centred table of radius 2r with zeros at the odd offsets; order 2
    stays on the bands path at ParaDiag's block shapes (complex64 -> float32 rows of 2n), order 4 leaves it."""
    order2, order4 = _tables()['order2'], _tables()['order4']
    (cx, ox), (cy, oy) = stencil.interleaved_terms(order2)
    assert (cx, ox) == order2[0] and oy == (-2, -1, 0, 1, 2) and cy == (1.0, 0.0, -2.0, 0.0, 1.0)
    assert stencil.interleaved_terms(order4)[1][1] == tuple(range(-4, 5))
    assert stencil.interleaved_terms(_tables()['asymmetric'])[1] == ((1.0, -0.25), (2, -6))
    for n in (512, 2048):
        for itemsize in (4, 8):
            assert stencil.choose_path((8, 3, n, 2 * n), stencil.interleaved_terms(order2), itemsize) == 'bands'
    assert stencil.choose_path((8, 3, 512, 1024), stencil.interleaved_terms(order4), 4) == 'general'


def test_complex_apply_takes_the_kernel_route_and_raises_without_a_view(monkeypatch):
    """``SeparableFDOperator.apply`` on a complex 2D periodic field goes through ``cross_stencil_2d`` (no roll
    path) and equals the roll apply; a non-contiguous complex field raises."""
    prob = theat.HeatND(nvars=(16, 16), nu=0.1, device='cpu')
    u = torch.randn((2, 3, 16, 16), dtype=torch.complex128, generator=torch.Generator().manual_seed(2))
    calls = []
    wrapper = stencil.cross_stencil_2d
    monkeypatch.setattr(stencil, 'cross_stencil_2d', lambda v, t, path=None: calls.append(v.dtype) or wrapper(v, t, path))
    got = prob.A.apply(u)
    assert calls == [torch.complex128, torch.float64]  # the complex field, then its interleaved view
    prob.A.disable_pallas()
    want = prob.A.apply(u)
    prob.A.enable_pallas()
    scale = sum(abs(c) for coeff, _ in prob.A._cross_terms for c in coeff) * u.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-15 * scale
    with pytest.raises(ValueError, match='contiguous'):
        prob.A.apply(u.transpose(-1, -2))
