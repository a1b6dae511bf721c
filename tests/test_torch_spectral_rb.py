"""The tensor-product spectral layer, the Chebyshev problems and Rayleigh-Benard of the PyTorch port against the
JAX package (float64 / complex128, CPU).

The bases' transforms and padding, ``TensorProductSpectral``'s shifted solve (one ``torch.linalg.solve_ex`` over the
modes, a float and a device-tensor factor), ``apply_L``, the dealiased products and the axis matrices on seeded
fields, all with leading batch axes riding along; ``HeatChebyshev1D``, ``Burgers1D``, ``Heat2DChebyshev``,
``RayleighBenard`` (with ``CFLLimit``) and ``RayleighBenard3D`` through ``ControllerNonMPI`` against live JAX runs
(equal ``niter``, ``uend`` to 1e-11 relative; Burgers and the 2D heat problem run a fixed number of sweeps, as their
collocation residual stalls on the tau rows in both packages), their diagnostics; and the four 2D-or-lower problems
through ``ShardedController(2)``'s fused lane against the JAX package's fused lane and the port's stage lane.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysdc_tpu
import pysdc_tpu.models.rayleigh_benard as jrb
import pysdc_tpu.models.spectral_problems as jsp
import pysdc_tpu.ops.spectral as jspec
import pysdc_tpu_torch
from pysdc_tpu_torch.models import rayleigh_benard as trb
from pysdc_tpu_torch.models import spectral_problems as tsp
from pysdc_tpu_torch.ops import spectral as tspec
from pysdc_tpu_torch.utils.convert import to_numpy
from test_torch_solvers import close

torch.set_num_threads(1)


def test_bases_match_jax():
    rng = np.random.default_rng(6)
    for J, T, args in ((jspec.FourierBase1D, tspec.FourierBase1D, (12, 0.0, 2.0)),
                       (jspec.UltrasphericalBase1D, tspec.UltrasphericalBase1D, (10, -1.0, 3.0))):
        jb, tb = J(*args), T(*args)
        np.testing.assert_array_equal(tb.nodes, jb.nodes)
        u = rng.standard_normal((3, args[0], 5)) + 1j * rng.standard_normal((3, args[0], 5))
        tu, ju = torch.as_tensor(u), jnp.asarray(u)
        close(tb.transform(tu, -2), jb.transform(ju, 1), rtol=1e-14)
        close(tb.itransform(tu, -2), jb.itransform(ju, 1), rtol=1e-14)
        close(tb.pad(tu, -2, 1.5), jb.pad(ju, 1, 1.5), rtol=0.0)
        if T is tspec.FourierBase1D:
            close(tb.unpad(tb.pad(tu, -2, 1.5), -2, 1.5), u, rtol=0.0)
        else:
            for p in (1, 2):
                np.testing.assert_array_equal(tb.ladder_matrix(p, 2), jb.ladder_matrix(p, 2))
            np.testing.assert_array_equal(tb.neumann_row(3.0), jb.neumann_row(3.0))


def _rb(package, **kw):
    return (jrb if package == 'jax' else trb).RayleighBenard(nx=16, nz=12, **({} if package == 'jax' else
                                                                                 dict(device='cpu')), **kw)


def test_tensor_product_operators_match_jax():
    jprob, tprob = _rb('jax'), _rb('torch')
    js, ts = jprob.spec, tprob.spec
    rng = np.random.default_rng(8)
    u = rng.standard_normal((4, 16, 12))
    tu, ju = torch.as_tensor(u), jnp.asarray(u)
    for factor in (0.03, torch.tensor(0.03, dtype=torch.float64)):
        close(ts.solve_shifted(tu, factor), js.solve_shifted(ju, 0.03))
    close(ts.apply_L(tu), js.apply_L(ju))
    uh_t, uh_j = ts.transform(tu), js.transform(ju)
    close(uh_t, uh_j, rtol=1e-14)
    close(ts.pad_to_real(uh_t, 1.5), js.pad_to_real(uh_j, 1.5), rtol=1e-14)
    pad = rng.standard_normal((4, 24, 18))
    close(ts.real_to_unpad(torch.as_tensor(pad), 1.5), js.real_to_unpad(jnp.asarray(pad), 1.5), rtol=1e-14)
    close(ts.apply_axis_matrix(jprob._Dz_T, uh_t, 'z'), js.apply_axis_matrix(jprob._Dz_T, uh_j, 'z'), rtol=1e-14)
    # leading batch axes (the nodes of a sweep) ride along
    stack = torch.stack([tu, 0.5 * tu])
    close(ts.solve_shifted(stack, 0.03)[1], to_numpy(ts.solve_shifted(0.5 * tu, 0.03)), rtol=1e-14)
    close(ts.pad_to_real(ts.transform(stack), 1.5)[0], to_numpy(ts.pad_to_real(uh_t, 1.5)), rtol=1e-15)
    got = tprob.solve_system_batched(stack, np.array([0.01, 0.03]), stack, np.zeros(2))
    close(got[1], to_numpy(ts.solve_shifted(0.5 * tu, 0.03)), rtol=1e-14)


CASES = {
    # name -> (problem, problem params, sweeper kind, QE, dt, steps, restol, maxiter)
    'heat-chebyshev': ('HeatChebyshev1D', dict(nvars=32), 'implicit', None, 0.05, 2, 1e-11, 30),
    'burgers': ('Burgers1D', dict(nvars=32), 'imex', 'EE', 0.01, 2, -1.0, 6),
    'heat-2d-chebyshev': ('Heat2DChebyshev', dict(nx=12, nz=12), 'implicit', None, 0.05, 2, -1.0, 6),
    # tests/test_spectral.py:217 and :236 at smaller grids
    'rayleigh-benard': ('RayleighBenard', dict(nx=32, nz=16, Rayleigh=2e6), 'imex', 'PIC', 0.02, 2, -1.0, 4),
    'rayleigh-benard-3d': ('RayleighBenard3D', dict(nx=8, ny=8, nz=8, Rayleigh=2e4), 'imex', 'PIC', 0.05, 2, -1.0,
                           4),
    'rayleigh-benard-cfl': ('RayleighBenard', dict(nx=32, nz=16, Rayleigh=2e6), 'imex', 'PIC', 0.01, 3, -1.0, 4),
}


def _description(package, name):
    cls, params, kind, qe, dt, _, restol, maxiter = CASES[name]
    jax_side = package == 'jax'
    pkg = pysdc_tpu if jax_side else pysdc_tpu_torch
    module = (jrb if jax_side else trb) if cls.startswith('Rayleigh') else (jsp if jax_side else tsp)
    if not jax_side:
        params = dict(params, device='cpu')
    sp = dict(num_nodes=2 if cls == 'RayleighBenard3D' else 3, QI='LU')
    if kind == 'imex':
        sweeper, sp = pkg.IMEXSweeper, dict(sp, QE=qe)
    else:
        sweeper = pkg.GenericImplicit
    desc = dict(problem_class=getattr(module, cls), problem_params=params, sweeper_class=sweeper, sweeper_params=sp,
                level_params=dict(dt=dt, restol=restol), step_params=dict(maxiter=maxiter))
    if name.endswith('cfl'):
        desc['convergence_controllers'] = {module.CFLLimit: {'cfl': 0.4}}
    return pkg, desc


@functools.lru_cache(maxsize=None)
def _run(package, name):
    pkg, desc = _description(package, name)
    ctrl = pkg.ControllerNonMPI(1, {'logger_level': 40}, desc)
    prob = ctrl.MS[0].levels[0].prob
    u0 = prob.u_exact(0.0)
    uend, stats = ctrl.run(u0, 0.0, CASES[name][5] * CASES[name][4])
    diag = prob.compute_Nusselt_numbers(uend) if hasattr(prob, 'compute_Nusselt_numbers') else {}
    return (np.asarray(to_numpy(u0)), np.asarray(to_numpy(uend)), [v for _, v in pkg.get_sorted(stats, type='niter')],
            [v for _, v in pkg.get_sorted(stats, type='dt')], diag)


@pytest.mark.parametrize('name', list(CASES))
def test_run_matches_live_jax(name):
    want_u0, want, want_niter, want_dt, want_nu = _run('jax', name)
    got_u0, got, niter, dts, nu = _run('torch', name)
    close(got_u0, want_u0, rtol=1e-14)
    assert niter == want_niter and dts == pytest.approx(want_dt, rel=1e-12)
    close(got, want)
    assert np.abs(got - got_u0).max() > 1e-8  # the run moved
    for key in want_nu:
        assert nu[key] == pytest.approx(want_nu[key], rel=1e-11, abs=1e-13)
    if name.endswith('cfl'):
        assert len(set(dts)) > 1  # the CFL limit moved dt


@pytest.mark.parametrize('dim', [2, 3])
def test_rayleigh_benard_diagnostics_match_jax(dim):
    if dim == 2:
        jprob, tprob = _rb('jax'), _rb('torch')
        jfn, tfn = jprob.compute_vorticity, tprob.compute_vorticity
    else:
        jprob = jrb.RayleighBenard3D(nx=8, ny=6, nz=8)
        tprob = trb.RayleighBenard3D(nx=8, ny=6, nz=8, device='cpu')
        jfn, tfn = jprob.compute_divergence, tprob.compute_divergence
    u = np.asarray(jprob.u_exact(0.0)) + 0.01 * np.random.default_rng(12).standard_normal(jprob.shape)
    close(tfn(torch.as_tensor(u)), jfn(jnp.asarray(u)))
    got, want = tprob.compute_Nusselt_numbers(torch.as_tensor(u)), jprob.compute_Nusselt_numbers(jnp.asarray(u))
    assert got == pytest.approx(want, rel=1e-12)
    for got, want in zip(tprob.eval_f(torch.as_tensor(u), 0.0), jprob.eval_f(jnp.asarray(u), 0.0)):
        close(got, want)


@functools.lru_cache(maxsize=None)
def _block_run(package, name, lane='auto'):
    """``ShardedController(2).run`` at restol -1 and maxiter 2 over two blocks: ``(uend, niter, lanes, ctrl)``."""
    pkg, desc = _description(package, name)
    desc['level_params'] = dict(desc['level_params'], restol=-1.0)
    desc['step_params'] = dict(maxiter=2)
    ctrl = pkg.ShardedController(2, {'logger_level': 40}, desc)
    u0 = ctrl.MS[0].levels[0].prob.u_exact(0.0)
    uend, stats = ctrl.run(u0, 0.0, 4 * CASES[name][4], lane=lane)
    return (np.asarray(to_numpy(uend)), [v for _, v in pkg.get_sorted(stats, type='niter', sortby='time')],
            [v for k, v in stats.items() if k.type == 'lane'], ctrl)


@pytest.mark.parametrize('name', ['heat-chebyshev', 'burgers', 'heat-2d-chebyshev', 'rayleigh-benard'])
def test_fused_lanes_refuse_the_spectral_problems_by_name(name):
    """The fused lanes take the spectral problems (the name is older than that): ``'auto'`` takes the fused lane in
    both packages, and the port's fused run equals the JAX package's fused run and the port's stage lane (equal
    ``niter``, ``uend`` to 1e-12 relative), reading nothing on the host but the one fetch."""
    want, want_niter, want_lanes, _ = _block_run('jax', name, 'fused')
    got, niter, lanes, ctrl = _block_run('torch', name)
    stage, stage_niter, stage_lanes, _ = _block_run('torch', name, 'stage')
    assert lanes == ['fused'] and want_lanes == ['fused'] and stage_lanes == ['stage']
    assert ctrl.MS[0].levels[0].prob.graph_capture_blocker is None
    assert niter == want_niter == stage_niter and len(niter) == 4
    close(got, want, rtol=1e-12)
    close(got, stage, rtol=1e-12)
    assert ctrl.host_reads == {'cont': 0, 'fetch': 1}
