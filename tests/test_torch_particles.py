"""The second-order problems and sweepers of the PyTorch port against the JAX package (float64, CPU).

``VerletSweeper``, ``BorisSDC`` and the Runge-Kutta-Nystrom classes on the
configurations of tests/test_sweeper_families.py:50-180 and
tests/test_boris_power_dae.py:17-38, through both packages'
``ControllerNonMPI`` from the same numpy initial state (carried across by
``pysdc_tpu_torch.utils.convert``): equal ``niter`` per step, ``uend`` to
1e-12 relative to the state's size, and the reference tests' own gates
(orders, energy, accuracy) on the port's runs.  Each particle model's
``eval_f`` and Hamiltonian (and the Penning trap's ``build_f`` and
``boris_solver``) at a seeded state to 1e-13 relative.  A ``Particles`` state
also crosses steps of a two-step block (``Level.set_u0``).
"""

import functools

import numpy as np
import pytest
import torch

import pysdc_tpu
import pysdc_tpu_torch
from pysdc_tpu.models import particles as jp
from pysdc_tpu.sweepers import boris as jboris
from pysdc_tpu.sweepers import rkn as jrkn
from pysdc_tpu.sweepers import verlet as jverlet
from pysdc_tpu_torch.models import particles as tp
from pysdc_tpu_torch.sweepers import boris as tboris
from pysdc_tpu_torch.sweepers import rkn as trkn
from pysdc_tpu_torch.sweepers import verlet as tverlet
from pysdc_tpu_torch.utils.convert import to_numpy, to_torch

torch.set_num_threads(1)

HO = (jp.HarmonicOscillator, tp.HarmonicOscillator)
VERLET = (jverlet.VerletSweeper, tverlet.VerletSweeper)
PENNING = dict(omega_B=25.0, omega_E=4.9, nparts=1, sig=0.1)
# name -> (problem classes, problem params, sweeper classes, sweeper params, level params, maxiter, Tend, procs)
CASES = {
    # tests/test_sweeper_families.py:50-69, both step sizes
    'verlet-ho-0.5': (HO, dict(k=1.0, mu=0.0), VERLET, dict(num_nodes=3), dict(dt=0.5, restol=1e-13), 20, 4.0, 1),
    'verlet-ho-0.25': (HO, dict(k=1.0, mu=0.0), VERLET, dict(num_nodes=3), dict(dt=0.25, restol=1e-13), 20, 4.0, 1),
    # tests/test_sweeper_families.py:72-87
    'verlet-damped': (HO, dict(k=1.0, mu=0.2), VERLET, dict(num_nodes=4), dict(dt=0.2, restol=1e-13), 30, 2.0, 1),
    # tests/test_sweeper_families.py:90-104
    'verlet-solar': ((jp.OuterSolarSystem, tp.OuterSolarSystem), {}, VERLET, dict(num_nodes=3),
                     dict(dt=50.0, restol=1e-12), 20, 1000.0, 1),
    # the same oscillator as a block of two steps: the state crosses steps through set_u0
    'verlet-ho-2-procs': (HO, dict(k=1.0, mu=0.0), VERLET, dict(num_nodes=3), dict(dt=0.5, restol=1e-13), 20, 4.0, 2),
    # the FPUT chain (chip_smoke.py's configuration, 64 particles)
    'verlet-fput': ((jp.FermiPastaUlamTsingou, tp.FermiPastaUlamTsingou), dict(npart=64), VERLET, dict(num_nodes=3),
                    dict(dt=1.0, restol=1e-12), 20, 5.0, 1),
    # tests/test_sweeper_families.py:138-180
    'rkn4-1/8': (HO, dict(k=1.0, mu=0.0), (jrkn.RKN4, trkn.RKN4), {}, dict(dt=1 / 8, restol=-1), 1, 2.0, 1),
    'rkn4-1/16': (HO, dict(k=1.0, mu=0.0), (jrkn.RKN4, trkn.RKN4), {}, dict(dt=1 / 16, restol=-1), 1, 2.0, 1),
    'rkn4-1/32': (HO, dict(k=1.0, mu=0.0), (jrkn.RKN4, trkn.RKN4), {}, dict(dt=1 / 32, restol=-1), 1, 2.0, 1),
    'vv-1/8': (HO, dict(k=1.0, mu=0.0), (jrkn.VelocityVerletRKN, trkn.VelocityVerletRKN), {}, dict(dt=1 / 8, restol=-1),
               1, 2.0, 1),
    'vv-1/16': (HO, dict(k=1.0, mu=0.0), (jrkn.VelocityVerletRKN, trkn.VelocityVerletRKN), {},
                dict(dt=1 / 16, restol=-1), 1, 2.0, 1),
    'vv-1/32': (HO, dict(k=1.0, mu=0.0), (jrkn.VelocityVerletRKN, trkn.VelocityVerletRKN), {},
                dict(dt=1 / 32, restol=-1), 1, 2.0, 1),
    'rkn4-damped': (HO, dict(k=1.0, mu=0.2), (jrkn.RKN4, trkn.RKN4), {}, dict(dt=1 / 16, restol=-1), 1, 2.0, 1),
    # tests/test_boris_power_dae.py:17-38, both step sizes
    'boris-1/64': ((jp.PenningTrap3D, tp.PenningTrap3D), PENNING, (jboris.BorisSDC, tboris.BorisSDC),
                   dict(num_nodes=3, quad_type='LOBATTO'), dict(dt=0.015625, restol=1e-12), 20, 0.5, 1),
    'boris-1/128': ((jp.PenningTrap3D, tp.PenningTrap3D), PENNING, (jboris.BorisSDC, tboris.BorisSDC),
                    dict(num_nodes=3, quad_type='LOBATTO'), dict(dt=0.0078125, restol=1e-12), 20, 0.5, 1),
}
FROM_INIT = ('verlet-ho', 'rkn', 'vv')  # the oscillator runs start from u_init, the others from u_exact(0)


def _u0(prob, case):
    return prob.u_init if case.startswith(FROM_INIT) else prob.u_exact(0.0)


@functools.lru_cache(maxsize=None)
def _run(package, case):
    classes, params, sweepers, sweeper_params, level, maxiter, Tend, procs = CASES[case]
    side = 0 if package == 'jax' else 1
    pkg = pysdc_tpu if side == 0 else pysdc_tpu_torch
    desc = dict(problem_class=classes[side], problem_params=dict(params, device='cpu') if side else params,
                sweeper_class=sweepers[side], sweeper_params=sweeper_params, level_params=level,
                step_params=dict(maxiter=maxiter))
    ctrl = pkg.ControllerNonMPI(procs, {'logger_level': 40}, desc)
    prob = ctrl.MS[0].levels[0].prob
    if side == 0:
        u0 = jp.Particles(*(np.asarray(leaf) for leaf in _u0(prob, case)))
    else:
        u0 = to_torch(_run('jax', case)['u0'], 'cpu')
        assert isinstance(u0, tp.Particles)
    uend, stats = ctrl.run(u0, 0.0, Tend)
    ex = None
    if classes[0] in (jp.HarmonicOscillator, jp.PenningTrap3D):
        ex = prob.u_exact(Tend)
    err = None if ex is None else max(np.abs(np.asarray(to_numpy(a)) - np.asarray(to_numpy(b))).max()
                                      for a, b in zip(uend, ex))
    ham = None
    if hasattr(prob, 'eval_hamiltonian'):
        ham = (float(prob.eval_hamiltonian(u0)), float(prob.eval_hamiltonian(uend)))
    return dict(u0=u0, uend=tuple(np.asarray(to_numpy(leaf)) for leaf in uend), err=err, ham=ham,
                niter=[v for _, v in pkg.get_sorted(stats, type='niter', sortby='time')])


@pytest.mark.parametrize('case', list(CASES))
def test_second_order_run_matches_jax(case):
    want, got = _run('jax', case), _run('torch', case)
    assert got['niter'] == want['niter'] and len(got['niter']) >= 2
    for g, w in zip(got['uend'], want['uend']):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12 * max(1.0, np.abs(w).max()))


def _order(cases):
    errs = [_run('torch', case)['err'] for case in cases]
    return [np.log(errs[i] / errs[i + 1]) / np.log(2) for i in range(len(errs) - 1)]


def test_the_reference_gates_on_the_port():
    """tests/test_sweeper_families.py and tests/test_boris_power_dae.py's assertions on the port's runs."""
    # 3 Lobatto nodes: collocation order 2M-2 = 4
    assert _order(['verlet-ho-0.5', 'verlet-ho-0.25'])[0] > 3.5
    # velocity-dependent forces see the pre-update velocity in eval_f (reference verlet.py:124-126): O(dt^2) bias
    assert _run('torch', 'verlet-damped')['err'] < 5e-3
    H0, H1 = _run('torch', 'verlet-solar')['ham']
    assert abs(H1 - H0) / abs(H0) < 1e-7
    assert np.median(_order(['rkn4-1/8', 'rkn4-1/16', 'rkn4-1/32'])) > 4 - 0.35
    assert np.median(_order(['vv-1/8', 'vv-1/16', 'vv-1/32'])) > 2 - 0.35
    assert _run('torch', 'rkn4-damped')['err'] < 1e-4
    assert _order(['boris-1/64', 'boris-1/128'])[0] > 3.3
    H0, H1 = _run('torch', 'verlet-fput')['ham']
    assert abs(H1 - H0) / abs(H0) < 1e-6


def _seeded(shape, rng):
    return rng.standard_normal(shape)


@pytest.mark.parametrize('name, params', [
    ('HarmonicOscillator', dict(k=2.0, mu=0.3)), ('FermiPastaUlamTsingou', dict(npart=16, alpha=0.25)),
    ('OuterSolarSystem', {}), ('OuterSolarSystem', dict(sun_only=True)), ('FullSolarSystem', {}),
    ('HenonHeiles', {}), ('PenningTrap3D', dict(nparts=8, sig=0.1)),
])
def test_particle_models_match_jax(name, params):
    jprob, tprob = getattr(jp, name)(**params), getattr(tp, name)(**params, device='cpu')
    rng = np.random.default_rng(17)
    if name in ('OuterSolarSystem', 'FullSolarSystem'):
        base = jprob.u_exact(0.0)
        u = jp.Particles(np.asarray(base.pos) + 0.1 * _seeded(jprob.shape, rng),
                         np.asarray(base.vel) + 1e-3 * _seeded(jprob.shape, rng))
    else:
        u = jp.Particles(_seeded(jprob.shape, rng), _seeded(jprob.shape, rng))
    tu = to_torch(u, 'cpu')
    want, got = jprob.eval_f(u, 0.3), tprob.eval_f(tu, 0.3)
    for w, g in zip(jax_leaves(want), jax_leaves(got)):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), rtol=1e-13, atol=1e-13 * np.abs(np.asarray(w)).max())
    if hasattr(jprob, 'eval_hamiltonian'):
        np.testing.assert_allclose(float(tprob.eval_hamiltonian(tu)), float(jprob.eval_hamiltonian(u)), rtol=1e-13)
    if name == 'PenningTrap3D':
        new = jprob.eval_f(jp.Particles(u.pos + 0.01, u.vel), 0.4)
        tnew = tprob.eval_f(to_torch(jp.Particles(u.pos + 0.01, u.vel), 'cpu'), 0.4)
        c = _seeded(jprob.shape, rng)
        np.testing.assert_allclose(to_numpy(tprob.build_f(tnew, tu, 0.4)), np.asarray(jprob.build_f(new, u, 0.4)),
                                   rtol=1e-13, atol=1e-12)
        np.testing.assert_allclose(to_numpy(tprob.boris_solver(torch.as_tensor(c), 0.01, got, tnew, tu)),
                                   np.asarray(jprob.boris_solver(c, 0.01, want, new, u)), rtol=1e-13, atol=1e-12)


def jax_leaves(x):
    return tuple(x) if isinstance(x, tuple) else (x,)


def test_exact_solutions_and_converters():
    for name, params, t in (('HarmonicOscillator', dict(k=1.0, mu=0.2), 1.3), ('HarmonicOscillator', {}, 0.7),
                            ('PenningTrap3D', {}, 0.25), ('FermiPastaUlamTsingou', dict(npart=32), 0.0),
                            ('HenonHeiles', {}, 0.0), ('FullSolarSystem', {}, 0.0)):
        want, got = getattr(jp, name)(**params).u_exact(t), getattr(tp, name)(**params, device='cpu').u_exact(t)
        assert isinstance(got, tp.Particles)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-14, atol=1e-14)
    # the converters carry Particles and EMFields across, leaf by leaf
    fields = tp.EMFields(torch.ones(3, 2), torch.zeros(3, 2))
    back = to_numpy(fields)
    assert isinstance(back, tp.EMFields) and isinstance(back.elec, np.ndarray)
    assert isinstance(to_torch(jp.EMFields(np.ones((3, 2)), np.ones((3, 2))), 'cpu'), tp.EMFields)
