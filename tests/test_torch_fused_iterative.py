"""The iterative solves on the fused lanes: the port against the JAX package, and the device loop's bodies.

The JAX package's fused lane traces every iterative solve as a ``lax.while_loop``; the port captures them as
device ``while`` loops (``pysdc_tpu_torch/ops/graph_loop.py``, CUDA conditional WHILE nodes).  On the CPU the
fused lanes run their pieces eagerly, and a capture is simulated by patching ``loops.capturing``: the masked
loops then take the device loop's plain version, which calls the body while the flag holds.

- ``ShardedController(4).run`` on the sparse lane (VarCoeffDiffusion2D 24^2 with ``pcg`` and with ``cg``) and
  on HeatND 32^2 with ``solver_type`` CG and GMRES, against the JAX package's ``ShardedController(4).run`` on
  the same description: ``'auto'`` takes the fused lane in both, ``niter`` equal, ``uend`` to 1e-12 in float64
  (both packages solve each step's systems to their tolerance, 1e-12 relative or tighter: what separates the
  two is the solves' rounding);
- the same runs under a simulated capture: the result equals the eager run's bit for bit, and the solves
  compute exactly as many iterations as eager (the operator's applies are counted);
- the PCG, CG and Arnoldi bodies traced once (``make_fx``, the CPU's counterpart of a graph capture) and
  replayed until their flag clears give the carry of the eager loop bit for bit: no body branches on a host
  counter;
- the fused block's loop body (``work`` then ``check``: PFASST heat, Rayleigh-Benard, the linearized sweeper, the
  circuit problems ``Piline``, ``BuckConverter`` and ``BatteryNCapacitors``, ``VanDerPol`` with its Newton loop as a
  capture records it) and the direct sparse solves (``'banded'``, ``'block_tridiag'``), with ``dt`` a 0-d tensor,
  traced once by ``make_fx``: no operation reads a value on the host (no ``aten._local_scalar_dense``, no
  ``aten._linalg_check_errors``).

One JAX run is shared per case through ``functools.lru_cache``; the port's CPU runs use one thread.
"""

from __future__ import annotations

import functools
from unittest import mock

import numpy as np
import pytest
import torch

import pysdc_tpu
import pysdc_tpu_torch
from pysdc_tpu.models.heat import HeatND as JaxHeat
from pysdc_tpu.models.var_diffusion import VarCoeffDiffusion2D as JaxVC2
from pysdc_tpu_torch.models.heat import HeatND
from pysdc_tpu_torch.models.var_diffusion import VarCoeffDiffusion2D
from pysdc_tpu_torch.ops import krylov, loops, solvers
from pysdc_tpu_torch.utils.convert import to_numpy

torch.set_num_threads(1)

UEND_TOL = 1e-12  # float64, absolute, fields of size <= 1


def _coeff(x, y):
    """The sparse lane's diffusivity (bench.py:343-377)."""
    return 0.1 * (1.0 + 0.5 * np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y))


HEAT = dict(nvars=(32, 32), nu=0.1, freq=2, bc='dirichlet-zero', lintol=1e-13)
# name -> (JAX class, port class, problem_params, dt, Tend: two blocks of 4 steps)
CASES = {
    'vc2d-pcg': (JaxVC2, VarCoeffDiffusion2D, dict(nvars=(24, 24), coeff_fn=_coeff), 1e-3, 8e-3),
    'vc2d-cg': (JaxVC2, VarCoeffDiffusion2D, dict(nvars=(24, 24), coeff_fn=_coeff, solver='cg'), 1e-3, 8e-3),
    'heat-CG': (JaxHeat, HeatND, dict(HEAT, solver_type='CG'), 0.01, 0.08),
    'heat-GMRES': (JaxHeat, HeatND, dict(HEAT, solver_type='GMRES'), 0.01, 0.08),
}


def _description(pkg, cls, params, dt):
    return dict(problem_class=cls, problem_params=params, sweeper_class=pkg.GenericImplicit,
                sweeper_params=dict(num_nodes=4, quad_type='RADAU-RIGHT', QI='LU'),
                level_params=dict(dt=dt, restol=1e-10), step_params=dict(maxiter=20))


def _u0(prob, to_tensor):
    """sin(pi x) sin(pi y) on the grid of a VarCoeffDiffusion2D (it has no exact solution), else ``u_exact(0)``."""
    if not hasattr(prob, 'yvals'):
        return prob.u_exact(0.0)
    x, y = np.meshgrid(np.asarray(prob.xvals), np.asarray(prob.yvals), indexing='ij')
    u = np.sin(np.pi * x) * np.sin(np.pi * y)
    return torch.as_tensor(u) if to_tensor else u


def _summary(pkg, ctrl, uend, stats):
    return dict(uend=np.asarray(to_numpy(uend)), lane=[v for k, v in stats.items() if k.type == 'lane'],
                niter=[v for _, v in pkg.get_sorted(stats, type='niter', sortby='time')], ctrl=ctrl)


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    jcls, _, params, dt, Tend = CASES[name]
    ctrl = pysdc_tpu.ShardedController(4, {'logger_level': 40}, _description(pysdc_tpu, jcls, dict(params), dt))
    uend, stats = ctrl.run(_u0(ctrl.MS[0].levels[0].prob, False), 0.0, Tend)
    return _summary(pysdc_tpu, ctrl, uend, stats)


def _counted(prob):
    """Count the operator's products (every iteration of every solve makes one): the sparse operator's SpMVs,
    or the separable operator's applies."""
    op = prob.A
    name = '_mv' if hasattr(op, '_mv') else 'apply'
    count = [0]
    product = getattr(op, name)

    def counting(u):
        count[0] += 1
        return product(u)

    setattr(op, name, counting)
    return count


def _torch_run(name, lane='auto'):
    _, tcls, params, dt, Tend = CASES[name]
    desc = _description(pysdc_tpu_torch, tcls, dict(params, device='cpu'), dt)
    ctrl = pysdc_tpu_torch.ShardedController(4, {'logger_level': 40}, desc)
    prob = ctrl.MS[0].levels[0].prob
    applies = _counted(prob)
    uend, stats = ctrl.run(_u0(prob, True), 0.0, Tend, lane=lane)
    return dict(_summary(pysdc_tpu_torch, ctrl, uend, stats), applies=applies[0], torch_uend=uend)


@functools.lru_cache(maxsize=None)
def _eager_run(name):
    return _torch_run(name)


@pytest.mark.parametrize('name', list(CASES))
def test_fused_lane_matches_the_jax_block(name):
    want, got = _jax_run(name), _eager_run(name)
    assert want['lane'] == got['lane'] == ['fused']
    assert got['niter'] == want['niter'] and len(got['niter']) == 8 and max(got['niter']) < 20
    np.testing.assert_allclose(got['uend'], want['uend'], rtol=0, atol=UEND_TOL)
    assert got['ctrl'].MS[0].levels[0].prob.graph_capture_blocker is None
    assert got['ctrl'].host_reads['fetch'] == 1


@pytest.mark.parametrize('name', list(CASES))
def test_simulated_capture_computes_the_eager_iterations(monkeypatch, name):
    """Under a simulated capture the loops take the device loop's plain version: the same iterations as eager
    (counted operator applies), the same result bit for bit, and no host read of a loop."""
    eager = _eager_run(name)
    monkeypatch.setattr(loops, 'capturing', lambda x: True)
    got = _torch_run(name)
    assert got['lane'] == ['fused'] and got['niter'] == eager['niter']
    assert got['applies'] == eager['applies'] > sum(eager['niter'])
    assert torch.equal(got['torch_uend'], eager['torch_uend'])
    assert got['ctrl'].MS[0].levels[0].prob.A.host_reads == 0
    if name.startswith('vc2d-pcg'):
        op = got['ctrl'].MS[0].levels[0].prob.A
        assert op.pcg_steps == eager['ctrl'].MS[0].levels[0].prob.A.pcg_steps > 0


# -- the bodies, traced once and replayed --------------------------------------------------------------------------
def _traced_while(flag_fn, body, carry):
    """The device loop with its body traced ONCE (``make_fx`` on copies, so tracing writes nothing) and the
    recorded operations replayed while the flag holds: what a captured graph does."""
    from torch.fx.experimental.proxy_tensor import make_fx

    carry = tuple(carry)
    graph = make_fx(lambda *c: tuple(body(c)))(*[c.clone() for c in carry])
    trips = 0
    while bool(flag_fn(carry)):
        carry = tuple(graph(*carry))
        trips += 1
    return carry, trips


def _sparse_pcg(rng):
    op = VarCoeffDiffusion2D(nvars=(24, 24), coeff_fn=_coeff, device='cpu').A
    rhs, x0 = torch.as_tensor(rng.standard_normal((2, 576))), torch.as_tensor(rng.standard_normal((2, 576)))
    return lambda: op._pcg(rhs, 0.01, 1e-12, 100, x0, batch_ndim=1)[0]


def _solvers_pcg(rng):
    op = HeatND(**dict(HEAT, nvars=(16, 16)), device='cpu').A
    b = torch.as_tensor(rng.standard_normal((3, 16, 16)))
    return lambda: solvers.pcg(lambda x: x - 0.05 * op.apply(x), b, torch.zeros_like(b), tol=1e-12, maxiter=100,
                               batch_ndim=1)[0]


def _cg(rng):
    op = HeatND(**dict(HEAT, nvars=(16, 16)), device='cpu').A
    b = torch.as_tensor(rng.standard_normal((16, 16)))
    return lambda: krylov.cg(lambda x: x - 0.05 * op.apply(x), b, tol=1e-12, maxiter=100)[0]


def _cg_batched(rng):
    op = HeatND(**dict(HEAT, nvars=(16, 16)), device='cpu').A
    b = torch.as_tensor(rng.standard_normal((3, 16, 16)))
    return lambda: krylov.cg(lambda x: x - 0.05 * op.apply(x), b, tol=1e-12, maxiter=100, batch_ndim=1)[0]


def _arnoldi(rng):
    """One GMRES restart: its Arnoldi loop writes rows of V and H at the device index k."""
    op = HeatND(**dict(HEAT, nvars=(12, 12)), device='cpu').A
    b = torch.as_tensor(rng.standard_normal((12, 12)))
    unit, norm = krylov._safe_normalize(b.reshape(-1))

    def one_restart():
        new, _ = krylov._gmres_restart(lambda x: x - 0.05 * op.apply(x), lambda v: v, b, torch.zeros_like(b), unit,
                                       norm, 20, [])
        return new[0]

    return one_restart


@pytest.mark.parametrize('make', [_sparse_pcg, _solvers_pcg, _cg, _cg_batched, _arnoldi],
                         ids=lambda f: f.__name__.strip('_'))
def test_loop_body_traced_once_equals_the_eager_loop(monkeypatch, make):
    """A body that branched on a host counter (PCG's first iteration, the Arnoldi index) would be frozen at its
    first iteration by the trace; the device counters make the replay equal the eager loop bit for bit."""
    eager = make(np.random.default_rng(5))()
    monkeypatch.setattr(loops, 'capturing', lambda x: True)
    monkeypatch.setattr(loops, 'device_while', _traced_while)
    replayed = make(np.random.default_rng(5))()
    assert torch.equal(replayed, eager)


def test_batched_cg_is_one_cg_per_system():
    """``batch_ndim`` leading axes are independent systems, as under ``jax.vmap`` of the solve: each ends with the
    count and the result of its own solve (to the rounding of the per-system sums)."""
    op = HeatND(**dict(HEAT, nvars=(16, 16)), device='cpu').A
    rng = np.random.default_rng(11)
    b = torch.as_tensor(rng.standard_normal((3, 16, 16)) * np.array([1.0, 1e-3, 1e3])[:, None, None])
    shifts = torch.as_tensor([0.01, 0.05, 0.2])[:, None, None]
    x, info = krylov.cg(lambda v: v - shifts * op.apply(v), b, tol=1e-10, maxiter=200, batch_ndim=1)
    for s in range(3):
        xs, inf = krylov.cg(lambda v: v - shifts[s] * op.apply(v), b[s], tol=1e-10, maxiter=200)
        assert info.iterations[s] == inf.iterations
        torch.testing.assert_close(x[s], xs, rtol=1e-12, atol=0)
    assert len(set(info.iterations)) > 1


# -- what a capture holds reads nothing on the host --------------------------------------------------------------------
HOST_READS = ('aten._local_scalar_dense', 'aten._linalg_check_errors')


def _host_reads_in(fn, *args):
    """The operations of ``fn(*args)`` traced once by ``make_fx`` (the CPU's counterpart of a graph capture) that
    read a value on the host: ``.item()`` / ``float()`` of a tensor, or a linalg error check."""
    from torch.fx.experimental.proxy_tensor import make_fx

    try:
        graph = make_fx(fn)(*args)
    except RuntimeError as err:  # make_fx refuses to read a traced tensor's value
        return [read for read in HOST_READS if read in str(err)] or [str(err)]
    return [str(node.target) for node in graph.graph.nodes if str(node.target).startswith(HOST_READS)]


def _block_body(desc, P):
    """The fused block's ``work -> check`` body (one trip of its device ``while``) of ``ShardedController(P)`` on
    ``desc``, and its flattened carry after ``start`` and the first check, ``dt`` a 0-d tensor in a float64 buffer."""
    from pysdc_tpu_torch.parallel import fused

    ctrl = pysdc_tpu_torch.ShardedController(P, {'logger_level': 40}, desc)
    prob = ctrl.MS[0].levels[0].prob
    block = fused.build_fused_block(ctrl)
    dt = float(ctrl.MS[0].levels[0].params.dt)
    u0, t_arr, window, dts = block._inputs(prob.u_exact(0.0), dt * np.arange(P), np.ones(P, dtype=bool),
                                           torch.tensor(dt, dtype=torch.float64))
    pieces = block._pieces()
    first = pieces.check(pieces.start(u0, t_arr, window, dts), t_arr, window, dts)

    def trip(t_arr, window, dts, *leaves):
        c = fused._rebuild(first, iter(leaves))
        return tuple(fused._leaves(pieces.check(pieces.work(c, t_arr, window, dts), t_arr, window, dts)))

    return trip, (t_arr, window, dts, *fused._leaves(first))


def _pfasst_heat():
    desc = dict(problem_class=HeatND,
                problem_params=dict(nvars=[(16, 16), (8, 8)], nu=0.1, freq=2, bc='periodic', device='cpu'),
                sweeper_class=pysdc_tpu_torch.GenericImplicit,
                sweeper_params=dict(num_nodes=[3, 2], quad_type='RADAU-RIGHT', QI='LU'),
                level_params=dict(dt=0.01, restol=1e-10), step_params=dict(maxiter=6))
    return _block_body(desc, 4)


def _spectral():
    from pysdc_tpu_torch.models.rayleigh_benard import RayleighBenard

    desc = dict(problem_class=RayleighBenard, problem_params=dict(nx=16, nz=8, Rayleigh=2e6, device='cpu'),
                sweeper_class=pysdc_tpu_torch.IMEXSweeper, sweeper_params=dict(num_nodes=3, QI='LU', QE='PIC'),
                level_params=dict(dt=0.01, restol=-1.0), step_params=dict(maxiter=2))
    return _block_body(desc, 2)


def _linearized():
    from pysdc_tpu_torch.models.odes import VanDerPol

    desc = dict(problem_class=VanDerPol, problem_params=dict(mu=2.0, device='cpu'),
                sweeper_class=pysdc_tpu_torch.LinearizedImplicitParallel,
                sweeper_params=dict(num_nodes=3, quad_type='RADAU-RIGHT'),
                level_params=dict(dt=0.05, restol=1e-10), step_params=dict(maxiter=10))
    return _block_body(desc, 2)


def _direct(solver):
    """One shifted solve of the sparse operator's direct ``solver`` with a 0-d tensor shift."""
    if solver == 'banded':
        op = HeatND(nvars=63, nu=0.1, freq=2, bc='dirichlet-zero', backend='sparse', device='cpu').A
    else:
        op = VarCoeffDiffusion2D(nvars=(24, 24), coeff_fn=_coeff, solver='block_tridiag', device='cpu').A
    assert op.solver_kind == solver
    rhs = torch.as_tensor(np.random.default_rng(4).standard_normal((3,) + tuple(op.grid_shape)))
    factor = torch.tensor(0.02, dtype=torch.float64)
    x = op.solve_shifted(rhs, factor)
    residual = rhs - (x - 0.02 * op.apply(x))
    assert float(residual.abs().max()) < 1e-12 * float(rhs.abs().max())  # the solve is right, by its residual
    return lambda rhs, factor: op.solve_shifted(rhs, factor), (rhs, factor)


def _circuit(name):
    """A circuit problem's block: IMEX M=3, its implicit part a dense solve of the circuit's few unknowns."""
    from pysdc_tpu_torch.models import power_electronics

    params = dict(ncapacitors=2) if name == 'BatteryNCapacitors' else dict(fsw=7.0) if name == 'BuckConverter' else {}
    desc = dict(problem_class=getattr(power_electronics, name), problem_params=dict(params, device='cpu'),
                sweeper_class=pysdc_tpu_torch.IMEXSweeper,
                sweeper_params=dict(num_nodes=3, quad_type='RADAU-RIGHT', QI='LU', QE='EE'),
                level_params=dict(dt=0.05, restol=1e-10), step_params=dict(maxiter=10))
    return _block_body(desc, 2)


def _one_trip(flag_fn, body, carry):
    """The device loop as a capture records it: the first flag computed on the device and not read, the body once."""
    carry = tuple(carry)
    flag_fn(carry)
    return tuple(body(carry)), None


def _newton():
    """VanDerPol under GenericImplicit: each node's solve is ``newton_solve``'s masked loop, which a capture holds as
    a device ``while`` (its body traced once here: one Newton step and its dense solve)."""
    from pysdc_tpu_torch.models.odes import VanDerPol

    desc = dict(problem_class=VanDerPol, problem_params=dict(mu=2.0, device='cpu'),
                sweeper_class=pysdc_tpu_torch.GenericImplicit,
                sweeper_params=dict(num_nodes=3, quad_type='RADAU-RIGHT', QI='LU'),
                level_params=dict(dt=0.05, restol=1e-10), step_params=dict(maxiter=10))
    trip, args = _block_body(desc, 2)

    def captured(*leaves):
        with mock.patch.object(loops, 'capturing', lambda x: True), mock.patch.object(loops, 'device_while', _one_trip):
            return trip(*leaves)

    return captured, args


@pytest.mark.parametrize('make', [_pfasst_heat, _spectral, _linearized, lambda: _direct('banded'),
                                  lambda: _direct('block_tridiag'), lambda: _circuit('Piline'),
                                  lambda: _circuit('BuckConverter'), lambda: _circuit('BatteryNCapacitors'), _newton],
                         ids=['pfasst-heat-block', 'spectral-block', 'linearized-block', 'banded-solve',
                              'block-tridiag-solve', 'piline-block', 'buck-converter-block',
                              'battery-n-capacitors-block', 'newton-vanderpol-block'])
def test_captured_code_reads_nothing_on_the_host(make):
    """The fused block's loop body (PFASST heat, Rayleigh-Benard, the linearized sweeper, the circuit problems' dense
    solves, a Newton ODE's device loop) and the direct sparse solves, with ``dt`` a 0-d tensor as the fused lanes
    give it, traced once: no operation reads a value on the host, so a CUDA graph holds them."""
    fn, args = make()
    assert _host_reads_in(fn, *args) == []


@pytest.mark.parametrize('name', ['VanDerPol', 'Lorenz', 'ChemicalReaction3Var'])
def test_newton_step_is_one_algorithm(monkeypatch, name):
    """A Newton ODE solves each step's linear systems with one call, eager and under a capture: the system under
    GenericImplicit through ``ShardedController(2)``, eager and under a simulated capture (the Newton loops take
    the device loop's plain version), equal ``niter`` and ``uend`` bit for bit."""
    from pysdc_tpu_torch.models import odes

    def run():
        desc = dict(problem_class=getattr(odes, name), problem_params=dict(device='cpu'),
                    sweeper_class=pysdc_tpu_torch.GenericImplicit,
                    sweeper_params=dict(num_nodes=3, quad_type='RADAU-RIGHT', QI='LU'),
                    level_params=dict(dt=0.02, restol=1e-10), step_params=dict(maxiter=10))
        ctrl = pysdc_tpu_torch.ShardedController(2, {'logger_level': 40}, desc)
        uend, stats = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, 0.08)
        return uend, _summary(pysdc_tpu_torch, ctrl, uend, stats)

    eager, eager_summary = run()
    monkeypatch.setattr(loops, 'capturing', lambda x: True)
    captured, captured_summary = run()
    assert eager_summary['lane'] == captured_summary['lane'] == ['fused']
    assert eager_summary['niter'] == captured_summary['niter'] and len(eager_summary['niter']) == 4
    assert torch.equal(captured, eager)
