"""The transfer layer of the PyTorch port against the JAX package (float64, CPU).

The same inputs, made from a seed with numpy, go through the JAX function and
its counterpart in the port.  Tolerances: the interpolation matrices are the
same numpy code (1e-14); ``MeshTransfer`` on both apply paths (roll/stride
stencils and the dense per-axis contraction) 1e-13; ``FFTTransfer`` 1e-12;
``BaseTransfer`` restrict / prolong / prolong_f on a seeded two-level state
1e-12 relative to the field's size.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import pysdc_tpu
import pysdc_tpu_torch
from pysdc_tpu.core.state import LevelState as JaxLevelState
from pysdc_tpu.core.step import Step as JaxStep
from pysdc_tpu.models.heat import HeatND as JaxHeat, HeatNDForced as JaxHeatForced
from pysdc_tpu.transfer import space_fft as jax_fft, space_mesh as jax_mesh
from pysdc_tpu_torch.core.errors import TransferError, UnlockError
from pysdc_tpu_torch.core.level import Level
from pysdc_tpu_torch.core.step import Step
from pysdc_tpu_torch.models.heat import HeatND, HeatNDForced
from pysdc_tpu_torch.transfer import BaseTransfer, FFTTransfer, MeshTransfer, NoCoarseTransfer
from pysdc_tpu_torch.transfer.space_mesh import interpolation_matrix_1d
from pysdc_tpu_torch.utils.convert import step_to_numpy, step_to_torch, to_numpy, to_torch


def _fake(shape, bc='periodic'):
    return SimpleNamespace(shape=tuple(shape), bc=bc)


@pytest.mark.parametrize('periodic', [True, False])
@pytest.mark.parametrize('order', [2, 4, 6])
def test_interpolation_matrix_equals_jax(periodic, order):
    if periodic:
        fg, cg = np.arange(64) / 64, np.arange(32) / 32
    else:
        fg, cg = np.arange(1, 64) / 64, np.arange(1, 32) / 32
    got = interpolation_matrix_1d(fg, cg, k=order, periodic=periodic)
    want = jax_mesh.interpolation_matrix_1d(fg, cg, k=order, periodic=periodic)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    interior = slice(order, -order)
    assert np.allclose(got[interior].sum(axis=1), 1.0, atol=1e-12)


# name -> (fine shape, coarse shape, bc, params, stencil path expected)
MESH_CASES = {
    'periodic-1d': ((64,), (32,), 'periodic', dict(iorder=6, rorder=2, periodic=True), True),
    'periodic-2d': ((32, 32), (16, 16), 'periodic', dict(iorder=6, rorder=2, periodic=True), True),
    'periodic-2d-one-axis': ((32, 16), (16, 16), 'periodic', dict(iorder=4, rorder=4, periodic=True), True),
    'periodic-not-nested': ((48,), (32,), 'periodic', dict(iorder=4, rorder=2, periodic=True), False),
    'dirichlet-1d': ((63,), (31,), 'dirichlet-zero', dict(iorder=6, rorder=2), False),
    'dirichlet-2d': ((15, 15), (7, 7), 'dirichlet-zero', dict(iorder=2, rorder=2), False),
}


@pytest.mark.parametrize('stencils', [True, False])
@pytest.mark.parametrize('case', list(MESH_CASES))
def test_mesh_transfer_matches_jax(case, stencils):
    """restrict and prolong of a seeded node stack (leading axis 4), on the
    stencil path where the grids allow it and after ``disable_stencils()``."""
    fs, cs, bc, params, has_stencil = MESH_CASES[case]
    jt = jax_mesh.MeshTransfer(_fake(fs, bc), _fake(cs, bc), params)
    tt = MeshTransfer(_fake(fs, bc), _fake(cs, bc), params)
    for a, b in zip(tt.P_1d + tt.R_1d, jt.P_1d + jt.R_1d):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-14)
    changing = [i for i, (nf, nc) in enumerate(zip(fs, cs)) if nf != nc]
    assert all((tt.P_sten[i] is not None) == has_stencil and (tt.R_sten[i] is not None) == has_stencil
               for i in changing)
    if not stencils:
        jt.disable_stencils()
        tt.disable_stencils()
        assert tt.P_sten == [None] * len(fs) and tt.R_sten == [None] * len(fs)
    rng = np.random.default_rng(11)
    F, G = rng.standard_normal((4,) + fs), rng.standard_normal((4,) + cs)
    got_r, got_p = tt.restrict(to_torch(F, 'cpu')), tt.prolong(to_torch(G, 'cpu'))
    assert got_r.shape == (4,) + cs and got_p.shape == (4,) + fs
    assert got_r.is_contiguous() and got_p.is_contiguous()
    np.testing.assert_allclose(to_numpy(got_r), np.asarray(jt.restrict(F)), rtol=0, atol=1e-13)
    np.testing.assert_allclose(to_numpy(got_p), np.asarray(jt.prolong(G)), rtol=0, atol=1e-13)


def test_mesh_transfer_takes_containers_and_keeps_float32():
    from pysdc_tpu_torch.core.state import IMEX

    tt = MeshTransfer(_fake((32,)), _fake((16,)), dict(periodic=True))
    rng = np.random.default_rng(0)
    f = IMEX(*(torch.as_tensor(rng.standard_normal((3, 32)), dtype=torch.float32) for _ in range(2)))
    out = tt.restrict(f)
    assert isinstance(out, IMEX) and out.impl.shape == (3, 16) and out.expl.dtype == torch.float32
    tt.disable_stencils()
    np.testing.assert_allclose(to_numpy(tt.restrict(f).impl), to_numpy(out.impl), rtol=0, atol=1e-6)


def test_restriction_is_scaled_transpose_and_odd_order_raises():
    tr = MeshTransfer(_fake((64,)), _fake((32,)), dict(iorder=4, rorder=4))
    assert np.allclose(tr.R_1d[0], 0.5 * tr.P_1d[0].T)
    with pytest.raises(TransferError):
        MeshTransfer(_fake((64,)), _fake((32,)), dict(iorder=3, rorder=2))
    with pytest.raises(TransferError):
        MeshTransfer(_fake((64,)), _fake((32,)), dict(iorder=2, rorder=3))


FFT_SHAPES = [((64, 64), (32, 32)), ((16, 16, 16), (8, 8, 8)), ((2, 64), (2, 32))]


@pytest.mark.parametrize('fs,cs', FFT_SHAPES)
def test_fft_transfer_matches_jax_and_round_trips(fs, cs):
    """Against the JAX transfer to 1e-12, and the Nyquist fold/split
    identity restrict(prolong(g)) == g to 1e-13."""
    jt, tt = jax_fft.FFTTransfer(_fake(fs), _fake(cs), {}), FFTTransfer(_fake(fs), _fake(cs), {})
    rng = np.random.RandomState(1)
    g, f = rng.randn(*cs), rng.randn(*fs)
    tg, tf = to_torch(g, 'cpu'), to_torch(f, 'cpu')
    np.testing.assert_allclose(to_numpy(tt.restrict(tf)), np.asarray(jt.restrict(f)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(to_numpy(tt.prolong(tg)), np.asarray(jt.prolong(g)), rtol=0, atol=1e-12)
    assert (tt.restrict(tt.prolong(tg)) - tg).abs().max().item() < 1e-13
    assert tt.restrict(tf).is_contiguous() and tt.restrict(tf).dtype == torch.float64


def test_fft_transfer_band_limited_and_float32():
    tt = FFTTransfer(_fake((64, 64)), _fake((32, 32)), {})
    x = np.arange(64) / 64
    fb = np.sin(2 * np.pi * 3 * np.outer(x, np.ones(64))) + np.cos(2 * np.pi * 5 * np.outer(np.ones(64), x))
    tfb = to_torch(fb, 'cpu')
    assert (tt.prolong(tt.restrict(tfb)) - tfb).abs().max().item() < 1e-13
    # a float32 field goes through complex64 and comes back float32
    r32 = tt.restrict(tfb.float())
    assert r32.dtype == torch.float32
    assert (r32.double() - tt.restrict(tfb)).abs().max().item() < 1e-5
    with pytest.raises(TransferError):
        FFTTransfer(_fake((63,)), _fake((31,)), {})


def test_no_coarse_transfer():
    tt = NoCoarseTransfer(_fake((8,)), _fake((8,)), {})
    x = torch.arange(8.0)
    assert tt.restrict(x) is x and tt.prolong(x) is x
    with pytest.raises(ValueError):
        NoCoarseTransfer(_fake((8,)), _fake((4,)), {})


# ----------------------------------------------------------------------
# BaseTransfer on a seeded two-level state
# ----------------------------------------------------------------------
def _two_level_steps(kind):
    """A two-level step of each package (fine 32 points / 3 nodes, coarse
    16 / 2), plain RHS (``HeatND`` + ``GenericImplicit``) or IMEX RHS."""
    def description(pkg, heat, device):
        return dict(
            problem_class=heat,
            problem_params=dict(nvars=[32, 16], nu=0.1, freq=2, bc='periodic', **device),
            sweeper_class=pkg.GenericImplicit if kind == 'plain' else pkg.IMEXSweeper,
            sweeper_params=dict(num_nodes=[3, 2], quad_type='RADAU-RIGHT', QI='LU'),
            level_params=dict(dt=0.1),
            space_transfer_params=dict(iorder=4, rorder=2, periodic=True),
        )

    jheat, theat = (JaxHeat, HeatND) if kind == 'plain' else (JaxHeatForced, HeatNDForced)
    jstep = JaxStep(description(pysdc_tpu, jheat, {}))
    tstep = Step(description(pysdc_tpu_torch, theat, dict(device='cpu')))
    for step in (jstep, tstep):
        for lvl in step.levels:
            lvl.status.time = 0.3
    return jstep, tstep


def _seeded_fine_state(jstep, kind, rng):
    """u, f and tau of the JAX step's fine level as independent seeded fields."""
    u, tau = rng.standard_normal((4, 32)), 1e-2 * rng.standard_normal((3, 32))
    f = rng.standard_normal((4, 32))
    if kind == 'imex':
        f = (f, rng.standard_normal((4, 32)))
    levels = [dict(state=(u, f, tau), uold=None, fold=None), dict(state=None, uold=None, fold=None)]
    _step_to_jax(jstep, levels)
    jstep.levels[0].status.unlocked = True


def _levels_close(tstep, jstep, tol=1e-12):
    for got, want in zip(step_to_numpy(tstep), step_to_numpy(jstep)):
        for key in ('state', 'uold', 'fold'):
            assert (got[key] is None) == (want[key] is None), key
            if want[key] is None:
                continue
            leaves_g, leaves_w = _leaves(got[key]), _leaves(want[key])
            assert len(leaves_g) == len(leaves_w)
            for g, w in zip(leaves_g, leaves_w):
                np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(1.0, np.abs(w).max()))


def _leaves(x):
    if isinstance(x, tuple):
        return [leaf for part in x for leaf in _leaves(part)]
    return [np.asarray(x)]


@pytest.mark.parametrize('kind', ['plain', 'imex'])
def test_base_transfer_restrict_prolong_match_jax(kind):
    """restrict, prolong and prolong_f, each from the same numbers: the JAX
    step's level states are carried across as numpy before every call."""
    jstep, tstep = _two_level_steps(kind)
    rng = np.random.default_rng(5)
    _seeded_fine_state(jstep, kind, rng)
    jt, tt = jstep.base_transfers[0], tstep.base_transfers[0]
    np.testing.assert_allclose(tt.Pcoll, jt.Pcoll, rtol=0, atol=1e-14)
    np.testing.assert_allclose(tt.Rcoll, jt.Rcoll, rtol=0, atol=1e-14)

    step_to_torch(step_to_numpy(jstep), tstep)
    assert tstep.levels[0].status.unlocked and not tstep.levels[1].status.unlocked
    jt.restrict()
    tt.restrict()
    assert tstep.levels[1].status.unlocked
    _levels_close(tstep, jstep)
    assert np.abs(to_numpy(tstep.levels[1].tau)).max() > 1e-3  # the FAS correction is not trivially zero

    # a coarse sweep's worth of change: move the coarse node values
    G = jstep.levels[1]
    G.state = G.state._replace(u=G.state.u + 1e-1 * rng.standard_normal(G.state.u.shape))
    before = step_to_numpy(jstep)
    for method in ('prolong', 'prolong_f'):
        step_to_torch(before, tstep)
        _step_to_jax(jstep, before)
        getattr(jt, method)()
        getattr(tt, method)()
        _levels_close(tstep, jstep)
        assert np.abs(to_numpy(tstep.levels[0].u) - before[0]['state'].u).max() > 1e-3


def _step_to_jax(jstep, levels):
    """Put the numpy ``levels`` back into the JAX step (the twin of step_to_torch)."""
    import jax.numpy as jnp

    from pysdc_tpu.core.state import IMEX as JaxIMEX

    def rhs(f):
        return JaxIMEX(*(jnp.asarray(part) for part in f)) if isinstance(f, tuple) else jnp.asarray(f)

    for data, lvl in zip(levels, jstep.levels):
        if data['state'] is None:
            continue
        u, f, tau = data['state']
        lvl.state = JaxLevelState(u=jnp.asarray(u), f=rhs(f), tau=jnp.asarray(tau))
        lvl.uold = None if data['uold'] is None else jnp.asarray(data['uold'])
        lvl.fold = None if data['fold'] is None else rhs(data['fold'])


def test_base_transfer_finter_switch_takes_prolong_f():
    jstep, tstep = _two_level_steps('plain')
    tt = tstep.base_transfers[0]
    fine, coarse = tstep.levels
    fine.predict(fine.prob.u_exact(0.0))
    fine.update_nodes()
    tt.restrict()
    coarse.update_nodes()
    snapshot = step_to_numpy(tstep)
    tt.prolong_f()
    want = to_numpy(fine.f)
    step_to_torch(snapshot, tstep)
    tt.finter = True
    tt.prolong()
    np.testing.assert_array_equal(to_numpy(fine.f), want)
    step_to_torch(snapshot, tstep)
    tt.finter = False
    tt.prolong()  # re-evaluates f instead of interpolating it
    assert np.abs(to_numpy(fine.f) - want).max() > 0


def _make_level(nvars, num_nodes, dt):
    prob = HeatND(nvars=nvars, nu=0.1, freq=2, bc='periodic', device='cpu')
    sweep = pysdc_tpu_torch.GenericImplicit({'num_nodes': num_nodes, 'QI': 'LU'})
    lvl = Level(prob, sweep, {'dt': dt, 'restol': 1e-12})
    lvl.status.time = 0.0
    return lvl


def test_fas_tau_vanishes_on_matching_levels():
    """With identical space/collocation resolution, tau must vanish."""
    fine, coarse = _make_level(64, 3, 0.1), _make_level(64, 3, 0.1)
    tr = BaseTransfer(fine, coarse, {}, MeshTransfer, dict(iorder=4, rorder=4))
    fine.predict(fine.prob.u_exact(0.0))
    fine.update_nodes()
    tr.restrict()
    assert coarse.state.tau.abs().max().item() < 1e-13
    assert coarse.uold is coarse.state.u and coarse.fold is coarse.state.f


def test_fas_prolongation_identity_without_coarse_change():
    """Prolongation of an unchanged coarse level must leave the fine level as is."""
    fine, coarse = _make_level(64, 3, 0.1), _make_level(32, 3, 0.1)
    tr = BaseTransfer(fine, coarse, {}, MeshTransfer, dict(iorder=4, rorder=4))
    fine.predict(fine.prob.u_exact(0.0))
    fine.update_nodes()
    u_before = fine.state.u.clone()
    tr.restrict()
    tr.prolong()  # coarse unchanged since restriction -> correction is zero
    assert (fine.state.u - u_before).abs().max().item() < 1e-13


def test_locked_levels_raise_and_reset_clears_uold():
    fine, coarse = _make_level(64, 3, 0.1), _make_level(32, 3, 0.1)
    tr = BaseTransfer(fine, coarse, {}, MeshTransfer, dict(iorder=4, rorder=4))
    with pytest.raises(UnlockError):
        tr.restrict()
    with pytest.raises(UnlockError):
        tr.prolong()
    with pytest.raises(UnlockError):
        tr.prolong_f()
    with pytest.raises(ValueError, match='coarse_op'):
        BaseTransfer(fine, coarse, dict(coarse_op='other'), MeshTransfer, {})
    fine.predict(fine.prob.u_exact(0.0))
    tr.restrict()
    assert coarse.uold is not None and coarse.fold is not None
    coarse.reset_level()
    assert coarse.uold is None and coarse.fold is None and coarse.state is None


def test_galerkin_coarse_operator_matches_dense_product_and_jax():
    """The installed coarse operator equals the explicit dense R A P (1e-12)
    and the JAX package's; the prepared node solvers are redone for it."""
    def description(pkg, heat, device):
        return dict(
            problem_class=heat,
            problem_params=dict(nu=0.1, freq=2, nvars=[(16, 16), (8, 8)], bc='periodic', backend='sparse', **device),
            sweeper_class=pkg.GenericImplicit,
            sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=[3], QI='LU'),
            level_params=dict(restol=1e-9, dt=0.05),
            base_transfer_params=dict(coarse_op='galerkin'),
            space_transfer_params=dict(rorder=2, iorder=2, periodic=True),
        )

    tstep = Step(description(pysdc_tpu_torch, HeatND, dict(device='cpu')))
    jstep = JaxStep(description(pysdc_tpu, JaxHeat, {}))
    st = tstep.base_transfers[0].space_transfer
    A_f = tstep.levels[0].prob.A.A.to_dense()
    A_c = tstep.levels[1].prob.A.A.to_dense()
    R_nd, P_nd = np.kron(st.R_1d[0], st.R_1d[1]), np.kron(st.P_1d[0], st.P_1d[1])
    np.testing.assert_allclose(A_c, R_nd @ A_f @ P_nd, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(A_c, np.asarray(jstep.levels[1].prob.A.A.to_dense()), rtol=1e-12, atol=1e-12)
    assert tstep.levels[1].prob.A.device.type == 'cpu'
    assert tstep.levels[1].prob.accepts_node_index == jstep.levels[1].prob.accepts_node_index

    eigen = description(pysdc_tpu_torch, HeatND, dict(device='cpu'))
    eigen['problem_params']['backend'] = 'eigen'
    with pytest.raises(TransferError, match='sparse'):
        Step(eigen)
    fft = description(pysdc_tpu_torch, HeatND, dict(device='cpu'))
    fft['space_transfer_class'] = FFTTransfer
    with pytest.raises(TransferError, match='MeshTransfer'):
        Step(fft)


def test_step_honours_transfer_classes_and_per_level_lists():
    """Only a list is per-level (a tuple nvars is one grid); a shorter list
    repeats its last entry; the description's transfer classes and params
    reach the transfers; only neighbouring levels transfer."""
    from pysdc_tpu_torch.core.errors import ParameterError

    class MyBase(BaseTransfer):
        pass

    desc = dict(
        problem_class=HeatND,
        problem_params=dict(nvars=[(16, 16), (8, 8), (8, 8)], bc='periodic', device='cpu'),
        sweeper_class=pysdc_tpu_torch.GenericImplicit,
        sweeper_params=dict(num_nodes=[3, 2]),
        level_params=dict(dt=0.1, nsweeps=[1, 2, 1]),
        base_transfer_class=MyBase,
        base_transfer_params=dict(finter=True),
        space_transfer_class=FFTTransfer,
    )
    step = Step(desc)
    assert [lvl.prob.shape for lvl in step.levels] == [(16, 16), (8, 8), (8, 8)]
    assert [lvl.sweep.coll.num_nodes for lvl in step.levels] == [3, 2, 2]
    assert [lvl.params.nsweeps for lvl in step.levels] == [1, 2, 1]
    assert [lvl.level_index for lvl in step.levels] == [0, 1, 2]
    assert all(type(bt) is MyBase and bt.finter and isinstance(bt.space_transfer, FFTTransfer)
               for bt in step.base_transfers) and len(step.base_transfers) == 2
    assert step.base_transfers[0].same_nodes is False and step.base_transfers[1].same_nodes is True
    with pytest.raises(ParameterError, match='non-neighbor'):
        step.transfer(step.levels[0], step.levels[2])
    one = Step(dict(desc, problem_params=dict(nvars=(16, 16), bc='periodic', device='cpu'),
                    sweeper_params=dict(num_nodes=3), level_params=dict(dt=0.1)))
    assert len(one.levels) == 1 and one.base_transfers == []
