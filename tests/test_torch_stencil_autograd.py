"""Kernel K1 under autograd and ``torch.func``: the rules of its ``autograd.Function``.

On the card ``cross_stencil_2d`` routes a tensor that a gradient is asked of
through ``stencil._CrossStencil``, whose backward, jvp and vmap rules are
launches of the same kernel.  Here the Function runs with the plain version as
its launch (a counting one where the number of launches matters), float64:

- ``gradcheck`` on a symmetric and a non-symmetric table;
- the adjoint identity ``<K u, v> = <u, K^T v>`` for the heat table and the
  2D periodic advection tables (``'center'``: antisymmetric and centred, so the
  bands path both ways; ``'upwind'``: not centred, so the general path);
- ``jacfwd`` and ``vmap`` against the batched apply, one launch a mapped call;
- ``jax.vmap`` of the JAX ``cross_stencil_2d`` (Pallas in interpret mode)
  against ``torch.func.vmap`` of the port's, the same numpy inputs, to 1e-13.

The CUDA launch itself is left to ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as forward_ad

from pysdc_tpu.ops.pallas import stencil as jst
from pysdc_tpu_torch.models.advection import AdvectionND
from pysdc_tpu_torch.models.heat import HeatND
from pysdc_tpu_torch.ops import loops
from pysdc_tpu_torch.ops.kernels import build
from pysdc_tpu_torch.ops.kernels import stencil as tst

torch.set_num_threads(1)

SYMMETRIC = (((1.0, -2.0, 1.0), (-1, 0, 1)), ((1.5, -3.0, 1.5), (-1, 0, 1)))
NON_SYMMETRIC = (((0.5, -2.0, 1.5), (-2, -1, 0)), ((1.0,), (1,)))
TABLES = {'symmetric': SYMMETRIC, 'non-symmetric': NON_SYMMETRIC}


class Counting:
    """The plain version as the Function's launch, counting its calls and the shapes it was given."""

    def __init__(self):
        self.shapes = []

    def __call__(self, u, terms, path=None):
        self.shapes.append(tuple(u.shape))
        return tst._roll_cross_2d(u, terms)


def _apply(launch, terms):
    return lambda u: tst._CrossStencil.apply(u, terms, None, launch)


def _advection_terms(stencil_type):
    return AdvectionND(nvars=(32, 32), stencil_type=stencil_type, device='cpu').A._cross_terms


def _rng_field(shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape))


@pytest.mark.parametrize('name', sorted(TABLES))
def test_gradcheck_through_the_function(name):
    u = _rng_field((6, 8), 1).requires_grad_()
    f = _apply(Counting(), TABLES[name])
    assert torch.autograd.gradcheck(f, (u,))
    assert torch.autograd.gradgradcheck(f, (u,))


@pytest.mark.parametrize('table', ['heat', 'symmetric', 'non-symmetric', 'advection center', 'advection upwind'])
def test_adjoint_identity_and_mirrored_path(table):
    if table == 'heat':
        terms = HeatND(nvars=(32, 32), device='cpu').A._cross_terms
    elif table.startswith('advection'):
        terms = _advection_terms(table.split()[1])
    else:
        terms = TABLES[table]
    u, v = _rng_field((3, 32, 32), 2), _rng_field((3, 32, 32), 3)
    launch = Counting()
    lhs = float((tst._roll_cross_2d(u, terms) * v).sum())
    uu = u.clone().requires_grad_()
    (_apply(launch, terms)(uu) * v).sum().backward()
    rhs = float((u * uu.grad).sum())
    scale = sum(abs(c) for coeff, _ in terms for c in coeff) * float(u.abs().max()) * float(v.abs().sum())
    assert abs(lhs - rhs) <= 1e-14 * scale
    assert launch.shapes == [(3, 32, 32), (3, 32, 32)]  # one forward, one adjoint launch
    mirror = tst.mirrored_terms(terms)
    assert torch.equal(uu.grad, tst._roll_cross_2d(v, mirror))
    assert tst.mirrored_terms(mirror) == tuple((tuple(map(float, c)), tuple(map(int, s))) for c, s in terms)
    # the adjoint takes the path the forward takes (a float64 row of 64 columns is one band)
    for shape in ((64, 64), (8, 64, 128)):
        assert tst.choose_path(shape, mirror, 8) == tst.choose_path(shape, terms, 8)
    if table in ('heat', 'symmetric', 'advection center'):
        assert tst.choose_path((64, 64), mirror, 8) == 'bands'
    if table == 'advection center':
        assert mirror != terms  # antisymmetric: the mirror is the negated table
        assert mirror == tuple((tuple(-c for c in coeff), offs) for coeff, offs in terms)
    if table == 'advection upwind':
        assert tst.choose_path((64, 64), terms, 8) == 'general'


@pytest.mark.parametrize('name', sorted(TABLES))
def test_vmap_and_jacfwd_launch_once_per_mapped_call(name):
    terms = TABLES[name]
    launch = Counting()
    f = _apply(launch, terms)
    batch = _rng_field((5, 6, 8), 4)
    out = torch.func.vmap(f)(batch)
    assert torch.equal(out, tst._roll_cross_2d(batch, terms)) and launch.shapes == [(5, 6, 8)]
    # the mapped axis anywhere: moved in front, one launch
    launch.shapes.clear()
    out = torch.func.vmap(f, in_dims=2, out_dims=2)(batch.permute(1, 2, 0))
    assert torch.equal(out, tst._roll_cross_2d(batch, terms).permute(1, 2, 0)) and launch.shapes == [(5, 6, 8)]
    # jacfwd: one primal launch and one launch of all 48 tangents
    launch.shapes.clear()
    u = batch[0]
    J = torch.func.jacfwd(lambda x: f(x.reshape(6, 8)).reshape(-1))(u.reshape(-1))
    dense = tst._roll_cross_2d(torch.eye(48, dtype=torch.float64).reshape(48, 6, 8), terms).reshape(48, 48).T
    assert torch.equal(J, dense) and sorted(launch.shapes) == [(6, 8), (48, 6, 8)]
    # jvp, forward-mode duals and jacrev agree with the same matrix
    t = batch[1]
    _, tangent = torch.func.jvp(f, (u,), (t,))
    assert torch.equal(tangent, tst._roll_cross_2d(t, terms))
    with forward_ad.dual_level():
        dual = tst.cross_stencil_2d(forward_ad.make_dual(u, t), terms)
        assert torch.equal(forward_ad.unpack_dual(dual).tangent, tangent)
    Jr = torch.func.jacrev(lambda x: tst.cross_stencil_2d(x.reshape(6, 8), terms).reshape(-1))(u.reshape(-1))
    assert torch.equal(Jr, dense)


def test_public_wrapper_routes_through_the_function_only_when_differentiated(monkeypatch):
    """On the CPU ``cross_stencil_2d`` takes the Function with the plain version as launch exactly where a
    gradient is asked of its input; its gradient equals autograd through the rolls, complex fields included."""
    applied = []
    original = tst._CrossStencil.apply

    def spy(*args):
        applied.append(args[3])
        return original(*args)

    monkeypatch.setattr(tst._CrossStencil, 'apply', spy)
    prob = HeatND(nvars=(16, 16), nu=0.1, freq=2, bc='periodic', device='cpu')
    u = _rng_field((3, 16, 16), 5)
    prob.eval_f(u, 0.0)
    assert applied == []
    x = u.clone().requires_grad_()
    (prob.eval_f(x, 0.0) ** 2).sum().backward()
    assert applied and all(fn is tst._plain for fn in applied)
    y = u.clone().requires_grad_()
    (tst._roll_cross_2d(y, prob.A._cross_terms) ** 2).sum().backward()
    assert torch.allclose(x.grad, y.grad, rtol=1e-14, atol=1e-12)
    z = torch.complex(u, _rng_field((3, 16, 16), 6)).requires_grad_()
    assert torch.autograd.gradcheck(lambda w: tst.cross_stencil_2d(w, NON_SYMMETRIC), (z,))
    mapped = torch.func.vmap(lambda w: tst.cross_stencil_2d(w, SYMMETRIC))(z.detach())
    assert torch.equal(mapped, tst.cross_stencil_2d(z.detach(), SYMMETRIC))


def test_differentiated_flags_what_autograd_or_a_transform_follows():
    """The test K1 uses to take its Function, and K2 / K3 to refuse a tensor on the card."""
    u = torch.zeros(4, dtype=torch.float64)
    assert not build.differentiated(u)
    assert build.differentiated(u.clone().requires_grad_())
    with torch.no_grad():
        assert not build.differentiated(u.clone().requires_grad_())
    seen = []
    torch.func.vmap(lambda x: seen.append(build.differentiated(x)) or x)(torch.zeros(2, 4))
    torch.func.grad(lambda x: seen.append(build.differentiated(x)) or x.sum())(u)
    with forward_ad.dual_level():
        seen.append(build.differentiated(forward_ad.make_dual(u, torch.ones_like(u))))
    assert seen == [True, True, True]
    with pytest.raises(NotImplementedError, match='adjoints of K2 and K3'):
        build.refuse_differentiated('dia_spmv', u.clone().requires_grad_())
    build.refuse_differentiated('bsr_spmm', u)


def test_masked_loop_under_vmap_reads_nothing_and_keeps_each_lanes_count():
    """Mapped, the loop runs every masked iteration without a host read; each lane stops where it would alone."""

    def run(x):
        out = loops.masked_loop(lambda c, active: (c[0] / 2,), lambda c: c[0].abs() > 1.0, (x,), 20)
        return out.carry[0], out.counts

    x = torch.tensor([3.0, 100.0, 0.5, 1e5], dtype=torch.float64)
    mapped, counts = torch.func.vmap(run)(x)
    alone = [run(v) for v in x]
    assert torch.equal(mapped, torch.stack([a for a, _ in alone]))
    assert counts.tolist() == [int(c) for _, c in alone] == [2, 7, 0, 17]


def _halving(seen):
    """A masked loop that halves each lane until it is at most 1, recording whether it read and how far it ran."""

    def run(x):
        out = loops.masked_loop(lambda c, active: (c[0] / 2,), lambda c: c[0].abs() > 1.0, (x,), 20)
        seen.append((out.reads > 0, out.steps))
        return out.carry[0]

    return run


LOOP_TRANSFORMS = {
    'vmap': lambda run, x: torch.func.vmap(run)(x),
    'grad': lambda run, x: torch.func.grad(lambda v: run(v).sum())(x),
    'jvp': lambda run, x: torch.func.jvp(run, (x,), (torch.ones_like(x),))[1],
    'vmap of grad': lambda run, x: torch.func.vmap(torch.func.grad(run))(x),
    'grad of vmap': lambda run, x: torch.func.grad(lambda v: torch.func.vmap(run)(v).sum())(x),
}


@pytest.mark.parametrize('name, reads', [('vmap', False), ('grad', True), ('jvp', True), ('vmap of grad', False),
                                         ('grad of vmap', False)])
def test_masked_loop_reads_unless_a_vmap_maps_its_carry(name, reads):
    """Only a mapped carry stops the loop's host reads (``build.mapped``): under ``grad`` or ``jvp`` alone it reads
    and stops after the iterations its largest lane needs, as it does eager; mapped it runs all 20."""
    x = torch.tensor([3.0, 100.0, 0.5, 1e5], dtype=torch.float64)
    seen = []
    got = LOOP_TRANSFORMS[name](_halving(seen), x)
    assert seen == [(reads, 17 if reads else 20)]
    if name in ('grad', 'grad of vmap'):
        assert torch.equal(got, torch.tensor([0.25, 2.0 ** -7, 1.0, 2.0 ** -17], dtype=torch.float64))


@pytest.fixture(scope='module')
def jax_vmapped():
    """``jax.vmap`` of the JAX ``cross_stencil_2d`` (Pallas in interpret mode on an aligned grid) over a batch."""
    batch = np.random.default_rng(8).standard_normal((4, 2, 16, 128))
    return batch, {name: np.asarray(jax.vmap(lambda u, t=terms: jst.cross_stencil_2d(u, t, interpret=True))(
        jnp.asarray(batch))) for name, terms in TABLES.items()}


@pytest.mark.parametrize('name', sorted(TABLES))
def test_vmap_matches_jax_vmap_of_the_pallas_kernel(jax_vmapped, name):
    batch, want = jax_vmapped
    launch = Counting()
    got = torch.func.vmap(_apply(launch, TABLES[name]))(torch.as_tensor(batch))
    assert launch.shapes == [(4, 2, 16, 128)]
    np.testing.assert_allclose(got.numpy(), want[name], rtol=0, atol=1e-13 * np.abs(batch).max())
    public = torch.func.vmap(lambda u: tst.cross_stencil_2d(u, TABLES[name]))(torch.as_tensor(batch))
    np.testing.assert_allclose(public.numpy(), want[name], rtol=0, atol=1e-13 * np.abs(batch).max())
