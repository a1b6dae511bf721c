"""The port's halo applies (``pysdc_tpu_torch/ops/halo.py``) against the JAX
package's on its 8-device mesh (tests/test_pallas_stencil.py:40-160).

On the CPU the port runs the plain version of each slab (the JAX function's
slices); on the card the same frame launches K1 on every ghost-extended slab
(``chip_smoke.py`` holds that route against K1 on the whole field).  Inputs
come from seeded numpy, float64, relative tolerance 1e-13.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysdc_tpu.ops.pallas import stencil as jst
from pysdc_tpu.parallel.mesh import make_mesh as jax_mesh
from pysdc_tpu_torch.core.errors import ProblemError
from pysdc_tpu_torch.ops import halo
from pysdc_tpu_torch.ops.fd import get_finite_difference_stencil
from pysdc_tpu_torch.ops.kernels.stencil import _roll_cross_2d
from pysdc_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)
CPU8 = ['cpu'] * 8
RTOL = 1e-13


def _terms(order):
    coeff, offs = get_finite_difference_stencil(2, order, 'center')
    axis = (tuple(float(c) for c in coeff), tuple(int(s) for s in offs))
    return axis, (tuple(1.5 * c for c in axis[0]), axis[1])


def _space_meshes(n_space):
    """The JAX tests' one-axis 'space' mesh and the port's counterpart."""
    jm = jax.sharding.Mesh(np.asarray(jax.devices()[:n_space]), axis_names=('space',))
    return jm, tmesh.Mesh(np.asarray(CPU8[:n_space], dtype=object), ('space',))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize('n_space', [1, 2, 4, 8])
def test_halo_stencil_apply(n_space):
    """tests/test_pallas_stencil.py:40 and :125 (one shard)."""
    jm, tm = _space_meshes(n_space)
    u = np.random.default_rng(3).standard_normal((8 * n_space, 32))
    want = jax.jit(lambda x: jst.halo_stencil_apply(x, jm, -4.0, 1.0, 1.5, axis='space'))(u)
    halo.halo_cross_apply_batched.shard_applies = 0
    got = halo.halo_stencil_apply(torch.as_tensor(u), tm, -4.0, 1.0, 1.5, axis='space')
    _close(got, want)
    assert halo.halo_cross_apply_batched.shard_applies == n_space


@pytest.mark.parametrize('order', [2, 4, 6])
@pytest.mark.parametrize('n_space', [1, 4])
def test_halo_cross_apply_arbitrary_width(order, n_space):
    """tests/test_pallas_stencil.py:89 at orders 2, 4 and 6, and one shard."""
    jm, tm = _space_meshes(n_space)
    terms = _terms(order)
    u = np.random.default_rng(9).standard_normal((8 * n_space, 32))
    want = jax.jit(lambda x: jst.halo_cross_apply(x, jm, terms, axis='space'))(u)
    got = halo.halo_cross_apply(torch.as_tensor(u), tm, terms, axis='space')
    _close(got, want)
    _close(got, _roll_cross_2d(torch.as_tensor(u), terms))


@pytest.mark.parametrize('order', [2, 4, 6])
def test_halo_cross_apply_batched(order):
    """tests/test_pallas_stencil.py:137: batched inputs on the 8-position space mesh of a (time, node, space) mesh."""
    terms = _terms(order)
    u = np.random.default_rng(0).standard_normal((3, 4, 64, 64))
    want = jax.jit(lambda x: jst.halo_cross_apply_batched(x, jax_mesh(n_time=1, n_space=8), terms, axis='space'))(u)
    mesh = tmesh.make_mesh(n_time=1, n_space=8, devices=CPU8)
    got = halo.halo_cross_apply_batched(torch.as_tensor(u), mesh, terms)
    _close(got, want)
    # eight slabs scattered, two ghosts each, one gather
    assert mesh.traffic == {'copies': 8 * 3, 'gathers': 1}


def test_halo_radius_beyond_the_slab_raises():
    """``rx > nloc`` raises in both packages (pysdc_tpu/ops/pallas/stencil.py:345, :390)."""
    terms = _terms(6)  # rx = 3
    u = np.random.default_rng(1).standard_normal((2, 16, 16))  # 8 slabs of 2 rows
    jm, tm = _space_meshes(8)
    with pytest.raises(ValueError, match='stencil radius 3 exceeds local shard size 2'):
        jst.halo_cross_apply(jnp.asarray(u[0]), jm, terms, axis='space')
    for fn, x in ((halo.halo_cross_apply, u[0]), (halo.halo_cross_apply_batched, u)):
        with pytest.raises(ValueError, match='stencil radius 3 exceeds local shard size 2'):
            fn(torch.as_tensor(x), tm, terms, axis='space')


def test_halo_apply_follows_the_time_row_of_a_time_by_space_mesh():
    """On a (time, space) mesh each time row exchanges among its own space positions."""
    devices = [torch.device('cpu')] * 8
    mesh = tmesh.make_mesh(n_time=2, n_space=4, devices=devices)
    for row in (0, 1):
        with mesh.time_row(row):
            assert mesh.positions('space') == list(mesh.devices[row, 0, :])
    u = torch.as_tensor(np.random.default_rng(4).standard_normal((5, 32, 24)))
    with mesh.time_row(1):
        _close(halo.halo_cross_apply_batched(u, mesh, _terms(4)), _roll_cross_2d(u, _terms(4)))


def test_operator_enable_halo_dispatch():
    """``SeparableFDOperator.enable_halo`` routes ``apply`` through the halo apply (pysdc_tpu/ops/linop.py:158-201)."""
    from pysdc_tpu_torch.models.heat import HeatND

    prob = HeatND(nvars=(32, 32), nu=0.1, freq=2, order=6, bc='periodic', device='cpu')
    u = torch.as_tensor(np.random.default_rng(5).standard_normal((3, 32, 32)))
    want = prob.A.apply(u)
    prob.A.enable_halo(tmesh.make_mesh(n_space=4, devices=CPU8))
    halo.halo_cross_apply_batched.shard_applies = 0
    _close(prob.A.apply(u), want)
    assert halo.halo_cross_apply_batched.shard_applies == 4
    # a complex field keeps the whole-field apply, as in the JAX package
    z = u.to(torch.complex128)
    _close(prob.A.apply(z).real, want)
    assert halo.halo_cross_apply_batched.shard_applies == 4
    prob.A.disable_halo()
    _close(prob.A.apply(u), want)
    assert halo.halo_cross_apply_batched.shard_applies == 4
    with pytest.raises(ProblemError, match='halo apply needs a 2D all-periodic'):
        HeatND(nvars=32, bc='periodic', device='cpu').A.enable_halo(tmesh.make_mesh(n_space=4, devices=CPU8))
