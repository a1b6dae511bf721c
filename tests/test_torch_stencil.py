"""Kernel K1 module of the PyTorch port against the JAX package.

On the CPU the port's ``cross_stencil_2d`` runs its plain version; it must
agree with the JAX ``cross_stencil_2d`` (Pallas in interpret mode on aligned
grids, its roll path otherwise) and with the JAX ``_roll_cross_2d``, float64,
rtol 1e-13 against the scale of the sum (sum|c| * max|u|).  The CUDA kernel
itself runs only on the card (``chip_smoke.py``).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysdc_tpu.ops.fd import get_finite_difference_stencil
from pysdc_tpu.ops.pallas import stencil as jst
from pysdc_tpu_torch.ops.kernels import stencil as tst


def _fd_terms(order):
    coeff, offs = get_finite_difference_stencil(2, order, 'center')
    axis = (tuple(float(c) for c in coeff), tuple(int(s) for s in offs))
    return (axis, axis)


TAP_TABLES = {
    # the three tables of tests/test_pallas_stencil.py
    'second': (((1.0, -2.0, 1.0), (-1, 0, 1)), ((1.5, -3.0, 1.5), (-1, 0, 1))),
    'fourth': (
        ((-1 / 12, 4 / 3, -5 / 2, 4 / 3, -1 / 12), (-2, -1, 0, 1, 2)),
        ((-1 / 12, 4 / 3, -5 / 2, 4 / 3, -1 / 12), (-2, -1, 0, 1, 2)),
    ),
    'asymmetric': (((0.5, -2.0, 1.5), (-2, -1, 0)), ((1.0,), (1,))),
    'fd2': _fd_terms(2),
    'fd4': _fd_terms(4),
    'fd6': _fd_terms(6),
}
SHAPES = [(32, 128), (3, 5, 16, 128), (17, 33)]


def _close(got, want, terms, u):
    scale = sum(abs(c) for coeff, _ in terms for c in coeff) * np.abs(u).max()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13 * scale)


@pytest.mark.parametrize('shape', SHAPES, ids=str)
@pytest.mark.parametrize('table', list(TAP_TABLES))
def test_cross_stencil_matches_jax(table, shape):
    terms = TAP_TABLES[table]
    u = np.random.default_rng(11).standard_normal(shape)
    got = tst.cross_stencil_2d(torch.from_numpy(u), terms).numpy()
    _close(got, np.asarray(jst.cross_stencil_2d(jnp.asarray(u), terms, interpret=True)), terms, u)
    _close(got, np.asarray(jst._roll_cross_2d(jnp.asarray(u), terms)), terms, u)
    _close(tst._roll_cross_2d(torch.from_numpy(u), terms).numpy(), got, terms, u)


def test_stencil2d_periodic_matches_jax():
    u = np.random.default_rng(7).standard_normal((32, 128))
    got = tst.stencil2d_periodic(torch.from_numpy(u), -4.0, 1.0, 1.5).numpy()
    want = np.asarray(jst.stencil2d_periodic(jnp.asarray(u), -4.0, 1.0, 1.5, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13 * 7 * np.abs(u).max())


def test_cpu_path_launches_nothing_and_other_devices_raise():
    before = tst.cross_stencil_2d.launches
    tst.cross_stencil_2d(torch.ones(4, 4, dtype=torch.float64), TAP_TABLES['second'])
    assert tst.cross_stencil_2d.launches == before
    with pytest.raises(ValueError):
        tst.cross_stencil_2d(torch.ones(4, 4, device='meta'), TAP_TABLES['second'])


def test_kernel_module_imports_without_a_card():
    """Importing the wrapper and the build module compiles nothing and needs no nvcc."""
    code = (
        'import pysdc_tpu_torch.ops.kernels.stencil as s, pysdc_tpu_torch.ops.kernels.build as b\n'
        'assert not b._loaded and s._library.cache_info().currsize == 0\n'
        'print(sorted(b.SOURCES))\n'
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert 'cross_stencil' in out.stdout
