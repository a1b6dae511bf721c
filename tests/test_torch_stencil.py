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


# ----------------------------------------------------------------------
# the wrapper's choice of kernel: a pure function, no card needed
# ----------------------------------------------------------------------
@pytest.mark.parametrize('shape, table, itemsize, aligned, want', [
    ((2048, 2048), 'fd2', 4, True, 'bands'),
    ((4, 2048, 2048), 'fd2', 4, True, 'bands'),
    ((2048, 2048), 'fd6', 8, True, 'bands'),
    ((64, 128), 'fd4', 4, True, 'bands'),       # exactly one band wide
    ((64, 132), 'fd4', 4, True, 'bands'),       # one column group wider
    ((40, 64), 'fd2', 8, True, 'bands'),        # one float64 band
    ((40, 66), 'fd2', 8, True, 'bands'),
    ((40, 64), 'fd2', 4, True, 'general'),      # narrower than a float32 band
    ((4, 128), 'fd6', 4, True, 'bands'),        # the window wraps more than once
    ((1, 4096), 'fd2', 4, True, 'bands'),
    ((3, 5, 64, 256), 'second', 4, True, 'bands'),
    ((17, 33), 'fd2', 4, True, 'general'),      # rows are no multiple of 16 bytes
    ((64, 130), 'fd2', 4, True, 'general'),
    ((64, 129), 'fd2', 8, True, 'general'),
    ((16, 16), 'fd2', 4, True, 'general'),      # smaller than a band
    ((2048, 2048), 'asymmetric', 4, True, 'general'),  # no centred table
    ((2048, 2048), 'fd2', 4, False, 'general'),        # a misaligned base
], ids=str)
def test_choose_path(shape, table, itemsize, aligned, want):
    assert tst.choose_path(shape, TAP_TABLES[table], itemsize, aligned) == want


@pytest.mark.parametrize('offs, want', [
    ((-1, 0, 1), 1), ((-2, -1, 0, 1, 2), 2), ((-3, -2, -1, 0, 1, 2, 3), 3), ((-4, -3, -2, -1, 0, 1, 2, 3, 4), 4),
    ((-1, 1), None), ((0,), None), ((-2, -1, 0), None), ((1, 0, -1), None), ((), None),
], ids=str)
def test_centred_radius(offs, want):
    assert tst.centred_radius(offs) == want
    terms = ((tuple(1.0 for _ in offs), offs), TAP_TABLES['fd2'][1])
    eligible = want is not None and want <= tst.BAND_MAX_RADIUS
    assert tst.choose_path((256, 256), terms, 4) == ('bands' if eligible else 'general')


@pytest.mark.parametrize('nb, nx, ny, itemsize, want', [
    (1, 2048, 2048, 4, 32), (4, 2048, 2048, 4, 128), (1, 2048, 2048, 8, 64), (1, 64, 128, 4, 16),
    (1, 4, 128, 4, 4), (1, 1, 4096, 4, 1), (15, 64, 256, 4, 16), (64, 4096, 4096, 4, 128),
], ids=str)
def test_band_rows(nb, nx, ny, itemsize, want):
    rows = tst.band_rows(nb, nx, ny, itemsize)
    assert rows == want and 1 <= rows <= nx
    bands = nb * -(-nx // rows) * -(-ny // tst.band_cols(itemsize))
    assert rows == min(tst.BAND_ROW_CHOICES[-1], nx) or bands >= tst.BAND_TARGET_ITEMS


def test_cpu_tensor_takes_the_plain_version_whatever_path_is_forced():
    """``path`` picks between the two kernels; a CPU tensor reaches neither."""
    u = torch.from_numpy(np.random.default_rng(2).standard_normal((17, 33)))
    want = tst._roll_cross_2d(u, TAP_TABLES['fd2'])
    for path in (None, 'bands', 'general'):
        assert torch.equal(tst.cross_stencil_2d(u, TAP_TABLES['fd2'], path=path), want)
    assert tst.cross_stencil_2d.paths == {'bands': 0, 'general': 0}


def _bands_model(u, terms, rows, itemsize):
    """The bands kernel's index arithmetic in numpy, with the wrapper's
    constants: bands of ``band_cols`` columns and ``rows`` rows; per band a
    ring of ``BAND_PREFETCH + rx + 1`` row buffers filled in arrival order
    (rows modulo nx, halo columns modulo ny), ``BAND_PREFETCH`` rows ahead; a
    rolling window of 2 rx + 1 rows for the x taps; the centre row's buffer
    for the y taps.  A buffer is overwritten the moment its copy is started,
    the earliest the hardware could do it.  ``u`` is float64 whatever
    ``itemsize`` the geometry is computed for: the model checks indices."""
    (cx, ox), (cy, oy) = terms
    rx, ry = tst.centred_radius(ox), tst.centred_radius(oy)
    vec = tst.BAND_LANE_BYTES // itemsize
    cw_full = tst.band_cols(itemsize)
    hp = -(-ry // vec) * vec
    ns = tst.BAND_PREFETCH + rx + 1
    nx, ny = u.shape[-2:]
    planes = u.reshape(-1, nx, ny)
    out = np.full_like(planes, np.nan)
    for b, row0, col0 in np.ndindex(len(planes), -(-nx // rows), -(-ny // cw_full)):
        row0, col0 = row0 * rows, col0 * cw_full
        cw, nrows = min(cw_full, ny - col0), min(rows, nx - row0)
        assert cw % vec == 0
        ring = np.full((ns, hp + cw_full + hp), np.nan)
        total = nrows + 2 * rx
        state = dict(g=(row0 - rx) % nx, started=0, slot=0)

        def start_row():
            if state['started'] < total:
                src, dst = planes[b, state['g']], ring[state['slot']]
                dst[:] = np.nan
                dst[hp:hp + cw] = src[col0:col0 + cw]
                for h in range(ry):
                    dst[hp - 1 - h] = src[(col0 - 1 - h) % ny]
                    dst[hp + cw + h] = src[(col0 + cw + h) % ny]
                state['g'] = state['g'] + 1 if state['g'] + 1 < nx else 0
            state['started'] += 1
            state['slot'] = (state['slot'] + 1) % ns

        for _ in range(tst.BAND_PREFETCH):
            start_row()
        window = [None] * (2 * rx + 1)
        slot_c, slot_mid = 0, ns - rx
        for c in range(total):
            start_row()
            window = window[1:] + [ring[slot_c, hp:hp + cw].copy()]
            if c >= 2 * rx:
                mid = ring[slot_mid]
                acc = np.zeros(cw)
                for k in range(2 * rx + 1):
                    acc = acc + cx[k] * window[k]
                for k in range(2 * ry + 1):
                    acc = acc + cy[k] * mid[hp + k - ry:hp + k - ry + cw]
                out[b, row0 + c - 2 * rx, col0:col0 + cw] = acc
            slot_c, slot_mid = (slot_c + 1) % ns, (slot_mid + 1) % ns
    return out.reshape(u.shape)


@pytest.mark.parametrize('shape, table, dtype, rows', [
    ((64, 128), 'fd2', np.float32, None),       # one band wide
    ((64, 132), 'fd4', np.float32, None),       # a column group wider: a 4-column last band
    ((100, 256), 'fd2', np.float32, None),      # nx that 16 rows do not divide
    ((100, 256), 'fd6', np.float32, 64),
    ((4, 128), 'fd6', np.float32, None),        # nx < radius + 1: the window wraps more than once
    ((1, 4096), 'fd4', np.float32, None),
    ((3, 5, 64, 256), 'second', np.float32, None),
    ((40, 64), 'fd6', np.float64, None),        # float64: 2 columns a lane, two neighbour vectors a side
    ((40, 66), 'fd4', np.float64, 7),
    ((33, 192), 'fourth', np.float64, 128),     # more rows asked for than the grid has
], ids=str)
def test_bands_index_arithmetic_matches_roll(shape, table, dtype, rows):
    terms = TAP_TABLES[table]
    itemsize = np.dtype(dtype).itemsize
    assert tst.choose_path(shape, terms, itemsize) == 'bands'
    nx, ny = shape[-2:]
    if rows is None:
        rows = tst.band_rows(int(np.prod(shape[:-2], dtype=int)), nx, ny, itemsize)
    u = np.random.default_rng(5).standard_normal(shape)
    want = np.zeros(shape)
    for axis, (coeff, offs) in zip((-2, -1), terms):
        for c, s in zip(coeff, offs):
            want = want + c * np.roll(u, -s, axis=axis)
    got = _bands_model(u, terms, min(rows, nx), itemsize)
    assert not np.isnan(got).any()  # every output written, nothing read that was not brought
    _close(got, want, terms, u)
