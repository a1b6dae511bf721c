"""Kernel K1: the periodic cross stencil, by hand in CUDA for Hopper.

The counterpart of ``pysdc_tpu/ops/pallas/stencil.py`` (``cross_stencil_2d``,
``stencil2d_periodic`` and the plain ``_roll_cross_2d``).  The kernels live in
``pysdc_tpu_torch/csrc/cross_stencil.cu``; they replace the Pallas kernels
``_cross2d_rows_db_kernel`` and ``_cross2d_kernel`` and need no alignment
of the grid.  The sharded halo applies of the JAX module are in
:mod:`pysdc_tpu_torch.ops.halo`: one launch of K1 on each ghost-extended slab.

A tensor on the CPU takes the plain version; a CUDA tensor launches a kernel
or raises.  Two kernels share the work, chosen by :func:`choose_path` from
the shape, the taps, the dtype and the alignment alone:

- ``'bands'``: centred tap tables of radius 1 to 3 on each axis (orders 2, 4,
  6 of ``ops/fd.py``) on grids whose rows are a multiple of 16 bytes and at
  least one band (32 lanes x 16 bytes) wide.  A warp marches down a band of
  rows with the rows arriving by ``cp.async``;
- ``'general'``: everything else (odd sizes, narrow grids, other tables).

A complex field takes the same kernels on its interleaved real view: the
taps are real, so the stencil acts on the real and imaginary parts alike, and
in the ``(..., nx, 2 ny)`` float view of a contiguous ``(..., nx, ny)``
complex tensor a shift by ``s`` complex columns is a shift by ``2 s`` float
columns (wrapping exactly, since ``2 ny`` is the period).  The y offsets
double and a centred table of radius ``r`` becomes one of radius ``2 r`` with
zeros at the odd offsets (:func:`interleaved_terms`); complex64 runs the
float32 kernel, complex128 the float64 one.  A complex tensor that has no such
view (not contiguous) raises.

``cross_stencil_2d.launches`` counts the launches, ``cross_stencil_2d.paths``
counts them by path, on the host.  ``cross_stencil_2d.device_count``, where a
caller sets it to a 0-d int64 tensor on the card, gets one added at each
launch, on the launch's stream: a CUDA graph that captured the launch counts
it again at every replay.  Each apply is a device span ``stencil.apply`` while
tracing is on (``utils/trace.py``).  ``path='general'`` (or ``'bands'``) forces a path, for
checks and timings; forcing ``'bands'`` where it does not apply raises.

Gradients (the counterpart of the JAX kernel's ``custom_vmap`` rule and of
``jax.grad`` through it): a tensor that a gradient is asked of
(:func:`~pysdc_tpu_torch.ops.kernels.build.differentiated`) goes through
:class:`_CrossStencil`, an ``autograd.Function`` whose rules are launches of
the same kernel.  The operator is linear, so nothing is saved: the adjoint is
K1 with the mirrored table (:func:`mirrored_terms`), the tangent of ``K u`` is
``K`` of the tangent, and a ``torch.func.vmap`` moves the mapped axis in front
as one more leading batch axis and launches once.  On the CPU the same
Function runs with the plain version as its launch, so the CPU tests drive
every rule; only the CUDA launch is left to the card.
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace

import torch

from pysdc_tpu_torch.ops.kernels.build import current_stream, differentiated
from pysdc_tpu_torch.utils import trace

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}

# geometry of the bands path (checked against the library's own constants when it loads)
BAND_LANE_BYTES = 16   #: bytes a lane moves at once
BAND_BYTES = 32 * BAND_LANE_BYTES  #: bytes of a row in a full band: 128 float32 or 64 float64 columns
BAND_MAX_RADIUS = 3    #: centred tables of 3, 5 and 7 taps an axis have an instantiation
BAND_PREFETCH = 8      #: rows a warp keeps in flight ahead of the row it consumes
BAND_ROW_CHOICES = (128, 64, 32, 16)  #: rows a warp marches over, largest first
BAND_TARGET_ITEMS = 1024  #: bands a launch should have at least: about 8 warps on each of 132 SMs


def _roll_cross_2d(u, terms):
    """Plain version: the same function as the kernel, as a sum of rolls."""
    (coeff_x, offs_x), (coeff_y, offs_y) = terms
    acc = torch.zeros_like(u)
    for c, s in zip(coeff_x, offs_x):
        acc = acc + float(c) * torch.roll(u, -int(s), dims=-2)
    for c, s in zip(coeff_y, offs_y):
        acc = acc + float(c) * torch.roll(u, -int(s), dims=-1)
    return acc


def _plain(u, terms, path=None):
    """The plain version with the signature of :func:`_launch` (``path`` has no meaning there)."""
    return _roll_cross_2d(u, terms)


@functools.lru_cache(maxsize=64)
def mirrored_terms(terms):
    """The tap table of the adjoint: ``roll(u, -s)`` transposed is
    ``roll(u, s)``, so every offset changes sign.  The pairs stay in order of
    offset, so a centred table ``-r..r`` stays centred with its coefficients
    reversed, and the adjoint takes the path the forward takes."""
    out = []
    for coeff, offs in terms:
        pairs = sorted((-int(s), float(c)) for c, s in zip(coeff, offs))
        out.append((tuple(c for _, c in pairs), tuple(s for s, _ in pairs)))
    return tuple(out)


class _CrossStencil(torch.autograd.Function):
    """``launch(u, terms, path)`` under autograd and ``torch.func``.

    ``launch`` is :func:`_launch` on the card and :func:`_plain` on the CPU.
    Every rule is one more call of ``launch``: the backward with the mirrored
    table, the jvp on the tangent, the vmap rule once on the batch folded in
    front (the JAX kernel's ``custom_vmap`` rule, ``ops/pallas/stencil.py:116``)."""

    @staticmethod
    def forward(u, terms, path, launch):
        return launch(u, terms, path)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.terms, ctx.launch = inputs[1], inputs[3]

    @staticmethod
    def backward(ctx, grad):
        return _CrossStencil.apply(grad.contiguous(), mirrored_terms(ctx.terms), None, ctx.launch), None, None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        return _CrossStencil.apply(tangent.contiguous(), ctx.terms, None, ctx.launch)

    @staticmethod
    def vmap(info, in_dims, u, terms, path, launch):
        if in_dims[0] is None:
            return _CrossStencil.apply(u, terms, path, launch), None
        return _CrossStencil.apply(u.movedim(in_dims[0], 0).contiguous(), terms, path, launch), 0


def centred_radius(offs) -> int | None:
    """``r`` when ``offs`` is exactly ``-r, ..., r`` (r >= 1), else None."""
    n = len(offs)
    r = (n - 1) // 2
    if n < 3 or n % 2 == 0 or tuple(int(s) for s in offs) != tuple(range(-r, r + 1)):
        return None
    return r


def band_cols(itemsize: int) -> int:
    """Columns of a full band: 128 for float32, 64 for float64."""
    return BAND_BYTES // itemsize


def band_rows(nb: int, nx: int, ny: int, itemsize: int) -> int:
    """Rows a warp marches over: the largest choice that still gives the
    launch ``BAND_TARGET_ITEMS`` bands (a 2048^2 float32 plane: 32 rows,
    1024 bands; four planes: 128 rows), never more than ``nx``."""
    ncb = -(-ny // band_cols(itemsize))
    for rows in BAND_ROW_CHOICES:
        if nb * -(-nx // rows) * ncb >= BAND_TARGET_ITEMS:
            return min(rows, nx)
    return min(BAND_ROW_CHOICES[-1], nx)


def choose_path(shape, terms, itemsize: int, aligned: bool = True) -> str:
    """``'bands'`` or ``'general'`` for a contiguous tensor of ``shape``.

    A pure function of the shape, the tap table, the element size and
    whether the data pointer is 16-byte aligned; it needs no card."""
    (_, offs_x), (_, offs_y) = terms
    rx, ry = centred_radius(offs_x), centred_radius(offs_y)
    if rx is None or ry is None or max(rx, ry) > BAND_MAX_RADIUS:
        return 'general'
    ny = shape[-1]
    if not aligned or (ny * itemsize) % BAND_LANE_BYTES or ny * itemsize < BAND_BYTES:
        return 'general'
    return 'bands'


@functools.lru_cache(maxsize=None)
def _library(device_index: int) -> SimpleNamespace:
    """The K1 library with its argument types set, and its limits on the
    device ``device_index`` (built at first use, never at import)."""
    from pysdc_tpu_torch.ops.kernels.build import load

    lib = load('cross_stencil')
    lib.cross_stencil_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
        ctypes.c_void_p,
    ]
    lib.cross_stencil_launch.restype = ctypes.c_int
    lib.cross_stencil_bands_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.cross_stencil_bands_launch.restype = ctypes.c_int
    limits = {}
    for name in ('tile_rows', 'tile_cols', 'max_taps', 'max_smem', 'band_bytes', 'band_max_radius', 'band_prefetch'):
        fn = getattr(lib, f'cross_stencil_{name}')
        fn.argtypes = []
        fn.restype = ctypes.c_int
        with torch.cuda.device(device_index):
            limits[name] = fn()
    ours = (BAND_BYTES, BAND_MAX_RADIUS, BAND_PREFETCH)
    theirs = (limits['band_bytes'], limits['band_max_radius'], limits['band_prefetch'])
    if ours != theirs:
        raise RuntimeError(f'cross_stencil: band geometry {ours} of the wrapper differs from the library\'s {theirs}')
    return SimpleNamespace(launch=lib.cross_stencil_launch, launch_bands=lib.cross_stencil_bands_launch, **limits)


@functools.lru_cache(maxsize=256)
def _plan(terms, dtype, index: int) -> SimpleNamespace:
    """What a launch with this tap table, dtype and device needs, checked once
    and kept: the per-call work is then the shape checks and the launch."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f'cross_stencil_2d kernel takes float32 or float64, got {dtype}')
    (coeff_x, offs_x), (coeff_y, offs_y) = terms
    if len(coeff_x) != len(offs_x) or len(coeff_y) != len(offs_y):
        raise ValueError('each axis needs as many coefficients as offsets')
    lib = _library(index)
    if max(len(offs_x), len(offs_y)) > lib.max_taps:
        raise ValueError(f'cross_stencil_2d kernel takes at most {lib.max_taps} taps per axis')
    rx = max((abs(int(s)) for s in offs_x), default=0)
    ry = max((abs(int(s)) for s in offs_y), default=0)
    itemsize = torch.empty((), dtype=dtype).element_size()
    smem = (lib.tile_rows + 2 * rx) * (lib.tile_cols + 2 * ry) * itemsize
    general = []
    for coeff, offs in terms:
        n = len(offs)
        general += [n, (ctypes.c_int * max(n, 1))(*(int(s) for s in offs)),
                    (ctypes.c_double * max(n, 1))(*(float(c) for c in coeff))]
    bands = [arg for coeff, r in ((coeff_x, rx), (coeff_y, ry))
             for arg in (r, (ctypes.c_double * max(len(coeff), 1))(*(float(c) for c in coeff)))]
    return SimpleNamespace(lib=lib, terms=terms, code=_DTYPE_CODES[dtype], itemsize=itemsize, radius=(rx, ry),
                           general=tuple(general), bands=tuple(bands), general_smem=smem, by_shape={})


def _shape_plan(plan, shape, aligned: bool) -> SimpleNamespace:
    """The path, the grid checks and the launch geometry for a tensor of
    ``shape`` (kept on the plan: a sweep launches the same shape many times)."""
    nx, ny = shape[-2:]
    nb = 1
    for n in shape[:-2]:
        nb *= n
    if nx * ny >= 2**31:
        raise ValueError(f'shape {tuple(shape)} exceeds the kernel grid limits')
    geo = SimpleNamespace(path=choose_path(shape, plan.terms, plan.itemsize, aligned), nb=nb,
                          rows=band_rows(nb, nx, ny, plan.itemsize),
                          general_grid_ok=nb <= 65535 and -(-nx // plan.lib.tile_rows) <= 65535)
    plan.by_shape[(shape, aligned)] = geo
    return geo


def _launch(u: torch.Tensor, terms, path=None, rows=None) -> torch.Tensor:
    if u.dim() < 2:
        raise ValueError(f'cross_stencil_2d needs at least 2 dims, got shape {tuple(u.shape)}')
    if not u.is_contiguous():
        raise ValueError('cross_stencil_2d kernel needs a contiguous tensor')
    index = u.device.index if u.device.index is not None else torch.cuda.current_device()
    plan = _plan(terms, u.dtype, index)
    out = torch.empty_like(u)
    if u.numel() == 0:
        return out
    aligned = (u.data_ptr() | out.data_ptr()) % BAND_LANE_BYTES == 0
    geo = plan.by_shape.get((u.shape, aligned)) or _shape_plan(plan, u.shape, aligned)
    chosen = geo.path
    if path is not None and path != chosen:
        if path != 'general':
            raise ValueError(f'cross_stencil_2d: path {path!r} does not take shape {tuple(u.shape)} with radius '
                             f'{plan.radius}, {u.dtype}, 16-byte aligned: {aligned}')
        chosen = path
    nx, ny = u.shape[-2:]
    head = (plan.code, u.data_ptr(), out.data_ptr(), geo.nb, nx, ny)
    if chosen == 'bands':
        args = head + plan.bands + (geo.rows if rows is None else int(rows), current_stream(index))
        launch = plan.lib.launch_bands
    else:
        if not geo.general_grid_ok:
            raise ValueError(f'shape {tuple(u.shape)} exceeds the grid limits of the general path')
        if plan.general_smem > plan.lib.max_smem:
            raise ValueError(f'stencil radius {plan.radius} needs a {plan.general_smem}-byte tile; '
                             f'the block limit is {plan.lib.max_smem}')
        args = head + plan.general + (current_stream(index),)
        launch = plan.lib.launch
    if torch.cuda.current_device() == index:
        err = launch(*args)
    else:
        with torch.cuda.device(index):
            err = launch(*args)
    if err != 0:
        raise RuntimeError(f'cross_stencil_2d kernel ({chosen} path) launch failed with CUDA error {err}')
    cross_stencil_2d.launches += 1
    cross_stencil_2d.paths[chosen] += 1
    if cross_stencil_2d.device_count is not None:
        cross_stencil_2d.device_count.add_(1)
    return out


@functools.lru_cache(maxsize=64)
def interleaved_terms(terms):
    """The tap table of ``terms`` on the interleaved real view of a complex
    field: the y offsets doubled, and a centred y table of radius ``r`` filled
    to the centred table of radius ``2 r`` with zeros at the odd offsets (so
    that radius-1 tables of order 2 stay on the bands path)."""
    (coeff_x, offs_x), (coeff_y, offs_y) = terms
    r = centred_radius(offs_y)
    if r is None:
        y = (tuple(float(c) for c in coeff_y), tuple(2 * int(s) for s in offs_y))
    else:
        doubled = {2 * int(s): float(c) for c, s in zip(coeff_y, offs_y)}
        offs = tuple(range(-2 * r, 2 * r + 1))
        y = (tuple(doubled.get(s, 0.0) for s in offs), offs)
    return (tuple(float(c) for c in coeff_x), tuple(int(s) for s in offs_x)), y


def interleaved(u: torch.Tensor) -> torch.Tensor:
    """The ``(..., nx, 2 ny)`` real view of a contiguous complex ``(..., nx, ny)`` tensor (no copy); raises for a
    tensor that has none."""
    if not u.is_contiguous():
        raise ValueError(f'cross_stencil_2d: a complex field needs a contiguous tensor for its interleaved real view, '
                         f'got strides {u.stride()} for shape {tuple(u.shape)}')
    return torch.view_as_real(u).view(tuple(u.shape[:-1]) + (2 * u.shape[-1],))


def cross_stencil_2d(u: torch.Tensor, terms, path=None) -> torch.Tensor:
    """Periodic cross stencil on the trailing two axes; leading axes batch.

    ``terms = ((coeff_x, offs_x), (coeff_y, offs_y))``, tuples of Python
    floats and ints.  Equal to ``sum_d sum_s c_{d,s} * roll(u, -s, axis=d)``.
    On a CUDA tensor one launch of a K1 kernel computes all taps in one
    pass over device memory (``path`` forces ``'bands'`` or ``'general'``);
    on a CPU tensor the plain version runs.  A complex tensor goes through
    its interleaved real view with :func:`interleaved_terms`.  A tensor that a
    gradient is asked of goes through :class:`_CrossStencil` (backward, jvp
    and vmap by launches of the same kernel)."""
    if u.is_complex():
        out = cross_stencil_2d(interleaved(u), interleaved_terms(terms), path)
        return torch.view_as_complex(out.view(tuple(u.shape) + (2,)))
    if u.device.type == 'cpu':
        launch = _plain
    elif u.device.type == 'cuda':
        launch = _launch
    else:
        raise ValueError(f'cross_stencil_2d runs on cuda or cpu tensors, got {u.device}')
    with trace.device_span('stencil.apply'):
        if differentiated(u):
            return _CrossStencil.apply(u, terms, path, launch)
        return launch(u, terms, path)


cross_stencil_2d.launches = 0
cross_stencil_2d.paths = {'bands': 0, 'general': 0}
cross_stencil_2d.device_count = None


def stencil2d_periodic(u: torch.Tensor, c0: float, cx: float, cy: float) -> torch.Tensor:
    """Periodic 5-point stencil
    ``c0*u + cx*(roll(u,1,0)+roll(u,-1,0)) + cy*(roll(u,1,1)+roll(u,-1,1))``,
    a thin wrapper over :func:`cross_stencil_2d`."""
    terms = ((float(cx), float(c0), float(cx)), (-1, 0, 1)), ((float(cy), float(cy)), (-1, 1))
    return cross_stencil_2d(u, terms)
