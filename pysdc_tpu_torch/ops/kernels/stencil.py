"""Kernel K1: the periodic cross stencil, by hand in CUDA for Hopper.

The counterpart of ``pysdc_tpu/ops/pallas/stencil.py`` (``cross_stencil_2d``,
``stencil2d_periodic`` and the plain ``_roll_cross_2d``).  The kernel lives in
``pysdc_tpu_torch/csrc/cross_stencil.cu``; it replaces the Pallas kernels
``_cross2d_rows_db_kernel`` and ``_cross2d_kernel`` and needs no alignment
of the grid.  The sharded halo applies of the JAX module wait for the
sharded controller (ROADMAP queue 1, item 10).

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises.  ``cross_stencil_2d.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace

import torch

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def _roll_cross_2d(u, terms):
    """Plain version: the same function as the kernel, as a sum of rolls."""
    (coeff_x, offs_x), (coeff_y, offs_y) = terms
    acc = torch.zeros_like(u)
    for c, s in zip(coeff_x, offs_x):
        acc = acc + float(c) * torch.roll(u, -int(s), dims=-2)
    for c, s in zip(coeff_y, offs_y):
        acc = acc + float(c) * torch.roll(u, -int(s), dims=-1)
    return acc


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
    limits = {}
    for name in ('tile_rows', 'tile_cols', 'max_taps', 'max_smem'):
        fn = getattr(lib, f'cross_stencil_{name}')
        fn.argtypes = []
        fn.restype = ctypes.c_int
        with torch.cuda.device(device_index):
            limits[name] = fn()
    return SimpleNamespace(launch=lib.cross_stencil_launch, **limits)


@functools.lru_cache(maxsize=64)
def _tap_arrays(terms):
    """The tap table as the C arrays the launcher takes (built once per table)."""
    out = []
    for coeff, offs in terms:
        n = len(offs)
        out += [n, (ctypes.c_int * max(n, 1))(*(int(s) for s in offs)),
                (ctypes.c_double * max(n, 1))(*(float(c) for c in coeff))]
    return tuple(out)


def _launch(u: torch.Tensor, terms) -> torch.Tensor:
    if u.dtype not in _DTYPE_CODES:
        raise TypeError(f'cross_stencil_2d kernel takes float32 or float64, got {u.dtype}')
    if u.dim() < 2:
        raise ValueError(f'cross_stencil_2d needs at least 2 dims, got shape {tuple(u.shape)}')
    if not u.is_contiguous():
        raise ValueError('cross_stencil_2d kernel needs a contiguous tensor')
    (coeff_x, offs_x), (coeff_y, offs_y) = terms
    if len(coeff_x) != len(offs_x) or len(coeff_y) != len(offs_y):
        raise ValueError('each axis needs as many coefficients as offsets')
    nx, ny = u.shape[-2:]
    out = torch.empty_like(u)
    if u.numel() == 0:
        return out
    nb = u.numel() // (nx * ny)
    lib = _library(u.device.index if u.device.index is not None else torch.cuda.current_device())
    if max(len(offs_x), len(offs_y)) > lib.max_taps:
        raise ValueError(f'cross_stencil_2d kernel takes at most {lib.max_taps} taps per axis')
    rx = max((abs(int(s)) for s in offs_x), default=0)
    ry = max((abs(int(s)) for s in offs_y), default=0)
    smem = (lib.tile_rows + 2 * rx) * (lib.tile_cols + 2 * ry) * u.element_size()
    if smem > lib.max_smem:
        raise ValueError(f'stencil radius ({rx}, {ry}) needs a {smem}-byte tile; the block limit is {lib.max_smem}')
    if nb > 65535 or -(-nx // lib.tile_rows) > 65535 or nx * ny >= 2**31:
        raise ValueError(f'shape {tuple(u.shape)} exceeds the kernel grid limits')
    with torch.cuda.device(u.device):
        err = lib.launch(
            _DTYPE_CODES[u.dtype], u.data_ptr(), out.data_ptr(), nb, nx, ny,
            *_tap_arrays(terms), torch.cuda.current_stream(u.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f'cross_stencil_2d kernel launch failed with CUDA error {err}')
    cross_stencil_2d.launches += 1
    return out


def cross_stencil_2d(u: torch.Tensor, terms) -> torch.Tensor:
    """Periodic cross stencil on the trailing two axes; leading axes batch.

    ``terms = ((coeff_x, offs_x), (coeff_y, offs_y))``, tuples of Python
    floats and ints.  Equal to ``sum_d sum_s c_{d,s} * roll(u, -s, axis=d)``.
    On a CUDA tensor one launch of the K1 kernel computes all taps in one
    pass over device memory; on a CPU tensor the plain version runs."""
    if u.device.type == 'cpu':
        return _roll_cross_2d(u, terms)
    if u.device.type != 'cuda':
        raise ValueError(f'cross_stencil_2d runs on cuda or cpu tensors, got {u.device}')
    return _launch(u, terms)


cross_stencil_2d.launches = 0


def stencil2d_periodic(u: torch.Tensor, c0: float, cx: float, cy: float) -> torch.Tensor:
    """Periodic 5-point stencil
    ``c0*u + cx*(roll(u,1,0)+roll(u,-1,0)) + cy*(roll(u,1,1)+roll(u,-1,1))``,
    a thin wrapper over :func:`cross_stencil_2d`."""
    terms = ((float(cx), float(c0), float(cx)), (-1, 0, 1)), ((float(cy), float(cy)), (-1, 1))
    return cross_stencil_2d(u, terms)
