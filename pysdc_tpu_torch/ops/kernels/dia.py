"""Kernel K2: the DIA SpMV, by hand in CUDA for Hopper.

The counterpart of ``pysdc_tpu/ops/pallas/dia.py:dia_spmv``.  The kernel lives
in ``pysdc_tpu_torch/csrc/dia_spmv.cu``; one kernel replaces both Pallas
versions (``_dia_kernel_v2`` and ``_dia_kernel``) and needs no tiling or
padding of the vector.  Its plain version is
:meth:`pysdc_tpu_torch.ops.sparse.DIA.spmv` (flat or 2D-grid rolls).

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises.  ``dia_spmv.launches`` counts the launches on the host.
``dia_spmv.device_count``, where a caller sets it to a 0-d int64 tensor on the
card, gets one added at each launch, on the launch's stream: a CUDA graph that
captured the launch then counts it again at every replay (the host count
sees only the capture).
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace

import torch

from pysdc_tpu_torch.ops.kernels.build import current_stream, load, refuse_differentiated

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


@functools.lru_cache(maxsize=None)
def _library(device_index: int) -> SimpleNamespace:
    """The K2 library with its argument types set, and its limits
    (built at first use, never at import)."""
    lib = load('dia_spmv')
    lib.dia_spmv_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
    ]
    lib.dia_spmv_launch.restype = ctypes.c_int
    lib.dia_spmv_max_diags.argtypes = []
    lib.dia_spmv_max_diags.restype = ctypes.c_int
    return SimpleNamespace(launch=lib.dia_spmv_launch, max_diags=lib.dia_spmv_max_diags())


def _plan(dia, u: torch.Tensor) -> SimpleNamespace:
    """What one launch for ``u``'s dtype and device needs, checked once and
    kept on the matrix: the per-call work is then a few attribute reads."""
    if u.dtype not in _DTYPE_CODES:
        raise TypeError(f'dia_spmv kernel takes float32 or float64, got {u.dtype}')
    n = dia.shape[0]
    if dia.shape[1] != n:
        raise ValueError(f'dia_spmv needs a square matrix, got {dia.shape}')
    data = dia.data_for(u)
    k = len(dia.offsets)
    if tuple(data.shape) != (k, n) or not data.is_contiguous():
        raise ValueError(f'dia_spmv: diagonals of shape {tuple(data.shape)}, expected contiguous {(k, n)}')
    index = u.device.index if u.device.index is not None else torch.cuda.current_device()
    lib = _library(index)
    if k > lib.max_diags:
        raise ValueError(f'dia_spmv kernel takes at most {lib.max_diags} diagonals, got {k}')
    if n >= 2**31 - 256 or any(abs(o) >= n for o in dia.offsets):
        raise ValueError(f'dia_spmv kernel takes n < 2**31 - 256 and offsets inside (-n, n), got n={n}')
    plan = SimpleNamespace(
        launch=lib.launch, code=_DTYPE_CODES[u.dtype], data=data, n=n, k=k, index=index,
        offsets=(ctypes.c_int * max(k, 1))(*dia.offsets),
    )
    dia._kernel_plans[(u.dtype, u.device)] = plan
    return plan


def _launch(dia, u: torch.Tensor) -> torch.Tensor:
    plan = dia._kernel_plans.get((u.dtype, u.device)) or _plan(dia, u)
    n = plan.n
    if u.dim() < 1 or u.shape[-1] != n:
        raise ValueError(f'dia_spmv: matrix {dia.shape} does not apply to a tensor of shape {tuple(u.shape)}')
    if not u.is_contiguous():
        raise ValueError('dia_spmv kernel needs a contiguous tensor')
    out = torch.empty_like(u)
    nbatch = u.numel() // n
    if nbatch == 0:
        return out
    if plan.k == 0:
        return out.zero_()
    if nbatch >= 2**31:
        raise ValueError(f'shape {tuple(u.shape)} exceeds the kernel grid limits')
    args = (plan.code, plan.data.data_ptr(), u.data_ptr(), out.data_ptr(), n, nbatch, plan.k, plan.offsets,
            current_stream(plan.index))
    if torch.cuda.current_device() == plan.index:
        err = plan.launch(*args)
    else:
        with torch.cuda.device(plan.index):
            err = plan.launch(*args)
    if err != 0:
        raise RuntimeError(f'dia_spmv kernel launch failed with CUDA error {err}')
    dia_spmv.launches += 1
    if dia_spmv.device_count is not None:
        dia_spmv.device_count.add_(1)
    return out


def dia_spmv(dia, u: torch.Tensor) -> torch.Tensor:
    """``y = A @ u`` for a :class:`~pysdc_tpu_torch.ops.sparse.DIA` matrix
    over the trailing axis of ``u``; leading axes batch.

    On a CUDA tensor one launch of the K2 kernel applies every diagonal to
    every batch row; on a CPU tensor the plain ``DIA.spmv`` runs.  A CUDA
    tensor that a gradient is asked of raises (the kernel has no adjoint
    yet)."""
    if u.device.type == 'cpu':
        return dia.spmv(u)
    if u.device.type != 'cuda':
        raise ValueError(f'dia_spmv runs on cuda or cpu tensors, got {u.device}')
    refuse_differentiated('dia_spmv', u)
    return _launch(dia, u)


dia_spmv.launches = 0
dia_spmv.device_count = None
