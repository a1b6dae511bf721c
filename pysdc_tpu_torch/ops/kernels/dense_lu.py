"""The panel of the port's dense LU, by hand in CUDA for Hopper.

Replaces no TPU kernel: the JAX package's dense solves are ``jnp.linalg.solve``,
an LU with partial pivoting that XLA computes by itself.  The port's route for
512 rows and more (:mod:`pysdc_tpu_torch.ops.linalg`) is LAPACK's blocked
right-looking ``getrf`` written in torch, and this kernel
(``pysdc_tpu_torch/csrc/dense_lu.cu``) factors its panels: no library call
factors a tall panel, with its pivots searched down the whole height, inside
the body of a CUDA graph's conditional WHILE node.

:func:`lu_panel` factors a ``(batch, m, w)`` view in place and returns the row
permutation it applied.  A tensor on the CPU takes the plain version,
:func:`plain_panel` (LAPACK's ``getrf`` of the panel); a CUDA tensor launches
the kernel or raises.  ``lu_panel.launches`` counts the launches on the host;
``lu_panel.device_count``, where a caller sets it to a 0-d int64 tensor on the
card, gets one added at each launch, on the launch's stream, so a replayed
graph counts its own launches.
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace

import torch

from pysdc_tpu_torch.ops.kernels.build import current_stream, load, refuse_differentiated

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.complex64: 2, torch.complex128: 3}

#: the panel's shared memory: the reduction's scratch, the panel (column-major, m + 1 a column) and the permutation
SCRATCH_BYTES = 384
#: the most shared memory a panel may fill (one CTA an SM), and the widest panel
SMEM_BUDGET = 192 * 1024
MAX_WIDTH = 64


def smem_bytes(m: int, w: int, itemsize: int) -> int:
    """Shared memory of one CTA for an ``m x w`` panel (the library checks this formula when it loads)."""
    return SCRATCH_BYTES + w * (m + 1) * itemsize + 4 * m


def panel_width(m: int, itemsize: int) -> int:
    """The widest panel of ``m`` rows, a power of two up to :data:`MAX_WIDTH`, that fits :data:`SMEM_BUDGET`."""
    w = MAX_WIDTH
    while w >= 1 and smem_bytes(m, w, itemsize) > SMEM_BUDGET:
        w //= 2
    if w < 1:
        raise ValueError(f'dense LU: a panel of {m} rows of {itemsize} bytes does not fit shared memory')
    return w


@functools.lru_cache(maxsize=None)
def _library() -> SimpleNamespace:
    """The panel library with its argument types set (built at first use, never at import), its shared-memory
    formula checked against :func:`smem_bytes`."""
    lib = load('dense_lu')
    lib.dense_lu_panel.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.dense_lu_panel.restype = ctypes.c_int
    lib.dense_lu_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.dense_lu_smem_bytes.restype = ctypes.c_longlong
    lib.dense_lu_max_smem_bytes.restype = ctypes.c_int
    for m, w, itemsize in ((512, 16, 16), (1024, 8, 16), (600, 32, 8), (513, 64, 4)):
        if lib.dense_lu_smem_bytes(m, w, itemsize) != smem_bytes(m, w, itemsize):
            raise RuntimeError('dense LU: the library and ops/kernels/dense_lu.py disagree on the shared memory')
    if lib.dense_lu_max_smem_bytes() < SMEM_BUDGET:
        raise RuntimeError('dense LU: SMEM_BUDGET exceeds what the library lets a CTA use')
    return SimpleNamespace(launch=lib.dense_lu_panel)


def permutation(pivots: torch.Tensor, m: int) -> torch.Tensor:
    """LAPACK's pivots ``(batch, w)`` (1-based: row k was swapped with row ``pivots[k] - 1``, in order) as the
    permutation ``(batch, m)`` they make: row r of the result is row ``perm[r]`` of the input."""
    b, w = pivots.shape
    perm = torch.arange(m, device=pivots.device).expand(b, m).clone()
    rows = pivots.long() - 1
    for k in range(w):
        p = rows[:, k:k + 1]
        at_k = perm[:, k:k + 1].clone()
        perm[:, k:k + 1] = perm.gather(1, p)
        perm.scatter_(1, p, at_k)
    return perm


def plain_panel(panel: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`lu_panel`: LAPACK's ``getrf`` of the panel, written back in place."""
    LU, pivots, _ = torch.linalg.lu_factor_ex(panel)
    panel.copy_(LU)
    return permutation(pivots, panel.shape[-2])


def lu_panel(panel: torch.Tensor) -> torch.Tensor:
    """Factor ``panel`` (a ``(batch, m, w)`` view, ``m >= w``, rows of unit stride) in place with partial pivoting,
    as ``P panel = L U`` (L unit lower below the diagonal, U on and above it); returns the permutation ``(batch, m)``
    int64: row r of the factored panel is row ``perm[r]`` of the panel given.  One launch for the whole batch; a
    CUDA tensor that a gradient is asked of raises (the kernel writes in place, outside autograd)."""
    if panel.device.type == 'cpu':
        return plain_panel(panel)
    if panel.device.type != 'cuda':
        raise ValueError(f'lu_panel runs on cuda or cpu tensors, got {panel.device}')
    refuse_differentiated('lu_panel', panel)
    if panel.dtype not in _DTYPE_CODES:
        raise TypeError(f'lu_panel takes float32, float64, complex64 or complex128, got {panel.dtype}')
    b, m, w = panel.shape
    if not 1 <= w <= m or panel.stride(-1) != 1 or panel.stride(-2) < w or b < 1:
        raise ValueError(f'lu_panel: a ({b}, {m}, {w}) panel of strides {panel.stride()} is not one it takes')
    if smem_bytes(m, w, panel.element_size()) > SMEM_BUDGET or b >= 2**31:
        raise ValueError(f'lu_panel: a ({b}, {m}, {w}) {panel.dtype} panel exceeds the kernel limits')
    index = panel.device.index if panel.device.index is not None else torch.cuda.current_device()
    lib = _library()
    perm = torch.empty((b, m), dtype=torch.int64, device=panel.device)
    args = (_DTYPE_CODES[panel.dtype], panel.data_ptr(), panel.stride(0), panel.stride(1), m, w, b, perm.data_ptr(),
            current_stream(index))
    if torch.cuda.current_device() == index:
        err = lib.launch(*args)
    else:
        with torch.cuda.device(index):
            err = lib.launch(*args)
    if err != 0:
        raise RuntimeError(f'lu_panel kernel launch failed with error {err}')
    lu_panel.launches += 1
    if lu_panel.device_count is not None:
        lu_panel.device_count.add_(1)
    return perm


lu_panel.launches = 0
lu_panel.device_count = None
