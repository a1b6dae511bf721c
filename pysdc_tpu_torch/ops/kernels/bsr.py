"""Kernel K3: the BSR SpMM, by hand in CUDA for Hopper.

The counterpart of ``pysdc_tpu/ops/pallas/spmv.py:bsr_spmm``.  The kernels live
in ``pysdc_tpu_torch/csrc/bsr_spmm.cu`` and replace the Pallas kernel
``_bsr_kernel``: the block products run in the kernel's own float32 or
float64 FMAs (no library GEMM, no TF32).  Its plain version is
:meth:`pysdc_tpu_torch.ops.sparse.BSR.spmv`.

A tensor on the CPU takes the plain version; a CUDA tensor launches a kernel
or raises.  Two kernels share the work, chosen by :func:`choose_path` from
the shapes, the dtype and the alignment alone:

- ``'stream'``: block rows of a multiple of 16 bytes, 16-byte aligned, with
  room for two slabs in shared memory.  Persistent thread blocks walk over
  work items (block row, group of rows); the blocks arrive by bulk
  asynchronous copies into a ring of slabs (:func:`stream_geometry`,
  :func:`stream_items`);
- ``'general'``: everything else.

``bsr_spmm.launches`` counts the launches, ``bsr_spmm.paths`` counts them by
path.  ``path='general'`` (or ``'stream'``) forces a path, for checks and
timings; forcing ``'stream'`` where it does not apply raises.
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace

import torch

from pysdc_tpu_torch.ops.kernels.build import current_stream, load, refuse_differentiated

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}

# geometry of the stream path (checked against the library's own constants when it loads)
CHUNK = 8                #: batch columns one pass over the blocks serves, at most
STREAM_WARPS = 8         #: consumer warps of a thread block
STREAM_MAX_STAGES = 4    #: slabs in the ring, at most
STREAM_HEADER = 128      #: bytes of shared memory in front of the ring
STREAM_COPY_BYTES = 16   #: granule and alignment of a bulk copy
SMEM_OPT_IN = 232448     #: shared memory a block may opt into on an H100 (227 KB)
SM_COUNT = 132           #: streaming multiprocessors of an H100 SXM


def stream_rows(itemsize: int) -> int:
    """Rows of a slab: each consumer warp takes 4 float32 or 2 float64 rows,
    so a row of a slab is ``bc * itemsize`` bytes and a slab ``128 * bc`` bytes."""
    return STREAM_WARPS * (4 if itemsize == 4 else 2)


def batch_tile(B: int) -> int:
    """The batch-column template instantiation (1, 2, 4 or 8) a launch of
    ``B`` columns takes: the smallest that holds its widest chunk."""
    widest = min(B, CHUNK)
    return next(bt for bt in (1, 2, 4, 8) if bt >= widest)


def stream_geometry(dims, B: int, itemsize: int, max_smem: int = SMEM_OPT_IN, sm_count: int = SM_COUNT):
    """``(stages, grid_x, smem_bytes)`` of a stream launch, or None when fewer
    than two slabs fit ``max_smem``.

    Shared memory holds the header, ``stages`` slabs of ``stream_rows`` rows
    and the ``kb`` staged column segments of U (``batch_tile(B)`` rows of
    ``kb * bc`` values plus 16 bytes of padding).  ``grid_x`` persistent
    thread blocks share the ``nb * ceil(br / rows)`` work items."""
    nb, kb, br, bc = dims
    rows = stream_rows(itemsize)
    slab = rows * bc * itemsize
    useg = batch_tile(B) * (kb * bc * itemsize + STREAM_COPY_BYTES)
    stages = min(STREAM_MAX_STAGES, (max_smem - STREAM_HEADER - useg) // slab)
    if stages < 2:
        return None
    items = nb * -(-br // rows)
    return stages, max(1, min(items, sm_count)), STREAM_HEADER + stages * slab + useg


def stream_items(dims, itemsize: int, grid_x: int):
    """The work-item walk of the stream kernel: for each of the ``grid_x``
    thread blocks the list of ``(block row i, first row r0, rows)`` it takes,
    in order.  Block ``k`` takes items ``items*k//grid_x .. items*(k+1)//grid_x``
    of the row-major (block row, row group) list, so consecutive items share
    a block row and its staged segments."""
    nb, _, br, _ = dims
    rows = stream_rows(itemsize)
    groups = -(-br // rows)
    items = nb * groups
    walk = []
    for k in range(grid_x):
        mine = []
        for item in range(items * k // grid_x, items * (k + 1) // grid_x):
            i, r0 = item // groups, (item % groups) * rows
            mine.append((i, r0, min(rows, br - r0)))
        walk.append(mine)
    return walk


def choose_path(dims, B: int, itemsize: int, aligned: bool = True, max_smem: int = SMEM_OPT_IN) -> str:
    """``'stream'`` or ``'general'`` for blocks of shape ``dims = (nb, kb, br, bc)``.

    A pure function of the shapes, the element size, whether the blocks'
    data pointer is 16-byte aligned, and the shared memory a block may opt
    into; it needs no card."""
    bc = dims[3]
    if not aligned or (bc * itemsize) % STREAM_COPY_BYTES:
        return 'general'
    if stream_geometry(dims, B, itemsize, max_smem) is None:
        return 'general'
    return 'stream'


@functools.lru_cache(maxsize=None)
def _library(device_index: int) -> SimpleNamespace:
    """The K3 library with its argument types set, and the limits of device
    ``device_index`` (built at first use, never at import)."""
    lib = load('bsr_spmm')
    lib.bsr_spmm_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.bsr_spmm_launch.restype = ctypes.c_int
    lib.bsr_spmm_stream_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.bsr_spmm_stream_launch.restype = ctypes.c_int
    lib.bsr_spmm_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.bsr_spmm_smem_bytes.restype = ctypes.c_longlong
    consts = {}
    for name in ('max_smem', 'sm_count', 'stream_warps', 'stream_max_stages', 'stream_header', 'chunk'):
        fn = getattr(lib, f'bsr_spmm_{name}')
        fn.argtypes = []
        fn.restype = ctypes.c_int
        with torch.cuda.device(device_index):
            consts[name] = fn()
    ours = (STREAM_WARPS, STREAM_MAX_STAGES, STREAM_HEADER, CHUNK)
    theirs = tuple(consts[k] for k in ('stream_warps', 'stream_max_stages', 'stream_header', 'chunk'))
    if ours != theirs:
        raise RuntimeError(f'bsr_spmm: stream geometry {ours} of the wrapper differs from the library\'s {theirs}')
    return SimpleNamespace(launch=lib.bsr_spmm_launch, launch_stream=lib.bsr_spmm_stream_launch,
                           smem_bytes=lib.bsr_spmm_smem_bytes, max_smem=consts['max_smem'],
                           sm_count=consts['sm_count'])


def _plan(bsr, u: torch.Tensor) -> SimpleNamespace:
    """What one launch for ``u``'s dtype and device needs, checked once and
    kept on the matrix."""
    if u.dtype not in _DTYPE_CODES:
        raise TypeError(f'bsr_spmm kernel takes float32 or float64, got {u.dtype}')
    blocks = bsr.blocks_for(u)
    nb, kb, br, bc = blocks.shape
    seg = bsr.seg_starts_for(u)
    if (br, bc) != (bsr.br, bsr.bc) or nb * br != bsr.shape[0] or tuple(seg.shape) != (nb, kb):
        raise ValueError(f'bsr_spmm: blocks {tuple(blocks.shape)} and segments {tuple(seg.shape)} '
                         f'do not describe a {bsr.shape} matrix in {bsr.br}x{bsr.bc} blocks')
    index = u.device.index if u.device.index is not None else torch.cuda.current_device()
    lib = _library(index)
    plan = SimpleNamespace(lib=lib, code=_DTYPE_CODES[u.dtype], blocks=blocks, seg=seg, dims=(nb, kb, br, bc),
                           itemsize=blocks.element_size(), aligned=blocks.data_ptr() % STREAM_COPY_BYTES == 0,
                           index=index, by_batch={})
    bsr._kernel_plans[(u.dtype, u.device)] = plan
    return plan


def _batch_plan(plan, B: int) -> SimpleNamespace:
    """The path and launch geometry for ``B`` batch columns (kept on the plan)."""
    lib = plan.lib
    nb, kb, br, bc = plan.dims
    path = choose_path(plan.dims, B, plan.itemsize, plan.aligned, lib.max_smem)
    geometry = stream_geometry(plan.dims, B, plan.itemsize, lib.max_smem, lib.sm_count) if path == 'stream' else None
    general_smem = lib.smem_bytes(plan.code, kb, bc, B)
    batch = plan.by_batch[B] = SimpleNamespace(path=path, geometry=geometry, general_smem=general_smem)
    return batch


def _launch(bsr, u: torch.Tensor, path=None, stages=None) -> torch.Tensor:
    if u.dim() != 2 or u.shape[0] != bsr.shape[1]:
        raise ValueError(f'bsr_spmm: matrix {bsr.shape} needs u of shape ({bsr.shape[1]}, B), got {tuple(u.shape)}')
    if not u.is_contiguous():
        raise ValueError('bsr_spmm kernel needs a contiguous tensor')
    plan = bsr._kernel_plans.get((u.dtype, u.device)) or _plan(bsr, u)
    nb, kb, br, bc = plan.dims
    B = u.shape[1]
    out = torch.empty((bsr.shape[0], B), dtype=u.dtype, device=u.device)
    if B == 0 or nb == 0:
        return out
    batch = plan.by_batch.get(B) or _batch_plan(plan, B)
    chosen = batch.path
    if path is not None and path != chosen:
        if path != 'general':
            raise ValueError(f'bsr_spmm: path {path!r} does not take blocks {plan.dims} of {u.dtype} with B = {B} '
                             f'(16-byte aligned: {plan.aligned})')
        chosen = path
    if B > CHUNK * 65535:
        raise ValueError(f'bsr_spmm: B = {B} exceeds the kernel grid limits')
    head = (plan.code, plan.blocks.data_ptr(), plan.seg.data_ptr(), u.data_ptr(), out.data_ptr(), nb, kb, br, bc, B)
    if chosen == 'stream':
        most, grid_x, _ = batch.geometry
        if stages is not None and not 2 <= stages <= most:
            raise ValueError(f'bsr_spmm: {stages} slabs asked for, 2 to {most} fit')
        args = head + (most if stages is None else stages, grid_x, current_stream(plan.index))
        launch = plan.lib.launch_stream
    else:
        if batch.general_smem > plan.lib.max_smem:
            raise ValueError(f'bsr_spmm: kb*bc = {kb * bc} segment rows of B = {B} columns need '
                             f'{batch.general_smem} bytes of shared memory; the block limit is {plan.lib.max_smem}')
        args = head + (current_stream(plan.index),)
        launch = plan.lib.launch
    if torch.cuda.current_device() == plan.index:
        err = launch(*args)
    else:
        with torch.cuda.device(plan.index):
            err = launch(*args)
    if err != 0:
        raise RuntimeError(f'bsr_spmm kernel ({chosen} path) launch failed with CUDA error {err}')
    bsr_spmm.launches += 1
    bsr_spmm.paths[chosen] += 1
    return out


def bsr_spmm(bsr, u: torch.Tensor, path=None) -> torch.Tensor:
    """``Y = A @ U`` for a :class:`~pysdc_tpu_torch.ops.sparse.BSR` matrix;
    ``u`` is (N, B), operator axis first, batch columns last (B=1 for a
    plain SpMV).  Returns (N_rows, B).

    On a CUDA tensor one launch of a K3 kernel (``path`` forces ``'stream'``
    or ``'general'``); on a CPU tensor the plain ``BSR.spmv``.  A CUDA tensor
    that a gradient is asked of raises (the kernel has no adjoint yet)."""
    if u.device.type == 'cpu':
        return bsr.spmv(u)
    if u.device.type != 'cuda':
        raise ValueError(f'bsr_spmm runs on cuda or cpu tensors, got {u.device}')
    refuse_differentiated('bsr_spmm', u)
    return _launch(bsr, u, path)


bsr_spmm.launches = 0
bsr_spmm.paths = {'stream': 0, 'general': 0}
