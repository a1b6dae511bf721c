"""Kernel K3: the BSR SpMM, by hand in CUDA for Hopper.

The counterpart of ``pysdc_tpu/ops/pallas/spmv.py:bsr_spmm``.  The kernel lives
in ``pysdc_tpu_torch/csrc/bsr_spmm.cu`` and replaces the Pallas kernel
``_bsr_kernel``: the block products run in the kernel's own float32 or
float64 FMAs (no library GEMM, no TF32).  Its plain version is
:meth:`pysdc_tpu_torch.ops.sparse.BSR.spmv`.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises.  ``bsr_spmm.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace

import torch

from pysdc_tpu_torch.ops.kernels.build import current_stream, load

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


@functools.lru_cache(maxsize=None)
def _library(device_index: int) -> SimpleNamespace:
    """The K3 library with its argument types set, and the opt-in shared
    memory limit of device ``device_index`` (built at first use, never at import)."""
    lib = load('bsr_spmm')
    lib.bsr_spmm_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.bsr_spmm_launch.restype = ctypes.c_int
    lib.bsr_spmm_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.bsr_spmm_smem_bytes.restype = ctypes.c_longlong
    lib.bsr_spmm_max_smem.argtypes = []
    lib.bsr_spmm_max_smem.restype = ctypes.c_int
    with torch.cuda.device(device_index):
        max_smem = lib.bsr_spmm_max_smem()
    return SimpleNamespace(launch=lib.bsr_spmm_launch, smem_bytes=lib.bsr_spmm_smem_bytes, max_smem=max_smem)


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
    plan = SimpleNamespace(launch=lib.launch, smem_bytes=lib.smem_bytes, max_smem=lib.max_smem,
                           code=_DTYPE_CODES[u.dtype], blocks=blocks, seg=seg, dims=(nb, kb, br, bc), index=index)
    bsr._kernel_plans[(u.dtype, u.device)] = plan
    return plan


def _launch(bsr, u: torch.Tensor) -> torch.Tensor:
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
    smem = plan.smem_bytes(plan.code, kb, bc, B)
    if smem > plan.max_smem:
        raise ValueError(f'bsr_spmm: kb*bc = {kb * bc} segment rows of B = {B} columns need {smem} bytes of '
                         f'shared memory; the block limit is {plan.max_smem}')
    if B > 8 * 65535:
        raise ValueError(f'bsr_spmm: B = {B} exceeds the kernel grid limits')
    args = (plan.code, plan.blocks.data_ptr(), plan.seg.data_ptr(), u.data_ptr(), out.data_ptr(), nb, kb, br, bc, B,
            current_stream(plan.index))
    if torch.cuda.current_device() == plan.index:
        err = plan.launch(*args)
    else:
        with torch.cuda.device(plan.index):
            err = plan.launch(*args)
    if err != 0:
        raise RuntimeError(f'bsr_spmm kernel launch failed with CUDA error {err}')
    bsr_spmm.launches += 1
    return out


def bsr_spmm(bsr, u: torch.Tensor) -> torch.Tensor:
    """``Y = A @ U`` for a :class:`~pysdc_tpu_torch.ops.sparse.BSR` matrix;
    ``u`` is (N, B), operator axis first, batch columns last (B=1 for a
    plain SpMV).  Returns (N_rows, B).

    On a CUDA tensor one launch of the K3 kernel; on a CPU tensor the plain
    ``BSR.spmv``."""
    if u.device.type == 'cpu':
        return bsr.spmv(u)
    if u.device.type != 'cuda':
        raise ValueError(f'bsr_spmm runs on cuda or cpu tensors, got {u.device}')
    return _launch(bsr, u)


bsr_spmm.launches = 0
