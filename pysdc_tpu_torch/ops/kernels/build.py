"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, loaded with :mod:`ctypes`.  The
library lands in ``pysdc_tpu_torch/_build/`` under a name that carries a hash
of its source, so an edited source is rebuilt and a stale library is never
loaded.  Builds happen at first use, never at import.  :func:`build` starts
one ``nvcc`` per missing library, all at once, and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch
import torch.autograd.forward_ad as forward_ad

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_DIR = PACKAGE_DIR / '_build'

#: every kernel library of the port: name -> source file under csrc/
SOURCES = {'cross_stencil': 'cross_stencil.cu', 'dia_spmv': 'dia_spmv.cu', 'bsr_spmm': 'bsr_spmm.cu',
           'graph_loop': 'graph_loop.cu', 'dense_lu': 'dense_lu.cu',
           'sine_solve': 'sine_solve.cu'}

NVCC_FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
    '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, 'bin', 'nvcc')] if CUDA_HOME else []
    candidates.append(shutil.which('nvcc') or '')
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError('nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed')


def library_path(name: str) -> Path:
    source = CSRC_DIR / SOURCES[name]
    digest = hashlib.sha256(source.read_bytes() + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f'lib{name}-{digest}.so'


def build(names=None) -> dict[str, dict]:
    """Compile the named libraries (default: all) that are not built yet.

    Returns ``{name: {'seconds': wall time, 'log': compiler output}}`` for
    the libraries compiled by this call; raises if any compile fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f'.{os.getpid()}.tmp')
        cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC_DIR / SOURCES[name])]
        procs[name] = (tmp, time.perf_counter(),
                       subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out, failed = {}, []
    for name, (tmp, start, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'{name}: nvcc exited {proc.returncode}\n{log}')
            continue
        os.replace(tmp, library_path(name))  # atomic: a concurrent loader sees all or nothing
        out[name] = {'seconds': time.perf_counter() - start, 'log': log}
    if failed:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(failed))
    return out


def current_stream(index: int) -> int:
    """The raw handle of device ``index``'s current CUDA stream, for a launch
    (the direct binding where the CUDA build of torch has it: it skips
    making a ``torch.cuda.Stream`` object per launch)."""
    raw = getattr(torch._C, '_cuda_getCurrentRawStream', None)
    return raw(index) if raw is not None else torch.cuda.current_stream(index).cuda_stream


_FUNCTORCH = getattr(torch._C, '_functorch', None)  # torch.func's wrapper tests: no public API offers them


def functorch_wrapped(u: torch.Tensor) -> bool:
    """True when a ``torch.func`` transform (``grad``, ``vmap``, ``jvp``, ``jacfwd``) wraps ``u``."""
    check = getattr(_FUNCTORCH, 'is_functorch_wrapped_tensor', None)
    return bool(check is not None and check(u))


def mapped(u: torch.Tensor) -> bool:
    """True when a ``torch.func.vmap`` maps ``u`` at some level of its wrappers: its values cannot be read on
    the host.  Under ``grad`` or ``jvp`` alone they can."""
    batched, unwrap = getattr(_FUNCTORCH, 'is_batchedtensor', None), getattr(_FUNCTORCH, 'get_unwrapped', None)
    while functorch_wrapped(u):
        if batched is None or unwrap is None or batched(u):
            return True
        u = unwrap(u)
    return False


def differentiated(u: torch.Tensor) -> bool:
    """True when a gradient will be asked of ``u``: it requires grad with grad
    mode on, a ``torch.func`` transform wraps it (``grad``, ``vmap``,
    ``jacfwd``), or it is a forward-mode dual tensor.  A kernel launched
    through ``ctypes`` writes into a tensor that no autograd graph records, so
    a wrapper either routes such a tensor through an ``autograd.Function`` or
    refuses it."""
    if u.requires_grad and torch.is_grad_enabled():
        return True
    return functorch_wrapped(u) or forward_ad.unpack_dual(u).tangent is not None


def refuse_differentiated(name: str, u: torch.Tensor) -> None:
    """Raise for a tensor that :func:`differentiated` flags: the kernel ``name`` has no adjoint yet."""
    if differentiated(u):
        raise NotImplementedError(
            f'{name} has no adjoint, jvp or vmap rule on the card (ROADMAP queue 2, "adjoints of K2 and K3"): '
            f'a gradient through its launch would silently drop this term; detach the input or run on the CPU')


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
