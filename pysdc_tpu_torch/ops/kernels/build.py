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

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_DIR = PACKAGE_DIR / '_build'

#: every kernel library of the port: name -> source file under csrc/
SOURCES = {'cross_stencil': 'cross_stencil.cu', 'dia_spmv': 'dia_spmv.cu', 'bsr_spmm': 'bsr_spmm.cu'}

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


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
