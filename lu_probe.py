"""Probes of the dense LU routes on one CUDA card, for ``pysdc_tpu_torch/ops/linalg.py``.

    python3 lu_probe.py faults [--root DIR]
    python3 lu_probe.py routes
    python3 lu_probe.py split [--root DIR]
    python3 lu_probe.py order
    python3 lu_probe.py timing [--root DIR]
    python3 lu_probe.py swap [--root DIR]

``faults`` imports ``pysdc_tpu_torch`` from DIR (default: this checkout; another commit unpacked with ``git
archive``) and runs, float64: ``Piline``, ``BuckConverter`` (fsw 10 and 7) and ``BatteryNCapacitors`` through
``ShardedController(4).run`` on the stage lane, on the CPU and on the card under ``lane='auto'``; the shifted
operators of ``RayleighBenard(nx=8)`` at nz 128 and 256 (512 and 1024 rows a mode) solved by ``ops/linalg.solve``
on the card against LAPACK on the CPU; and one ``RayleighBenard(8, 128)`` block on the stage lane, card against CPU.
Each part prints one line starting with ``###``; ``FAULTS=rbc`` skips the circuits, ``FAULTS=piline`` runs
``Piline`` alone of them.

``routes`` holds two library routes for an LU of 512 rows and more inside the body of a device ``while``
(``ops/graph_loop.py``), each captured and replayed against the eager call, and against LAPACK:

- (a) ``torch.linalg.lu_factor_ex`` of a tall panel (``n x nb``, a batch of two or more) with torch asked for
  cuSOLVER, which factors it with cuSOLVER's ``getrf``, one matrix at a time;
- (b) cuBLAS's ``getrfBatched`` / ``getrsBatched`` on whole matrices, from a small C entry point compiled here by
  ``nvcc`` into ``pysdc_tpu_torch/_build`` and loaded with ``ctypes``; its pointer arrays are made on the device.

``split`` times the pivoted route of DIR's ``ops/linalg.py`` eager at RayleighBenard 256x128's batch (256 matrices
of 512^2 complex128, 4 right-hand sides each) and splits it by the calls the route makes: each call of the panel
kernel, of ``lu_swap_trsm`` where DIR has it, of ``gather`` / ``copy_`` / ``__setitem__``, ``solve_triangular`` and
``baddbmm_`` runs inside a ``torch.profiler`` range named for its part (the level of ``_getrf``'s recursion by the
width of the side or the triangle, the GEMM by its rank, everything of ``_substitute`` as the substitution) and
between two CUDA events.  It prints the device time of each part by the profiler and by the events, the calls, and
what neither part names ("other": the route's time less the parts').

``order`` runs ``chip_smoke.py``'s phases 1, 72, 73 and 4 in that order (phase 4's parity once missed its gate
right after phases 72-73; ROADMAP queue 3) and prints phase 4's outcome on a line starting with ``###``.

``timing`` builds DIR's ``csrc/dense_lu.cu`` with its timing marks (``-DDENSE_LU_TIMING``) into a library of its own
and runs both kernels once at RayleighBenard 256x128's first block through it: the first CTA's time between marks,
its SM clock, and each CTA's start and end.

``swap`` times DIR's ``lu_swap_trsm`` at each of the route's 8 blocks at RayleighBenard 256x128's batch, each beside
its bound (``chip_smoke.py``'s ``swap_block_times``): run it on two commits in one call to compare their kernels.

The CPU legs run on one thread (the CPU torch's LAPACK has hung multithreaded on a card's host).  Every line ends
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

CUBLAS_SOURCE = r'''
#include <cublas_v2.h>
#include <cuda_runtime.h>
static cublasHandle_t handle = nullptr;
__global__ void fill_ptrs(void** out, char* base, long long stride, int batch) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < batch) out[i] = base + stride * i;
}
extern "C" {
int probe_init(void* workspace, long long bytes) {
  if (!handle && cublasCreate(&handle) != CUBLAS_STATUS_SUCCESS) return 1;
  if (workspace && cublasSetWorkspace(handle, workspace, bytes) != CUBLAS_STATUS_SUCCESS) return 2;
  return 0;
}
// dtype 1 = float64, 3 = complex128; a: column-major (batch, n, n); ptrs: device scratch of batch pointers
int probe_getrf(int dtype, int n, void* a, int batch, void* ptrs, void* piv, void* info, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cublasSetStream(handle, s) != CUBLAS_STATUS_SUCCESS) return 3;
  long long es = dtype == 3 ? 16 : 8;
  fill_ptrs<<<(batch + 255) / 256, 256, 0, s>>>((void**)ptrs, (char*)a, es * n * n, batch);
  if (cudaGetLastError() != cudaSuccess) return 4;
  cublasStatus_t st;
  if (dtype == 3) st = cublasZgetrfBatched(handle, n, (cuDoubleComplex**)ptrs, n, (int*)piv, (int*)info, batch);
  else st = cublasDgetrfBatched(handle, n, (double**)ptrs, n, (int*)piv, (int*)info, batch);
  return st == CUBLAS_STATUS_SUCCESS ? 0 : 100 + (int)st;
}
int probe_getrs(int dtype, int n, int nrhs, void* a, void* b, int batch, void* pa, void* pb, void* piv, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cublasSetStream(handle, s) != CUBLAS_STATUS_SUCCESS) return 3;
  long long es = dtype == 3 ? 16 : 8;
  fill_ptrs<<<(batch + 255) / 256, 256, 0, s>>>((void**)pa, (char*)a, es * n * n, batch);
  fill_ptrs<<<(batch + 255) / 256, 256, 0, s>>>((void**)pb, (char*)b, es * n * nrhs, batch);
  int info = 0;
  cublasStatus_t st;
  if (dtype == 3)
    st = cublasZgetrsBatched(handle, CUBLAS_OP_N, n, nrhs, (const cuDoubleComplex* const*)pa, n, (const int*)piv,
                             (cuDoubleComplex**)pb, n, &info, batch);
  else
    st = cublasDgetrsBatched(handle, CUBLAS_OP_N, n, nrhs, (const double* const*)pa, n, (const int*)piv,
                             (double**)pb, n, &info, batch);
  return st == CUBLAS_STATUS_SUCCESS ? (info ? 200 - info : 0) : 100 + (int)st;
}
}
'''


def _card():
    out = subprocess.run(['nvidia-smi', '-i', '0', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _rel(got, want):
    return float((got.cpu() - want.cpu()).abs().max() / want.abs().max())


def _rbc_operator(nz, factor):
    import torch

    from pysdc_tpu_torch.models.rayleigh_benard import RayleighBenard

    spec = RayleighBenard(nx=8, nz=nz, device='cpu').spec
    like = torch.zeros((1,), dtype=torch.complex128)
    keep = torch.as_tensor(spec.keep_mask)
    return (spec._dev('M_all', like) + factor * spec._dev('L_all', like)) * keep[:, :, None] + spec._dev('bc_rows', like)


def faults(card):
    import numpy as np
    import torch

    import pysdc_tpu_torch as P
    from pysdc_tpu_torch.models.power_electronics import BatteryNCapacitors, BuckConverter, Piline
    from pysdc_tpu_torch.models.rayleigh_benard import RayleighBenard
    from pysdc_tpu_torch.ops import linalg

    torch.set_num_threads(1)
    print(f'### package {P.__file__} [{card}]', flush=True)

    def run(cls, params, lane, device):
        desc = dict(problem_class=cls, problem_params=dict(params, dtype=torch.float64, device=device),
                    sweeper_class=P.IMEXSweeper,
                    sweeper_params=dict(num_nodes=3, QI='LU', QE='EE', quad_type='RADAU-RIGHT'),
                    level_params=dict(dt=0.05, restol=1e-10), step_params=dict(maxiter=20))
        ctrl = P.ShardedController(4, {'logger_level': 40}, desc)
        u, st = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, 0.4, lane=lane)
        return (u.cpu(), [v for k, v in st.items() if k.type == 'lane'],
                [v for _, v in P.get_sorted(st, type='niter', sortby='time')])

    circuits = ((Piline, {}), (BuckConverter, dict(fsw=10.0)), (BuckConverter, dict(fsw=7.0)),
                (BatteryNCapacitors, dict(ncapacitors=2)))
    circuits = {'rbc': (), 'piline': circuits[:1]}.get(os.environ.get('FAULTS'), circuits)
    for cls, params in circuits:
        name = f'{cls.__name__} {params}'
        print(f'### {name}: starting [{card}]', flush=True)
        try:
            us, ls, ns = run(cls, params, 'stage', 'cuda')
            uc, lc, nc = run(cls, params, 'auto', 'cpu')
            print(f'### {name}: stage lane on the card {ls} niter {ns}; CPU \'auto\' {lc} niter {nc}, |CPU - stage| '
                  f'{float((uc - us).abs().max()):.3e} [{card}]', flush=True)
            uf, lf, nf = run(cls, params, 'auto', 'cuda')
            print(f'### {name}: the card under \'auto\' {lf} niter {nf}, |auto - stage| '
                  f'{float((uf - us).abs().max()):.3e} [{card}]', flush=True)
        except Exception as err:
            print(f'### {name} FAILED {type(err).__name__}: {str(err)[:400]} [{card}]', flush=True)
            traceback.print_exc(limit=3)

    rng = np.random.default_rng(4)
    for nz, factor in ((128, 1e-3), (128, 1e-2), (128, 0.25), (256, 1e-3)):
        A = _rbc_operator(nz, factor)
        shape = tuple(A.shape[:-1]) + (1,)
        B = torch.as_tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
        want = torch.linalg.solve(A, B)
        got = linalg.solve(A.cuda(), B.cuda()).cpu()
        print(f'### RayleighBenard(8, {nz}) modes {tuple(A.shape)}, factor {factor}: cond {float(torch.linalg.cond(A).max()):.2e}, '
              f'ops/linalg.solve on the card against LAPACK: rel {_rel(got, want):.3e} [{card}]', flush=True)

    def rbc_block(device):
        desc = dict(problem_class=RayleighBenard, problem_params=dict(nx=8, nz=128, Rayleigh=2e6, Prandtl=1,
                                                                      dtype=torch.float64, device=device),
                    sweeper_class=P.IMEXSweeper, sweeper_params=dict(num_nodes=3, QI='LU', QE='PIC'),
                    level_params=dict(dt=0.01, restol=-1.0), step_params=dict(maxiter=4))
        ctrl = P.ShardedController(4, {'logger_level': 40}, desc)
        u, st = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, 0.04, lane='stage')
        return u.cpu(), [v for _, v in P.get_sorted(st, type='niter', sortby='time')]

    ug, ng = rbc_block('cuda')
    uc, nc = rbc_block('cpu')
    print(f'### RayleighBenard(8, 128) one block on the stage lane: niter card {ng}, CPU {nc}; uend rel '
          f'{_rel(ug, uc):.3e}, finite on the card {bool(ug.isfinite().all())} [{card}]', flush=True)


def _in_body(op, label, card):
    """``op()`` inside a device ``while`` of 2 trips, captured and replayed, against the eager call."""
    import torch

    from pysdc_tpu_torch.ops import graph_loop

    dev = torch.device('cuda')
    try:
        want = op()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            op()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph_loop.prepare(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            (trips, got), _ = graph_loop.device_while(
                lambda c: c[0] < 2, lambda c: (c[0] + 1, op()),
                (torch.zeros((), dtype=torch.int64, device=dev), torch.zeros_like(want)))
        graph.replay()
        torch.cuda.synchronize()
        print(f'BODY {label}: captured, {int(trips)} trips, equal to the eager call {torch.equal(got, want)} [{card}]',
              flush=True)
    except Exception as err:
        print(f'BODY {label}: FAILED {type(err).__name__}: {str(err).splitlines()[0][:200]} [{card}]', flush=True)
        torch.cuda.synchronize()


def routes(card):
    import torch

    from pysdc_tpu_torch.ops import linalg
    from pysdc_tpu_torch.ops.kernels import build

    torch.set_num_threads(1)
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(3)
    for dtype, b, m, w in ((torch.complex128, 4, 512, 32), (torch.float64, 2, 1024, 64),
                           (torch.complex128, 2, 512, 128)):
        panel = torch.randn((b, m, w), dtype=dtype, device=dev, generator=gen)

        def op():
            with linalg._cusolver(panel):
                return torch.linalg.lu_factor_ex(panel)[0]

        _in_body(op, f'(a) lu_factor_ex of a tall panel, torch asked for cuSOLVER, {dtype} {(b, m, w)}', card)
        print(f'(a) {dtype} {(b, m, w)} against LAPACK: LU rel {_rel(op(), torch.linalg.lu_factor_ex(panel.cpu())[0]):.3e} '
              f'[{card}]', flush=True)

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source = build.BUILD_DIR / 'lu_probe_cublas.cu'
    source.write_text(CUBLAS_SOURCE)
    library = build.BUILD_DIR / 'liblu_probe_cublas.so'
    out = subprocess.run([build._nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a', '-O3', '-shared', '-Xcompiler',
                          '-fPIC', '-o', str(library), str(source), '-lcublas'], capture_output=True, text=True)
    if out.returncode != 0:
        print(f'(b) nvcc failed: {out.stderr[-1500:]}', flush=True)
        return
    lib = ctypes.CDLL(str(library))
    for fn in (lib.probe_init, lib.probe_getrf, lib.probe_getrs):
        fn.restype = ctypes.c_int
    lib.probe_init.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.probe_getrf.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
    lib.probe_getrs.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 4
    workspace = torch.empty(32 << 20, dtype=torch.uint8, device=dev)
    if lib.probe_init(workspace.data_ptr(), workspace.numel()) != 0:
        print('(b) cuBLAS handle: failed', flush=True)
        return

    def route_b(A, B):
        b, n, _ = A.shape
        code = 3 if A.dtype == torch.complex128 else 1
        a, x = A.mT.contiguous(), B.mT.contiguous()  # column-major copies
        pa, pb = (torch.empty(b, dtype=torch.int64, device=dev) for _ in range(2))
        pivots = torch.empty((b, n), dtype=torch.int32, device=dev)
        info = torch.empty(b, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        err = (lib.probe_getrf(code, n, a.data_ptr(), b, pa.data_ptr(), pivots.data_ptr(), info.data_ptr(), stream),
               lib.probe_getrs(code, n, B.shape[-1], a.data_ptr(), x.data_ptr(), b, pa.data_ptr(), pb.data_ptr(),
                               pivots.data_ptr(), stream))
        if any(err):
            raise RuntimeError(f'route (b): errors {err}')
        return x.mT

    for nz, factor in ((128, 1e-2), (256, 1e-3)):
        A = _rbc_operator(nz, factor).to(dev)
        B = torch.randn(tuple(A.shape[:-1]) + (1,), dtype=A.dtype, device=dev, generator=gen)
        want = torch.linalg.solve(A.cpu(), B.cpu())
        try:
            print(f'(b) RayleighBenard(8, {nz}) modes {tuple(A.shape)}: against LAPACK {_rel(route_b(A, B), want):.3e} '
                  f'[{card}]', flush=True)
        except Exception as err:
            print(f'(b) FAILED {type(err).__name__}: {str(err)[:200]}', flush=True)
        _in_body(lambda: route_b(A, B), f'(b) getrfBatched / getrsBatched RayleighBenard(8, {nz}) modes', card)


def _split_parts(linalg, torch):
    """Wrap the calls ``linalg``'s route makes so that each runs inside a profiler range and between two CUDA events
    named for its part.  Returns (parts, undo): parts maps a name to its (start, end) event pairs."""
    parts, stage = {}, ['factor']

    def side_level(width):
        return 'outer' if width >= 64 else 'inner'

    def name_of(kind, args):
        if stage[0] == 'substitute':
            return 'substitution'
        if kind in ('gather', 'copy_'):
            t = args[0]
            return 'perm' if t.dim() == 2 else f'side {kind}, {side_level(t.shape[-1])}'
        if kind == 'setitem':
            return 'setitem (perm, U12)'
        if kind == 'trsm':
            return f'solve_triangular, {"outer" if args[0].shape[-1] >= 64 else "inner"}'
        if kind == 'baddbmm_':
            return f'baddbmm rank {args[1].shape[-1]}'
        return kind

    def timed(kind, fn):
        def call(*args, **kwargs):
            if stage[0] is None:  # inside another part (a plain version's own calls): that part's time
                return fn(*args, **kwargs)
            name = name_of(kind, args)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            before, stage[0] = stage[0], None
            try:
                with torch.profiler.record_function(f'part: {name}'):
                    start.record()
                    out = fn(*args, **kwargs)
                    end.record()
            finally:
                stage[0] = before
            parts.setdefault(name, []).append((start, end))
            return out
        return call

    def staged(name, fn):
        def call(*args, **kwargs):
            before, stage[0] = stage[0], name
            try:
                return fn(*args, **kwargs)
            finally:
                stage[0] = before
        return call

    saved = [(linalg, '_getrf', linalg._getrf), (linalg, '_substitute', linalg._substitute),
             (linalg, 'lu_panel', linalg.lu_panel), (torch.linalg, 'solve_triangular', torch.linalg.solve_triangular),
             (torch.Tensor, 'gather', torch.Tensor.gather), (torch.Tensor, 'copy_', torch.Tensor.copy_),
             (torch.Tensor, '__setitem__', torch.Tensor.__setitem__), (torch.Tensor, 'baddbmm_', torch.Tensor.baddbmm_)]
    if hasattr(linalg, 'lu_swap_trsm'):
        saved.append((linalg, 'lu_swap_trsm', linalg.lu_swap_trsm))
    kinds = {'_getrf': None, '_substitute': None, 'lu_panel': 'panel kernel', 'lu_swap_trsm': 'lu_swap_trsm kernel',
             'solve_triangular': 'trsm', 'gather': 'gather', 'copy_': 'copy_', '__setitem__': 'setitem',
             'baddbmm_': 'baddbmm_'}
    for owner, attr, fn in saved:
        if attr == '_getrf':
            setattr(owner, attr, staged('factor', fn))
        elif attr == '_substitute':
            setattr(owner, attr, staged('substitute', fn))
        else:
            setattr(owner, attr, timed(kinds[attr], fn))

    def undo():
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)

    return parts, undo


def split(card):
    import torch

    from pysdc_tpu_torch.ops import linalg

    A = _rbc128_modes()
    gen = torch.Generator(device='cuda').manual_seed(13)
    B = torch.randn((4,) + tuple(A.shape[:-1]) + (1,), dtype=torch.complex128, device='cuda', generator=gen)
    label = f'A {tuple(A.shape)} complex128, B {tuple(B.shape)}'
    for _ in range(2):
        linalg.solve(A, B)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        linalg.solve(A, B)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    print(f'### split: the route eager, {label}: {", ".join(f"{t:.3f}" for t in times)} ms (CUDA events, 3 runs) '
          f'[{card}]', flush=True)

    parts, undo = _split_parts(linalg, torch)
    try:
        linalg.solve(A, B)  # once with the wrappers before the profiled call
        torch.cuda.synchronize()
        parts.clear()
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.profiler.profile(activities=activities) as prof:
            start.record()
            linalg.solve(A, B)
            end.record()
            torch.cuda.synchronize()
    finally:
        undo()
    total = start.elapsed_time(end)
    device = {}
    for evt in prof.key_averages():
        ms = getattr(evt, 'device_time_total', None)
        ms = (ms if ms is not None else getattr(evt, 'cuda_time_total', 0.0)) / 1e3
        if evt.key.startswith('part: '):
            device[evt.key[6:]] = ms
    by_events = {name: sum(s.elapsed_time(e) for s, e in pairs) for name, pairs in parts.items()}
    for name in sorted(by_events, key=lambda k: -by_events[k]):
        print(f'### split part {name}: {len(parts[name])} calls, {device.get(name, 0.0):.3f} ms on the card '
              f'(profiler), {by_events[name]:.3f} ms between CUDA events [{card}]', flush=True)
    named = sum(by_events.values())
    print(f'### split total: {total:.3f} ms between CUDA events with the wrappers and the profiler on; parts '
          f'{named:.3f} ms (events), {sum(device.values()):.3f} ms on the card (profiler) [{card}]', flush=True)


def order(card):
    import importlib.util

    spec = importlib.util.spec_from_file_location('chip_smoke', ROOT / 'chip_smoke.py')
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.phase_build(card)
    smoke.phase_dense_lu(card)
    smoke.phase_dense_lu_times(card)
    try:
        smoke.phase_parity()
        print(f'### order: phase 4 right after phases 72-73 passed its gate [{card}]', flush=True)
    except AssertionError as err:
        print(f'### order: phase 4 right after phases 72-73 FAILED: {err} [{card}]', flush=True)


def kernel_timing(card):
    """Both kernels once at RayleighBenard 256x128's first block, built from csrc/dense_lu.cu with its timing marks
    (``-DDENSE_LU_TIMING``, the card's global timer): the first CTA's time at each mark, its SM clock (cycles over the
    timer's time), and each CTA's start and end (its waves)."""
    import types

    import numpy as np
    import torch

    from pysdc_tpu_torch.ops.kernels import build, dense_lu

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = build.BUILD_DIR / 'libdense_lu_timing.so'
    out = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, '-DDENSE_LU_TIMING', '-o', str(so),
                          str(build.CSRC_DIR / 'dense_lu.cu')], check=True, capture_output=True, text=True)
    entry = ''
    for line in (out.stdout + out.stderr).splitlines():
        if 'Compiling entry function' in line:
            entry = line.split("'")[1]
        elif ('Used' in line or 'spill' in line) and 'CxIdE' in entry:
            print(f'### kernel timing ptxas {entry[-60:]}: {line.split(":", 1)[-1].strip()}', flush=True)
    lib = ctypes.CDLL(str(so))
    real = dense_lu._library()
    lib.dense_lu_panel.argtypes = real.panel.argtypes
    lib.dense_lu_swap_trsm.argtypes = real.swap_trsm.argtypes
    lib.dense_lu_panel.restype = lib.dense_lu_swap_trsm.restype = ctypes.c_int
    dense_lu._library = lambda: types.SimpleNamespace(panel=lib.dense_lu_panel, swap_trsm=lib.dense_lu_swap_trsm)

    A = _rbc128_modes()
    marks, ctas = np.zeros(128, dtype=np.uint64), np.zeros(2 * 8192, dtype=np.uint64)
    clocks = np.zeros(2, dtype=np.int64)

    def run(label, fn):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        lib.dl_clear()
        fn()
        torch.cuda.synchronize()
        if lib.dl_read(marks.ctypes.data, ctas.ctypes.data, clocks.ctypes.data) != 0:
            raise RuntimeError('kernel timing: reading the marks failed')
        got = marks[marks > 0].astype(np.int64)
        steps = np.diff(got) / 1e3
        pairs = ctas.reshape(-1, 2).astype(np.int64)
        pairs = pairs[pairs[:, 0] > 0]
        t0 = pairs[:, 0].min()
        start, length = (pairs[:, 0] - t0) / 1e3, (pairs[:, 1] - pairs[:, 0]) / 1e3
        mhz = (clocks[1] - clocks[0]) / max(float(got[-1] - got[0]) / 1e3, 1e-9)
        print(f'### kernel timing {label}: SM clock {mhz:.0f} MHz; the first CTA\'s steps between marks (us): '
              f'{", ".join(f"{x:.1f}" for x in steps)}; {len(pairs)} CTAs, each {np.median(length):.1f} us median '
              f'({length.min():.1f}-{length.max():.1f}), starts from 0 to {start.max():.1f} us, the last ends at '
              f'{(pairs[:, 1].max() - t0) / 1e3:.1f} us [{card}]', flush=True)

    work = A.clone()
    run('lu_panel (256, 512, 64)', lambda: dense_lu.lu_panel(work[:, :, :64].copy_(A[:, :, :64])))
    factored = A.clone()
    rows = dense_lu.lu_panel(factored[:, :, :64])
    run('lu_swap_trsm block 0', lambda: dense_lu.lu_swap_trsm(work.copy_(factored), 0, 64, rows))


def _rbc128_modes():
    """RayleighBenard 256x128's shifted operators on the card: 256 matrices of 512^2 complex128."""
    import torch

    from pysdc_tpu_torch.models.rayleigh_benard import RayleighBenard

    spec = RayleighBenard(nx=256, nz=128, Rayleigh=2e6, Prandtl=1, dtype=torch.float64, device='cuda').spec
    like = torch.zeros((1,), dtype=torch.complex128, device='cuda')
    keep = torch.as_tensor(spec.keep_mask, device='cuda')
    return (spec._dev('M_all', like) + 0.3 * 0.01 * spec._dev('L_all', like)) * keep[:, :, None] \
        + spec._dev('bc_rows', like)


def swap(card):
    import importlib.util

    import pysdc_tpu_torch as P

    spec = importlib.util.spec_from_file_location('chip_smoke', ROOT / 'chip_smoke.py')
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    print(f'### swap: the package {P.__file__} [{card}]', flush=True)
    smoke.swap_block_times(_rbc128_modes(), card)


def main():
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('what', choices=('faults', 'routes', 'split', 'order', 'timing', 'swap'))
    parser.add_argument('--root', default=None, help='import pysdc_tpu_torch from this directory')
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve() if args.root else ROOT))
    import torch

    if not torch.cuda.is_available():
        print('lu_probe: no CUDA card', file=sys.stderr)
        return 1
    card = _card()
    start = time.perf_counter()
    {'faults': faults, 'routes': routes, 'split': split, 'order': order, 'timing': kernel_timing,
     'swap': swap}[args.what](card)
    print(f'lu_probe {args.what}: {time.perf_counter() - start:.1f} s [{card}]')
    return 0


if __name__ == '__main__':
    sys.exit(main())
