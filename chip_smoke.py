"""Smoke run of the PyTorch/CUDA port (``pysdc_tpu_torch``) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit (``nvcc`` for ``sm_90a``)::

    python3 chip_smoke.py

It imports nothing of JAX or ``pysdc_tpu``.  Phases, in order; any failure
raises and the script exits nonzero without printing the final line:

1. build   — compile every kernel of the port from ``pysdc_tpu_torch/csrc``.
2. kernels — K1 (``cross_stencil_2d``) against its plain version on the card,
   float32 and float64, several tap tables and shapes.
3. main    — ``ControllerNonMPI`` on HeatND 2048^2 periodic, float32, M=4
   RADAU-RIGHT, QI='LU', dt=0.01, 4 steps of 8 sweeps; the K1 launch count
   must equal what the ``niter`` stats imply; ``uend`` against the exact
   solution and against the same run through the plain apply.
4. parity  — HeatND 256^2 float64, restol 1e-10: ``niter`` and ``uend`` on the
   card against the port's CPU run of the same description.
5. times   — K1, its plain version, a library yardstick and the main-path
   sweep, with CUDA events.

The last lines are the ``kernels`` JSON line, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

# the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
L2_BYTES = 50 * 2**20

N_MAIN, M_MAIN, DT, N_STEPS, SWEEPS = 2048, 4, 0.01, 4, 8
# fp32 roundoff bounds: this script measured 5.9e-5 and 6.0e-5 on an H100 80GB
# HBM3 at 700 W; each bound leaves about 8x room
UEND_EXACT_BOUND = 5e-4  # |uend - u_exact(0.04)|
UEND_PLAIN_BOUND = 5e-4  # |uend - uend through the plain apply|: the two round differently
PARITY_UEND_TOL = 1e-11  # fp64, card against CPU


def _card():
    out = subprocess.run(
        ['nvidia-smi', '-i', '0', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _heat_description(n, dtype, device, restol, maxiter):
    from pysdc_tpu_torch import GenericImplicit
    from pysdc_tpu_torch.models.heat import HeatND

    return dict(
        problem_class=HeatND,
        problem_params=dict(nvars=(n, n), nu=0.1, freq=2, bc='periodic', dtype=dtype, device=device),
        sweeper_class=GenericImplicit,
        sweeper_params=dict(num_nodes=M_MAIN, quad_type='RADAU-RIGHT', QI='LU'),
        level_params=dict(dt=DT, restol=restol),
        step_params=dict(maxiter=maxiter),
    )


def _run(description, plain=False):
    from pysdc_tpu_torch import ControllerNonMPI, get_sorted

    ctrl = ControllerNonMPI(1, {'logger_level': 30}, description)
    prob = ctrl.MS[0].levels[0].prob
    if plain:
        prob.A.disable_pallas()
    uend, stats = ctrl.run(prob.u_exact(0.0), 0.0, N_STEPS * DT)
    return ctrl, prob, uend, [v for _, v in get_sorted(stats, type='niter')]


def _stencil_tolerance(terms, dtype):
    """Worst-case rounding gap between two sums of the same n products taken
    in different orders, relative to sum|c| * max|u|: 2 n eps."""
    import torch

    n_terms = sum(len(offs) for _, offs in terms)
    return 2 * n_terms * torch.finfo(dtype).eps


def _event_ms(fn, reps, warmup=3, host=False):
    """Mean ms per call of ``fn(i)`` over ``reps`` back-to-back calls, timed
    with CUDA events; with ``host=True`` also the host's mean ms to enqueue
    one call (when the two are close, the host holds the card back)."""
    import torch

    for i in range(warmup):
        fn(i)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    host_ms = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / reps
    return (device_ms, host_ms) if host else device_ms


def phase_build(card):
    from pysdc_tpu_torch.ops.kernels.build import SOURCES, build

    start = time.perf_counter()
    built = build()
    for name, info in built.items():
        print(f'build {name}: {info["seconds"]:.2f} s')
        for line in info['log'].splitlines():
            if 'registers' in line or 'smem' in line or 'spill' in line:
                print(f'  ptxas: {line.strip()}')
    print(f'build: {len(built)} of {len(SOURCES)} libraries compiled in {time.perf_counter() - start:.2f} s [{card}]')


def phase_kernels():
    """K1 against its plain version on the card.  Returns the largest
    absolute error at the main path's shape and taps, float32."""
    import torch

    from pysdc_tpu_torch.ops.fd import get_finite_difference_stencil
    from pysdc_tpu_torch.ops.kernels.stencil import _roll_cross_2d, cross_stencil_2d
    from pysdc_tpu_torch.ops.linop import SeparableFDOperator

    tables = {}
    for order in (2, 4, 6):
        c, s = get_finite_difference_stencil(2, order, 'center')
        axis = (tuple(float(x) for x in c), tuple(int(x) for x in s))
        tables[f'order{order}'] = (axis, axis)
    tables['asymmetric'] = (((0.5, -2.0, 1.5), (-2, -1, 0)), ((1.0,), (1,)))
    dx = 1.0 / N_MAIN
    per_dim = [dict(size=N_MAIN, dx=dx, derivative=2, order=2, bc='periodic')] * 2
    tables['main'] = SeparableFDOperator(per_dim, scale=0.1)._cross_terms

    shapes = [(N_MAIN, N_MAIN), (M_MAIN, N_MAIN, N_MAIN), (17, 33), (16, 16), (1, 4096)]
    gen = torch.Generator(device='cuda').manual_seed(1234)
    main_err = None
    for dtype in (torch.float32, torch.float64):
        for name, terms in tables.items():
            tol = _stencil_tolerance(terms, dtype)
            scale_c = sum(abs(c) for coeff, _ in terms for c in coeff)
            worst = 0.0
            for shape in shapes:
                u = torch.randn(shape, generator=gen, device='cuda', dtype=dtype)
                got = cross_stencil_2d(u, terms)
                torch.cuda.synchronize()
                want = _roll_cross_2d(u, terms)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                rel = err / (scale_c * u.abs().max().item())
                if not (got.shape == u.shape and math.isfinite(err) and rel <= tol):
                    raise AssertionError(f'K1 {name} {dtype} {shape}: max abs err {err:.3e}, rel {rel:.3e} > {tol:.3e}')
                worst = max(worst, rel)
                if name == 'main' and dtype == torch.float32 and shape == (N_MAIN, N_MAIN):
                    main_err = err
            print(f'kernels: K1 {name:10s} {str(dtype):13s} max rel err {worst:.3e} <= tol {tol:.3e} '
                  f'over shapes {shapes}')
    return main_err


def phase_main(card):
    import torch

    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    desc = _heat_description(N_MAIN, torch.float32, 'cuda', restol=-1.0, maxiter=SWEEPS)
    cross_stencil_2d.launches = 0
    start = time.perf_counter()
    ctrl, prob, uend, niter = _run(desc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = cross_stencil_2d.launches
    # per step: f(u0) and one batched f over the M spread nodes, then M per sweep
    expected = sum(2 + M_MAIN * k for k in niter)
    if len(niter) != N_STEPS or launches != expected:
        raise AssertionError(f'main path: niter {niter}, K1 launches {launches}, expected {expected}')
    if uend.shape != (N_MAIN, N_MAIN) or uend.dtype != torch.float32 or not bool(torch.isfinite(uend).all()):
        raise AssertionError('main path: uend is not a finite float32 field of the grid shape')
    err_exact = (uend - prob.u_exact(N_STEPS * DT)).abs().max().item()
    if err_exact > UEND_EXACT_BOUND:
        raise AssertionError(f'main path: |uend - u_exact| = {err_exact:.3e} > {UEND_EXACT_BOUND}')

    cross_stencil_2d.launches = 0
    _, _, uend_plain, niter_plain = _run(desc, plain=True)
    diff = (uend - uend_plain).abs().max().item()
    if cross_stencil_2d.launches != 0 or niter_plain != niter or diff > UEND_PLAIN_BOUND:
        raise AssertionError(f'main path vs plain apply: diff {diff:.3e}, niter {niter_plain}, '
                             f'K1 launches {cross_stencil_2d.launches}')
    print(f'main: HeatND {N_MAIN}^2 fp32 M={M_MAIN} LU, {N_STEPS} steps, niter {niter}, '
          f'K1 launches {launches} (= sum(2 + {M_MAIN}*niter)), wall {wall:.3f} s incl. first calls, '
          f'|uend - u_exact| {err_exact:.3e} <= {UEND_EXACT_BOUND}, '
          f'|uend - uend_plain_apply| {diff:.3e} <= {UEND_PLAIN_BOUND} [{card}]')
    return ctrl, launches


def phase_parity():
    import torch

    _, _, u_card, it_card = _run(_heat_description(256, torch.float64, 'cuda', restol=1e-10, maxiter=50))
    _, _, u_cpu, it_cpu = _run(_heat_description(256, torch.float64, 'cpu', restol=1e-10, maxiter=50))
    diff = (u_card.cpu() - u_cpu).abs().max().item()
    if it_card != it_cpu or diff > PARITY_UEND_TOL:
        raise AssertionError(f'parity: niter card {it_card} cpu {it_cpu}, uend diff {diff:.3e}')
    print(f'parity: HeatND 256^2 fp64 restol 1e-10, niter {it_card} on card and CPU, '
          f'uend diff {diff:.3e} <= {PARITY_UEND_TOL}')


def _time_stencil(shape, terms, card):
    """K1, its plain version and the conv2d yardstick at ``shape``, float32.
    Inputs rotate through enough buffers to exceed the 50 MB L2 cache."""
    import torch
    import torch.nn.functional as F

    from pysdc_tpu_torch.ops.kernels.stencil import _roll_cross_2d, cross_stencil_2d

    gen = torch.Generator(device='cuda').manual_seed(7)
    nbytes = math.prod(shape) * 4
    nbuf = max(2, math.ceil(3 * L2_BYTES / nbytes))
    us = [torch.randn(shape, generator=gen, device='cuda') for _ in range(nbuf)]
    reps = 4 * nbuf

    ms = _event_ms(lambda i: cross_stencil_2d(us[i % nbuf], terms), reps)
    plain_ms = _event_ms(lambda i: _roll_cross_2d(us[i % nbuf], terms), reps)

    # yardstick: one cuDNN convolution with the cross-shaped taps on a
    # circularly padded input (TF32 off); the port never calls it
    (cx, ox), (cy, oy) = terms
    rx, ry = max(abs(s) for s in ox), max(abs(s) for s in oy)
    w = torch.zeros((1, 1, 2 * rx + 1, 2 * ry + 1), device='cuda')
    for c, s in zip(cx, ox):
        w[0, 0, rx + s, ry] += c
    for c, s in zip(cy, oy):
        w[0, 0, rx, ry + s] += c
    padded = [F.pad(u.reshape((-1, 1) + shape[-2:]), (ry, ry, rx, rx), mode='circular') for u in us]
    library_ms = _event_ms(lambda i: F.conv2d(padded[i % nbuf], w), reps)
    lib_err = (F.conv2d(padded[0], w).reshape(shape) - cross_stencil_2d(us[0], terms)).abs().max().item()

    n_terms = sum(len(o) for _, o in terms)
    numel = math.prod(shape)
    bytes_s = 2 * nbytes / HBM_BYTES_PER_S
    ops_s = 2 * n_terms * numel / FP32_FLOP_PER_S
    bound_ms = 1e3 * max(bytes_s, ops_s)
    bound_by = 'bytes' if bytes_s >= ops_s else 'operations'
    print(f'times: K1 {shape} fp32: {ms:.4f} ms, plain {plain_ms:.4f} ms, conv2d yardstick {library_ms:.4f} ms '
          f'(its max abs diff to K1 {lib_err:.3e}), bound {bound_ms:.4f} ms by {bound_by}, '
          f'{2 * nbytes / ms / 1e6:.1f} GB/s [{card}]')
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_times(ctrl, card):
    import torch

    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    lvl = ctrl.MS[0].levels[0]
    terms = lvl.prob.A._cross_terms
    k1 = _time_stencil((N_MAIN, N_MAIN), terms, card)
    _time_stencil((M_MAIN, N_MAIN, N_MAIN), terms, card)

    # the parts of one sweep at the main path's shape: a shifted solve
    # (rfftn / divide / irfftn), the node-axis integral, the residual
    rhs = lvl.state.u[1].clone()
    solve_ms = _event_ms(lambda i: lvl.prob.A.solve_shifted(rhs, 0.003), 20)
    integral_ms = _event_ms(lambda i: lvl.integrate(), 20)
    residual_ms = _event_ms(lambda i: lvl.compute_residual(), 20)

    # one main-path sweep: update_nodes + residual, as bench.py's headline counts it
    def sweep(i):
        lvl.update_nodes()
        lvl.compute_residual()

    before = cross_stencil_2d.launches
    sweep_ms, sweep_host_ms = _event_ms(sweep, 10, warmup=2, host=True)
    per_sweep = (cross_stencil_2d.launches - before) / 12
    lvl.prob.A.disable_pallas()
    sweep_plain_ms = _event_ms(sweep, 10, warmup=2)
    lvl.prob.A.enable_pallas()
    nnz_per_sweep = M_MAIN * lvl.prob.A.nnz_per_dof * N_MAIN**2
    rest_ms = sweep_ms - M_MAIN * (k1['ms'] + solve_ms) - integral_ms - residual_ms
    print(f'times: sweep {N_MAIN}^2 fp32 {sweep_ms:.4f} ms on the card, {sweep_host_ms:.4f} ms to enqueue on the host '
          f'({per_sweep:.0f} K1 launches/sweep, {nnz_per_sweep / sweep_ms / 1e6:.3f} Gnnz/s); '
          f'through the plain apply {sweep_plain_ms:.4f} ms [{card}]')
    print(f'times: sweep parts: {M_MAIN} x K1 {M_MAIN * k1["ms"]:.4f} ms, {M_MAIN} x shifted solve '
          f'{M_MAIN * solve_ms:.4f} ms, integral {integral_ms:.4f} ms, residual {residual_ms:.4f} ms, '
          f'rest (Gauss-Seidel updates, stacking) {rest_ms:.4f} ms [{card}]')
    return k1


def main():
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA card (torch.cuda.is_available() is False)', file=sys.stderr)
        return 1
    card = _card()
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} [{card}]')
    phase_build(card)
    main_err = phase_kernels()
    ctrl, launches = phase_main(card)
    phase_parity()
    k1 = phase_times(ctrl, card)

    kernels = [dict(
        name='cross_stencil_2d', route='cuda', source='pysdc_tpu_torch/csrc/cross_stencil.cu',
        replaces='pysdc_tpu/ops/pallas/stencil.py:169', launches=launches, max_abs_err=main_err, **k1,
    )]
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
