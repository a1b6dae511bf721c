"""Times of the fused block paths on one CUDA card, to compare two commits in one call.

    python3 block_times.py [--root DIR] [--tag NAME]

``--root`` imports ``pysdc_tpu_torch`` from DIR (another commit unpacked with ``git archive``); the configurations
come from this checkout's ``chip_smoke.py``.  After a first run (the capture), CUDA events and the host clock time:

- pfasst: the PFASST fused block of ``chip_smoke.py`` phase 18 (HeatND 512^2 / 256^2 float32, ShardedController(8),
  coarse chain ``'diag'``, burn-in, restol 1e-3, one block), 5 runs, and its busy time (profiler);
- march: phase 16's march (the same at relative residuals, 4 blocks of 8 steps), 3 runs, and its busy time;
- sparse: phase 67's block (VarCoeffDiffusion2D 1024^2 float32, M=4 LU, ShardedController(4), restol 1e-6,
  maxiter 8), 3 runs;
- rbc: phase 69's block (RayleighBenard 256 x 64 float64, IMEX M=3, ShardedController(4), maxiter 4) on the stage
  lane and, where the package takes it, on the fused lane, 3 runs each in turns, and the busy time of each;
- linearized: phase 70's block (``LinearizedImplicitParallel`` on HeatND 32^2 float64, ShardedController(4), its
  1024-row complex solves), both lanes in turns, 3 runs each;
- rbc128: phase 72's block (RayleighBenard 256 x 128 float64, 512 rows a mode), both lanes in turns, 3 runs each.

``--configs`` names the configurations to run (default: all).

The profiler does not see the kernels of a device loop inside a device loop, so a busy time (and the idle share from
it) is printed only where the block's loops nest at most one deep.  Every line of results starts with ``TIME`` and
the tag, and ends with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
import time
from pathlib import Path


def _chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke', Path(__file__).with_name('chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _timed(torch, fn, runs):
    """ms on the card (CUDA events) and on the host clock of each of ``runs`` calls of ``fn()``."""
    card, host = [], []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
        card.append(start.elapsed_time(end))
    return card, host


def main():
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--root', default=None, help='import pysdc_tpu_torch from this directory')
    parser.add_argument('--tag', default='this')
    parser.add_argument('--configs', default='pfasst,march,sparse,rbc,linearized,rbc128')
    args = parser.parse_args()
    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print('block_times: no CUDA card', file=sys.stderr)
        return 1
    c = _chip_smoke()
    from pysdc_tpu_torch import ShardedController
    from pysdc_tpu_torch.core.errors import ControllerError

    card = c._card()
    tag = args.tag

    def report(name, fn, runs, busy=True):
        fn()  # warm-up and capture
        ms, host = _timed(torch, fn, runs)
        extra = ''
        if busy:
            busy_ms, kernels = c._device_busy(fn)
            extra = f', busy {busy_ms:.3f} ms in {kernels} kernels and copies, idle {100 * (1 - busy_ms / min(ms)):.1f}%'
        print(f'TIME {tag} {name}: ms on the card {[round(x, 3) for x in ms]}, host clock '
              f'{[round(x, 3) for x in host]}{extra} [{card}]', flush=True)

    configs = args.configs.split(',')

    if 'pfasst' in configs:  # one block
        desc = c._pfasst_description(c.N_PFASST, c.NC_PFASST, torch.float32, 'cuda', c.RESTOL_PFASST)
        ctrl = c._block_controller(desc, c.P_PFASST, coarse_mode='diag')
        u0 = ctrl.MS[0].levels[0].prob.u_exact(0.0)
        report(f'pfasst fused block {c.N_PFASST}^2/{c.NC_PFASST}^2 fp32', lambda: ctrl.run_fused(u0, 0.0, c.P_PFASST * c.DT),
               5)
        del ctrl

    if 'march' in configs:  # phase 16's PFASST march of 4 blocks
        desc = c._pfasst_description(c.N_PFASST, c.NC_PFASST, torch.float32, 'cuda', c.RESTOL_PFASST)
        desc['level_params'] = dict(desc['level_params'], residual_type='full_rel')
        ctrl = c._block_controller(desc, c.P_PFASST)
        u0 = ctrl.MS[0].levels[0].prob.u_exact(0.0)
        n_steps = c.MARCH_BLOCKS * c.P_PFASST
        report(f'fused march {c.MARCH_BLOCKS} blocks', lambda: ctrl.run_fused(u0, 0.0, n_steps * c.DT), 3)
        del ctrl

    if 'sparse' in configs:  # phase 67's block (its PCG loops nest inside the block's loop)
        desc = c._sparse_description(c.N_SPARSE, torch.float32, 'cuda', restol=c.RESTOL_SF, maxiter=c.MAXITER_SF)
        ctrl = ShardedController(c.P_SF, {'logger_level': 30}, desc)
        us = c._sin_field(ctrl.MS[0].levels[0].prob)
        report(f'sparse fused block {c.N_SPARSE}^2 fp32', lambda: ctrl.run_fused(us, 0.0, c.P_SF * c.DT_SPARSE), 3,
               busy=False)
        del ctrl
        torch.cuda.empty_cache()

    def both_lanes(name, desc, u0_of, block):
        """Stage and fused in turns, 3 runs each."""
        lanes = {lane: ShardedController(c.P_RBC, {'logger_level': 30}, desc) for lane in ('stage', 'fused')}
        u0 = u0_of(lanes['stage'])
        try:
            lanes['fused'].run(u0, 0.0, block, lane='fused')
        except ControllerError as err:
            print(f'TIME {tag} {name} fused lane refused: {err} [{card}]')
            del lanes['fused']
        for lane in list(lanes) * 2:
            report(f'{name} {lane} block', lambda: lanes[lane].run(u0, 0.0, block, lane=lane), 3)
        del lanes
        torch.cuda.empty_cache()

    def exact(ctrl):
        return ctrl.MS[0].levels[0].prob.u_exact(0.0)

    if 'rbc' in configs:
        both_lanes('rbc 256x64 fp64', c._rbc_description('cuda'), exact, c.P_RBC * c.DT_RBC)
    if 'linearized' in configs:
        from pysdc_tpu_torch import LinearizedImplicitParallel
        from pysdc_tpu_torch.models.heat import HeatND

        n = c.N_LINEARIZED
        desc = dict(problem_class=HeatND, problem_params=dict(nvars=(n, n), nu=0.1, freq=2, bc='periodic',
                                                              dtype=torch.float64, device='cuda'),
                    sweeper_class=LinearizedImplicitParallel,
                    sweeper_params=dict(num_nodes=3, quad_type='RADAU-RIGHT', jacobian=0, basis='Q'),
                    level_params=dict(dt=0.01, restol=1e-10), step_params=dict(maxiter=20))
        both_lanes(f'linearized HeatND {n}^2 fp64', desc, exact, 0.04)
    if 'rbc128' in configs:
        both_lanes(f'rbc {c.RBC_LU["nx"]}x{c.RBC_LU["nz"]} fp64', c._rbc_lu_description(c.RBC_LU, 'cuda'), exact,
                   c.P_RBC * c.DT_RBC)
    return 0


if __name__ == '__main__':
    sys.exit(main())
