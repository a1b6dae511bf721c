"""The readings that a cell's limits are set from: the program's and the control's, over many seeds.

    python3 benchmark/control.py --workload rbc2d.nz128 --seeds 11,12,13 --seconds 4 [--faults 11,12]

For each seed, in one process (the set-up once): a short window of the cell's own intervals through the program,
then, with the program freed, the check's numbers of each seed (``field_gap``, ``decisions_off``) for the
program, and for the control: the reference in the next precision below the configuration's
(``reference/<family>.py``'s ``CONTROL``), put in the program's place on the same inputs and judged by the
reference as the program is.  The program's largest reading over the seeds is the lower end of a limit, the
control's smallest the upper.  For the seeds given to ``--faults``, each of the family's ``FAULTS`` is read the
same way.  One JSON line a seed, a summary last.  The benchmark's own runs do not run this.
"""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def readings(cell: str, seeds, seconds: float, device='cuda', overrides=None, wrap=None, fault_seeds=()):
    """``{seed: {'program': {...}, 'control': {...}, 'faults': {name: {...}}}}`` for ``seeds`` (the faults for
    those of ``fault_seeds``)."""
    import torch

    from benchmark import harness

    spec = harness.load_cell(cell, overrides=overrides)
    run = harness.Run(spec, seeds[0], device, wrap=wrap)
    run.warm()
    windows = {}
    for seed in seeds:
        run.seed = int(seed)
        run.state = run.prev_out = None
        windows[seed] = run.window(seconds, spec.traffic['check_intervals'])
        harness.log(f'{cell} seed {seed}: {len(windows[seed].intervals)} intervals, {windows[seed].failed} failed')
    run.close()
    family = importlib.import_module(f'benchmark.reference.{spec.config["family"]}')
    dev = torch.device(device)
    out = {}
    for seed, win in windows.items():
        program = harness.judge(spec, win.samples, seed, dev)
        control = harness.judge(spec, win.samples, seed, dev, control=True)
        faults = {name: harness.judge(spec, win.samples, seed, dev, fault=name)
                  for name in (family.FAULTS if seed in fault_seeds else ())}
        out[seed] = {'program': program, 'control': control, 'faults': faults, 'failed': win.failed,
                     'intervals': len(win.intervals), 'checked': len(win.samples)}
    return out, family.CONTROL


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True, help='comma-separated seeds')
    parser.add_argument('--seconds', type=float, default=4.0)
    parser.add_argument('--faults', default='', help='comma-separated seeds on which to read the faults')
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print('control: no CUDA card', file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    seeds = [int(s) for s in args.seeds.split(',')]
    fault_seeds = [int(s) for s in args.faults.split(',') if s]
    out, control = readings(args.workload, seeds, args.seconds, fault_seeds=fault_seeds)
    for seed, r in out.items():
        print(json.dumps({'seed': seed, **r}))
    summary = {'workload': args.workload, 'control': control, 'seconds': time.perf_counter() - t0,
               'device': torch.cuda.get_device_name(0)}
    for key in ('field_gap', 'decisions_off'):
        summary[key] = {'program_max': max(r['program'][key] for r in out.values()),
                        'control_min': min(r['control'][key] for r in out.values())}
        for name in {n for r in out.values() for n in r['faults']}:
            summary[key][f'{name}_min'] = min(r['faults'][name][key] for r in out.values() if name in r['faults'])
    summary['ties'] = max(r['program']['ties'] for r in out.values())
    print(json.dumps(summary))
    return 0


if __name__ == '__main__':
    sys.exit(main())
