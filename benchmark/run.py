"""Run one cell of the benchmark once and print its result as the last line of standard output.

    python3 benchmark/run.py --workload rbc2d.nz128 --seed 12345 --seconds 45 --trace 0

Needs a CUDA card (and as many as the cell asks for): without one it prints no result and exits with 2.  With
``--trace 0`` the metrics are the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, the
device's busy time and a breakdown.  The numbers the check compared, each with its limit, end standard error and
the result line.  A run whose process holds JAX or the JAX package once the window has closed prints no result
and exits with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark import harness

    spec = harness.load_cell(args.workload)
    import torch

    chips = spec.cell['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        harness.log(f'{args.workload} needs {chips} CUDA card(s); this machine has {count}: no result')
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device='cuda',
                              t_start=T_START)
    held = harness.forbidden_modules()
    if held:
        harness.log(f'the run holds {held} in sys.modules: no result')
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
