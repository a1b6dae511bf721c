"""The reader ``precond_sine_share`` (``benchmark/metrics/precond_sine_share.py``): declared for ``sparse.n1024``
alone, ``None`` without a card or without the program's counters, and on a tiny run of the cell on the CPU, where the
program counts on the host, 0: every preconditioner solve there takes the sine transform chain, not the kernels."""

import json
from pathlib import Path
from types import SimpleNamespace

import torch

from benchmark import harness, yardstick
from benchmark.metrics import precond_sine_share

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
CELL = 'sparse.n1024'


def test_declared():
    (m,) = [m for m in BENCH['per_layer'] if m['name'] == 'precond_sine_share']
    (roofline,) = [m for m in BENCH['per_layer'] if m['name'] == 'precond_solve_roofline']  # the same layer
    assert m == {'name': 'precond_sine_share', 'unit': '%', 'better': 'higher', 'source': 'program_counter',
                 'layer': roofline['layer'], 'moves': 'steps_per_s', 'workloads': [CELL]}


def test_returns_none_without_a_card():
    run = SimpleNamespace(device=torch.device('cpu'))
    ctx = SimpleNamespace(run=run, window=harness.Window(intervals=[harness.Interval(0.05, [[8, 8, 8, 8]])]))
    assert precond_sine_share.read(ctx) is None


class _Run:
    """A run whose intervals count nothing: the program of a tree without the counters."""

    def start_of(self, i):
        return None, None

    def interval(self, u0):
        self.intervals = getattr(self, 'intervals', 0) + 1


def test_returns_none_without_the_counters():
    from pysdc_tpu_torch.utils import trace

    run = _Run()
    run.device = torch.device('cpu')
    ctx = SimpleNamespace(run=run, window=harness.Window(intervals=[harness.Interval(0.05, [[8, 8, 8, 8]])]))
    assert precond_sine_share.measure(ctx, trace) is None
    assert run.intervals > 1 and not trace.enabled()


def test_reading_on_the_cpu():
    """A tiny run of the cell (32^2 float32): the preconditioner's solves are counted, and none is by the sine kernels,
    which run on the card only: the reading sees the route the solves took, not the operator's axes."""
    torch.set_num_threads(2)
    from pysdc_tpu_torch.utils import trace

    spec = harness.load_cell(CELL, overrides={'nvars': [[32, 32]]})
    run = harness.Run(spec, 2**31 + 7, 'cpu')
    run.warm()
    ctx = SimpleNamespace(spec=spec, run=run, window=run.window(0.3, 2), torch=torch, yardstick=yardstick)
    share = precond_sine_share.measure(ctx, trace)
    run.close()
    assert share == 0.0 and not trace.enabled()
