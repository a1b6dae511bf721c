"""The per-layer metrics that read the program's spans (``benchmark/spans.py``): each returns ``None`` without a card,
and on the CPU at a tiny size the readings hold together."""

import importlib
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, spans, yardstick
from benchmark.tests.tiny import TINY

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
READERS = [m['name'] for m in BENCH['per_layer'] if m['source'] == 'program_span']


def test_span_metrics_are_declared():
    assert READERS == ['march_host_ms', 'device_idle_share', 'block_device_ms', 'coarse_chain_share',
                       'stencil_block_share', 'dense_solve_block_share']


@pytest.mark.parametrize('name', READERS)
def test_span_reader_returns_none_without_a_card(name):
    run = SimpleNamespace(device=torch.device('cpu'))
    ctx = SimpleNamespace(run=run, window=harness.Window(intervals=[harness.Interval(0.05, [[1, 1]])]))
    assert importlib.import_module(f'benchmark.metrics.{name}').read(ctx) is None
    assert ctx.spans is None


@pytest.mark.parametrize('cell', ['heat2d_pfasst.n512', 'rbc2d.nz64'])
def test_span_readings_on_the_cpu(cell):
    """The readings of a tiny run, traced on the CPU (each device span the host clock around its call): the checks
    equal the iteration counts' and every share lies in 0-100%."""
    torch.set_num_threads(2)
    from pysdc_tpu_torch.utils import trace

    spec = harness.load_cell(cell, overrides=TINY[cell])
    run = harness.Run(spec, 2**31 + 5, 'cpu')
    run.warm()
    ctx = SimpleNamespace(spec=spec, run=run, window=run.window(0.3, 2), torch=torch, yardstick=yardstick)
    out = spans.measure(ctx, trace)
    run.close()
    assert not trace.enabled()
    assert out.checks['block_check'] == out.checks['checks'] > 0 and out.checks['late'] == 0
    assert 90 <= out.checks['phases_share'] <= 100
    assert 0 <= out.device_idle_share <= 100 and 0 < out.block_device_ms and out.march_host_ms > 0
    heat = cell.startswith('heat')
    for share, here in ((out.coarse_chain_share, heat), (out.stencil_block_share, heat),
                        (out.dense_solve_block_share, not heat)):
        assert (share is not None) == here and (share is None or 0 < share <= 100)
