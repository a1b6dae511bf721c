"""The harness at tiny sizes on the CPU: a well-formed result, no JAX in the process, the reference's
independence, the control and the faults of the timed path each come out not correct."""

import functools
import importlib
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import control, harness
from benchmark.tests.tiny import TINY

ROOT = Path(__file__).resolve().parents[2]
CELLS = sorted(TINY)

DRY_RUN = '''
import json, sys
sys.path.insert(0, {root!r})
from benchmark import harness
r = harness.run_cell({cell!r}, 2**31 + 99, 0.5, False, device='cpu', overrides={tiny!r})
print(json.dumps({{'result': r, 'held': harness.forbidden_modules(),
                   'modules': sorted({{m.split('.')[0] for m in sys.modules}})}}))
'''


@pytest.mark.parametrize('cell', CELLS)
def test_bench_dry_run(cell):
    """A whole run of ``cell`` in a process of its own: the last line well formed, the check compared last,
    correct, and neither JAX nor the JAX package in ``sys.modules`` (compared by whole top-level names)."""
    code = DRY_RUN.format(root=str(ROOT), cell=cell, tiny=TINY[cell])
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    r = line['result']
    assert list(r)[:5] == ['correct', 'attempted', 'failed', 'metrics', 'device'] and list(r)[-1] == 'compared'
    assert r['correct'] is True and r['failed'] == 0 and r['attempted'] >= 1
    assert set(r['metrics']) == {'steps_per_s', 'interval_ms_p95', 'setup_s'}
    assert all(m['value'] > 0 for m in r['metrics'].values())
    assert all(c['value'] <= c['limit'] for c in r['compared'].values())
    assert line['held'] == [] and 'pysdc_tpu_torch' in line['modules']
    assert 'jax' not in line['modules'] and 'pysdc_tpu' not in line['modules']
    assert out.stderr.strip().splitlines()[-1].startswith('compared ')


def test_bench_run_needs_a_card():
    """Without a CUDA card the command prints no result and exits with another code than 0."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    out = subprocess.run([sys.executable, 'benchmark/run.py', '--workload', 'rbc2d.nz64', '--seed', '1',
                          '--seconds', '1', '--trace', '0'], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ''


def test_bench_reference_imports_nothing_of_the_program():
    code = ('import sys; sys.path.insert(0, %r)\n'
            'import benchmark.reference.sdc, benchmark.reference.rbc2d, benchmark.reference.heat2d_pfasst\n'
            'print(sorted({m.split(".")[0] for m in sys.modules}))' % str(ROOT))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    held = set(eval(out.stdout))
    assert not held & {'pysdc_tpu_torch', 'pysdc_tpu', 'jax', 'jaxlib', 'flax'}


@functools.lru_cache(maxsize=None)
def _readings(cell):
    """The program's, the control's and every fault's readings of ``cell`` on three seeds at its test size."""
    out, _ = control.readings(cell, [5, 6, 7], 0.3, device='cpu', overrides=TINY[cell], fault_seeds=(5, 6, 7))
    return out


def _fails(reading, limits):
    return any(reading[k] is None or not reading[k] <= limits[k] for k in limits)


@pytest.mark.parametrize('cell', ['rbc2d.nz128', 'heat2d_pfasst.n512'])
def test_bench_control_fails(cell):
    """The control (the reference one precision below the configuration's, in the program's place) fails the
    cell's limits on three seeds, where the program passes them."""
    limits = harness.load_cell(cell).limits
    for r in _readings(cell).values():
        assert not _fails(r['program'], limits)
        assert _fails(r['control'], limits)


FAULTS = [(cell, name) for cell in ('rbc2d.nz64', 'heat2d_pfasst.n512')
          for name in importlib.import_module(f'benchmark.reference.{cell.split(".")[0]}').FAULTS]


@pytest.mark.parametrize('cell,fault', FAULTS, ids=['-'.join(f) for f in FAULTS])
def test_bench_planted_faults_are_not_correct(cell, fault):
    """Each of the family's faults (the reference with one thing wrong, in the program's place: a Laplacian by
    the wrong symbol, a shifted transfer, a step stopped at 1.4 or 2 restol, products not dealiased, an
    iteration too few) fails the cell's limits on three seeds."""
    limits = harness.load_cell(cell).limits
    for r in _readings(cell).values():
        assert _fails(r['faults'][fault], limits)


def _unchanged(ctrl):
    def march(u):
        uend, stats = ctrl.run(u, 0.0, ctrl._bench_Tend, lane='fused')
        return u.clone(), stats
    return march


def _half_the_steps(ctrl):
    def march(u):
        half, stats = ctrl.run(u, 0.0, ctrl._bench_Tend / 2, lane='fused')
        _, stats = ctrl.run(u, 0.0, ctrl._bench_Tend, lane='fused')
        return half, stats
    return march


def _altered(ctrl):
    def march(u):
        uend, stats = ctrl.run(u, 0.0, ctrl._bench_Tend, lane='fused')
        uend = uend.clone()
        uend.view(-1)[uend.numel() // 3] += 1e-2 * uend.abs().max()
        return uend, stats
    return march


@pytest.mark.parametrize('fault', [_unchanged, _half_the_steps, _altered], ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize('cell', ['rbc2d.nz64', 'heat2d_pfasst.n512'])
def test_bench_faults_are_not_correct(cell, fault):
    """The rest of a run with the timed path broken underneath: a step that returns its state unchanged, half
    of the block's steps left out, an answer altered where it is produced.  (One card: no exchange between
    chips to leave out.)"""
    spec = harness.load_cell(cell, overrides=TINY[cell])
    Tend = spec.traffic['blocks_per_interval'] * spec.config['num_procs'] * spec.config['dt']

    def wrap(ctrl):
        ctrl._bench_Tend = Tend
        return fault(ctrl)

    r = harness.run_cell(cell, 17, 0.3, False, device='cpu', overrides=TINY[cell], wrap=wrap)
    assert r['correct'] is False


@pytest.mark.card
def test_bench_one_run_on_the_card(card):
    """One short run of the smallest cell on the card: correct, with the device's name."""
    r = harness.run_cell('heat2d_pfasst.n512', 23, 2.0, False, device=card)
    assert r['correct'] is True and r['device']['platform'] == 'gpu'
