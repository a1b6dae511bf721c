"""The ``varcoeff2d`` family and its cell ``sparse.n1024`` at a tiny size on the CPU: a correct dry run, the control
and each fault not correct, the reference's own solve and independence, the new readers without a card, and the
work functions against values worked out by hand."""

import functools
import importlib
import json
import math
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import control, harness, sparse_yardstick, yardstick
from benchmark.reference import varcoeff2d

ROOT = Path(__file__).resolve().parents[2]
CELL = 'sparse.n1024'
TINY = {'nvars': [[32, 32]]}
READERS = ['pcg_trips_per_solve', 'spmv_apply_roofline', 'precond_solve_roofline']

DRY_RUN = '''
import json, sys
sys.path.insert(0, {root!r})
from benchmark import harness
r = harness.run_cell({cell!r}, 2**31 + 99, 0.5, False, device='cpu', overrides={tiny!r})
print(json.dumps({{'result': r, 'held': harness.forbidden_modules(),
                   'modules': sorted({{m.split('.')[0] for m in sys.modules}})}}))
'''


def test_sparse_dry_run():
    """A whole run of the cell in a process of its own: correct, every step 8 iterations, no JAX."""
    code = DRY_RUN.format(root=str(ROOT), cell=CELL, tiny=TINY)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    r = line['result']
    assert r['correct'] is True and r['failed'] == 0 and r['attempted'] >= 1
    assert set(r['metrics']) == {'steps_per_s', 'interval_ms_p95', 'setup_s'}
    assert line['held'] == [] and 'pysdc_tpu_torch' in line['modules']
    assert 'mean iterations a step 8.0000' in out.stderr


def test_sparse_reference_imports_nothing_of_the_program():
    code = ('import sys; sys.path.insert(0, %r)\n'
            'import benchmark.reference.varcoeff2d, benchmark.sparse_yardstick\n'
            'print(sorted({m.split(".")[0] for m in sys.modules}))' % str(ROOT))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert not set(eval(out.stdout)) & {'pysdc_tpu_torch', 'pysdc_tpu', 'jax', 'jaxlib', 'flax'}


@functools.lru_cache(maxsize=None)
def _readings():
    out, _ = control.readings(CELL, [5, 6, 7], 0.3, device='cpu', overrides=TINY, fault_seeds=(5, 6, 7))
    return out


def _fails(reading, limits):
    return any(reading[k] is None or not reading[k] <= limits[k] for k in limits)


def test_sparse_control_fails():
    limits = harness.load_cell(CELL).limits
    for r in _readings().values():
        assert not _fails(r['program'], limits)
        assert _fails(r['control'], limits)


@pytest.mark.parametrize('fault', list(varcoeff2d.FAULTS))
def test_sparse_planted_faults_are_not_correct(fault):
    """Each fault (only the mean-coefficient preconditioner solved, solves stopped at 1e-2, a sweep too few) fails
    the cell's limits on three seeds."""
    limits = harness.load_cell(CELL).limits
    for r in _readings().values():
        assert _fails(r['faults'][fault], limits)


def _dense_operator(nx, ny):
    """The conservative five-point matrix row by row from its definition: ``a`` at the faces, the walls at 0."""
    def a(x, y):
        return 0.1 * (1 + 0.5 * math.sin(2 * math.pi * x) * math.cos(2 * math.pi * y))

    hx, hy = 1 / (nx + 1), 1 / (ny + 1)
    A = torch.zeros((nx * ny, nx * ny), dtype=torch.float64)
    for i in range(nx):
        for j in range(ny):
            row, x, y = i * ny + j, (i + 1) * hx, (j + 1) * hy
            for di, dj, w in ((1, 0, a(x + hx / 2, y) / hx**2), (-1, 0, a(x - hx / 2, y) / hx**2),
                              (0, 1, a(x, y + hy / 2) / hy**2), (0, -1, a(x, y - hy / 2) / hy**2)):
                A[row, row] -= w
                if 0 <= i + di < nx and 0 <= j + dj < ny:
                    A[row, (i + di) * ny + j + dj] += w
    return A


def test_sparse_reference_operator_and_solve():
    """The reference's operator equals its definition; its solve reaches its own tolerance on every system."""
    torch.manual_seed(0)
    prob = varcoeff2d.VarDiffusion2D(9, 7, 0.1, 0.5, torch.float64, 'cpu')
    u = torch.rand((2, 9, 7), dtype=torch.float64)
    want = (u.reshape(2, -1) @ _dense_operator(9, 7).T).reshape(u.shape)
    torch.testing.assert_close(prob.apply(u), want, rtol=1e-13, atol=1e-13 * float(want.abs().max()))
    rhs = torch.rand((3, 9, 7), dtype=torch.float64)
    alpha = 2.5e-4
    x = prob.solve(rhs, alpha)
    res = rhs - (x - alpha * prob.apply(x))
    assert float((res.norm(dim=(-2, -1)) / rhs.norm(dim=(-2, -1))).max()) <= varcoeff2d.SOLVE_TOL


@pytest.mark.parametrize('name', READERS)
def test_sparse_reader_returns_none_without_a_card(name):
    run = SimpleNamespace(device=torch.device('cpu'))
    ctx = SimpleNamespace(run=run, window=harness.Window(intervals=[harness.Interval(0.05, [[8, 8, 8, 8]])]),
                          torch=torch, yardstick=yardstick)
    assert importlib.import_module(f'benchmark.metrics.{name}').read(ctx) is None


def test_sparse_spmv_work():
    # K2 at the PCG's shape (4, 1024^2) float32 on 5 diagonals: the diagonals, the input and the output once
    flops, nbytes = sparse_yardstick.spmv_apply_work(1024 * 1024, 4, 5, 4)
    assert flops == 2 * 5 * 4 * 1024 * 1024 and nbytes == (5 + 2 * 4) * 1024 * 1024 * 4 == 54_525_952
    share, by = yardstick.roofline_share(nbytes / 3.35e12 / 0.71, flops=flops, nbytes=nbytes, flop_peak=67e12)
    assert share == pytest.approx(71.0) and by == 'bytes'


def test_sparse_precond_work():
    # the preconditioner at (4, 1024, 1024) float32: the right-hand side and the solution once, no tables
    flops, nbytes = sparse_yardstick.precond_solve_work((4, 1024, 1024), 4)
    assert flops == 0 and nbytes == 2 * 4 * 1024 * 1024 * 4 == 33_554_432
    share, by = yardstick.roofline_share(1e-3, flops=flops, nbytes=nbytes, flop_peak=67e12)
    assert share == pytest.approx(100 * 33_554_432 / 3.35e12 / 1e-3) and by == 'bytes'
