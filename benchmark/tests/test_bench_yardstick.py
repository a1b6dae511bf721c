"""The metric arithmetic against values worked out by hand."""

import pytest
import torch

from benchmark import yardstick
from benchmark.reference import sdc


def test_bench_percentile_over_all_intervals():
    values = list(range(1, 101))  # 1..100: rank 0.95 * 99 = 94.05 -> 95 + 0.05
    assert yardstick.percentile(values, 95) == pytest.approx(95.05)
    assert yardstick.percentile([3.0, 1.0, 2.0], 50) == 2.0
    assert yardstick.percentile([10.0], 95) == 10.0


def test_bench_rate_over_the_window():
    # 230 intervals of 4 steps in 46.0 s: every step over all the time
    assert yardstick.rate(230 * 4, 46.0) == pytest.approx(20.0)


def test_bench_stencil_work():
    flops, nbytes = yardstick.stencil_apply_work((3, 8, 512, 512), 4)
    assert nbytes == 2 * 3 * 8 * 512 * 512 * 4 and flops == 10 * 3 * 8 * 512 * 512
    share, by = yardstick.roofline_share(nbytes / 3.35e12 * 2, flops=flops, nbytes=nbytes, flop_peak=67e12)
    assert share == pytest.approx(50.0) and by == 'bytes'


def test_bench_dense_solve_work():
    # RayleighBenard 256 x 128: 256 systems of 512 rows, 4 right-hand sides, complex128 (chip_smoke.py: 93.8 GFLOP)
    flops, nbytes = yardstick.dense_solve_work(256, 512, 4, 16)
    assert flops == pytest.approx(256 * (8 / 3 * 512**3 + 8 * 512 * 512 * 4))
    assert flops / 1e9 == pytest.approx(93.8, abs=0.05)
    assert nbytes == (256 * 512 * 512 + 2 * 256 * 512 * 4) * 16
    share, by = yardstick.roofline_share(flops / 67e12 / 0.14, flops=flops, nbytes=nbytes, flop_peak=67e12)
    assert share == pytest.approx(14.0) and by == 'operations'


def test_bench_collocation_tables():
    c = sdc.Collocation.radau_right(3)
    # Radau IIA with 3 stages: nodes (4 -+ sqrt 6) / 10 and 1; its last row of q the weights (16 -+ sqrt 6) / 36, 1/9
    s6 = 6 ** 0.5
    assert c.nodes == pytest.approx([(4 - s6) / 10, (4 + s6) / 10, 1.0], abs=1e-15)
    assert c.q[-1] == pytest.approx([(16 - s6) / 36, (16 + s6) / 36, 1 / 9], abs=1e-15)
    assert c.QI == pytest.approx(torch.tensor(c.QI).tril().numpy())


def test_bench_tf32_rounding():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, 1.0 + 3 * 2**-12], dtype=torch.float32)
    # ties to even at the 10th bit of the mantissa
    assert sdc.tf32(x).tolist() == [1.0, 1.0 + 2**-9, 1.0 + 2**-10]
