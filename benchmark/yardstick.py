"""The benchmark's arithmetic: percentiles and rates, the published peaks, and the work a layer must do.

Nothing here imports the program.  The work functions count what a call needs, from its shapes (each byte read
once and written once, the operations of the algorithm), so that a later change to the program that fuses,
splits or replaces a kernel leaves the yardstick where it was.
"""

from __future__ import annotations

import math

#: NVIDIA H100 SXM, the data sheet's dense rates (at the full power limit of 700 W)
PEAKS = {
    'hbm_bytes_per_s': 3.35e12,
    'fp64_tensor_flop_per_s': 67e12,
    'fp32_flop_per_s': 67e12,
    'l2_bytes': 50 * 2**20,
}


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values``, by linear interpolation between the order statistics
    (numpy's default, ``statistics.quantiles(method='inclusive')``): rank ``(n - 1) q / 100`` from 0."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError('percentile of no values')
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    """All the work of a window over all its time."""
    return count / seconds


def roofline_share(seconds: float, flops: float = 0.0, nbytes: float = 0.0, flop_peak: float | None = None,
                   byte_peak: float = PEAKS['hbm_bytes_per_s']):
    """(share in %, what bounds it): the least time the card could take, the larger of the operations at the
    peak rate and the bytes at the bandwidth, over the time it took."""
    t_ops = flops / flop_peak if flops else 0.0
    t_bytes = nbytes / byte_peak
    bound = max(t_ops, t_bytes)
    return 100.0 * bound / seconds, ('operations' if t_ops >= t_bytes else 'bytes')


# -- work of the layers the per-layer metrics time ---------------------------------------------------------------
def stencil_apply_work(shape, itemsize: int, taps: int = 5):
    """(operations, bytes) of the cross stencil's apply over a field of ``shape``: a multiply and an add a tap
    and point, each element read once and written once (``chip_smoke.py``'s K1 bound)."""
    numel = math.prod(shape)
    return 2 * taps * numel, 2 * numel * itemsize


def dense_solve_work(batch: int, n: int, nrhs: int, itemsize: int, complex_: bool = True):
    """(operations, bytes) of an LU with partial pivoting and the two substitutions of ``batch`` systems of
    ``n`` rows with ``nrhs`` right-hand sides each (``chip_smoke.py``'s route bound): ``8/3 n^3 + 8 n^2 nrhs``
    real operations a complex matrix (a quarter of that for a real one), the matrices read once and the
    right-hand sides read and the solutions written once."""
    per = 8 / 3 * n**3 + 8 * n * n * nrhs
    flops = batch * (per if complex_ else per / 4)
    nbytes = (batch * n * n + 2 * batch * n * nrhs) * itemsize
    return flops, nbytes
