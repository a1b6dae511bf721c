"""Sizes at which a cell's configuration runs on the CPU in a test."""

TINY = {
    'rbc2d.nz128': dict(nx=16, nz=16),
    'rbc2d.nz64': dict(nx=16, nz=8),
    'heat2d_pfasst.n512': dict(nvars=[[64, 64], [32, 32]]),
}
