"""Convergence-controller registry (the counterpart of
``pysdc_tpu/convergence/__init__.py``); this slice ports the controllers the
stage machine registers by itself."""

from pysdc_tpu_torch.convergence.basic_restarting import BasicRestarting
from pysdc_tpu_torch.convergence.check_convergence import CheckConvergence
from pysdc_tpu_torch.convergence.spread_step_sizes import SpreadStepSizesBlockwise

__all__ = ['BasicRestarting', 'CheckConvergence', 'SpreadStepSizesBlockwise']
