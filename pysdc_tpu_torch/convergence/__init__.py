"""Convergence-controller registry (the counterpart of
``pysdc_tpu/convergence/__init__.py``): the controllers the stage machine
registers by itself and the embedded-error adaptivity stack.  The names of the
JAX package's registry that are not ported yet are exported where a class
exists that raises naming its ROADMAP item."""

from pysdc_tpu_torch.convergence.adaptivity import (
    Adaptivity,
    AdaptivityCollocation,
    AdaptivityExtrapolationWithinQ,
    AdaptivityPolynomialError,
    AdaptivityResidual,
    AdaptivityRK,
)
from pysdc_tpu_torch.convergence.basic_restarting import BasicRestarting
from pysdc_tpu_torch.convergence.check_convergence import CheckConvergence
from pysdc_tpu_torch.convergence.estimate_embedded_error import (
    EstimateEmbeddedError,
    EstimateEmbeddedErrorCollocation,
    EstimateEmbeddedErrorLinearized,
)
from pysdc_tpu_torch.convergence.spread_step_sizes import SpreadStepSizesBlockwise
from pysdc_tpu_torch.convergence.step_size_limiter import (
    StepSizeLimiter,
    StepSizeRounding,
    StepSizeSlopeLimiter,
)
from pysdc_tpu_torch.convergence.store_uold import StoreUOld

__all__ = [
    'Adaptivity',
    'AdaptivityCollocation',
    'AdaptivityExtrapolationWithinQ',
    'AdaptivityPolynomialError',
    'AdaptivityResidual',
    'AdaptivityRK',
    'BasicRestarting',
    'CheckConvergence',
    'EstimateEmbeddedError',
    'EstimateEmbeddedErrorCollocation',
    'EstimateEmbeddedErrorLinearized',
    'SpreadStepSizesBlockwise',
    'StepSizeLimiter',
    'StepSizeRounding',
    'StepSizeSlopeLimiter',
    'StoreUOld',
]
