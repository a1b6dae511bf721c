"""Convergence-controller registry.

The counterpart of ``pysdc_tpu/convergence/__init__.py``, with the same
names: one import point for the pluggable iteration policies — the
counterpart of the reference's ``implementations/convergence_controller_classes/``
package.  ``Compression`` and ``quantize_roundtrip`` live in
:mod:`pysdc_tpu_torch.convergence.compression`, as in the JAX package.
"""

from pysdc_tpu_torch.convergence.adaptive_collocation import AdaptiveCollocation
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
from pysdc_tpu_torch.convergence.check_iteration_estimator import CheckIterationEstimatorNonMPI
from pysdc_tpu_torch.convergence.crash import StopAtMaxRuntime, StopAtNan
from pysdc_tpu_torch.convergence.estimate_contraction_factor import EstimateContractionFactor
from pysdc_tpu_torch.convergence.estimate_embedded_error import (
    EstimateEmbeddedError,
    EstimateEmbeddedErrorCollocation,
    EstimateEmbeddedErrorLinearized,
)
from pysdc_tpu_torch.convergence.estimate_extrapolation_error import (
    EstimateExtrapolationErrorNonMPI,
    EstimateExtrapolationErrorWithinQ,
)
from pysdc_tpu_torch.convergence.estimate_polynomial_error import EstimatePolynomialError
from pysdc_tpu_torch.convergence.hotrod import HotRod
from pysdc_tpu_torch.convergence.inexactness import NewtonInexactness
from pysdc_tpu_torch.convergence.interpolate_between_restarts import InterpolateBetweenRestarts
from pysdc_tpu_torch.convergence.spread_step_sizes import SpreadStepSizesBlockwise
from pysdc_tpu_torch.convergence.step_size_limiter import (
    StepSizeLimiter,
    StepSizeRounding,
    StepSizeSlopeLimiter,
)
from pysdc_tpu_torch.convergence.store_uold import StoreUOld
from pysdc_tpu_torch.convergence.switch_estimator import SwitchEstimator

__all__ = [
    'AdaptiveCollocation',
    'Adaptivity',
    'AdaptivityCollocation',
    'AdaptivityExtrapolationWithinQ',
    'AdaptivityPolynomialError',
    'AdaptivityResidual',
    'AdaptivityRK',
    'BasicRestarting',
    'CheckConvergence',
    'CheckIterationEstimatorNonMPI',
    'EstimateContractionFactor',
    'EstimateEmbeddedError',
    'EstimateEmbeddedErrorCollocation',
    'EstimateEmbeddedErrorLinearized',
    'EstimateExtrapolationErrorNonMPI',
    'EstimateExtrapolationErrorWithinQ',
    'EstimatePolynomialError',
    'HotRod',
    'InterpolateBetweenRestarts',
    'NewtonInexactness',
    'SpreadStepSizesBlockwise',
    'StepSizeLimiter',
    'StepSizeRounding',
    'StepSizeSlopeLimiter',
    'StopAtMaxRuntime',
    'StopAtNan',
    'StoreUOld',
    'SwitchEstimator',
]
