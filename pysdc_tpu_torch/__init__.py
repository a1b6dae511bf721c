"""pysdc_tpu_torch: the PyTorch/CUDA port of pysdc_tpu.

A second package beside ``pysdc_tpu``, with its layout (``core/``, ``ops/``,
``models/``, ``sweepers/``, ``transfer/``, ``convergence/``, ``hooks/``,
``parallel/``, ``utils/``), its ``description``-dict frontend and its stats ``Entry``
schema, so one script runs against either package by swapping the import.
It imports torch, numpy and scipy, never JAX and nothing of ``pysdc_tpu``.
Every TPU kernel of the JAX package is a hand-written CUDA kernel for Hopper
under ``csrc/``, built at first use: the periodic cross stencil of the 2D
heat equation (``cross_stencil.cu``), the DIA SpMV of the sparse lane
(``dia_spmv.cu``) and its block-sparse SpMM (``bsr_spmm.cu``).  SDC (implicit,
IMEX, explicit, multi-implicit, Newton-linearized), MLSDC and virtual PFASST
run through ``ControllerNonMPI``, as do the Runge-Kutta tableaus
(:mod:`pysdc_tpu_torch.sweepers.runge_kutta`, with ``AdaptivityRK``) and the
multistep methods (:mod:`pysdc_tpu_torch.sweepers.multistep`); the FAS
transfers (``MeshTransfer``, ``FFTTransfer``, ``NoCoarseTransfer``) are in
:mod:`pysdc_tpu_torch.transfer`.  ``ShardedController`` keeps a block of time
steps in tensors with a time axis (one card, no mesh yet) and runs it on the
stage machine or, by default where eligible, on the fused lane or, for the
step-size adaptivity stack of :mod:`pysdc_tpu_torch.convergence`, on the
adaptive fused lane (:mod:`pysdc_tpu_torch.parallel.fused`: replayed CUDA
graphs on the card that read ``dt`` from the device).  Nonlinear PDEs solve
with the shared Newton-Krylov solver of :mod:`pysdc_tpu_torch.ops.solvers`,
iterative linear solves with ``jax.scipy``'s CG and GMRES rewritten in
:mod:`pysdc_tpu_torch.ops.krylov`; every such loop is a masked loop
(:mod:`pysdc_tpu_torch.ops.loops`) whose stopping test stays on the device.
The problem classes are exported from :mod:`pysdc_tpu_torch.models`.

Entry points run on the CUDA card unless the caller asks for the CPU::

    import torch
    from pysdc_tpu_torch import ControllerNonMPI, GenericImplicit
    from pysdc_tpu_torch.models.heat import HeatND

    description = dict(
        problem_class=HeatND,
        problem_params=dict(nvars=64, nu=0.1, freq=2, bc='periodic', device='cuda'),
        sweeper_class=GenericImplicit,
        sweeper_params=dict(num_nodes=3, QI='LU'),
        level_params=dict(dt=0.1, restol=1e-10),
        step_params=dict(maxiter=20),
    )
    controller = ControllerNonMPI(1, {'logger_level': 30}, description)
    prob = controller.MS[0].levels[0].prob
    uend, stats = controller.run(prob.u_exact(0.0), 0.0, 1.0)
"""

from pysdc_tpu_torch.core.precision import configure_default_matmul_precision

# numerics policy: no TF32 in matmuls or convolutions (core/precision.py)
configure_default_matmul_precision()

from pysdc_tpu_torch.parallel.nonmpi import ControllerNonMPI  # noqa: E402
from pysdc_tpu_torch.parallel.sharded import ShardedController  # noqa: E402
from pysdc_tpu_torch.sweepers.explicit import ExplicitSweeper  # noqa: E402
from pysdc_tpu_torch.sweepers.generic_implicit import GenericImplicit  # noqa: E402
from pysdc_tpu_torch.sweepers.imex import IMEXSweeper  # noqa: E402
from pysdc_tpu_torch.sweepers.linearized import LinearizedImplicitParallel  # noqa: E402
from pysdc_tpu_torch.sweepers.multi_implicit import MultiImplicitSweeper  # noqa: E402
from pysdc_tpu_torch.utils.stats import filter_stats, get_list_of_types, get_sorted, sort_stats  # noqa: E402

__version__ = '0.1.0'

__all__ = [
    'ControllerNonMPI',
    'ShardedController',
    'GenericImplicit',
    'IMEXSweeper',
    'ExplicitSweeper',
    'MultiImplicitSweeper',
    'LinearizedImplicitParallel',
    'filter_stats',
    'sort_stats',
    'get_sorted',
    'get_list_of_types',
]
