"""Sweepers of the port, under the JAX package's module names: ``generic_implicit``, ``imex``, ``explicit``,
``multi_implicit``, ``linearized``, ``runge_kutta`` (the tableaus and ``RungeKutta`` / ``RungeKuttaIMEX``),
``multistep``, ``paradiag`` (``QDiagonalization``), the second-order ``verlet``, ``boris`` and ``rkn``, and ``dae``."""

from pysdc_tpu_torch.sweepers.explicit import ExplicitSweeper
from pysdc_tpu_torch.sweepers.generic_implicit import GenericImplicit
from pysdc_tpu_torch.sweepers.imex import IMEXSweeper
from pysdc_tpu_torch.sweepers.linearized import LinearizedImplicitParallel
from pysdc_tpu_torch.sweepers.multi_implicit import MultiImplicitSweeper
from pysdc_tpu_torch.sweepers.paradiag import QDiagonalization, QDiagonalizationIMEX

__all__ = ['ExplicitSweeper', 'GenericImplicit', 'IMEXSweeper', 'LinearizedImplicitParallel', 'MultiImplicitSweeper',
           'QDiagonalization', 'QDiagonalizationIMEX']
