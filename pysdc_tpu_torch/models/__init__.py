"""Problem classes of the port, under the JAX package's names."""

from pysdc_tpu_torch.models.advdiff import AdvectionDiffusion1D
from pysdc_tpu_torch.models.advection import AdvectionND
from pysdc_tpu_torch.models.allen_cahn import (
    AllenCahnFront1D,
    AllenCahnFront1DFinel,
    AllenCahnFront1DSemiImplicit,
    AllenCahnPeriodicMultiImplicitND,
    AllenCahnPeriodicND,
    AllenCahnPeriodicSemiImplicitND,
)
from pysdc_tpu_torch.models.allen_cahn_spectral import (
    AllenCahn2DSpectral,
    AllenCahn2DSpectralStab,
    AllenCahnSpectralND,
    AllenCahnSpectralTimeForcing,
    AllenCahnTempSpectralND,
)
from pysdc_tpu_torch.models.brusselator import Brusselator
from pysdc_tpu_torch.models.dae_problems import (
    DAEProblem,
    DiscontinuousTestDAE,
    OneTransistorAmplifier,
    Pendulum2D,
    ProblematicF,
    SimpleDAE,
    SynchronousMachineInfiniteBus,
    TwoTransistorAmplifier,
)
from pysdc_tpu_torch.models.dahlquist import Dahlquist, DahlquistIMEX
from pysdc_tpu_torch.models.fisher import GeneralizedFisher1D
from pysdc_tpu_torch.models.gray_scott import (
    GrayScott,
    GrayScottLinearIMEX,
    GrayScottMultiImplicit,
    GrayScottMultiImplicitLinear,
)
from pysdc_tpu_torch.models.heat import HeatND, HeatNDForced
from pysdc_tpu_torch.models.nls import NonlinearSchroedinger
from pysdc_tpu_torch.models.odes import (
    Auzinger,
    ChemicalReaction3Var,
    DiscontinuousTestODE,
    JacobiElliptic,
    Kaps,
    Logistic,
    Lorenz,
    NonlinearODE1,
    PolynomialTestEquation,
    PolynomialTestEquationIMEX,
    ProtheroRobinson,
    ProtheroRobinsonAutonomous,
    ProtheroRobinsonNonLinear,
    VanDerPol,
)
from pysdc_tpu_torch.models.particles import (
    EMFields,
    FermiPastaUlamTsingou,
    FullSolarSystem,
    HarmonicOscillator,
    HenonHeiles,
    OuterSolarSystem,
    Particles,
    PenningTrap3D,
)
from pysdc_tpu_torch.models.var_diffusion import VarCoeffDiffusion1D, VarCoeffDiffusion2D, VarCoeffDiffusionForced1D

__all__ = [
    'DAEProblem', 'DiscontinuousTestDAE', 'EMFields', 'FermiPastaUlamTsingou', 'FullSolarSystem', 'HarmonicOscillator',
    'HenonHeiles', 'OneTransistorAmplifier', 'OuterSolarSystem', 'Particles', 'Pendulum2D', 'PenningTrap3D',
    'ProblematicF', 'SimpleDAE', 'SynchronousMachineInfiniteBus', 'TwoTransistorAmplifier',
    'AdvectionDiffusion1D', 'AdvectionND', 'AllenCahn2DSpectral', 'AllenCahn2DSpectralStab', 'AllenCahnFront1D',
    'AllenCahnFront1DFinel', 'AllenCahnFront1DSemiImplicit', 'AllenCahnPeriodicMultiImplicitND',
    'AllenCahnPeriodicND', 'AllenCahnPeriodicSemiImplicitND', 'AllenCahnSpectralND', 'AllenCahnSpectralTimeForcing',
    'AllenCahnTempSpectralND', 'Auzinger', 'Brusselator', 'ChemicalReaction3Var', 'Dahlquist', 'DahlquistIMEX',
    'DiscontinuousTestODE', 'GeneralizedFisher1D', 'GrayScott', 'GrayScottLinearIMEX', 'GrayScottMultiImplicit',
    'GrayScottMultiImplicitLinear', 'HeatND', 'HeatNDForced', 'JacobiElliptic', 'Kaps', 'Logistic', 'Lorenz',
    'NonlinearODE1', 'NonlinearSchroedinger', 'PolynomialTestEquation', 'PolynomialTestEquationIMEX',
    'ProtheroRobinson', 'ProtheroRobinsonAutonomous', 'ProtheroRobinsonNonLinear', 'VanDerPol',
    'VarCoeffDiffusion1D', 'VarCoeffDiffusion2D', 'VarCoeffDiffusionForced1D',
]
