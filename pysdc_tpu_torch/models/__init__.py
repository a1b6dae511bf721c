"""Problem classes of the port, under the JAX package's names."""

from pysdc_tpu_torch.models.acoustic import AcousticAdvection1D
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
from pysdc_tpu_torch.models.boussinesq import Boussinesq2DIMEX
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
from pysdc_tpu_torch.models.monodomain import MonodomainIMEX, MonodomainIMEXEXP
from pysdc_tpu_torch.models.navier_stokes import NavierStokesVorticity2D
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
from pysdc_tpu_torch.models.power_electronics import Battery, BatteryNCapacitors, BuckConverter, Piline
from pysdc_tpu_torch.models.quench import Quench, QuenchIMEX
from pysdc_tpu_torch.models.rayleigh_benard import CFLLimit, RayleighBenard, RayleighBenard3D
from pysdc_tpu_torch.models.spectral_problems import Burgers1D, Heat2DChebyshev, HeatChebyshev1D
from pysdc_tpu_torch.models.var_diffusion import VarCoeffDiffusion1D, VarCoeffDiffusion2D, VarCoeffDiffusionForced1D
from pysdc_tpu_torch.models.wscc9 import WSCC9BusSystem

__all__ = [
    'DAEProblem', 'DiscontinuousTestDAE', 'EMFields', 'FermiPastaUlamTsingou', 'FullSolarSystem', 'HarmonicOscillator',
    'HenonHeiles', 'OneTransistorAmplifier', 'OuterSolarSystem', 'Particles', 'Pendulum2D', 'PenningTrap3D',
    'ProblematicF', 'SimpleDAE', 'SynchronousMachineInfiniteBus', 'TwoTransistorAmplifier',
    'Battery', 'BatteryNCapacitors', 'BuckConverter', 'Piline',
    'AdvectionDiffusion1D', 'AdvectionND', 'AllenCahn2DSpectral', 'AllenCahn2DSpectralStab', 'AllenCahnFront1D',
    'AllenCahnFront1DFinel', 'AllenCahnFront1DSemiImplicit', 'AllenCahnPeriodicMultiImplicitND',
    'AllenCahnPeriodicND', 'AllenCahnPeriodicSemiImplicitND', 'AllenCahnSpectralND', 'AllenCahnSpectralTimeForcing',
    'AllenCahnTempSpectralND', 'Auzinger', 'Brusselator', 'ChemicalReaction3Var', 'Dahlquist', 'DahlquistIMEX',
    'DiscontinuousTestODE', 'GeneralizedFisher1D', 'GrayScott', 'GrayScottLinearIMEX', 'GrayScottMultiImplicit',
    'GrayScottMultiImplicitLinear', 'HeatND', 'HeatNDForced', 'JacobiElliptic', 'Kaps', 'Logistic', 'Lorenz',
    'NonlinearODE1', 'NonlinearSchroedinger', 'PolynomialTestEquation', 'PolynomialTestEquationIMEX',
    'ProtheroRobinson', 'ProtheroRobinsonAutonomous', 'ProtheroRobinsonNonLinear', 'VanDerPol',
    'VarCoeffDiffusion1D', 'VarCoeffDiffusion2D', 'VarCoeffDiffusionForced1D',
    'AcousticAdvection1D', 'Boussinesq2DIMEX', 'Burgers1D', 'CFLLimit', 'Heat2DChebyshev', 'HeatChebyshev1D',
    'MonodomainIMEX', 'MonodomainIMEXEXP', 'NavierStokesVorticity2D', 'Quench', 'QuenchIMEX', 'RayleighBenard',
    'RayleighBenard3D', 'WSCC9BusSystem',
]
