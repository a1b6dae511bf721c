"""The system under test for a ``varcoeff2d`` configuration: the program's ``VarCoeffDiffusion2D`` (conservative
variable-coefficient diffusion, Dirichlet-0; K2's SpMV and PCG preconditioned by the mean-coefficient eigen solve)
under generic implicit SDC through its block controller, ``ShardedController(num_procs)``."""

from __future__ import annotations

import numpy as np


def diffusivity(config: dict):
    """``a(x, y) = mean (1 + amplitude sin 2 pi x cos 2 pi y)`` of the configuration, on numpy arrays."""
    mean, amplitude = config['diffusivity']['mean'], config['diffusivity']['amplitude']

    def a(x, y):
        return mean * (1.0 + amplitude * np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y))

    return a


def build(config: dict, device):
    import torch

    from pysdc_tpu_torch import GenericImplicit, ShardedController
    from pysdc_tpu_torch.models.var_diffusion import VarCoeffDiffusion2D

    if config['bc'] != 'dirichlet':
        raise ValueError(f'VarCoeffDiffusion2D holds Dirichlet-0 walls, not {config["bc"]!r}')
    (nvars,) = config['nvars']
    description = dict(
        problem_class=VarCoeffDiffusion2D,
        problem_params=dict(nvars=tuple(nvars), coeff_fn=diffusivity(config), dtype=getattr(torch, config['dtype']),
                            solver=config['solver'], device=device),
        sweeper_class=GenericImplicit,
        sweeper_params=dict(quad_type=config['quad_type'], num_nodes=config['num_nodes'], QI=config['QI']),
        level_params=dict(restol=config['restol'], dt=config['dt'], residual_type=config['residual_type']),
        step_params=dict(maxiter=config['maxiter']),
    )
    params = {'logger_level': 30, 'mssdc_jac': config['mssdc_jac'], 'predict_type': config['predict_type']}
    return ShardedController(config['num_procs'], params, description)
