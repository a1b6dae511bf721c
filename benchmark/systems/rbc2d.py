"""The system under test for an ``rbc2d`` configuration: the program's ``RayleighBenard`` under IMEX SDC through
its block controller, ``ShardedController(num_procs)``."""

from __future__ import annotations


def build(config: dict, device):
    import torch

    from pysdc_tpu_torch import IMEXSweeper, ShardedController
    from pysdc_tpu_torch.models.rayleigh_benard import RayleighBenard

    problem = {key: config[key] for key in ('nx', 'nz', 'Rayleigh', 'Prandtl', 'Lx', 'Lz', 'z0', 'dealiasing')}
    description = dict(
        problem_class=RayleighBenard,
        problem_params=dict(problem, dtype=getattr(torch, config['dtype']), device=device),
        sweeper_class=IMEXSweeper,
        sweeper_params=dict(num_nodes=config['num_nodes'], quad_type=config['quad_type'], QI=config['QI'],
                            QE=config['QE']),
        level_params=dict(dt=config['dt'], restol=config['restol'], residual_type=config['residual_type']),
        step_params=dict(maxiter=config['maxiter']),
    )
    params = {'logger_level': 30, 'mssdc_jac': config['mssdc_jac'], 'predict_type': config['predict_type']}
    return ShardedController(config['num_procs'], params, description)
