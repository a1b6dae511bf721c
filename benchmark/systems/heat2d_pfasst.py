"""The system under test for a ``heat2d_pfasst`` configuration: the program's two-level ``HeatND`` (periodic,
eigen backend) under generic implicit SDC through its block controller, ``ShardedController(num_procs)``."""

from __future__ import annotations


def build(config: dict, device):
    import torch

    from pysdc_tpu_torch import GenericImplicit, ShardedController
    from pysdc_tpu_torch.models.heat import HeatND

    description = dict(
        problem_class=HeatND,
        problem_params=dict(nu=config['nu'], freq=config['freq'], nvars=[tuple(n) for n in config['nvars']],
                            bc=config['bc'], dtype=getattr(torch, config['dtype']), device=device),
        sweeper_class=GenericImplicit,
        sweeper_params=dict(quad_type=config['quad_type'], num_nodes=config['num_nodes'], QI=config['QI']),
        level_params=dict(restol=config['restol'], dt=config['dt'], residual_type=config['residual_type']),
        step_params=dict(maxiter=config['maxiter']),
        space_transfer_params=dict(config['space_transfer']),
    )
    params = {'logger_level': 30, 'predict_type': config['predict_type']}
    return ShardedController(config['num_procs'], params, description, coarse_mode=config['coarse_mode'])
