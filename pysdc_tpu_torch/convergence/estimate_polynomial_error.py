"""Polynomial-interpolation error estimate within the collocation nodes.

The counterpart of ``pysdc_tpu/convergence/estimate_polynomial_error.py``;
mirrors reference ``EstimatePolynomialError``
(convergence_controller_classes/estimate_polynomial_error.py:7-199):
interpolate the collocation polynomial, leaving one node out, to that node —
the order mismatch gives a local error estimate independent of how the
collocation solution was obtained.  The interpolation is one weight row
contracted with the node axis (the first axis of the node stack); the
estimate is one host read.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.convergence import ConvergenceController
from pysdc_tpu_torch.core.errors import ParameterError
from pysdc_tpu_torch.core.state import norm_max
from pysdc_tpu_torch.ops.lagrange import interpolation_matrix


class EstimatePolynomialError(ConvergenceController):
    def setup(self, controller, params, description, **kwargs):
        sw = description['sweeper_params']
        M = sw['num_nodes']
        quad = sw.get('quad_type', 'RADAU-RIGHT')
        # For GAUSS the right end is not a node, so interpolating *to* it
        # (index M+1) loses one order; otherwise leave out the second-to-last
        # node instead.
        defaults = {
            'control_order': -75,
            'estimate_on_node': M + 1 if quad == 'GAUSS' else M - 1,
            'rel_error': False,
            **super().setup(controller, params, description, **kwargs),
        }
        if quad != 'GAUSS' and defaults['estimate_on_node'] > M:
            raise ParameterError(
                'when the right end is itself a node, a lower-order interpolation to it is meaningless'
            )
        from pysdc_tpu_torch.hooks.logging_hooks import LogEmbeddedErrorEstimate

        controller.add_hook(LogEmbeddedErrorEstimate)
        self.interpolation_matrix = None
        return defaults

    def setup_status_variables(self, controller, **kwargs):
        self.add_status_variable_to_level('error_embedded_estimate')
        self.add_status_variable_to_level('order_embedded_estimate')

    def post_iteration_processing(self, controller, S, **kwargs):
        from pysdc_tpu_torch.convergence.check_convergence import CheckConvergence

        if not CheckConvergence.check_convergence(S):
            return
        L = S.levels[0]
        coll = L.sweep.coll
        nodes = np.concatenate(([0.0], coll.nodes, [1.0]))
        k = self.params.estimate_on_node

        if self.interpolation_matrix is None:
            pts = [nodes[i] for i in range(coll.num_nodes + 1) if i != k]
            self.interpolation_matrix = interpolation_matrix(np.asarray(pts), np.array([nodes[k]]))

        u = L.state.u
        keep = [i for i in range(coll.num_nodes + 1) if i != k]
        weights = torch.as_tensor(self.interpolation_matrix[0], dtype=u.dtype, device=u.device)
        u_inter = torch.tensordot(weights, u[keep], dims=([0], [0]))

        if k == len(nodes) - 1:
            L.compute_end_point()
            high_order_sol = L.uend
            L.status.order_embedded_estimate = coll.num_nodes + 1
        else:
            high_order_sol = u[k]
            L.status.order_embedded_estimate = coll.num_nodes

        rescale = float(norm_max(u_inter)) if self.params.rel_error else 1.0
        L.status.error_embedded_estimate = float(norm_max(u_inter - high_order_sol)) / rescale
