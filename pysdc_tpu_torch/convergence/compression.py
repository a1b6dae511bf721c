"""Lossy-compression error injection (compression research support).

The counterpart of ``pysdc_tpu/convergence/compression.py``; counterpart of
the reference ``Compression`` convergence controller
(projects/compression/compression_convergence_controller.py): after every
iteration the node solutions are round-tripped through a lossy compressor
with an absolute error bound and the RHS is re-evaluated, so the effect of
storing/communicating compressed state on SDC convergence order can be
studied (projects/compression/order.py).

The default compressor is *uniform quantization at the absolute error
bound* — the error model of SZ3's ``pressio:abs`` mode — as elementwise
tensor operations on the device.  A custom ``compressor`` callable (a
host-side codec, numpy in and out, one node at a time) can be supplied
instead; it costs one copy to the host and back per node.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.convergence import ConvergenceController


def quantize_roundtrip(u, abs_bound):
    """Encode/decode through uniform scalar quantization with bin width
    ``2*abs_bound``: the reconstruction error is bounded by ``abs_bound``."""
    width = 2.0 * abs_bound
    return torch.round(u / width) * width


class Compression(ConvergenceController):
    """params: ``abs_bound`` (default 1e-10), ``compressor`` (optional
    callable u -> u_roundtripped, overrides the quantizer)."""

    def setup(self, controller, params, description, **kwargs):
        return {
            'control_order': 0,
            'abs_bound': 1e-10,
            'compressor': None,
            **super().setup(controller, params, description, **kwargs),
        }

    def post_iteration_processing(self, controller, S, **kwargs):
        if len(S.levels) != 1:
            raise ValueError('Compression supports single-level runs (reference :36)')
        L = S.levels[0]
        if L.state is None:
            return
        compressor = self.params.compressor
        u = L.state.u
        if compressor is None:
            u_comp = quantize_roundtrip(u, float(self.params.abs_bound))
        else:
            host = u.detach().cpu().numpy()
            u_comp = torch.as_tensor(np.stack([np.asarray(compressor(node)) for node in host]),
                                     dtype=u.dtype, device=u.device)
        nodes = np.append(0.0, L.sweep.coll.nodes)
        f_new = L.prob.eval_f_batched(u_comp, float(L.time) + float(L.dt) * nodes)
        L.state = L.state._replace(u=u_comp, f=f_new)
