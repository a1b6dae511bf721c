"""Identity space transfer: coarsen only in collocation nodes.

The counterpart of ``pysdc_tpu/transfer/no_coarse.py`` (reference
``TransferMesh_NoCoarse``, implementations/transfer_classes): the spatial
restrict/prolong are identities, so multi-level hierarchies coarsen purely
in the node dimension.
"""

from __future__ import annotations


class NoCoarseTransfer:
    def __init__(self, fine_prob, coarse_prob, params: dict):
        if fine_prob.shape != coarse_prob.shape:
            raise ValueError(
                f'NoCoarseTransfer needs identical problem shapes, got {fine_prob.shape} vs {coarse_prob.shape}'
            )

    def restrict(self, F):
        return F

    def prolong(self, G):
        return G
