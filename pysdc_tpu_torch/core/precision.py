"""Numerics policy: full-precision float32 products on the card.

The counterpart of ``pysdc_tpu/core/precision.py``.  pySDC-style frameworks
terminate on residual tolerances (reference ``pySDC/core/sweeper.py:164-222``),
so the small coefficient contractions along the node axis (Q, QDelta,
weights, eigenbases; ``torch.tensordot`` in the sweepers and operators) must
run at full input precision: reduced-precision inputs put a floor of about
1e-3 under the achievable residual.

On an NVIDIA card a float32 matrix product runs in full float32 only while
``torch.backends.cuda.matmul.allow_tf32`` is False, and a float32 convolution
only while ``torch.backends.cudnn.allow_tf32`` is False (the latter is True
by default).  Importing :mod:`pysdc_tpu_torch` sets both to False and the
float32 matmul precision to ``'highest'``.
"""

from __future__ import annotations

import torch


def configure_default_matmul_precision() -> None:
    """Turn TF32 off for matmuls and convolutions (called at package import)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
