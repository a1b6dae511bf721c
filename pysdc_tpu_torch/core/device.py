"""Device selection and constants on a device for the port's entry points.

Problems and operators run on the CUDA card unless the caller asks for the
CPU (``device='cpu'``, as the tests do).  Without a card, asking for CUDA
raises: nothing carries on silently on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device='cuda') -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} needs a CUDA card, and torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def complex_dtype(dtype: torch.dtype) -> torch.dtype:
    """The complex dtype with the precision of ``dtype`` (real or complex)."""
    return torch.complex64 if dtype in (torch.float32, torch.complex64) else torch.complex128


def cached_tensor(cache: dict, key, make, like: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """The constant ``make()`` (a numpy array) as a tensor on ``like``'s
    device, in ``dtype`` (default: ``like``'s), made once per (key, dtype,
    device) and kept in ``cache``."""
    dtype = like.dtype if dtype is None else dtype
    full_key = (key, dtype, like.device)
    t = cache.get(full_key)
    if t is None:
        # np.array copies: the collocation tables are read-only arrays
        t = cache[full_key] = torch.as_tensor(np.array(make()), dtype=dtype, device=like.device)
    return t
