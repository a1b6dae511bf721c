"""State containers for the SDC core, on tensors.

The counterpart of ``pysdc_tpu/core/state.py``.  A level's node data is one
tuple of tensors with a leading node axis:

  - ``u``:   (M+1, *shape)   solution at [t0, node_1..node_M]
  - ``f``:   RHS, each component (M+1, *shape); a plain tensor for
             single-component problems, :class:`IMEX` for split problems,
             :class:`Comp2` for multi-implicit ones.
  - ``tau``: (M, *shape)     FAS correction (zeros when unused)

RHS containers mirror the reference's ``imex_mesh`` / ``comp2_mesh``
attribute views (``pySDC/implementations/datatype_classes/mesh.py:128-190``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class IMEX(NamedTuple):
    """Split RHS: ``impl`` (stiff, solved implicitly) + ``expl`` parts."""

    impl: Any
    expl: Any


class Comp2(NamedTuple):
    """Two implicit components (multi-implicit sweeper)."""

    comp1: Any
    comp2: Any


def components(f) -> tuple:
    """The tensors of an RHS: the fields of a container, or ``(f,)``."""
    return tuple(f) if isinstance(f, tuple) else (f,)


def map_components(fn, *fs):
    """Apply ``fn`` componentwise to RHS values of the same kind, or leaf by
    leaf to states of the same kind (a tensor, or a container such as
    ``Particles``): on a tensor it is ``fn`` itself."""
    if isinstance(fs[0], tuple):
        return type(fs[0])(*(fn(*parts) for parts in zip(*fs)))
    return fn(*fs)


def f_total(f):
    """Full right-hand side: sum of all components."""
    parts = components(f)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


class LevelState(NamedTuple):
    """All device data of one level of one time step."""

    u: torch.Tensor  # (M+1, *shape)
    f: Any  # tensor or container of tensors, each (M+1, *shape)
    tau: torch.Tensor  # (M, *shape)

    @property
    def u0(self):
        return self.u[0]

    @property
    def num_nodes(self):
        return self.u.shape[0] - 1


def norm_max(x) -> torch.Tensor:
    """The datatype norm of the reference (``mesh.__abs__``,
    mesh.py:65-83): max absolute value over all components, as a 0-d
    tensor on the field's device (no host sync)."""
    return torch.stack([part.abs().amax() for part in components(x)]).amax()
