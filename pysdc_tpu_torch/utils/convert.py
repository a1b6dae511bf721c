"""Carry fields and level states between the JAX package and the port.

``to_torch`` / ``state_to_torch`` take numpy arrays (or anything
``numpy.asarray`` reads, such as arrays of the JAX package) to the port's
tensors on a given device and dtype; ``to_numpy`` / ``state_to_numpy`` go
back.  Containers are matched by their field names, so the JAX package's
``IMEX``/``Comp2``/``IMEXEXP`` (RHS) and ``Particles``/``EMFields`` (second-order states
and the Boris sweeper's fields) become the port's, leaf by leaf.

Complex fields (the nonlinear Schroedinger state) keep their imaginary part:
a real ``dtype`` asked of a complex array gives the complex dtype of its
precision.  ``step_to_numpy`` / ``step_to_torch`` carry a whole multi-level step across:
the first reads every level's ``(u, f, tau)``, ``uold`` (the previous sweep's
``u`` that ``StoreUOld`` keeps, or what a restriction left), ``fold`` and step
size ``dt`` of a step of either package as numpy, the second writes such a
list into the levels of a step of the port, each on its problem's device: a
block that adaptivity rejected (the new ``dt`` on the finest level, the old
one below) reaches both packages in the same state.  ``dts_to_torch`` /
``dts_to_numpy`` carry a block's per-level step sizes as the float64 tensor
the fused lanes read them from.

``fault_to_torch`` makes the port's ``Fault`` from the fields of a fault of
the JAX package (or a ``dict`` of them), and ``extrapolation_store_to_torch``
/ ``extrapolation_store_to_numpy`` carry the stored step-end history of an
``EstimateExtrapolationErrorNonMPI`` (times, step sizes, ``u`` and ``f``), so
a run of either package can start from the same numpy state.

``dia_to_torch`` / ``bsr_to_torch`` carry sparse operators across: the
fields of the JAX package's ``DIA`` and ``BSR`` containers, as numpy arrays,
become the port's containers on a device (the card unless ``device='cpu'``),
so both packages apply the same matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.device import complex_dtype
from pysdc_tpu_torch.core.state import IMEX, IMEXEXP, Comp2, LevelState
from pysdc_tpu_torch.models.particles import EMFields, Particles
from pysdc_tpu_torch.ops.sparse import BSR, DIA

_CONTAINERS = {IMEX._fields: IMEX, Comp2._fields: Comp2, IMEXEXP._fields: IMEXEXP, Particles._fields: Particles,
               EMFields._fields: EMFields}


def to_torch(x, device, dtype=None):
    """A field (e.g. an initial value ``u0``) as a tensor on ``device``; a
    container (``Particles``) as the port's container of such tensors."""
    if getattr(x, '_fields', None) is not None:
        return _rhs(x, lambda part: to_torch(part, device, dtype))
    arr = np.asarray(x)
    if not arr.flags.writeable:  # arrays of the JAX package are read-only views
        arr = arr.copy()
    if dtype is not None and np.iscomplexobj(arr) and not dtype.is_complex:
        dtype = complex_dtype(dtype)
    return torch.as_tensor(arr, dtype=dtype, device=device)


def to_numpy(x):
    """A tensor (or array) as numpy; a container as the port's container of numpy arrays."""
    if getattr(x, '_fields', None) is not None:
        return _rhs(x, to_numpy)
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rhs(f, conv):
    fields = getattr(f, '_fields', None)
    if fields is None:
        return conv(f)
    if fields not in _CONTAINERS:
        raise TypeError(f'no container of the port has the fields {fields}')
    return _CONTAINERS[fields](*(conv(part) for part in f))


def state_to_torch(state, device, dtype=None) -> LevelState:
    """A level state ``(u, f, tau)`` as the port's :class:`LevelState`."""
    u, f, tau = state
    conv = lambda x: to_torch(x, device, dtype)  # noqa: E731
    return LevelState(u=conv(u), f=conv(f), tau=conv(tau))


def state_to_numpy(state) -> LevelState:
    """A level state with every field as a numpy array."""
    u, f, tau = state
    return LevelState(u=to_numpy(u), f=to_numpy(f), tau=to_numpy(tau))


def step_to_numpy(step) -> list[dict]:
    """Per level of ``step`` (of either package): ``state`` as a numpy
    :class:`LevelState`, ``uold`` and ``fold`` as numpy (None where unset), ``dt`` as a float."""
    return [
        dict(
            state=None if lvl.state is None else state_to_numpy(lvl.state),
            uold=None if lvl.uold is None else to_numpy(lvl.uold),
            fold=None if lvl.fold is None else _rhs(lvl.fold, to_numpy),
            dt=None if lvl.params.dt is None else float(lvl.params.dt),
        )
        for lvl in step.levels
    ]


def step_to_torch(levels: list[dict], step, dtype=None):
    """Write ``levels`` (as ``step_to_numpy`` gives them) into the levels of
    the port's ``step``, each on its problem's device; a level that receives
    a state is unlocked, as after ``predict`` or a restriction."""
    if len(levels) != len(step.levels):
        raise ValueError(f'{len(levels)} level states for a step of {len(step.levels)} levels')
    for data, lvl in zip(levels, step.levels):
        conv = lambda x, dev=lvl.prob.device: to_torch(x, dev, dtype)  # noqa: E731
        lvl.state = None if data['state'] is None else state_to_torch(data['state'], lvl.prob.device, dtype)
        lvl.uold = None if data['uold'] is None else conv(data['uold'])
        lvl.fold = None if data['fold'] is None else _rhs(data['fold'], conv)
        lvl.status.unlocked = lvl.state is not None
        if data.get('dt') is not None:
            lvl.params.dt = float(data['dt'])
    return step


def dts_to_torch(dts, device) -> torch.Tensor:
    """A block's per-level step sizes (finest first) as the float64 tensor of
    ``nlevels`` entries that the fused lanes' programs take as an input."""
    return torch.as_tensor(np.asarray(dts, dtype=np.float64).reshape(-1).copy(), dtype=torch.float64, device=device)


def dts_to_numpy(dts) -> np.ndarray:
    return to_numpy(dts).astype(np.float64).reshape(-1)


def dia_to_torch(data, offsets, shape, grid=None, device='cuda') -> DIA:
    """A DIA matrix from its fields: ``data (k, n)``, ``offsets (k,)``,
    ``shape`` and the optional 2D-grid decomposition ``grid``."""
    return DIA(np.asarray(data, dtype=float), [int(o) for o in np.asarray(offsets)], tuple(shape),
               grid=grid, device=device)


def bsr_to_torch(blocks, seg_starts, shape, br, bc, device='cuda') -> BSR:
    """A BSR matrix from its fields: ``blocks (nb, kb, br, bc)``,
    ``seg_starts (nb, kb)`` (element offsets), ``shape``, ``br`` and ``bc``."""
    return BSR(np.asarray(blocks, dtype=float), np.asarray(seg_starts), tuple(shape), int(br), int(bc),
               device=device)


_FAULT_FIELDS = ('time', 'timestep', 'level_number', 'iteration', 'node', 'problem_pos', 'bit', 'happened')


def fault_to_torch(fault):
    """The port's ``Fault`` with the fields of ``fault`` (a fault of either package, or a dict)."""
    from pysdc_tpu_torch.resilience.fault_injection import Fault

    get = fault.get if isinstance(fault, dict) else lambda key, default=None: getattr(fault, key, default)
    fields = {key: get(key) for key in _FAULT_FIELDS if get(key) is not None}
    if 'problem_pos' in fields:
        fields['problem_pos'] = tuple(int(p) for p in fields['problem_pos'])
    return Fault(**fields)


def extrapolation_store_to_numpy(store: dict) -> dict:
    """An extrapolation estimate's ``store`` (either package's) with its fields as numpy arrays
    (empty slots stay ``None``)."""
    return {key: [None if v is None else (to_numpy(v) if key in ('u', 'f') else float(v)) for v in vals]
            for key, vals in store.items()}


def extrapolation_store_to_torch(store: dict, device, dtype=None) -> dict:
    """A ``store`` as :func:`extrapolation_store_to_numpy` gives it, with ``u`` and ``f`` as tensors on ``device``."""
    return {key: [None if v is None else (to_torch(v, device, dtype) if key in ('u', 'f') else float(v))
                  for v in vals] for key, vals in store.items()}
