"""Device-mesh helpers for the (time, node, space) sharding of PFASST blocks.

The counterpart of ``pysdc_tpu/parallel/mesh.py``.  The reference scales with
nested MPI communicators ``[comm_time, comm_node, comm_space]``
(projects/GPU/configs/base_config.py:20-57); the JAX package uses one 3-axis
``jax.sharding.Mesh`` whose axes carry the same roles.  This port keeps the
JAX package's single controller: one process builds the mesh and the
controllers, and a mesh is an array of ``torch.device`` shaped
``(n_time, n_node, n_space)``.  Each position holds its shard as a tensor on
its device; what ``shard_map`` runs once per device runs once per shard here,
and every ``ppermute`` or all-gather is an explicit copy between shards
(:meth:`Mesh.copy_to`, :meth:`Mesh.gather`).  A position may repeat a device:
``make_mesh(n_time=4, devices=['cuda:0'] * 4)`` is a mesh of four positions on
one card, ``devices=['cpu'] * 8`` the counterpart of the JAX tests' eight
emulated host devices.  On a machine with several cards the same code copies
between them.

:class:`Mesh`, :class:`PartitionSpec` and :class:`NamedSharding` are small
types of this package with the attributes of JAX's that the controllers read
(``axis_names``, ``devices``, ``shape`` as a mapping).  :func:`device_put`
places a tensor by a sharding and returns a :class:`ShardedTensor`, whose
``addressable_shards`` carry an ``index``, the ``data`` and a
``replica_id`` as a ``jax.Array``'s do (FieldsIO writes them slab by slab).

A mesh's ``traffic`` counts what the code moves between its positions:
``copies`` (a tensor handed to another position: a slab, a halo's ghost rows,
a step's end point crossing a shard boundary, a chain's carry) and
``gathers`` (shards joined on one position).  Positions that share a device
count their copies all the same: they are what the layout costs on a mesh of
distinct devices.  The time row that a per-shard call runs as
(:meth:`Mesh.time_row`) is the mesh's too.
"""

from __future__ import annotations

import contextlib
import itertools
from types import SimpleNamespace

import numpy as np
import torch

AXIS_NAMES = ('time', 'node', 'space')


def _device(d) -> torch.device:
    return d if isinstance(d, torch.device) else torch.device(d)


class TimeShards(tuple):
    """A block split along its time axis into the mesh's time shards: part
    ``c`` holds the steps of time row ``c``, on that row's first position."""

    def __new__(cls, parts=()):
        return super().__new__(cls, parts)


class PartitionSpec(tuple):
    """One mesh axis name (or None) per array dimension, as
    ``jax.sharding.PartitionSpec``; dimensions past its length are not sharded."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f'PartitionSpec{tuple(self)!r}'


class Mesh:
    """An object array of ``torch.device`` with named axes."""

    def __init__(self, devices, axis_names):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f'{devices.ndim}-dimensional device array for axis names {tuple(axis_names)}')
        flat = np.empty(devices.size, dtype=object)
        flat[:] = [_device(d) for d in devices.reshape(-1)]
        self.devices = flat.reshape(devices.shape)
        self.axis_names = tuple(axis_names)
        #: tensors moved between positions and shards joined on one position, since the last reset
        self.traffic = {'copies': 0, 'gathers': 0}
        self._row = 0  # the time row whose positions the current per-shard call runs on

    def reset_traffic(self) -> None:
        self.traffic = {'copies': 0, 'gathers': 0}

    @contextlib.contextmanager
    def time_row(self, row: int):
        """Run the body as the shard of time row ``row``: the halo applies
        inside it exchange among that row's space positions."""
        old, self._row = self._row, int(row)
        try:
            yield
        finally:
            self._row = old

    def copy_to(self, x: torch.Tensor, device) -> torch.Tensor:
        """``x`` handed to the position on ``device`` (one counted copy)."""
        self.traffic['copies'] += 1
        return x.to(device)

    def gather(self, parts, device, dim: int = 0) -> torch.Tensor:
        """The shards ``parts`` joined along ``dim`` on ``device`` (one counted gather)."""
        self.traffic['gathers'] += 1
        return torch.cat([p.to(device) for p in parts], dim=dim)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_set(self) -> set:
        return set(self.devices.reshape(-1))

    def positions(self, axis: str) -> list:
        """The devices along ``axis``, the other axes at the current time row
        (where the mesh has a 'time' axis other than ``axis``) and at 0."""
        index = []
        for name in self.axis_names:
            if name == axis:
                index.append(slice(None))
            elif name == 'time':
                index.append(self._row)
            else:
                index.append(0)
        return list(self.devices[tuple(index)])

    def row_device(self, row: int) -> torch.device:
        """The first position of time row ``row``: where that row's shard of a block lives."""
        index = tuple(row if name == 'time' else 0 for name in self.axis_names)
        return self.devices[index]

    def __repr__(self):
        return f'Mesh({self.shape}, {sorted(str(d) for d in self.device_set)})'


class NamedSharding:
    """A mesh and a :class:`PartitionSpec`, as ``jax.sharding.NamedSharding``."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)
        for name in self.spec:
            if name is not None and name not in mesh.axis_names:
                raise ValueError(f'partition spec {self.spec} names {name!r}, not an axis of {mesh.axis_names}')

    @property
    def is_fully_replicated(self) -> bool:
        return all(name is None or self.mesh.shape[name] == 1 for name in self.spec)

    def indices(self, shape) -> list:
        """``(position, index)`` for every mesh position in order: the slices
        of an array of ``shape`` that the position holds."""
        sizes = self.mesh.shape
        if len(self.spec) > len(shape):
            raise ValueError(f'{self.spec} is only valid for values of rank at least {len(self.spec)}, '
                             f'not for shape {tuple(shape)}')
        for dim, name in enumerate(self.spec):
            if name is not None and shape[dim] % sizes[name]:
                raise ValueError(f'dimension {dim} of shape {tuple(shape)} does not divide over mesh axis {name!r} '
                                 f'of size {sizes[name]}')
        out = []
        for pos in itertools.product(*(range(n) for n in self.mesh.devices.shape)):
            at = dict(zip(self.mesh.axis_names, pos))
            index = []
            for dim in range(len(shape)):
                name = self.spec[dim] if dim < len(self.spec) else None
                if name is None:
                    index.append(slice(None))
                else:
                    n = shape[dim] // sizes[name]
                    index.append(slice(at[name] * n, (at[name] + 1) * n))
            out.append((pos, tuple(index)))
        return out


class ShardedTensor:
    """A tensor placed by a :class:`NamedSharding`: each mesh position holds
    its shard on its device (a ``jax.Array`` with that sharding)."""

    def __init__(self, shape, dtype, sharding: NamedSharding, shards):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.sharding = sharding
        self.addressable_shards = shards

    @property
    def is_fully_replicated(self) -> bool:
        return self.sharding.is_fully_replicated

    def gather(self, device) -> torch.Tensor:
        """The whole tensor on ``device``, each distinct slab read once."""
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for sh in self.addressable_shards:
            if sh.replica_id == 0:
                out[sh.index] = sh.data.to(device)
        self.sharding.mesh.traffic['gathers'] += 1
        return out


def device_put(x: torch.Tensor, sharding: NamedSharding) -> ShardedTensor:
    """Place ``x`` by ``sharding``: every position gets a copy of its slab on
    its device (replicated axes hold equal copies, numbered by ``replica_id``)."""
    seen: dict = {}
    shards = []
    for pos, index in sharding.indices(tuple(x.shape)):
        key = tuple((s.start, s.stop) for s in index)
        replica = seen.get(key, 0)
        seen[key] = replica + 1
        device = sharding.mesh.devices[pos]
        shards.append(SimpleNamespace(device=device, index=index, replica_id=replica,
                                      data=sharding.mesh.copy_to(x[index].contiguous(), device)))
    return ShardedTensor(x.shape, x.dtype, sharding, shards)


def make_mesh(n_time: int = 1, n_space: int = 1, n_node: int = 1, devices=None) -> Mesh:
    """Build a (time, node, space) mesh from the given devices.

    ``devices=None`` takes every CUDA card (``torch.cuda.device_count()``); a
    mesh never falls back to the CPU.  ``devices`` may name one device more
    than once: ``['cuda:0'] * 4`` is a mesh of four positions on one card and
    ``['cpu'] * 8`` eight positions on the host, the counterpart of the JAX
    tests' emulated devices.  Axes of size 1 are kept, so all downstream code
    can address 'time'/'node'/'space' uniformly.
    """
    if devices is None:
        devices = [torch.device('cuda', i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    need = n_time * n_node * n_space
    if len(devices) < need:
        raise ValueError(
            f'need {need} devices for mesh (time={n_time}, node={n_node}, space={n_space}), have {len(devices)}'
        )
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return Mesh(grid.reshape(n_time, n_node, n_space), axis_names=AXIS_NAMES)


def block_sharding(mesh: Mesh, ndim_space: int, shard_space: bool = True,
                   node_axis_len: int | None = None) -> NamedSharding:
    """Sharding for block state arrays (P, M+1, *space): leading axis over
    'time', the collocation-node axis over 'node' (only when the mesh has a
    non-trivial node axis AND ``node_axis_len`` divides evenly), first
    spatial axis over 'space' (if requested)."""
    node = None
    if 'node' in mesh.axis_names and mesh.shape['node'] > 1:
        if node_axis_len is not None and node_axis_len % mesh.shape['node'] == 0:
            node = 'node'
    space_axes = [None] * ndim_space
    if shard_space and ndim_space > 0:
        space_axes[0] = 'space'
    return NamedSharding(mesh, PartitionSpec('time', node, *space_axes))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
