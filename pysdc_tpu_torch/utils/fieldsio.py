"""Binary field IO for checkpoint/restart and postprocessing.

The port's copy of ``pysdc_tpu/utils/fieldsio.py`` (reference
``helpers/fieldsIO.py``: FieldsIO / Scalar / Rectilinear): a self-describing
binary format with a header followed by appended ``(time, field)`` records,
registered per structure ID.  The bytes are those the JAX package writes, so a
file written by either package reads back in the other.  Restart =
``FieldsIO.fromFile(name).readField(idx)`` (reference GPU project
configs/base_config.py:168-192).  A torch tensor on any device is written
from its host copy; a field sharded over a mesh
(:class:`~pysdc_tpu_torch.parallel.mesh.ShardedTensor`) is written shard by
shard into its slab of the record, as the JAX package writes a
device-sharded ``jax.Array``.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

H_BASE_FMT = '<2sQi'  # structure ID, dtype code, header size placeholder


class FieldsIO:
    """Base file handler.  Layout:
    [magic sID (2 bytes)] [dtype str (8 bytes)] [header] [(t, field)...]."""

    sID: bytes = b'00'
    _registry: dict[bytes, type] = {}

    def __init__(self, dtype, file_name):
        self.dtype = np.dtype(dtype)
        self.file_name = str(file_name)
        self.initialized = False
        self.header = {}

    # -- registration ---------------------------------------------------
    @classmethod
    def register(cls, sID: bytes):
        def wrapper(registered):
            registered.sID = sID
            cls._registry[sID] = registered
            return registered

        return wrapper

    @classmethod
    def fromFile(cls, file_name):
        with open(file_name, 'rb') as f:
            sid = f.read(2)
            dtype = np.dtype(f.read(8).decode().strip())
            sub = cls._registry[sid]
            obj = sub(dtype, file_name)
            obj.readHeader(f)
            obj.initialized = True
            obj._header_size = f.tell()
        return obj

    # -- header protocol (overridden by subclasses) ---------------------
    def setHeader(self, **params):
        raise NotImplementedError

    def writeHeader(self, f):
        raise NotImplementedError

    def readHeader(self, f):
        raise NotImplementedError

    @property
    def nDoF(self):
        raise NotImplementedError

    # -- IO -------------------------------------------------------------
    def initialize(self):
        if not self.header:
            raise RuntimeError('setHeader must be called before initialize')
        with open(self.file_name, 'wb') as f:
            f.write(self.sID)
            f.write(f'{self.dtype.str.lstrip("<>|")!s:<8}'.encode()[:8])
            self.writeHeader(f)
            self._header_size = f.tell()
        self.initialized = True

    @property
    def itemSize(self):
        return self.dtype.itemsize

    @property
    def fSize(self):
        """Bytes per (time, field) record."""
        return 8 + self.nDoF * self.itemSize

    @property
    def nFields(self):
        size = os.path.getsize(self.file_name) - self._header_size
        return size // self.fSize

    def addField(self, time, field):
        """Append one (time, field) record (a numpy array or a torch tensor on
        any device, written from its host copy).

        A field sharded over a mesh
        (:class:`~pysdc_tpu_torch.parallel.mesh.ShardedTensor`) is written
        without ever being whole on the host: the record's slab is reserved,
        then each distinct shard (``replica_id`` 0) is written once into its
        index of a memmap of the record, the counterpart of the reference's
        MPI-IO collective writes (fieldsIO.py:505-560).  A replicated one is
        written once, from one of its copies.  Scope: one process owning the
        file, as in the JAX package."""
        if not self.initialized:
            raise RuntimeError('FieldsIO not initialized')
        from pysdc_tpu_torch.parallel.mesh import ShardedTensor

        if isinstance(field, ShardedTensor):
            if int(np.prod(field.shape)) != self.nDoF:
                raise ValueError(f'expected {self.nDoF} DoF, got {int(np.prod(field.shape))}')
            if field.is_fully_replicated:
                field = field.addressable_shards[0].data
            else:
                self._add_sharded(time, field)
                return
        if isinstance(field, torch.Tensor):
            field = field.detach().cpu().numpy()
        arr = np.ascontiguousarray(np.asarray(field, dtype=self.dtype))
        if arr.size != self.nDoF:
            raise ValueError(f'expected {self.nDoF} DoF, got {arr.size}')
        with open(self.file_name, 'ab') as f:
            f.write(struct.pack('<d', float(time)))
            f.write(arr.tobytes())

    def _add_sharded(self, time, field):
        with open(self.file_name, 'ab') as f:
            offset0 = f.tell()
            f.write(struct.pack('<d', float(time)))
            f.truncate(offset0 + self.fSize)  # reserve the record's slab space
        mm = np.memmap(self.file_name, dtype=self.dtype, mode='r+', offset=offset0 + 8, shape=field.shape)
        for sh in field.addressable_shards:
            if sh.replica_id == 0:  # each slab written exactly once
                mm[sh.index] = sh.data.detach().cpu().numpy().astype(self.dtype, copy=False)
        mm.flush()
        del mm

    def formatIndex(self, idx):
        n = self.nFields
        if idx < 0:
            idx += n
        if not 0 <= idx < n:
            raise IndexError(f'index {idx} out of range [0, {n})')
        return idx

    @property
    def times(self):
        out = []
        with open(self.file_name, 'rb') as f:
            for i in range(self.nFields):
                f.seek(self._header_size + i * self.fSize)
                out.append(struct.unpack('<d', f.read(8))[0])
        return np.asarray(out)

    def time(self, idx):
        idx = self.formatIndex(idx)
        with open(self.file_name, 'rb') as f:
            f.seek(self._header_size + idx * self.fSize)
            return struct.unpack('<d', f.read(8))[0]

    def readField(self, idx):
        idx = self.formatIndex(idx)
        with open(self.file_name, 'rb') as f:
            f.seek(self._header_size + idx * self.fSize)
            t = struct.unpack('<d', f.read(8))[0]
            data = np.frombuffer(f.read(self.nDoF * self.itemSize), dtype=self.dtype)
        return t, self.reshape(data)

    def reshape(self, field):
        return field


@FieldsIO.register(b'S0')
class Scalar(FieldsIO):
    """0-D (vector-of-unknowns) fields: header is just nVar."""

    def setHeader(self, nVar):
        self.header = {'nVar': int(nVar)}

    def writeHeader(self, f):
        f.write(struct.pack('<q', self.header['nVar']))

    def readHeader(self, f):
        (nVar,) = struct.unpack('<q', f.read(8))
        self.header = {'nVar': nVar}

    @property
    def nVar(self):
        return self.header['nVar']

    @property
    def nDoF(self):
        return self.nVar


@FieldsIO.register(b'R0')
class Rectilinear(Scalar):
    """Fields on an N-D rectilinear grid: header stores nVar + coordinates."""

    def setHeader(self, nVar, coords):
        coords = [np.asarray(c, dtype=np.float64) for c in (coords if isinstance(coords, (list, tuple)) else [coords])]
        self.header = {'nVar': int(nVar), 'coords': coords}

    def writeHeader(self, f):
        f.write(struct.pack('<q', self.header['nVar']))
        coords = self.header['coords']
        f.write(struct.pack('<q', len(coords)))
        for c in coords:
            f.write(struct.pack('<q', c.size))
            f.write(c.tobytes())

    def readHeader(self, f):
        (nVar,) = struct.unpack('<q', f.read(8))
        (dim,) = struct.unpack('<q', f.read(8))
        coords = []
        for _ in range(dim):
            (n,) = struct.unpack('<q', f.read(8))
            coords.append(np.frombuffer(f.read(8 * n), dtype=np.float64))
        self.header = {'nVar': nVar, 'coords': coords}

    @property
    def coords(self):
        return self.header['coords']

    @property
    def gridSizes(self):
        return [c.size for c in self.coords]

    @property
    def nDoF(self):
        return self.header['nVar'] * int(np.prod(self.gridSizes))

    def reshape(self, field):
        return field.reshape([self.header['nVar']] + self.gridSizes)

    def toVTR(self, base_name, idx=None):
        """Minimal VTK rectilinear-grid (.vtr XML, ascii) export for ParaView
        (reference fieldsIO.py:466 writes .vtr via vtkIO)."""
        indices = range(self.nFields) if idx is None else [idx]
        if len(self.coords) not in (2, 3):
            raise NotImplementedError('toVTR supports 2D/3D fields')
        for i in indices:
            t, field = self.readField(i)
            coords = list(self.coords) + [np.zeros(1)] * (3 - len(self.coords))
            nx, ny, nz = [c.size for c in coords]
            path = f'{base_name}_{i:06d}.vtr'
            with open(path, 'w') as f:
                f.write('<?xml version="1.0"?>\n<VTKFile type="RectilinearGrid" version="0.1">\n')
                f.write(f'<RectilinearGrid WholeExtent="0 {nx-1} 0 {ny-1} 0 {nz-1}">\n')
                f.write(f'<Piece Extent="0 {nx-1} 0 {ny-1} 0 {nz-1}">\n<Coordinates>\n')
                for c in coords:
                    vals = ' '.join(map(str, c.tolist()))
                    f.write(f'<DataArray type="Float64" format="ascii">{vals}</DataArray>\n')
                f.write('</Coordinates>\n<PointData>\n')
                for v in range(self.header['nVar']):
                    vals = ' '.join(map(str, np.asarray(field[v]).ravel(order='F').tolist()))
                    f.write(f'<DataArray type="Float64" Name="var{v}" format="ascii">{vals}</DataArray>\n')
                f.write('</PointData>\n</Piece>\n</RectilinearGrid>\n</VTKFile>\n')


class LogToFile:
    """Hook factory writing solutions into a FieldsIO file at a fixed time
    increment, with ``load(idx)``-style restart (reference log_solution.py:200+)."""

    def __init__(self, path, problem, time_increment=0.0, file_name='solution'):
        from pysdc_tpu_torch.core.hooks import Hooks

        os.makedirs(path, exist_ok=True)
        self.file_name = os.path.join(path, f'{file_name}.pysdc')
        shape = problem.shape
        nvar = shape[0] if len(shape) > 1 else 1
        grid_shape = shape[1:] if len(shape) > 1 else shape
        self.io = Rectilinear(np.dtype(str(problem.dtype).removeprefix('torch.')), self.file_name)
        self.io.setHeader(nVar=nvar, coords=[np.arange(n, dtype=float) for n in grid_shape])
        self.io.initialize()
        self.time_increment = time_increment
        self._t_next = -np.inf
        io = self

        class _Hook(Hooks):
            def post_step(self, step, level_number):
                super().post_step(step, level_number)
                L = step.levels[level_number]
                t = float(L.time) + float(L.dt)
                if t >= io._t_next:
                    L.compute_end_point()
                    io.io.addField(t, L.uend)
                    io._t_next = t + io.time_increment

        self.hook_class = _Hook

    def load(self, idx):
        io = FieldsIO.fromFile(self.file_name)
        return io.readField(idx)
