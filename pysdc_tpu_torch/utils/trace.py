"""Spans of the fused lane on one clock: the host's work in the march entry and the card's inside each block.

Tracing is off until :func:`enable` and off again after :func:`disable`; there is no environment variable and no
constructor argument.  Off, nothing is added: a block graph captured while tracing is off holds no stamp, no library
is built or loaded for it, and a span is a test of two flags and an empty context.

**Host spans** (``time.monotonic_ns``, kept in memory): ``march`` is one ``ShardedController.run(...,
lane='fused')``, once the lane is chosen, to its return; its children are ``march.capture`` (a block graph
captured), ``march.enqueue`` (the input writes and every replay enqueued), ``march.fetch`` (the march's one fetch)
and ``march.stats`` (the statistics made on the host).  Each carries the march's sequence number.  While
``torch.profiler`` records, a host span is also a ``record_function`` range of its name, traced or not.

**Device spans**, inside a block: ``block`` (the block graph, first node to last), its phases ``block.start``
(spread and predictor), ``block.check`` (IT_CHECK), ``block.down`` and ``block.up`` (the restriction and prolongation
cascades with their intermediate sweeps), ``block.coarse`` (IT_COARSE's serial chain; inside ``block.start`` the
burn-in's or FMG's coarse wavefront) and ``block.fine`` (IT_FINE's sweeps at level 0, or a single level's
iteration), and the layers ``linalg.solve`` (``ops/linalg.py:solve``), ``stencil.apply`` (a launch of K1),
``spmv.apply`` (a sparse operator's SpMV, ``ops/sparse_op.py``: a launch of K2 on the card), ``pcg.solve`` (one
preconditioned CG solve, from its first residual to the end of its loop) and ``precond.solve`` (its preconditioner's
solve, at every trip of the PCG loop: inside the block's device ``while``, a ``while`` nested in it).  On
the card a span is a pair of one-thread kernels that read the card's global timer on the current stream
(``csrc/graph_loop.cu``), captured with the block: inside the block's device ``while`` they run at every trip.  A
*site* is a span's name under the names of the spans it lies in (``('block', 'block.start', 'block.coarse')`` is
the burn-in's wavefront, ``('block', 'block.coarse')`` IT_COARSE's chain); each has a row of a small int64 table
on the card, in which the open stamp writes the start and the close stamp adds the elapsed time to the total and 1
to the count.  The table is zeroed as a march starts to enqueue and comes home inside the march's one fetch;
each block's own start and end are kept after its replay, as the march keeps its iteration counts.  On the CPU,
where a block runs eagerly, a device span is the host clock around the same call.

**Counters**: :func:`count` adds one to a host counter; :func:`tally` counts an event of the program where it
happens: on the host, or, inside a CUDA graph being captured, on the card, in a row of a small int64 table that a
replay adds to.  That table comes home inside the march's one fetch (and at :func:`record`), and its rows are added
to the host counters of their names and set to 0.  ``spectral.slot_solves`` counts the solves that a node's kept LU
served (``ops/spectral.py``), ``spectral.refreshes`` the LU made again for them because the node's shift changed;
``pcg.solves`` counts the PCG solves of ``ops/sparse_op.py`` (one a call, which holds a block's steps as its
systems) and ``pcg.trips`` the trips of their loops (tallied inside the loop's body, so that a replay counts every
trip the card runs).  The benchmark's cell ``sparse.n1024`` reads the last two.

**One clock.** :func:`enable` calibrates the card's timer against the host's: the narrowest of several rounds of
host clock, stamp, synchronize, host clock gives the offset, and half that round's width is the stated
uncertainty.  :func:`record` calibrates again, and a stamp is placed on the host clock between the two.

:func:`record` returns the spans (host spans and each block, on the host clock) and the sites' counts and totals,
by march; :func:`report` a text summary for operators.  A phase's self time is its total less the phases nested in
it; the layers (:data:`LAYER_SPANS`) cut across the phases and keep their time inside the phase they lie in.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import itertools
import time
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

from pysdc_tpu_torch.ops.kernels.build import current_stream, load

#: spans of a layer rather than a phase of the block: a phase's self time keeps the time of these inside it
LAYER_SPANS = ('linalg.solve', 'stencil.apply', 'spmv.apply', 'pcg.solve', 'precond.solve')
#: rows of the card's table: one a site
TABLE_ROWS = 64
#: rounds of a calibration of the card's timer against the host's
CALIBRATION_ROUNDS = 24

_NULL = contextlib.nullcontext()
_tracer = None  # the _Tracer while tracing is on
_tokens = itertools.count(1)


def _profiling() -> bool:
    return getattr(_autograd_profiler, '_is_profiler_enabled', False)


@dataclass(frozen=True)
class Span:
    """One span on the host clock (``time.monotonic_ns``): a host span (``where='host'``) or a block (``'card'``
    or ``'cpu'``, with its ``index`` in the march and ``enqueued_ns``, when the host began to enqueue its replay)."""
    name: str
    start_ns: int
    end_ns: int
    march: int | None
    parent: str | None
    where: str
    index: int | None = None
    enqueued_ns: int | None = None

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


@dataclass(frozen=True)
class Site:
    """The count and total time of one device span site over one march."""
    path: tuple
    march: int
    count: int
    total_ns: int

    @property
    def name(self) -> str:
        return self.path[-1]


@dataclass(frozen=True)
class Record:
    spans: list
    sites: list
    counters: dict
    clock: SimpleNamespace | None  # offset_ns, uncertainty_ns, resolution_ns (smallest, largest step), drift_ppm

    def marches(self) -> list:
        return sorted({s.march for s in self.spans if s.name == 'march'})


@functools.lru_cache(maxsize=None)
def _library():
    """The stamp kernels of the graph-loop library, loaded (built at first use)."""
    lib = load('graph_loop')
    for fn, args in ((lib.trace_load, []), (lib.trace_open, [ctypes.c_void_p, ctypes.c_void_p]),
                     (lib.trace_close, [ctypes.c_void_p, ctypes.c_void_p]),
                     (lib.trace_resolution, [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])):
        fn.argtypes, fn.restype = args, ctypes.c_int
    _check(lib.trace_load(), 'trace_load')
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f'trace: {what} failed with CUDA error {err}')


class _March:
    """What one march traced: its sequence number, and the device spans' sums and blocks until it closes."""

    def __init__(self, seq: int):
        self.seq = seq
        self.enqueued = []  # per block: host ns when its replay's enqueue began
        self.blocks = []  # per block: (start, end) on the card (a device tensor until the fetch) or the CPU's clock
        self.table = None  # the card's table, fetched
        self.cpu_sites = {}  # on the CPU: site path -> [count, total ns]
        self.last_block = None


class _Tracer:
    def __init__(self, device: torch.device):
        self.device = device
        self.token = next(_tokens)
        self.on_card = device.type == 'cuda'
        self.rows = {}  # site path -> row of the card's table
        self.stack = []  # names of the device spans open, outermost first
        self.host_stack = []
        self.host_spans = []
        self.marches = []
        self.counters = {'fused.captures': 0}
        self.tallies = {}  # name -> row of the card's tally table
        self.seq = 0
        self.march = None
        if self.on_card:
            self.index = device.index if device.index is not None else torch.cuda.current_device()
            self.lib = _library()
            self.table = torch.zeros((TABLE_ROWS, 4), dtype=torch.int64, device=device)
            self.tally_table = torch.zeros((TABLE_ROWS,), dtype=torch.int64, device=device)
            self.points = [self._calibrate()]
            res = torch.zeros((3,), dtype=torch.int64, device=device)
            _check(self.lib.trace_resolution(res.data_ptr(), 64, current_stream(self.index)), 'trace_resolution')
            self.resolution = tuple(int(v) for v in res.cpu())

    # -- the clock ------------------------------------------------------------------------------------------
    def _calibrate(self) -> tuple:
        """``(host ns, card ns, half-width ns)`` of the narrowest round."""
        slots = torch.zeros((CALIBRATION_ROUNDS, 4), dtype=torch.int64, device=self.device)
        stream = current_stream(self.index)
        torch.cuda.synchronize(self.device)
        bounds = []
        for r in range(CALIBRATION_ROUNDS):
            t0 = time.monotonic_ns()
            _check(self.lib.trace_open(slots[r].data_ptr(), stream), 'trace_open')
            torch.cuda.synchronize(self.device)
            bounds.append((t0, time.monotonic_ns()))
        stamps = slots[:, 0].cpu().tolist()
        r = min(range(CALIBRATION_ROUNDS), key=lambda i: bounds[i][1] - bounds[i][0])
        t0, t1 = bounds[r]
        return (t0 + t1) // 2, int(stamps[r]), (t1 - t0 + 1) // 2

    def _to_host(self, card_ns: int) -> int:
        (h0, d0, _), (h1, d1, _) = self.points[0], self.points[-1]
        rate = (h1 - h0) / (d1 - d0) if d1 != d0 else 1.0
        return h0 + int(round((card_ns - d0) * rate))

    # -- spans ----------------------------------------------------------------------------------------------
    @contextlib.contextmanager
    def host(self, name: str):
        with _autograd_profiler.record_function(name) if _profiling() else _NULL:
            parent = self.host_stack[-1] if self.host_stack else None
            self.host_stack.append(name)
            t0 = time.monotonic_ns()
            try:
                yield
            finally:
                t1 = time.monotonic_ns()
                self.host_stack.pop()
                seq = self.march.seq if self.march is not None else None
                self.host_spans.append(Span(name, t0, t1, seq, parent, 'host'))

    def _row(self, path: tuple) -> int:
        row = self.rows.get(path)
        if row is None:
            if len(self.rows) >= TABLE_ROWS:
                raise RuntimeError(f'trace: more than {TABLE_ROWS} span sites (TABLE_ROWS); the next is {path}')
            row = self.rows[path] = len(self.rows)
        return row

    @contextlib.contextmanager
    def device_span(self, name: str):
        path = tuple(self.stack) + (name,)
        if self.on_card:
            ptr = self.table[self._row(path)].data_ptr()
            stream = current_stream(self.index)
            _check(self.lib.trace_open(ptr, stream), 'trace_open')
            self.stack.append(name)
            try:
                yield
            finally:
                self.stack.pop()
            _check(self.lib.trace_close(ptr, current_stream(self.index)), 'trace_close')
            return
        self.stack.append(name)
        t0 = time.monotonic_ns()
        try:
            yield
        finally:
            self.stack.pop()
        t1 = time.monotonic_ns()
        m = self.march
        if m is not None:
            acc = m.cpu_sites.setdefault(path, [0, 0])
            acc[0] += 1
            acc[1] += t1 - t0
            if path == ('block',):
                m.last_block = (t0, t1)

    @contextlib.contextmanager
    def open_march(self):
        self.seq += 1
        self.march = _March(self.seq)
        try:
            with self.host('march'):
                yield
        finally:
            self.marches.append(self.march)
            self.march = None

    @contextlib.contextmanager
    def enqueue(self):
        if self.on_card:
            self.table.zero_()
        with self.host('march.enqueue'):
            yield

    @contextlib.contextmanager
    def replay(self):
        t0 = time.monotonic_ns()
        yield
        m = self.march
        if m is None:
            return
        if self.on_card:
            row = self.rows.get(('block',))
            if row is not None:
                m.enqueued.append(t0)
                m.blocks.append(self.table[row, 0::3].clone())
        elif m.last_block is not None:
            m.enqueued.append(t0)
            m.blocks.append(m.last_block)
            m.last_block = None

    def tally(self, name: str, like: torch.Tensor) -> None:
        if not (self.on_card and like.is_cuda and torch.cuda.is_current_stream_capturing()):
            self.counters[name] = self.counters.get(name, 0) + 1
            return
        row = self.tallies.get(name)
        if row is None:
            if len(self.tallies) >= TABLE_ROWS:
                raise RuntimeError(f'trace: more than {TABLE_ROWS} tallies (TABLE_ROWS); the next is {name}')
            row = self.tallies[name] = len(self.tallies)
        self.tally_table[row].add_(1)

    def _add_tallies(self, counts) -> None:
        """The tally table's rows as fetched added to the host counters; the table on the card set to 0."""
        for name, row in self.tallies.items():
            self.counters[name] = self.counters.get(name, 0) + int(counts[row])
        self.tally_table.zero_()

    def fetch_parts(self) -> list:
        m = self.march
        if not self.on_card or m is None:
            return []
        return [self.table, self.tally_table] + ([torch.stack(m.blocks)] if m.blocks else [])

    def fetched(self, arrays) -> None:
        m = self.march
        if not arrays or m is None:
            return
        m.table = np.array(arrays[0])
        self._add_tallies(arrays[1])
        m.blocks = [tuple(int(v) for v in b) for b in arrays[2]] if len(arrays) > 2 else []

    # -- what was traced ------------------------------------------------------------------------------------
    def record(self) -> Record:
        clock = SimpleNamespace(offset_ns=0, uncertainty_ns=0, resolution_ns=None, drift_ppm=0.0,
                                device=str(self.device))
        if self.on_card:
            if self.tallies:
                self._add_tallies(self.tally_table.cpu())
            self.points = [self.points[0], self._calibrate()]
            (h0, d0, w0), (h1, d1, w1) = self.points
            clock = SimpleNamespace(offset_ns=d0 - h0, uncertainty_ns=max(w0, w1), resolution_ns=self.resolution[:2],
                                    drift_ppm=((d1 - d0) - (h1 - h0)) / max(h1 - h0, 1) * 1e6,
                                    device=torch.cuda.get_device_name(self.device))
        spans, sites = list(self.host_spans), []
        for m in self.marches:
            if self.on_card:
                if m.table is None:
                    continue
                for path, row in self.rows.items():
                    count = int(m.table[row, 2])
                    if count:
                        sites.append(Site(path, m.seq, count, int(m.table[row, 1])))
                blocks = [(self._to_host(a), self._to_host(b)) for a, b in m.blocks]
            else:
                sites += [Site(path, m.seq, c, t) for path, (c, t) in m.cpu_sites.items()]
                blocks = m.blocks
            where = 'card' if self.on_card else 'cpu'
            spans += [Span('block', a, b, m.seq, 'march', where, i, e)
                      for i, ((a, b), e) in enumerate(zip(blocks, m.enqueued))]
        return Record(spans, sites, dict(self.counters), clock)


# -- the switch ---------------------------------------------------------------------------------------------
def enable(device) -> None:
    """Trace the fused lane on ``device`` from now on (a fresh record).  On the card this loads the stamp kernels
    and calibrates the card's timer against the host's; a controller's block graph is captured again, with its
    stamps, at its next run."""
    global _tracer
    _tracer = _Tracer(torch.device(device))


def disable() -> None:
    """Stop tracing and drop what was recorded; a controller's next run replays its untraced graph again."""
    global _tracer
    _tracer = None


def enabled() -> bool:
    return _tracer is not None


def key():
    """The tracing state a captured program depends on: ``None`` when off, else the token of this :func:`enable`."""
    return None if _tracer is None else _tracer.token


def record() -> Record:
    """The spans and sites traced since :func:`enable` (empty when tracing is off)."""
    if _tracer is None:
        return Record([], [], {}, None)
    return _tracer.record()


# -- the spans the program opens ----------------------------------------------------------------------------
def span(name: str):
    """A host span ``name`` (a ``record_function`` range too, while ``torch.profiler`` records)."""
    if _tracer is not None:
        return _tracer.host(name)
    return _autograd_profiler.record_function(name) if _profiling() else _NULL


def march(on: bool = True):
    """The ``march`` span of one fused run, when ``on``."""
    if not on or (_tracer is None and not _profiling()):
        return _NULL
    return _tracer.open_march() if _tracer is not None else _autograd_profiler.record_function('march')


def enqueue():
    """The ``march.enqueue`` span; traced on the card, the table is zeroed first."""
    return _tracer.enqueue() if _tracer is not None else span('march.enqueue')


def device_span(name: str):
    """A device span ``name``: stamps on the current stream on the card, the host clock on the CPU."""
    return _NULL if _tracer is None else _tracer.device_span(name)


def replay():
    """Around one block's input writes and replay: keeps the block's start and end with its index in the march."""
    return _NULL if _tracer is None else _tracer.replay()


def fetch_parts() -> list:
    """Tensors that the march's one fetch takes home with its own: the card's table, its tallies and each block's
    stamps."""
    return [] if _tracer is None else _tracer.fetch_parts()


def fetched(arrays) -> None:
    """The host copies of :func:`fetch_parts`, in its order."""
    if _tracer is not None:
        _tracer.fetched(arrays)


def count(name: str) -> None:
    if _tracer is not None:
        _tracer.counters[name] = _tracer.counters.get(name, 0) + 1


def tally(name: str, like: torch.Tensor) -> None:
    """One event ``name`` of the program: on the host, or on ``like``'s card inside a CUDA graph being captured (each
    replay that runs it counts it; the march's fetch brings it home)."""
    if _tracer is not None:
        _tracer.tally(name, like)


# -- the operator's summary ---------------------------------------------------------------------------------
def phase_times(sites) -> dict:
    """site path -> ``[count, total ns, self ns]`` summed over ``sites``; self is the total less the phases nested
    directly in it (not the :data:`LAYER_SPANS`)."""
    out = {}
    for s in sites:
        acc = out.setdefault(s.path, [0, 0, 0])
        acc[0] += s.count
        acc[1] += s.total_ns
    for path, acc in out.items():
        acc[2] = acc[1] - sum(c[1] for p, c in out.items()
                              if len(p) == len(path) + 1 and p[:-1] == path and p[-1] not in LAYER_SPANS)
    return out


def idle_gaps(rec: Record) -> list:
    """``(ns, start, march, innermost host span over its midpoint)`` of each stretch of a ``march`` span that no
    ``block`` covers, longest first."""
    gaps = []
    for m in (s for s in rec.spans if s.name == 'march'):
        blocks = sorted((s.start_ns, s.end_ns) for s in rec.spans if s.name == 'block' and s.march == m.march)
        at = m.start_ns
        for a, b in blocks + [(m.end_ns, m.end_ns)]:
            if a > at:
                mid = (at + a) // 2
                inside = [s for s in rec.spans if s.where == 'host' and s.start_ns <= mid <= s.end_ns]
                gaps.append((a - at, at, m.march, min(inside, key=lambda s: s.ns).name if inside else 'none'))
            at = max(at, b)
    return sorted(gaps, reverse=True)


def report(rec: Record | None = None, gaps: int = 5) -> str:
    """A text summary: each site's count, total and self time and its share of ``block``, the host spans, the
    longest device gaps with the host span over each, the counters and the clock."""
    rec = record() if rec is None else rec
    lines = [f'trace: {len(rec.marches())} marches']
    if rec.clock is not None:
        c = rec.clock
        lines.append(f'clock: {c.device}, card - host {c.offset_ns} ns, uncertainty {c.uncertainty_ns} ns, timer steps '
                     f'{c.resolution_ns} ns, drift {c.drift_ppm:.3f} ppm')
    times = phase_times(rec.sites)
    block = times.get(('block',), [0, 0, 0])[1]
    lines.append(f'{"device site":<48} {"count":>8} {"total ms":>12} {"self ms":>12} {"of block":>9}')
    for path in sorted(times):
        n, total, own = times[path]
        share = f'{100 * total / block:8.2f}%' if block else ''
        lines.append(f'{"  " * (len(path) - 1) + path[-1]:<48} {n:>8} {total / 1e6:>12.4f} {own / 1e6:>12.4f} {share}')
    host = {}
    for s in rec.spans:
        if s.where == 'host':
            acc = host.setdefault(s.name, [0, 0])
            acc[0] += 1
            acc[1] += s.ns
    for name, (n, total) in sorted(host.items()):
        lines.append(f'host {name:<43} {n:>8} {total / 1e6:>12.4f} ms, mean {total / n / 1e6:.4f} ms')
    for ns, start, seq, over in idle_gaps(rec)[:gaps]:
        lines.append(f'device gap {ns / 1e6:.4f} ms in march {seq}, under {over}')
    if rec.counters:
        lines.append('counters: ' + ', '.join(f'{k} {v}' for k, v in sorted(rec.counters.items())))
    return '\n'.join(lines)
