"""One run of one cell: set-up, a closed loop of output intervals for a fixed time, the check of what it made.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration (``configs/<name>.json``, whose ``family``
names the system builder ``systems/<family>.py`` and the plain reference ``reference/<family>.py``) and a traffic
mix (``traffic/<name>.json``); its own file ``workloads/<cell>.json`` holds the limits of its check.  A run:

1. **Set-up**: builds the controller, makes the first interval's state from the seed and marches two intervals
   (the kernels are built or loaded from the program's build directory and the block's graph is captured).
   ``setup_s`` runs from the process's start to the first timed interval.
2. **Window**: output intervals back to back for ``seconds``.  An interval is one
   ``ShardedController.run(u0, 0, Tend, lane='fused')`` over ``blocks_per_interval`` blocks, its fetch, and the
   state copied to the host, as an output write needs (into one page-locked buffer, made in the set-up).
   ``steps_per_s`` is every step of the window over the whole window; ``interval_ms_p95`` the 95th percentile of
   every interval's time on the host clock.
3. **Traced run** (``trace``): the intervals of the window carry CUDA events; then two profiled sets of a few
   intervals (the idle share and the breakdown), and each per-layer metric's reader (``metrics/<name>.py``).
4. **Check**: with the program's state freed, the plain reference computes the sampled intervals again from
   the same inputs, taking its own iteration decisions (the program's only on a tie, a residual within
   ``TIE_BAND`` of ``restol``), and judges the program's outputs by the largest gap of a field (``field_gap``,
   relative to the reference's largest value, by component) and by the count of the program's step decisions
   that differ from its own and are no tie (``decisions_off``).
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from benchmark import generator, yardstick

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'pysdc_tpu')
#: the share of ``restol`` within which the program's residual and the reference's may lie on two sides of it (a
#: tie, decided by rounding): five times the widest tie over 12 seeds of the 512^2 heat cell on the card, 0.019
TIE_BAND = 0.1
#: kernels whose launches the program counts on the card when asked (``device_count``): profiler name -> wrapper
COUNTED = {'cross_stencil': ('pysdc_tpu_torch.ops.kernels.stencil', 'cross_stencil_2d'),
           'lu_panel_kernel': ('pysdc_tpu_torch.ops.kernels.dense_lu', 'lu_panel')}


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the run may not hold, compared whole."""
    return sorted({name.split('.')[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_cell(name: str, overrides: dict | None = None) -> SimpleNamespace:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, traffic and limits (``overrides`` replace
    keys of the configuration: the tests' tiny sizes)."""
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise SystemExit(f'unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}')
    cell = cells[name]
    config_entry = {c['name']: c for c in bench['configs']}[cell['config']]
    config = json.loads((ROOT / config_entry['file']).read_text())
    config.update(overrides or {})
    here = ROOT / 'benchmark'
    traffic = json.loads((here / 'traffic' / f'{cell["traffic"]}.json').read_text())
    check = json.loads((here / 'workloads' / f'{name}.json').read_text())
    return SimpleNamespace(name=name, bench=bench, cell=cell, config=config, traffic=traffic,
                           limits=check['limits'])


def metric_names(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports."""
    e2e = {m['name']: m for m in bench['end_to_end']}
    out = []
    for m in bench[kind]:
        if 'workloads' in m:
            if cell in m['workloads']:
                out.append(m)
        elif kind == 'end_to_end' or 'workloads' not in e2e[m['moves']] or cell in e2e[m['moves']]['workloads']:
            out.append(m)
    return out


@dataclass
class Interval:
    host_s: float
    niters: list  # per block: the iteration count of each step
    span_ms: float | None = None  # CUDA events around the interval, in a traced run


@dataclass
class Sample:
    """One interval the check computes again: where it started and what the program made."""
    index: int
    start: tuple  # ('seeded', index) or ('state', host tensor)
    output: object  # host tensor
    niters: list


@dataclass
class Window:
    intervals: list = field(default_factory=list)
    samples: list = field(default_factory=list)
    failed: int = 0
    attempted: int = 0
    seconds: float = 0.0


def _niters(stats, P: int) -> list:
    from pysdc_tpu_torch import get_sorted

    flat = [int(v) for _, v in get_sorted(stats, type='niter', sortby='time')]
    return [flat[b:b + P] for b in range(0, len(flat), P)]


class Run:
    """The program's side of a run, from its set-up to its last interval."""

    def __init__(self, spec, seed: int, device, trace: bool = False, wrap=None):
        import torch

        self.torch = torch
        self.spec, self.seed, self.device, self.trace = spec, int(seed), torch.device(device), trace
        cfg, traffic = spec.config, spec.traffic
        self.dtype = getattr(torch, cfg['dtype'])
        self.P = cfg['num_procs']
        self.blocks = traffic['blocks_per_interval']
        self.steps = self.blocks * self.P
        self.Tend = self.steps * cfg['dt']
        self.counters = {}
        if trace and self.device.type == 'cuda':
            for name, (module, attr) in COUNTED.items():  # armed before the capture, so the graph counts too
                wrapper = getattr(importlib.import_module(module), attr)
                wrapper.device_count = self.counters[name] = torch.zeros((), dtype=torch.int64, device=self.device)
        system = importlib.import_module(f'benchmark.systems.{cfg["family"]}')
        self.ctrl = system.build(cfg, self.device)
        self.march = wrap(self.ctrl) if wrap else (lambda u: self.ctrl.run(u, 0.0, self.Tend, lane='fused'))
        self.state = None  # the device state an interval of an episode continues from
        self.prev_out = None  # its copy on the host, from which the check starts that interval again
        self.out_buf = None  # the host buffer each interval writes its output into, made in the warm-up

    def seeded(self, index: int):
        return generator.initial_state(self.spec.config, self.spec.traffic, self.seed, index, self.device,
                                       self.dtype)

    def start_of(self, i: int):
        """(the device state interval ``i`` starts from, how the check makes it again)."""
        if self.spec.traffic['initial'] == 'ensemble':
            return self.seeded(i), ('seeded', i)
        episode, first = generator.episode_of(self.spec.traffic, i)
        if first or self.state is None:
            return self.seeded(episode), ('seeded', episode)
        return self.state, ('state', self.prev_out)

    def interval(self, u0, events: bool = False):
        """One output interval: ``(host seconds, output on the host, iteration counts, CUDA-event ms)``."""
        torch = self.torch
        start = end = None
        if events:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        if start is not None:
            start.record()
        with torch.profiler.record_function('bench.run'):
            uend, stats = self.march(u0)
        with torch.profiler.record_function('bench.output'):
            if self.out_buf is None:
                self.out_buf = torch.empty(uend.shape, dtype=uend.dtype, pin_memory=self.device.type == 'cuda')
            out = self.out_buf.copy_(uend)
        if end is not None:
            end.record()
        host = time.perf_counter() - t0
        span = None
        if end is not None:
            end.synchronize()
            span = start.elapsed_time(end)
        self.state = uend
        if self.spec.traffic['initial'] != 'ensemble':
            self.prev_out = out.clone()
        return host, out, _niters(stats, self.P), span

    def warm(self):
        """Two intervals: the first builds or loads the kernels and captures the graph, the second replays it
        (for a march that continues, from the first one's state)."""
        for i in (0, 1):
            u0, _ = self.start_of(i)
            self.interval(u0)
        self.state = self.prev_out = None

    def window(self, seconds: float, check_intervals: int) -> Window:
        """Intervals back to back until ``seconds`` have passed; a seeded reservoir of intervals to check, with
        the first interval always in it."""
        rng = np.random.default_rng([self.seed % 2**64, 7])
        win = Window()
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            u0, start = self.start_of(i)
            win.attempted += 1
            try:
                host, out, niters, span = self.interval(u0, events=self.trace)
            except Exception as err:  # an interval that never ends well: counted, and the march starts again
                log(f'interval {i}: {type(err).__name__}: {err}')
                win.failed += 1
                self.state = self.prev_out = None
                i += 1
                continue
            win.intervals.append(Interval(host, niters, span))
            kept = [s for s in win.samples if s.index != 0]
            if i == 0:
                win.samples.insert(0, Sample(i, start, out.clone(), niters))
            elif len(kept) < check_intervals - 1:
                win.samples.append(Sample(i, start, out.clone(), niters))
            else:
                j = int(rng.integers(0, i))  # reservoir over the intervals after the first
                if j < check_intervals - 1:
                    win.samples[win.samples.index(kept[j])] = Sample(i, start, out.clone(), niters)
            i += 1
        win.seconds = time.perf_counter() - t0
        return win

    def close(self):
        for module, attr in COUNTED.values():
            if self.counters:
                setattr(getattr(importlib.import_module(module), attr), 'device_count', None)
        del self.ctrl, self.march, self.state, self.prev_out, self.out_buf
        gc.collect()
        if self.device.type == 'cuda':
            self.torch.cuda.empty_cache()


# -- the traced run -------------------------------------------------------------------------------------------
def _profile(run: Run, n: int):
    """``n`` intervals under ``torch.profiler``: a summary of the device's work and the host's, with CUDA events
    around each interval.  The trace is written under the run's temporary directory and deleted."""
    torch = run.torch
    from torch.profiler import ProfilerActivity, profile

    before = {k: int(c.item()) for k, c in run.counters.items()}
    spans_ms = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()  # the traced window: the intervals, not the profiler's start and its processing
        for i in range(n):
            u0, _ = run.start_of(i)
            _, _, _, span = run.interval(u0, events=True)
            spans_ms.append(span)
        wall = time.perf_counter() - t0
    counted = {k: int(c.item()) - before[k] for k, c in run.counters.items()}
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    finally:
        os.unlink(path)
    device = [e for e in events if e.get('ph') == 'X' and e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')]
    host = [e for e in events if e.get('ph') == 'X' and e.get('cat') in ('cpu_op', 'user_annotation',
                                                                        'cuda_runtime', 'cuda_driver')]
    spans = sorted((float(e['ts']), float(e['ts']) + float(e['dur'])) for e in device)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) / 1e6
    by_name = {}
    for e in device:
        by_name[e['name']] = by_name.get(e['name'], 0.0) + float(e['dur']) / 1e6
    gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps.sort(reverse=True)

    def doing(t):
        inside = [e for e in host if float(e['ts']) <= t <= float(e['ts']) + float(e['dur'])]
        return min(inside, key=lambda e: float(e['dur']))['name'] if inside else 'host idle'

    idle = [[doing(0.5 * (a + b)), g / 1e6] for g, a, b in gaps[:10]]
    kernels = {name: sum(1 for e in device if e.get('cat') == 'kernel' and name in e['name']) for name in COUNTED}
    return SimpleNamespace(busy_s=busy, wall_s=wall, span_ms=spans_ms, n_device=len(device),
                           top=sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:10],
                           idle=idle, counted=counted, seen=kernels)


def traced(run: Run, win: Window, spec) -> tuple[dict, dict, dict]:
    """The per-layer metrics, the ``device`` entries of a traced run and its breakdown."""
    typical = sorted(iv.host_s for iv in win.intervals)[len(win.intervals) // 2]
    prof = _profile(run, int(min(10, max(3, round(1.0 / typical)))))
    # the program's own launch counts beside the profiler's: the profiler sees a graph's conditional WHILE body
    # once, whatever the trips it runs
    log(f'profiler: {len(prof.span_ms)} intervals, {prof.n_device} device operations, busy {prof.busy_s:.6f} s '
        f'of {sum(prof.span_ms) / 1e3:.6f} s of CUDA-event spans; launches counted on the card {prof.counted}, '
        f'seen by the profiler {prof.seen}')
    ctx = SimpleNamespace(spec=spec, run=run, window=win, profile=prof, torch=run.torch, yardstick=yardstick)
    values = {}
    for m in metric_names(spec.bench, spec.name, 'per_layer'):
        reader = importlib.import_module(f'benchmark.metrics.{m["name"]}')
        value = reader.read(ctx)
        if value is not None:
            values[m['name']] = {'value': float(value), 'unit': m['unit']}
    device = {'busy_s': prof.busy_s, 'window_s': prof.wall_s}
    breakdown = {'device_ops': prof.top, 'idle_gaps': prof.idle}
    return values, device, breakdown


# -- the check --------------------------------------------------------------------------------------------------
def field_gap(program, reference, component_axis) -> float:
    """The largest gap between the two fields, relative to the reference's largest value, by component."""
    diff = (program.to(reference.dtype) - reference).abs()
    if component_axis is None:
        return float(diff.max() / reference.abs().max())
    d, r = diff.movedim(component_axis, 0), reference.abs().movedim(component_axis, 0)
    return max(float(d[c].max() / r[c].max()) for c in range(d.shape[0]))


def judge(spec, samples, seed: int, device, control: bool = False, fault: str | None = None) -> dict:
    """The reference's readings over ``samples``, the largest over them: ``{'field_gap': x, 'decisions_off':
    n}``, and beside them ``ties``, the widest tie on which the reference took the judged run's decision.  With
    ``control`` (or ``fault``, a key of the family's ``FAULTS``) the outputs judged are the control's (the
    reference one precision below, or with that one thing wrong, deciding its own iterations), made from the same
    inputs in the program's place."""
    import torch

    family = importlib.import_module(f'benchmark.reference.{spec.config["family"]}')
    ref = family.Reference(spec.config, device)
    stand_in = family.Reference(spec.config, device, control=control, fault=fault) if control or fault else None
    dtype = getattr(torch, spec.config['dtype'])
    gaps, ties, off = [], 0.0, 0
    for s in samples:
        if s.start[0] == 'seeded':
            u0 = generator.initial_state(spec.config, spec.traffic, seed, s.start[1], device, dtype)
        else:
            u0 = s.start[1].to(device)
        output, niters = s.output.to(device), s.niters
        if stand_in is not None:
            output, _, niters, _ = stand_in.march(u0, [None] * len(niters))
        u_ref, t, _, o = ref.march(u0, niters, TIE_BAND)
        gaps.append(field_gap(output, u_ref, family.COMPONENT_AXIS))
        ties, off = max(ties, t), off + o
    gap = float('nan') if any(not math.isfinite(g) for g in gaps) else max(gaps, default=float('nan'))
    return {'field_gap': gap, 'decisions_off': off, 'ties': ties}


def compared(readings: dict, limits: dict) -> dict:
    return {k: {'value': (readings[k] if math.isfinite(readings[k]) else None), 'limit': v} for k, v in limits.items()}


def within(cmp: dict) -> bool:
    return all(c['value'] is not None and c['value'] <= c['limit'] for c in cmp.values())


# -- one run ----------------------------------------------------------------------------------------------------
def run_cell(name: str, seed: int, seconds: float, trace: bool, device='cuda', t_start: float | None = None,
             overrides: dict | None = None, wrap=None) -> dict:
    """The result line of one run (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
    ``trace`` a ``breakdown``, and last the numbers ``compared`` with their limits)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_cell(name, overrides=overrides)
    t_build = time.perf_counter()
    run = Run(spec, seed, device, trace=trace, wrap=wrap)
    t_warm = time.perf_counter()
    run.warm()
    if run.device.type == 'cuda':
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    setup_s = t_end - t_start
    log(f'set-up: {setup_s:.3f} s: {t_build - t_start:.3f} s to the controller, {t_warm - t_build:.3f} s to build it, '
        f'{t_end - t_warm:.3f} s for two intervals (kernels built or loaded, the graph captured)')
    win = run.window(seconds, spec.traffic['check_intervals'])

    metrics, dev, breakdown = {}, {}, None
    if trace:
        metrics, dev, breakdown = traced(run, win, spec)
    else:
        hosts = [iv.host_s for iv in win.intervals]
        steps = run.steps * len(win.intervals)
        e2e = {
            'steps_per_s': yardstick.rate(steps, win.seconds),
            'interval_ms_p95': 1e3 * yardstick.percentile(hosts, 95) if hosts else float('nan'),
            'setup_s': setup_s,
        }
        for m in metric_names(spec.bench, name, 'end_to_end'):
            metrics[m['name']] = {'value': e2e[m['name']], 'unit': m['unit']}
    if run.device.type == 'cuda':
        device_info = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(run.device), 'count': 1,
                       'memory_peak_bytes': int(torch.cuda.max_memory_allocated(run.device))}
    else:
        device_info = {'platform': 'cpu', 'kind': 'cpu', 'count': 1, 'memory_peak_bytes': 0}
    device_info.update(dev)
    steps_done = sum(len(b) for iv in win.intervals for b in iv.niters)
    iters = [n for iv in win.intervals for b in iv.niters for n in b]
    log(f'window: {len(win.intervals)} intervals of {run.steps} steps in {win.seconds:.3f} s, {win.failed} failed, '
        f'{steps_done} steps, mean iterations a step {np.mean(iters) if iters else float("nan"):.4f}')
    run.close()
    del run

    readings = judge(spec, win.samples, seed, torch.device(device))
    log(f'check: {len(win.samples)} intervals computed again; the widest tie taken from the program '
        f'{readings["ties"]:.4f} of restol (tie band {TIE_BAND})')
    cmp = compared(readings, spec.limits)
    result = {'correct': bool(win.failed == 0 and win.intervals and within(cmp)),
              'attempted': win.attempted, 'failed': win.failed, 'metrics': metrics, 'device': device_info}
    if breakdown is not None:
        result['breakdown'] = breakdown
    result['compared'] = cmp
    for key, c in cmp.items():
        log(f'compared {key} {c["value"]} limit {c["limit"]}')
    return result
