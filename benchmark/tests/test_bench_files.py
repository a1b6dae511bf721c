"""Every file the benchmark reads parses and keeps to the contract's limits."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')


def test_bench_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs', 'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['benchmark'] and BENCH['command'][1].startswith('benchmark/')
    assert isinstance(BENCH['run_seconds'], int) and 1 <= BENCH['run_seconds'] <= 51
    total = 2 + 14 * 24
    assert total * (BENCH['run_seconds'] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize('config', BENCH['configs'], ids=lambda c: c['name'])
def test_bench_config_file(config):
    assert set(config) == {'name', 'source', 'file', 'reduced', 'why'}
    assert NAME.match(config['name']) and all(NAME.match(k) for k in config['reduced'])
    data = json.loads((ROOT / config['file']).read_text())
    assert (ROOT / 'benchmark' / 'systems' / f'{data["family"]}.py').exists()
    assert (ROOT / 'benchmark' / 'reference' / f'{data["family"]}.py').exists()
    assert data['reduced'] == config['reduced'] and data['source'] == config['source']
    for text in (config['source'], config['why']):
        assert 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


@pytest.mark.parametrize('cell', BENCH['workloads'], ids=lambda c: c['name'])
def test_bench_cell_files(cell):
    assert set(cell) == {'name', 'config', 'traffic', 'chips', 'why'}
    assert NAME.match(cell['name']) and NAME.match(cell['traffic']) and cell['chips'] == 1
    assert cell['config'] in {c['name'] for c in BENCH['configs']}
    traffic = json.loads((ROOT / 'benchmark' / 'traffic' / f'{cell["traffic"]}.json').read_text())
    assert traffic['loop'] == 'closed' and traffic['blocks_per_interval'] >= 1
    check = json.loads((ROOT / 'benchmark' / 'workloads' / f'{cell["name"]}.json').read_text())
    assert set(check) == {'limits'} and set(check['limits']) == {'field_gap', 'decisions_off'}
    assert check['limits']['decisions_off'] == 0
    assert 1 <= len(cell['why']) <= 200


def test_bench_metrics():
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    assert {'steps_per_s', 'interval_ms_p95', 'setup_s'} <= set(e2e)
    cells = {c['name'] for c in BENCH['workloads']}
    layers = {}
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert NAME.match(m['name']) and UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        assert set(m.get('workloads', cells)) <= cells
    for m in BENCH['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace') and 0 < m['bound'] <= 0.25
    for m in BENCH['per_layer']:
        assert m['moves'] in e2e and m['source'] in ('device_trace', 'program_span', 'program_counter', 'host_clock')
        assert (ROOT / 'benchmark' / 'metrics' / f'{m["name"]}.py').exists()
        layers.setdefault(m['layer'], []).append(m['name'])
    names = [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
    assert len(names) == len(set(names))
