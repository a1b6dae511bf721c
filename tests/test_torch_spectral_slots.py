"""One LU a collocation node, kept between solves (``ops/spectral.py``: ``TensorProductSpectral.solve_shifted(rhs,
factor, node=m)``), and the two halves of the dense solve it rests on (``ops/linalg.py``: ``lu_factor``,
``lu_substitute``), on the CPU in float64 / complex128.

A slot's solve must equal a fresh solve (``node=None``) bit for bit: the factors come from the same operator through
the same calls.  A slot is refreshed only where its shift changed: on the host for a host float, in a device ``while``
of at most one trip for a tensor factor inside a capture (simulated by patching ``loops.capturing``, which runs the
loop's plain version).  ``utils/trace.py``'s counters ``spectral.refreshes`` and ``spectral.slot_solves`` count
both.  The card's routes run here with the kernels' plain versions by patching ``linalg._lapack``.
"""

import numpy as np
import pytest
import torch

from pysdc_tpu_torch import IMEXSweeper, ShardedController, get_sorted
from pysdc_tpu_torch.models import rayleigh_benard as trb
from pysdc_tpu_torch.models import spectral_problems as tsp
from pysdc_tpu_torch.ops import graph_loop, linalg, loops
from pysdc_tpu_torch.utils import trace

torch.set_num_threads(1)

# three nodes' shifts dt * QI[m, m], distinct as a sweep's are
SHIFTS = (0.0015, 0.0035, 0.001)

PROBLEMS = {
    'rayleigh-benard': lambda dtype: trb.RayleighBenard(nx=16, nz=16, Rayleigh=2e6, dtype=dtype, device='cpu'),
    'heat-chebyshev': lambda dtype: tsp.HeatChebyshev1D(nvars=32, dtype=dtype, device='cpu'),
    'burgers': lambda dtype: tsp.Burgers1D(nvars=32, dtype=dtype, device='cpu'),
    'heat-2d-chebyshev': lambda dtype: tsp.Heat2DChebyshev(nx=12, nz=12, dtype=dtype, device='cpu'),
}


@pytest.fixture
def counters():
    """Tracing on (the counters live in the tracer) for the test; ``counters()`` reads them."""
    trace.enable('cpu')
    try:
        yield lambda: dict(trace.record().counters)
    finally:
        trace.disable()


def _field(prob, seed=3, lead=()):
    rng = np.random.default_rng(seed)
    u = prob.u_exact(0.0)
    noise = torch.as_tensor(rng.standard_normal(lead + tuple(u.shape)), dtype=u.dtype)
    return u + 0.01 * noise


@pytest.mark.parametrize('name, dtype', [(name, torch.float64) for name in PROBLEMS]
                         + [('rayleigh-benard', torch.float32)])
def test_slot_solves_equal_fresh_solves_bit_for_bit(counters, name, dtype):
    """The 3 nodes' solves over 3 blocks at one dt: each equals the solve without a node to the bit, each node's LU
    is made once, and every other solve only substitutes."""
    prob = PROBLEMS[name](dtype)
    spec = prob.spec
    for block in range(3):
        u = _field(prob, seed=block, lead=(2,))  # a block's steps ride along as a batch axis
        for m, shift in enumerate(SHIFTS):
            fresh = spec.solve_shifted(u, shift)
            kept = spec.solve_shifted(u, shift, node=m)
            assert kept.dtype == dtype and torch.equal(kept, fresh), (block, m)
    seen = counters()
    assert seen['spectral.refreshes'] == 3 and seen['spectral.slot_solves'] == 9
    assert sorted(key[0] for key in spec._slots) == [0, 1, 2]


def test_changed_shift_refreshes_each_node(counters):
    """After dt changes, each node's next solve makes its LU again (one refresh a node) and equals the fresh solve
    at the new shift, not the one at the stale shift; solves at the new shift after that only substitute."""
    prob = PROBLEMS['rayleigh-benard'](torch.float64)
    spec, u = prob.spec, _field(prob)
    for m, shift in enumerate(SHIFTS):
        spec.solve_shifted(u, shift, node=m)
    before = counters()
    for m, shift in enumerate(SHIFTS):
        new = 2 * shift
        kept = spec.solve_shifted(u, new, node=m)
        assert torch.equal(kept, spec.solve_shifted(u, new))
        assert not torch.equal(kept, spec.solve_shifted(u, shift))
        assert counters()['spectral.refreshes'] == before['spectral.refreshes'] + m + 1
    for m, shift in enumerate(SHIFTS):
        spec.solve_shifted(u, 2 * shift, node=m)
    after = counters()
    assert after['spectral.refreshes'] == before['spectral.refreshes'] + 3
    assert after['spectral.slot_solves'] == before['spectral.slot_solves'] + 6


def test_device_factor_refreshes_in_a_device_loop(counters, monkeypatch):
    """A 0-d tensor factor (the fused lanes' ``dt``): made eagerly at the node's first solve; inside a capture
    (simulated) the check is a device ``while`` that runs no trip while the shift holds and one where it changed, and
    each result equals the fresh solve at that factor."""
    prob = PROBLEMS['rayleigh-benard'](torch.float64)
    spec, u = prob.spec, _field(prob, lead=(2,))
    table = torch.tensor(SHIFTS, dtype=torch.float64)
    for m in range(3):
        assert torch.equal(spec.solve_shifted(u, table[m], node=m), spec.solve_shifted(u, table[m]))
    assert counters()['spectral.refreshes'] == 3
    loops_built, trips = [], []
    device_while = graph_loop.device_while

    def counting(flag_fn, body, carry):
        loops_built.append(1)
        out, n = device_while(flag_fn, body, carry)
        trips.append(n)
        return out, n

    monkeypatch.setattr(loops, 'capturing', lambda x: True)
    monkeypatch.setattr(graph_loop, 'device_while', counting)
    for m in range(3):
        assert torch.equal(spec.solve_shifted(u, table[m], node=m), spec.solve_shifted(u, table[m]))
    assert trips == [0, 0, 0] and counters()['spectral.refreshes'] == 3
    scaled = 1.5 * table
    for m in range(3):
        assert torch.equal(spec.solve_shifted(u, scaled[m], node=m), spec.solve_shifted(u, scaled[m]))
    assert trips == [0, 0, 0, 1, 1, 1] and counters()['spectral.refreshes'] == 6
    assert all(slot.known is None for slot in spec._slots.values())
    # a node with no slot yet keeps nothing inside a capture: its tensors are made outside any graph
    assert torch.equal(spec.solve_shifted(u, table[0], node=5), spec.solve_shifted(u, table[0]))
    assert len(spec._slots) == 3 and len(loops_built) == 6


def test_host_factor_after_a_device_refresh_reads_the_shift(counters, monkeypatch):
    """A host float is checked on the host against the shift last written by a host call; once a tensor factor has
    met the slot (a device loop may write it at any replay), the host reads the shift from the device before it
    trusts the factors."""
    prob = PROBLEMS['heat-chebyshev'](torch.float64)
    spec, u = prob.spec, _field(prob)
    spec.solve_shifted(u, SHIFTS[0], node=0)
    slot = spec._slots[(0, torch.complex128, torch.device('cpu'))]
    assert slot.known == SHIFTS[0]
    with monkeypatch.context() as patch:
        patch.setattr(loops, 'capturing', lambda x: True)
        spec.solve_shifted(u, torch.tensor(SHIFTS[1], dtype=torch.float64), node=0)
    assert float(slot.shift) == SHIFTS[1] and slot.known is None
    kept = spec.solve_shifted(u, SHIFTS[0], node=0)
    assert torch.equal(kept, spec.solve_shifted(u, SHIFTS[0]))
    assert counters()['spectral.refreshes'] == 3 and slot.known is None


def test_calls_without_a_node_keep_nothing(counters):
    """A solve without a node (the batched solve of a diagonal QI, a direct call), with one shift a node in one
    call, or of a field a gradient is asked of, factors afresh and keeps no slot."""
    prob = PROBLEMS['rayleigh-benard'](torch.float64)
    spec, u = prob.spec, _field(prob, lead=(3,))
    prob.solve_system_batched(u, np.asarray(SHIFTS), u, 0.0)
    spec.solve_shifted(u[0], SHIFTS[0])
    spec.solve_shifted(u, torch.tensor(SHIFTS, dtype=torch.float64).reshape(3, 1, 1, 1), node=0)
    wanted = u[0].clone().requires_grad_(True)
    x = spec.solve_shifted(wanted, SHIFTS[0], node=0)
    x.sum().backward()
    assert wanted.grad is not None and torch.equal(x.detach(), spec.solve_shifted(u[0], SHIFTS[0]))
    assert spec._slots == {} and 'spectral.slot_solves' not in counters()


@pytest.mark.parametrize('rows', [32, 96])
@pytest.mark.parametrize('shape_a, shape_b', [((3, 0, 0), (3, 0, 2)), ((2, 0, 0), (4, 2, 0, 1)), ((0, 0), (0, 1)),
                                              ((1, 0, 0), (2, 1, 0, 3))])
def test_split_route_equals_the_whole_route_bit_for_bit(monkeypatch, rows, shape_a, shape_b):
    """``lu_substitute(*lu_factor(A), B)`` on the card's routes (``_lapack`` patched, ``PIVOTED_FROM`` 64): the
    pivoted route from 64 rows, cuBLAS's batched route's torch calls below, each equal to the route as one call
    (``_pivoted_solve``, ``_batched_solve``) to the bit; ``overwrite_a`` factors a contiguous ``A`` in place with the
    same bits; broadcast batches and one matrix included."""
    monkeypatch.setattr(linalg, '_lapack', lambda x: False)
    monkeypatch.setattr(linalg, 'PIVOTED_FROM', 64)
    rng = np.random.default_rng(rows + len(shape_b))
    shape_a = tuple(rows if s == 0 else s for s in shape_a)
    shape_b = tuple(rows if s == 0 else s for s in shape_b)
    A = torch.as_tensor(rng.standard_normal(shape_a) + 1j * rng.standard_normal(shape_a))
    B = torch.as_tensor(rng.standard_normal(shape_b) + 1j * rng.standard_normal(shape_b))
    whole = (linalg._pivoted_solve if rows >= 64 else linalg._batched_solve)(A, B)
    assert torch.equal(linalg.lu_substitute(*linalg.lu_factor(A), B), whole)
    assert torch.equal(linalg.solve(A, B), whole)
    work = A.clone()
    LU, pivots = linalg.lu_factor(work, overwrite_a=True)
    assert torch.equal(linalg.lu_substitute(LU, pivots, B), whole)
    assert (LU.data_ptr() == work.data_ptr()) == (rows >= 64)
    if rows < 64:
        assert torch.equal(work, A)  # the batched route leaves A as it was
    rel = float((whole - torch.linalg.solve(A, B)).abs().max() / torch.linalg.solve(A, B).abs().max())
    assert rel < 1e-11


def test_cpu_halves_are_lapacks_solve():
    """On the CPU the halves are ``lu_factor_ex`` and ``lu_solve``: equal to ``solve_ex`` (what ``linalg.solve``
    calls there) to the bit, broadcast batches included."""
    rng = np.random.default_rng(4)
    A = torch.as_tensor(rng.standard_normal((5, 24, 24)) + 1j * rng.standard_normal((5, 24, 24)))
    B = torch.as_tensor(rng.standard_normal((3, 5, 24, 1)) + 1j * rng.standard_normal((3, 5, 24, 1)))
    assert torch.equal(linalg.lu_substitute(*linalg.lu_factor(A), B), linalg.solve(A, B))


def _fused(fresh: bool, dt=0.01):
    desc = dict(problem_class=trb.RayleighBenard,
                problem_params=dict(nx=16, nz=16, Rayleigh=2e6, dtype=torch.float64, device='cpu'),
                sweeper_class=IMEXSweeper,
                sweeper_params=dict(num_nodes=3, QI='LU', QE='PIC'),
                level_params=dict(dt=dt, restol=-1.0), step_params=dict(maxiter=3))
    ctrl = ShardedController(2, {'logger_level': 40}, desc)
    if fresh:  # a solve that names no node: the route before the slots
        for step in ctrl.MS:
            for lvl in step.levels:
                lvl.prob.accepts_node_index = False
    return ctrl


def _march(ctrl, u0, blocks=2):
    dt = float(ctrl.MS[0].levels[0].params.dt)
    uend, stats = ctrl.run(u0, 0.0, blocks * 2 * dt, lane='fused')
    return uend, [v for _, v in get_sorted(stats, type='niter', sortby='time')]


def test_fused_lane_keeps_one_lu_a_node(counters):
    """RayleighBenard 16x16 through ``ShardedController(2)``'s fused lane (its pieces eager on the CPU): the sweeps
    name their node (``prepare_node_solvers`` routes it), the first march makes the 3 nodes' LUs and the next
    none, and the marches equal a march whose solves name no node to the bit; a new dt makes each LU once again."""
    kept, fresh = _fused(False), _fused(True)
    prob = kept.MS[0].levels[0].prob
    assert prob.accepts_node_index and not fresh.MS[0].levels[0].prob.accepts_node_index
    u0 = _field(prob)
    marches = []
    for _ in range(2):
        before = counters()
        uend, niter = _march(kept, u0)
        want, want_niter = _march(fresh, u0)
        after = counters()
        marches.append(after['spectral.refreshes'] - before.get('spectral.refreshes', 0))
        assert niter == want_niter == [3] * 4 and torch.equal(uend, want)
        assert after['spectral.slot_solves'] - before.get('spectral.slot_solves', 0) > 0
    assert marches == [3, 0]
    for ctrl in (kept, fresh):
        ctrl.MS[0].levels[0].params.dt = 0.02
    before = counters()
    uend, niter = _march(kept, u0)
    want, want_niter = _march(fresh, u0)
    assert niter == want_niter and torch.equal(uend, want)
    assert counters()['spectral.refreshes'] - before['spectral.refreshes'] == 3
    assert len(prob.spec._slots) == 3 and fresh.MS[0].levels[0].prob.spec._slots == {}
