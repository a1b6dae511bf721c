"""Coefficient layer of the PyTorch port against the JAX package.

Nodes, weights, Q, S and every QDelta generator of ``pysdc_tpu_torch.ops``
must equal those of ``pysdc_tpu.ops`` to 1e-14 (both are float64 numpy).
The cases are those of ``tests/test_collocation.py`` and
``tests/test_qdelta.py``, merged into one parametrised test each.
"""

import numpy as np
import pytest

from pysdc_tpu.ops import collocation as jcoll
from pysdc_tpu.ops import qdelta as jqd
from pysdc_tpu_torch.ops import collocation as tcoll
from pysdc_tpu_torch.ops import qdelta as tqd

NODE_TYPES = ['EQUID', 'LEGENDRE', 'CHEBY-1', 'CHEBY-2', 'CHEBY-3', 'CHEBY-4']
QUAD_TYPES = ['GAUSS', 'LOBATTO', 'RADAU-RIGHT', 'RADAU-LEFT']
TOL = 1e-14


def _same(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=TOL)


@pytest.mark.parametrize('quad_type', QUAD_TYPES)
@pytest.mark.parametrize('node_type', NODE_TYPES)
@pytest.mark.parametrize('M', range(2, 13))
def test_collocation_matches_jax(M, node_type, quad_type):
    interval = (0.1387, 0.9461)  # the interval of tests/test_collocation.py
    want = jcoll.get_collocation(M, node_type, quad_type, *interval)
    got = tcoll.get_collocation(M, node_type, quad_type, *interval)
    for name in ('nodes', 'weights', 'Qmat', 'Smat', 'delta_m', 'q', 's'):
        _same(getattr(got, name), getattr(want, name))
    for name in ('num_nodes', 'order', 'left_is_node', 'right_is_node', 'tleft', 'tright'):
        assert getattr(got, name) == getattr(want, name), name
    # lru_cache contract: equal parameters give the same frozen object
    assert tcoll.get_collocation(M, node_type, quad_type, *interval) is got


@pytest.mark.parametrize('quad_type', QUAD_TYPES)
@pytest.mark.parametrize('node_type', NODE_TYPES)
@pytest.mark.parametrize('M', [2, 3, 4, 5])
def test_qdelta_matches_jax(M, node_type, quad_type):
    want_c = jcoll.get_collocation(M, node_type, quad_type, 0.0, 1.0)
    got_c = tcoll.get_collocation(M, node_type, quad_type, 0.0, 1.0)
    for name in tqd.IMPLICIT_GENERATORS:
        ks = range(1, M + 3) if tqd.is_k_dependent(name) else [None]
        for k in ks:
            got = tqd.qdelta_implicit(got_c, name, k=k)
            _same(got, jqd.qdelta_implicit(want_c, name, k=k))
            assert tqd.is_diagonal(got) == jqd.is_diagonal(got)
    for name in tqd.EXPLICIT_GENERATORS:
        _same(tqd.qdelta_explicit(got_c, name), jqd.qdelta_explicit(want_c, name))
    assert tqd.IMPLICIT_GENERATORS == jqd.IMPLICIT_GENERATORS
    assert tqd.K_DEPENDENT == jqd.K_DEPENDENT


def test_bad_parameters_raise_like_jax():
    for args in ((0, 'LEGENDRE', 'GAUSS'), (3, 'NOPE', 'GAUSS'), (3, 'LEGENDRE', 'NOPE'), (3, 'LEGENDRE', 'GAUSS', 1.0, 0.0)):
        with pytest.raises(ValueError):
            jcoll.get_collocation(*args)
        with pytest.raises(ValueError):
            tcoll.get_collocation(*args)
    coll = tcoll.get_collocation(3, 'LEGENDRE', 'RADAU-RIGHT')
    for fn, args in ((tqd.qdelta_implicit, ('NOPE',)), (tqd.qdelta_explicit, ('NOPE',)),
                     (tqd.qdelta_implicit, ('MIN-SR-FLEX', 0))):
        with pytest.raises(ValueError):
            fn(coll, *args)


def test_rdc_and_fd_tables_match_jax():
    from pysdc_tpu.ops import fd as jfd
    from pysdc_tpu_torch.ops import fd as tfd

    want, got = jcoll.get_collocation(5, 'EQUID-RDC'), tcoll.get_collocation(5, 'EQUID-RDC')
    for name in ('nodes', 'weights', 'Qmat', 'Smat'):
        _same(getattr(got, name), getattr(want, name))
    for order in (2, 4, 6):
        for kind in ('center', 'forward', 'backward', 'upwind'):
            for a, b in zip(tfd.get_finite_difference_stencil(1, order, kind),
                            jfd.get_finite_difference_stencil(1, order, kind)):
                _same(a, b)
        for bc in ('periodic', 'dirichlet-zero', 'neumann'):
            for a, b in zip(tfd.fd_matrix_1d(2, order, 12, 1 / 13, bc=bc), jfd.fd_matrix_1d(2, order, 12, 1 / 13, bc=bc)):
                _same(a, b)
        c, s = tfd.get_finite_difference_stencil(2, order, 'center')
        _same(tfd.stencil_symbol(c, s, 16, 1 / 16, 2), jfd.stencil_symbol(c, s, 16, 1 / 16, 2))
    for bc in ('periodic', 'dirichlet-zero'):
        for a, b in zip(tfd.get_1d_grid(10, bc), jfd.get_1d_grid(10, bc)):
            _same(a, b)
