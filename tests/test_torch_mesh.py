"""The port's device mesh (``pysdc_tpu_torch/parallel/mesh.py``) against the
JAX package's (``pysdc_tpu/parallel/mesh.py``), and the two users of a mesh
outside the block controller: ParaDiag's time-sharded block
(tests/test_paradiag.py:100) and FieldsIO's sharded write
(tests/test_fieldsio.py:100-130).

Port meshes take ``devices=['cpu'] * 8``, the counterpart of the eight
emulated host devices of tests/conftest.py; inputs come from seeded numpy,
everything is float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysdc_tpu_torch
from pysdc_tpu.parallel import mesh as jmesh
from pysdc_tpu_torch.core.errors import ControllerError
from pysdc_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)
CPU8 = ['cpu'] * 8


@pytest.mark.parametrize('shape', [(1, 1, 1), (4, 1, 1), (2, 2, 2), (1, 1, 8), (2, 1, 4)])
def test_make_mesh_axes_and_shape(shape):
    n_time, n_node, n_space = shape
    want = jmesh.make_mesh(n_time=n_time, n_space=n_space, n_node=n_node)
    got = tmesh.make_mesh(n_time=n_time, n_space=n_space, n_node=n_node, devices=CPU8)
    assert got.axis_names == want.axis_names == ('time', 'node', 'space')
    assert dict(got.shape) == dict(want.shape) == {'time': n_time, 'node': n_node, 'space': n_space}
    assert got.devices.shape == want.devices.shape
    assert all(d == torch.device('cpu') for d in got.devices.reshape(-1))
    assert pysdc_tpu_torch.make_mesh is tmesh.make_mesh


def test_make_mesh_needs_enough_devices_and_never_takes_the_cpu_by_itself(monkeypatch):
    with pytest.raises(ValueError, match=r'need 16 devices for mesh \(time=4, node=1, space=4\), have 8'):
        jmesh.make_mesh(n_time=4, n_space=4)
    with pytest.raises(ValueError, match=r'need 16 devices for mesh \(time=4, node=1, space=4\), have 8'):
        tmesh.make_mesh(n_time=4, n_space=4, devices=CPU8)
    # devices=None means the CUDA cards: none here, so even a one-position mesh raises
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 0)
    with pytest.raises(ValueError, match='need 1 devices .* have 0'):
        tmesh.make_mesh()
    # one device may fill every position
    m = tmesh.make_mesh(n_time=4, devices=[torch.device('cpu')] * 4)
    assert m.device_set == {torch.device('cpu')} and m.size == 4


@pytest.mark.parametrize('shape,ndim_space,node_len,shard_space', [
    ((4, 1, 2), 2, 4, True), ((2, 2, 2), 2, 4, True), ((2, 2, 2), 2, 3, True), ((2, 2, 2), 1, 4, False),
    ((2, 4, 1), 3, 4, True), ((2, 4, 1), 3, None, True), ((8, 1, 1), 0, 3, True),
])
def test_block_sharding_specs(shape, ndim_space, node_len, shard_space):
    """The node axis is sharded only where the mesh has one and the node count divides
    (pysdc_tpu/parallel/mesh.py:36-53)."""
    n_time, n_node, n_space = shape
    args = (ndim_space, shard_space, node_len)
    want = jmesh.block_sharding(jmesh.make_mesh(n_time=n_time, n_space=n_space, n_node=n_node), *args)
    got = tmesh.block_sharding(tmesh.make_mesh(n_time=n_time, n_space=n_space, n_node=n_node, devices=CPU8), *args)
    assert tuple(got.spec) == tuple(want.spec)
    assert (got.spec[1] == 'node') == (n_node > 1 and node_len is not None and node_len % n_node == 0)


def test_replicated_and_device_put():
    m_j = jmesh.make_mesh(n_time=2, n_space=4)
    m_t = tmesh.make_mesh(n_time=2, n_space=4, devices=CPU8)
    assert tuple(tmesh.replicated(m_t).spec) == tuple(jmesh.replicated(m_j).spec) == ()
    data = np.random.default_rng(3).standard_normal((4, 2, 8, 6))
    want = jax.device_put(jnp.asarray(data), jmesh.block_sharding(m_j, 2))
    got = tmesh.device_put(torch.as_tensor(data), tmesh.block_sharding(m_t, 2))
    # every position holds the slab at the same index, with the same replica numbering
    key = [(tuple((s.start, s.stop) for s in sh.index), sh.replica_id) for sh in got.addressable_shards]
    assert sorted(key) == sorted((tuple((s.start, s.stop) for s in sh.index), sh.replica_id)
                                 for sh in want.addressable_shards)
    for sh in got.addressable_shards:
        np.testing.assert_array_equal(sh.data.numpy(), data[sh.index])
    np.testing.assert_array_equal(got.gather('cpu').numpy(), data)
    assert not got.is_fully_replicated
    rep = tmesh.device_put(torch.as_tensor(data), tmesh.replicated(m_t))
    assert rep.is_fully_replicated and sorted(sh.replica_id for sh in rep.addressable_shards) == list(range(8))
    with pytest.raises(ValueError, match='does not divide'):
        tmesh.device_put(torch.zeros(3, 8), tmesh.NamedSharding(m_t, tmesh.PartitionSpec('time', 'space')))
    with pytest.raises(ValueError, match='rank at least 4'):
        tmesh.device_put(torch.as_tensor(data[0]), tmesh.block_sharding(m_t, 2))


def test_controllers_refuse_what_is_not_a_mesh_and_a_mesh_off_the_problems_device(monkeypatch):
    from pysdc_tpu_torch import GenericImplicit, ParaDiagController, ShardedController
    from pysdc_tpu_torch.models.heat import HeatND

    desc = dict(problem_class=HeatND, problem_params=dict(nvars=8, device='cpu'), sweeper_class=GenericImplicit,
                sweeper_params=dict(num_nodes=2), level_params=dict(dt=0.1))
    with pytest.raises(ControllerError, match='mesh must be a pysdc_tpu_torch.parallel.mesh.Mesh'):
        ShardedController(2, {'logger_level': 40}, desc, mesh='a mesh')
    with pytest.raises(ControllerError, match='do not divide over the 4 time positions'):
        ShardedController(2, {'logger_level': 40}, desc, mesh=tmesh.make_mesh(n_time=4, devices=CPU8))
    # a problem on the CPU and a mesh on the card: nothing moves quietly (the device is never touched)
    card_mesh = tmesh.Mesh(np.asarray([torch.device('cuda', 0)] * 2, dtype=object).reshape(2, 1, 1),
                           tmesh.AXIS_NAMES)
    with pytest.raises(ControllerError, match='the problem lives on cpu and the mesh has a position on cuda:0'):
        ShardedController(2, {'logger_level': 40}, desc, mesh=card_mesh)
    pd = dict(desc, sweeper_params=dict(num_nodes=2, quad_type='RADAU-RIGHT'))
    del pd['sweeper_class']
    with pytest.raises(ControllerError, match='mesh must be'):
        ParaDiagController(2, {'logger_level': 40, 'alpha': 1e-4}, pd, mesh='a mesh')
    with pytest.raises(ControllerError, match='the problem lives on cpu'):
        ParaDiagController(2, {'logger_level': 40, 'alpha': 1e-4}, pd, mesh=card_mesh)


def _paradiag_desc(package):
    """tests/test_paradiag.py:100's configuration."""
    if package == 'jax':
        from pysdc_tpu.models.heat import HeatND
        from pysdc_tpu.sweepers.paradiag import QDiagonalization
        pp = {}
    else:
        from pysdc_tpu_torch.models.heat import HeatND
        from pysdc_tpu_torch.sweepers.paradiag import QDiagonalization
        pp = {'device': 'cpu'}
    return dict(problem_class=HeatND, problem_params=dict(nvars=64, nu=0.1, freq=2, bc='periodic', **pp),
                sweeper_class=QDiagonalization, sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=3),
                level_params=dict(dt=0.05, restol=1e-10), step_params=dict(maxiter=30))


def test_paradiag_time_sharded_matches_unsharded_and_jax():
    """tests/test_paradiag.py:100: the (L, M, *shape) block sharded over 'time' (the weighted DFTs as gather,
    product, split; per-step solves on each shard) against the unsharded controller and the JAX package's
    sharded one: equal niter, uend within 1e-11."""
    import pysdc_tpu
    from pysdc_tpu_torch.utils.stats import get_sorted

    P, cp = 8, {'logger_level': 40, 'alpha': 1e-4}
    jsh = pysdc_tpu.ParaDiagController(P, cp, _paradiag_desc('jax'), mesh=jmesh.make_mesh(n_time=8))
    assert jsh._time_sharded
    u0_j = jsh.template.levels[0].prob.u_exact(0.0)
    u_j, s_j = jsh.run(u0_j, 0.0, P * 0.05)
    it_j = [v for _, v in pysdc_tpu.get_sorted(s_j, type='niter')]

    ref = pysdc_tpu_torch.ParaDiagController(P, cp, _paradiag_desc('torch'))
    u0 = torch.as_tensor(np.array(u0_j))
    u_ref, s_ref = ref.run(u0, 0.0, P * 0.05)
    for n_time in (8, 4, 2):
        sh = pysdc_tpu_torch.ParaDiagController(P, cp, _paradiag_desc('torch'),
                                                mesh=tmesh.make_mesh(n_time=n_time, devices=CPU8))
        assert sh._time_sharded
        u_sh, s_sh = sh.run(u0, 0.0, P * 0.05)
        it_sh = [v for _, v in get_sorted(s_sh, type='niter')]
        assert it_sh == [v for _, v in get_sorted(s_ref, type='niter')] == it_j, n_time
        np.testing.assert_allclose(u_sh.numpy(), u_ref.numpy(), rtol=0, atol=1e-11)
        np.testing.assert_allclose(u_sh.numpy(), np.asarray(u_j), rtol=0, atol=1e-11)
        # per iteration: the residual norms and the two DFT operands gathered, the two DFT results and the
        # u0 chain's boundary fields copied
        iters = sum(it_sh) // P
        assert sh.mesh.traffic == {'gathers': 3 * iters, 'copies': n_time + iters * (2 * n_time + n_time - 1)}
    # a mesh whose time axis does not divide L keeps the block whole
    assert not pysdc_tpu_torch.ParaDiagController(P, cp, _paradiag_desc('torch'),
                                                  mesh=tmesh.make_mesh(n_time=3, devices=CPU8))._time_sharded


def test_sharded_write_matches_host_write_and_the_jax_file(tmp_path):
    """tests/test_fieldsio.py:100-130: each shard written once into its slab of the record; the file byte-equal to
    the host write of the port and to the JAX package's sharded write.  A replicated field is written once."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from pysdc_tpu.utils import fieldsio as jfio
    from pysdc_tpu_torch.utils import fieldsio as tfio

    data = np.random.default_rng(7).standard_normal((2, 16, 8))
    coords = [np.arange(16, dtype=float), np.arange(8, dtype=float)]
    jm = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2), axis_names=('a', 'b'))
    tm = tmesh.Mesh(np.asarray(CPU8, dtype=object).reshape(4, 2), ('a', 'b'))
    spec = (None, 'a', 'b')

    def write(module, name, fields):
        io = module.Rectilinear(np.float64, str(tmp_path / name))
        io.setHeader(nVar=2, coords=coords)
        io.initialize()
        for t, field in fields:
            io.addField(t, field)
        return (tmp_path / name).read_bytes()

    sharded = [(t, tmesh.device_put(torch.as_tensor(k * data), tmesh.NamedSharding(tm, tmesh.PartitionSpec(*spec))))
               for t, k in ((0.5, 1.0), (1.5, 2.0))]
    assert len(sharded[0][1].addressable_shards) == 8 and not sharded[0][1].is_fully_replicated
    got = write(tfio, 'port-sharded.pysdc', sharded)
    host = write(tfio, 'port-host.pysdc', [(0.5, data), (1.5, 2 * data)])
    jax_file = write(jfio, 'jax-sharded.pysdc', [
        (t, jax.device_put(jnp.asarray(k * data), NamedSharding(jm, PartitionSpec(*spec)))) for t, k in ((0.5, 1.0),
                                                                                                      (1.5, 2.0))])
    assert got == host == jax_file
    # the slab writes read no shard twice: a tensor standing in for each copy of a replicated slab is never read
    repl = tmesh.device_put(torch.as_tensor(data), tmesh.replicated(tm))
    for sh in repl.addressable_shards[1:]:
        sh.data = None
    io = tfio.FieldsIO.fromFile(str(tmp_path / 'port-sharded.pysdc'))
    io.addField(2.5, repl)
    t, f = tfio.FieldsIO.fromFile(io.file_name).readField(2)
    assert t == 2.5
    np.testing.assert_array_equal(np.asarray(f), data)
