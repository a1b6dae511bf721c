"""``utils/fieldsio.py`` and ``utils/golden.py`` of the port against the JAX package's.

FieldsIO: the same fields written by each package give byte-identical files,
and a file written by one package reads back in the other (both directions,
``Scalar`` and ``Rectilinear``, float32 and float64, torch tensors as input);
the ``.vtr`` export is the same text; a run checkpointed through the port's
``LogToFile`` and restarted equals a straight run (tests/test_fieldsio.py).
GoldenStore: the port's store gates ``examples/golden/step_26_embedding.json``
as the JAX store does, and in write mode both write the same bytes.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from pysdc_tpu.utils import fieldsio as jio
from pysdc_tpu.utils import golden as jgolden
from pysdc_tpu_torch.models.heat import HeatND
from pysdc_tpu_torch.parallel.nonmpi import ControllerNonMPI
from pysdc_tpu_torch.sweepers.generic_implicit import GenericImplicit
from pysdc_tpu_torch.utils import fieldsio as tio
from pysdc_tpu_torch.utils import golden as tgolden

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_26 = os.path.join(ROOT, 'examples', 'golden', 'step_26_embedding.json')
PACKAGES = {'jax': jio, 'torch': tio}


def _write(module, kind, dtype, path, fields, as_tensor=False):
    io = getattr(module, kind)(dtype, path)
    if kind == 'Scalar':
        io.setHeader(nVar=fields[0].size)
    else:
        io.setHeader(nVar=fields[0].shape[0], coords=[np.linspace(0, 1, n) for n in fields[0].shape[1:]])
    io.initialize()
    for i, f in enumerate(fields):
        io.addField(0.25 * i, torch.as_tensor(f) if as_tensor else f)
    return io


CASES = [('Scalar', np.float64, (7,)), ('Rectilinear', np.float32, (2, 8, 4)), ('Rectilinear', np.float64, (1, 6, 5, 3))]


@pytest.mark.parametrize('kind,dtype,shape', CASES, ids=[f'{k}-{np.dtype(d).name}-{len(s)}d' for k, d, s in CASES])
@pytest.mark.parametrize('writer', sorted(PACKAGES))
def test_files_are_byte_identical_and_read_across(tmp_path, writer, kind, dtype, shape):
    rng = np.random.default_rng(len(shape))
    fields = [rng.standard_normal(shape).astype(dtype) for _ in range(3)]
    jpath, tpath = str(tmp_path / 'jax.pysdc'), str(tmp_path / 'torch.pysdc')
    _write(jio, kind, dtype, jpath, fields)
    _write(tio, kind, dtype, tpath, fields, as_tensor=True)
    assert filecmp.cmp(jpath, tpath, shallow=False)
    reader = PACKAGES['torch' if writer == 'jax' else 'jax']
    back = reader.FieldsIO.fromFile(jpath if writer == 'jax' else tpath)
    assert back.nFields == 3 and np.array_equal(back.times, [0.0, 0.25, 0.5])
    for i, f in enumerate(fields):
        t, data = back.readField(i)
        assert t == 0.25 * i and data.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(data.reshape(f.shape), f)
    np.testing.assert_array_equal(back.readField(-1)[1].reshape(shape), fields[-1])


def test_vtr_export_is_the_same_text(tmp_path):
    field = np.random.default_rng(3).standard_normal((2, 4, 3))
    for name, module in PACKAGES.items():
        io = _write(module, 'Rectilinear', np.float64, str(tmp_path / f'{name}.pysdc'), [field])
        io.toVTR(str(tmp_path / name), idx=0)
    assert filecmp.cmp(tmp_path / 'jax_000000.vtr', tmp_path / 'torch_000000.vtr', shallow=False)


def test_checkpoint_restart_equivalence(tmp_path):
    """A run checkpointed at t=0.1 through ``LogToFile`` and restarted matches a straight run; the checkpoint file
    reads back in the JAX package."""
    desc = dict(
        problem_class=HeatND,
        problem_params=dict(nvars=64, nu=0.1, freq=2, bc='periodic', device='cpu'),
        sweeper_class=GenericImplicit,
        sweeper_params=dict(num_nodes=3, QI='LU'),
        level_params=dict(dt=0.05, restol=1e-11),
        step_params=dict(maxiter=20),
    )
    c = ControllerNonMPI(1, {'logger_level': 40}, desc)
    P = c.MS[0].levels[0].prob
    u_direct, _ = c.run(P.u_exact(0.0), 0.0, 0.2)

    logger = tio.LogToFile(str(tmp_path), P)
    c1 = ControllerNonMPI(1, {'logger_level': 40, 'hook_class': [logger.hook_class]}, desc)
    u_mid, _ = c1.run(P.u_exact(0.0), 0.0, 0.1)

    t_restart, u_restart = logger.load(-1)
    assert t_restart == pytest.approx(0.1) and logger.io.nFields == 2
    np.testing.assert_array_equal(u_restart.reshape(64), u_mid.numpy())
    t_jax, u_jax = jio.FieldsIO.fromFile(logger.file_name).readField(-1)
    assert t_jax == t_restart and np.array_equal(u_jax, u_restart)
    c2 = ControllerNonMPI(1, {'logger_level': 40}, desc)
    u_cont, _ = c2.run(torch.tensor(u_restart.reshape(64)), t_restart, 0.2)
    assert float((u_cont - u_direct).abs().max()) < 1e-13


def test_golden_store_gates_step_26_as_the_jax_store_does(tmp_path, monkeypatch):
    monkeypatch.delenv(tgolden.GoldenStore.WRITE_ENV, raising=False)
    stores = {'jax': jgolden.GoldenStore(STEP_26), 'torch': tgolden.GoldenStore(STEP_26)}
    niter = [5, 6, 6, 6, 6, 6, 6, 6]
    for store in stores.values():
        store.check('host_march_niter', niter)
        store.check('host_march_err', [0.0001535155772230956 * (1 + 1e-7)], rtol=1e-6, atol=1e-12)
        store.check('adjoint_loss_reduction_log10', [5.789589528454368 * 1.1], rtol=0.2)
        for bad in (lambda s: s.check('host_march_niter', niter[:-1] + [7]),
                    lambda s: s.check('adjoint_loss_reduction_log10', [5.789589528454368 * 1.5], rtol=0.2),
                    lambda s: s.check('no such key', [1.0])):
            with pytest.raises(AssertionError):
                bad(store)
    # a torch tensor is read as its values
    stores['torch'].check('host_march_niter', torch.tensor(niter))
    stores['torch'].check('host_march_err', torch.tensor([0.0001535155772230956], dtype=torch.float64))

    monkeypatch.setenv(tgolden.GoldenStore.WRITE_ENV, '1')
    for name, module in (('jax', jgolden), ('torch', tgolden)):
        store = module.GoldenStore(tmp_path / f'{name}.json')
        store.check('series', np.arange(3) * 0.5, rtol=1e-9)
        store.check('counts', [3, 4])
        store.flush()
    assert filecmp.cmp(tmp_path / 'jax.json', tmp_path / 'torch.json', shallow=False)


def test_fieldsio_refuses_misuse(tmp_path):
    """The port raises (not asserts) on a record before its header, a record of the wrong size, an index past the
    end."""
    io = tio.Scalar(np.float64, str(tmp_path / 'a.pysdc'))
    with pytest.raises(RuntimeError, match='setHeader'):
        io.initialize()
    with pytest.raises(RuntimeError, match='not initialized'):
        io.addField(0.0, np.zeros(3))
    io.setHeader(nVar=3)
    io.initialize()
    with pytest.raises(ValueError, match='expected 3 DoF'):
        io.addField(0.0, torch.zeros(4))
    io.addField(0.0, torch.zeros(3))
    with pytest.raises(IndexError):
        tio.FieldsIO.fromFile(io.file_name).readField(1)
