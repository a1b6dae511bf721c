"""Package rules of the PyTorch port.

``pysdc_tpu_torch`` and ``chip_smoke.py`` import neither JAX nor anything of
``pysdc_tpu``; entry points run on the card unless asked for the CPU and
refuse to carry on without one; what the slice does not port yet raises.
"""

import os
import subprocess
import sys
import tempfile

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = (
    'import sys\n'
    'bad = sorted(m for m in sys.modules if m.startswith("jax") or m == "pysdc_tpu" or m.startswith("pysdc_tpu."))\n'
    'assert not bad, bad\n'
    'print("clean")\n'
)


@pytest.mark.parametrize('imports', [
    'import pysdc_tpu_torch, pysdc_tpu_torch.models.heat, pysdc_tpu_torch.utils.convert, '
    'pysdc_tpu_torch.ops.kernels.stencil, pysdc_tpu_torch.ops.kernels.build, pysdc_tpu_torch.convergence',
    'import pysdc_tpu_torch.models.var_diffusion, pysdc_tpu_torch.ops.sparse_op, pysdc_tpu_torch.ops.banded, '
    'pysdc_tpu_torch.ops.kernels.dia, pysdc_tpu_torch.ops.kernels.bsr',
    'import pysdc_tpu_torch.transfer, pysdc_tpu_torch.transfer.base_transfer, pysdc_tpu_torch.transfer.space_mesh, '
    'pysdc_tpu_torch.transfer.space_fft, pysdc_tpu_torch.transfer.no_coarse, pysdc_tpu_torch.sweepers.imex, '
    'pysdc_tpu_torch.ops.diag_sdc',
    'import pysdc_tpu_torch.parallel.sharded, pysdc_tpu_torch.parallel.fused; '
    'from pysdc_tpu_torch import ShardedController',
    'import chip_smoke',
])
def test_imports_no_jax_and_no_pysdc_tpu(imports):
    out = subprocess.run([sys.executable, '-c', imports + '\n' + _NO_JAX],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'clean'


def test_problem_without_device_needs_a_card(monkeypatch):
    from pysdc_tpu_torch.models.heat import HeatND

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        HeatND(nvars=(8, 8))
    prob = HeatND(nvars=(8, 8), device='cpu')
    assert prob.u_exact(0.0).device.type == 'cpu' and prob.u_exact(0.0).dtype == torch.float64


def test_unported_parts_raise_naming_the_roadmap():
    from pysdc_tpu_torch.models.heat import HeatND

    for kwargs in (dict(solver_type='CG'), dict(solver_type='GMRES'), dict(backend='sparse', solver_type='CG')):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            HeatND(nvars=8, device='cpu', **kwargs)
    sparse = HeatND(nvars=8, device='cpu', backend='sparse')
    u = sparse.u_exact(0.0)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        sparse.A.solve_shifted_gmres(u, 0.1, u)

    # the block controller: a mesh, the owner-computes chain and the adaptive fused lane
    from pysdc_tpu_torch import GenericImplicit, ShardedController
    from pysdc_tpu_torch.core.errors import ControllerError
    from pysdc_tpu_torch.parallel import fused

    desc = dict(problem_class=HeatND, problem_params=dict(nvars=8, device='cpu'), sweeper_class=GenericImplicit,
                sweeper_params=dict(num_nodes=2), level_params=dict(dt=0.1))
    for kwargs in (dict(mesh='a mesh'), dict(coarse_mode='owner')):
        with pytest.raises(ControllerError, match='ROADMAP queue 1, item 10b'):
            ShardedController(2, {'logger_level': 40}, desc, **kwargs)
    ctrl = ShardedController(2, {'logger_level': 40}, desc)
    for entry in (fused.check_fused_adaptive_eligibility, fused.run_fused_adaptive):
        with pytest.raises(ControllerError, match='ROADMAP queue 1, item 6b'):
            entry(ctrl)


def test_chip_smoke_fails_without_a_card_and_alone():
    out = subprocess.run([sys.executable, 'chip_smoke.py'], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    with tempfile.TemporaryDirectory() as alone:
        with open(os.path.join(ROOT, 'chip_smoke.py')) as src, open(os.path.join(alone, 'chip_smoke.py'), 'w') as dst:
            dst.write(src.read())
        env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
        out = subprocess.run([sys.executable, 'chip_smoke.py'], capture_output=True, text=True, timeout=120,
                             cwd=alone, env=env)
    assert out.returncode != 0 and '"ok"' not in out.stdout
