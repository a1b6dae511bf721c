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
    'import pysdc_tpu_torch.convergence.adaptivity, pysdc_tpu_torch.convergence.estimate_embedded_error, '
    'pysdc_tpu_torch.convergence.step_size_limiter, pysdc_tpu_torch.convergence.store_uold, '
    'pysdc_tpu_torch.hooks.logging_hooks, pysdc_tpu_torch.models.odes, pysdc_tpu_torch.models.allen_cahn',
    'import pysdc_tpu_torch.models, pysdc_tpu_torch.ops.solvers, pysdc_tpu_torch.ops.krylov, '
    'pysdc_tpu_torch.ops.loops, pysdc_tpu_torch.models.allen_cahn_spectral, pysdc_tpu_torch.models.gray_scott',
    'import chip_smoke',
    'import pysdc_tpu_torch.sweepers, pysdc_tpu_torch.sweepers.runge_kutta, pysdc_tpu_torch.sweepers.multistep, '
    'pysdc_tpu_torch.sweepers.linearized, pysdc_tpu_torch.sweepers.multi_implicit, pysdc_tpu_torch.sweepers.explicit, '
    'pysdc_tpu_torch.models.dahlquist',
    'import pysdc_tpu_torch.parallel.paradiag, pysdc_tpu_torch.sweepers.paradiag, pysdc_tpu_torch.models.particles, '
    'pysdc_tpu_torch.sweepers.verlet, pysdc_tpu_torch.sweepers.boris, pysdc_tpu_torch.sweepers.rkn, '
    'pysdc_tpu_torch.models.dae_problems, pysdc_tpu_torch.sweepers.dae; '
    'from pysdc_tpu_torch import ParaDiagController, QDiagonalization, QDiagonalizationIMEX',
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

    # the iterative solves are ported (item 9): they solve where they raised
    for kwargs in (dict(solver_type='CG'), dict(solver_type='GMRES'), dict(backend='sparse', solver_type='CG')):
        prob = HeatND(nvars=8, device='cpu', **kwargs)
        u = prob.u_exact(0.0)
        x = prob.solve_system(u, 0.01, u, 0.0)
        assert torch.allclose(x, HeatND(nvars=8, device='cpu').solve_system(u, 0.01, u, 0.0), atol=1e-10)
    sparse = HeatND(nvars=8, device='cpu', backend='sparse')
    u = sparse.u_exact(0.0)
    assert torch.allclose(sparse.A.solve_shifted_gmres(u, 0.1, u), sparse.A.solve_shifted(u, 0.1), atol=1e-10)

    # the block controller: a mesh and the owner-computes chain
    from pysdc_tpu_torch import GenericImplicit, ShardedController
    from pysdc_tpu_torch.core.errors import ControllerError

    desc = dict(problem_class=HeatND, problem_params=dict(nvars=8, device='cpu'), sweeper_class=GenericImplicit,
                sweeper_params=dict(num_nodes=2), level_params=dict(dt=0.1))
    for kwargs in (dict(mesh='a mesh'), dict(coarse_mode='owner')):
        with pytest.raises(ControllerError, match='ROADMAP queue 1, item 10b'):
            ShardedController(2, {'logger_level': 40}, desc, **kwargs)
    # ParaDiag (item 11) is ported; its time axis sharded over a mesh waits for 10b
    from pysdc_tpu_torch import ParaDiagController

    with pytest.raises(ControllerError, match='ROADMAP queue 1, item 10b'):
        ParaDiagController(2, {'logger_level': 40, 'alpha': 1e-4}, dict(desc, sweeper_params=dict(num_nodes=2)),
                           mesh='a mesh')

    # the adaptivity classes that wait for their estimators; the fully implicit Allen-Cahn solve (item 9) solves
    # now, and so do the first-order sweepers of item 12 (AdaptivityRK among them): nothing of the package names
    # item 9 or item 12 any more
    import pysdc_tpu_torch.convergence as conv
    from pysdc_tpu_torch.models.allen_cahn import AllenCahnPeriodicND

    for name, item in (('AdaptivityResidual', 'item 13'), ('EstimateEmbeddedErrorCollocation', 'item 13')):
        with pytest.raises(NotImplementedError, match=f'ROADMAP queue 1, {item}'):
            getattr(conv, name)(None, {}, desc)
    prob = AllenCahnPeriodicND(nvars=(8, 8), eps=0.2, device='cpu')
    u = prob.u_exact(0.0)
    x = prob.solve_system(u, 1e-3, u, 0.0)
    assert float((x - 1e-3 * (prob.A.apply(x) + prob._reaction(x)) - u).abs().max()) <= prob.newton_tol
    package = os.path.join(ROOT, 'pysdc_tpu_torch')
    for folder, _, files in os.walk(package):
        for name in files:
            if name.endswith('.py'):
                with open(os.path.join(folder, name)) as f:
                    text = f.read()
                    assert 'item 9' not in text and 'item 11' not in text and 'item 12' not in text, name


def test_adaptive_lane_and_e_tol_run():
    """What raised "not ported" until the adaptive slice now runs: ``CheckConvergence(e_tol=...)`` registers its
    estimator, and an ``Adaptivity`` configuration goes to the adaptive fused lane through ``run()``."""
    from pysdc_tpu_torch import ControllerNonMPI, GenericImplicit, ShardedController, get_sorted
    from pysdc_tpu_torch.convergence import Adaptivity
    from pysdc_tpu_torch.models.odes import VanDerPol
    from pysdc_tpu_torch.parallel import fused

    desc = dict(problem_class=VanDerPol, problem_params=dict(newton_tol=1e-10, device='cpu'),
                sweeper_class=GenericImplicit, sweeper_params=dict(num_nodes=3, QI='LU'),
                level_params=dict(dt=1e-2, restol=-1.0, e_tol=1e-8), step_params=dict(maxiter=10))
    ctrl = ControllerNonMPI(1, {'logger_level': 40}, desc)
    assert 'EstimateEmbeddedError' in [type(C).__name__ for C in ctrl.convergence_controllers]
    _, stats = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, 0.02)
    assert all(0 < v < 10 for _, v in get_sorted(stats, type='niter'))

    desc = dict(desc, level_params=dict(dt=1e-2, restol=-1.0), step_params=dict(maxiter=4),
                convergence_controllers={Adaptivity: {'e_tol': 1e-6}})
    ctrl = ShardedController(2, {'logger_level': 40}, desc)
    fused.check_fused_adaptive_eligibility(ctrl)
    uend, stats = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, 0.03)
    assert [v for k, v in stats.items() if k.type == 'lane'] == ['fused_adaptive']
    assert torch.isfinite(uend).all() and ctrl.host_reads['cont'] == 0 and ctrl.host_reads['fetch'] >= 1
    assert len(ctrl._fused_adaptive_fn._programs) == 1


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
