"""The port's pivoted dense route (``ops/linalg.py:_pivoted_solve``) inside a whole run, against the JAX package
(float64 / complex128, CPU).

``RayleighBenard(nx=8, nz=128)`` couples 4 x 128 = 512 rows a Fourier mode, the first size at which the port's solve
takes the pivoted blocked LU on the card.  On the CPU ``ops.linalg`` calls LAPACK, so ``linalg._lapack`` is patched
here to send the port's factorizations and substitutions down the card's routes: the route's blocks run as on the
card, each panel and each block's row interchanges and ``U12`` by the kernels' plain versions.  The sweeps' solves
name their node, so each node's LU is made once at the run's one ``dt`` and kept (``ops/spectral.py``).  IMEX M=3
LU / PIC, 2 steps through ``ControllerNonMPI`` in both packages: equal ``niter``, ``uend`` to 1e-11 of
``max|uend|``.
"""

import numpy as np
import torch

import pysdc_tpu
import pysdc_tpu.models.rayleigh_benard as jrb
import pysdc_tpu_torch
from pysdc_tpu_torch.models import rayleigh_benard as trb
from pysdc_tpu_torch.ops import linalg
from pysdc_tpu_torch.ops.kernels import dense_lu
from pysdc_tpu_torch.utils.convert import to_numpy
from test_torch_solvers import close

torch.set_num_threads(1)

DT, STEPS, RESTOL, MAXITER = 0.01, 2, -1.0, 4  # chip_smoke.py phase 72's sweeps (the tau rows stall the residual)


def _run(pkg, module, **params):
    desc = dict(problem_class=module.RayleighBenard, problem_params=dict(nx=8, nz=128, Rayleigh=2e6, **params),
                sweeper_class=pkg.IMEXSweeper, sweeper_params=dict(num_nodes=3, QI='LU', QE='PIC'),
                level_params=dict(dt=DT, restol=RESTOL), step_params=dict(maxiter=MAXITER))
    ctrl = pkg.ControllerNonMPI(1, {'logger_level': 40}, desc)
    u0 = ctrl.MS[0].levels[0].prob.u_exact(0.0)
    uend, stats = ctrl.run(u0, 0.0, STEPS * DT)
    return np.asarray(to_numpy(u0)), np.asarray(to_numpy(uend)), [v for _, v in pkg.get_sorted(stats, type='niter')]


def test_pivoted_route_in_a_rayleigh_benard_run_matches_jax(monkeypatch):
    factored, substituted = [], []
    pivoted_factor, pivoted_substitute = linalg._pivoted_factor, linalg._pivoted_substitute

    def factor(A, overwrite_a=False):
        factored.append(A.shape[-1])
        return pivoted_factor(A, overwrite_a)

    def substitute(LU, perm, B):
        substituted.append(LU.shape[-1])
        return pivoted_substitute(LU, perm, B)

    panels = []
    plain_panel = dense_lu.plain_panel
    monkeypatch.setattr(linalg, '_lapack', lambda x: False)
    monkeypatch.setattr(linalg, '_pivoted_factor', factor)
    monkeypatch.setattr(linalg, '_pivoted_substitute', substitute)
    monkeypatch.setattr(dense_lu, 'plain_panel', lambda panel: panels.append(panel.shape) or plain_panel(panel))
    want_u0, want, want_niter = _run(pysdc_tpu, jrb)
    got_u0, got, niter = _run(pysdc_tpu_torch, trb, device='cpu')
    close(got_u0, want_u0, rtol=1e-14)
    assert niter == want_niter == [MAXITER] * STEPS
    close(got, want, rtol=1e-11)
    assert np.abs(got - got_u0).max() > 1e-8  # the run moved
    # every solve of the run took the pivoted route: one LU a node at the run's one dt, one 64-column panel a block
    # of each 512-row operator, and a substitution for each of the sweeps' node solves
    assert factored == [512] * 3 and all(rows >= 64 and width == 64 for _, rows, width in panels)
    assert len(panels) == 8 * len(factored)
    assert substituted == [512] * (STEPS * MAXITER * 3)
