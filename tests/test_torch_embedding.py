"""``utils/embedding.py`` of the port against the JAX package's (tests/test_embedding.py through both).

Every case of ``tests/test_embedding.py`` runs in both packages on the CPU,
float64, and the two are compared: the external loop of pure SDC steps (``lax.scan``
inside ``jit`` against a Python loop), the step mapped over a batch of initial
conditions (``jax.vmap`` against ``torch.func.vmap`` of the masked loop), the
refusal of k-dependent preconditioners, the controller as a stepper (equal
``niter``), and the gradient through ``fixed_sweeps`` steps (``jax.grad``
against ``torch.autograd`` and ``torch.func.grad``, to 1e-11 relative; at 32^2
the 2D operator applies go through K1's ``autograd.Function``).  The JAX runs
are made once, in one module fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysdc_tpu.models.heat import HeatND as JaxHeat
from pysdc_tpu.parallel.nonmpi import ControllerNonMPI as JaxController
from pysdc_tpu.sweepers.generic_implicit import GenericImplicit as JaxImplicit
from pysdc_tpu.utils import embedding as jemb
from pysdc_tpu.utils.stats import get_sorted as jax_sorted
from pysdc_tpu_torch.models.heat import HeatND
from pysdc_tpu_torch.ops.kernels import stencil
from pysdc_tpu_torch.parallel.nonmpi import ControllerNonMPI
from pysdc_tpu_torch.sweepers.generic_implicit import GenericImplicit
from pysdc_tpu_torch.utils import embedding as temb
from pysdc_tpu_torch.utils.stats import get_sorted

torch.set_num_threads(1)

SCAN_DT, SCAN_STEPS = 0.05, 10
GRAD_N, GRAD_DT, GRAD_STEPS, GRAD_SWEEPS = 32, 0.02, 5, 4
ROUNDOFF = 1e-13


def _heat_desc(problem_class, sweeper_class, dt, **problem):
    return dict(
        problem_class=problem_class,
        problem_params=dict(nvars=64, nu=0.1, freq=2, bc='periodic', **problem),
        sweeper_class=sweeper_class,
        sweeper_params=dict(num_nodes=3, QI='LU'),
        level_params=dict(dt=dt, restol=1e-11),
        step_params=dict(maxiter=30),
    )


def _grad_inputs():
    rng = np.random.default_rng(26)
    return rng.standard_normal((GRAD_N, GRAD_N)), rng.standard_normal((GRAD_N, GRAD_N))


@pytest.fixture(scope='module')
def jax_runs():
    out = {}
    prob = JaxHeat(nvars=64, nu=0.1, freq=2, bc='periodic')
    step = jemb.make_sdc_step_function(prob, JaxImplicit({'num_nodes': 3, 'QI': 'LU'}), restol=1e-11, maxiter=30)

    @jax.jit
    def external_program(u0):
        def body(carry, k):
            u, t = carry
            return (step(u, t, SCAN_DT), t + SCAN_DT), None

        (u, _), _ = jax.lax.scan(body, (u0, 0.0), jnp.arange(SCAN_STEPS))
        return u

    out['scan'] = np.asarray(external_program(prob.u_exact(0.0)))

    prob = JaxHeat(nvars=32, nu=0.1, freq=2, bc='periodic')
    step = jemb.make_sdc_step_function(prob, JaxImplicit({'num_nodes': 3, 'QI': 'LU'}), restol=1e-11, maxiter=30)
    u0 = prob.u_exact(0.0)
    out['vmap'] = np.asarray(jax.vmap(lambda u: step(u, 0.0, 0.05))(jnp.stack([u0, 2 * u0, -u0])))

    stepper = jemb.ControllerAsStepper(JaxController, _heat_desc(JaxHeat, JaxImplicit, 0.1), {'logger_level': 40},
                                       dt=0.1, n_steps=2)
    u = stepper.controller.MS[0].levels[0].prob.u_exact(0.0)
    for i in range(4):
        u = stepper.apply(u, 0.1 * i)
    out['stepper'] = (np.asarray(u), [v for _, v in jax_sorted(stepper.stats, type='niter')], stepper.reached(0.4))

    prob = JaxHeat(nvars=32, nu=0.1, freq=2, bc='periodic')
    step = jemb.make_sdc_step_function(prob, JaxImplicit({'num_nodes': 3, 'QI': 'LU'}), fixed_sweeps=5)
    u0 = prob.u_exact(0.0)

    def loss(scale):
        return jnp.sum(step(scale * u0, 0.0, 0.05) ** 2)

    out['scale_grad'] = (float(jax.grad(loss)(1.0)), float(loss(1.0)))

    prob = JaxHeat(nvars=(GRAD_N, GRAD_N), nu=0.1, freq=2, bc='periodic')
    sweep = JaxImplicit({'num_nodes': 3, 'quad_type': 'RADAU-RIGHT', 'QI': 'LU'})
    step = jemb.make_sdc_step_function(prob, sweep, fixed_sweeps=GRAD_SWEEPS)
    u0, target = _grad_inputs()

    def mse(u):
        def body(carry, i):
            u, t = carry
            return (step(u, t, GRAD_DT), t + GRAD_DT), None

        (uT, _), _ = jax.lax.scan(body, (u, 0.0), jnp.arange(GRAD_STEPS))
        return jnp.mean((uT - target) ** 2)

    value, grad = jax.value_and_grad(mse)(jnp.asarray(u0))
    out['mse'] = (float(value), np.asarray(grad))
    return out


def test_sdc_step_inside_external_loop(jax_runs):
    prob = HeatND(nvars=64, nu=0.1, freq=2, bc='periodic', device='cpu')
    step = temb.make_sdc_step_function(prob, GenericImplicit({'num_nodes': 3, 'QI': 'LU'}), restol=1e-11, maxiter=30)
    u, t = prob.u_exact(0.0), 0.0
    for _ in range(SCAN_STEPS):  # the external program's own loop
        u, t = step(u, t, SCAN_DT), t + SCAN_DT
    assert float((u - prob.u_exact(SCAN_STEPS * SCAN_DT)).abs().max()) < 1e-7
    np.testing.assert_allclose(u.numpy(), jax_runs['scan'], rtol=0, atol=ROUNDOFF)


def test_sdc_step_is_vmappable(jax_runs):
    prob = HeatND(nvars=32, nu=0.1, freq=2, bc='periodic', device='cpu')
    step = temb.make_sdc_step_function(prob, GenericImplicit({'num_nodes': 3, 'QI': 'LU'}), restol=1e-11, maxiter=30)
    u0 = prob.u_exact(0.0)
    out = torch.func.vmap(lambda u: step(u, 0.0, 0.05))(torch.stack([u0, 2 * u0, -u0]))
    one = step(u0, 0.0, 0.05)
    assert float((out[0] - one).abs().max()) < 1e-13
    assert float((out[1] - 2 * one).abs().max()) < 5e-11  # linear problem
    np.testing.assert_allclose(out.numpy(), jax_runs['vmap'], rtol=0, atol=ROUNDOFF)


def test_sdc_step_on_k1_is_vmappable_with_one_launch_an_apply(monkeypatch):
    """A 2D periodic problem: the mapped step's every operator apply is one launch of the whole batch."""
    shapes = []
    plain = stencil._plain

    def counting(u, terms, path=None):
        shapes.append(tuple(u.shape))
        return plain(u, terms, path)

    monkeypatch.setattr(stencil, '_plain', counting)
    prob = HeatND(nvars=(16, 16), nu=0.1, freq=2, bc='periodic', device='cpu')
    step = temb.make_sdc_step_function(prob, GenericImplicit({'num_nodes': 3, 'QI': 'LU'}), restol=1e-11, maxiter=8)
    u0 = prob.u_exact(0.0)
    out = torch.func.vmap(lambda u: step(u, 0.0, 0.05))(torch.stack([u0, 3 * u0]))
    assert shapes and all(s[0] == 2 for s in shapes)
    assert float((out[1] - 3 * step(u0, 0.0, 0.05)).abs().max()) < 1e-12


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_k_dependent_preconditioner_rejected(package):
    if package == 'jax':
        prob, sweep, make = JaxHeat(nvars=32), JaxImplicit({'num_nodes': 3, 'QI': 'MIN-SR-FLEX'}), jemb
    else:
        prob, sweep, make = HeatND(nvars=32, device='cpu'), GenericImplicit({'num_nodes': 3, 'QI': 'MIN-SR-FLEX'}), temb
    with pytest.raises(ValueError, match='k-dependent'):
        make.make_sdc_step_function(prob, sweep)
    make.make_sdc_step_function(prob, sweep, fixed_sweeps=3)


def test_controller_as_stepper_accumulates_stats(jax_runs):
    stepper = temb.ControllerAsStepper(ControllerNonMPI, _heat_desc(HeatND, GenericImplicit, 0.1, device='cpu'),
                                       {'logger_level': 40}, dt=0.1, n_steps=2)
    prob = stepper.controller.MS[0].levels[0].prob
    u, t = prob.u_exact(0.0), 0.0
    for _ in range(4):  # the EXTERNAL loop
        u = stepper.apply(u, t)
        t += 0.1
    assert float((u - prob.u_exact(t)).abs().max()) < 5e-8
    niter = [v for _, v in get_sorted(stepper.stats, type='niter')]
    want_u, want_niter, want_reached = jax_runs['stepper']
    assert niter == want_niter and len(niter) == 8  # 4 applies x 2 substeps accumulated
    assert abs(stepper.reached(t) - t) < 1e-12 and abs(stepper.reached(t) - want_reached) < 1e-12
    np.testing.assert_allclose(u.numpy(), want_u, rtol=0, atol=ROUNDOFF)


def test_fixed_sweeps_step_is_differentiable(jax_runs):
    prob = HeatND(nvars=32, nu=0.1, freq=2, bc='periodic', device='cpu')
    step = temb.make_sdc_step_function(prob, GenericImplicit({'num_nodes': 3, 'QI': 'LU'}), fixed_sweeps=5)
    u0 = prob.u_exact(0.0)

    def loss(scale):
        return (step(scale * u0, 0.0, 0.05) ** 2).sum()

    g = float(torch.func.grad(loss)(torch.tensor(1.0, dtype=torch.float64)))
    assert np.isfinite(g) and abs(g - 2 * float(loss(1.0))) < 1e-9
    want_g, want_loss = jax_runs['scale_grad']
    assert abs(g - want_g) <= 1e-11 * abs(want_g) and abs(float(loss(1.0)) - want_loss) <= 1e-12 * want_loss


def test_gradient_through_the_integrator_matches_jax_grad(jax_runs):
    """The loss of step 26's inversion at 32^2: value and gradient against ``jax.value_and_grad`` to 1e-11."""
    prob = HeatND(nvars=(GRAD_N, GRAD_N), nu=0.1, freq=2, bc='periodic', device='cpu')
    sweep = GenericImplicit({'num_nodes': 3, 'quad_type': 'RADAU-RIGHT', 'QI': 'LU'})
    step = temb.make_sdc_step_function(prob, sweep, fixed_sweeps=GRAD_SWEEPS)
    u0, target = (torch.as_tensor(a) for a in _grad_inputs())

    def mse(u):
        t = 0.0
        for _ in range(GRAD_STEPS):
            u, t = step(u, t, GRAD_DT), t + GRAD_DT
        return torch.mean((u - target) ** 2)

    x = u0.clone().requires_grad_()
    value = mse(x)
    value.backward()
    want_value, want_grad = jax_runs['mse']
    scale = np.abs(want_grad).max()
    assert abs(float(value.detach()) - want_value) <= 1e-11 * want_value
    assert np.abs(x.grad.numpy() - want_grad).max() <= 1e-11 * scale
    assert np.abs(torch.func.grad(mse)(u0).numpy() - want_grad).max() <= 1e-11 * scale
