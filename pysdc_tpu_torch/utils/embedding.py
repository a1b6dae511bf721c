"""Embed pysdc_tpu_torch integrators inside external frameworks.

The counterpart of ``pysdc_tpu/utils/embedding.py`` (reference Gusto
coupling, ``helpers/pySDC_as_gusto_time_discretization.py:35`` +
``problem_classes/GenericGusto.py``): an outer framework owns the time loop
and calls the integrator per step.  Two embeddings:

  - :class:`ControllerAsStepper` — host-side: wrap any controller as a
    ``(u, t) -> u`` stepper that an external Python or training loop calls;
    hook stats accumulate across calls as the reference's
    ``pySDC_integrator.stats`` does.
  - :func:`make_sdc_step_function` — device-side: a pure ``(u, t, dt) ->
    u_next`` SDC step built from the sweeper's protocol functions, which an
    external PyTorch program calls inside its own loop, differentiates with
    ``torch.autograd`` / ``torch.func.grad`` (``fixed_sweeps=k``) or maps
    with ``torch.func.vmap``.  On the card the operator applies go through
    kernel K1 in both directions: its ``autograd.Function`` launches the
    mirrored stencil for the adjoint (``ops/kernels/stencil.py``).
"""

from __future__ import annotations

from pysdc_tpu_torch.core.state import LevelState, components
from pysdc_tpu_torch.ops.loops import masked_loop
from pysdc_tpu_torch.utils.stats import get_sorted


def _leaves(state: LevelState) -> tuple:
    return (state.u,) + components(state.f) + (state.tau,)


def _rebuilt(like: LevelState, leaves) -> LevelState:
    f = type(like.f)(*leaves[1:-1]) if isinstance(like.f, tuple) else leaves[1]
    return LevelState(u=leaves[0], f=f, tau=leaves[-1])


def make_sdc_step_function(problem, sweeper, restol: float = 0.0, maxiter: int = 10,
                           residual_type: str = 'full_abs', fixed_sweeps: int | None = None):
    """Build a pure single-step SDC integrator ``step(u, t, dt) -> u_next``.

    Two iteration modes, as in the JAX package:

    - default: sweeps until the collocation residual drops below ``restol``
      or ``maxiter`` is hit, as a masked loop (``ops/loops.py``): one flag
      and one sweep count per system, so under ``torch.func.vmap`` each lane
      stops at its own count (the counterpart of ``jax.vmap`` over
      ``lax.while_loop``).  Eager it reads the residual's flag on the host
      once a sweep; mapped it reads nothing and runs ``maxiter`` masked sweeps.
    - ``fixed_sweeps=k``: exactly ``k`` sweeps of plain tensor operations,
      differentiable by ``torch.autograd`` and ``torch.func.grad`` (the
      counterpart of ``jax.grad`` over ``lax.scan``): the integrator can sit
      inside an outer optimization or adjoint loop.

    k-dependent preconditioners (MIN-SR-FLEX) support only the
    ``fixed_sweeps`` mode (the sweep index must be fixed).
    """
    if sweeper.k_dependent and fixed_sweeps is None:
        raise ValueError('k-dependent preconditioners need a static sweep count; '
                         'pass fixed_sweeps=... or use ControllerAsStepper')

    if fixed_sweeps is not None:
        def step(u, t, dt):
            state = sweeper.predict(problem, u, t, dt, 0.0)
            state = sweeper.update_nodes_k(problem, state, t, dt, fixed_sweeps)
            return sweeper.compute_end_point(state, t, dt)

        return step

    def step(u, t, dt):
        state = sweeper.predict(problem, u, t, dt, 0.0)
        _, res0 = sweeper.compute_residual(state, dt, residual_type)

        def body(carry, active):
            s = sweeper.update_nodes(problem, _rebuilt(state, carry[1:]), t, dt, 0)
            _, res = sweeper.compute_residual(s, dt, residual_type)
            return (res,) + _leaves(s)

        out = masked_loop(body, lambda carry: carry[0] > restol, (res0,) + _leaves(state), maxiter)
        return sweeper.compute_end_point(_rebuilt(state, out.carry[1:]), t, dt)

    return step


class ControllerAsStepper:
    """Wrap a pysdc_tpu_torch controller as an external-framework time stepper.

    Mirrors the reference's ``pySDC_integrator`` surface
    (pySDC_as_gusto_time_discretization.py:35-180): the outer framework owns
    the time loop and calls :meth:`apply` once per step; each call runs one
    controller block of ``n_steps`` substeps of size ``dt / n_steps`` and
    all hook stats accumulate in :attr:`stats` across calls.

    Parameters
    ----------
    controller_class: e.g. ``ControllerNonMPI`` / ``ShardedController``.
    description / controller_params: the usual setup dicts; the level dt
        is overwritten with ``dt / n_steps``.
    dt: outer step size the external framework will advance by.
    n_steps: substeps per apply (the reference's multi-step subcycling).
    """

    def __init__(self, controller_class, description, controller_params, dt,
                 n_steps: int = 1, **controller_kwargs):
        description = dict(description)
        description['level_params'] = {**description.get('level_params', {}),
                                       'dt': float(dt) / n_steps}
        self.dt = float(dt)
        self.n_steps = n_steps
        self.controller = controller_class(n_steps, controller_params, description,
                                           **controller_kwargs)
        self.stats = {}

    def apply(self, u, t):
        """Advance u from t to t + dt; accumulates hook stats."""
        uend, stats = self.controller.run(u, float(t), float(t) + self.dt)
        self.stats = {**self.stats, **stats}
        return uend

    def reached(self, t_target):
        """Last time actually reached (adaptive runs may re-cut steps):
        max over accumulated 'dt' stats, like the reference's LogTime hook."""
        entries = get_sorted(self.stats, type='dt', recomputed=False)
        if not entries:
            return None
        return max(t + float(v) for t, v in entries)
