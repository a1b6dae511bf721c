"""The traffic generator: the initial states of the output intervals, made on the device from the seed.

A traffic file (``traffic/<name>.json``) names the kind of initial state (``initial``), its parameters and the
march's shape (``blocks_per_interval``, ``episode_blocks``).  Interval ``i`` of a run starts from:

- ``convection``: at the start of each episode (every ``episode_blocks // blocks_per_interval`` intervals) the
  conduction state with the configuration's seeded noise in ``T``, plus finite-amplitude convection rolls: a
  stream function ``psi = sum_m a_m sin(2 pi m x / Lx + phi_m) w(z)`` over the traffic's ``rolls.x_modes``, with
  ``w = (4 zeta (1 - zeta))^2`` (``zeta = (z - z0) / Lz``), so that ``u = psi_z``, ``v = -psi_x`` is divergence
  free and vanishes with ``psi_z`` at both walls, scaled to ``max(|u|, |v|) = rolls.velocity``; and a
  temperature perturbation ``sum_m b_m cos(2 pi m x / Lx + theta_m) sin(pi zeta)`` scaled to
  ``max = rolls.temperature``.  Otherwise where the interval before it ended;
- ``ensemble``: a new member each interval: ``sum_k a_k cos(2 pi (kx x + ky y) + phi_k)`` over every integer
  wavenumber ``k`` (one of each pair ``+-k``) with ``|k|^2`` in the traffic's ``k2`` band, amplitudes ``a``
  uniform in [0.5, 1] and phases uniform, drawn for the member's index (one inverse FFT).

The same seed gives the same states; each draw takes its own generator, seeded from ``(seed, kind, index)``, so
that the states do not depend on how many were drawn before.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.rbc2d import cheb_nodes, conduction_state


def _generator(seed: int, *key: int, device) -> torch.Generator:
    state = np.random.SeedSequence([int(seed) % 2**64, *key]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))


def episode_of(traffic: dict, interval: int):
    """(episode, is its first interval) of ``interval``."""
    per = max(1, traffic['episode_blocks'] // traffic['blocks_per_interval'])
    return interval // per, interval % per == 0


def band_modes(k2_min: int, k2_max: int) -> list[tuple[int, int]]:
    """The integer wavenumbers ``(kx, ky)`` with ``k2_min <= kx^2 + ky^2 <= k2_max``, one of each pair ``+-k``."""
    r = int(np.ceil(np.sqrt(k2_max)))
    return [(kx, ky) for kx in range(0, r + 1) for ky in range(-r, r + 1)
            if k2_min <= kx * kx + ky * ky <= k2_max and (kx > 0 or ky > 0)]


def _rolls(config: dict, rolls: dict, gen, device, dtype) -> torch.Tensor:
    """(4, nx, nz): the velocity of the rolls and their temperature perturbation (pressure 0)."""
    nx, nz, Lx, Lz, z0 = config['nx'], config['nz'], config['Lx'], config['Lz'], config['z0']
    m = torch.as_tensor(rolls['x_modes'], dtype=torch.float64, device=device)
    draws = torch.rand((4, len(m)), generator=gen, dtype=torch.float64, device=device)
    a, phi, b, theta = 0.5 + 0.5 * draws[0], 2 * np.pi * draws[1], 0.5 + 0.5 * draws[2], 2 * np.pi * draws[3]
    x = torch.arange(nx, dtype=torch.float64, device=device) * (Lx / nx)
    zeta = torch.as_tensor((cheb_nodes(nz) + 1) / 2, dtype=torch.float64, device=device)
    kx = 2 * np.pi * m / Lx
    arg = kx[:, None] * x[None, :] + phi[:, None]  # (modes, nx)
    w = (4 * zeta * (1 - zeta)) ** 2
    dw = 32 * zeta * (1 - zeta) * (1 - 2 * zeta) / Lz
    u = (a[:, None] * torch.sin(arg)).sum(0)[:, None] * dw[None, :]
    v = -(a[:, None] * kx[:, None] * torch.cos(arg)).sum(0)[:, None] * w[None, :]
    T = (b[:, None] * torch.cos(kx[:, None] * x[None, :] + theta[:, None])).sum(0)[:, None] \
        * torch.sin(np.pi * zeta)[None, :]
    scale = rolls['velocity'] / torch.maximum(u.abs().max(), v.abs().max())
    out = torch.zeros((4, nx, nz), dtype=torch.float64, device=device)
    out[0], out[1], out[2] = u * scale, v * scale, T * (rolls['temperature'] / T.abs().max())
    return out.to(dtype)


def initial_state(config: dict, traffic: dict, seed: int, index: int, device, dtype) -> torch.Tensor:
    """The seeded state that episode (``convection``) or member (``ensemble``) ``index`` starts from."""
    kind = traffic['initial']
    if kind == 'convection':
        gen = _generator(seed, 1, index, device=device)
        noise = torch.rand((config['nx'], config['nz']), generator=gen, dtype=dtype, device=device)
        return conduction_state(config, noise) + _rolls(config, traffic['rolls'], gen, device, dtype)
    if kind == 'ensemble':
        gen = _generator(seed, 2, index, device=device)
        n = config['nvars'][0][0]
        modes = band_modes(*traffic['k2'])
        amp = 0.5 + 0.5 * torch.rand(len(modes), generator=gen, dtype=torch.float64, device=device)
        phase = 2 * np.pi * torch.rand(len(modes), generator=gen, dtype=torch.float64, device=device)
        coef = torch.zeros((n, n), dtype=torch.complex128, device=device)
        kx, ky = (torch.as_tensor([k[d] % n for k in modes], device=device) for d in (0, 1))
        coef[kx, ky] = torch.complex((n * n) * amp * torch.cos(phase), (n * n) * amp * torch.sin(phase))
        return torch.fft.ifft2(coef).real.to(dtype)
    raise ValueError(f'unknown initial state {kind!r}')
