"""Particle/second-order problems: the state is a (pos, vel) pair of tensors.

The counterpart of ``pysdc_tpu/models/particles.py`` (reference particle
problems, ``implementations/problem_classes/``: HarmonicOscillator.py,
FermiPastaUlamTsingou.py, OuterSolarSystem.py, FullSolarSystem.py,
PenningTrap_3D.py, HenonHeiles.py, and the ``particles`` datatype,
datatype_classes/particles.py).  The RHS of a second-order problem is the
*acceleration* (the shape of ``vel``); the Penning trap's RHS is its fields
(:class:`EMFields`), which the Boris sweeper turns into accelerations with
``build_f``.  A :class:`Particles` value is a state, never an RHS container:
the second-order sweepers (``verlet``, ``boris``, ``rkn``) give their own
integral, residual and end point, so no ``f_total`` sums its two fields.

Problems and their constant tensors live on ``device`` (the card unless the
caller asks for the CPU).  The pairwise interactions (solar systems, the
Penning trap's ``(3, N, N)`` Coulomb sum) are dense tensor products there.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from pysdc_tpu_torch.core.problem import Problem, WorkCounter


class Particles(NamedTuple):
    """Second-order state: position + velocity (leaves of equal shape)."""

    pos: torch.Tensor
    vel: torch.Tensor


class EMFields(NamedTuple):
    """E and B fields per particle (the Boris sweeper's RHS container,
    reference datatype_classes/particles.py fields type)."""

    elec: torch.Tensor  # (3, N)
    magn: torch.Tensor  # (3, N)


def _shift_left(x):
    """``x`` moved one entry to the left along the last axis, a zero (the fixed boundary) entering on the right."""
    return torch.cat([x[..., 1:], torch.zeros_like(x[..., :1])], dim=-1)


def _pairwise_potential(prob, u: Particles):
    """Gravitational energy ``-G sum_{i<j} m_i m_j / r_ij`` of a ``(3, N)`` configuration."""
    N = u.pos.shape[-1]
    diff = u.pos[:, None, :] - u.pos[:, :, None]
    eye = torch.eye(N, dtype=u.pos.dtype, device=u.pos.device)
    r = torch.sqrt(torch.sum(diff**2, dim=0) + eye)
    mm = prob.masses[:, None] * prob.masses[None, :]
    return -prob.G * torch.sum(torch.triu(mm / r, diagonal=1))


class HarmonicOscillator(Problem):
    """x'' = -k x - mu x' (reference HarmonicOscillator.py)."""

    def __init__(self, k=1.0, mu=0.0, u0=(1.0, 0.0), phase=0.0, amp=1.0, dtype=None, device='cuda'):
        super().__init__(shape=(1,), dtype=dtype, device=device)
        self._register(k=k, mu=mu, u0=u0, phase=phase, amp=amp)
        self.work_counters['rhs'] = WorkCounter()

    def _full(self, value):
        return torch.full((1,), float(value), dtype=self.dtype, device=self.device)

    @property
    def u_init(self):
        return Particles(pos=self._full(self.u0[0]), vel=self._full(self.u0[1]))

    def eval_f(self, u: Particles, t):
        return -self.k * u.pos - self.mu * u.vel

    def u_exact(self, t, u_init=None, t_init=0.0):
        """Closed-form damped oscillator (reference HarmonicOscillator.py:80+)."""
        k, mu, t = self.k, self.mu, float(t)
        delta = mu / 2.0
        omega = np.sqrt(k)
        x0, v0 = self.u0
        if delta == 0:
            pos = x0 * np.cos(omega * t) + v0 / omega * np.sin(omega * t)
            vel = -x0 * omega * np.sin(omega * t) + v0 * np.cos(omega * t)
        elif delta < omega:  # underdamped
            om = np.sqrt(omega**2 - delta**2)
            A = x0
            B = (v0 + delta * x0) / om
            e = np.exp(-delta * t)
            pos = e * (A * np.cos(om * t) + B * np.sin(om * t))
            vel = e * ((-delta * A + om * B) * np.cos(om * t) + (-delta * B - om * A) * np.sin(om * t))
        else:
            raise NotImplementedError('only undamped/underdamped closed forms implemented')
        return Particles(pos=self._full(pos), vel=self._full(vel))

    def eval_hamiltonian(self, u: Particles):
        return 0.5 * torch.sum(u.vel**2) + 0.5 * self.k * torch.sum(u.pos**2)


class FermiPastaUlamTsingou(Problem):
    """FPUT chain with quartic coupling (reference FermiPastaUlamTsingou.py):
    x_i'' = (x_{i+1} - 2 x_i + x_{i-1}) + alpha*((x_{i+1}-x_i)^2 - (x_i-x_{i-1})^2)."""

    def __init__(self, npart=2048, alpha=0.25, k=1.0, energy_modes=(1,), dtype=None, device='cuda'):
        super().__init__(shape=(npart,), dtype=dtype, device=device)
        self._register(npart=npart, alpha=alpha, k=k, energy_modes=tuple(energy_modes))
        self.work_counters['rhs'] = WorkCounter()

    @property
    def u_init(self):
        return self.u_exact(0.0)

    def eval_f(self, u: Particles, t):
        x = u.pos
        # fixed (zero) boundaries
        xp = _shift_left(x)
        xm = torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)
        dr = xp - x
        dl = x - xm
        return (dr - dl) + self.alpha * (dr**2 - dl**2)

    def u_exact(self, t, u_init=None, t_init=0.0):
        if float(t) != 0.0:
            raise NotImplementedError('u_exact only implemented for t=0')
        n = self.npart
        i = torch.arange(1, n + 1, dtype=torch.float64, device=self.device)
        pos = torch.sin(math.pi * i / (n + 1)) * 0.0
        vel = math.sqrt(2.0 / (n + 1)) * torch.sin(math.pi * i / (n + 1))
        return Particles(pos=pos.to(self.dtype), vel=vel.to(self.dtype))

    def eval_hamiltonian(self, u: Particles):
        x = u.pos
        dr = _shift_left(x) - x
        d0 = x[0]  # left boundary spring
        ham = 0.5 * torch.sum(u.vel**2)
        ham = ham + torch.sum(0.5 * dr**2 + self.alpha / 3.0 * dr**3)
        return ham + 0.5 * d0**2 + self.alpha / 3.0 * d0**3


_OUTER_POS = [
    [0.0, 0.0, 0.0],
    [-3.5025653, -3.8169847, -1.5507963],
    [9.0755314, -3.0458353, -1.6483708],
    [8.3101420, -16.2901086, -7.2521278],
    [11.4707666, -25.7294829, -10.8169456],
    [-15.5387357, -25.2225594, -3.1902382],
]
_OUTER_VEL = [
    [0.0, 0.0, 0.0],
    [0.00565429, -0.00412490, -0.00190589],
    [0.00168318, 0.00483525, 0.00192462],
    [0.00354178, 0.00137102, 0.00055029],
    [0.00288930, 0.00114527, 0.00039677],
    [0.00276725, -0.0017072, -0.00136504],
]


class OuterSolarSystem(Problem):
    """Six-body outer solar system (reference OuterSolarSystem.py): sun,
    Jupiter, Saturn, Uranus, Neptune, Pluto; standard astronomical data."""

    G = 2.95912208286e-4
    _masses = [1.00000597682, 0.000954786104043, 0.000285583733151, 4.37273164546e-5, 5.17759138449e-5,
               1.0 / 130000000.0]
    _pos, _vel = _OUTER_POS, _OUTER_VEL

    def __init__(self, sun_only=False, dtype=None, device='cuda'):
        super().__init__(shape=(3, len(self._masses)), dtype=dtype, device=device)
        self._register(sun_only=sun_only)
        self.masses = torch.as_tensor(self._masses, dtype=torch.float64, device=self.device)
        self.work_counters['rhs'] = WorkCounter()

    def eval_f(self, u: Particles, t):
        """Pairwise gravitational accelerations, fully vectorized."""
        pos = u.pos  # (3, N)
        N = pos.shape[1]
        if self.sun_only:
            # acceleration of body i due to the sun only
            diff_sun = pos[:, :1] - pos  # (3, N)
            r2s = torch.sum(diff_sun**2, dim=0)
            r2s = torch.where(r2s == 0, torch.ones_like(r2s), r2s)
            acc = self.G * self.masses[0] * diff_sun / r2s**1.5
            return torch.cat([torch.zeros_like(acc[:, :1]), acc[:, 1:]], dim=1)
        diff = pos[:, None, :] - pos[:, :, None]  # (3, i, j): x_j - x_i
        eye = torch.eye(N, dtype=pos.dtype, device=pos.device)
        r2 = torch.sum(diff**2, dim=0) + eye
        inv_r3 = torch.where(eye.bool(), torch.zeros_like(r2), r2 ** (-1.5))
        return self.G * torch.einsum('j,dij->di', self.masses.to(pos.dtype), diff * inv_r3[None])

    def u_exact(self, t, u_init=None, t_init=0.0):
        if float(t) != 0.0:
            raise NotImplementedError('u_exact only works for the initial time t0=0')
        pos = torch.as_tensor(np.array(self._pos).T, dtype=self.dtype, device=self.device)
        vel = torch.as_tensor(np.array(self._vel).T, dtype=self.dtype, device=self.device)
        return Particles(pos=pos, vel=vel)

    def eval_hamiltonian(self, u: Particles):
        kin = 0.5 * torch.sum(self.masses * torch.sum(u.vel**2, dim=0))
        return kin + _pairwise_potential(self, u)


class FullSolarSystem(OuterSolarSystem):
    """Ten-body solar system (reference FullSolarSystem.py): the outer solar
    system plus the four inner planets; initial data from the reference."""

    # masses relative to the sun (standard astronomical values): sun (+ inner dust), Mercury, Venus, Earth+Moon,
    # Mars, then the outer planets
    _masses = [1.00000597682, 1.0 / 6023600.0, 1.0 / 408523.5, 1.0 / 328900.5, 1.0 / 3098710.0] + \
        OuterSolarSystem._masses[1:]
    # heliocentric positions [AU] and velocities [AU/day] (J2000-like data)
    _pos = [_OUTER_POS[0], [-0.1302, -0.4473, -0.0246], [-0.7183, -0.0327, 0.0410], [-0.1842, 0.9645, 0.0000],
            [1.3835, -0.0162, -0.0342]] + _OUTER_POS[1:]
    _vel = [_OUTER_VEL[0], [0.02145, -0.00614, -0.00246], [0.00080, -0.02031, -0.00033], [-0.01720, -0.00329, 0.0000],
            [0.00067, 0.01513, 0.00031]] + _OUTER_VEL[1:]


class PenningTrap3D(Problem):
    """Charged particles in a Penning trap (reference PenningTrap_3D.py):
    external quadrupole E field + axial B field + smoothed pairwise Coulomb
    interactions.  Used with the Boris SDC sweeper.  Fields and particle
    states are ``(3, N)``; ``build_f`` and ``boris_solver`` also take a
    leading batch axis (the nodes)."""

    def __init__(self, omega_B=25.0, omega_E=4.9, u0=None, nparts=1, sig=0.1, dtype=None, device='cuda'):
        super().__init__(shape=(3, nparts), dtype=dtype, device=device)
        u0 = u0 if u0 is not None else (np.array([10.0, 0.0, 0.0]), np.array([100.0, 0.0, 100.0]), 1.0, 1.0)
        self._register(omega_B=omega_B, omega_E=omega_E, u0=u0, nparts=nparts, sig=sig)
        self.q = torch.full((nparts,), float(u0[2]), dtype=self.dtype, device=self.device)
        self.m = torch.full((nparts,), float(u0[3]), dtype=self.dtype, device=self.device)
        self._Emat = torch.diag(torch.as_tensor([1.0, 1.0, -2.0], dtype=self.dtype, device=self.device))
        self._off_diagonal = 1.0 - torch.eye(nparts, dtype=self.dtype, device=self.device)
        self.work_counters['rhs'] = WorkCounter()
        self.work_counters['Boris_solver'] = WorkCounter()

    def _interactions(self, pos):
        """Smoothed pairwise Coulomb field (reference fast_interactions): the ``(3, N, N)`` sum on the device."""
        diff = pos[:, :, None] - pos[:, None, :]  # (3, i, j) = x_i - x_j
        dist2 = torch.sum(diff**2, dim=0) + self.sig**2
        w = self.q[None, :] / dist2**1.5
        w = w * self._off_diagonal
        return torch.einsum('dij,ij->di', diff, w)

    def eval_f(self, part: Particles, t):
        alpha = self.q / self.m
        elec = self._interactions(part.pos) + self.omega_E**2 / alpha * (self._Emat @ part.pos)
        magn = torch.cat([torch.zeros_like(part.pos[:2]), torch.full_like(part.pos[2:], float(self.omega_B))])
        return EMFields(elec=elec, magn=magn)

    def build_f(self, f: EMFields, part: Particles, t):
        """Acceleration from fields: q/m (E + v x B) (reference :305-333)."""
        alpha = self.q / self.m
        return alpha * (f.elec + torch.linalg.cross(part.vel, f.magn, dim=-2))

    def boris_solver(self, c, dt, old_fields: EMFields, new_fields: EMFields, old_parts: Particles):
        """Boris rotation velocity update with the SDC c-term
        (reference :336-377), vectorized over particles."""
        alpha = self.q / self.m
        Emean = 0.5 * (old_fields.elec + new_fields.elec)
        c = c + dt / 2 * alpha * torch.linalg.cross(old_parts.vel, old_fields.magn - new_fields.magn, dim=-2)
        vm = old_parts.vel + dt / 2 * alpha * Emean + c / 2
        t_vec = dt / 2 * alpha * new_fields.magn
        s = 2 * t_vec / (1.0 + torch.sum(t_vec**2, dim=-2))
        vp = vm + torch.linalg.cross(vm + torch.linalg.cross(vm, t_vec, dim=-2), s, dim=-2)
        return vp + dt / 2 * alpha * Emean + c / 2

    def u_exact(self, t, u_init=None, t_init=0.0):
        """Analytic single-particle trajectory (reference :252-303)."""
        if self.nparts != 1:
            raise NotImplementedError('u_exact is only valid for a single particle')
        t = float(t)
        wE, wB = self.omega_E, self.omega_B
        p0, v0 = np.asarray(self.u0[0]), np.asarray(self.u0[1])
        wbar = np.sqrt(2) * wE
        pos_z = p0[2] * np.cos(wbar * t) + v0[2] / wbar * np.sin(wbar * t)
        vel_z = -p0[2] * wbar * np.sin(wbar * t) + v0[2] * np.cos(wbar * t)
        Op = 0.5 * (wB + np.sqrt(wB**2 - 4 * wE**2))
        Om = 0.5 * (wB - np.sqrt(wB**2 - 4 * wE**2))
        Rm = (Op * p0[0] + v0[1]) / (Op - Om)
        Rp = p0[0] - Rm
        Im = (Op * p0[1] - v0[0]) / (Op - Om)
        Ip = p0[1] - Im
        w = (Rp + Ip * 1j) * np.exp(-Op * t * 1j) + (Rm + Im * 1j) * np.exp(-Om * t * 1j)
        dw = -1j * Op * (Rp + Ip * 1j) * np.exp(-Op * t * 1j) - 1j * Om * (Rm + Im * 1j) * np.exp(-Om * t * 1j)
        pos = torch.as_tensor(np.stack([np.real(w), np.imag(w), pos_z])[:, None], dtype=self.dtype, device=self.device)
        vel = torch.as_tensor(np.stack([np.real(dw), np.imag(dw), vel_z])[:, None], dtype=self.dtype,
                              device=self.device)
        return Particles(pos=pos, vel=vel)


class HenonHeiles(Problem):
    """Henon-Heiles chaotic Hamiltonian system (reference HenonHeiles.py):
    x'' = -x - 2 x y, y'' = -y - (x^2 - y^2)."""

    def __init__(self, dtype=None, device='cuda'):
        super().__init__(shape=(2,), dtype=dtype, device=device)
        self.work_counters['rhs'] = WorkCounter()

    @property
    def u_init(self):
        return self.u_exact(0.0)

    def eval_f(self, u: Particles, t):
        x, y = u.pos[0], u.pos[1]
        return torch.stack([-x - 2 * x * y, -y - (x**2 - y**2)])

    def u_exact(self, t, u_init=None, t_init=0.0):
        if float(t) != 0.0:
            raise NotImplementedError('initial condition only')
        q1 = 0.1
        p0 = np.sqrt(2 * (1 / 12.0 - 0.5 * q1**2 + q1**3 / 3.0))  # H = 1/12 shell
        return Particles(pos=torch.as_tensor([0.0, q1], dtype=self.dtype, device=self.device),
                         vel=torch.as_tensor([p0, 0.0], dtype=self.dtype, device=self.device))

    def eval_hamiltonian(self, u: Particles):
        x, y = u.pos[0], u.pos[1]
        return 0.5 * torch.sum(u.vel**2) + 0.5 * (x**2 + y**2) + x**2 * y - y**3 / 3.0
