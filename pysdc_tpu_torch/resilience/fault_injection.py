"""Soft-fault injection: flip bits in the solution during a run.

The counterpart of ``pysdc_tpu/resilience/fault_injection.py``; counterpart
of the reference Resilience project's ``FaultInjector``
(projects/Resilience/fault_injection.py:132-517): faults are specified (or
randomly drawn) as (time, level, iteration, node, position, bit) tuples; at
the matching hook point the chosen bit of the chosen solution entry is
flipped via an integer view of the float data.  Recovery strategies
(adaptivity-based restarts, Hot Rod detection, iterate-more) are exercised
in tests against injected faults.

Bits count from the most significant one, as in the JAX package: bit 0 is
the sign, bits 1-11 (float64) or 1-8 (float32) the exponent.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pysdc_tpu_torch.core.hooks import Hooks
from pysdc_tpu_torch.core.problem import count_work
from pysdc_tpu_torch.core.state import LevelState, map_components


@dataclass
class Fault:
    """One bitflip event (reference fault_injection.py:24-130)."""

    time: float = None
    timestep: int = None
    level_number: int = 0
    iteration: int = 1
    node: int = 1
    problem_pos: tuple = (0,)
    bit: int = 0
    happened: bool = False

    @classmethod
    def random(cls, args, rng: np.random.Generator, num_nodes: int, shape: tuple, bits: int = 64):
        return cls(
            time=args.get('time'),
            timestep=args.get('timestep'),
            level_number=0,
            iteration=int(rng.integers(1, args.get('max_iter', 5) + 1)),
            node=int(rng.integers(1, num_nodes + 1)),
            problem_pos=tuple(int(rng.integers(0, s)) for s in shape),
            bit=int(rng.integers(0, bits)),
        )


_INT_VIEWS = {torch.float64: (torch.int64, 64), torch.float32: (torch.int32, 32)}


def flip_bit(value: torch.Tensor, bit: int) -> torch.Tensor:
    """Flip one bit of a floating-point tensor via its integer view
    (reference fault_injection.py:452-517 uses struct pack/unpack).  Torch
    has no XOR on unsigned 64-bit integers, so the signed view takes the mask
    in two's complement (the sign bit of a float64 is ``-2**63``)."""
    if value.dtype not in _INT_VIEWS:
        raise NotImplementedError(f'bitflip not implemented for {value.dtype}')
    iview, bits = _INT_VIEWS[value.dtype]
    assert 0 <= bit < bits
    mask = 1 << (bits - 1 - bit)
    if mask >= 1 << (bits - 1):
        mask -= 1 << bits
    flipped = torch.bitwise_xor(value.view(iview), torch.tensor(mask, dtype=iview, device=value.device))
    return flipped.view(value.dtype)


def _replace_at(leaf, idx, new):
    """``leaf`` with entry ``idx`` replaced, as a new tensor (states are never written in place:
    ``StoreUOld`` and the extrapolation estimate keep the old ones)."""
    out = leaf.clone()
    out[idx] = new
    return out


class FaultInjector(Hooks):
    """Hook that flips a bit of ``u`` at the configured hook point.

    Faults trigger at (timestep index OR time) + iteration, right after the
    sweep of the configured node's level.
    """

    def __init__(self):
        super().__init__()
        self.faults: list[Fault] = []
        self.rng = np.random.default_rng(0)
        self._step_counter = 0

    def add_fault(self, fault: Fault):
        self.faults.append(fault)

    def add_random_fault(self, time=None, timestep=None, num_nodes=3, shape=(1,), bits=64, max_iter=5):
        self.add_fault(
            Fault.random(
                dict(time=time, timestep=timestep, max_iter=max_iter),
                self.rng,
                num_nodes,
                shape,
                bits=bits,
            )
        )
        return self.faults[-1]

    def pre_step(self, step, level_number):
        super().pre_step(step, level_number)
        self._step_counter += 1

    def post_sweep(self, step, level_number):
        super().post_sweep(step, level_number)
        L = step.levels[level_number]
        for f in self.faults:
            if f.happened or level_number != f.level_number:
                continue
            time_match = (
                (f.time is not None and abs(float(L.time) - f.time) < 1e-13)
                or (f.timestep is not None and self._step_counter == f.timestep)
            )
            if time_match and step.status.iter == f.iteration:
                u = L.state.u
                idx = (f.node,) + tuple(f.problem_pos)
                old = u[idx]
                new = flip_bit(old, f.bit)
                u_new = _replace_at(u, idx, new)
                # re-evaluate f at the corrupted node and refresh the
                # residual, else the fault heals silently (sweeps only read
                # old iterates through f) — reference fault_injection.py:286-297
                t_node = L.status.time + L.params.dt * L.sweep.coll.nodes[max(0, f.node - 1)]
                f_node = L.prob.eval_f(u_new[f.node], t_node)
                count_work(L.prob, 'rhs', 1)
                f_new = map_components(lambda leaf, comp: _replace_at(leaf, f.node, comp), L.state.f, f_node)
                L.state = LevelState(u=u_new, f=f_new, tau=L.state.tau)
                L.compute_residual()
                f.happened = True
                self.logger.info(
                    f'Flipped bit {f.bit} of u at node {f.node}, pos {f.problem_pos}: {old.item()} -> {new.item()}'
                )
                self.add_to_stats(
                    process=step.status.slot,
                    time=L.time,
                    level=level_number,
                    iter=step.status.iter,
                    sweep=L.status.sweep,
                    type='bitflip',
                    value=(f.node, f.problem_pos, f.bit),
                )
