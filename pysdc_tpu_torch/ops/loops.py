"""The masked loop: the port's ``lax.while_loop`` for its Krylov and Newton iterations.

The JAX package runs every iterative solve (CG, PCG, GMRES, the Newton loops,
the refinement of a prepared factorization) as a ``lax.while_loop`` on the
device.  PyTorch has no device loop, and a Python loop whose condition is a
device value reads the host once an iteration: the card drains its queue and
waits for the host's next launch each time.  :func:`masked_loop` keeps the
loop's stopping test on the device instead:

- every independent system (one flag per entry of the leading batch axes, a
  0-d flag for one system) carries a device flag ``active`` and a device
  counter that advances only while it is set;
- an iteration is computed for every system and kept only where ``active``
  (``torch.where``): a masked iteration leaves the carry exactly as it was, so
  the result and the counts equal, bit for bit, those of a loop that reads
  every iteration (what ``jax.vmap`` of ``lax.while_loop`` does per system);
- eager, the loop reads the flags and the counters on the host once every
  :data:`READ_EVERY` iterations, stacked into one tensor, one read: a loop of
  ``k`` iterations reads ``ceil(k / READ_EVERY) + 1`` times;
- while a CUDA graph is being captured the loop never reads: it becomes a
  device ``while`` (:func:`pysdc_tpu_torch.ops.graph_loop.device_while`, a
  conditional WHILE node) whose condition is ``flags.any()``.  Each replay
  runs exactly the iterations the eager loop would compute with a read every
  iteration, stops at ``maxiter`` as eager and ``lax.while_loop`` do, and
  leaves the same carry and counts; a loop inside the body (Newton's PCG, a
  GMRES restart's Arnoldi steps) becomes a node of the body's graph;
- on a carry that ``torch.func.vmap`` maps (a value of a mapped tensor
  cannot be read) the loop reads nothing either and runs all ``maxiter``
  iterations, masked per lane: each lane ends with the count and the carry
  it would have had alone, as under ``jax.vmap`` of ``lax.while_loop``.
  Under ``grad`` or ``jvp`` alone it reads as it does eager.

A body is called once under a capture and its launches replayed: it may not
branch on a host counter of its own.  State that changes from one iteration to
the next (PCG's first-iteration test, GMRES's Arnoldi index) is carried on the
device, as in the JAX package's loops.

``READ_EVERY`` is 1, by measurement (``chip_smoke.py``, phase "implicit
times", on an NVIDIA H100 80GB HBM3 at 700 W): eager, a sweep of the fully
implicit Allen-Cahn path is bound by the host's kernel launches, about 100 a
PCG iteration (some 1 ms of the host's time), not by its reads.  A blocking
read costs the card only the wait for the next launch, while every iteration
computed past the stop costs a whole iteration's launches.  Reading every
second iteration gained nothing in three calls of 10 alternating pairs each:
the implicit sweep at 1024^2 went to a read every iteration in 8, 6 and 4
pairs (medians within 2%), at 128^2 in 7, 8 and 7, and the sparse sweep at
1024^2 in 10 of 10 each time (4 PCG iterations computed a sweep against 8).
What the
masked loop takes out is every read inside a CUDA graph (the fused lanes run
these solves with none), and it gives a batch of systems their own flags.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pysdc_tpu_torch.ops.graph_loop import device_while
from pysdc_tpu_torch.ops.kernels.build import mapped

#: iterations between two host reads of an eager loop (the module docstring says why 1)
READ_EVERY = 1


class LoopResult(NamedTuple):
    carry: tuple  #: the final carry
    counts: torch.Tensor  #: int32, one per system: the iterations each ran (on the device)
    host_counts: list | None  #: the same as host integers (None under a capture, which reads nothing)
    reads: int  #: host reads this loop made (0 under a capture)
    #: iterations computed, masked ones included: min(maxiter, READ_EVERY * ceil(max count / READ_EVERY)) eager,
    #: the largest count under a capture (None on the card, where each replay's device decides it), maxiter under
    #: a vmap
    steps: int | None


def capturing(x: torch.Tensor) -> bool:
    """True while a CUDA graph is being captured on ``x``'s card: the masked loop then becomes a device
    ``while``.  The CPU tests patch this function to run that path's plain version."""
    return x.is_cuda and torch.cuda.is_current_stream_capturing()


def behind(flag: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``flag`` (over the leading batch axes of ``like``) shaped to broadcast against ``like``."""
    return flag.reshape(tuple(flag.shape) + (1,) * (like.dim() - flag.dim()))


def _select(active, new, old):
    if new is old:
        return old
    return torch.where(behind(active, new), new, old)


def masked_loop(body, cond, carry: tuple, maxiter: int, *, active=None) -> LoopResult:
    """``while cond(carry) and count < maxiter: carry = body(carry)``, one system per flag.

    ``body(carry, active)`` gives the next carry for every system (``active``
    are the current flags, for a nested loop to start from); ``cond(carry)``
    gives a bool tensor, one flag per system (the batch shape); every leaf of
    ``carry`` has that shape in front.  ``active`` (optional, the
    same shape) masks systems out from the start, as an enclosing loop's flags
    do.
    """
    carry = tuple(carry)
    flags = cond(carry)
    if active is not None:
        flags = flags & active
    if maxiter <= 0:
        flags = torch.zeros_like(flags)
    counts = torch.zeros(flags.shape, dtype=torch.int32, device=flags.device)

    def step(carry, flags, counts):
        new = body(carry, flags)
        carry = tuple(_select(flags, nw, old) for nw, old in zip(new, carry))
        counts = counts + flags.to(torch.int32)
        return carry, flags & cond(carry) & (counts < maxiter), counts

    if capturing(flags):
        def trip(state):
            carry, flags, counts = step(state[:-2], state[-2], state[-1])
            return carry + (flags, counts)

        state, trips = device_while(lambda state: state[-2].any(), trip, carry + (flags, counts))
        return LoopResult(state[:-2], state[-1], None, 0, trips)
    if any(mapped(x) for x in (flags,) + carry if isinstance(x, torch.Tensor)):
        for _ in range(int(maxiter)):  # the values cannot be read: every iteration, masked per lane
            carry, flags, counts = step(carry, flags, counts)
        return LoopResult(carry, counts, None, 0, int(maxiter))
    reads = 0
    i = 0
    while True:
        if i % READ_EVERY == 0 or i == maxiter:
            # one read: "is any system still active" and every counter
            got = torch.cat([flags.any().reshape(1).to(torch.int32), counts.reshape(-1)]).tolist()
            reads += 1
            host_counts = got[1:]
            if not got[0] or i == maxiter:
                break
        carry, flags, counts = step(carry, flags, counts)
        i += 1
    return LoopResult(carry, counts, host_counts, reads, i)
