"""A device ``while`` loop inside a CUDA graph capture: the port's ``lax.while_loop``.

The JAX package runs its iterative solves as ``lax.while_loop``: the device
decides the trip count.  A CUDA graph holds such a loop as a conditional WHILE
node (CUDA 12.3+, ``pysdc_tpu_torch/csrc/graph_loop.cu``).
:func:`device_while` builds one into the graph being captured:

- the carry is cloned into buffers made before the node, on the capturing
  stream: a body graph's addresses are fixed, so the loop-carried state lives
  in buffers that every trip reads and writes again;
- the flag of the first trip is computed from those buffers and a one-thread
  kernel hands it to the node's handle, upstream of the node, so a loop whose
  work is done runs zero trips;
- the body is captured ONCE, on a body stream of its own (one per nesting
  depth and device, made once), into the node's body graph.  Its allocations
  are routed into a private memory pool of that depth (``torch``'s
  ``_cuda_beginAllocateCurrentStreamToPool``); the body ends by copying the
  new carry into the very buffers it read (a result that is a view of a
  buffer is cloned first, so no buffer is overwritten before it is read),
  computing the next flag and handing it to the handle;
- a loop inside the body (a fused block's Newton solve, Newton's PCG, a
  GMRES restart's Arnoldi steps) becomes a conditional node of the body graph:
  its handle is created on the graph its enclosing stream captures into.  The
  body streams and pools of :data:`PREPARED_DEPTHS` nesting depths are made by
  :func:`prepare` before a capture; a loop nested deeper raises.

A body holds kernels and copies only: no event, no host read (``.item()``,
``bool`` of a tensor), no profiler range, no plan creation (cuFFT and cuBLAS
plans must exist before the capture: the fused lanes warm up first).  K1 and
K2 launch on the current stream, which is the body stream while the body is
captured.

Why private pools per depth and not the capturing graph's own pool: the
allocator ends routing by pool id, and the outer capture routes into its pool
for the whole capture; a second routing into the same pool would be ended
together with it.  A body's allocations die with its trip, and every body of
one depth is captured and replayed in stream order, so one pool per depth
serves every graph on its device.

The plain version, :func:`plain_while` (a tensor on the CPU), is a Python
loop that calls ``body`` while ``bool(flag_fn(carry))`` holds; the CPU
tests reach it by patching :func:`pysdc_tpu_torch.ops.loops.capturing`.  On a
CUDA tensor under a capture the node is built or the call raises: there is no
return to an unrolled loop.  ``device_while.nodes`` counts the nodes built.
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace

import torch

from pysdc_tpu_torch.ops.kernels.build import current_stream, load

#: the oldest runtime and driver with conditional WHILE graph nodes (1000 * major + 10 * minor)
MIN_CUDA_VERSION = 12030

#: nesting depths whose body streams and pools :func:`prepare` makes: the port's loops nest up to four deep (a fused
#: block's PFASST loop, a sparse Allen-Cahn Newton step in it, the Newton step's PCG and its preconditioner's CG).  A
#: capture may not make a stream, so a deeper loop raises by name
PREPARED_DEPTHS = 4


@functools.lru_cache(maxsize=None)
def _library() -> SimpleNamespace:
    """The graph-loop library with its argument types set, after the version check (built at first use)."""
    lib = load('graph_loop')
    lib.graph_loop_versions.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.graph_loop_begin_while.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.POINTER(ctypes.c_ulonglong)]
    lib.graph_loop_set_conditional.argtypes = [ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_void_p]
    lib.graph_loop_end_while.argtypes = [ctypes.c_void_p]
    lib.graph_loop_load.argtypes = []
    for fn in (lib.graph_loop_versions, lib.graph_loop_load, lib.graph_loop_begin_while,
               lib.graph_loop_set_conditional, lib.graph_loop_end_while):
        fn.restype = ctypes.c_int
    runtime, driver = ctypes.c_int(0), ctypes.c_int(0)
    _check(lib.graph_loop_versions(ctypes.byref(runtime), ctypes.byref(driver)), 'graph_loop_versions')
    if min(runtime.value, driver.value) < MIN_CUDA_VERSION:
        raise RuntimeError(f'device_while needs CUDA {MIN_CUDA_VERSION // 1000}.{MIN_CUDA_VERSION % 1000 // 10}+ '
                           f'(conditional WHILE graph nodes): runtime {runtime.value}, driver {driver.value}')
    _check(lib.graph_loop_load(), 'graph_loop_load')
    return SimpleNamespace(lib=lib, runtime=runtime.value, driver=driver.value)


def versions() -> tuple[int, int]:
    """``(runtime, driver)`` CUDA versions as the graph-loop library reads them (raises below 12.3)."""
    lib = _library()
    return lib.runtime, lib.driver


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f'device_while: {what} failed with CUDA error {err}')


@functools.lru_cache(maxsize=None)
def _depth_resources(device_index: int, depth: int) -> SimpleNamespace:
    """The body stream and the private memory pool of one nesting depth on one card, made once."""
    with torch.cuda.device(device_index):
        stream = torch.cuda.Stream(device=device_index)
    return SimpleNamespace(stream=stream, pool=torch.cuda.graph_pool_handle())


_depth = [0]  # loops being captured, nested


def prepare(device) -> None:
    """Build and load the library and make the body streams and pools of :data:`PREPARED_DEPTHS` nesting depths
    on ``device``'s card: call before a capture (a capture may not create them, and :func:`device_while` raises for
    a loop nested deeper)."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    _library()
    for depth in range(PREPARED_DEPTHS):
        _depth_resources(index, depth)


def _write_back(buffers, new) -> None:
    """Copy the body's results into the carry buffers; a result that shares storage with a buffer is cloned
    first, so that no buffer is overwritten before it has been read."""
    owned = {b.untyped_storage().data_ptr() for b in buffers}
    pairs = [(buf, x.clone() if x.untyped_storage().data_ptr() in owned else x)
             for buf, x in zip(buffers, new) if x is not buf]
    for buf, x in pairs:
        buf.copy_(x)


def plain_while(flag_fn, body, carry: tuple):
    """The plain version of :func:`device_while`: a Python loop that reads the flag each trip.  Returns ``(carry,
    trips)``."""
    carry = tuple(carry)
    steps = 0
    while bool(flag_fn(carry)):
        carry = tuple(body(carry))
        steps += 1
    return carry, steps


def device_while(flag_fn, body, carry: tuple):
    """``while flag_fn(carry): carry = body(carry)``, on the device under a CUDA graph capture.

    ``flag_fn(carry)`` gives a 0-d bool tensor; ``body(carry)`` a tuple of tensors shaped and typed like
    ``carry``.  Returns ``(carry, trips)``: the final carry (fresh buffers under a capture) and the number of
    trips, a host integer from the plain loop and ``None`` from a captured one (the device decides it at each
    replay).  A carry on the CPU runs :func:`plain_while`."""
    carry = tuple(carry)
    device = carry[0].device
    if device.type != 'cuda':
        return plain_while(flag_fn, body, carry)
    if not torch.cuda.is_current_stream_capturing():
        raise RuntimeError('device_while builds a conditional graph node: call it inside a CUDA graph capture')
    if _depth[0] >= PREPARED_DEPTHS:
        raise RuntimeError(f'device_while: a loop nested {_depth[0] + 1} deep; prepare() makes the body streams of '
                           f'{PREPARED_DEPTHS} depths (PREPARED_DEPTHS), and a capture may not make one')
    lib = _library().lib
    index = device.index if device.index is not None else torch.cuda.current_device()
    res = _depth_resources(index, _depth[0])
    buffers = tuple(x.clone() for x in carry)  # made before the node, on the capturing stream
    first = flag_fn(buffers).reshape(()).to(torch.bool).contiguous()
    handle = ctypes.c_ulonglong(0)
    _check(lib.graph_loop_begin_while(current_stream(index), res.stream.cuda_stream, first.data_ptr(),
                                      ctypes.byref(handle)), 'the WHILE node (graph_loop_begin_while)')
    _depth[0] += 1
    try:
        with torch.cuda.stream(res.stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(index, res.pool)
            try:
                _write_back(buffers, tuple(body(buffers)))
                again = flag_fn(buffers).reshape(()).to(torch.bool).contiguous()
                _check(lib.graph_loop_set_conditional(handle, again.data_ptr(), res.stream.cuda_stream),
                       'the body\'s flag (graph_loop_set_conditional)')
            finally:
                _check(lib.graph_loop_end_while(res.stream.cuda_stream), 'the body\'s capture (graph_loop_end_while)')
                torch._C._cuda_endAllocateToPool(index, res.pool)
    finally:
        _depth[0] -= 1
    device_while.nodes += 1
    return buffers, None


device_while.nodes = 0
