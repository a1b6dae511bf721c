"""The two kernels of the port's dense LU, by hand in CUDA for Hopper.

Replace no TPU kernel: the JAX package's dense solves are ``jnp.linalg.solve``,
an LU with partial pivoting that XLA computes by itself.  The port's route for
512 rows and more (:func:`pysdc_tpu_torch.ops.linalg._getrf`) is LAPACK's
blocked right-looking ``getrf`` by blocks of 64 columns, and these kernels
(``pysdc_tpu_torch/csrc/dense_lu.cu``) do all of a block but its trailing
GEMM: no library call factors a tall panel, with its pivots searched down the
whole height, inside the body of a CUDA graph's conditional WHILE node.

- :func:`lu_panel` factors a ``(batch, m, w)`` view (``w <= 64``) in place in one
  launch, left-looking over sub-panels of :func:`panel_width` columns, and
  returns the row permutation it applied;
- :func:`lu_swap_trsm` applies that permutation to the block's rows in every
  other column of the matrix and solves ``L11 U12 = A12`` right of the panel.

One CTA of :func:`lu_panel` holds a sub-panel of at least one column, the
permutation and the row map in :data:`SMEM_BUDGET` of shared memory
(:func:`smem_bytes`), so the route takes at most 8,175 rows in complex128,
12,263 in float64 and complex64 and 16,351 in float32; a taller panel on the
card raises ``ValueError``.

One CTA of :func:`lu_swap_trsm` owns a range of tiles of :data:`SWAP_TILE`
columns of one matrix (:func:`swap_grid` sizes the range from the batch and the
card's SMs).  It loads ``L11`` once, by blocks of 8 x 8 with its diagonal blocks
inverted; then, for each tile, it copies the rows it must rewrite (right of the
panel the top ``jb`` rows and the moved rows below them, left of it the moved
rows: a closed set) straight from their source rows into shared memory, solves
``U12`` there by blocks of 8 rows on the FP64 tensor cores (the CUDA cores for
the float types), and writes each row once, while half of its warps write the
tile before and load the next.  Its bound counts each byte once: those rows read
and written, ``L11``'s strict lower triangle read once a matrix.  Shared memory:
:func:`swap_smem_bytes`.

A tensor on the CPU takes the plain versions, :func:`plain_panel` (LAPACK's
``getrf`` of the panel) and :func:`plain_swap_trsm` (a gather and
``torch.linalg.solve_triangular``); a CUDA tensor launches the kernel or
raises.  Each wrapper's ``launches`` counts its launches on the host; its
``device_count``, where a caller sets it to a 0-d int64 tensor on the card, gets
one added at each launch, on the launch's stream, so a replayed graph counts its
own launches.
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace

import torch

from pysdc_tpu_torch.ops.kernels.build import current_stream, load, refuse_differentiated

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.complex64: 2, torch.complex128: 3}

#: the panel's shared memory: the pivot candidates' scratch, a sub-panel (column-major, m + 1 a column), the
#: permutation and the row map
SCRATCH_BYTES = 384
#: the most shared memory a sub-panel may fill (one CTA an SM)
SMEM_BUDGET = 192 * 1024
#: the widest panel one launch factors (the route's block), and the widest sub-panel
MAX_WIDTH = 64
#: columns of a tile of :func:`lu_swap_trsm` (its warps that substitute take 8 each)
SWAP_TILE = 32
#: what sizes :func:`lu_swap_trsm`'s grid: threads a CTA, and an SM's threads and shared memory (an H100's 228 KiB,
#: of which each CTA's reservation takes 1 KiB)
THREADS, SM_THREADS, SM_SMEM_BYTES, CTA_RESERVED_BYTES = 256, 2048, 228 * 1024, 1024
#: the most shared memory one CTA may take
MAX_SMEM_BYTES = 232448


def smem_bytes(m: int, ws: int, itemsize: int) -> int:
    """Shared memory of one CTA of :func:`lu_panel` for ``m`` rows and sub-panels of ``ws`` columns (the library
    checks this formula when it loads)."""
    return SCRATCH_BYTES + ws * (m + 1) * itemsize + 8 * m


def swap_smem_bytes(rows: int, jb: int, itemsize: int) -> int:
    """Shared memory of one CTA of :func:`lu_swap_trsm`: a header and the lists of moved rows and their sources
    (ints), ``L11`` by blocks of 8 x 8 on and below the diagonal (64 entries each), and two buffers of a tile's rows
    (at most ``2 jb``), each row :data:`SWAP_TILE` entries and 32 bytes of padding."""
    cap, nb = min(2 * jb, rows), -(-jb // 8)
    ints = -(-(16 + 2 * cap + MAX_WIDTH) * 4 // 16) * 16
    return ints + nb * (nb + 1) // 2 * 64 * itemsize + 2 * cap * (SWAP_TILE + 32 // itemsize) * itemsize


def swap_grid(m: int, w: int, j: int, jb: int, batch: int, itemsize: int, sms: int) -> tuple[int, int, int, int]:
    """``(left, right, per_cta, ctas)`` of :func:`lu_swap_trsm` at block ``(j, jb)`` of a ``(batch, m, w)`` batch on a
    card of ``sms`` SMs: the tiles left and right of the panel (tile ``t < left`` holds columns ``32 t ..``, tile
    ``left + t`` columns ``j + jb + 32 t ..``, each up to the panel or ``w``), the tiles a CTA owns and the CTAs a
    matrix takes: as few CTAs a matrix (each reads ``L11``) as fill the card's resident CTAs, one at least."""
    left, right = -(-j // SWAP_TILE), -(-(w - j - jb) // SWAP_TILE)
    tiles = left + right
    if tiles == 0:
        return left, right, 0, 0
    per_sm = max(1, min(SM_THREADS // THREADS,
                        SM_SMEM_BYTES // (swap_smem_bytes(m - j, jb, itemsize) + CTA_RESERVED_BYTES)))
    per_cta = -(-tiles // min(tiles, -(-sms * per_sm // batch)))
    return left, right, per_cta, -(-tiles // per_cta)


def panel_width(m: int, itemsize: int) -> int:
    """The sub-panel width of ``m`` rows: the widest power of two up to :data:`MAX_WIDTH` that fits
    :data:`SMEM_BUDGET`."""
    w = MAX_WIDTH
    while w >= 1 and smem_bytes(m, w, itemsize) > SMEM_BUDGET:
        w //= 2
    if w < 1:
        raise ValueError(f'dense LU: a panel of {m} rows of {itemsize} bytes does not fit shared memory')
    return w


@functools.lru_cache(maxsize=None)
def _library() -> SimpleNamespace:
    """The library with its argument types set (built at first use, never at import), its shared-memory formulas
    and limits checked against this module's."""
    lib = load('dense_lu')
    lib.dense_lu_panel.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.dense_lu_swap_trsm.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p, ctypes.c_void_p]
    lib.dense_lu_panel.restype = lib.dense_lu_swap_trsm.restype = ctypes.c_int
    for name in ('dense_lu_smem_bytes', 'dense_lu_swap_smem_bytes'):
        getattr(lib, name).argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_longlong
    for m, w, itemsize in ((512, 16, 16), (1024, 8, 16), (600, 32, 8), (513, 64, 4), (64, 64, 16)):
        if lib.dense_lu_smem_bytes(m, w, itemsize) != smem_bytes(m, w, itemsize) \
                or lib.dense_lu_swap_smem_bytes(m, w, itemsize) != swap_smem_bytes(m, w, itemsize):
            raise RuntimeError('dense LU: the library and ops/kernels/dense_lu.py disagree on the shared memory')
    if lib.dense_lu_max_smem_bytes() != MAX_SMEM_BYTES or lib.dense_lu_max_width() != MAX_WIDTH \
            or lib.dense_lu_swap_tile() != SWAP_TILE or lib.dense_lu_threads() != THREADS:
        raise RuntimeError('dense LU: the library\'s limits are not those of ops/kernels/dense_lu.py')
    return SimpleNamespace(panel=lib.dense_lu_panel, swap_trsm=lib.dense_lu_swap_trsm)


def permutation(pivots: torch.Tensor, m: int) -> torch.Tensor:
    """LAPACK's pivots ``(batch, w)`` (1-based: row k was swapped with row ``pivots[k] - 1``, in order) as the
    permutation ``(batch, m)`` they make: row r of the result is row ``perm[r]`` of the input."""
    b, w = pivots.shape
    perm = torch.arange(m, device=pivots.device).expand(b, m).clone()
    rows = pivots.long() - 1
    for k in range(w):
        p = rows[:, k:k + 1]
        at_k = perm[:, k:k + 1].clone()
        perm[:, k:k + 1] = perm.gather(1, p)
        perm.scatter_(1, p, at_k)
    return perm


def plain_panel(panel: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`lu_panel`: LAPACK's ``getrf`` of the panel, written back in place."""
    LU, pivots, _ = torch.linalg.lu_factor_ex(panel)
    panel.copy_(LU)
    return permutation(pivots, panel.shape[-2])


def plain_swap_trsm(A: torch.Tensor, j: int, jb: int, rows: torch.Tensor) -> None:
    """The plain version of :func:`lu_swap_trsm`: the rows ``j..`` of each side of the panel gathered by ``rows``
    and copied back, then ``U12`` by ``torch.linalg.solve_triangular``."""
    index = rows.unsqueeze(-1)
    for side in (A[:, j:, :j], A[:, j:, j + jb:]):
        if side.shape[-1]:
            side.copy_(side.gather(1, index.expand(side.shape)))
    if j + jb < A.shape[-1]:
        A[:, j:j + jb, j + jb:] = torch.linalg.solve_triangular(A[:, j:j + jb, j:j + jb], A[:, j:j + jb, j + jb:],
                                                                upper=False, unitriangular=True)


def _counted(wrapper) -> None:
    wrapper.launches += 1
    if wrapper.device_count is not None:
        wrapper.device_count.add_(1)


def _launch(name: str, fn, device: torch.device, *args) -> None:
    """Call the library function ``fn`` for tensors on ``device`` with the device's current stream last."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    args = args + (current_stream(index),)
    if torch.cuda.current_device() == index:
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed with error {err}')


def _checked(name: str, A: torch.Tensor) -> bool:
    """True for a CUDA tensor the kernel ``name`` takes, False for a CPU tensor; raises on anything else."""
    if A.device.type == 'cpu':
        return False
    if A.device.type != 'cuda':
        raise ValueError(f'{name} runs on cuda or cpu tensors, got {A.device}')
    refuse_differentiated(name, A)
    if A.dtype not in _DTYPE_CODES:
        raise TypeError(f'{name} takes float32, float64, complex64 or complex128, got {A.dtype}')
    if A.dim() != 3 or A.stride(-1) != 1 or A.stride(-2) < A.shape[-1] or A.shape[0] < 1:
        raise ValueError(f'{name}: a {tuple(A.shape)} view of strides {A.stride()} is not one it takes')
    return True


def lu_panel(panel: torch.Tensor) -> torch.Tensor:
    """Factor ``panel`` (a ``(batch, m, w)`` view, ``w <= min(m, 64)``, rows of unit stride) in place with partial
    pivoting, as ``P panel = L U`` (L unit lower below the diagonal, U on and above it); returns the permutation
    ``(batch, m)`` int64: row r of the factored panel is row ``perm[r]`` of the panel given.  One launch for the
    whole batch; a CUDA tensor that a gradient is asked of raises (the kernel writes in place, outside autograd)."""
    if not _checked('lu_panel', panel):
        return plain_panel(panel)
    b, m, w = panel.shape
    ws = min(panel_width(m, panel.element_size()), w)
    if not 1 <= w <= min(m, MAX_WIDTH) or b >= 2**31 or min(2 * w, m) > ws * (m + 1):
        raise ValueError(f'lu_panel: a ({b}, {m}, {w}) {panel.dtype} panel exceeds the kernel limits')
    lib = _library()
    perm = torch.empty((b, m), dtype=torch.int64, device=panel.device)
    _launch('lu_panel', lib.panel, panel.device, _DTYPE_CODES[panel.dtype], panel.data_ptr(), panel.stride(0),
            panel.stride(1), m, w, ws, b, perm.data_ptr())
    _counted(lu_panel)
    return perm


def lu_swap_trsm(A: torch.Tensor, j: int, jb: int, rows: torch.Tensor) -> None:
    """For the block of columns ``j .. j + jb`` of ``A`` (a ``(batch, m, w)`` view, rows of unit stride) whose
    panel :func:`lu_panel` factored, with ``rows`` ``(batch, m - j)`` the permutation it returned: apply the
    permutation to the rows ``j..`` of every column outside the panel, and solve ``L11 U12 = A12`` in place right
    of it (``L11`` the panel's unit lower ``jb x jb`` top).  One launch for the whole batch, none where no column
    lies outside the panel; a CUDA tensor that a gradient is asked of raises."""
    if not _checked('lu_swap_trsm', A):
        return plain_swap_trsm(A, j, jb, rows)
    b, m, w = A.shape
    if not (0 <= j and 1 <= jb <= MAX_WIDTH and j + jb <= min(m, w)) or b > 65535:
        raise ValueError(f'lu_swap_trsm: block ({j}, {jb}) of a ({b}, {m}, {w}) batch exceeds the kernel limits')
    if rows.shape != (b, m - j) or rows.dtype != torch.int64 or rows.device != A.device or not rows.is_contiguous():
        raise ValueError(f'lu_swap_trsm: rows {tuple(rows.shape)} {rows.dtype} on {rows.device}, expected contiguous '
                         f'({b}, {m - j}) int64 on {A.device}')
    _, _, per_cta, ctas = swap_grid(m, w, j, jb, b, A.element_size(), _sms(A.device))
    if ctas == 0:
        return None
    _launch('lu_swap_trsm', _library().swap_trsm, A.device, _DTYPE_CODES[A.dtype], A.data_ptr(), A.stride(0),
            A.stride(1), m, w, j, jb, b, per_cta, rows.data_ptr())
    _counted(lu_swap_trsm)
    return None


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


lu_panel.launches = lu_swap_trsm.launches = 0
lu_panel.device_count = lu_swap_trsm.device_count = None
