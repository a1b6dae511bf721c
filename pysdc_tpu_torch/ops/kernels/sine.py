"""Kernels SINE: the exact shifted solve of a 2D order-2 Dirichlet operator, by hand in CUDA for Hopper.

``(I - f (cx D_x + A_y)) x = r`` over the trailing ``(nx, ny)`` axes of ``r``, one shift ``f`` for each leading
batch entry, where ``D_x = tridiag(1, -2, 1)`` along x and ``A_y = cy tridiag(1, -2, 1)`` along y with eigenvalues
``lam`` in the DST-I's mode order.  The y axis is transformed by the DST-I (a complex FFT of length ``ny + 1`` of
each row's odd extension, cuFFT on the card); each sine mode is then a tridiagonal system along x with constant
diagonals, solved by the Thomas recurrence; a second DST-I brings the solution back.  The kernels live in
``pysdc_tpu_torch/csrc/sine_solve.cu`` (its header says why and what bounds them); they replace no TPU kernel.  The
plain version (:func:`plain_solve`) takes the same steps in PyTorch, the sweep a Python loop over x.
:func:`dst_rows` is the DST-I alone, the same extension and split around one FFT: the sine transform of
``ops/linop.py``'s other sine solves and of its diagonal basis.

A tensor on the CPU takes the plain version; a CUDA tensor launches the kernels or raises.
``sine_solve_2d.launches`` counts the solves launched on the card (three kernels each), ``dst_rows.launches`` the
transforms (two kernels each).
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace

import torch

from pysdc_tpu_torch.ops.kernels.build import current_stream, differentiated, load, refuse_differentiated

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def odd_extension(x: torch.Tensor) -> torch.Tensor:
    """``(0, x_1..x_n, 0, -x_n..-x_1)`` along the last axis: ``2 (n + 1)`` values, whose interleaved pairs are the
    complex sequence that :func:`fft_rows` transforms."""
    zero = x.new_zeros(x.shape[:-1] + (1,))
    return torch.cat([zero, x, zero, -x.flip(-1)], dim=-1)


def fft_rows(v: torch.Tensor) -> torch.Tensor:
    """The complex FFT of length ``M`` of each row of ``v`` (``2 M`` reals) read as ``M`` interleaved complex
    values."""
    M = v.shape[-1] // 2
    return torch.fft.fft(torch.view_as_complex(v.reshape(v.shape[:-1] + (M, 2))), dim=-1)


def dst_coefficients(Z: torch.Tensor, cs: torch.Tensor, sn: torch.Tensor) -> torch.Tensor:
    """``X_k = sum_j x_j sin(pi j k / M)``, ``k = 1..M-1``, of each real row ``x`` whose odd extension gave the FFT
    row of ``Z`` (``M`` complex values): the split of a real FFT of length ``2 M`` into its even and odd halves, with
    ``a = Z_k``, ``b = Z_{M-k}`` and ``(cs, sn)`` the cosine and sine of ``pi k / M``."""
    a = Z[..., 1:]
    b = a.flip(-1)
    return 0.25 * ((a.real - b.real) * cs + (a.imag + b.imag) * sn - (a.imag - b.imag))


def tridiag_sweep(d: torch.Tensor, diag: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """The Thomas recurrence along axis -2 of ``d`` ``(B, nx, ny)``: each ``(b, k)`` column solves the tridiagonal
    system with constant diagonal ``diag[b, k]`` and off-diagonals ``off[b, k]`` (both broadcast to ``(B, ny)``)."""
    nx = d.shape[-2]
    out = torch.empty_like(d)
    cps = torch.empty_like(d)
    cp = dp = torch.zeros_like(d[:, 0])
    for i in range(nx):
        m = 1.0 / (diag - off * cp)
        cp = off * m
        dp = (d[:, i] - off * dp) * m
        cps[:, i] = cp
        out[:, i] = dp
    x = torch.zeros_like(d[:, 0])
    for i in range(nx - 1, -1, -1):
        x = out[:, i] - cps[:, i] * x
        out[:, i] = x
    return out


def _systems(fac, scale: float, cx: float, lam: torch.Tensor, nb: int):
    """The diagonal and off-diagonal of each ``(b, k)`` system, ``(nb, ny)`` and ``(nb, 1)``."""
    f = (fac.reshape(nb, 1) if torch.is_tensor(fac) else fac) * scale
    return 1.0 - f * (lam - 2.0 * cx), -f * cx * torch.ones_like(lam[:1])


def plain_solve(rhs: torch.Tensor, fac, scale: float, cx: float, lam, cs, sn) -> torch.Tensor:
    """The plain version of :func:`sine_solve_2d`, on ``rhs`` ``(B, nx, ny)``: the same steps in PyTorch."""
    nb, _, ny = rhs.shape
    diag, off = _systems(fac, scale, cx, lam, nb)
    d = dst_coefficients(fft_rows(odd_extension(rhs)), cs, sn)
    w = tridiag_sweep(d, diag, off)
    return (2.0 / (ny + 1)) * dst_coefficients(fft_rows(odd_extension(w)), cs, sn)


@functools.lru_cache(maxsize=None)
def _library(device_index: int) -> SimpleNamespace:
    """The library with its argument types set (built at first use, never at import)."""
    lib = load('sine_solve')
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.sine_extend_launch.argtypes = [i32, ptr, ptr, i32, i32, ptr]
    lib.sine_thomas_launch.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr, f64, f64, f64, i32, i32, i32, ptr]
    lib.sine_post_launch.argtypes = [i32, ptr, ptr, ptr, ptr, f64, i32, i32, ptr]
    for fn in (lib.sine_extend_launch, lib.sine_thomas_launch, lib.sine_post_launch):
        fn.restype = i32
    return SimpleNamespace(extend=lib.sine_extend_launch, thomas=lib.sine_thomas_launch, post=lib.sine_post_launch)


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed with CUDA error {err}')


def _index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _tables(like: torch.Tensor, n: int, *tables) -> list:
    tables = [t.to(device=like.device, dtype=like.dtype) for t in tables]
    if any(t.shape != (n,) or not t.is_contiguous() for t in tables):
        raise ValueError(f'sine kernels: tables of shape {[tuple(t.shape) for t in tables]}, expected ({n},)')
    return tables


def dst_rows(x: torch.Tensor, cs: torch.Tensor, sn: torch.Tensor, scale: float) -> torch.Tensor:
    """``scale X_k`` with ``X_k = sum_j x_j sin(pi j k / (n + 1))``, ``k = 1..n``, of each row of the real ``x``
    ``(..., n)``, in its precision; ``(cs, sn)`` ``(n,)`` the cosine and sine of ``pi k / (n + 1)``.  On a CUDA tensor
    the extension kernel, cuFFT of length ``n + 1`` and the split kernel; on the CPU, or where a gradient is asked of
    ``x``, the same steps in PyTorch."""
    if x.device.type != 'cuda' or x.dtype not in _DTYPE_CODES or differentiated(x) or x.numel() == 0:
        return scale * dst_coefficients(fft_rows(odd_extension(x)), cs, sn)
    n = x.shape[-1]
    rows = x.numel() // n
    if rows * 2 * (n + 1) >= 2**62 or rows >= 2**31 or n >= 2**30:
        raise ValueError(f'shape {tuple(x.shape)} exceeds the sine kernels\' limits')
    x = x.contiguous()
    index = _index(x)
    lib = _library(index)
    code = _DTYPE_CODES[x.dtype]
    cs, sn = _tables(x, n, cs, sn)
    with torch.cuda.device(index):
        stream = current_stream(index)
        v = torch.empty((rows, 2 * (n + 1)), dtype=x.dtype, device=x.device)
        _check('sine_extend', lib.extend(code, x.data_ptr(), v.data_ptr(), rows, n, stream))
        Z = fft_rows(v)
        out = torch.empty_like(x)
        _check('sine_post', lib.post(code, Z.data_ptr(), out.data_ptr(), cs.data_ptr(), sn.data_ptr(), scale, rows, n,
                                     stream))
    dst_rows.launches += 1
    return out


dst_rows.launches = 0


def _launch(rhs: torch.Tensor, fac, scale: float, cx: float, lam, cs, sn) -> torch.Tensor:
    nb, nx, ny = rhs.shape
    M = ny + 1
    if nb * nx * 2 * M >= 2**62 or max(nb * nx, nb * ny) >= 2**31 or ny >= 2**30:
        raise ValueError(f'shape {tuple(rhs.shape)} exceeds the sine kernels\' limits')
    index = _index(rhs)
    lib = _library(index)
    code = _DTYPE_CODES[rhs.dtype]
    lam, cs, sn = _tables(rhs, ny, lam, cs, sn)
    if torch.is_tensor(fac):
        fac = fac.to(device=rhs.device, dtype=rhs.dtype).expand(nb).contiguous()
        fac_ptr, fac0 = fac.data_ptr(), 0.0
    else:
        fac_ptr, fac0 = None, float(fac)
    with torch.cuda.device(index):
        stream = current_stream(index)
        v = torch.empty((nb * nx, 2 * M), dtype=rhs.dtype, device=rhs.device)
        _check('sine_extend', lib.extend(code, rhs.data_ptr(), v.data_ptr(), nb * nx, ny, stream))
        Z = fft_rows(v)
        # the sweep keeps its recurrences in v, which the first FFT has read, and leaves there the odd extension of
        # its result
        _check('sine_thomas', lib.thomas(code, Z.data_ptr(), v.data_ptr(), lam.data_ptr(), cs.data_ptr(),
                                         sn.data_ptr(), fac_ptr, fac0, scale, cx, nb, nx, ny, stream))
        Z = fft_rows(v)
        x = torch.empty_like(rhs)
        _check('sine_post', lib.post(code, Z.data_ptr(), x.data_ptr(), cs.data_ptr(), sn.data_ptr(), 2.0 / M, nb * nx,
                                     ny, stream))
    sine_solve_2d.launches += 1
    return x


def sine_solve_2d(rhs: torch.Tensor, fac, scale: float, cx: float, lam: torch.Tensor, cs: torch.Tensor,
                  sn: torch.Tensor) -> torch.Tensor:
    """``x`` with ``(I - fac scale (cx D_x + A_y)) x = rhs`` over ``rhs`` ``(B, nx, ny)``, real.

    ``fac`` is a number, or a real tensor of ``B`` shifts (one for each batch entry); ``lam`` ``(ny,)`` holds
    ``A_y``'s eigenvalues ``-4 cy sin^2(pi k / (2 (ny + 1)))`` and ``(cs, sn)`` ``(ny,)`` the cosine and sine of
    ``pi k / (ny + 1)``, ``k = 1..ny``.  Exact for any shift that leaves each mode's tridiagonal system symmetric
    positive definite (every ``fac scale >= 0``): the sweep does not pivot.  On a CUDA tensor the three kernels and
    two cuFFT transforms run; on a CPU tensor the plain version.  A CUDA tensor that a gradient is asked of raises."""
    if rhs.dim() != 3 or rhs.dtype not in _DTYPE_CODES:
        raise TypeError(f'sine_solve_2d takes a real (B, nx, ny) float32 or float64 tensor, got {rhs.dtype} '
                        f'{tuple(rhs.shape)}')
    if rhs.device.type == 'cpu':
        return plain_solve(rhs, fac, scale, cx, lam, cs, sn)
    if rhs.device.type != 'cuda':
        raise ValueError(f'sine_solve_2d runs on cuda or cpu tensors, got {rhs.device}')
    refuse_differentiated('sine_solve_2d', rhs)
    if torch.is_tensor(fac):
        refuse_differentiated('sine_solve_2d', fac)
    if rhs.numel() == 0:
        return torch.empty_like(rhs)
    return _launch(rhs.contiguous(), fac, scale, cx, lam, cs, sn)


sine_solve_2d.launches = 0
