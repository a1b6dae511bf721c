"""Spectral (FFT pad/truncate) space transfer for periodic grids.

The counterpart of ``pysdc_tpu/transfer/space_fft.py`` (reference
``TransferMesh_FFT`` / ``TransferMesh_MPIFFT``, implementations/transfer_classes):
restriction truncates the Fourier spectrum to the coarse modes, prolongation
zero-pads it — spectrally exact for resolved fields.  The transforms are
cuFFT calls on the card and run in the field's own precision (a float32
field goes through complex64).
"""

from __future__ import annotations

import numpy as np
import torch

from pysdc_tpu_torch.core.device import complex_dtype
from pysdc_tpu_torch.core.errors import TransferError
from pysdc_tpu_torch.core.state import map_components


class FFTTransfer:
    """Works on problems whose trailing ``ndim_space`` axes are periodic
    grids (shape attributes define the sizes; leading component axes pass
    through untouched)."""

    def __init__(self, fine_prob, coarse_prob, params: dict):
        f_shape, c_shape = fine_prob.shape, coarse_prob.shape
        if len(f_shape) != len(c_shape):
            raise TransferError('fine and coarse problems need the same rank')
        # trailing axes that actually change are the spectral grid
        self.ndim_space = sum(1 for f, c in zip(f_shape, c_shape) if f != c) or len(f_shape)
        self.fine_shape = f_shape[-self.ndim_space:]
        self.coarse_shape = c_shape[-self.ndim_space:]
        for nf, nc in zip(self.fine_shape, self.coarse_shape):
            if nf % 2 or nc % 2:
                raise TransferError('FFT transfer needs even grid sizes')
        self.ratio = float(np.prod(self.fine_shape) / np.prod(self.coarse_shape))

    def _resample(self, x, target_shape):
        axes = tuple(range(x.dim() - self.ndim_space, x.dim()))
        x_hat = torch.fft.fftn(x.to(complex_dtype(x.dtype)), dim=axes, norm='forward')
        for ax, n_to in zip(axes, target_shape):
            n_from = x_hat.shape[ax]
            x_hat = torch.fft.fftshift(x_hat, dim=ax)
            if n_to < n_from:
                # window [-n_to/2, n_to/2); fold the +n_to/2 mode into the
                # -n_to/2 slot so the coarse Nyquist keeps both halves
                lo = (n_from - n_to) // 2
                first = x_hat.narrow(ax, lo, 1) + x_hat.narrow(ax, lo + n_to, 1)
                x_hat = torch.cat([first, x_hat.narrow(ax, lo + 1, n_to - 1)], dim=ax)
            elif n_to > n_from:
                # split the coarse Nyquist (-n_from/2) evenly onto +-n_from/2
                # to keep the padded spectrum Hermitian (real ifft)
                half = 0.5 * x_hat.narrow(ax, 0, 1)
                lo = (n_to - n_from) // 2

                def zeros(width):
                    shape = list(x_hat.shape)
                    shape[ax] = width
                    return x_hat.new_zeros(shape)

                x_hat = torch.cat(
                    [zeros(lo), half, x_hat.narrow(ax, 1, n_from - 1), half, zeros(n_to - n_from - lo - 1)], dim=ax
                )
            x_hat = torch.fft.ifftshift(x_hat, dim=ax)
        out = torch.fft.ifftn(x_hat, dim=axes, norm='forward')
        return out if x.is_complex() else out.real.contiguous()

    def restrict(self, F):
        return map_components(lambda leaf: self._resample(leaf, self.coarse_shape), F)

    def prolong(self, G):
        return map_components(lambda leaf: self._resample(leaf, self.fine_shape), G)
