"""Space-time transfers between levels (MLSDC, PFASST)."""

from pysdc_tpu_torch.transfer.base_transfer import BaseTransfer
from pysdc_tpu_torch.transfer.no_coarse import NoCoarseTransfer
from pysdc_tpu_torch.transfer.space_fft import FFTTransfer
from pysdc_tpu_torch.transfer.space_mesh import MeshTransfer

__all__ = ['BaseTransfer', 'MeshTransfer', 'FFTTransfer', 'NoCoarseTransfer']
