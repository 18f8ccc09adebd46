"""Mamba-2 SSD (counterpart of ``repro.kernels.ssd``): the plain
versions (``ref``), the intra-chunk CUDA kernel's wrapper (``ssd``) and
the entry points ``ops.ssd`` and ``ops.ssd_decode_step``."""
