"""Flash attention (counterpart of ``repro.kernels.flash_attention``):
the plain version (``ref``), the CUDA kernel's wrapper
(``flash_attention``) and the entry point ``ops.mha``."""
