"""Flash attention (counterpart of ``repro.kernels.flash_attention``):
the plain version (``ref``), the wrapper of the two CUDA kernels
(``flash_attention``: tensor cores for bf16 at D 64 and 128, CUDA cores
otherwise) and the entry point ``ops.mha``."""
