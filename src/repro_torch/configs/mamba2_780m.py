"""mamba2-780m [ssm]: SSD, attention-free (arXiv:2405.21060; unverified).

48L d_model=1536, d_ff=0 (the Mamba blocks carry their own expansion),
vocab=50280, ssm_state=128. d_inner = 2*1536 = 3072 at head_dim 64: 48
SSD heads. Its state N=128 is above what the tensor-core SSD kernel
takes, so its intra-chunk pass runs on the CUDA-core kernel
(``kernels/ssd/ssd.py::route``).
"""

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="mamba2-780m",
    block_type="ssm",
    mlp_type="none",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssd_chunk=128,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    loss_chunk=512,
    source="arXiv:2405.21060 (unverified tier)",
)
