"""hymba-1.5b [hybrid]: parallel attention and Mamba-2 heads
(arXiv:2411.13676; hf).

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001 ssm_state=16;
every block runs attention heads and SSD heads in parallel on the same
input and averages their outputs. As in the reference config: a uniform
2048-token sliding window (the published model mixes 3 global-attention
layers among sliding-window layers) and no meta tokens (it adds 128).
"""

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="hymba-1.5b",
    block_type="hybrid",
    mlp_type="swiglu",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    window=2048,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssd_chunk=128,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    loss_chunk=512,
    source="arXiv:2411.13676 (hf tier); uniform SWA + no meta tokens",
)
