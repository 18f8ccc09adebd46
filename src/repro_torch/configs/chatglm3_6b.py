"""chatglm3-6b [dense]: 2d/partial RoPE, GQA (arXiv:2406.12793; hf).

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024; SwiGLU; QKV
bias; RoPE on half the head dims (rotary_fraction=0.5, the "RoPE 2d"
scheme).
"""

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="chatglm3-6b",
    block_type="dense",
    mlp_type="swiglu",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    qkv_bias=True,
    rotary_fraction=0.5,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    loss_chunk=512,
    source="arXiv:2406.12793 (hf tier)",
)
