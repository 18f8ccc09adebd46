"""qwen1.5-32b [dense]: QKV bias (hf:Qwen/Qwen1.5 family; hf).

64L d_model=5120 40H (kv=40, MHA) d_ff=27392 vocab=152064; SwiGLU; QKV
bias; rope_theta 1e6.
"""

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="qwen1.5-32b",
    block_type="dense",
    mlp_type="swiglu",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    loss_chunk=512,
    source="hf:Qwen/Qwen1.5 family (hf tier)",
)
