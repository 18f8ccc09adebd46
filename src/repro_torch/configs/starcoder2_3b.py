"""starcoder2-3b [dense]: GQA, RoPE (arXiv:2402.19173; hf).

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152; non-gated GELU
MLP, attention bias as in the HF config, rope_theta 1e5. As in the
reference config: full causal attention, as the 3b config has it.
"""

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="starcoder2-3b",
    block_type="dense",
    mlp_type="gelu",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    qkv_bias=True,
    rope_theta=100000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    loss_chunk=512,
    source="arXiv:2402.19173 (hf tier)",
)
