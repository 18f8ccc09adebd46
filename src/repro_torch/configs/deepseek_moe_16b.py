"""deepseek-moe-16b [moe]: fine-grained MoE (arXiv:2401.06066; hf).

28L d_model=2048 16H (kv=16) vocab=102400; 64 routed experts (top-6,
d_ff=1408 each) + 2 shared experts; SwiGLU; top-k gate renormalisation
per the paper. As in the reference config: a homogeneous MoE stack (the
published model's first layer is a dense FFN).
"""

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="deepseek-moe-16b",
    block_type="moe",
    mlp_type="swiglu",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=102400,
    num_experts=64,
    top_k=6,
    expert_d_ff=1408,
    shared_experts=2,
    router_type="softmax",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    loss_chunk=512,
    source="arXiv:2401.06066 (hf tier); uniform MoE stack",
)
