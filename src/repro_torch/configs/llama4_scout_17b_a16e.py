"""llama4-scout-17b-a16e [moe]: MoE, early fusion
(hf:meta-llama/Llama-4-Scout-17B-16E; unverified).

48L d_model=5120 40H (GQA kv=8) vocab=202048; 16 routed experts top-1
(sigmoid router gate) + 1 shared expert, expert d_ff=8192; SwiGLU. As in
the reference config: the text decoder only, with full attention in
every layer and a homogeneous MoE stack (the published model interleaves
chunked-attention layers and is natively multimodal).
"""

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="llama4-scout-17b-a16e",
    block_type="moe",
    mlp_type="swiglu",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=202048,
    num_experts=16,
    top_k=1,
    expert_d_ff=8192,
    shared_experts=1,
    router_type="sigmoid",
    rope_theta=500000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    loss_chunk=256,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (unverified tier)",
)
