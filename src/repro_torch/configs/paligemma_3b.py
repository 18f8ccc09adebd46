"""paligemma-3b [vlm]: SigLIP + gemma (arXiv:2407.07726; hf).

Gemma-2b text backbone: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
(GeGLU) vocab=257216, head_dim 256. As in the reference config: the
SigLIP vision tower is a stub, 256 precomputed patch embeddings
(``prefix_len``) stand in for it, and attention stays causal over the
image prefix (the published model attends to it bidirectionally).
"""

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="paligemma-3b",
    block_type="dense",
    mlp_type="geglu",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    prefix_len=256,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    loss_chunk=256,
    source="arXiv:2407.07726 (hf tier); causal attn on image prefix",
)
