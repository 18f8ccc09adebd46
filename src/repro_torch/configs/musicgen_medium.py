"""musicgen-medium [audio]: a decoder over EnCodec tokens
(arXiv:2306.05284; hf).

48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048 (EnCodec codebook).
As in the reference config: the backbone only, 256 precomputed
conditioning embeddings (``prefix_len``) standing in for the
text-conditioning stream, with RoPE and prefix conditioning where the
published model has sinusoidal positions and cross-attention.
"""

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="musicgen-medium",
    block_type="dense",
    mlp_type="gelu",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    prefix_len=256,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    loss_chunk=1024,
    source="arXiv:2306.05284 (hf tier); RoPE + prefix conditioning stub",
)
