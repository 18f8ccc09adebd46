"""nemotron-4-340b [dense]: GQA, squared-ReLU (arXiv:2402.16819; unverified).

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000; squared-ReLU
MLP (no gating); partial rotary (fraction 0.5, per the Nemotron
reports); head_dim 192. Its 336.3B parameters (673 GB in bf16) fit no
single card.
"""

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="nemotron-4-340b",
    block_type="dense",
    mlp_type="squared_relu",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    rotary_fraction=0.5,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    loss_chunk=256,
    source="arXiv:2402.16819 (unverified tier)",
)
