"""LM architecture configuration (counterpart of
``repro/models/config.py``).

The fields are the reference's that change what the ported blocks and
the loss compute, and ``remat``, which steers memory only: training
recomputes each block's forward in the backward pass
(``torch.utils.checkpoint``) instead of keeping its activations. The
reference's fields that only steer XLA or sharding (``act_shard_seq``,
``act_spec``, ``scan_layers``, ``use_kernels``) have no counterpart: on
the card the port always launches its kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 2
    head_dim: int = 32
    d_ff: int = 512
    vocab_size: int = 256
    mlp_type: str = "swiglu"          # swiglu|geglu|gelu|squared_relu|none
    block_type: str = "dense"         # dense|moe|ssm|hybrid
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rotary_fraction: float = 1.0
    window: Optional[int] = None      # sliding-window attention
    # MoE
    num_experts: int = 0
    top_k: int = 1
    expert_d_ff: int = 0
    shared_experts: int = 0
    capacity_factor: float = 1.25
    router_type: str = "softmax"      # softmax|sigmoid
    moe_dispatch: str = "scatter"     # scatter|dense
    # SSM
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssd_chunk: int = 64
    # frontend stubs ([audio]/[vlm]: precomputed embeddings prepended)
    prefix_len: int = 0
    # numerics
    norm_eps: float = 1e-6
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # training: recompute each block in the backward pass; sequence
    # positions per chunk of the vocabulary cross-entropy
    remat: bool = True
    loss_chunk: int = 1024
    # provenance note (source + any deviations from the published config)
    source: str = ""

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def attn_active(self) -> bool:
        return self.block_type in ("dense", "moe", "hybrid")

    @property
    def ssm_active(self) -> bool:
        return self.block_type in ("ssm", "hybrid")

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM state or bounded window)."""
        return self.block_type == "ssm" or (
            self.block_type == "hybrid" and self.window is not None
        )

    def smoke(self) -> "LMConfig":
        """Reduced same-family config for CPU smoke tests (the
        reference's ``smoke()`` on the fields the port has)."""
        return dataclasses.replace(
            self,
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=128,
            num_experts=min(self.num_experts, 8),
            expert_d_ff=32 if self.num_experts else 0,
            top_k=min(self.top_k, 2),
            shared_experts=min(self.shared_experts, 1),
            ssm_state=min(self.ssm_state, 8),
            ssm_head_dim=16 if self.ssm_state else 64,
            window=min(self.window, 16) if self.window else None,
            prefix_len=min(self.prefix_len, 4),
            ssd_chunk=8,
            loss_chunk=32,
        )
