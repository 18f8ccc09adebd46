"""CausalLM: full-sequence forward, prefill, decode and the training
loss (counterpart of ``repro/models/lm.py``).

Layers are an ``nn.ModuleList`` of ``Block``s, one per layer, where the
reference stacks them under one scan. A cache is a list with one dict
per layer. In training (``cfg.remat``, gradients on) each block runs
under ``torch.utils.checkpoint``: only the residual stream between
blocks is kept, and the backward pass recomputes one block at a time,
as the reference's ``jax.checkpoint(..., nothing_saveable)``.

``lm_loss`` computes the vocabulary cross-entropy in sequence chunks of
``cfg.loss_chunk`` (each checkpointed), so the (B, S, V) float32 logits
are never held at once.

Prefix embeddings: with ``cfg.prefix_len`` set, ``embeds`` (B, P, D)
(precomputed frontend outputs, e.g. image patches) are cast to the
compute dtype and put before the token embeddings, and positions run over
the whole P + S. The loss is taken on the token positions only.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import blocks as BLK
from repro_torch.models.config import LMConfig
from repro_torch.models.layers import (embed, init_embedding, init_rmsnorm,
                                       rmsnorm, unembed)


class CausalLM(nn.Module):
    """Parameters drawn from ``gen`` on its device, in ``cfg.pdtype``
    (``a_log``, ``dt_bias`` and ``d_skip`` in float32, as in the
    reference)."""

    def __init__(self, cfg: LMConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.embed = init_embedding(gen, cfg.vocab_size, cfg.d_model, cfg.pdtype)
        self.blocks = nn.ModuleList(BLK.Block(gen, cfg) for _ in range(cfg.num_layers))
        self.final_norm = init_rmsnorm(cfg.d_model, cfg.pdtype, gen.device)

    def _inputs(self, tokens: torch.Tensor, embeds: torch.Tensor | None):
        """The input hidden states, ``embeds`` first where the config has
        a prefix and they are given (as the reference, which then takes
        tokens alone), and their positions 0..S_total-1."""
        x = embed(self.embed, tokens).to(self.cfg.cdtype)
        if self.cfg.prefix_len and embeds is not None:
            x = torch.cat([embeds.to(self.cfg.cdtype), x], dim=1)
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        return x, positions

    def forward_hidden(self, tokens: torch.Tensor,
                       embeds: torch.Tensor | None = None) -> torch.Tensor:
        """Final hidden states (B, S_total, D) of the full-sequence forward."""
        x, positions = self._inputs(tokens, embeds)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for i in range(self.cfg.num_layers):
            if remat:
                # the block draws no random numbers: no RNG state to keep
                x = checkpoint(self._block_train, i, x, positions,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = self._block_train(i, x, positions)
        return rmsnorm(self.final_norm, x, self.cfg.norm_eps)

    def _block_train(self, i: int, x: torch.Tensor, positions: torch.Tensor):
        """Block ``i``'s forward; recomputed whole in the backward pass
        under remat (the sharded trainer gathers the block's parameters
        here)."""
        return BLK.block_train(self.blocks[i], self.cfg, x, positions)

    def prefill(self, tokens: torch.Tensor, cache_len: int,
                embeds: torch.Tensor | None = None):
        """Returns (last-position float32 logits (B, V), cache). The
        cache holds the trailing ``cache_len`` positions of prefix and
        tokens, so a decode that follows needs prefix + prompt + gen."""
        x, positions = self._inputs(tokens, embeds)
        caches = []
        for blk in self.blocks:
            x, c = BLK.block_prefill(blk, self.cfg, x, positions, cache_len)
            caches.append(c)
        h = rmsnorm(self.final_norm, x[:, -1:], self.cfg.norm_eps)
        return unembed(self.embed, h)[:, 0], caches

    def decode_step(self, token: torch.Tensor, cache: list, fill: int):
        """One decode step for token (B,) with ``fill`` tokens already in
        the cache. Returns (float32 logits (B, V), new cache); raises
        once ``fill`` reaches the cache's length."""
        x = embed(self.embed, token[:, None]).to(self.cfg.cdtype)
        positions = torch.full((x.shape[0], 1), fill, dtype=torch.int32,
                               device=x.device)
        new_cache = []
        for blk, c in zip(self.blocks, cache):
            x, c = BLK.block_decode(blk, self.cfg, x, positions, c, fill)
            new_cache.append(c)
        h = rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        return unembed(self.embed, h)[:, 0], new_cache

    def init_cache(self, batch: int, cache_len: int) -> list:
        dev = self.embed.table.device
        return [BLK.init_cache(self.cfg, batch, cache_len, dev)
                for _ in range(self.cfg.num_layers)]


# -- training loss ---------------------------------------------------------------

def lm_loss_terms(model, tokens, targets, mask, embeds=None):
    """``lm_loss``'s numerator and denominator, both 0-d float32: the
    summed cross-entropy over the positions ``mask`` keeps, and their
    count. The sharded trainer sums both over the ranks that split the
    batch before it divides."""
    h = _GradDtypeBarrier.apply(model.forward_hidden(tokens, embeds))
    h = h[:, model.cfg.prefix_len:]  # loss on token positions only
    b, s, _ = h.shape
    chunk = _largest_divisor_leq(s, model.cfg.loss_chunk)
    mf = mask.float()
    losses, counts = [], []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        args = (model.embed, h[:, sl], targets[:, sl], mf[:, sl])
        if torch.is_grad_enabled():
            loss, count = checkpoint(_chunk_loss, *args, use_reentrant=False,
                                     preserve_rng_state=False)
        else:
            loss, count = _chunk_loss(*args)
        losses.append(loss)
        counts.append(count)
    return torch.stack(losses).sum(), torch.stack(counts).sum()


def _largest_divisor_leq(s: int, target: int) -> int:
    for c in range(min(target, s), 0, -1):
        if s % c == 0:
            return c
    return s


class _GradDtypeBarrier(torch.autograd.Function):
    """Identity whose gradient is cast back to the input's dtype (the
    reference's ``_grad_dtype_barrier``): the float32 logits' gradient
    reaches the bf16 hidden states, and the backward chain below them
    runs in the model's dtype. The identity in float32."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def _chunk_loss(table_p, hc, tc, mc):
    """Summed cross-entropy of one chunk and its mask count."""
    logits = unembed(table_p, hc)  # (B, c, V) float32
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, tc[..., None].long())[..., 0]
    return torch.sum((lse - ll) * mc), torch.sum(mc)


def lm_loss(model: CausalLM, tokens: torch.Tensor, targets: torch.Tensor,
            mask: torch.Tensor, embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Mean softmax cross-entropy over the positions ``mask`` keeps.
    tokens, targets, mask: (B, S); ``embeds`` (B, P, D), the prefix, whose
    positions take no loss. The vocabulary is reduced in
    ``_largest_divisor_leq(S, cfg.loss_chunk)``-position chunks, each
    recomputed in the backward pass, not stored. ``model`` may be any
    object with ``cfg``, ``embed`` and ``forward_hidden`` (the sharded
    trainer's ``train/sharding.py::ShardedLM``)."""
    total, count = lm_loss_terms(model, tokens, targets, mask, embeds)
    return total / torch.clamp_min(count, 1.0)


# -- logical axes (counterparts of ``abstract_axes`` and ``cache_axes``) ---------

# each parameter's logical axes, by its name within the model or a block
_LEAF_AXES = {
    "embed.table": ("vocab", "embed"),
    "final_norm.scale": ("embed",),
    "norm1.scale": ("embed",),
    "norm2.scale": ("embed",),
    "attn.wq": ("embed", "heads", "head_dim"),
    "attn.wk": ("embed", "kv_heads", "head_dim"),
    "attn.wv": ("embed", "kv_heads", "head_dim"),
    "attn.wo": ("heads", "head_dim", "embed"),
    "attn.bq": ("heads", "head_dim"),
    "attn.bk": ("kv_heads", "head_dim"),
    "attn.bv": ("kv_heads", "head_dim"),
    "ssm.in_proj": ("embed", "ssm_inner"),
    "ssm.conv_w": (None, "ssm_inner"),
    "ssm.conv_b": ("ssm_inner",),
    "ssm.a_log": ("ssm_heads",),
    "ssm.dt_bias": ("ssm_heads",),
    "ssm.d_skip": ("ssm_heads",),
    "ssm.out_proj": ("ssm_inner", "embed"),
    "ssm.norm.scale": ("embed",),
    "moe.router": ("embed", "experts"),
    "moe.wi": ("experts", "embed", "ffn"),
    "moe.wo": ("experts", "ffn", "embed"),
    "moe.shared.wi": ("embed", "ffn"),
    "moe.shared.wo": ("ffn", "embed"),
    "mlp.wi": ("embed", "ffn"),
    "mlp.wo": ("ffn", "embed"),
}


def block_shapes(cfg: LMConfig) -> dict[str, tuple[int, ...]]:
    """One block's parameter shapes by name within the block, in the
    order ``Block`` registers them, from the config alone."""
    from repro_torch.models.mlp import GATED
    from repro_torch.models.ssm import CONV_K, ssm_dims

    d = cfg.d_model
    out = {"norm1.scale": (d,)}
    if cfg.attn_active:
        hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        out.update({"attn.wq": (d, hq, dh), "attn.wk": (d, hkv, dh),
                    "attn.wv": (d, hkv, dh), "attn.wo": (hq, dh, d)})
        if cfg.qkv_bias:
            out.update({"attn.bq": (hq, dh), "attn.bk": (hkv, dh),
                        "attn.bv": (hkv, dh)})
    if cfg.ssm_active:
        d_inner, heads, conv_dim = ssm_dims(cfg)
        out.update({
            "ssm.in_proj": (d, 2 * d_inner + 2 * cfg.ssm_state + heads),
            "ssm.conv_w": (CONV_K, conv_dim), "ssm.conv_b": (conv_dim,),
            "ssm.a_log": (heads,), "ssm.dt_bias": (heads,), "ssm.d_skip": (heads,),
            "ssm.out_proj": (d_inner, d), "ssm.norm.scale": (d_inner,)})

    def mlp_shapes(prefix, d_ff):
        width = 2 * d_ff if cfg.mlp_type in GATED else d_ff
        return {f"{prefix}.wi": (d, width), f"{prefix}.wo": (d_ff, d)}

    if cfg.block_type == "moe":
        e, f = cfg.num_experts, cfg.expert_d_ff
        width = 2 * f if cfg.mlp_type in GATED else f
        out.update({"norm2.scale": (d,), "moe.router": (d, e),
                    "moe.wi": (e, d, width), "moe.wo": (e, f, d)})
        if cfg.shared_experts:
            out.update(mlp_shapes("moe.shared", cfg.shared_experts * f))
    elif cfg.mlp_type != "none" and cfg.d_ff > 0:
        out["norm2.scale"] = (d,)
        out.update(mlp_shapes("mlp", cfg.d_ff))
    return out


def param_shapes(cfg: LMConfig) -> dict[str, tuple[int, ...]]:
    """Every parameter's shape under the port's names (``blocks.{i}.*``),
    in ``named_parameters`` order, without allocating the model."""
    out = {"embed.table": (cfg.vocab_size, cfg.d_model)}
    blk = block_shapes(cfg)
    for i in range(cfg.num_layers):
        out.update({f"blocks.{i}.{k}": v for k, v in blk.items()})
    out["final_norm.scale"] = (cfg.d_model,)
    return out


def _leaf_name(name: str) -> str:
    if name.startswith("blocks."):
        return name.split(".", 2)[2]
    return name


def param_axes(cfg: LMConfig) -> dict[str, tuple]:
    """Every parameter's logical axes under the port's names: the
    reference's ``abstract_axes`` with the leading ``layers`` axis taken
    off each layer's leaves."""
    return {k: _LEAF_AXES[_leaf_name(k)] for k in param_shapes(cfg)}


def cache_axes(cfg: LMConfig) -> dict[str, tuple]:
    """One layer's cache's logical axes (the reference's, without its
    leading ``layers`` axis)."""
    ax = {}
    if cfg.attn_active:
        ax["k"] = ("batch", "cache_seq", "kv_heads", "head_dim")
        ax["v"] = ("batch", "cache_seq", "kv_heads", "head_dim")
    if cfg.ssm_active:
        ax["conv"] = ("batch", None, "ssm_inner")
        ax["ssm"] = ("batch", "ssm_heads", None, None)
    return ax
