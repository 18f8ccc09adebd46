"""Fine-grained mixture-of-experts with shared experts (counterpart of
``repro/models/moe.py``).

Two dispatches, both with static shapes, selected by
``cfg.moe_dispatch``:

  * ``scatter`` (default): each (token, slot)'s position in its expert
    from an exclusive cumsum over the one-hot assignment, an add into
    (E, C, D) expert buffers, the expert products, a gather back.
  * ``dense``: the one-hot einsums of GShard/Switch, which hold a
    (T*K, E, C) mask; kept to compare with the scatter dispatch.

Tokens over the capacity C = max(ceil(T*K/E * capacity_factor), 1) are
dropped (their gate is zero); C depends on T, so a decode step drops
differently from a prefill. Shared experts are a dense MLP of width
``shared_experts * expert_d_ff`` applied to every token (DeepSeek-MoE,
arXiv:2401.06066).

The router runs in float32, its weights kept in float32 whatever
``param_dtype`` is. Its top-k breaks ties towards the lower expert, as
``jax.lax.top_k`` does, by a stable descending sort (``torch.topk``
orders ties otherwise). Nothing on the path reads a value back to the
host: no boolean-mask indexing, ``nonzero`` or ``.item()``.

``routing`` and ``dispatch`` are separate so that a test can hand the
dispatch the reference's own expert choices: one float32 ulp in the
router's logits may swap an expert.

Split over ranks (``global_batch``, which the sharded trainer enters),
the capacity and every (token, slot)'s place are those of the global
batch, as the reference computes them over all B*S tokens of a sharded
batch: C from the global T, and each place the rank's own exclusive
cumsum plus the per-expert counts of the rows before the rank's (their
all-gather is the caller's ``before_counts``). So every rank drops the
tokens the one-device step drops. The rank's expert buffers hold only
its own kept slots, min(C, T_rank) of them an expert, at their place within the
rank.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch

from repro_torch.models.mlp import GATED, activation, init_mlp, mlp
from repro_torch.models.module import Params, dense_init

DISPATCHES = ("scatter", "dense")

# (ranks the batch is split over, before_counts), set by ``global_batch``
_GLOBAL_BATCH: tuple[int, Callable[[torch.Tensor], torch.Tensor]] | None = None


@contextlib.contextmanager
def global_batch(ranks: int, before_counts: Callable[[torch.Tensor], torch.Tensor]):
    """Within it, ``dispatch`` takes capacity and places over the global
    batch of ``ranks`` equal row blocks, of which the caller holds one:
    ``before_counts(counts)`` maps this rank's per-expert (E,) int32
    counts to the sums of those of the ranks before it (the caller's
    collective, which every rank must reach in the same order)."""
    global _GLOBAL_BATCH
    prev, _GLOBAL_BATCH = _GLOBAL_BATCH, (int(ranks), before_counts)
    try:
        yield
    finally:
        _GLOBAL_BATCH = prev


def init_moe(gen: torch.Generator, cfg, dtype: torch.dtype) -> Params:
    """``router`` (d, E) float32, ``wi`` (E, d, width), ``wo`` (E, f, d)
    and, with shared experts, ``shared`` (an MLP of width
    ``shared_experts * expert_d_ff``). ``dense_init`` scales ``wi`` and
    ``wo`` by 1/sqrt(E), their leading dim, as the reference does."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    width = 2 * f if cfg.mlp_type in GATED else f
    p = Params(router=dense_init(gen, (d, e), torch.float32),
               wi=dense_init(gen, (e, d, width), dtype),
               wo=dense_init(gen, (e, f, d), dtype))
    if cfg.shared_experts:
        p.shared = init_mlp(gen, d, cfg.shared_experts * f, cfg.mlp_type, dtype)
    return p


def top_k(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest scores of each row, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def routing(p: Params, cfg, xf: torch.Tensor):
    """xf: (T, D) float32. Returns (idx (T, K) int32, gates (T, K)
    float32): softmax scores renormalised over the top k (DeepSeek), or
    sigmoid scores as they are (llama4)."""
    logits = xf @ p.router
    if cfg.router_type == "sigmoid":
        gates, idx = top_k(torch.sigmoid(logits), cfg.top_k)
    else:
        gates, idx = top_k(torch.softmax(logits, dim=-1), cfg.top_k)
        gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)
    return idx.to(torch.int32), gates.float()


def capacity(cfg, tokens: int) -> int:
    return max(int(math.ceil(tokens * cfg.top_k / cfg.num_experts
                             * cfg.capacity_factor)), 1)


def _one_hot(i: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """As ``jax.nn.one_hot``: a row of zeros where i is outside [0, n),
    with no bounds check that reads back to the host."""
    return (i[:, None] == torch.arange(n, dtype=i.dtype, device=i.device)).to(dtype)


def positions(idx: torch.Tensor, num_experts: int, cap: int):
    """Each (token, slot)'s place in its expert in arrival order (flat
    (T, K) order). Returns (flat_e (T*K,), onehot (T*K, E) int32, pos
    (T*K,) int32, keep (T*K,) bool: pos < cap)."""
    flat_e = idx.reshape(-1)
    onehot = _one_hot(flat_e, num_experts, torch.int32)
    excl = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    pos = torch.gather(excl, 1, flat_e[:, None].long())[:, 0]
    return flat_e, onehot, pos, pos < cap


def places(idx: torch.Tensor, cfg, tokens: int):
    """Where each (token, slot) goes: ``(flat_e, onehot, pos, keep,
    pos_buf, cap_buf)``. ``pos`` is its place in its expert over the
    whole batch, ``keep`` = pos < C, and ``pos_buf`` its row in this
    rank's (E, cap_buf, D) buffers. On one device pos_buf is pos and
    cap_buf is C; within ``global_batch``, see the module docstring."""
    e = cfg.num_experts
    if _GLOBAL_BATCH is None or _GLOBAL_BATCH[0] == 1:
        cap = capacity(cfg, tokens)
        flat_e, onehot, pos, keep = positions(idx, e, cap)
        return flat_e, onehot, pos, keep, pos, cap
    ranks, before_counts = _GLOBAL_BATCH
    cap = capacity(cfg, tokens * ranks)
    flat_e, onehot, pos_buf, _ = positions(idx, e, cap)
    before = before_counts(onehot.sum(dim=0, dtype=torch.int32))
    pos = pos_buf + torch.gather(before, 0, flat_e.long())
    # a kept slot's rank-local place is below C and below the rank's T
    return flat_e, onehot, pos, pos < cap, pos_buf, min(cap, tokens)


def expert_ffn(p: Params, cfg, expert_in: torch.Tensor) -> torch.Tensor:
    """expert_in: (E, C, D) -> (E, C, D), in expert_in's dtype: each
    expert's MLP as one batched product each way."""
    h = activation(torch.bmm(expert_in, p.wi.to(expert_in.dtype)), cfg.mlp_type)
    return torch.bmm(h, p.wo.to(expert_in.dtype))


def dispatch(p: Params, cfg, x: torch.Tensor, idx: torch.Tensor,
             gates: torch.Tensor, mode: str = "scatter"):
    """The experts' combined output for x (B, S, D), given the router's
    choices idx and gates (T, K). Returns (out (B, S, D) in x's dtype,
    aux {"expert_load" (E,), "dropped" ()})."""
    if mode not in DISPATCHES:
        raise ValueError(f"unknown moe dispatch {mode!r}; one of {DISPATCHES}")
    b, s, d = x.shape
    t, k, e = b * s, cfg.top_k, cfg.num_experts
    xt = x.reshape(t, d)
    flat_e, onehot, _, keep, pos, cap = places(idx, cfg, t)
    gates_flat = gates.reshape(t * k) * keep.float()
    src = xt.repeat_interleave(k, dim=0) if k > 1 else xt

    if mode == "scatter":
        # every (token, slot) row goes in: a dropped one adds exact zeros
        # at cap - 1, so the shapes never depend on the routing
        pos_c = torch.where(keep, pos, cap - 1)
        slot = flat_e.long() * cap + pos_c.long()
        buf = torch.zeros((e * cap, d), dtype=x.dtype, device=x.device)
        buf.index_add_(0, slot, torch.where(keep[:, None], src, 0).to(x.dtype))
        out_buf = expert_ffn(p, cfg, buf.view(e, cap, d))
        y = out_buf.view(e * cap, d).index_select(0, slot) * gates_flat[:, None]
    else:
        assign = _one_hot(flat_e, e, x.dtype)
        poh = _one_hot(pos, cap, x.dtype) * keep[:, None].to(x.dtype)
        mask = assign[:, :, None] * poh[:, None, :]  # (T*K, E, C)
        buf = torch.einsum("tec,td->ecd", mask, src)
        out_buf = expert_ffn(p, cfg, buf)
        y = torch.einsum("tec,ecd->td", mask.float(), out_buf.float()) * gates_flat[:, None]
    out = y.reshape(t, k, d).sum(dim=1).reshape(b, s, d).to(x.dtype)
    if hasattr(p, "shared"):
        out = out + mlp(p.shared, x, cfg.mlp_type)
    # load-balance diagnostics (the Switch aux loss's form)
    aux = {"expert_load": onehot.float().mean(dim=0),
           "dropped": 1.0 - keep.float().mean()}
    return out, aux


def moe(p: Params, cfg, x: torch.Tensor, *, mode: str = "scatter"):
    """x: (B, S, D). Returns (out, aux) as ``dispatch``."""
    idx, gates = routing(p, cfg, x.reshape(-1, x.shape[-1]).float())
    return dispatch(p, cfg, x, idx, gates, mode)
