"""AdamW with global-norm clipping (counterpart of
``repro/train/optimizer.py``), in the reference's arithmetic order.

Moments are float32 whatever the parameters' dtype (bf16 parameters and
float32 moments, with no float32 master copy). The update works on
dicts of tensors keyed by parameter name, leaf by leaf and in place, so
that no second copy of the moments or the parameters is ever held (the
reference returns new trees). The scalars that depend on the step alone
(learning rate, bias corrections) are float32 numbers computed on the
host, as the reference computes them in float32; the ones that depend
on the gradients stay on the parameters' device, so nothing waits for
the card.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100


def adamw_init(params: Mapping[str, torch.Tensor]):
    """Float32 zero moments (mu, nu) shaped like ``params``."""
    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}
    return zeros(), zeros()


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in tree.values()))


def lr_schedule(cfg: AdamWConfig, step: int) -> np.float32:
    """Linear warmup to ``cfg.lr`` over ``cfg.warmup`` steps, in float32;
    step 0 trains too."""
    s = np.float32(step) + np.float32(1.0)
    warm = np.minimum(s / np.float32(max(cfg.warmup, 1)), np.float32(1.0))
    return np.float32(cfg.lr) * warm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor],
                 mu: dict, nu: dict, params: Mapping[str, torch.Tensor],
                 step: int, ok: torch.Tensor | None = None,
                 gnorm: torch.Tensor | None = None) -> torch.Tensor:
    """One AdamW step at ``step`` (0-based): updates ``mu``, ``nu`` and
    ``params`` in place and returns the gradients' global norm. The
    parameters update in float32 and are cast back to their dtype. Where
    the 0-d bool ``ok`` is false the parameters keep their values; the
    moments update all the same, as the reference's do. ``gnorm`` is the
    norm that clips, by default ``global_norm(grads)``; the sharded
    trainer passes the norm over every rank's shards, and the update,
    elementwise, then gives each shard its slice of the full update."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    # float32 values as Python floats (exact), which torch applies as such
    t = np.float32(step + 1)
    lr = float(lr_schedule(cfg, step))
    c1 = float(np.float32(1.0) - np.float32(cfg.b1) ** t)
    c2 = float(np.float32(1.0) - np.float32(cfg.b2) ** t)
    for k, p in params.items():
        gf = grads[k].float() * scale
        m = cfg.b1 * mu[k] + (1.0 - cfg.b1) * gf
        v = cfg.b2 * nu[k] + (1.0 - cfg.b2) * gf * gf
        mh = m / c1
        vh = v / c2
        upd = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        new = (p.float() - lr * upd).to(p.dtype)
        mu[k].copy_(m)
        nu[k].copy_(v)
        p.copy_(new if ok is None else torch.where(ok, new, p))
    return gnorm
