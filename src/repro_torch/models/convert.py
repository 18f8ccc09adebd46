"""Carry LM weights across from the reference.

``lm_params_from_numpy`` takes the tree that the reference's ``init_lm``
returns, with its arrays as numpy arrays (``jax.tree.map(np.asarray,
params)``): layers stacked on a leading L axis, the reference's layouts
(``wq`` (d, Hq, Dh), ``wo`` (Hq, Dh, d), ``in_proj`` (d, .), ``conv_w``
(4, C), the gated MLPs' ``wi`` (d, 2 d_ff) as gate | up, one kv head's
``wk``/``wv`` (d, 1, Dh), the tied ``embed.table`` (V, d), the experts'
``moe.wi`` (E, d, width) and ``moe.wo`` (E, f, d) beside the float32
``moe.router`` (d, E) whatever the other weights' dtype). It loads them
into a ``CausalLM`` so that both compute the same function.
``train_state_from_numpy`` does the same for the reference's training
state (parameters, AdamW moments, step).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import LMConfig
from repro_torch.models.lm import CausalLM
from repro_torch.train.trainer import TrainState, train_state_for


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def _named(tree: Mapping[str, Any], cfg: LMConfig) -> dict[str, torch.Tensor]:
    """The reference's tree as CPU tensors under the port's parameter
    names, the stacked layers split into ``blocks.{i}.*``."""
    state = {}
    for name, arr in _flatten(tree):
        t = _tensor(arr)
        if name.startswith("blocks."):
            if t.shape[0] != cfg.num_layers:
                raise ValueError(f"{name}: leading axis {t.shape[0]}, "
                                 f"expected {cfg.num_layers} layers")
            rest = name[len("blocks."):]
            for i in range(cfg.num_layers):
                state[f"blocks.{i}.{rest}"] = t[i]
        else:
            state[name] = t
    return state


def lm_params_from_numpy(params: Mapping[str, Any], cfg: LMConfig,
                         device: torch.device | str = "cuda") -> CausalLM:
    """A ``CausalLM`` on ``device`` (the card unless the caller passes
    "cpu") holding the reference's parameters (copied). Every name,
    shape and dtype must match the port's model exactly."""
    dev = resolve_device(device)
    model = CausalLM(cfg, torch.Generator(device=dev).manual_seed(0))
    state = _named(params, cfg)
    own = model.state_dict()
    for name, t in state.items():
        if name in own and own[name].dtype != t.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, the model holds "
                            f"{own[name].dtype}")
    model.load_state_dict(state, strict=True)
    return model


def train_state_from_numpy(params: Mapping[str, Any], mu: Mapping[str, Any],
                           nu: Mapping[str, Any], step: int, cfg: LMConfig,
                           device: torch.device | str = "cuda") -> TrainState:
    """A ``TrainState`` on ``device`` from the reference's ``TrainState``
    fields as numpy trees (``params``, the float32 moments ``mu`` and
    ``nu``) and its step."""
    model = lm_params_from_numpy(params, cfg, device)
    dev = model.embed.table.device
    state = train_state_for(model, int(step))
    for tree, dst in ((mu, state.mu), (nu, state.nu)):
        got = _named(tree, cfg)
        if got.keys() != dst.keys():
            raise ValueError("the moments' names differ from the model's: "
                             f"{sorted(got.keys() ^ dst.keys())}")
        for name, t in got.items():
            dst[name].copy_(t.to(dev, torch.float32))
    return state
