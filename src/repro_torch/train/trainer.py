"""Training step and loop (counterpart of ``repro/train/trainer.py``).

``make_train_step(cfg, opt)`` builds the (state, batch) -> (state,
metrics) step: the loss and its gradients, NaN protection, one AdamW
update. The model's parameters, and the moments, update in place.

The loop (``Trainer``) adds periodic checkpoints (``train/checkpoint.py``),
a per-step deadline count, and restart from the latest checkpoint. The
step skips the update on a non-finite loss or gradient norm, as the
reference does: the gradients are zeroed, the moments decay by their
betas, the parameters keep their values, and the step count goes on.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device, synchronize
from repro_torch.models import lm as LM
from repro_torch.models.config import LMConfig
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.optimizer import (AdamWConfig, adamw_init, adamw_update,
                                         global_norm)


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are the trained ones), float32 moments
    keyed by parameter name, and the number of steps taken."""
    model: LM.CausalLM
    mu: dict
    nu: dict
    step: int = 0

    @property
    def params(self) -> dict:
        return dict(self.model.named_parameters())

    def payload(self) -> dict:
        """What a checkpoint stores."""
        return {"params": self.params, "mu": self.mu, "nu": self.nu,
                "step": np.int32(self.step)}


def train_state_for(model: LM.CausalLM, step: int = 0) -> TrainState:
    """A state that trains ``model`` (its parameters now take gradients),
    with zero moments."""
    model.requires_grad_(True)
    mu, nu = adamw_init(dict(model.named_parameters()))
    return TrainState(model, mu, nu, step)


def init_train_state(seed: int, cfg: LMConfig,
                     device: torch.device | str = "cuda") -> TrainState:
    """A model initialized from ``seed`` on ``device`` (the card unless
    the caller passes "cpu"), and zero moments."""
    dev = resolve_device(device)
    return train_state_for(LM.CausalLM(cfg, torch.Generator(device=dev).manual_seed(seed)))


def batch_tensors(batch: dict, device: torch.device) -> dict:
    """A numpy batch of ``data/lm_data.py`` as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def make_train_step(cfg: LMConfig, opt: AdamWConfig):
    def train_step(state: TrainState, batch: dict):
        params = state.params
        loss = LM.lm_loss(state.model, batch["tokens"], batch["targets"],
                          batch["mask"], batch.get("embeds"))
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        loss = loss.detach()
        # NaN protection: skip the update on a non-finite loss OR
        # gradient norm (gradients can be NaN while the loss is finite)
        ok = torch.isfinite(loss) & torch.isfinite(global_norm(grads))
        for k in grads:
            grads[k] = torch.where(ok, grads[k], 0.0)
        gnorm = adamw_update(opt, grads, state.mu, state.nu, params,
                             state.step, ok)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "skipped": (~ok).to(torch.int32)}
        return dataclasses.replace(state, step=state.step + 1), metrics

    return train_step


class Trainer:
    """Training loop with checkpoints, deadline counts and resume."""

    def __init__(self, cfg: LMConfig, opt: AdamWConfig, step_fn, *,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 100,
                 step_deadline_s: Optional[float] = None,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.opt = opt
        self.step_fn = step_fn
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.step_deadline_s = step_deadline_s
        self.device = resolve_device(device)
        self.deadline_breaches = 0

    def restore_or_init(self, seed: int) -> TrainState:
        """The latest checkpoint's state, else a new one from ``seed``."""
        state = init_train_state(seed, self.cfg, self.device)
        if self.checkpoint_dir:
            got = CKPT.restore_latest(self.checkpoint_dir, state.payload())
            if got is not None:
                with torch.no_grad():
                    for k, p in state.params.items():
                        p.copy_(got["params"][k])
                state = dataclasses.replace(state, mu=got["mu"], nu=got["nu"],
                                            step=int(got["step"]))
        return state

    def run(self, state: TrainState, batches: Iterable[dict], *,
            log_every: int = 10):
        """Take a step per batch (tensors on the trainer's device).
        Returns the final state and the logged history: step, loss,
        grad_norm, skipped and sec (a step's wall time, to the card's
        end of it) every ``log_every`` steps."""
        history = []
        for i, batch in enumerate(batches):
            t0 = time.monotonic()
            state, metrics = self.step_fn(state, batch)
            synchronize(self.device)
            dt = time.monotonic() - t0
            if self.step_deadline_s and dt > self.step_deadline_s:
                self.deadline_breaches += 1
            if i % log_every == 0:
                history.append({
                    "step": state.step, "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "skipped": int(metrics["skipped"]), "sec": dt})
            if self.checkpoint_dir and state.step % self.checkpoint_every == 0:
                self.save(state)
        return state, history

    def save(self, state: TrainState) -> None:
        """Checkpoint ``state`` at its step."""
        CKPT.save(self.checkpoint_dir, state.step, state.payload())
