"""The topic-conditioned LM (counterpart of
``examples/topic_conditioned_lm.py``): the HDP sampler as a data-pipeline
component of LM training. The port's sampler infers per-document topic
mixtures theta on a planted-topics corpus; a small causal LM trains on
the documents with ``theta @ proj`` as a one-position prefix embedding,
and once without; conditioning should lower the loss.

  PYTHONPATH=src python -m repro_torch.launch.topic_lm           # on the card
  PYTHONPATH=src python -m repro_torch.launch.topic_lm --device cpu

The sizes and seeds are the reference's: 150 documents of 20-32 tokens
over V = 80 from 4 planted topics (numpy seed 3); K = 16, 100 Gibbs
iterations (seed 0), the ``cuda`` z-step on the card and ``dense`` on the
CPU (the port has no ``sparse``; the three are conformant); a 2-layer LM
(d_model 64, 4/2 heads at D = 16, d_ff 128) trained 150 AdamW steps (lr
3e-3, warmup 10) of 8 documents drawn from numpy seed 0, which also
draws ``proj``. The loss reported is the mean of the last 20 steps. The
LM's weights and the sampler's chain come from ``torch.Generator``s, so
the numbers are not the reference's; its batches, prefix and schedule
are. Prints the reference's four lines, then one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.core import hdp as H
from repro_torch.data.corpus import Corpus
from repro_torch.data.synthetic import planted_topics_corpus
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.hdp_z import hdp_z as HZ
from repro_torch.models.config import LMConfig
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import (TrainState, batch_tensors,
                                       init_train_state, make_train_step)

OPT = AdamWConfig(lr=3e-3, warmup=10)
BATCH = 8
LAST = 20  # the steps the reported loss averages


def make_corpus() -> Corpus:
    """The reference's planted-topics corpus (numpy seed 3)."""
    corpus, _ = planted_topics_corpus(np.random.default_rng(3), D=150, V=80,
                                      K_true=4, doc_len=(20, 32),
                                      topic_sharpness=0.03)
    return corpus


def infer_topics(corpus: Corpus, device: torch.device, k: int = 16,
                 iters: int = 100, seed: int = 0) -> tuple[np.ndarray, int]:
    """Per-document topic mixtures (D, K) float32 (each row the
    document's topic counts over its length) after ``iters`` Gibbs
    iterations from the single-topic init, and the active topics."""
    z_impl = "cuda" if device.type == "cuda" else "dense"
    cfg = H.HDPConfig(K=k, V=corpus.V, bucket=32, z_impl=z_impl, hist_cap=64)
    tokens = torch.from_numpy(corpus.tokens).to(device)
    mask = torch.from_numpy(corpus.mask).to(device)
    state = H.init_state(H.make_generator(seed, device), tokens, mask, cfg)
    for _ in range(iters):
        state = H.gibbs_iteration(state, tokens, mask, cfg)
    theta = H.doc_topic_counts(state.z, mask, cfg.K).cpu().numpy().astype(np.float32)
    theta /= np.maximum(theta.sum(1, keepdims=True), 1)
    return theta, int(H.active_topics(state))


def lm_config(vocab: int, prefix: int) -> LMConfig:
    return LMConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                    head_dim=16, d_ff=128, vocab_size=vocab, prefix_len=prefix,
                    loss_chunk=32)


def lm_batches(corpus: Corpus, theta: np.ndarray | None, steps: int,
               d_model: int, seed: int = 0):
    """The reference's batches: ``proj`` (K, d_model) * 0.5 drawn first
    ((1, d_model) without theta, so both runs see the same documents),
    then 8 document indices a step; next-token targets, the mask of
    positions whose target is live, and the prefix (B, 1, d_model)."""
    rng = np.random.default_rng(seed)
    proj = rng.standard_normal((theta.shape[1] if theta is not None else 1,
                                d_model)).astype(np.float32) * 0.5
    for _ in range(steps):
        idx = rng.integers(0, corpus.num_docs, size=BATCH)
        toks, live = corpus.tokens[idx], corpus.mask[idx]
        batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1),
                 "mask": live & np.roll(live, -1, axis=1)}
        if theta is not None:
            batch["embeds"] = (theta[idx] @ proj)[:, None, :]
        yield batch


def run_lm(corpus: Corpus, theta: np.ndarray | None, device: torch.device,
           steps: int = 150, seed: int = 0,
           state: TrainState | None = None) -> tuple[float, list[float]]:
    """Train the LM (with the prefix when ``theta`` is given) from
    ``state``, or from a model drawn from ``seed``. Returns the mean loss
    of the last 20 steps and every step's loss."""
    cfg = lm_config(corpus.V, 1 if theta is not None else 0)
    if state is None:
        state = init_train_state(seed, cfg, device)
    step = make_train_step(cfg, OPT)
    losses = []
    for batch in lm_batches(corpus, theta, steps, cfg.d_model, seed):
        state, metrics = step(state, batch_tensors(batch, device))
        losses.append(float(metrics["loss"]))
    return float(np.mean(losses[-LAST:])), losses


def run(device: str | torch.device = "cuda") -> dict:
    """The whole example; prints its lines and returns the summary."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        _build.build_all([*HZ.SOURCES, *FA.SOURCES])
    corpus = make_corpus()
    print(f"corpus: {corpus.num_docs} docs, {corpus.num_tokens} tokens")
    theta, active = infer_topics(corpus, dev)
    print(f"HDP inferred {active} active topics")
    base, _ = run_lm(corpus, None, dev)
    cond, _ = run_lm(corpus, theta, dev)
    print(f"LM loss unconditioned: {base:.3f}")
    print(f"LM loss topic-conditioned: {cond:.3f}")
    print("conditioning gain:", round(base - cond, 3))
    summary = {"unconditioned_loss": base, "conditioned_loss": cond,
               "gain": base - cond, "active_topics": active,
               "docs": corpus.num_docs, "tokens": corpus.num_tokens,
               "device": str(dev)}
    print(json.dumps(summary), flush=True)
    return summary


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda with no card is an error")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None
    run(args.device)


if __name__ == "__main__":
    main()
