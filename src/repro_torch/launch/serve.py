"""Batched LM serving driver (counterpart of ``repro/launch/serve.py``):
prefill, then a greedy decode loop, over a queue of requests.

Static batches: requests are drained from a queue in batches of
``--batch``; each batch is prefilled once and decoded ``--gen`` tokens.
Reports prefill and decode tokens/s over the batches after the first,
which is served too but off the clock: it pays for cuBLAS's first calls
and the allocator's growth. The rates of each timed batch are listed
beside them.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      --requests 8 --batch 4 --prompt-len 512 --gen 32     # on the card
  ... --arch paligemma-3b ...                              # with a prefix
  ... --arch deepseek-moe-16b ...                          # mixture of experts
  ... --smoke --device cpu                                 # plain, CPU

Parameters are drawn from a seeded ``torch.Generator`` on the device, in
the config's ``param_dtype``. An arch with a prefix (``cfg.prefix_len``)
gets, per batch, standard-normal float32 embeddings (B, prefix_len,
d_model) standing in for its frontend, drawn as the reference draws them:
from the generator of the queue's prompts, after them. The cache holds
min(prefix + prompt + gen, window) positions and decoding starts at
prefix + prompt; ``serve`` runs only when every generated token fits,
because past that the reference's decode overwrites its last cache slot
and no longer computes the model (the port's decode raises there). The
reference's CLI leaves the prefix out of its cache length, and so drops
positions whenever there is one (ROADMAP C7); the port does not copy that.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.ssd import ssd as SSD
from repro_torch.models.config import LMConfig
from repro_torch.models.lm import CausalLM

WARMUP_BATCHES = 1


class RequestQueue:
    def __init__(self, rng, num: int, vocab: int, prompt_len: int):
        self.prompts = [
            rng.integers(0, vocab, size=prompt_len).astype(np.int32)
            for _ in range(num)
        ]

    def drain(self, n: int):
        out, self.prompts = self.prompts[:n], self.prompts[n:]
        return out


def cache_length(cfg, prompt_len: int, gen: int) -> int:
    """Positions of the KV cache: prefix + prompt + gen, cut to the
    window; raises where the cut would drop positions."""
    need = cfg.prefix_len + prompt_len + gen
    cache_len = min(need, cfg.window) if cfg.window else need
    if need > cache_len:
        raise ValueError(
            f"prefix {cfg.prefix_len} + prompt {prompt_len} + gen {gen} exceeds "
            f"the cache of {cache_len} positions (window {cfg.window}); the "
            "decode would have to drop positions, which serving here does not do")
    return cache_len


@torch.inference_mode()
def serve_queue(model: CausalLM, queue: RequestQueue, batch: int,
                prompt_len: int, gen: int, warmup: int = 0,
                rng: np.random.Generator | None = None):
    """Prefill and greedily decode every request of ``queue`` in static
    batches of ``batch`` (a partial last batch is padded with copies of
    its last request). Where the model has a prefix, each batch's
    embeddings are drawn from ``rng`` (required then) before its prefill.
    Returns (generated tokens, one list per request; stats). Prefill and
    decode are timed between synchronizes, the embeddings' copy to the
    device included; the first ``warmup`` batches are served but neither
    timed nor counted in the token totals, which count prompt and
    generated tokens of real requests (prefix positions are not tokens)."""
    cfg = model.cfg
    device = model.embed.table.device
    cache_len = cache_length(cfg, prompt_len, gen)
    if cfg.prefix_len and rng is None:
        raise ValueError(f"{cfg.name} takes a prefix of {cfg.prefix_len} "
                         "embeddings: pass the rng to draw them from")
    stats = {"prefill_tokens": 0, "decode_tokens": 0, "batches": 0,
             "prefill_s": [], "decode_s": [], "batch_tokens": []}
    finite = torch.ones((), dtype=torch.bool, device=device)
    outputs = []
    while True:
        reqs = queue.drain(batch)
        if not reqs:
            break
        pad = batch - len(reqs)
        toks = torch.from_numpy(np.stack(reqs + [reqs[-1]] * pad)).to(device)
        embeds = None
        if cfg.prefix_len:
            embeds = rng.standard_normal(
                (batch, cfg.prefix_len, cfg.d_model)).astype(np.float32)
        synchronize(device)
        t0 = time.perf_counter()
        if embeds is not None:
            embeds = torch.from_numpy(embeds).to(device)
        logits, cache = model.prefill(toks, cache_len, embeds)
        synchronize(device)
        prefill_s = time.perf_counter() - t0
        finite &= torch.isfinite(logits).all()

        generated = []
        token = torch.argmax(logits, dim=-1)
        fill = cfg.prefix_len + prompt_len
        t0 = time.perf_counter()
        for _ in range(gen):
            generated.append(token)
            logits, cache = model.decode_step(token, cache, fill)
            finite &= torch.isfinite(logits).all()
            token = torch.argmax(logits, dim=-1)
            fill += 1
        synchronize(device)
        if stats["batches"] >= warmup:
            stats["prefill_s"].append(prefill_s)
            stats["decode_s"].append(time.perf_counter() - t0)
            # real requests only: the padding rows of a partial batch are
            # not served tokens
            stats["batch_tokens"].append(len(reqs))
            stats["prefill_tokens"] += prompt_len * len(reqs)
            stats["decode_tokens"] += gen * len(reqs)
        stats["batches"] += 1
        if generated:
            outputs.extend(torch.stack(generated, 1)[: len(reqs)].tolist())
        else:
            outputs.extend([] for _ in reqs)
    stats["logits_finite"] = bool(finite)
    return outputs, stats


def serve(args: argparse.Namespace, cfg: LMConfig | None = None):
    """Serve ``args.requests`` random prompts with a model drawn from
    ``args.seed``. On the card the kernels are built first, off the
    clock. Prints and returns the summary, with the generated tokens.
    ``prefill_tok_s`` counts prompt tokens only, as the reference does:
    a prefix's embeddings are not tokens, though its prefill computes
    them too. ``cfg``, where a caller gives it, is served in place of
    ``args.arch``'s config (e.g. the arch at a reduced depth,
    ``dataclasses.replace(cfg, num_layers=8)``)."""
    if cfg is None:
        cfg = get_config(args.arch, smoke=args.smoke)
    device = resolve_device(args.device)
    cache_length(cfg, args.prompt_len, args.gen)  # refuse before any work
    if args.requests <= WARMUP_BATCHES * args.batch:
        raise ValueError(f"{args.requests} requests leave no batch to time after "
                         f"{WARMUP_BATCHES} warm-up batch of {args.batch}")
    if device.type == "cuda":
        _build.build_all([*FA.SOURCES, *SSD.SOURCES])
    model = CausalLM(cfg, torch.Generator(device=device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    queue = RequestQueue(rng, args.requests, cfg.vocab_size, args.prompt_len)
    outputs, stats = serve_queue(model, queue, args.batch, args.prompt_len,
                                 args.gen, warmup=WARMUP_BATCHES, rng=rng)

    def rate(tokens, seconds):
        return round(tokens / max(seconds, 1e-9), 1)

    summary = {
        "arch": cfg.name,
        "requests": args.requests,
        "prefill_tok_s": rate(stats["prefill_tokens"], sum(stats["prefill_s"])),
        "decode_tok_s": rate(stats["decode_tokens"], sum(stats["decode_s"])),
        "batches": stats["batches"],
        "warmup_batches": WARMUP_BATCHES,
        "prefill_tok_s_per_batch": [rate(args.prompt_len * n, t) for n, t in
                                    zip(stats["batch_tokens"], stats["prefill_s"])],
        "decode_tok_s_per_batch": [rate(args.gen * n, t) for n, t in
                                   zip(stats["batch_tokens"], stats["decode_s"])],
        "sample_output": outputs[0][:8] if outputs else [],
        "parameters": sum(t.numel() for t in model.parameters()),
        "logits_finite": stats["logits_finite"],
        "device": str(device),
    }
    print(json.dumps(summary), flush=True)
    return outputs, summary


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda with no card is an error")
    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None
    serve(args)


if __name__ == "__main__":
    main()
