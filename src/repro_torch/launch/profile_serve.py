"""Where LM serving spends its time on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch hymba-1.5b \
      --batch 4 --prompt-len 512 --gen 32
  ... --arch paligemma-3b                  # with its 256-position prefix

Builds the model and a batch of prompts as ``repro_torch.launch.serve``
does, serves ``--warmup`` batches unprofiled (the first pays cuBLAS's
and the allocator's first-call costs), then profiles one prefill and one
decode step with ``torch.profiler`` (CPU and CUDA activities). For each
it prints one JSON line, as ``profile_iteration`` does: the wall time
(host clock, ending in a synchronize), the device busy time, the idle
share, and device time by kernel name. It also prints the number of
PyTorch operator calls the host made in each, which bounds a step whose
device is mostly idle.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.ssd import ssd as SSD
from repro_torch.launch.profile_iteration import profiled
from repro_torch.launch.serve import RequestQueue, cache_length, serve_queue
from repro_torch.models.lm import CausalLM


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def host_ops(fn) -> int:
    """PyTorch operator calls the host makes in ``fn`` (top level)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for evt in prof.events() if evt.cpu_parent is None)


@torch.inference_mode()
def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("error: profile_serve measures the card; no CUDA device is present")
    cfg = get_config(args.arch)
    dev = torch.device("cuda")
    _build.build_all([*FA.SOURCES, *SSD.SOURCES])
    model = CausalLM(cfg, torch.Generator(device=dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    serve_queue(model, RequestQueue(rng, args.warmup * args.batch, cfg.vocab_size,
                                    args.prompt_len),
                args.batch, args.prompt_len, args.gen, rng=rng)
    print(json.dumps({
        "arch": cfg.name, "batch": args.batch, "prompt_len": args.prompt_len,
        "warmup_batches": args.warmup, "card": card(),
    }), flush=True)

    toks = torch.from_numpy(np.stack(RequestQueue(
        rng, args.batch, cfg.vocab_size, args.prompt_len).drain(args.batch))).to(dev)
    embeds = None
    if cfg.prefix_len:
        embeds = torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.prefix_len, cfg.d_model)).astype(np.float32)).to(dev)
    cache_len = cache_length(cfg, args.prompt_len, args.gen)
    prefill = lambda: model.prefill(toks, cache_len, embeds)  # noqa: E731
    logits, cache = profiled(prefill, "prefill", args.top)
    token = torch.argmax(logits, dim=-1)
    # decode at fill = prefix + prompt writes one cache slot; each call
    # below rewrites the same slot, so every call does the same work
    fill = cfg.prefix_len + args.prompt_len
    step = lambda: model.decode_step(token, cache, fill)  # noqa: E731
    step()
    profiled(step, "decode_step", args.top)
    print(json.dumps({
        "host_ops_prefill": host_ops(prefill),
        "host_ops_decode_step": host_ops(step),
    }), flush=True)


if __name__ == "__main__":
    main()
