"""Where one HDP Gibbs iteration spends its time on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_iteration \
      --hdp pubmed --scale 0.01 --topics 1000 --max-len 256 --bucket 256

Sets the run up as ``repro_torch.launch.train`` does, takes ``--warmup``
iterations, then profiles one more iteration and one log-likelihood
evaluation with ``torch.profiler`` (CPU and CUDA activities). For each it
prints one JSON line: the wall time (host clock, ending in a
synchronize), the device busy time (sum of kernel times; one stream, so
kernels do not overlap), the idle share, and device time by kernel name.
``--trace PATH`` also writes the iteration's Chrome trace.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import hdp as H
from repro_torch.launch.train import build_parser, prepare_hdp


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profiled(fn, label: str, top: int, trace: str | None = None):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace:
        prof.export_chrome_trace(trace)
    by_kernel: dict[str, float] = defaultdict(float)
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.key] += _device_us(evt) / 1e3
    busy = sum(by_kernel.values())
    # names cut to 80 characters can meet: their times add up
    shown: dict[str, float] = defaultdict(float)
    for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]:
        shown[k[:80]] += v
    print(json.dumps({
        "phase": label, "wall_ms": wall_ms, "device_busy_ms": busy,
        "device_idle_share": (1.0 - busy / wall_ms) if wall_ms else None,
        "kernels_ms": dict(shown),
    }), flush=True)
    return out


def main(argv: list[str] | None = None) -> None:
    ap = build_parser()
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    if args.device != "cuda":
        raise SystemExit("error: profile_iteration measures the card (--device cuda)")
    corpus, cfg, tokens, mask, state = prepare_hdp(args)
    for _ in range(args.warmup):
        state = H.gibbs_iteration(state, tokens, mask, cfg)
    print(json.dumps({
        "corpus": args.hdp, "docs": corpus.num_docs, "tokens": corpus.num_tokens,
        "V": cfg.V, "K": cfg.K, "W": cfg.bucket, "z_impl": cfg.z_impl,
        "warmup_iters": args.warmup, "card": torch.cuda.get_device_name(0),
    }), flush=True)
    state = profiled(lambda: H.gibbs_iteration(state, tokens, mask, cfg),
                     "gibbs_iteration", args.top, args.trace)
    profiled(lambda: H.log_marginal_likelihood(state, tokens, mask, cfg),
             "log_marginal_likelihood", args.top)


if __name__ == "__main__":
    main()
