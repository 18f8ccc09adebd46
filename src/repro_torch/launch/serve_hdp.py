"""HDP topic-inference serving (counterpart of
``repro/launch/serve_hdp.py``): snapshot -> engine or fleet -> stats.

Loads a frozen ``ModelSnapshot`` (or, with --smoke/--train-iters, trains
one with the port's sampler), runs a query workload through the
continuous-batching engine, or with ``--workers`` through a replicated
``ServeFleet``, and prints one JSON line: docs/s, p50 and p95 latency,
steps and held-out fold-in perplexity.

  # end to end from nothing (a tiny model, 16 queries), on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.serve_hdp --smoke --device cpu

  # on the card, through a 2-worker fleet sharing it:
  PYTHONPATH=src python -m repro_torch.launch.serve_hdp --smoke --workers 2

  # serve an exported snapshot against a synthetic AP-like workload:
  PYTHONPATH=src python -m repro_torch.launch.serve_hdp \\
      --snapshot "${TMPDIR:-/tmp}"/snap --corpus ap --scale 0.01 \\
      --requests 256 --slots 32

  # serve a registry's latest version, hot-swapping on publish, with a
  # 3-sample posterior ensemble:
  PYTHONPATH=src python -m repro_torch.launch.serve_hdp \\
      --registry "${TMPDIR:-/tmp}"/hdp_reg --workers 2 --watch-registry --ensemble 3

``--trace PATH`` writes the requests' spans as a Chrome trace and
``--metrics PATH`` appends metrics snapshots (JSONL): the queue-wait,
service and latency histograms, queue depths and SLO counters.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.hdp_z import hdp_z as HZ
from repro_torch.serve import eval as EV
from repro_torch.serve import snapshot as SNAP
from repro_torch.serve.engine import DEFAULT_BUCKETS, ServeEngine


def train_tiny_snapshot(args, device: torch.device):
    """Fit a small model on a planted-topics corpus with the port's
    sampler and distill it: the from-scratch path of --smoke. The corpus
    tail (--eval-docs documents) is held out of training and returned as
    the perplexity batch."""
    from repro_torch.core import hdp as H
    from repro_torch.data.synthetic import planted_topics_corpus

    rng = np.random.default_rng(args.seed)
    n_eval = max(args.eval_docs, 1)
    corpus, _ = planted_topics_corpus(rng, D=args.train_docs + n_eval, V=args.vocab,
                                      K_true=3, doc_len=(10, 24))
    cfg = H.HDPConfig(K=args.topics, V=corpus.V, bucket=args.topics,
                      z_impl="cuda", hist_cap=64)
    tokens = torch.from_numpy(corpus.tokens[:args.train_docs]).to(device)
    mask = torch.from_numpy(corpus.mask[:args.train_docs]).to(device)
    state = H.init_state(H.make_generator(args.seed, device), tokens, mask, cfg)
    for _ in range(args.train_iters):
        state = H.gibbs_iteration(state, tokens, mask, cfg)
    snap = SNAP.snapshot_from_state(state, cfg, compact=args.compact)
    if args.export:
        SNAP.save(args.export, snap)
        print(f"exported snapshot (it={int(snap.it)}) to {args.export}")
    heldout = (corpus.tokens[args.train_docs:], corpus.mask[args.train_docs:])
    return snap, heldout


def make_workload(args, snap: SNAP.ModelSnapshot, heldout):
    """Variable-length query documents and a held-out eval batch. Queries
    come from a corpus replica (--corpus) or are uniform random; the eval
    batch is the held-out tail of the training corpus or of the replica,
    else uniform random documents (throughput only: the perplexity is then
    a score against noise, flagged ``eval_synthetic``)."""
    rng = np.random.default_rng(args.seed + 1)
    n_eval = max(args.eval_docs, 1)
    if args.corpus:
        from repro_torch.data.synthetic import paper_corpus

        corpus = paper_corpus(args.corpus, rng, scale=args.scale,
                              max_len=max(DEFAULT_BUCKETS))
        docs = [corpus.tokens[i][corpus.mask[i]] % snap.V
                for i in range(min(args.requests, corpus.num_docs))]
        if heldout is None and corpus.num_docs > args.requests:
            tail = slice(args.requests, args.requests + n_eval)
            heldout = (corpus.tokens[tail] % snap.V, corpus.mask[tail])
    else:
        lengths = rng.integers(args.min_len, args.max_len + 1, size=args.requests)
        docs = [rng.integers(0, snap.V, size=int(n)).astype(np.int32)
                for n in lengths]
    if heldout is not None:
        ev_tokens, ev_mask = heldout
    else:
        elen = max(args.max_len, 16)
        ev_tokens = np.zeros((n_eval, elen), np.int32)
        ev_mask = np.zeros((n_eval, elen), bool)
        for i in range(n_eval):
            n = int(rng.integers(8, elen + 1))
            ev_tokens[i, :n] = rng.integers(0, snap.V, size=n)
            ev_mask[i, :n] = True
    return docs, np.asarray(ev_tokens), np.asarray(ev_mask), heldout is None


def _serve_fleet(args, snap, docs, device):
    """The workload through a ServeFleet: from --registry when given (a
    freshly trained snapshot is published into it first), else from the
    snapshot itself."""
    from repro_torch.serve.fleet import ServeFleet
    from repro_torch.serve.registry import SnapshotRegistry

    source = snap
    if args.registry:
        reg = SnapshotRegistry(args.registry)
        if args.smoke or args.train_iters:
            v = reg.publish(snap)
            print(f"published trained snapshot as v{v} in {args.registry}")
        source = reg
    with ServeFleet(
        source, workers=args.workers, slots=args.slots, burnin=args.burnin,
        impl=args.impl, buckets=tuple(args.buckets), base_seed=args.seed,
        ensemble=args.ensemble, watch_registry=args.watch_registry,
        slo_ms=args.slo_ms, device=device,
    ) as fleet:
        rids = [fleet.submit(doc) for doc in docs]
        mixtures = fleet.run()
        stats = fleet.stats_summary()
    return rids, mixtures, stats


def serve(args) -> dict:
    device = resolve_device(args.device)
    if device.type == "cuda" and args.impl == "cuda":
        _build.build_all(HZ.SOURCES)
    heldout = None
    if args.snapshot and not args.smoke and not args.train_iters:
        snap = SNAP.load(args.snapshot, device=device)
    elif args.registry and not args.smoke and not args.train_iters:
        from repro_torch.serve.registry import SnapshotRegistry

        snap = SnapshotRegistry(args.registry).load(device=device)
    else:
        snap, heldout = train_tiny_snapshot(args, device)
    print(f"snapshot: K={snap.K} V={snap.V} W={snap.W} compact={snap.compact} "
          f"({snap.nbytes() / 1e6:.2f} MB)")

    docs, ev_tokens, ev_mask, ev_synth = make_workload(args, snap, heldout)
    if args.workers:
        rids, mixtures, stats = _serve_fleet(args, snap, docs, device)
    else:
        engine = ServeEngine(snap, slots=args.slots, burnin=args.burnin,
                             impl=args.impl, buckets=tuple(args.buckets),
                             base_seed=args.seed)
        rids = [engine.submit(doc) for doc in docs]
        mixtures = engine.run()
        stats = engine.stats.summary()

    # every accepted request comes back as a valid mixture
    if len(mixtures) != len(rids):
        raise RuntimeError(f"{len(mixtures)} mixtures for {len(rids)} requests")
    for rid in rids:
        th = mixtures[rid]
        if th.shape != (snap.K,) or not np.all(th >= 0) or abs(float(th.sum()) - 1.0) > 1e-4:
            raise RuntimeError(f"request {rid}: not a mixture over {snap.K} topics")

    t0 = time.perf_counter()
    perplexity = EV.heldout_perplexity(snap, ev_tokens, ev_mask, args.seed + 2,
                                       burnin=args.burnin, impl=args.impl)
    eval_s = time.perf_counter() - t0

    out = {
        "mode": "serve_hdp",
        "impl": args.impl,
        "device": str(device),
        "snapshot": {"K": snap.K, "V": snap.V, "W": snap.W,
                     "compact": snap.compact, "it": int(snap.it),
                     "mbytes": round(snap.nbytes() / 1e6, 3)},
        "requests": len(rids),
        "burnin": args.burnin,
        "slots": args.slots,
        **stats,
        "heldout_perplexity": round(perplexity, 3),
        # True when the eval batch is uniform noise: the perplexity is then
        # a smoke number, not a model-quality metric
        "eval_synthetic": ev_synth,
        "eval_docs": int(ev_tokens.shape[0]),
        "eval_s": round(eval_s, 2),
        "sample_mixture_top3": sorted(np.asarray(mixtures[rids[0]]).tolist(),
                                      reverse=True)[:3],
    }
    print(json.dumps(out), flush=True)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--snapshot", default=None,
                    help="snapshot dir to load (serve/snapshot.py)")
    ap.add_argument("--export", default=None,
                    help="export the freshly trained snapshot here")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny end-to-end run: train, export, serve, eval")
    ap.add_argument("--impl", default="cuda", choices=["dense", "sparse", "cuda"])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--burnin", type=int, default=8)
    ap.add_argument("--buckets", type=int, nargs="+", default=list(DEFAULT_BUCKETS))
    ap.add_argument("--workers", type=int, default=0,
                    help="serve through a fleet of N engine workers "
                         "(0 = one engine)")
    ap.add_argument("--ensemble", type=int, default=1,
                    help="average each request's mixtures over the E newest "
                         "registry versions (needs --registry)")
    ap.add_argument("--registry", default=None,
                    help="snapshot registry dir to serve from (its latest "
                         "version; a freshly trained snapshot is published "
                         "into it)")
    ap.add_argument("--watch-registry", action="store_true",
                    help="hot-swap fleet workers onto newly published "
                         "versions between engine steps")
    ap.add_argument("--corpus", default=None,
                    help="ap|cgcbib|neurips|pubmed synthetic query workload")
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--min-len", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=48)
    ap.add_argument("--eval-docs", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compact", action="store_true",
                    help="bf16/int16 snapshot tables")
    # training for --smoke and --train-iters
    ap.add_argument("--train-iters", type=int, default=0)
    ap.add_argument("--train-docs", type=int, default=64)
    ap.add_argument("--topics", type=int, default=16)
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="end-to-end latency SLO: count completions as ok or "
                         "miss (fleet mode)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda with no card is an error")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the requests' spans as a Chrome trace to PATH")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="append metrics snapshots (JSONL) to PATH")
    return ap


def main(argv: list[str] | None = None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.smoke and not args.train_iters:
        args.train_iters = 20
    if not args.snapshot and not args.registry and not args.train_iters:
        ap.error("need --snapshot, --registry, --smoke, or --train-iters")
    if (args.watch_registry or args.ensemble > 1) and not args.workers:
        ap.error("--watch-registry/--ensemble serve through the fleet: "
                 "pass --workers N")
    if (args.watch_registry or args.ensemble > 1) and not args.registry:
        ap.error("--watch-registry/--ensemble need --registry")
    if args.slo_ms is not None and not args.workers:
        ap.error("--slo-ms is accounted by the fleet router: pass --workers N")
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None
    obs.setup(trace=args.trace, metrics_path=args.metrics)
    try:
        serve(args)
        obs.flush_metrics(force=True)
    finally:
        obs.finalize()


if __name__ == "__main__":
    main()
