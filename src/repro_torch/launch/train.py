"""Training driver (counterpart of ``repro/launch/train.py``): the HDP
sampler on one device, on a grid of ranks under ``torchrun``, with sweep
lanes on several devices, and LM training.

  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
      --steps 8 --batch 4 --seq 512                 # LM, on the card
  ... --arch hymba-1.5b --smoke --device cpu --steps 3   # reduced, CPU
  ... --ckpt DIR --ckpt-every 50                    # resumable
  PYTHONPATH=src python -m repro_torch.launch.train --hdp ap --scale 0.01 \
      --iters 2 --topics 20 --max-len 64            # on the card
  ... --device cpu                                  # plain versions, CPU
  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
      --hdp ap --scale 0.01 --iters 2 --topics 20 --max-len 64 --device cpu
                                                    # 4 ranks (gloo), a grid
  ... --stream --block-docs 16 --ckpt DIR --ckpt-every 1 --ckpt-every-blocks 2
                                                    # block-streamed, resumable
  ... --stream --block-docs 16 --devices 4          # 4 sweep lanes
  ... --trace t.json --metrics m.jsonl              # Chrome trace, metrics

Prints one dict per ``--log-every`` iterations, then a JSON summary line.
Under ``torchrun`` with ``--hdp`` each rank runs
``core/sharded.py::ShardedHDP`` on the grid
``launch/mesh.py::host_grid_shape`` gives the world (as the
reference runs ``ShardedHDP`` on ``make_host_mesh``): gloo with
``--device cpu``, NCCL on ``cuda:{LOCAL_RANK}`` otherwise (one card a
rank; NCCL refuses two ranks on one card, and that raises), and rank 0
alone prints.
With ``--stream`` the corpus is swept block by block
(``core/streaming.py``); a rerun with the same ``--ckpt`` resumes from
its latest checkpoint, mid-iteration too, and prints
``restored streaming state: iteration N, block cursor C``. ``--devices
N`` splits each block's rows over N sweep lanes (one card: N streams;
the chain is bitwise ``--devices 1``'s). ``--trace`` writes the run's
spans as a Chrome trace, ``--metrics`` appends metrics snapshots (JSONL,
``launch/monitor.py`` reads them) and turns on the per-iteration health
gauges.

Without ``--stream``, ``--ckpt DIR`` saves the sampler's whole state
every ``--ckpt-every`` iterations (the generator's state too; under
``torchrun`` at logical shape, rank 0 writing) and a rerun resumes from
the latest checkpoint, printing ``restored HDP state at iteration N``;
the resumed chain is bitwise the uninterrupted one.

``--arch`` takes ``--steps`` AdamW steps on the synthetic LM stream
(``data/lm_data.py``), with both LM kernels on the card in every
forward and every recompute, and prints one JSON line: the reference's
keys (arch, steps, first_loss, final_loss, tokens_per_s,
deadline_breaches, history), the device and the peak device memory.
A rerun with the same ``--ckpt`` resumes from its latest checkpoint.
Under ``torchrun`` the ranks train it sharded
(``train/sharding.py``): parameters and moments placed by the
reference's ``train_rules`` on ``Grid.for_world``, the global batch of
``--batch`` sequences split over the batch axes, gloo with ``--device
cpu`` and NCCL on ``cuda:{LOCAL_RANK}`` otherwise; checkpoints are at
logical shape and resume on any grid; rank 0 prints the summary, whose
``tokens_per_s`` counts the global batch, with each rank's peak memory.

  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
      --arch deepseek-moe-16b --smoke --steps 3 --batch 4 --seq 32 --device cpu
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core import hdp as H
from repro_torch.core.collectives import Collectives
from repro_torch.core.sharded import ShardedHDP, ShardState
from repro_torch.core.streaming import StreamingHDP
from repro_torch.data.corpus import shard_balanced
from repro_torch.data.lm_data import SyntheticLMStream, batches
from repro_torch.data.stream import ShardedCorpusStore
from repro_torch.data.synthetic import paper_corpus
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.hdp_z import hdp_z as HZ
from repro_torch.kernels.ssd import ssd as SSD
from repro_torch.launch import mesh as MESH
from repro_torch.models.config import LMConfig
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import sharding as SHD
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, batch_tensors, make_train_step


def train_lm(args: argparse.Namespace, cfg: LMConfig | None = None):
    """``args.steps`` AdamW steps of ``cfg`` (by default ``args.arch``'s
    config, reduced with ``args.smoke``) on the synthetic LM stream,
    resuming from ``args.ckpt``'s latest checkpoint. A caller passes
    ``cfg`` to train a depth cut; the CLI has no flag for it. The clock
    runs from a synchronize after the kernels' build and the model's
    init to the last step's end; ``peak_mem_gib`` is the card's peak
    over the same span. Returns the final state, the logged history
    and the printed summary.

    Started by ``torchrun``, it runs ``train_lm_sharded`` instead."""
    launch = MESH.torchrun_env()
    if launch is not None:
        return train_lm_sharded(args, launch, cfg)
    device = resolve_device(args.device)
    cfg, opt = _lm_setup(args, cfg, device)
    trainer = Trainer(cfg, opt, make_train_step(cfg, opt),
                      checkpoint_dir=args.ckpt,
                      checkpoint_every=args.ckpt_every or 50,
                      step_deadline_s=args.deadline, device=device)
    state, history, summary = _lm_run(args, cfg, device, trainer)
    print(json.dumps(summary), flush=True)
    return state, history, summary


def _lm_setup(args: argparse.Namespace, cfg: LMConfig | None,
              device: torch.device):
    """The run's config (``args.arch``'s unless given) and optimizer; on
    the card, the LM kernels built."""
    if cfg is None:
        cfg = get_config(args.arch, smoke=args.smoke)
    if device.type == "cuda":
        _build.build_all([*FA.SOURCES, *SSD.SOURCES])
    return cfg, AdamWConfig(lr=args.lr, warmup=20)


def _lm_run(args: argparse.Namespace, cfg: LMConfig, device: torch.device,
            trainer, rows=lambda batch: batch):
    """The trainer's restored or new state, then ``args.steps`` steps on
    the stream (``rows`` of each global batch), on ``train_lm``'s clock
    and peak. Returns the state, the history and the summary."""
    stream = SyntheticLMStream(cfg.vocab_size, args.batch, args.seq,
                               prefix_len=cfg.prefix_len, d_model=cfg.d_model)
    state = trainer.restore_or_init(args.seed)
    synchronize(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    data = (batch_tensors(rows(b), device)
            for b in batches(stream, args.steps, start=state.step))
    state, history = trainer.run(state, data, log_every=args.log_every)
    dt = time.perf_counter() - t0
    summary = {
        "arch": cfg.name, "steps": args.steps,
        "first_loss": history[0]["loss"] if history else None,
        "final_loss": history[-1]["loss"] if history else None,
        "tokens_per_s": args.steps * args.batch * args.seq / dt,
        "deadline_breaches": trainer.deadline_breaches,
        "history": history, "device": str(device),
        "peak_mem_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                         if device.type == "cuda" else None),
    }
    return state, history, summary


def _start_ranks(args: argparse.Namespace, launch: MESH.LaunchEnv):
    """Bind this rank's device and start the default process group:
    ``(device, backend)``, gloo on the CPU, NCCL on ``cuda:{LOCAL_RANK}``."""
    device = resolve_device(args.device)
    backend = "gloo" if device.type == "cpu" else "nccl"
    if device.type == "cuda":
        device = torch.device("cuda", launch.local_rank)
    MESH.init_distributed(backend, device, rank=launch.rank,
                          world_size=launch.world_size,
                          local_rank=launch.local_rank,
                          local_world_size=launch.local_world_size)
    return device, backend


def train_lm_sharded(args: argparse.Namespace, launch: MESH.LaunchEnv,
                     cfg: LMConfig | None = None):
    """One rank of the sharded LM run (the reference's ``train_lm`` on a
    mesh over every device): ``train_lm`` with the parameters and both
    moments sharded by ``train_rules`` over ``Grid.for_world``, each rank
    taking its rows of every global batch. The clock and the peak are
    ``train_lm``'s, on each rank; rank 0 prints the summary, whose
    ``tokens_per_s`` counts the global batch, ``peak_mem_gib_by_rank``
    holds each rank's peak (``peak_mem_gib`` the largest) and
    ``bytes_by_collective`` this rank's bytes over the steps. At world 1
    the run is bitwise ``train_lm``'s. Returns what ``train_lm`` returns,
    on every rank (the state is the rank's shards)."""
    device, backend = _start_ranks(args, launch)
    try:
        grid = MESH.Grid.for_world(launch.world_size, launch.rank)
        comm = SHD.make_comm(grid, backend, device)
        cfg, opt = _lm_setup(args, cfg, device)
        layout = SHD.Layout(cfg, comm)
        trainer = SHD.ShardedTrainer(
            cfg, opt, layout, SHD.make_sharded_train_step(opt, layout, args.batch),
            checkpoint_dir=args.ckpt, checkpoint_every=args.ckpt_every or 50,
            step_deadline_s=args.deadline)
        state, history, summary = _lm_run(
            args, cfg, device, trainer, rows=lambda b: SHD.local_batch(grid, b))
        peak = summary["peak_mem_gib"]
        peaks = comm.all_gather(torch.tensor([peak or 0.0], dtype=torch.float64,
                                             device=device), grid.axes, 0).tolist()
        summary.update({
            "peak_mem_gib": max(peaks) if peak is not None else None,
            "peak_mem_gib_by_rank": peaks if peak is not None else None,
            "ranks": grid.world_size, "backend": backend,
            "grid": dict(zip(grid.axes, grid.shape)),
            "bytes_by_collective": dict(comm.sent)})
        if grid.rank == 0:
            print(json.dumps(summary), flush=True)
        return state, history, summary
    finally:
        dist.destroy_process_group()


def hdp_corpus_config(args: argparse.Namespace):
    """The synthetic paper corpus and the sampler's config of a run."""
    rng = np.random.default_rng(args.seed)
    corpus = paper_corpus(args.hdp, rng, scale=args.scale, max_len=args.max_len)
    k_topics = args.topics
    bucket = (min(k_topics, corpus.max_len) if args.bucket is None
              else args.bucket)
    cfg = H.HDPConfig(K=k_topics, V=corpus.V, bucket=bucket,
                      z_impl=args.z_impl, hist_cap=min(corpus.max_len, 256))
    return corpus, cfg


def prepare_hdp(args: argparse.Namespace):
    """Corpus, config, device tensors and initial state of an HDP run:
    ``(corpus, cfg, tokens, mask, state)``."""
    device = resolve_device(args.device)
    corpus, cfg = hdp_corpus_config(args)
    tokens = torch.from_numpy(corpus.tokens).to(device)
    mask = torch.from_numpy(corpus.mask).to(device)
    state = H.init_state(H.make_generator(args.seed, device), tokens, mask, cfg)
    synchronize(device)
    return corpus, cfg, tokens, mask, state


def save_hdp(ckpt_dir: str, state: H.HDPState) -> str:
    """Checkpoint the whole ``HDPState`` at step ``state.it``: the arrays,
    the iteration and the generator's state."""
    return CKPT.save(ckpt_dir, state.it, {
        "z": state.z, "n": state.n, "phi": state.phi, "varphi": state.varphi,
        "psi": state.psi, "l": state.l, "it": np.int32(state.it),
        "gen": state.gen.get_state()})


def restore_hdp(ckpt_dir: str, like: H.HDPState) -> H.HDPState | None:
    """The latest checkpoint of ``ckpt_dir`` (None when there is none) as
    an ``HDPState`` on ``like``'s device, its generator (``like``'s,
    advanced in place) set to the saved state."""
    got = CKPT.restore_latest(ckpt_dir, {
        "z": like.z, "n": like.n, "phi": like.phi, "varphi": like.varphi,
        "psi": like.psi, "l": like.l, "it": 0, "gen": like.gen.get_state()})
    if got is None:
        return None
    if tuple(got["z"].shape) != tuple(like.z.shape):
        raise ValueError(f"checkpoint z {tuple(got['z'].shape)} does not match "
                         f"the corpus {tuple(like.z.shape)}")
    like.gen.set_state(got["gen"])
    return H.HDPState(z=got["z"], n=got["n"], phi=got["phi"], varphi=got["varphi"],
                      psi=got["psi"], l=got["l"], gen=like.gen, it=int(got["it"]))


def train_hdp(
    args: argparse.Namespace,
    on_iteration: Callable[[H.HDPState, torch.Tensor, torch.Tensor,
                            H.HDPConfig], None] | None = None,
):
    """Run ``args.iters`` Gibbs iterations on a synthetic paper corpus.

    ``sec_per_iter`` and ``tokens_per_s`` time the Gibbs iterations
    alone: the clock runs from a synchronize before each iteration to one
    after it, and leaves out the logging and ``on_iteration(state,
    tokens, mask, cfg)``, which, when given, is called after every
    iteration. On the card the kernels are built before the first
    iteration. Returns the final state, the logged history and the
    printed summary.

    Started by ``torchrun``, it runs ``train_hdp_sharded`` instead, and
    ``on_iteration`` gets ``(sh, state, tokens, mask)``: the
    ``ShardedHDP``, the rank's ``ShardState`` and its documents.
    """
    launch = MESH.torchrun_env()
    if launch is not None:
        return train_hdp_sharded(args, launch, on_iteration)
    corpus, cfg, tokens, mask, state = prepare_hdp(args)
    device = tokens.device
    if device.type == "cuda" and cfg.z_impl == "cuda":
        _build.build_all(HZ.SOURCES)
    if args.ckpt:
        got = restore_hdp(args.ckpt, state)
        if got is not None:
            state = got
            print(f"restored HDP state at iteration {state.it}", flush=True)

    history = []
    dt = 0.0
    for i in range(args.iters):
        synchronize(device)
        t0 = time.perf_counter()
        state = H.gibbs_iteration(state, tokens, mask, cfg)
        synchronize(device)
        dt += time.perf_counter() - t0
        if (i + 1) % args.log_every == 0:
            ll = float(H.log_marginal_likelihood(state, tokens, mask, cfg))
            history.append({
                "iter": int(state.it), "log_lik": ll,
                "active_topics": int(H.active_topics(state)),
                "flag_tokens": int(H.flag_topic_tokens(state)),
            })
            print(history[-1], flush=True)
        if on_iteration is not None:
            on_iteration(state, tokens, mask, cfg)
        if args.ckpt and (i + 1) % (args.ckpt_every or 1) == 0:
            save_hdp(args.ckpt, state)
    summary = {
        "corpus": args.hdp, "tokens": corpus.num_tokens,
        "iters": args.iters, "sec_per_iter": dt / args.iters,
        "tokens_per_s": corpus.num_tokens * args.iters / dt,
        "device": str(device), "z_impl": cfg.z_impl,
    }
    print(json.dumps(summary), flush=True)
    return state, history, summary


def train_hdp_sharded(
    args: argparse.Namespace, launch: MESH.LaunchEnv,
    on_iteration: Callable[[ShardedHDP, ShardState, torch.Tensor,
                            torch.Tensor], None] | None = None,
):
    """One rank of the data-parallel run (the reference's ``train_hdp`` on
    a mesh over every device): the corpus ``shard_balanced`` over the
    ranks, V padded to a multiple of the ``model`` axis, every iteration
    ``ShardedHDP.iteration`` on the rank's documents. The clock is
    ``train_hdp``'s, on each rank; rank 0 prints the log lines and the
    summary, whose ``tokens_per_s`` counts the whole corpus. The kernels
    are built before the first iteration, once for all the ranks of a
    host (``kernels/_build.py`` locks each build). Returns what
    ``train_hdp`` returns, on every rank."""
    device, backend = _start_ranks(args, launch)
    try:
        grid = MESH.Grid.for_world(launch.world_size, launch.rank)
        corpus, cfg = hdp_corpus_config(args)
        corpus = shard_balanced(corpus, grid.world_size)
        m = grid.size("model")
        cfg = cfg._replace(V=-(-corpus.V // m) * m)
        sh = ShardedHDP(Collectives(grid, backend, device), cfg)
        rows = sh.doc_rows(corpus.num_docs)
        tokens = torch.from_numpy(corpus.tokens[rows]).to(device)
        mask = torch.from_numpy(corpus.mask[rows]).to(device)
        if device.type == "cuda" and cfg.z_impl == "cuda":
            _build.build_all(HZ.SOURCES)
        state = sh.init_state(args.seed, tokens, mask)
        lead = grid.rank == 0
        if args.ckpt:
            got = sh.restore(args.ckpt, tokens.shape[1], doc_ranks=grid.world_size)
            if got is not None:
                state = got
                if lead:
                    print(f"restored HDP state at iteration {state.it}", flush=True)
        history = []
        dt = 0.0
        for i in range(args.iters):
            synchronize(device)
            t0 = time.perf_counter()
            state = sh.iteration(state, tokens, mask)
            synchronize(device)
            dt += time.perf_counter() - t0
            if (i + 1) % args.log_every == 0:
                history.append({"iter": state.it,
                                **sh.diagnostics(state, tokens, mask)})
                if lead:
                    print(history[-1], flush=True)
            if on_iteration is not None:
                on_iteration(sh, state, tokens, mask)
            if args.ckpt and (i + 1) % (args.ckpt_every or 1) == 0:
                sh.save(args.ckpt, state)
        summary = {
            "corpus": args.hdp, "tokens": corpus.num_tokens,
            "iters": args.iters, "sec_per_iter": dt / args.iters,
            "tokens_per_s": corpus.num_tokens * args.iters / dt,
            "device": str(device), "z_impl": cfg.z_impl,
            "ranks": grid.world_size, "backend": backend,
            "grid": dict(zip(grid.axes, grid.shape)),
        }
        if lead:
            print(json.dumps(summary), flush=True)
        return state, history, summary
    finally:
        dist.destroy_process_group()


def train_hdp_streaming(args: argparse.Namespace):
    """The block-streamed run (counterpart of the reference's
    ``train_hdp_streaming``): the corpus swept ``--block-docs`` documents
    at a time, z slabs in ``--z-store`` (the disk store's files under
    ``--z-dir``, by default the checkpoint directory, which makes saves
    nearly free), resumable mid-iteration from ``--ckpt``. The clock
    covers the iterations alone; checkpoint saves between iterations and
    the logging are off it. Returns the final state, the logged history
    and the printed summary."""
    device = resolve_device(args.device)
    corpus, cfg = hdp_corpus_config(args)
    store = ShardedCorpusStore.from_corpus(corpus, args.block_docs)
    stream = StreamingHDP(cfg, store, device=device, z_store=args.z_store,
                          z_dir=args.z_dir or args.ckpt, z_pack=args.z_pack,
                          block_sparse_tables=args.block_sparse_tables,
                          n_lanes=args.devices)
    if device.type == "cuda" and cfg.z_impl == "cuda":
        _build.build_all(HZ.SOURCES)
    state, resume_kw = None, {}
    if args.ckpt:
        state, resume_kw = stream.restore(args.ckpt)
        if state is not None:
            print(f"restored streaming state: iteration {state.it}, "
                  f"block cursor {resume_kw.get('start_block', 0)}", flush=True)
    if state is None:
        state = stream.init_state(args.seed)
    print(f"streaming: {store.num_blocks} blocks x {store.block_docs} docs "
          f"(corpus {store.num_docs} docs, {store.num_tokens} tokens), z slabs "
          f"in {state.z_blocks.kind} as {state.z_blocks.dtype}, "
          f"{stream.n_lanes} sweep lane(s)", flush=True)
    history = []
    dt = 0.0
    for i in range(args.iters):
        synchronize(device)
        t0 = time.perf_counter()
        state = stream.iteration(state, ckpt_dir=args.ckpt,
                                 ckpt_every_blocks=args.ckpt_every_blocks,
                                 **resume_kw)
        synchronize(device)
        dt += time.perf_counter() - t0
        resume_kw = {}
        if (i + 1) % args.log_every == 0:
            history.append({
                "iter": state.it,
                "active_topics": int((state.n.sum(1) > 0).sum()),
                "flag_tokens": int(state.n[-1].sum()),
            })
            print(history[-1], flush=True)
        if args.ckpt and (i + 1) % (args.ckpt_every or 1) == 0:
            stream.save(args.ckpt, state)
    summary = {
        "corpus": args.hdp, "tokens": store.num_tokens, "mode": "streaming",
        "blocks": store.num_blocks, "iters": args.iters,
        "z_store": state.z_blocks.kind, "z_dtype": state.z_blocks.dtype.name,
        "block_sparse_tables": stream.block_sparse_tables,
        "sweep_lanes": stream.n_lanes,
        "delta_reduce_mb": stream.delta_reduce_bytes / 2**20,
        "sec_per_iter": dt / args.iters,
        "tokens_per_s": store.num_tokens * args.iters / dt,
        "device": str(device), "z_impl": cfg.z_impl,
    }
    print(json.dumps(summary), flush=True)
    return state, history, summary


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--hdp", help="ap|cgcbib|neurips|pubmed")
    what.add_argument("--arch", help="LM architecture to train (hymba-1.5b)")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config (--arch)")
    ap.add_argument("--steps", type=int, default=50, help="AdamW steps (--arch)")
    ap.add_argument("--batch", type=int, default=8, help="sequences a step (--arch)")
    ap.add_argument("--seq", type=int, default=128, help="tokens a sequence (--arch)")
    ap.add_argument("--lr", type=float, default=1e-3, help="peak learning rate (--arch)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="seconds a step may take before it counts as a "
                         "deadline breach (--arch)")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--topics", type=int, default=100)
    ap.add_argument("--bucket", type=int, default=None,
                    help="table slots per word (W) for the cuda z-step; "
                         "default min(topics, max doc length)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda with no card is an error")
    ap.add_argument("--z-impl", default="cuda", choices=H.Z_IMPLS)
    ap.add_argument("--stream", action="store_true",
                    help="sweep the corpus block by block (core/streaming.py)")
    ap.add_argument("--block-docs", type=int, default=1024,
                    help="documents a block (--stream)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory; a rerun resumes from it "
                         "(--hdp with or without --stream, and --arch)")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="iterations between checkpoints (--hdp; default 1; "
                         "with --stream at iteration boundaries), steps "
                         "between checkpoints (--arch; default 50)")
    ap.add_argument("--ckpt-every-blocks", type=int, default=None,
                    help="blocks between mid-iteration checkpoints (--stream)")
    ap.add_argument("--z-store", default="ram", choices=("ram", "disk"),
                    help="where z slabs live (--stream)")
    ap.add_argument("--z-dir", default=None,
                    help="root of the disk store's files; default --ckpt (--stream)")
    ap.add_argument("--z-pack", default="auto", choices=("auto", "off"),
                    help="pack z slabs to uint8/uint16 (--stream)")
    ap.add_argument("--block-sparse-tables", default="auto",
                    choices=("auto", "on", "off"),
                    help="tables only for the corpus's words (--stream)")
    ap.add_argument("--devices", type=int, default=1,
                    help="sweep lanes: each block's rows split over this many "
                         "lanes, on the one card a stream each; the chain is "
                         "bitwise --devices 1's (--stream)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the run's spans as a Chrome trace to PATH")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="append metrics snapshots (JSONL) to PATH; also "
                         "turns on the per-iteration health gauges")
    ap.add_argument("--metrics-every", type=float, default=None,
                    help="seconds between periodic metrics snapshots "
                         "(default: iteration boundaries only)")
    return ap


def main(argv: list[str] | None = None):
    """Run the CLI; returns what the training function returns (the final
    state, the logged history and the printed summary)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.devices != 1 and not args.stream:
        ap.error("--devices sets the streamed trainer's sweep lanes: pass --stream")
    if MESH.torchrun_env() is not None and args.stream:
        ap.error("under torchrun the ranks run the sharded HDP sampler or the "
                 "sharded LM trainer: pass --hdp without --stream, or --arch")
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None
    obs.setup(trace=args.trace, metrics_path=args.metrics,
              metrics_every_s=args.metrics_every)
    try:
        if args.arch:
            return train_lm(args)
        return (train_hdp_streaming if args.stream else train_hdp)(args)
    finally:
        obs.finalize()


if __name__ == "__main__":
    main()
