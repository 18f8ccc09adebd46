#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, none wrapped in a ``try``; any failure exits non-zero:
  1. environment: the card (nvidia-smi), torch and CUDA versions, and the
     seven kernel sources (hdp_z_lanes and hdp_z, flash_attention on the
     CUDA cores, flash_fwd_sm90 on the tensor cores, ssd_chunk on the
     CUDA cores, ssd_chunk_sm90 and ssd_chunk_sm90_wide on the tensor
     cores) built from ``csrc``, one nvcc each, all started together;
     the registers, spills (ptxas) and dynamic shared memory of the
     lanes hdp_z kernel and of the three tensor-core kernels, the CTAs
     an SM holds of the N <= 32 SSD one, and the wide SSD kernel's plan
     at mamba2-780m's shape (head groups, units, grid);
  2. hdp_z against its plain version on the card: every variant of
     emit_delta x table mode (float32 tables, compact bf16/int16 tables,
     prologue: the alias built in the kernel) at K in {2, 3, 257,
     1000} and W in {8, 33, 64, 256}, value- and topic-ordered tables,
     odd D, L=24 (L=23 at W=33, where the lanes kernel reads positions
     and rows in scalars), ragged masked padding, words with zero mass
     and words with every count of live slots from 0 to W, all on the
     lanes route; and at K=4000, W=64 on the warp route; z, m and dn
     must be bitwise equal, n + dn == count_n(z_new), and each launch
     takes the route ``hdp_z.route`` gives;
  3. main path: ``repro_torch.launch.train`` takes 3 Gibbs iterations
     on the synthetic PubMed replica at --scale 0.01 (81,999 documents,
     K=1000, W=256, alias built in the kernel); after every iteration
     n == count_n(z), n.sum() == tokens, |sum(psi) - 1| < 1e-4, the
     flag topic is empty and the kernel's launch count rose by 1, on the
     lanes route;
  4. one sweep at the main path's shape on five inputs: the trained
     state in prologue mode, in table mode and on compact tables, random
     z, and a dense phi
     (every word's W slots live) with random z; on each the kernel
     against the plain version (bitwise), both timed with CUDA events,
     beside the warp kernel (the earlier design) on the same inputs,
     the words' live slots, the row bytes the first walk reads and the
     bound the card's memory rate and float32 rate set; then the whole
     z-step (table or support build plus sweep) with the alias built in
     the kernel and with tables built first, bitwise equal and both
     timed;
  5. flash attention and the SSD intra-chunk kernels against their plain
     versions on the card, in the working dtype, the plain versions'
     float32 products in full float32 (no TF32; the tensor-core SSD
     kernel gets float32 accuracy from three TF32 passes): attention at
     hymba's prefill shape (B=4,
     S=512, 25/5 heads, D=64, window 2048) in bf16 and float32, at
     S=4096 with window 2048, at ragged S=300 with a window larger than
     S, non-causal, group 1 and D in {16, 128} (atol 3e-2 bf16, 2e-5
     float32, those of tests/test_flash_attention.py); bf16 at D in
     {64, 128} on the tensor-core route (also S=64, S=37, non-causal,
     group 1, D=128 with a window), bf16 at D in {16, 32} and float32 on
     the CUDA-core route, each launch checked against its route; at the
     serving shape SDPA's error against the same plain version is
     printed beside the kernel's; SSD (atol 2e-4 on y, st and dec, that
     of tests/test_ssd.py), each launch on the route ``ssd.route``
     gives: at B=2, S=1024, H=50, P=64, N=16, chunk 128 with B and C
     shared by all heads (stride 0, as the model passes them); at the
     serving shape (B=4, S=512) with B and C stride 0 and contiguous per
     head, and with the model's dt and A; at S=128 (one chunk); at chunk
     64; at one odd shape (P=24, N=12, chunk 40) on the tensor cores and
     one (P=10, N=6, chunk 20) that the route leaves on the CUDA cores;
     one (P=36, N=44, chunk 40, B and C per head) on the wide route;
     on the model's dt and A both routes also against the plain version
     and a float64 oracle computed on the card (decays from float64
     segment sums), at 2e-4;
  6. the LM main path: ``repro_torch.launch.serve`` serves hymba-1.5b at
     full width (32 layers, d_model 1600, bf16 weights from a seed): 8
     requests of 512 tokens in batches of 4, 32 greedy tokens each; every
     logit finite, and each LM kernel launched 32 layers x 2 batches
     times, every flash and SSD launch on the tensor-core route. Then the
     serving rates: 1 warm-up batch off the clock and 5 timed batches,
     each batch's prefill and decode tok/s listed with their spread. Then prefill/decode consistency in float32 at full
     width and depth 4: decode logits after a prefill of S against the
     last logits of a prefill of S + 1;
  7. the LM kernels timed at the serving shape by CUDA events over
     back-to-back calls (beside the host time of one call), against
     their plain versions, their bound, and for attention
     ``F.scaled_dot_product_attention`` on the same inputs (timed only;
     the port never calls it) and the CUDA-core flash kernel, the
     earlier design, on the same bf16 inputs; these three also by their
     device time under ``torch.profiler``, which is what the kernels
     line reports for them, since their host cost a call exceeds it
     (the line's ``earlier_ms`` is the CUDA-core kernel by events);
     SSD by its device time under ``torch.profiler`` (the kernels line's
     ``ms``), by events, and on dt and A as the model at init feeds them
     (both routes held to the plain version and the float64 oracle
     there), beside the CUDA-core SSD
     kernel, the earlier design, on the same inputs by events
     (``earlier_ms``) and device time; the SSD bound prices the products
     at three TF32 passes on the tensor cores;
  8. the streamed main path, ``StreamingHDP.iteration`` on the corpus of
     phase 3 (K=1000, W=256, z slabs packed to uint16): (a) a one-block
     stream is bitwise the monolithic chain over 2 iterations; (b) 11
     blocks of 8,192 documents (the last padded), 2 iterations with the
     ram and the disk store, bitwise equal, n the recount of z, z in
     [0, K), and iteration 2's sweeps of the first block and of the
     padded last one (79 of 8,192 documents live), staged as the driver
     stages them, bitwise the plain version and the stream's z; (c)
     iteration 2 stopped after 5 blocks at a checkpoint, restored and
     finished, bitwise (b); (d) block-sparse tables (table mode) bitwise
     the default (prologue mode), on the whole corpus and on its first
     1,000 documents (4 blocks of 256), which miss words, so that some
     table rows are zero, with that store's first and last sweeps
     against the plain version as in (b); (e) every sweep on the
     lanes route, the sweep counts zeroed just before (b) and read just
     after; (f) one iteration streamed and monolithic on the corpus
     tiled 10x by documents (819,990 documents): s/iter, peak device
     memory (the streamed one must be lower) and the streamed
     iteration's phase split (``iteration_profiled``);
  9. HDP serving (``repro_torch/serve``) on a snapshot of phase 3's corpus
     (K=1000, W=256) trained 10 iterations from z drawn uniformly over K,
     queried with 2,048 documents of a PubMed 0.01 replica drawn with
     another seed: (a) hdp_z_cuda in table mode (no delta) against
     hdp_z_ref, bitwise in z and m, on both routes, at D in {1, 8, 32,
     33} x L in {32, 64, 128, 256}, on the float32 snapshot, its compact
     copy and a restricted one, with empty slots and mixed sweep counts;
     (b) the fold-in uniforms (Philox) on the card bitwise those on the
     CPU; (c) the engine (slots 32, burn-in 16, buckets 32-256), its
     sweep counts zeroed just before and read just after, bitwise direct
     ``foldin_docs``, with slots 8 and with async admission bitwise slots
     32 on a subset, every sweep on the lanes route; (d) a 2-worker fleet
     on the one card (a stream each) bitwise the engine; (e) a publishing
     ``StreamingHDP.run`` on phase 8's 11 blocks (2 iterations, its chain
     bitwise the run without publishing) and an ensemble=2 fleet over its
     registry, bitwise the mean of one engine on each version; (f)
     held-out perplexity of the snapshot and of its init (printed: the
     replica's documents are Zipf draws with no topics to learn), and on
     planted topics (500 training documents of 40-60 tokens, 200 held
     out) the port's sampler trained 15 iterations on the card from z
     uniform over K, and the truth, each below 0.9x the untrained
     (single-topic) init's; (g) the engine's docs/s and latencies, the
     fleet's docs/s, one engine step's wall and device time (profiler,
     every step's sweep record kept) and idle share (an upper estimate:
     the profiler may drop records of the small kernels), its parts, and
     the sweep at (32, 128) on both routes, with the bound of the words
     those 32 documents hold.
 10. the streamed trainer's sweep lanes on phase 8's 11 blocks (K=1000,
     W=256, z as uint16): (a) ``launch/train.py --stream --devices 4``
     (the main path, its hdp_z launches zeroed just before and read just
     after, all on the route ``hdp_z.route`` gives 2,048 documents) and 2
     lanes, and 4 lanes on the disk store with int32 slabs, each bitwise
     the one-lane chain over 3 iterations from phase 8's starting state
     (every z block, n, phi, varphi, psi, l, the generator); (b) in
     iteration 2's first block each lane's ``delta_sparsify`` and the
     ``deltawire`` round trip equal its dense delta, the merged delta the
     one-lane block's dn, the lanes' dh and z the block's; (c) a 4-lane
     iteration stopped after 5 blocks, restored and finished, bitwise;
     (d) 10 iterations with ``--metrics`` and ``--trace`` bitwise the
     silent chain, the JSONL carrying K*, delta sparsity, the
     log-likelihood, its ESS and each lane's ``train.phase_ms``, the
     trace ``sweep.d0..d3`` on 4 thread tracks overlapping in wall time,
     and ``launch/monitor.py`` rendering the file; (e) s/iter with 1, 2
     and 4 sweep lanes and their serialized split, the lanes' sweeps on
     the device (profiler), and the busy time of each thread of one
     traced streamed iteration on the corpus tiled 10x; (f) a 2-worker
     fleet with trace and metrics on: mixtures bitwise phase 9's engine,
     ``serve.latency_ms`` counting every request, every async span
     paired.
 11. hymba-1.5b training at its published width (32 layers, d_model
     1600, bf16, seed 0) on the synthetic LM stream, B=4, S=512: (a)
     ``FlashAttentionFn`` (bf16, 25/5 heads, D=64, window 2048) and
     ``SSDIntraChunkFn`` (H=50, P=64, N=16, chunk 128, float32, the
     model's dt and A, B and C as stride-0 views of (B, S, N) leaves), the
     kernel forwards, against plain autograd through ``attention_ref`` and
     ``ssd_intra_chunk_ref`` on the same card tensors: the forwards at
     3e-2 and 2e-4, each input gradient within ``FN_GRAD_REL`` of its
     largest magnitude; each backward timed by events beside the plain
     VJP alone, its bound and, for attention, SDPA's backward; (b) one
     loss and backward of the full model: every parameter's gradient
     present and finite, every block's attn.wq and ssm.in_proj gradient
     non-zero, each kernel launched twice a layer (forward, recompute);
     a warm step's split (forward, backward, AdamW, a no-grad forward as
     the recompute's measure) and one profiled step (device busy, idle
     share, the kernels' device time); (c) the main path,
     ``launch/train.py --arch hymba-1.5b --steps 8 --batch 4 --seq 512``:
     every loss finite, no step skipped, every step launching each kernel
     64 times on the tensor-core route and calling each plain version 32
     times (the backward's VJPs, no plain forward); tok/s, ms a step and
     the peak device memory; (d) at depth 4, full width: 4 steps, a
     checkpoint, 4 more restored from it, the losses within ``RESUME_REL``
     of an uninterrupted 8-step run (whose rerun's spread is printed).
 12. paligemma-3b and the flash kernels at head dims 192 and 256: (a) both
     routes at paligemma's prefill shape (B=4, S=768 = prefix 256 + prompt
     512, 8/1 heads, D=256) and at nemotron-4-340b's heads (B=1, S=512,
     96/8 heads, D=192), causal with and without a window of 200, bf16
     on the tensor cores and float32 on the CUDA cores, against the
     plain version (3e-2, 2e-5), each launch on the route ``FA.route``
     gives; each route timed at both shapes by profiler device time and
     by events beside SDPA (timed only), the plain version and
     ``flash_bound_ms``; (b) the main path, ``launch/serve.py --arch
     paligemma-3b`` at its published width and depth (18 layers, d_model
     2048, vocab 257,216, bf16, seed 0): 8 requests of 512 tokens after a
     256-position prefix of embeddings, batches of 4, 32 greedy tokens;
     the flash launches zeroed just before and read just after, 18 layers
     x 2 batches = 36, all on the tensor cores; every logit finite, every
     token in the vocabulary; prefill and decode tok/s and peak memory;
     (c) float32 at full width and depth 4: decode logits after a
     prefixed prefill against the last logits of a prefill one token
     longer, within ``CONSISTENCY_ATOL``, every attention on the CUDA-core
     route at D=256; (d) ``launch/topic_lm.py`` on the card (the port's
     sampler, 100 hdp_z sweeps, its mixtures as the LM's prefix): the
     conditioned loss below the unconditioned one.
 13. deepseek-moe-16b and the last reference configs: (a) flash bf16 on
     the tensor cores at D=128 at the prefill shapes (B=4, S=512) of
     deepseek (16/16 heads), llama4-scout (40/8), chatglm3 (32/2),
     qwen1.5 (40/40) and starcoder2-3b (24/2), and at D=64 at
     musicgen-medium's (B=4, S=768: a 256-position prefix and 512
     tokens, 24/24), and float32 on the CUDA cores at deepseek's, against
     the plain version (3e-2, 2e-5; SDPA's error printed beside); the
     wide tensor-core SSD (``ssd_chunk_sm90_wide.cu``) and the CUDA-core
     one (``ssd_chunk.cu``, 199,168 B of shared memory a block, the
     earlier design) at mamba2-780m's shape (B=4, S=512, H=48, P=64,
     N=128, chunk 128), B and C shared by the heads and per head, on
     random and on the model's dt and A, each against the plain version
     (2e-4), on the model's dt and A also against the float64 oracle
     (2e-4), with both kernels' ptxas registers and spills; each timed in
     a child process (profiler device time, events, the plain version,
     the bound, SDPA for flash; both SSD kernels on the same inputs in
     the same child); (b) the
     main path, ``launch/serve.py --arch deepseek-moe-16b`` at its
     published width and depth (28 layers, d_model 2048, 64 experts top-6
     of d_ff 1408 + 2 shared, bf16, seed 0): 8 requests of 512 tokens in
     batches of 4, 32 greedy tokens; the flash launches zeroed just
     before and read just after, 28 x 2 = 56, all on the tensor cores;
     every logit finite; prefill and decode tok/s, peak memory, and the
     share of the experts' slots dropped at prefill (capacity 240) and
     decode (capacity 1), from the aux of every moe call; (c) float32 at
     full width and depth 4 with capacity factor E/K, where nothing
     drops (at the reference's 1.25 a decode step's capacity is 1, and a
     decode step drops what a prefill keeps): decode logits against the
     last logits of a prefill one token longer, within
     ``CONSISTENCY_ATOL``; the scatter and dense dispatches on one
     layer's input at that capacity, at 1.25 and at 0.5 (where slots
     drop), within
     ``MOE_DISPATCH_ATOL``; no moe call synchronizing with the host
     (``torch.cuda.set_sync_debug_mode``); (d) ``launch/serve.py`` on
     llama4-scout-17b-a16e at depth 8 of 48, mamba2-780m whole (every SSD
     launch on the wide tensor-core route, no flash launch), chatglm3-6b whole,
     qwen1.5-32b at depth 16 of 64, starcoder2-3b whole (gelu, qkv
     biases, GQA 12:1) and musicgen-medium whole (256 prefix positions,
     its cache prefix + prompt + gen), the same requests: launches by
     route, tok/s and peak memory of each, every logit finite and every
     token in the vocabulary; (e) starcoder2-3b and musicgen-medium
     trained whole through ``launch/train.py --arch ... --steps 3
     --batch 4 --seq 512`` on the synthetic stream: finite losses, none
     skipped, every step launching flash twice a layer (forward and
     recompute, all tensor-core) and calling the plain attention once a
     layer (the backward's VJPs); ms a step, tok/s and peak memory.
 14. deepseek-moe-16b training at its published width and depth 6 of 28
     (3,736,889,344 parameters; 12 B each of bf16 parameters and gradients
     and float32 moments make 41.8 GiB, the full depth 200 GB), seed 0, on
     the synthetic LM stream at B=4, S=512. Phases 1-13 run in a function
     of their own and leave only plain numbers, so this phase starts with
     under ``PHASE14_START_GIB`` allocated on the card, which it prints.
     (a) ``FlashAttentionFn`` at the layer's shape (bf16, 16/16 heads,
     D=128), as 11 (a): the forward and input gradients against plain
     autograd, the backward timed beside the plain VJP, its bound and
     SDPA's backward; (b) one warm loss and backward of the model that (c)
     trains: every parameter's gradient present and finite, each block's
     moe.router, moe.wi, moe.wo and attn.wq gradients non-zero, flash
     launched 12 times (forward and recompute), all on the tensor cores,
     each block's recompute routing as its forward did; a warm step's
     split (forward, backward, AdamW), one ``make_train_step`` call under
     ``torch.cuda.set_sync_debug_mode`` with no host sync, and one
     profiled step; (c) the main path, ``launch/train.py``'s ``train_lm``
     with the depth cut from the caller (``--arch deepseek-moe-16b --steps
     8 --batch 4 --seq 512``; the CLI has no depth flag): every loss
     finite, no step skipped, every step launching flash 12 times on the
     tensor cores and calling the plain attention 6 times (the backward's
     VJPs); tok/s, ms a step, the peak device memory and the dropped share
     of the experts' slots by layer; (d) float32 at full width, depth 2,
     capacity factor 0.5 (slots drop): the scatter and dense dispatches'
     gradients within ``MOE_GRAD_REL`` of each leaf's largest magnitude.
 15. the data-parallel sampler (``core/sharded.py::ShardedHDP``), after
     ``torch.cuda.empty_cache()``: (a) the main path, ``launch/train.py
     --hdp pubmed --scale 0.01 --topics 1000 --bucket 256 --iters 3`` in
     a child process with torchrun's environment at world size 1, over
     NCCL: after each iteration the gathered n == count_n(z), n.sum() ==
     tokens, the flag topic empty, |sum(psi) - 1| < 1e-4, and hdp_z
     launched once more, on the lanes route; its tok/s beside phase 3's;
     then one more iteration on its own draws, in prologue mode and in
     table mode with compact tables, saved with them, and from the
     prologue one an iteration to warm up, ``SHARD_TIMED_ITERS`` timed and
     one split by sub-step; (b)
     2 ranks (data 2) and 4 ranks
     ((data, model) = (2, 2)) on the one card over gloo, the collectives
     staged through pinned host memory, at full width (the PubMed replica
     at 0.01, K=1000, W=256, V padded to a multiple of the model axis:
     6,904 at (2, 2)) from (a)'s state after its 3 iterations, the
     documents padded to a multiple of the ranks with empty ones: given
     (a)'s draws (a padded word's PPU count 0), z, n, dh, l and Psi after one
     iteration bitwise (a)'s in both modes, every rank's sweeps launched
     on the card on the lanes route; then the warm-up, timed and split
     iterations of (a) on their own draws; (c) each collective's bytes
     (the tensors each rank handed to it), each sub-step's wall ms, and
     s/iter for 1, 2 and 4 ranks.
 16. the sharded LM trainer (``train/sharding.py``), the sampler's
     ``--ckpt`` without ``--stream`` and the compression wire, after
     ``torch.cuda.empty_cache()``, in a child process with torchrun's
     environment at world size 1 over NCCL: (a) ``launch/train.py``'s
     ``train_lm`` under torchrun (``train_lm_sharded``) on deepseek-moe-16b
     at full width, depth 6, B=4, S=512, 3 steps: the losses bitwise
     phase 14's first 3, flash launched 2 x 6 times a step, all on the
     tensor cores; ms a step, tok/s, peak memory; (b) the sampler's
     ``--ckpt`` round trip on phase 3's corpus: 2 iterations, a save and
     a restore, 2 more, bitwise 4 in one run (z, n, phi, varphi, psi,
     l), through ``ShardedHDP.save``/``restore`` at world size 1 in the
     child and ``launch/train.py``'s ``save_hdp``/``restore_hdp`` (the
     generator's state too) in this process; (c) ``compressed_psum`` over NCCL at
     world size 1 on 16,777,216 float32: NCCL takes the int64 lanes and
     the MAX all-reduce, the mean is the int32 sum of q's dequantized, the
     residual x - deq, the wire 2 bytes an element; timed beside a plain
     float32 psum. ``four_cards`` (not part of ``main``; run it with four
     cards: ``python3 -c "import chip_smoke as C; C.four_cards()"``)
     trains the same model sharded on (2, 2), one card a rank over NCCL:
     depth 6 against world 1, the full depth 28 (ms a step, tok/s, each
     card's peak memory), a save on (2, 2) restored on (4, 1) bitwise,
     and ``compressed_psum`` on (2, 1, 2); beside its full-depth run it
     prints the dry run's prediction of the same step on (2, 2): the
     bytes a collective (which must equal the measured ones) and the
     peak.
 17. the dry run (``launch/dryrun.py``, fake tensors on the host, in a
     child process started before phase 14) against what this run
     measured: (a) ``hdp_record``'s bytes a collective of one Gibbs
     iteration at world 1 with phase 15 (a)'s config equal, label by
     label, ``ShardedHDP.last["bytes"]`` of each of its iterations; (b)
     the traced peak of the train step at world 1, B=4, S=512 of
     deepseek-moe-16b at depth 6, hymba-1.5b and starcoder2-3b within
     ``DRYRUN_PEAK_REL`` of ``torch.cuda.max_memory_allocated`` in phase
     14 (c), 11 (c) and 13 (e); both printed.
The last lines are the ``kernels`` JSON, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
sys.path.insert(0, str(SRC))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Without the repository's sources beside this script, these fail and
# the script exits non-zero before any phase.
import dataclasses  # noqa: E402

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import hdp as H  # noqa: E402
from repro_torch.core import sharded as SH  # noqa: E402
from repro_torch.core.collectives import Collectives  # noqa: E402
from repro_torch.core.polya_urn import ppu_sample  # noqa: E402
from repro_torch.core.stick import gem_prior_sample  # noqa: E402
from repro_torch.core.streaming import StreamingHDP  # noqa: E402
from repro_torch.data.corpus import Corpus  # noqa: E402
from repro_torch.data.stream import ShardedCorpusStore  # noqa: E402
from repro_torch.data.synthetic import paper_corpus, planted_topics_corpus  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.data import deltawire as DW  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as FA  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FAO  # noqa: E402
from repro_torch.kernels.flash_attention.ops import FlashAttentionFn  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.hdp_z import hdp_z as HZ  # noqa: E402
from repro_torch.kernels.hdp_z import ops as zops  # noqa: E402
from repro_torch.kernels.hdp_z.hdp_z import hdp_z_cuda  # noqa: E402
from repro_torch.kernels.hdp_z.ref import (  # noqa: E402
    hdp_z_ref, hdp_z_ref_prologue)
from repro_torch.kernels.ssd import ssd as SSD  # noqa: E402
from repro_torch.kernels.ssd import ops as SSDO  # noqa: E402
from repro_torch.kernels.ssd.ops import SSDIntraChunkFn  # noqa: E402
from repro_torch.kernels.ssd.ref import (  # noqa: E402
    decay_to_end, segsum, ssd_intra_chunk_ref)
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.launch import monitor as MON  # noqa: E402
from repro_torch.launch import serve as SV  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.data import lm_data as LMD  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models.lm import CausalLM  # noqa: E402
from repro_torch.train import checkpoint as CKPT  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402
from repro_torch.perf import PhaseTimers  # noqa: E402
from repro_torch.serve import eval as EV  # noqa: E402
from repro_torch.serve import foldin as FI  # noqa: E402
from repro_torch.serve import snapshot as SNAP  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.fleet import ServeFleet  # noqa: E402
from repro_torch.serve.registry import SnapshotRegistry  # noqa: E402

# H100 SXM data sheet: HBM3 bandwidth, float32 (non-tensor) peak, and
# dense bf16 and TF32 tensor-core peaks.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12
# float32 accuracy on the tensor cores takes three TF32 passes (3xTF32)
TF32_PASSES = 3

# hymba-1.5b serving on the main path (phase 6): batch, prompt, heads
SERVE_B, SERVE_S = 4, 512
# timed batches of the serving-rate run (phase 6), after one warm-up
RATE_BATCHES = 5
FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
SSD_ATOL = 2e-4
# float32 prefill/decode consistency at full width, depth 4 (phase 6):
# the largest |decode logit - prefill(S+1) logit| allowed. The two take
# different float32 sum orders (chunked SSD against the one-step
# recurrence, online against dense softmax, cuBLAS products of 1 row
# against 513): measured 1.47e-4 at logits up to 327 (chip run, NVIDIA
# H100 80GB HBM3, 700.00 W), a few float32 ulps of the largest logit;
# 1e-3 leaves about 7x that and is still 3e-6 of the logits' scale.
CONSISTENCY_ATOL = 1e-3

# the streamed main path (phase 8): documents a block (11 blocks of the
# PubMed 0.01 replica, the last one padded), and how many times the
# corpus is tiled by documents for the memory comparison
STREAM_BLOCK_DOCS = 8192
STREAM_TILES = 10
# phase 8 (d) again on the first documents, which miss about 8% of the
# words (PubMed 0.01), in 4 blocks, the last padded
STREAM_PART_DOCS = 1000
STREAM_PART_BLOCK_DOCS = 256

# HDP serving (phase 9): the engine's slots, burn-in and length buckets,
# the query documents (a PubMed 0.01 replica drawn with another seed), the
# held-out documents of the perplexity check, and the Gibbs iterations
# that train the served snapshot from z drawn uniformly over K
SERVE_SLOTS, SERVE_BURNIN = 32, 16
SERVE_BUCKETS = (32, 64, 128, 256)
SERVE_QUERIES = 2048
SERVE_EVAL_DOCS = 512
SERVE_TRAIN_ITERS = 10
SERVE_BASE_SEED = 7
# (f): the planted-topics corpus (documents of 40-60 tokens, the last
# ones held out) and the Gibbs iterations the port's sampler trains on it
PLANTED_DOCS, PLANTED_HELDOUT, PLANTED_ITERS = 700, 200, 15
# the subsets that (c)'s slots-8 and async engines, and (e), serve
SERVE_SUBSET = 256
SERVE_LIVE_QUERIES = 256
# (a): the kernel at the serving shapes
SERVE_DS = (1, 8, 32, 33)
SERVE_LS = (32, 64, 128, 256)

# the streamed trainer's sweep lanes (phase 10): the lane counts on the
# one card, the main path's (through launch/train.py), the iterations of
# (a) and of (d), with metrics and trace on (the convergence diagnostics
# publish ESS once they hold 8 samples), and where (c) stops
LANE_COUNTS = (1, 2, 4)
MAIN_LANES = 4
LANE_ITERS = 3
OBS_ITERS = 10
LANE_STOP_BLOCKS = 5

# hymba-1.5b training (phase 11): batch, sequence and steps of the main
# path through launch/train.py; the depth and the steps a side of the
# checkpoint-resume check (full width; at full depth a checkpoint holds
# 16 GB of bf16 parameters and float32 moments)
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 512, 8
RESUME_LAYERS, RESUME_STEPS = 4, 4
# the backward Functions' input gradients against plain autograd on the
# same card tensors, relative to each gradient's largest magnitude: their
# backward is that autograd on the same inputs, so any difference is
# the sum order of the card's products (bf16 attention, float32 SSD)
FN_GRAD_REL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# resumed losses against the uninterrupted run's, relative to the largest
# loss: the state is restored exactly, and only the order of the card's
# sums (atomics in the embedding's backward) may differ between runs
RESUME_REL = 1e-3

# paligemma-3b serving (phase 12): requests, batch, prompt and generated
# tokens of the main path; the depth of the float32 consistency check
PALI_REQUESTS, PALI_B, PALI_PROMPT, PALI_GEN = 8, 4, 512, 32
PALI_F32_LAYERS = 4
# nemotron-4-340b's attention heads (96 query, 8 kv, D=192; the reference's
# configs/nemotron_4_340b.py) at B=1, S=512: its model is not ported, its
# head dim is; and the window of (a)'s windowed cases
NEMO_HEADS, NEMO_B, NEMO_S = (96, 8, 192), 1, 512
PHASE12_WINDOW = 200

# deepseek-moe-16b serving (phase 13): requests, batch, prompt and
# generated tokens of the main path (those of phases 6 and 12); the depth
# of the float32 consistency check
MOE_REQUESTS, MOE_B, MOE_PROMPT, MOE_GEN = 8, 4, 512, 32
MOE_F32_LAYERS = 4
# scatter against dense dispatch on the card, float32: each expert slot
# holds one row, so the two differ only where the card's products order
# their sums differently
MOE_DISPATCH_ATOL = 1e-5
# a capacity factor at which random inputs drop slots (at the reference's
# 1.25 they hardly do: the router spreads them almost evenly)
MOE_DROP_FACTOR = 0.5
# 13 (a): the attention configs whose prefill shape (B=4, S=512, D=128)
# flash is checked and timed at; 13 (d): the configs served beside
# deepseek, each at the depth one card holds beside the script's other
# tensors (None: whole)
PHASE13_ATTN = ("deepseek-moe-16b", "llama4-scout-17b-a16e", "chatglm3-6b", "qwen1.5-32b",
                "starcoder2-3b", "musicgen-medium")
PHASE13_SERVED = (("llama4-scout-17b-a16e", 8), ("mamba2-780m", None),
                  ("chatglm3-6b", None), ("qwen1.5-32b", 16), ("starcoder2-3b", None),
                  ("musicgen-medium", None))
# 13 (e): the configs trained whole through launch/train.py, and their steps
PHASE13_TRAINED = ("starcoder2-3b", "musicgen-medium")
PHASE13_TRAIN_STEPS = 3

# deepseek-moe-16b training (phase 14), at phase 11's batch, sequence and
# steps: its depth (a layer holds 587,862,016 parameters at 12 B each of
# training state, bf16 parameters and gradients and float32 moments, so
# 6 of 28 layers and the embedding make 41.8 GiB, beside AdamW's float32
# temporaries on the experts' 1.375 GiB leaves and the float32 loss
# chunk; the full depth makes 200 GB), and the depth of the float32
# check of the two dispatches' gradients
MOE_TRAIN_LAYERS = 6
MOE_GRAD_LAYERS = 2
# both dispatches' gradients on the card, float32, relative to each leaf's
# largest magnitude: the routing is the same, and each expert slot holds
# one row, so the two differ only where the card's products order their
# sums differently
MOE_GRAD_REL = 1e-4
# what may stay allocated on the card from phases 1-13 when phase 14 starts
PHASE14_START_GIB = 1.0

# the data-parallel sampler (phase 15): the main path's iterations at
# world size 1, the rank counts and (data, model) grids of (b) on the one
# card, the iterations each rank count times after the fed one, and how
# long a child process may take
SHARD_ITERS = 3
SHARD_GRIDS = ((2, (2, 1)), (4, (2, 2)))
SHARD_TIMED_ITERS = 3
SHARD_CHILD_TIMEOUT_S = 300

# the sharded LM trainer (phase 16): steps of (a) at world size 1 (held
# bitwise to phase 14's first steps), the sampler's iterations a side of
# the checkpoint in (b), and the float32 elements of (c)'s compressed psum
SHARDED_LM_STEPS = 3
RESUME_ITERS = 2
COMP_ELEMENTS = 1 << 24
# the four-card run (``four_cards``): its depth-6 losses on (2, 2) against
# world 1's, relative (bf16: the gradients are summed over the ranks in
# bf16 and each rank's expert buffers hold its own rows, so the sums
# round elsewhere), and the depth of its save-and-restore across grids
# (a layer and the embedding hold 798 M parameters, 7.4 GiB of
# checkpoint at 10 B each)
FOUR_CARD_LOSS_REL = 1e-2
FOUR_CARD_CKPT_LAYERS = 1

# the dry run (phase 17): its traced peak of a train step against the
# card's torch.cuda.max_memory_allocated, relative to the measured peak
DRYRUN_PEAK_REL = 0.2

KS = (2, 3, 257, 1000)
WS = (8, 33, 64, 256)
# one shape on the warp route: 32 documents' uint16 m (256,000 B at
# K=4000) exceed an H100 block's 232,448 B
WARP_ROUTE_K, WARP_ROUTE_W = 4000, 64


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def max_int_err(a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def small_problem(rng, k, w, device, d=37, l=24, v=50):
    """Inputs at a small shape: PPU phi with some all-zero word columns,
    then min(K, W) + 1 words of which the j-th has j topics (so their
    supports hold every count of live slots), ragged documents with
    masked padding, random z and uniforms."""
    n = torch.from_numpy(rng.poisson(0.8, size=(k, v)).astype(np.int32)).to(device)
    gen = H.make_generator(int(rng.integers(1 << 30)), device)
    phi, _ = ppu_sample(gen, n, 0.01)
    zero_words = rng.choice(v, size=3, replace=False)
    phi[:, torch.from_numpy(zero_words).to(device)] = 0.0
    graded = np.zeros((k, min(k, w) + 1), np.float32)
    for j in range(graded.shape[1]):
        graded[rng.choice(k, size=j, replace=False), j] = rng.integers(1, 5, j) / (4.0 * v)
    phi = torch.cat([phi, torch.from_numpy(graded).to(device)], dim=1)
    v = phi.shape[1]
    psi = torch.from_numpy(rng.dirichlet(np.ones(k)).astype(np.float32)).to(device)
    tok = rng.integers(0, v, (d, l)).astype(np.int32)
    tok[:, :3] = zero_words  # every document meets the zero-mass words
    lens = rng.integers(0, l + 1, d)
    msk = (np.arange(l)[None, :] < lens[:, None]) & (rng.random((d, l)) > 0.1)
    z0 = rng.integers(0, k, (d, l)).astype(np.int32)
    u = rng.random((d, l, 3)).astype(np.float32)
    to = lambda x: torch.from_numpy(x).to(device)
    return phi, psi, to(tok), to(msk), to(z0), to(u)


def compare_variants(tokens, mask, z0, u, phi, psi, alpha, w, kk, order, want_route):
    """Kernel against plain version in all six emit_delta x mode variants
    (float32 tables, compact bf16/int16 tables, prologue) on the same
    inputs, each launch on ``want_route``; returns the largest integer
    error."""
    vv = phi.shape[1]
    n0 = H.count_n(z0, tokens, mask, kk, vv)
    tables = {compact: zops.build_word_sparse_tables(phi, psi, alpha, w, order=order,
                                                     compact=compact)
              for compact in (False, True)}
    vals, ids = zops.build_word_sparse_supports(phi, w, order=order)
    apsi = torch.tensor(alpha, dtype=torch.float32, device=psi.device) * psi
    limit = HZ.smem_limit(tokens.device)
    worst = 0
    for mode in ("table", "compact", "prologue"):
        in_kernel = mode == "prologue"
        for emit in (False, True):
            r = HZ.route(kk, tokens.shape[1], in_kernel, limit)
            check(r == want_route, f"K={kk} {mode}: route {r}, expected {want_route}")
            before = hdp_z_cuda.launches
            before_route = hdp_z_cuda.launches_by_route[r]
            if in_kernel:
                got = hdp_z_cuda(tokens, mask, z0, u, kk=kk, apsi=apsi,
                                 vals=vals, ids=ids, emit_delta=emit)
                want = hdp_z_ref_prologue(tokens, mask, z0, u, apsi, vals,
                                          ids, kk=kk, emit_delta=emit)
            else:
                q_a, fpack, ipack = tables[mode == "compact"]
                got = hdp_z_cuda(tokens, mask, z0, u, kk=kk, q_a=q_a,
                                 fpack=fpack, ipack=ipack, emit_delta=emit)
                want = hdp_z_ref(tokens, mask, z0, u, q_a, fpack, ipack,
                                 kk=kk, emit_delta=emit)
            torch.cuda.synchronize()
            tag = f"K={kk} W={w} {order} {mode} emit_delta={emit}"
            check(hdp_z_cuda.launches == before + 1, f"{tag}: no launch")
            check(hdp_z_cuda.launches_by_route[r] == before_route + 1,
                  f"{tag}: not launched on the {r} route")
            for name, a, b in zip(("z", "m", "dn"), got, want):
                err = max_int_err(a, b)
                worst = max(worst, err)
                check(torch.equal(a, b), f"{tag}: {name} differs (max {err})")
            if emit:
                recount = H.count_n(got[0], tokens, mask, kk, vv)
                check(torch.equal(n0 + got[2], recount),
                      f"{tag}: n + dn != count_n(z_new)")
            check(torch.equal(got[1], H.doc_topic_counts(got[0], mask, kk)),
                  f"{tag}: m != doc_topic_counts(z_new)")
    return worst


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after
    one warm-up call, by CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_kernels(prof) -> list:
    """The profiler's CUDA kernel records, by name."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_time_ms(fn, reps: int, per_call: int | None = None,
                   name: str | None = None, phase: str = "7") -> float:
    """Device time of ``fn`` a call: the time of the CUDA kernels that
    ``torch.profiler`` records over ``reps`` calls after one warm-up call
    (only those whose name holds ``name``, when given). Unlike
    cuda_time_ms it leaves out the gaps in which the card waits for the
    host, so it is the kernels' own time where a call's host cost exceeds
    its device time.

    The profiler drops kernel records where calls launch small kernels
    back to back (it has kept 43 and 49 of 50 in phase 9, and 40 of 50 in
    phase 7), so each kernel's time is the mean over its records kept,
    times its launches a call: ``per_call`` (one kernel a call) when
    given, else its records over ``reps``, rounded. A window must keep
    half of each kernel's launches, and no more than ``reps * per_call``
    records, or it is measured again; after three such windows the call
    is timed by events (cuda_time_ms), and the line says so."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evts = [e for e in cuda_kernels(prof) if name is None or name in e.key]
        kept = sum(e.count for e in evts)
        if per_call:
            whole = reps * per_call <= 2 * kept <= 2 * reps * per_call
            calls = [per_call / kept] * len(evts)
        else:
            launches = [max(1, round(e.count / reps)) for e in evts]
            whole = all(2 * e.count >= reps * k for e, k in zip(evts, launches))
            calls = [k / e.count for e, k in zip(evts, launches)]
        if kept and whole:
            if kept % reps:
                print(f"[{phase}] the profiler kept {kept} kernel records over {reps} "
                      f"calls; the time is the mean over those kept", flush=True)
            return sum(e.self_device_time_total * c for e, c in zip(evts, calls)) / 1e3
        print(f"[{phase}] the profiler recorded {kept} kernels over {reps} calls; "
              f"measuring again; recorded: " + ", ".join(
                  f"{e.key[:60]} x{e.count}" for e in evts), flush=True)
    ms = cuda_time_ms(fn, reps)
    print(f"[{phase}] the profiler missed kernels three times: {ms:.4f} ms a call "
          f"is by events, not profiler device time", flush=True)
    return ms


def host_time_ms(fn, reps: int) -> float:
    """Host time of one call of ``fn`` (its launch, not its run), over
    ``reps`` calls after a synchronize: when it is near cuda_time_ms's
    figure, the launches, not the kernel, set that figure."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def sweep_bound_ms(d, l, kk, vv, w, tok_words, live_w, in_kernel, emit, table_bytes=4):
    """Least time for one sweep: each byte the sweep needs read once and
    each output byte written once over the memory rate, against the
    float32 work every live token needs whichever branch it takes over
    the float32 rate. What the sums need depends on the data: a slot
    past a word's live slots adds +-0.0 (``hdp_z.live_slots``), and only
    the rows of the words the live tokens hold are read.

    ``tok_words`` holds the word of each live token, ``live_w`` the live
    slots of each of the V words. Bytes: mask, z in and z out over all
    D*L positions (padding keeps its z); tokens and uniforms only at the
    live positions; m (D, K); of each distinct word the tokens hold, the
    support's values and ids at its live slots and, in table mode, its
    q_a; apsi (K,) in prologue mode; in table mode an alias slot (prob
    and alias) for each live token's global-branch draw, or each slot of
    those words' rows where there are fewer slots than live tokens, at
    ``table_bytes`` an element (4, or 2 for compact tables); dn (K, V)
    with emit. Operations: per live slot of each live token's word a
    product and a prefix add for term (b); prologue mode also a product
    and an add for wa and q_a."""
    live = tok_words.numel()
    words = torch.unique(tok_words)
    row_slots = int(live_w[words].sum())
    nbytes = d * l * (1 + 4 + 4) + live * (4 + 12) + d * kk * 4
    nbytes += ((row_slots * 8 + kk * 4) if in_kernel else
               (words.numel() * 4
                + (row_slots + min(live, words.numel() * w)) * 2 * table_bytes))
    nbytes += kk * vv * 4 if emit else 0
    ops = int(live_w[tok_words].sum()) * (4 if in_kernel else 2)
    return bound_ms(nbytes, ops, FP32_OPS_PER_S)


def bound_ms(nbytes: float, ops: float, ops_per_s: float):
    """The larger of bytes over the memory rate and operations over the
    peak rate for their type, in ms, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_pairs(s: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs of one head that the causal mask and the window
    leave."""
    qpos = np.arange(s)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(s, np.int64)
    hi = qpos if causal else np.full(s, s - 1)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_bound_ms(b, hq, hkv, s, d, itemsize, causal, window):
    """q and out (B, Hq, S, D), k and v (B, Hkv, S, D), each moved once;
    4 D operations (q.k and p.v multiply-adds) per unmasked pair at the
    tensor-core peak of the input type (bf16) or the float32 peak."""
    nbytes = 2 * (b * hq + b * hkv) * s * d * itemsize
    ops = 4 * d * b * hq * attention_pairs(s, causal, window)
    return bound_ms(nbytes, ops, BF16_OPS_PER_S if itemsize == 2 else FP32_OPS_PER_S)


def ssd_bound_ms(b, s, h, p, n, cl):
    """x in and y out (B, S, H, P), dt in and dec out (B, S, H), a (H,),
    B and C (B, S, N) shared by the heads, the states out (B, NC, H, N, P),
    all float32 and moved once. Per (batch, chunk) the products are 2N
    for C.B per pair i >= j, once, since B and C are the same for every
    head; per (batch, chunk, head) 2P for y per pair and 2NP for the
    state per row. They are priced at the best float32-accurate rate the
    card has: three TF32 passes at the tensor-core peak. The elementwise
    work (3 a pair for the decay and its product; P for x dt and N + 5
    for the decays a row) stays at the float32 peak."""
    nc = s // cl
    nbytes = 4 * (2 * b * s * h * p + 2 * b * s * h + h + 2 * b * s * n
                  + b * nc * h * n * p)
    pairs = cl * (cl + 1) // 2
    products = b * nc * (pairs * 2 * n + h * (pairs * 2 * p + cl * 2 * n * p))
    elementwise = b * nc * h * (pairs * 3 + cl * (p + n + 5))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (products * TF32_PASSES / TF32_OPS_PER_S + elementwise / FP32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_inputs(gen, b, hq, hkv, s, d, dtype):
    """q (B, Hq, S, D) and k, v (B, Hkv, S, D) as transposed views of
    (B, S, H, D) tensors, as the model passes its projections."""
    def one(h):
        return torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    return one(hq), one(hkv), one(hkv)


def check_flash(gen, b, hq, hkv, s, d, dtype, causal, window, sdpa=False, phase="5"):
    """Kernel against plain version on one case, the launch on the route
    ``FA.route`` gives; returns the kernel's max error and, with
    ``sdpa`` (a case where SDPA computes the same function), SDPA's max
    error against the same plain version."""
    q, k, v = flash_inputs(gen, b, hq, hkv, s, d, dtype)
    route = FA.route(dtype, d)
    before = FA.flash_attention.launches
    before_route = FA.flash_attention.launches_by_route[route]
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, causal=causal, window=window)
    err = float((got.float() - want.float()).abs().max())
    tag = (f"flash B={b} Hq={hq} Hkv={hkv} S={s} D={d} {dtype} "
           f"causal={causal} window={window}")
    check(FA.flash_attention.launches == before + 1, f"{tag}: no launch")
    check(FA.flash_attention.launches_by_route[route] == before_route + 1,
          f"{tag}: not launched on the {route} route")
    check(got.dtype == dtype and got.shape == want.shape, f"{tag}: dtype/shape")
    check(err <= FLASH_ATOL[dtype], f"{tag}: max error {err} > {FLASH_ATOL[dtype]}")
    lib_err = None
    if sdpa:
        lib = F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)
        lib_err = float((lib.float() - want.float()).abs().max())
    print(f"[{phase}] {tag} ({route}): max |kernel - plain| {err:.3g}" + (
        f"; max |SDPA - plain| {lib_err:.3g}" if sdpa else ""), flush=True)
    return err, lib_err


def ssd_inputs(gen, b, s, h, p, n, shared=True, model=False):
    """x, dt, a as in tests/test_ssd.py; B and C (B, S, N) shared by
    the heads, as stride-0 views, as the model passes them (or, without
    ``shared``, contiguous per head). With ``model``, dt and A as the
    model at init feeds them: A = -linspace(1, 16, H) and dt the softplus
    of a unit-variance projection, so cum reaches about -1400 within a
    chunk and exp(cum) underflows."""
    dev = "cuda"
    x = torch.randn((b, s, h, p), generator=gen, device=dev)
    dt = torch.rand((b, s, h), generator=gen, device=dev) * 0.19 + 0.01
    a = -(torch.rand((h,), generator=gen, device=dev) * 1.5 + 0.5)
    if shared:
        bm, cm = (torch.randn((b, s, n), generator=gen, device=dev)[:, :, None, :]
                  .expand(b, s, h, n) for _ in range(2))
    else:
        bm, cm = (torch.randn((b, s, h, n), generator=gen, device=dev) for _ in range(2))
    if model:
        dt = F.softplus(torch.randn((b, s, h), generator=gen, device=dev))
        a = -torch.linspace(1.0, 16.0, h, device=dev)
    return x, dt, a, bm, cm


def ssd_oracle(x, dt, a, bm, cm, chunk):
    """The intra-chunk pass in float64 on the card, from the float32
    inputs, its decays from float64 segment sums of the exact products
    dt * A: (y, st, dec) as ``ssd_intra_chunk``."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    nc = s // chunk
    steps = dt.double().reshape(b, nc, chunk, h) * a.double()
    xdt = (x.double() * dt.double()[..., None]).reshape(b, nc, chunk, h, p)
    br = bm.double().reshape(b, nc, chunk, h, n)
    scores = torch.einsum("bcihn,bcjhn->bcijh", cm.double().reshape(b, nc, chunk, h, n),
                          br) * torch.exp(segsum(steps, 2))
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, xdt).reshape(b, s, h, p)
    st = torch.einsum("bcjhn,bcjhp->bchnp",
                      br * torch.exp(decay_to_end(steps, 2))[..., None], xdt)
    return y, st, torch.exp(torch.cumsum(steps, 2)).reshape(b, s, h)


def check_ssd_oracle(tag, args, cl, want=None) -> float:
    """The SSD routes that take the shape (the route ``SSD.route`` gives
    and the CUDA-core one) against the plain version and the float64
    oracle at SSD_ATOL, over y, st and dec; returns their largest error
    against the oracle. These launches compare, they are off any main
    path."""
    want = ssd_intra_chunk_ref(*args, chunk=cl) if want is None else want
    oracle = ssd_oracle(*args, cl)
    b, s, h, p = args[0].shape
    routes = tuple(dict.fromkeys((SSD.route(cl, args[3].shape[-1], p), "cuda_cores")))
    worst, line = 0.0, []
    for r in routes:
        got = SSD._launch(r, *args, cl)
        torch.cuda.synchronize()
        for name, g, w, o in zip(("y", "st", "dec"), got, want, oracle):
            e, eo = float((g - w).abs().max()), float((g.double() - o).abs().max())
            check(e <= SSD_ATOL, f"{tag} {r}: {name} {e} from the plain version")
            check(eo <= SSD_ATOL, f"{tag} {r}: {name} {eo} from the float64 oracle")
            worst = max(worst, eo)
        line.append(f"{r} y {float((got[0].double() - oracle[0]).abs().max()):.3g}")
    plain_err = max(float((w.double() - o).abs().max()) for w, o in zip(want, oracle))
    check(plain_err <= SSD_ATOL, f"{tag}: the plain version {plain_err} from the oracle")
    print(f"{tag}: max |. - float64 oracle|: {', '.join(line)}, plain {plain_err:.3g} "
          f"over y, st, dec (|y| up to {float(oracle[0].abs().max()):.1f})", flush=True)
    return worst


def check_ssd(gen, b, s, h, p, n, cl, shared=True, model=False, phase="5",
              also=()) -> float:
    """Kernel against plain version on one case, the launch on the route
    ``SSD.route`` gives, and the routes in ``also`` on the same inputs
    (off the main path); with ``model`` also the shape's route and the
    CUDA-core one against the plain version and the float64 oracle
    (``check_ssd_oracle``). Returns the largest error over y, st and dec
    of the shape's route."""
    args = ssd_inputs(gen, b, s, h, p, n, shared, model)
    route = SSD.route(cl, n, p)
    before = SSD.ssd_intra_chunk.launches
    before_route = SSD.ssd_intra_chunk.launches_by_route[route]
    got = SSD.ssd_intra_chunk(*args, chunk=cl)
    torch.cuda.synchronize()
    want = ssd_intra_chunk_ref(*args, chunk=cl)
    tag = (f"ssd B={b} S={s} H={h} P={p} N={n} chunk={cl} "
           f"{'B, C stride 0' if shared else 'B, C per head'}"
           f"{', model dt and A' if model else ''}")
    check(SSD.ssd_intra_chunk.launches == before + 1, f"{tag}: no launch")
    check(SSD.ssd_intra_chunk.launches_by_route[route] == before_route + 1,
          f"{tag}: not launched on the {route} route")
    err = 0.0
    for name, a, w in zip(("y", "st", "dec"), got, want):
        check(a.shape == w.shape, f"{tag}: {name} shape")
        e = float((a - w).abs().max())
        check(e <= SSD_ATOL, f"{tag}: {name} max error {e} > {SSD_ATOL}")
        err = max(err, e)
    print(f"[{phase}] {tag} ({route}): max |kernel - plain| {err:.3g} over y, st, dec",
          flush=True)
    for other in also:
        got = SSD._launch(other, *args, cl)
        torch.cuda.synchronize()
        e = max(float((a - w).abs().max()) for a, w in zip(got, want))
        check(e <= SSD_ATOL, f"{tag} {other}: max error {e} > {SSD_ATOL}")
        print(f"[{phase}] {tag} ({other}, the same inputs): max |kernel - plain| {e:.3g} "
              f"over y, st, dec", flush=True)
    if model:
        check_ssd_oracle(f"[{phase}] {tag}", args, cl, want)
    return err


def check_streams_equal(a, b, tag: str) -> None:
    """Two streamed states bitwise equal: n, phi, varphi, psi, l, z and
    the iteration count."""
    for f in ("n", "phi", "varphi", "psi", "l"):
        check(torch.equal(getattr(a, f), getattr(b, f)), f"{tag}: {f} differs")
    check(a.it == b.it, f"{tag}: iterations {a.it} and {b.it}")
    check(np.array_equal(a.z_blocks.materialize(), b.z_blocks.materialize()),
          f"{tag}: z differs")


def check_block_sweeps(sh: StreamingHDP, state, z_next: np.ndarray, tag: str) -> None:
    """The sweep at the streamed path's own shapes against its plain
    version. From ``state`` (after an iteration) the next iteration's
    tables and every block's uniforms are redrawn on a copy of its
    generator, in the driver's order; the first block and the padded
    last one are staged as the driver stages them, swept through
    ``z_sweep_u`` (the kernel) and through the plain version, and z, m
    and dn must agree bitwise. ``z_next``, the stream's z slabs after
    that iteration, must equal the kernel's z: these are the main
    path's inputs. Returns the tables."""
    cfg = sh.cfg
    gen = torch.Generator(device=sh.device)
    gen.set_state(state.gen.get_state())
    _, _, ztables = sh._phi_tables(gen, state.n, state.varphi, state.psi)
    plain = hdp_z_ref_prologue if sh.in_kernel else hdp_z_ref
    last = sh.store.num_blocks - 1
    for b in range(sh.store.num_blocks):
        u = sh._uniforms(gen)
        if b not in (0, last):
            continue
        _, tokens, mask, z = sh._take(sh._to_device(
            sh._host_z(sh._host_block(b), state.z_blocks)))
        lanes = hdp_z_cuda.launches_by_route["lanes"]
        got = SH.z_sweep_u(cfg, ztables, z, tokens, mask, state.psi, u,
                           in_kernel=sh.in_kernel)
        want = plain(tokens, mask, z, u, *ztables, kk=cfg.K, emit_delta=True)
        torch.cuda.synchronize()
        where = f"{tag} block {b} of {sh.store.num_blocks}"
        check(hdp_z_cuda.launches_by_route["lanes"] == lanes + 1,
              f"{where}: the sweep was not launched on the lanes route")
        for name, a, w in zip(("z", "m", "dn"), got, want):
            check(torch.equal(a, w), f"{where}: {name} differs from the plain "
                                     f"version (max {max_int_err(a, w)})")
        check(np.array_equal(got[0].cpu().numpy(), z_next[b]),
              f"{where}: the kernel's z is not the stream's")
        print(f"[8] {tag} block {b} ({int(mask.any(1).sum())} of {mask.shape[0]} "
              f"documents live, {'prologue' if sh.in_kernel else 'table'} mode): "
              f"kernel == {plain.__name__} bitwise (z, m, dn) == the stream's z",
              flush=True)
    return ztables


def streamed_chain(stream: StreamingHDP, iters: int, seed: int):
    state = stream.init_state(seed)
    for _ in range(iters):
        state = stream.iteration(state)
    return state


def stream_phase(corpus: Corpus, cfg: H.HDPConfig, dev: torch.device, seed: int):
    """Phase 8, the streamed main path (``StreamingHDP.iteration``) on the
    corpus of phase 3, K=1000, W=256, z packed to uint16: (a) a one-block
    stream is bitwise the monolithic chain over 2 iterations; (b) 11
    blocks of 8,192 documents (the last padded), 2 iterations with the ram
    and with the disk store, bitwise equal, n the recount of z, z in [0,
    K), the first and the padded last sweep of iteration 2 bitwise the
    plain version; (c) iteration 2 stopped after 5 blocks at a
    checkpoint, restored and finished, bitwise (b); (d) block-sparse
    tables (table mode) bitwise the default (prologue mode), also on a
    part of the corpus that misses words; (e) every sweep on the lanes
    route; (f) one iteration streamed and monolithic on the corpus tiled
    10x by documents: s/iter, peak device memory, and the streamed
    iteration's phase split. Returns the numbers for the kernels line."""
    import tempfile

    t_phase = time.perf_counter()
    out = {}
    before = dict(hdp_z_cuda.launches_by_route)
    # (a) one block against the monolithic chain
    tokens = torch.from_numpy(corpus.tokens).to(dev)
    mask = torch.from_numpy(corpus.mask).to(dev)
    one = StreamingHDP(cfg, ShardedCorpusStore.from_corpus(corpus, corpus.num_docs),
                       device=dev)
    check(one.store.num_blocks == 1 and one.z_dtype == np.uint16,
          f"one-block stream: {one.store.num_blocks} blocks, z as {one.z_dtype}")
    mono = H.init_state(H.make_generator(seed, dev), tokens, mask, cfg)
    st = one.init_state(seed)
    for _ in range(2):
        mono = H.gibbs_iteration(mono, tokens, mask, cfg)
        st = one.iteration(st)
    check(torch.equal(mono.z.cpu(), torch.from_numpy(st.z_blocks[0])),
          "one-block stream: z differs from the monolithic chain")
    for f in ("n", "phi", "varphi", "psi", "l"):
        check(torch.equal(getattr(mono, f), getattr(st, f)),
              f"one-block stream: {f} differs from the monolithic chain")
    check(hdp_z_cuda.launches_by_route == {"lanes": before["lanes"] + 4,
                                           "warp": before["warp"]},
          f"one-block stream: launches by route {hdp_z_cuda.launches_by_route}, "
          f"from {before}: expected 4 more on lanes")
    print("[8] (a) a one-block stream is bitwise the monolithic chain over 2 "
          "iterations (z, n, phi, varphi, psi, l)", flush=True)
    del mono, st, one

    # (b) the main path: 11 blocks, ram and disk
    store = ShardedCorpusStore.from_corpus(corpus, STREAM_BLOCK_DOCS)
    check(store.num_blocks == 11, f"{store.num_blocks} blocks, expected 11")
    ram = StreamingHDP(cfg, store, device=dev)
    st_ram = ram.init_state(seed)
    torch.cuda.synchronize()
    hdp_z_cuda.launches = 0
    hdp_z_cuda.launches_by_route.update(dict.fromkeys(HZ.ROUTES, 0))
    t0 = time.perf_counter()
    for _ in range(2):
        st_ram = ram.iteration(st_ram)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out["launches"] = hdp_z_cuda.launches
    out["launches_by_route"] = dict(hdp_z_cuda.launches_by_route)
    want = 2 * store.num_blocks
    check(out["launches_by_route"] == {"lanes": want, "warp": 0},
          f"streamed main path: launches by route {out['launches_by_route']}, "
          f"expected {want} on lanes")
    st_disk = streamed_chain(StreamingHDP(cfg, store, device=dev, z_store="disk"), 2, seed)
    check_streams_equal(st_ram, st_disk, "ram against disk")
    z_all = st_ram.z_blocks.materialize()
    check(bool(((z_all >= 0) & (z_all < cfg.K)).all()), "a z outside [0, K)")
    check(not z_all.reshape(-1, store.max_len)[store.num_docs:].any(),
          "a padded row's z is not 0")
    z_dev = torch.from_numpy(z_all.reshape(-1, store.max_len)[:store.num_docs]).to(dev)
    check(torch.equal(st_ram.n, H.count_n(z_dev, tokens, mask, cfg.K, cfg.V)),
          "streamed n != count_n(z)")
    check(int(st_ram.n.sum()) == int(mask.sum()), "streamed n.sum() != tokens")
    del z_dev, tokens, mask
    print(f"[8] (b) {store.num_blocks} blocks x {store.block_docs} docs, z as "
          f"{st_ram.z_blocks.dtype}: 2 iterations in {secs:.3f} s "
          f"({secs / 2:.4f} s/iter, iteration 1 included), ram == disk bitwise, n == "
          f"count_n(z), z in [0, K); sweeps {out['launches']} "
          f"(by route {out['launches_by_route']})", flush=True)

    # (b) the sweeps of iteration 2 at (b)'s block shapes, first and padded
    st_c = ram.iteration(ram.init_state(seed))
    check_block_sweeps(ram, st_c, z_all, "(b)")

    # (c) stopped mid-iteration at a checkpoint, restored, finished
    with tempfile.TemporaryDirectory() as d:
        check(ram.iteration(st_c, ckpt_dir=d, stop_after_blocks=5) is None,
              "the stopped iteration returned a state")
        st_c, kw = ram.restore(d)
        check(kw.get("start_block") == 5 and st_c.it == 1,
              f"restored at iteration {st_c.it}, cursor {kw.get('start_block')}")
        st_c = ram.iteration(st_c, **kw)
    check_streams_equal(st_ram, st_c, "stopped and resumed")
    print("[8] (c) iteration 2 stopped after 5 blocks, restored from its checkpoint "
          "and finished: bitwise (b)", flush=True)

    # (d) block-sparse tables (table mode) against the default (prologue mode)
    on = StreamingHDP(cfg._replace(alias_in_kernel="off"), store, device=dev,
                      block_sparse_tables="on")
    check(on.block_sparse_tables and not on.in_kernel and ram.in_kernel
          and not ram.block_sparse_tables, "block-sparse tables: unexpected modes")
    check_streams_equal(st_ram, streamed_chain(on, 2, seed), "block-sparse on")
    print(f"[8] (d) block_sparse_tables on (table mode, {len(store.vocab_ids())} of "
          f"{cfg.V} words) == off (prologue mode), bitwise", flush=True)
    # ... and on the first documents, which miss words, so that the masked
    # build zeroes rows the card then holds
    part = Corpus(corpus.tokens[:STREAM_PART_DOCS], corpus.mask[:STREAM_PART_DOCS],
                  corpus.V)
    part_store = ShardedCorpusStore.from_corpus(part, STREAM_PART_BLOCK_DOCS)
    words = len(part_store.vocab_ids())
    check(words < cfg.V, f"the first {STREAM_PART_DOCS} documents hold every word")
    on_part = StreamingHDP(cfg._replace(alias_in_kernel="off"), part_store, device=dev,
                           block_sparse_tables="on")
    st_off = streamed_chain(StreamingHDP(cfg, part_store, device=dev), 2, seed)
    st_on = streamed_chain(on_part, 1, seed)
    _, fpack, _ = check_block_sweeps(on_part, st_on, st_off.z_blocks.materialize(), "(d)")
    absent = ~on_part._u_mask
    zeroed = int(absent.sum())
    check(zeroed == cfg.V - words and not fpack[absent].any() and fpack[~absent].any(),
          "block-sparse tables: the rows of absent words are not zero")
    check_streams_equal(st_off, on_part.iteration(st_on), "block-sparse on, part of the corpus")
    print(f"[8] (d) on the first {STREAM_PART_DOCS} documents ({part_store.num_blocks} "
          f"blocks of {STREAM_PART_BLOCK_DOCS}, {words} of {cfg.V} words, {zeroed} table "
          f"rows zero): block_sparse_tables on == off (prologue mode), bitwise over 2 "
          f"iterations", flush=True)
    del st_ram, st_disk, st_c, ram, on, on_part, st_on, st_off
    torch.cuda.empty_cache()

    # (e) every sweep of the phase on the lanes route ((a) checked its own)
    warp = hdp_z_cuda.launches_by_route["warp"]
    check(warp == 0, f"phase 8: {warp} sweeps on the warp route since (b)")
    print(f"[8] (e) every sweep on the lanes route (by route since (b): "
          f"{dict(hdp_z_cuda.launches_by_route)})", flush=True)

    # (f) the corpus tiled by documents: streamed against monolithic
    tiled = Corpus(np.tile(corpus.tokens, (STREAM_TILES, 1)),
                   np.tile(corpus.mask, (STREAM_TILES, 1)), corpus.V)
    big = StreamingHDP(cfg, ShardedCorpusStore.from_corpus(tiled, STREAM_BLOCK_DOCS),
                       device=dev)
    st = big.init_state(seed)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = big.iteration(st)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    stream_peak = torch.cuda.max_memory_allocated()
    st, timers = big.iteration_profiled(st)
    check(int(st.n.sum()) == tiled.num_tokens, "tiled stream: n.sum() != tokens")
    stream_out = dict(sec_per_iter=stream_s, peak_bytes=stream_peak, resident_bytes=base,
                      profiled_sec=timers.total, phase_sec=timers.totals,
                      phase_fractions=timers.fractions(), blocks=big.store.num_blocks)
    del st, big
    torch.cuda.empty_cache()
    tokens = torch.from_numpy(tiled.tokens).to(dev)
    mask = torch.from_numpy(tiled.mask).to(dev)
    mono = H.init_state(H.make_generator(seed, dev), tokens, mask, cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mono = H.gibbs_iteration(mono, tokens, mask, cfg)
    torch.cuda.synchronize()
    mono_out = dict(sec_per_iter=time.perf_counter() - t0,
                    peak_bytes=torch.cuda.max_memory_allocated(), resident_bytes=base)
    check(int(mono.n.sum()) == tiled.num_tokens, "tiled monolithic: n.sum() != tokens")
    del mono, tokens, mask
    torch.cuda.empty_cache()
    check(stream_out["peak_bytes"] < mono_out["peak_bytes"],
          f"streamed peak {stream_out['peak_bytes']} B not below the monolithic "
          f"{mono_out['peak_bytes']} B")
    gib = 2.0**30
    print(f"[8] (f) corpus tiled {STREAM_TILES}x by documents ({tiled.num_docs} docs, "
          f"{tiled.num_tokens} tokens): streamed ({stream_out['blocks']} blocks) "
          f"{stream_out['sec_per_iter']:.4f} s/iter, peak "
          f"{stream_out['peak_bytes'] / gib:.3f} GiB (resident before the iteration "
          f"{stream_out['resident_bytes'] / gib:.3f}); monolithic "
          f"{mono_out['sec_per_iter']:.4f} s/iter, peak {mono_out['peak_bytes'] / gib:.3f} "
          f"GiB (resident {mono_out['resident_bytes'] / gib:.3f})", flush=True)
    print(f"[8] (f) streamed iteration, serialized, {stream_out['profiled_sec']:.4f} s "
          f"by phase: " + ", ".join(f"{k} {v:.4f} s ({stream_out['phase_fractions'][k]:.1%})"
                                    for k, v in stream_out["phase_sec"].items()),
          flush=True)
    print(f"[8] phase 8 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    out["tiled"] = {"streamed": stream_out, "monolithic": mono_out,
                    "docs": tiled.num_docs, "tokens": tiled.num_tokens}
    return out


def random_z_state(gen, tokens, mask, cfg: H.HDPConfig) -> H.HDPState:
    """An HDP state whose z is drawn uniformly over K, with Phi and Psi
    drawn from it: the untrained start of phase 9's models."""
    z = torch.where(mask, torch.randint(0, cfg.K, tokens.shape, generator=gen,
                                        device=tokens.device, dtype=torch.int32), 0)
    n = H.count_n(z, tokens, mask, cfg.K, cfg.V)
    phi, varphi = ppu_sample(gen, n, cfg.beta)
    return H.HDPState(z=z, n=n, phi=phi, varphi=varphi,
                      psi=gem_prior_sample(gen, cfg.K, cfg.gamma),
                      l=torch.zeros((cfg.K,), dtype=torch.int32, device=tokens.device),
                      gen=gen, it=0)


def pad_rows(docs, length: int, dev):
    """(D, L) tokens and mask of documents, each truncated to L."""
    tokens = np.zeros((len(docs), length), np.int32)
    mask = np.zeros((len(docs), length), bool)
    for i, doc in enumerate(docs):
        n = min(len(doc), length)
        tokens[i, :n] = doc[:n]
        mask[i, :n] = True
    return torch.from_numpy(tokens).to(dev), torch.from_numpy(mask).to(dev)


def bucket_of(n: int) -> int:
    """The engine's length bucket of an n-token document (the largest
    bucket for longer ones, which it truncates)."""
    return next((b for b in SERVE_BUCKETS if n <= b), SERVE_BUCKETS[-1])


def run_engine(snap, docs, rids, slots: int, async_admit: bool = False):
    """Serve ``docs`` (request ids ``rids``) through one engine; returns
    ``({rid: mixture}, stats)``."""
    eng = ServeEngine(snap, slots=slots, burnin=SERVE_BURNIN, buckets=SERVE_BUCKETS,
                      base_seed=SERVE_BASE_SEED, async_admit=async_admit)
    try:
        for doc, rid in zip(docs, rids):
            eng.submit(doc, seed=rid)
        out = eng.run()
        torch.cuda.synchronize()
    finally:
        eng.close()
    return out, eng.stats


def check_mixtures(got: dict, want: dict, tag: str) -> None:
    check(sorted(got) == sorted(want), f"{tag}: {len(got)} requests, expected {len(want)}")
    bad = [rid for rid in want if not np.array_equal(got[rid], want[rid])]
    check(not bad, f"{tag}: {len(bad)} mixtures differ (first request {bad[:1]})")


def serve_phase(corpus: Corpus, cfg: H.HDPConfig, dev: torch.device, seed: int):
    """Phase 9, HDP serving (``repro_torch/serve``) on a snapshot of the
    PubMed 0.01 replica (K=1000, W=256) trained 10 iterations from z drawn
    uniformly over K: (a) hdp_z_cuda in table mode against hdp_z_ref at the
    serving shapes, both routes; (b) the uniforms on the card against the
    CPU; (c) the engine against direct fold-in, slots 8 against 32, async
    admission against sync, every sweep on the lanes route; (d) a 2-worker
    fleet on the card against the engine; (e) a publishing
    ``StreamingHDP.run`` and an ensemble fleet over its registry; (f)
    held-out perplexity of the snapshot and of its init, and on planted
    topics the truth's below the untrained init's; (g) rates and the
    engine step's split. Returns the numbers for the kernels line."""
    import tempfile

    t_phase = time.perf_counter()
    out = {}
    # the served model: z uniform over K, Phi and Psi drawn from it (the
    # untrained init), then 10 monolithic Gibbs iterations
    tokens = torch.from_numpy(corpus.tokens).to(dev)
    mask = torch.from_numpy(corpus.mask).to(dev)
    state = random_z_state(H.make_generator(seed + 9, dev), tokens, mask, cfg)
    snap0 = SNAP.snapshot_from_state(state, cfg, w=cfg.bucket)
    for _ in range(SERVE_TRAIN_ITERS):
        state = H.gibbs_iteration(state, tokens, mask, cfg)
    check(torch.equal(state.n, H.count_n(state.z, tokens, mask, cfg.K, cfg.V)),
          "served model: n != count_n(z)")
    snap = SNAP.snapshot_from_state(state, cfg, w=cfg.bucket)
    compact = SNAP.snapshot_from_state(state, cfg, w=cfg.bucket, compact=True)
    exact_w = min(max(-(-zops.max_column_nnz(state.phi) // 8) * 8, 8), cfg.K)
    del tokens, mask, state
    torch.cuda.synchronize()
    print(f"[9] snapshot of PubMed 0.01 after {SERVE_TRAIN_ITERS} iterations from z "
          f"uniform over K: K={snap.K} V={snap.V} W={snap.W} (exact width {exact_w}), "
          f"{snap.nbytes() / 1e6:.1f} MB (compact {compact.nbytes() / 1e6:.1f} MB)",
          flush=True)

    # the queries: another replica's documents, as long as it makes them
    t0 = time.perf_counter()
    q = paper_corpus("pubmed", np.random.default_rng(seed + 1), scale=0.01, max_len=256)
    docs = [q.tokens[i][q.mask[i]] % cfg.V for i in range(SERVE_QUERIES)]
    rids = list(range(SERVE_QUERIES))
    held = slice(SERVE_QUERIES, SERVE_QUERIES + SERVE_EVAL_DOCS)
    ev_tokens, ev_mask = q.tokens[held] % cfg.V, q.mask[held]
    del q
    lengths = np.array([len(d) for d in docs])
    by_bucket = {b: sum(int(bucket_of(n) == b) for n in lengths) for b in SERVE_BUCKETS}
    print(f"[9] {SERVE_QUERIES} queries ({time.perf_counter() - t0:.1f} s to draw): "
          f"lengths {lengths.min()}..{lengths.max()}, mean {lengths.mean():.1f}; "
          f"by bucket {by_bucket}", flush=True)

    # (a) the kernel at the serving shapes, table mode, both routes; the
    # plain version (rows independent) runs once per L over all four batches
    rng = np.random.default_rng(9)
    limit = HZ.smem_limit(dev)
    shapes = 0
    for l in SERVE_LS:
        check(HZ.route(cfg.K, l, False, limit) == "lanes", f"L={l}: route is not lanes")
        parts = []
        for d in SERVE_DS:
            pick = rng.choice(SERVE_QUERIES, size=d, replace=False)
            tok, msk = pad_rows([docs[i] for i in pick], l, dev)
            if d > 1:  # empty slots: the last, and about a quarter of the rest
                msk[torch.from_numpy(rng.random(d) < 0.25).to(dev)] = False
                msk[-1] = False
                msk[0, 0] = True
            parts.append((tok, msk, torch.from_numpy(pick.astype(np.int64)),
                          torch.from_numpy(rng.integers(0, SERVE_BURNIN + 1, d)),
                          torch.from_numpy(rng.integers(0, cfg.K, (d, l)).astype(np.int32))))
        tok, msk, seeds, sweeps, z_rand = (torch.cat(x).to(dev) for x in zip(*parts))
        u = FI.sweep_uniforms(SERVE_BASE_SEED, seeds, sweeps, l)
        u0 = FI.sweep_uniforms(SERVE_BASE_SEED, seeds, torch.zeros_like(sweeps), l)
        sub, remapped = FI.restrict_snapshot(snap, tok, bucket=64)
        check(all(t.is_contiguous() for t in sub) and remapped.dtype == torch.int32,
              "restricted snapshot: tables not contiguous or tokens not int32")
        for name, s_, t_ in (("float32", snap, tok), ("compact", compact, tok),
                             ("restricted", sub, remapped)):
            # mixed sweep counts: fresh rows from the init, the rest mid-chain
            z = torch.where((sweeps == 0)[:, None], FI.init_z(t_, msk, u0, s_.fpack, s_.ipack),
                            torch.where(msk, z_rand, 0))
            want = hdp_z_ref(t_, msk, z, u, s_.q_a, s_.fpack, s_.ipack, kk=cfg.K)
            lo = 0
            for d in SERVE_DS:
                rows = slice(lo, lo + d)
                lo += d
                args_k = (t_[rows], msk[rows], z[rows], u[rows])
                tables = dict(kk=cfg.K, q_a=s_.q_a, fpack=s_.fpack, ipack=s_.ipack)
                before = dict(hdp_z_cuda.launches_by_route)
                got = {"lanes": hdp_z_cuda(*args_k, **tables),
                       "warp": HZ._launch("warp", *args_k, **tables)}
                torch.cuda.synchronize()
                check(hdp_z_cuda.launches_by_route == {"lanes": before["lanes"] + 1,
                                                      "warp": before["warp"] + 1},
                      f"(a) D={d} L={l} {name}: launches by route "
                      f"{hdp_z_cuda.launches_by_route}, from {before}")
                for route, out_r in got.items():
                    for what, a, b in zip(("z", "m"), out_r, (want[0][rows], want[1][rows])):
                        check(torch.equal(a, b), f"(a) D={d} L={l} {name} {route}: {what} "
                                                 f"differs (max {max_int_err(a, b)})")
                shapes += 1
    print(f"[9] (a) hdp_z_cuda == hdp_z_ref bitwise (z, m), table mode, on both routes, "
          f"at {shapes} shapes: D in {SERVE_DS} x L in {SERVE_LS} x (float32, compact, "
          f"restricted) tables, with empty slots and mixed sweep counts "
          f"({time.perf_counter() - t_phase:.1f} s into the phase)", flush=True)

    # (b) the uniforms, card against CPU
    seeds_all = torch.arange(SERVE_QUERIES, dtype=torch.int64) * 7919 + 13
    sweeps_all = torch.arange(SERVE_QUERIES, dtype=torch.int64) % (SERVE_BURNIN + 1)
    u_cpu = FI.sweep_uniforms(SERVE_BASE_SEED, seeds_all, sweeps_all, 256)
    u_dev = FI.sweep_uniforms(SERVE_BASE_SEED, seeds_all.to(dev), sweeps_all.to(dev), 256)
    check(torch.equal(u_dev.cpu(), u_cpu), "(b) sweep_uniforms on the card != on the CPU")
    check(bool(((u_cpu >= 0) & (u_cpu < 1)).all()), "(b) a uniform outside [0, 1)")
    print(f"[9] (b) sweep_uniforms, {SERVE_QUERIES} seeds x 256 positions x 3: card == "
          f"CPU bitwise, mean {float(u_cpu.mean()):.5f}", flush=True)
    del u_cpu, u_dev

    # (c) the main path: the engine, its launches counted
    torch.cuda.synchronize()
    hdp_z_cuda.launches = 0
    hdp_z_cuda.launches_by_route.update(dict.fromkeys(HZ.ROUTES, 0))
    served, stats = run_engine(snap, docs, rids, SERVE_SLOTS)
    out["launches"] = hdp_z_cuda.launches
    out["launches_by_route"] = dict(hdp_z_cuda.launches_by_route)
    check(out["launches_by_route"] == {"lanes": stats.steps, "warp": 0},
          f"(c) engine: launches by route {out['launches_by_route']}, expected "
          f"{stats.steps} (its steps) on lanes")
    summary = stats.summary()
    for rid in rids:
        th = served[rid]
        check(th.shape == (cfg.K,) and bool(np.isfinite(th).all()) and bool((th >= 0).all())
              and abs(float(th.sum()) - 1.0) < 1e-4, f"(c) request {rid}: not a mixture")
    direct = {}
    for b in SERVE_BUCKETS:
        idx = [i for i in rids if bucket_of(len(docs[i])) == b]
        if idx:
            tok, msk = pad_rows([docs[i] for i in idx], b, dev)
            theta = FI.foldin_docs(snap, tok, msk, torch.tensor(idx, device=dev),
                                   SERVE_BASE_SEED, burnin=SERVE_BURNIN)
            direct.update(zip(idx, theta.cpu().numpy()))
    check_mixtures(served, direct, "(c) engine against foldin_docs")
    sub = rids[:SERVE_SUBSET]
    check_mixtures(run_engine(snap, [docs[i] for i in sub], sub, 8)[0],
                   {i: served[i] for i in sub}, "(c) slots 8 against slots 32")
    check_mixtures(run_engine(snap, [docs[i] for i in sub], sub, SERVE_SLOTS, True)[0],
                   {i: served[i] for i in sub}, "(c) async admission against sync")
    print(f"[9] (c) engine (slots {SERVE_SLOTS}, burn-in {SERVE_BURNIN}, buckets "
          f"{SERVE_BUCKETS}): {summary['completed']} requests in {summary['steps']} steps, "
          f"{summary['docs_per_s']} docs/s, p50 {summary['p50_latency_ms']} ms, p95 "
          f"{summary['p95_latency_ms']} ms; == foldin_docs bitwise; slots 8 == slots 32 "
          f"and async == sync on {SERVE_SUBSET} requests; sweeps {out['launches']} (by "
          f"route {out['launches_by_route']}); {time.perf_counter() - t_phase:.1f} s into the "
          f"phase", flush=True)

    # (d) two workers on one card
    with ServeFleet(snap, workers=2, slots=SERVE_SLOTS, burnin=SERVE_BURNIN,
                    buckets=SERVE_BUCKETS, base_seed=SERVE_BASE_SEED, device=dev) as fleet:
        for doc, rid in zip(docs, rids):
            fleet.submit(doc, seed=rid)
        fleet_out = fleet.run(timeout=600)
        fstats = fleet.stats_summary()
    check_mixtures(fleet_out, served, "(d) 2-worker fleet against the engine")
    print(f"[9] (d) 2 workers on one card (a stream each) == the engine bitwise: "
          f"{fstats['docs_per_s']} docs/s, p50 {fstats['p50_latency_ms']} ms, p95 "
          f"{fstats['p95_latency_ms']} ms, steps by worker "
          f"{[w['steps'] for w in fstats['per_worker']]}; {time.perf_counter() - t_phase:.1f} s "
          f"into the phase", flush=True)

    # (e) a live run that publishes, and an ensemble over its registry
    store = ShardedCorpusStore.from_corpus(corpus, STREAM_BLOCK_DOCS)
    stream = StreamingHDP(cfg, store, device=dev)
    live = rids[:SERVE_LIVE_QUERIES]
    with tempfile.TemporaryDirectory() as d:
        reg = SnapshotRegistry(d)
        st = stream.run(stream.init_state(seed), 2, registry=reg, publish_every_iters=1)
        check(reg.versions() == [1, 2], f"(e) registry versions {reg.versions()}")
        check_streams_equal(st, stream.run(stream.init_state(seed), 2),
                            "(e) the publishing run against the plain run")
        per_version = [run_engine(reg.load(v, device=dev), [docs[i] for i in live], live,
                                  SERVE_SLOTS)[0] for v in (1, 2)]
        with ServeFleet(reg, workers=2, ensemble=2, slots=SERVE_SLOTS,
                        burnin=SERVE_BURNIN, buckets=SERVE_BUCKETS,
                        base_seed=SERVE_BASE_SEED, device=dev) as fleet:
            for rid in live:
                fleet.submit(docs[rid], seed=rid)
            ens = fleet.run(timeout=600)
        widths = [reg.manifest()["versions"][v]["W"] for v in ("1", "2")]
    check_mixtures(ens, {rid: np.mean(np.stack([per_version[0][rid], per_version[1][rid]]),
                                      axis=0, dtype=np.float32) for rid in live},
                   "(e) ensemble against the mean of the two versions' engines")
    print(f"[9] (e) StreamingHDP.run, {store.num_blocks} blocks, 2 iterations, published "
          f"v1, v2 (W {widths}); its chain == the run without publishing bitwise; an "
          f"ensemble=2 fleet == the mean of one engine on each version, bitwise, on "
          f"{len(live)} requests; {time.perf_counter() - t_phase:.1f} s into the phase",
          flush=True)
    del stream, st

    # (f) perplexity: the served snapshot and its init measured (the
    # replica's documents are Zipf draws with no topics to learn); the
    # ranking checked on planted topics, where the port's sampler trains
    # 15 iterations from z uniform over K on the card
    ppl = EV.heldout_perplexity(snap, ev_tokens, ev_mask, SERVE_BASE_SEED + 2,
                                burnin=SERVE_BURNIN)
    ppl0 = EV.heldout_perplexity(snap0, ev_tokens, ev_mask, SERVE_BASE_SEED + 2,
                                 burnin=SERVE_BURNIN)
    check(np.isfinite(ppl) and np.isfinite(ppl0) and ppl > 1 and ppl0 > 1,
          f"(f) held-out perplexities {ppl}, {ppl0}")
    n_train = PLANTED_DOCS - PLANTED_HELDOUT
    pc, truth = planted_topics_corpus(np.random.default_rng(0), D=PLANTED_DOCS, V=48,
                                      K_true=3, doc_len=(40, 60))
    pcfg = H.HDPConfig(K=12, V=48, bucket=12, z_impl="cuda", hist_cap=64)
    ptok, pmsk = (torch.from_numpy(a[:n_train]).to(dev) for a in (pc.tokens, pc.mask))
    untrained = H.init_state(H.make_generator(seed, dev), ptok, pmsk, pcfg)
    chain = random_z_state(H.make_generator(seed + 1, dev), ptok, pmsk, pcfg)
    for _ in range(PLANTED_ITERS):
        chain = H.gibbs_iteration(chain, ptok, pmsk, pcfg)
    phi_t = torch.zeros((12, 48), device=dev)
    phi_t[:3] = torch.from_numpy(truth.phi.astype(np.float32)).to(dev)
    psi_t = torch.full((12,), 1e-6, device=dev)
    psi_t[:3] = torch.from_numpy(truth.psi.astype(np.float32)).to(dev)
    p_truth, p_init, p_trained = (
        EV.heldout_perplexity(s_, pc.tokens[n_train:], pc.mask[n_train:], 5,
                              burnin=SERVE_BURNIN) for s_ in (
            SNAP.build_snapshot(phi_t, psi_t / psi_t.sum(), pcfg.alpha),
            SNAP.snapshot_from_state(untrained, pcfg),
            SNAP.snapshot_from_state(chain, pcfg)))
    check(p_truth < 0.9 * p_init,
          f"(f) planted topics: the truth's perplexity {p_truth} not below 0.9 x the "
          f"untrained init's {p_init}")
    check(p_trained < 0.9 * p_init,
          f"(f) planted topics: the trained model's perplexity {p_trained} not below "
          f"0.9 x the untrained init's {p_init} (the truth's {p_truth})")
    print(f"[9] (f) held-out perplexity on {SERVE_EVAL_DOCS} replica documents: "
          f"{ppl:.3f} after {SERVE_TRAIN_ITERS} iterations, {ppl0:.3f} at the init (the "
          f"replica's documents are Zipf draws with no topics to learn); on planted "
          f"topics ({PLANTED_HELDOUT} held-out documents of 40-60 tokens) the port's "
          f"sampler after {PLANTED_ITERS} iterations on {n_train} documents "
          f"{p_trained:.3f} and the truth {p_truth:.3f}, each < 0.9 x the untrained "
          f"init {p_init:.3f}", flush=True)

    # (g) the engine step: wall against device time, its split, the sweep
    sub_docs = [docs[i] for i in sub]
    t0 = time.perf_counter()
    _, sub_stats = run_engine(snap, sub_docs, sub, SERVE_SLOTS)
    wall_s = time.perf_counter() - t0
    # the profiler drops kernel records where many small kernels run (see
    # device_time_ms): the run is profiled again until it kept every
    # step's sweep, up to three times, and the device time is of the
    # records kept, so the idle share is an upper estimate
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, prof_stats = run_engine(snap, sub_docs, sub, SERVE_SLOTS)
            prof_wall_s = time.perf_counter() - t0
        evts = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        sweeps_kept = sum(e.count for e in evts if "hdp_z" in e.key)
        if sweeps_kept == prof_stats.steps:
            break
        print(f"[9] (g) the profiler kept {sweeps_kept} of {prof_stats.steps} sweeps; "
              f"profiling again", flush=True)
    else:
        print(f"[9] (g) the profiler missed sweeps three times: the device times "
              f"below are of the {sweeps_kept} sweeps kept, lower estimates", flush=True)
    busy_ms = sum(e.self_device_time_total for e in evts) / 1e3
    sweep_ms = sum(e.self_device_time_total for e in evts if "hdp_z" in e.key) / 1e3
    top = sorted(evts, key=lambda e: -e.self_device_time_total)[:6]
    steps = sub_stats.steps
    step = dict(steps=steps, wall_ms=wall_s * 1e3 / steps,
                device_ms=busy_ms / prof_stats.steps, sweep_device_ms=sweep_ms / prof_stats.steps,
                profiled_wall_ms=prof_wall_s * 1e3 / prof_stats.steps,
                device_kernels_per_step=sum(e.count for e in evts) / prof_stats.steps,
                sweeps_kept=sweeps_kept,
                top_kernels_ms_per_step={e.key[:60]: e.self_device_time_total / 1e3
                                         / prof_stats.steps for e in top})
    step["idle_share"] = 1.0 - step["device_ms"] / step["wall_ms"]
    # the parts of one steady step at (32, 128), each between synchronizes
    tok, msk = pad_rows([docs[i] for i in sub[:SERVE_SLOTS]], 128, dev)
    seeds = torch.tensor(sub[:SERVE_SLOTS], dtype=torch.int64, device=dev)
    sweeps_h = np.arange(SERVE_SLOTS, dtype=np.int32) % SERVE_BURNIN
    z0 = FI.init_z(tok, msk, FI.sweep_uniforms(SERVE_BASE_SEED, seeds, torch.zeros_like(seeds),
                                               128), snap.fpack, snap.ipack)
    timers = PhaseTimers(dev)
    for _ in range(20):
        with timers.phase("counts_h2d"):
            sweeps = torch.tensor(sweeps_h, device=dev)
        with timers.phase("uniforms"):
            u = FI.sweep_uniforms(SERVE_BASE_SEED, seeds, sweeps + 1, 128)
        with timers.phase("init_z"):
            z_init = FI.init_z(tok, msk, FI.sweep_uniforms(
                SERVE_BASE_SEED, seeds, torch.zeros_like(sweeps), 128), snap.fpack, snap.ipack)
            z = torch.where((sweeps == 0)[:, None], z_init, z0)
        with timers.phase("sweep"):
            _, m = hdp_z_cuda(tok, msk, z, u, kk=cfg.K, q_a=snap.q_a, fpack=snap.fpack,
                              ipack=snap.ipack)
        with timers.phase("retire"):
            rows = torch.tensor([0, 1], dtype=torch.int64, device=dev)
            FI.topic_mixture_from_m(m[rows], snap.psi, snap.alpha).cpu()
    step["split_ms"] = {k: v * 1e3 / 20 for k, v in timers.totals.items()}
    # the sweep alone at (32, 128) on both routes, table mode
    args_k = dict(kk=cfg.K, q_a=snap.q_a, fpack=snap.fpack, ipack=snap.ipack)
    lanes_fn = lambda: hdp_z_cuda(tok, msk, z0, u, **args_k)  # noqa: E731
    warp_fn = lambda: HZ._launch("warp", tok, msk, z0, u, **args_k)  # noqa: E731
    sweep_t = {}
    for route, fn in (("lanes", lanes_fn), ("warp", warp_fn)):
        sweep_t[route] = dict(kernel_device_ms=device_time_ms(
            fn, 50, per_call=1, name="hdp_z", phase="9"),
                              event_ms=cuda_time_ms(fn, 20), host_ms=host_time_ms(fn, 20))
    sweep_t["plain_ms"] = cuda_time_ms(
        lambda: hdp_z_ref(tok, msk, z0, u, snap.q_a, snap.fpack, snap.ipack, kk=cfg.K), 1)
    sweep_t["bound_ms"], sweep_t["bound_by"] = sweep_bound_ms(
        SERVE_SLOTS, 128, cfg.K, cfg.V, snap.W, tok[msk].to(torch.int64),
        HZ.live_slots(snap.fpack[:, 0].float()).to(torch.int64), False, False)
    sweep_t["words"] = int(torch.unique(tok[msk]).numel())
    sweep_t["shape"] = f"B={SERVE_SLOTS} L=128 K={cfg.K} W={snap.W} table mode"
    rates = {k: summary[k] for k in ("docs_per_s", "p50_latency_ms", "p95_latency_ms",
                                      "completed", "steps")}
    print(f"[9] (g) engine: {rates['docs_per_s']} docs/s, p50 {rates['p50_latency_ms']} ms, "
          f"p95 {rates['p95_latency_ms']} ms; fleet (2 workers, one card) "
          f"{fstats['docs_per_s']} docs/s", flush=True)
    print(f"[9] (g) one engine step ({SERVE_SUBSET} requests, {steps} steps): wall "
          f"{step['wall_ms']:.3f} ms, device {step['device_ms']:.3f} ms (profiler; sweep "
          f"{step['sweep_device_ms']:.3f} ms; {sweeps_kept} of {prof_stats.steps} sweeps "
          f"kept), idle at most "
          f"{step['idle_share']:.1%}, "
          f"{step['device_kernels_per_step']:.0f} kernels a step; split at (32, 128), "
          f"synchronized: " + ", ".join(f"{k} {v:.3f} ms" for k, v in step["split_ms"].items()),
          flush=True)
    print(f"[9] (g) sweep at {sweep_t['shape']}, kernel device time: lanes "
          f"{sweep_t['lanes']['kernel_device_ms']:.4f} ms, warp "
          f"{sweep_t['warp']['kernel_device_ms']:.4f} ms; whole call by events, back to back: "
          f"lanes {sweep_t['lanes']['event_ms']:.4f} ms (host {sweep_t['lanes']['host_ms']:.4f} "
          f"ms), warp {sweep_t['warp']['event_ms']:.4f} ms; plain {sweep_t['plain_ms']:.1f} ms; "
          f"bound {sweep_t['bound_ms']:.5f} ms ({sweep_t['bound_by']})", flush=True)
    print(f"[9] phase 9 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    out["serve_hdp"] = {
        "engine": rates, "fleet_2_workers_one_card": {
            k: fstats[k] for k in ("docs_per_s", "p50_latency_ms", "p95_latency_ms",
                                   "completed", "steps")},
        "step": step, "sweep": sweep_t, "heldout_perplexity": ppl,
        "heldout_perplexity_init": ppl0, "planted_perplexity": {
            "trained": p_trained, "truth": p_truth, "untrained_init": p_init}, "snapshot": {
            "K": snap.K, "V": snap.V, "W": snap.W, "exact_w": exact_w,
            "mbytes": snap.nbytes() / 1e6, "compact_mbytes": compact.nbytes() / 1e6},
        "queries": SERVE_QUERIES, "by_bucket": by_bucket,
        "slots": SERVE_SLOTS, "burnin": SERVE_BURNIN}
    # for phase 10 (f): the snapshot, the queries and the engine's mixtures
    out.update(snap=snap, docs=docs, mixtures=served)
    return out


def lane_argv(lanes: int, iters: int, *extra: str) -> list[str]:
    """``launch/train.py``'s arguments for the streamed lane path on phase
    3's corpus (the same seed, scale, K, W and length)."""
    return ["--hdp", "pubmed", "--scale", "0.01", "--iters", str(iters),
            "--topics", "1000", "--max-len", "256", "--bucket", "256",
            "--seed", "0", "--log-every", str(iters), "--stream",
            "--block-docs", str(STREAM_BLOCK_DOCS), "--devices", str(lanes), *extra]


def check_same_chain(a, b, tag: str) -> None:
    """check_streams_equal and the generators' states."""
    check_streams_equal(a, b, tag)
    check(torch.equal(a.gen.get_state(), b.gen.get_state()), f"{tag}: generator differs")


def launches_since(before: dict) -> dict:
    return {r: hdp_z_cuda.launches_by_route[r] - before[r] for r in HZ.ROUTES}


def thread_busy(events) -> dict:
    """Busy seconds a thread track from a Chrome trace: the union of its
    spans (the driver's ``stage_wait``, a wait, left out) and each span
    name's sum."""
    names = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    tracks: dict = {}
    for e in events:
        if e["ph"] == "X":
            tracks.setdefault(names.get(e["tid"], str(e["tid"])), []).append(e)
    out = {}
    for track, evs in tracks.items():
        busy, end = 0.0, float("-inf")
        for t0, t1 in sorted((e["ts"], e["ts"] + e["dur"]) for e in evs
                             if e["name"] != "stage_wait"):
            if t1 > end:
                busy += t1 - max(t0, end)
                end = t1
        by_span: dict = {}
        for e in evs:
            by_span[e["name"]] = by_span.get(e["name"], 0.0) + e["dur"] / 1e6
        out[track] = {"busy_s": busy / 1e6, "by_span_s": by_span}
    return out


def overlapping_pairs(a, b) -> int:
    """Pairs of (start, end) intervals, one from each list, that overlap."""
    return sum(1 for s0, e0 in a for s1, e1 in b if s0 < e1 and s1 < e0)


def lanes_phase(corpus: Corpus, cfg: H.HDPConfig, dev: torch.device, seed: int,
                snap, docs: list, served: dict):
    """Phase 10, the streamed trainer's sweep lanes on the card, on phase
    8's 11 blocks of the PubMed 0.01 replica (K=1000, W=256, z as uint16):
    (a) 2 and 4 sweep lanes (4 through ``launch/train.py --devices 4``,
    the main path, its launches counted) bitwise the one-lane chain over 3
    iterations from phase 8's starting state, also on the disk store with
    int32 slabs; (b) each lane's ``delta_sparsify`` and the ``deltawire``
    round trip equal its dense delta, the merge the one-lane block's; (c)
    a lane-mode iteration stopped after 5 blocks, restored and finished;
    (d) 10 iterations with ``--metrics`` and ``--trace`` bitwise the
    silent chain, the metrics, the lanes' spans and the monitor; (e)
    s/iter for 1, 2 and 4 lanes, the thread split of a streamed iteration
    on the tiled corpus, and the lanes' sweeps on the device; (f) HDP
    serving with trace and metrics on. Returns the numbers for the
    kernels line."""
    import tempfile

    t_phase = time.perf_counter()
    out = {}
    store = ShardedCorpusStore.from_corpus(corpus, STREAM_BLOCK_DOCS)
    one = StreamingHDP(cfg, store, device=dev)
    ref = one.init_state(seed)
    refs = []
    for _ in range(LANE_ITERS):
        ref = one.iteration(ref)
        refs.append({f: getattr(ref, f).clone() for f in ("n", "psi", "l")})
    z_ref = ref.z_blocks.materialize().copy()

    # (a) the main path: launch/train.py --stream --devices 4, counts zeroed
    # just before and read just after
    torch.cuda.synchronize()
    hdp_z_cuda.launches = 0
    hdp_z_cuda.launches_by_route.update(dict.fromkeys(HZ.ROUTES, 0))
    st_main, _, summary = T.main(lane_argv(MAIN_LANES, LANE_ITERS))
    torch.cuda.synchronize()
    out["launches"] = hdp_z_cuda.launches
    out["launches_by_route"] = dict(hdp_z_cuda.launches_by_route)
    want = LANE_ITERS * store.num_blocks * MAIN_LANES
    lane_route = HZ.route(cfg.K, store.max_len, True, HZ.smem_limit(dev))
    check(out["launches_by_route"] == {**dict.fromkeys(HZ.ROUTES, 0), lane_route: want},
          f"(a) main path: launches by route {out['launches_by_route']}, expected "
          f"{want} on {lane_route}")
    check(summary["sweep_lanes"] == MAIN_LANES and summary["blocks"] == store.num_blocks,
          f"(a) main path summary {summary}")
    check_same_chain(ref, st_main, f"(a) {MAIN_LANES} sweep lanes (launch/train.py)")
    check(np.array_equal(st_main.z_blocks.materialize(), z_ref), "(a) z differs")
    out["delta_reduce_mb_per_iter"] = summary["delta_reduce_mb"] / LANE_ITERS
    print(f"[10] (a) launch/train.py --stream --devices {MAIN_LANES}: {LANE_ITERS} "
          f"iterations on {store.num_blocks} blocks x {store.block_docs} documents "
          f"({store.block_docs // MAIN_LANES} a sweep lane, a CUDA stream each on the one "
          f"card) == the one-lane chain bitwise (every z block, n, phi, varphi, psi, l, "
          f"generator); hdp_z launches by route {out['launches_by_route']} (route() at "
          f"{store.block_docs // MAIN_LANES} documents: {lane_route}); "
          f"{summary['sec_per_iter']:.4f} s/iter; delta_reduce "
          f"{out['delta_reduce_mb_per_iter']:.3f} MB/iter", flush=True)
    del st_main
    for lanes, kw in ((2, {}), (MAIN_LANES, {"z_store": "disk", "z_pack": "off"})):
        before = dict(hdp_z_cuda.launches_by_route)
        drv = StreamingHDP(cfg, store, device=dev, n_lanes=lanes, **kw)
        st = streamed_chain(drv, LANE_ITERS, seed)
        torch.cuda.synchronize()
        tag = f"(a) {lanes} sweep lanes {kw or ''}".strip()
        check_same_chain(ref, st, tag)
        print(f"[10] {tag} == the one-lane chain bitwise over {LANE_ITERS} iterations (z "
              f"as {st.z_blocks.dtype} in {st.z_blocks.kind}); hdp_z launches by route "
              f"{launches_since(before)}; delta_reduce "
              f"{drv.delta_reduce_bytes / 2**20 / LANE_ITERS:.3f} MB/iter", flush=True)
        del st, drv

    # (b) iteration 2's first block: each lane's nonzeros and the packed
    # exchange against the dense deltas and the one-lane block
    st1 = one.iteration(one.init_state(seed))
    gen = torch.Generator(device=dev)
    gen.set_state(st1.gen.get_state())
    _, _, ztables = one._phi_tables(gen, st1.n, st1.varphi, st1.psi)
    u = one._uniforms(gen)
    _, tokens, mask, z = one._take(one._to_device(one._host_z(one._host_block(0),
                                                              st1.z_blocks)))
    z_whole, dn_whole, dh_whole = SH.z_block(cfg, ztables, z, tokens, mask, st1.psi, u,
                                             in_kernel=one.in_kernel)
    rows = store.block_docs // MAIN_LANES
    cap = min(2 * rows * store.max_len, cfg.K * cfg.V)
    packs, dh_sum, nnzs = [], torch.zeros_like(dh_whole), []
    for d in range(MAIN_LANES):
        sl = slice(d * rows, (d + 1) * rows)
        z_d, dn_d, dh_d = SH.z_lane(cfg, ztables, z[sl], tokens[sl], mask[sl], st1.psi, u,
                                    n_lanes=MAIN_LANES, lane=d, in_kernel=one.in_kernel)
        idx, val, nnz = zops.delta_sparsify(dn_d, cap)
        pack = DW.pack_coo(idx[:nnz].cpu().numpy(), val[:nnz].cpu().numpy(), (cfg.K, cfg.V))
        check(np.array_equal(DW.unpack_delta(pack), dn_d.cpu().numpy()),
              f"(b) lane {d}: the packed nonzeros are not its dense delta")
        check(torch.equal(z_d, z_whole[sl]), f"(b) lane {d}: z differs from the block's")
        packs.append(pack)
        dh_sum += dh_d
        nnzs.append(nnz)
    merged = DW.reduce_packed(packs, shape=(cfg.K, cfg.V))
    check(np.array_equal(merged, dn_whole.cpu().numpy()),
          "(b) the merged delta is not the one-lane block's")
    check(torch.equal(dh_sum, dh_whole), "(b) the lanes' histograms do not sum to the block's")
    out["block_exchange"] = {"lane_nnz": nnzs, "packed_bytes": DW.packed_nbytes(packs),
                             "dense_bytes": MAIN_LANES * cfg.K * cfg.V * 4,
                             "kinds": [p.kind for p in packs]}
    print(f"[10] (b) iteration 2, block 0, {MAIN_LANES} lanes: delta_sparsify + deltawire "
          f"round trip == each lane's dense dn (nonzeros {nnzs}, packed as "
          f"{[p.kind for p in packs]}, {DW.packed_nbytes(packs)} B against "
          f"{MAIN_LANES * cfg.K * cfg.V * 4} B dense), merged == the one-lane block's dn, "
          f"lanes' dh sum == its dh, lanes' z == its z", flush=True)
    del z_whole, dn_whole, dh_whole, ztables, u, tokens, mask, z

    # (c) a lane-mode iteration stopped mid-way, restored and finished
    drv = StreamingHDP(cfg, store, device=dev, n_lanes=MAIN_LANES)
    st = drv.iteration(drv.init_state(seed))
    with tempfile.TemporaryDirectory() as d:
        check(drv.iteration(st, ckpt_dir=d, stop_after_blocks=LANE_STOP_BLOCKS) is None,
              "(c) the stopped iteration returned a state")
        st, kw = drv.restore(d)
        check(kw.get("start_block") == LANE_STOP_BLOCKS and st.it == 1,
              f"(c) restored at iteration {st.it}, cursor {kw.get('start_block')}")
        st = drv.iteration(st, **kw)
    check(all(torch.equal(getattr(st, f), refs[1][f]) for f in ("n", "psi", "l")),
          "(c) the resumed iteration differs from the uninterrupted one")
    st = drv.iteration(st)
    check_same_chain(ref, st, "(c) stopped, resumed, then one more iteration")
    print(f"[10] (c) {MAIN_LANES} lanes: iteration 2 stopped after {LANE_STOP_BLOCKS} blocks "
          f"(the reducer flushed before the save), restored, finished == the uninterrupted "
          f"iteration (n, psi, l), and iteration 3 after it == the one-lane chain bitwise",
          flush=True)
    del st, drv, st1, ref
    torch.cuda.empty_cache()

    # (d) metrics and trace on, through the CLI, against the silent chain
    silent = streamed_chain(one, OBS_ITERS, seed)
    with tempfile.TemporaryDirectory() as d:
        mpath, tpath = f"{d}/metrics.jsonl", f"{d}/trace.json"
        st, _, _ = T.main(lane_argv(MAIN_LANES, OBS_ITERS, "--metrics", mpath,
                                    "--trace", tpath))
        check_same_chain(silent, st, f"(d) {MAIN_LANES} lanes, metrics and trace on")
        last = json.loads(open(mpath).read().splitlines()[-1])
        got = {(m["name"], m["labels"].get("proc")): m for m in last["metrics"]}
        for name in ("train.k_star", "train.delta_nnz_frac", "train.log_lik",
                     "train.ess_log_lik", "train.delta_reduce_mb"):
            check((name, None) in got, f"(d) the metrics file lacks {name}")
        for lane in range(MAIN_LANES):
            check(("train.phase_ms", f"d{lane}") in got,
                  f"(d) the metrics file lacks train.phase_ms{{proc=d{lane}}}")
        events = json.load(open(tpath))["traceEvents"]
        spans = {lane: [(e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
                        if e["ph"] == "X" and e["name"] == f"sweep.d{lane}"]
                 for lane in range(MAIN_LANES)}
        # each iteration starts its lanes' threads anew: a lane's spans lie on
        # tracks of its own name, no track shared with another lane
        names = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
        tids = [{t for *_, t in spans[lane]} for lane in range(MAIN_LANES)]
        check(all(names.get(t) == f"sweep.d{lane}" for lane in range(MAIN_LANES)
                  for t in tids[lane])
              and sum(map(len, tids)) == len(set().union(*tids)),
              f"(d) the lanes' spans are not on distinct tracks of their own: {tids}")
        check(all(len(spans[lane]) == OBS_ITERS * store.num_blocks
                  for lane in range(MAIN_LANES)), "(d) a lane's span count is off")
        overlaps = [overlapping_pairs([x[:2] for x in spans[0]], [x[:2] for x in spans[lane]])
                    for lane in range(1, MAIN_LANES)]
        check(all(overlaps), f"(d) sweep.d0 overlaps no span of some lane: {overlaps}")
        buf = io.StringIO()
        MON.render(MON.load(mpath), out=buf)
        check("train.k_star" in buf.getvalue(), "(d) the monitor did not render the file")
        out["metrics"] = {k: got[(k, None)]["value"] for k in (
            "train.k_star", "train.delta_nnz_frac", "train.log_lik", "train.ess_log_lik",
            "train.delta_reduce_mb")}
    print(f"[10] (d) {OBS_ITERS} iterations with --metrics and --trace == the silent chain "
          f"bitwise; metrics {out['metrics']}, train.phase_ms{{proc=d0..d{MAIN_LANES - 1}}} "
          f"present; sweep.d0..d{MAIN_LANES - 1} on tracks of their own ({len(tids[0])} a lane), d0 "
          f"overlapping the others in {overlaps} span pairs; launch/monitor.py rendered the "
          f"file ({len(buf.getvalue().splitlines())} lines)", flush=True)
    del st, silent
    torch.cuda.empty_cache()

    # (e) s/iter by lane count, and the serialized split, in one call
    times = {}
    for lanes in LANE_COUNTS:
        drv = StreamingHDP(cfg, store, device=dev, n_lanes=lanes)
        st = drv.iteration(drv.init_state(seed))  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LANE_ITERS):
            st = drv.iteration(st)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / LANE_ITERS
        st, timers = drv.iteration_profiled(st)
        times[lanes] = {"sec_per_iter": sec, "profiled_sec": timers.total,
                        "phase_sec": timers.totals,
                        "delta_reduce_mb_per_iter": drv.delta_reduce_bytes / 2**20
                        / (LANE_ITERS + 2) if lanes > 1 else 0.0}
        print(f"[10] (e) {lanes} sweep lane(s): {sec:.4f} s/iter ({LANE_ITERS} iterations "
              f"after a warm one); serialized {timers.total:.4f} s: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in timers.totals.items()), flush=True)
        if lanes == MAIN_LANES:
            # the lanes' sweeps on the device: kernels on distinct streams
            with tempfile.TemporaryDirectory() as d:
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    st = drv.iteration(st)
                    torch.cuda.synchronize()
                prof.export_chrome_trace(f"{d}/lanes.json")
                kern = [e for e in json.load(open(f"{d}/lanes.json"))["traceEvents"]
                        if e.get("ph") == "X" and "hdp_z" in e.get("name", "")]
            by_stream: dict = {}
            for e in kern:
                by_stream.setdefault(e.get("args", {}).get("stream", e.get("tid")), []).append(
                    (e["ts"], e["ts"] + e["dur"]))
            keys = sorted(by_stream, key=str)
            pairs = sum(overlapping_pairs(by_stream[a], by_stream[b])
                        for i, a in enumerate(keys) for b in keys[i + 1:])
            times["device_overlap"] = {"sweeps_recorded": len(kern), "streams": len(keys),
                                       "overlapping_pairs": pairs}
            print(f"[10] (e) profiler, one {lanes}-lane iteration: {len(kern)} of "
                  f"{lanes * store.num_blocks} sweeps recorded on {len(keys)} streams, "
                  f"{pairs} pair(s) of sweeps on different streams overlapping on the device"
                  if kern else "[10] (e) profiler: no sweep kernel recorded (not shown)",
                  flush=True)
        del st, drv
    out["sec_per_iter"] = times
    # the threads of one streamed iteration on the tiled corpus (one lane)
    tiled = Corpus(np.tile(corpus.tokens, (STREAM_TILES, 1)),
                   np.tile(corpus.mask, (STREAM_TILES, 1)), corpus.V)
    big = StreamingHDP(cfg, ShardedCorpusStore.from_corpus(tiled, STREAM_BLOCK_DOCS),
                       device=dev)
    st = big.iteration(big.init_state(seed))  # warm
    tr = obs.enable_tracing()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = big.iteration(st)
    torch.cuda.synchronize()
    overlapped = time.perf_counter() - t0
    events = tr.events()
    tr.stop()
    busy = thread_busy(events)
    out["tiled_threads"] = {"overlapped_sec": overlapped, "blocks": big.store.num_blocks,
                            "threads": busy}
    print(f"[10] (e) one streamed iteration, corpus tiled {STREAM_TILES}x "
          f"({big.store.num_blocks} blocks, 1 lane), traced: {overlapped:.4f} s overlapped; "
          f"busy by thread: " + "; ".join(
              f"{t} {v['busy_s']:.4f} s (" + ", ".join(
                  f"{k} {x:.4f}" for k, x in v["by_span_s"].items()) + ")"
              for t, v in busy.items()), flush=True)
    del st, big, tiled
    torch.cuda.empty_cache()

    # (f) HDP serving with trace and metrics on; the registry holds phase
    # 9's observations too, so the latencies are counted from here
    sub = list(range(SERVE_SUBSET))

    def latencies():
        hists = [obs.metrics().get("serve.latency_ms", bucket=b) for b in SERVE_BUCKETS]
        return sum(h.count for h in hists if h is not None)

    lat0 = latencies()
    with tempfile.TemporaryDirectory() as d:
        obs.setup(trace=f"{d}/serve.json", metrics_path=f"{d}/serve.jsonl")
        try:
            with ServeFleet(snap, workers=2, slots=SERVE_SLOTS, burnin=SERVE_BURNIN,
                            buckets=SERVE_BUCKETS, base_seed=SERVE_BASE_SEED,
                            slo_ms=60_000.0, device=dev) as fleet:
                for rid in sub:
                    fleet.submit(docs[rid], seed=rid)
                observed = fleet.run(timeout=600)
                fstats = fleet.stats_summary()
            lat = latencies() - lat0
        finally:
            obs.finalize()
        events = json.load(open(f"{d}/serve.json"))["traceEvents"]
    check_mixtures(observed, {rid: served[rid] for rid in sub},
                   "(f) the fleet with trace and metrics on against the silent engine")
    check(lat == len(sub) == fstats["completed"],
          f"(f) serve.latency_ms counts {lat} for {len(sub)} requests")
    key = lambda e: (e["name"], e["cat"], e["id"])  # noqa: E731
    begins = sorted(key(e) for e in events if e["ph"] == "b")
    ends = sorted(key(e) for e in events if e["ph"] == "e")
    check(begins == ends and len(begins) == 3 * len(sub),
          f"(f) async spans: {len(begins)} begins, {len(ends)} ends, paired "
          f"{begins == ends}, expected 3 a request")
    print(f"[10] (f) 2-worker fleet, {len(sub)} requests, trace and metrics on: mixtures "
          f"== the silent engine's bitwise; serve.latency_ms count {lat}; {len(begins)} "
          f"async spans (request, request.queued, request.inflight), every one paired; "
          f"slo_ok {fstats['slo_ok']}", flush=True)
    print(f"[10] phase 10 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def flash_bwd_bound_ms(b, hq, hkv, s, d, itemsize, causal, window):
    """The gradient of attention from (q, k, v, dO): q, dO and dq
    (B, Hq, S, D), k, v, dk, dv (B, Hkv, S, D), each moved once; 10 D
    operations per unmasked pair (q.k again, dO.v, and the products
    into dv, dq and dk) at the bf16 tensor-core peak."""
    nbytes = (3 * b * hq + 4 * b * hkv) * s * d * itemsize
    ops = 10 * d * b * hq * attention_pairs(s, causal, window)
    return bound_ms(nbytes, ops, BF16_OPS_PER_S)


def ssd_bwd_bound_ms(b, s, h, p, n, cl):
    """The gradient of the intra-chunk pass: x, dy, dx (B, S, H, P), dt,
    ddec, ddt (B, S, H), a and da (H,), B, C, dB, dC (B, S, N) shared by
    the heads, dst (B, NC, H, N, P), all float32 and moved once; twice
    the forward's products (each product's two operand gradients) at
    three TF32 passes, and twice its elementwise work at the float32
    peak."""
    nc = s // cl
    nbytes = 4 * (3 * b * s * h * p + 3 * b * s * h + 2 * h + 4 * b * s * n
                  + b * nc * h * n * p)
    pairs = cl * (cl + 1) // 2
    products = 2 * b * nc * h * (pairs * (2 * n + 2 * p) + cl * 2 * n * p)
    elementwise = 2 * b * nc * h * (pairs * 3 + cl * (p + n + 5))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (products * TF32_PASSES / TF32_OPS_PER_S + elementwise / FP32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def grad_rel_errs(got, want) -> list[float]:
    """max |got - want| over max |want|, per input gradient."""
    return [float((g.float() - w.float()).abs().max()) / max(float(w.float().abs().max()), 1e-30)
            for g, w in zip(got, want)]


def check_flash_fn(gen, cfg, phase="11") -> dict:
    """11 (a), 14 (a), attention: ``FlashAttentionFn`` (the kernel forward)
    against plain autograd through ``attention_ref`` at the config's
    per-layer training shape,
    q, k, v as transposed views of bf16 leaves, as the model passes its
    projections; then the Function's backward timed (the plain version's
    recompute and its VJP) beside the plain VJP alone, its bound and
    SDPA's backward (timed only; the port never calls it)."""
    b, s, hq, hkv, d, win = TRAIN_B, TRAIN_S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.window
    bf16 = torch.bfloat16
    leaves = [torch.randn((b, s, h, d), generator=gen, device="cuda").to(bf16).requires_grad_(True)
              for h in (hq, hkv, hkv)]
    q, k, v = (t.transpose(1, 2) for t in leaves)
    before = FA.flash_attention.launches_by_route["tensor_cores"]
    out = FlashAttentionFn.apply(q, k, v, True, win)
    check(FA.flash_attention.launches_by_route["tensor_cores"] == before + 1,
          "FlashAttentionFn: no tensor-core launch")
    check(out.grad_fn is not None, "FlashAttentionFn: the kernel's output has no grad_fn")
    want = attention_ref(q, k, v, causal=True, window=win)
    g = torch.randn(out.shape, generator=gen, device="cuda").to(bf16)
    got_g = torch.autograd.grad(out, leaves, g, retain_graph=True)
    want_g = torch.autograd.grad(want, leaves, g, retain_graph=True)
    fwd_err = float((out.detach().float() - want.detach().float()).abs().max())
    check(fwd_err <= FLASH_ATOL[bf16], f"FlashAttentionFn forward: max error {fwd_err}")
    rel = grad_rel_errs(got_g, want_g)
    check(max(rel) <= FN_GRAD_REL[bf16] and all(torch.isfinite(t).all() for t in got_g),
          f"FlashAttentionFn: input gradients {rel} of their max-abs from plain autograd")
    sdpa = F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    t = dict(
        ms=cuda_time_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), 10),
        plain_vjp_ms=cuda_time_ms(
            lambda: torch.autograd.grad(want, leaves, g, retain_graph=True), 10),
        library_ms=cuda_time_ms(
            lambda: torch.autograd.grad(sdpa, leaves, g, retain_graph=True), 10))
    t["bound_ms"], t["bound_by"] = flash_bwd_bound_ms(b, hq, hkv, s, d, 2, True, win)
    print(f"[{phase}] (a) FlashAttentionFn B={b} S={s} {hq}/{hkv} heads D={d} bf16: forward "
          f"max |kernel - plain| {fwd_err:.3g} (atol {FLASH_ATOL[bf16]}); dq, dk, dv "
          f"within {', '.join(f'{r:.3g}' for r in rel)} of their max-abs from plain "
          f"autograd (bar {FN_GRAD_REL[bf16]}); backward {t['ms']:.4f} ms (plain VJP "
          f"alone {t['plain_vjp_ms']:.4f}, SDPA's backward {t['library_ms']:.4f}, "
          f"bound {t['bound_ms']:.4f} ms, {t['bound_by']})", flush=True)
    return {"forward_max_abs_err": fwd_err, "grad_max_rel_err": max(rel), **t}


def check_ssd_fn(gen, cfg) -> dict:
    """11 (a), SSD: ``SSDIntraChunkFn`` (the kernel forward) against plain
    autograd through ``ssd_intra_chunk_ref`` at hymba's per-layer shape
    on the model's dt and A, B and C (B, S, N) leaves passed as stride-0
    views; every output's gradient used; the backward timed beside the
    plain VJP alone and its bound."""
    b, s, cl, n = TRAIN_B, TRAIN_S, cfg.ssd_chunk, cfg.ssm_state
    h, p = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim
    x, dt, a, bm, cm = ssd_inputs(gen, b, s, h, p, n, model=True)
    leaves = [x.requires_grad_(True), dt.requires_grad_(True), a.requires_grad_(True),
              bm[:, :, 0].clone().requires_grad_(True), cm[:, :, 0].clone().requires_grad_(True)]
    args = (*leaves[:3], *(t[:, :, None, :].expand(b, s, h, n) for t in leaves[3:]))
    before = SSD.ssd_intra_chunk.launches_by_route["tensor_cores"]
    outs = SSDIntraChunkFn.apply(*args, cl)
    check(SSD.ssd_intra_chunk.launches_by_route["tensor_cores"] == before + 1,
          "SSDIntraChunkFn: no tensor-core launch")
    check(all(o.grad_fn is not None for o in outs), "SSDIntraChunkFn: an output has no grad_fn")
    want = ssd_intra_chunk_ref(*args, chunk=cl)
    gs = [torch.randn(o.shape, generator=gen, device="cuda") for o in outs]
    got_g = torch.autograd.grad(outs, leaves, gs, retain_graph=True)
    want_g = torch.autograd.grad(want, leaves, gs, retain_graph=True)
    fwd_err = max(float((o - w).detach().abs().max()) for o, w in zip(outs, want))
    check(fwd_err <= SSD_ATOL, f"SSDIntraChunkFn forward: max error {fwd_err}")
    rel = grad_rel_errs(got_g, want_g)
    check(max(rel) <= FN_GRAD_REL[torch.float32]
          and all(torch.isfinite(t).all() for t in got_g),
          f"SSDIntraChunkFn: input gradients {rel} of their max-abs from plain autograd")
    t = dict(
        ms=cuda_time_ms(lambda: torch.autograd.grad(outs, leaves, gs, retain_graph=True), 10),
        plain_vjp_ms=cuda_time_ms(
            lambda: torch.autograd.grad(want, leaves, gs, retain_graph=True), 10),
        library_ms=None)
    t["bound_ms"], t["bound_by"] = ssd_bwd_bound_ms(b, s, h, p, n, cl)
    print(f"[11] (a) SSDIntraChunkFn B={b} S={s} H={h} P={p} N={n} chunk={cl} f32, the "
          f"model's dt and A: forward max |kernel - plain| {fwd_err:.3g} (atol "
          f"{SSD_ATOL}); dx, ddt, da, dB, dC within {', '.join(f'{r:.3g}' for r in rel)} "
          f"of their max-abs from plain autograd (bar {FN_GRAD_REL[torch.float32]}); "
          f"backward {t['ms']:.4f} ms (plain VJP alone {t['plain_vjp_ms']:.4f}, bound "
          f"{t['bound_ms']:.5f} ms, {t['bound_by']})", flush=True)
    return {"forward_max_abs_err": fwd_err, "grad_max_rel_err": max(rel), **t}


def lm_launches() -> tuple[int, int]:
    return FA.flash_attention.launches, SSD.ssd_intra_chunk.launches


def zero_lm_launches() -> None:
    FA.flash_attention.launches = 0
    FA.flash_attention.launches_by_route.update(dict.fromkeys(FA.ROUTES, 0))
    SSD.ssd_intra_chunk.launches = 0
    SSD.ssd_intra_chunk.launches_by_route.update(dict.fromkeys(SSD.ROUTES, 0))


def synced_ms(fn):
    """(fn's result, its wall ms between synchronizes)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def profiled_step(step, state, bt):
    """One ``make_train_step`` step under ``torch.profiler``: (the new
    state, its wall ms, device busy ms and idle share, the LM kernels'
    device ms and records, the device records in all and the six
    largest by device time)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, m = step(state, bt)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    check(int(m["skipped"]) == 0, "profiled step skipped")
    evts = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in evts) / 1e3
    by = lambda key: sum(e.self_device_time_total for e in evts if key in e.key) / 1e3  # noqa: E731
    count = lambda key: sum(e.count for e in evts if key in e.key)  # noqa: E731
    top = sorted(evts, key=lambda e: -e.self_device_time_total)[:6]
    return state, {
        "wall_ms": wall, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
        "flash_fwd_sm90_ms": by("flash_fwd_sm90"), "flash_records": count("flash_fwd_sm90"),
        "ssd_chunk_sm90_ms": by("ssd_chunk_sm90"), "ssd_records": count("ssd_chunk_sm90"),
        "kernels": len(evts), "launches": sum(e.count for e in evts),
        "top": [(e.key[:60], e.self_device_time_total / 1e3, e.count) for e in top]}


def check_full_width_grads(cfg, dev) -> dict:
    """11 (b): one loss and backward of the full-width model (seed 0) on a
    batch of the synthetic stream: every parameter's gradient present and
    finite, every block's attn.wq and ssm.in_proj gradient non-zero, each
    kernel launched twice a layer (forward and recompute). Then the split
    of warm steps (forward with the loss, backward with the recompute,
    AdamW; a no-grad ``forward_hidden`` as the recompute's measure) and
    one profiled ``make_train_step`` step: device busy and idle share,
    kernels by device time."""
    state = TT.train_state_for(TLM.CausalLM(cfg, torch.Generator(device=dev).manual_seed(0)))
    params = state.params
    stream = LMD.SyntheticLMStream(cfg.vocab_size, TRAIN_B, TRAIN_S)
    bt = TT.batch_tensors(stream.batch(0), dev)
    inputs = (bt["tokens"], bt["targets"], bt["mask"])
    zero_lm_launches()
    loss = TLM.lm_loss(state.model, *inputs)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    launches = lm_launches()
    check(bool(torch.isfinite(loss)), f"full width: loss {float(loss.detach())}")
    missing = [n for n, g in zip(params, grads) if g is None]
    check(not missing, f"full width: no gradient for {missing[:5]} ({len(missing)})")
    bad = [n for n, g in zip(params, grads) if not torch.isfinite(g).all()]
    check(not bad, f"full width: non-finite gradients in {bad[:5]} ({len(bad)})")
    named = dict(zip(params, grads))
    zero = [n for i in range(cfg.num_layers) for n in (f"blocks.{i}.attn.wq", f"blocks.{i}.ssm.in_proj")
            if float(named[n].abs().max()) == 0.0]
    check(not zero, f"full width: zero gradients in {zero}")
    want = 2 * cfg.num_layers
    check(launches == (want, want) and FA.flash_attention.launches_by_route["tensor_cores"] == want
          and SSD.ssd_intra_chunk.launches_by_route["tensor_cores"] == want,
          f"full width: launches (flash, ssd) {launches}, expected {want} each, tensor-core")
    n_params = sum(p.numel() for p in params.values())
    print(f"[11] (b) full width ({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{n_params:,} parameters, bf16), B={TRAIN_B} S={TRAIN_S}: loss "
          f"{float(loss):.4f}; all {len(params)} gradients present and finite, attn.wq "
          f"and ssm.in_proj non-zero in every block; launches flash {launches[0]}, ssd "
          f"{launches[1]} (forward + recompute)", flush=True)
    del loss, grads, named

    opt = TO.AdamWConfig(lr=1e-3, warmup=20)
    split = {}
    for i in range(3):
        loss, split["forward_ms"] = synced_ms(lambda: TLM.lm_loss(state.model, *inputs))
        grads, split["backward_ms"] = synced_ms(
            lambda: torch.autograd.grad(loss, list(params.values())))
        _, split["adamw_ms"] = synced_ms(lambda: TO.adamw_update(
            opt, dict(zip(params, grads)), state.mu, state.nu, params, i))
        del loss, grads
    with torch.no_grad():
        _, split["recompute_ms"] = synced_ms(lambda: state.model.forward_hidden(bt["tokens"]))

    step = TT.make_train_step(cfg, opt)
    state, _ = step(state, bt)  # warm
    state, prof_split = profiled_step(step, state, bt)
    wall, busy = prof_split["wall_ms"], prof_split["device_busy_ms"]
    print(f"[11] (b) a warm step's split, synchronized: forward + loss "
          f"{split['forward_ms']:.2f} ms, backward (recompute + VJPs) "
          f"{split['backward_ms']:.2f} ms, AdamW {split['adamw_ms']:.2f} ms; a no-grad "
          f"forward (the recompute) {split['recompute_ms']:.2f} ms", flush=True)
    print(f"[11] (b) one profiled step: wall {wall:.2f} ms, device busy {busy:.2f} ms, "
          f"idle {prof_split['idle_share']:.1%}; flash_fwd_sm90 "
          f"{prof_split['flash_fwd_sm90_ms']:.3f} ms ({prof_split['flash_records']} "
          f"records), ssd_chunk_sm90 {prof_split['ssd_chunk_sm90_ms']:.3f} ms "
          f"({prof_split['ssd_records']} records), {prof_split['launches']} device "
          f"records in all; largest: " + "; ".join(
              f"{k} {ms:.2f} ms x{c}" for k, ms, c in prof_split["top"]), flush=True)
    del state
    torch.cuda.empty_cache()
    return {"parameters": n_params, "split": split, "profiled_step": prof_split}


def train_cli(argv, per_step: list, plain_calls: dict, cfg=None):
    """``launch/train.py`` with ``argv`` (``train_lm`` on ``cfg`` where one
    is given), recording each step's kernel launches and the plain
    versions' calls (the backward's VJPs) into ``per_step`` and
    ``plain_calls``."""
    make_step = T.make_train_step
    plain = (FAO.attention_ref, SSDO.ssd_intra_chunk_ref)

    def counting(name, fn):
        def wrapped(*a, **kw):
            plain_calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    def make_counting_step(cfg, opt):
        step = make_step(cfg, opt)

        def counted(state, batch):
            before = (*lm_launches(), plain_calls["attention"], plain_calls["ssd"])
            out = step(state, batch)
            after = (*lm_launches(), plain_calls["attention"], plain_calls["ssd"])
            per_step.append(tuple(a - b for a, b in zip(after, before)))
            return out
        return counted

    T.make_train_step = make_counting_step
    FAO.attention_ref = counting("attention", plain[0])
    SSDO.ssd_intra_chunk_ref = counting("ssd", plain[1])
    try:
        if cfg is None:
            return T.main(argv)
        return T.train_lm(T.build_parser().parse_args(argv), cfg)
    finally:
        T.make_train_step = make_step
        FAO.attention_ref, SSDO.ssd_intra_chunk_ref = plain


def resume_run(cfg, dev, steps: int, ckpt=None) -> list[float]:
    """The losses of ``steps`` Trainer steps as ``launch/train.py`` takes
    them (AdamW lr 1e-3, warmup 20, seed 0, the stream from the restored
    step), checkpointing every ``RESUME_STEPS`` steps into ``ckpt``."""
    opt = TO.AdamWConfig(lr=1e-3, warmup=20)
    tr = TT.Trainer(cfg, opt, TT.make_train_step(cfg, opt), checkpoint_dir=ckpt,
                    checkpoint_every=RESUME_STEPS, device=dev)
    state = tr.restore_or_init(0)
    stream = LMD.SyntheticLMStream(cfg.vocab_size, TRAIN_B, TRAIN_S)
    data = (TT.batch_tensors(b, dev) for b in LMD.batches(stream, steps, start=state.step))
    state, hist = tr.run(state, data, log_every=1)
    del state
    torch.cuda.empty_cache()
    return [h["loss"] for h in hist]


def train_phase(dev, cfg) -> dict:
    """Phase 11: hymba-1.5b training at full width (see the docstring)."""
    import tempfile

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(11)
    fn = {"flash": check_flash_fn(gen, cfg), "ssd": check_ssd_fn(gen, cfg)}
    torch.cuda.empty_cache()
    full = check_full_width_grads(cfg, dev)

    # (c) the main path through the CLI
    per_step, plain_calls = [], {"attention": 0, "ssd": 0}
    zero_lm_launches()
    before_gib = torch.cuda.memory_allocated(dev) / 2**30  # held by earlier phases
    _, hist, summary = train_cli([
        "--arch", "hymba-1.5b", "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_B),
        "--seq", str(TRAIN_S), "--log-every", "1"], per_step, plain_calls)
    launches = {"flash": dict(FA.flash_attention.launches_by_route),
                "ssd": dict(SSD.ssd_intra_chunk.launches_by_route)}
    layers = cfg.num_layers
    check(len(hist) == TRAIN_STEPS and all(np.isfinite(h["loss"]) for h in hist),
          f"train: losses {[h['loss'] for h in hist]}")
    check(all(h["skipped"] == 0 for h in hist), f"train: skipped {[h['skipped'] for h in hist]}")
    check(per_step == [(2 * layers, 2 * layers, layers, layers)] * TRAIN_STEPS,
          f"train: per step (flash, ssd launches, plain attention, plain ssd calls) "
          f"{per_step}, expected {(2 * layers, 2 * layers, layers, layers)} each")
    want = 2 * layers * TRAIN_STEPS
    check(launches["flash"]["tensor_cores"] == want and launches["ssd"]
          == {**dict.fromkeys(SSD.ROUTES, 0), "tensor_cores": want},
          f"train: launches by route {launches}, expected {want} each on tensor_cores")
    secs = [h["sec"] for h in hist[1:]]
    ms_step = 1e3 * float(np.median(secs))
    # the profiled step's device time against an unprofiled step's wall
    # time: the profiler lengthens the host's part of a step
    idle = 1.0 - full["profiled_step"]["device_busy_ms"] / ms_step
    print(f"[11] (c) launch/train.py --arch hymba-1.5b --steps {TRAIN_STEPS} --batch "
          f"{TRAIN_B} --seq {TRAIN_S}: losses {[round(h['loss'], 4) for h in hist]}, none "
          f"skipped; every step launched flash {2 * layers} and ssd {2 * layers} times "
          f"(forward + recompute, all tensor-core) and called the plain attention and "
          f"SSD {layers} times each (the backward's VJPs), no plain forward; "
          f"{summary['tokens_per_s']:.1f} tok/s over the run, {ms_step:.1f} ms a step "
          f"(median of steps 2-{TRAIN_STEPS}, spread {min(secs) * 1e3:.1f}-"
          f"{max(secs) * 1e3:.1f}), peak {summary['peak_mem_gib']:.3f} GiB "
          f"(torch.cuda.max_memory_allocated); device busy "
          f"{full['profiled_step']['device_busy_ms']:.2f} ms of a step (profiled), "
          f"idle {idle:.1%} of the median step; {nvidia_smi()}", flush=True)
    torch.cuda.empty_cache()

    # (d) checkpoint and resume, full width at depth RESUME_LAYERS
    cfg_r = dataclasses.replace(cfg, num_layers=RESUME_LAYERS)
    whole = resume_run(cfg_r, dev, 2 * RESUME_STEPS)
    again = resume_run(cfg_r, dev, 2 * RESUME_STEPS)
    with tempfile.TemporaryDirectory() as d:
        first = resume_run(cfg_r, dev, RESUME_STEPS, d)
        check(CKPT.latest_step(d) == RESUME_STEPS, f"resume: checkpoints {CKPT.all_steps(d)}")
        second = resume_run(cfg_r, dev, RESUME_STEPS, d)
    resumed = first + second
    err = max(abs(a - b) for a, b in zip(resumed, whole))
    spread = max(abs(a - b) for a, b in zip(again, whole))
    bar = RESUME_REL * max(abs(x) for x in whole)
    check(all(np.isfinite(resumed)) and err <= bar,
          f"resume: losses {resumed} against {whole}: max error {err} > {bar}")
    print(f"[11] (d) depth {RESUME_LAYERS}, full width: {RESUME_STEPS} steps, a checkpoint, "
          f"{RESUME_STEPS} more restored from it: max |resumed - uninterrupted| loss "
          f"{err:.3g} (bar {bar:.3g}, {RESUME_REL} of the largest loss); two uninterrupted "
          f"runs differ by {spread:.3g}; losses {[round(x, 4) for x in whole]}", flush=True)
    print(f"[11] phase 11 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"fn": fn, "full": full, "launches": launches, "hist": hist,
            "train": {"tokens_per_s": summary["tokens_per_s"], "ms_per_step": ms_step,
                      "memory_before_gib": before_gib,
                      "sec_per_step": secs, "peak_mem_gib": summary["peak_mem_gib"],
                      "idle_share": idle,
                      "parameters": full["parameters"], "split": full["split"],
                      "profiled_step": full["profiled_step"],
                      "resume_max_abs_err": err, "resume_spread": spread}}


def time_flash(gen, b, hq, hkv, s, d, dtype, route, phase="12 (a)") -> dict:
    """12 (a), 13 (a): one route at one shape, causal: the kernel by profiler
    device time and by events, SDPA the same ways (timed only; the port
    never calls it), the plain version by events, and the bound."""
    q, k, v = flash_inputs(gen, b, hq, hkv, s, d, dtype)
    kern = lambda: FA._launch(route, q, k, v, True, None)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, enable_gqa=True)
    err = float((kern().float() - attention_ref(q, k, v).float()).abs().max())
    lib_err = float((sdpa().float() - attention_ref(q, k, v).float()).abs().max())
    check(err <= FLASH_ATOL[dtype], f"flash {route} D={d}: max error {err}")
    t = dict(route=route, head_dim=d, dtype=str(dtype).replace("torch.", ""),
             shape=f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} causal",
             max_abs_err=err, library_max_abs_err=lib_err,
             ms=device_time_ms(kern, 20, per_call=1), event_ms=cuda_time_ms(kern, 20),
             library_ms=device_time_ms(sdpa, 20), library_event_ms=cuda_time_ms(sdpa, 20),
             plain_ms=cuda_time_ms(lambda: attention_ref(q, k, v), 3))
    t["bound_ms"], t["bound_by"] = flash_bound_ms(b, hq, hkv, s, d, q.element_size(),
                                                  True, None)
    print(f"[{phase}] flash {route} {t['dtype']} {t['shape']}: device time {t['ms']:.4f} ms "
          f"(events {t['event_ms']:.4f}), bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
          f"{t['ms'] / t['bound_ms']:.1f}x; SDPA {t['library_ms']:.4f} ms (events "
          f"{t['library_event_ms']:.4f}, max |SDPA - plain| {lib_err:.3g}); plain "
          f"{t['plain_ms']:.4f} ms", flush=True)
    return t


def phase12_shapes(cfg) -> dict:
    """Head dim: (B, Hq, Hkv, S, D) of 12 (a): paligemma's prefill
    (prefix + prompt) and nemotron's heads."""
    return {256: (PALI_B, cfg.num_heads, cfg.num_kv_heads, cfg.prefix_len + PALI_PROMPT,
                  cfg.head_dim),
            192: (NEMO_B, *NEMO_HEADS[:2], NEMO_S, NEMO_HEADS[2])}


def flash_timings() -> None:
    """12 (a)'s timings, run by ``paligemma_phase`` in a process of its
    own: by phase 12 the profiler in the script's process loses records
    (after phase 11 it kept 16 of 20 launches of one kernel, and none of
    one launch), while a fresh process keeps them all. Prints the [12]
    lines, then one JSON list of ``time_flash``'s results."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(12)
    out = [time_flash(gen, *shape, dtype, FA.route(dtype, d))
           for d, shape in phase12_shapes(get_config("paligemma-3b")).items()
           for dtype in (torch.bfloat16, torch.float32)]
    print(json.dumps(out), flush=True)


def paligemma_phase(dev) -> dict:
    """Phase 12: the flash kernels at head dims 192 and 256, paligemma-3b
    served at full width, float32 decode after a prefix at depth 4, and
    the topic-conditioned LM on the card (see the docstring)."""
    from repro_torch.launch import topic_lm as TOPIC

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(12)
    cfg = get_config("paligemma-3b")
    bf16, f32 = torch.bfloat16, torch.float32
    shapes = phase12_shapes(cfg)
    check(cfg.head_dim == 256 and shapes[256] == (4, 8, 1, 768, 256),
          f"paligemma-3b's prefill shape {shapes[256]}")
    for line in _build.ptxas_report(FA.SOURCE).splitlines():
        if re.search(r"registers|spill", line):
            print(f"[12] flash_attention ptxas: {line.strip()}", flush=True)

    # (a) both routes at both head dims against the plain version, timed
    errs = {}
    for d, shape in shapes.items():
        check(FA.route(bf16, d) == "tensor_cores" and FA.route(f32, d) == "cuda_cores",
              f"flash routes at D={d}: {FA.route(bf16, d)}, {FA.route(f32, d)}")
        for dtype in (bf16, f32):
            for window in (None, PHASE12_WINDOW):
                err, _ = check_flash(gen, *shape, dtype, True, window, phase="12")
                errs[(d, str(dtype))] = max(errs.get((d, str(dtype)), 0.0), err)
    child = subprocess.run(
        [sys.executable, "-c", "import chip_smoke as C; C.flash_timings()"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = child.stdout.strip().splitlines()
    print("\n".join(lines[:-1]), flush=True)
    check(child.returncode == 0, f"12 (a) timings: exit {child.returncode}\n"
          f"{child.stdout[-2000:]}\n{child.stderr[-4000:]}")
    timed = json.loads(lines[-1])
    torch.cuda.empty_cache()

    # (b) the main path: launch/serve.py at full width and depth
    args = SV.build_parser().parse_args([
        "--arch", "paligemma-3b", "--requests", str(PALI_REQUESTS), "--batch",
        str(PALI_B), "--prompt-len", str(PALI_PROMPT), "--gen", str(PALI_GEN),
        "--seed", "0"])
    torch.cuda.reset_peak_memory_stats()
    zero_lm_launches()
    outputs, served = SV.serve(args)
    launches = FA.flash_attention.launches
    by_route = dict(FA.flash_attention.launches_by_route)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    batches = PALI_REQUESTS // PALI_B
    want = cfg.num_layers * batches
    check(launches == want and by_route == {"tensor_cores": want, "cuda_cores": 0},
          f"paligemma serve: flash {launches} launches, by route {by_route}, expected "
          f"{want} on tensor_cores")
    check(SSD.ssd_intra_chunk.launches == 0, "paligemma serve: an SSD launch")
    check(served["logits_finite"], "paligemma serve: a logit is not finite")
    check(len(outputs) == PALI_REQUESTS and all(len(o) == PALI_GEN for o in outputs),
          f"paligemma serve: not {PALI_REQUESTS} requests of {PALI_GEN} tokens")
    check(all(0 <= t < cfg.vocab_size for o in outputs for t in o),
          "paligemma serve: a token outside the vocabulary")
    n_params = (cfg.vocab_size * cfg.d_model + cfg.d_model + cfg.num_layers * (
        2 * cfg.d_model + cfg.d_model * cfg.head_dim * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
        + 3 * cfg.d_model * cfg.d_ff))
    print(f"[12] (b) served paligemma-3b ({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads at D={cfg.head_dim}, GeGLU d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {n_params:,} parameters, bf16, seed 0): "
          f"{PALI_REQUESTS} requests, batch {PALI_B}, prefix {cfg.prefix_len} + prompt "
          f"{PALI_PROMPT}, gen {PALI_GEN}, cache {SV.cache_length(cfg, PALI_PROMPT, PALI_GEN)}; "
          f"flash launches {launches} (by route {by_route}); prefill "
          f"{served['prefill_tok_s']} tok/s, decode {served['decode_tok_s']} tok/s "
          f"({batches - 1} timed batch after 1 warm-up); peak "
          f"{peak_gib:.3f} GiB (torch.cuda.max_memory_allocated); sample "
          f"{served['sample_output']}", flush=True)
    torch.cuda.empty_cache()

    # (c) float32 at full width, depth 4: decode after a prefixed prefill
    # against the last logits of a prefill one token longer; the CUDA-core
    # route at D=256 inside the model
    cfg32 = dataclasses.replace(cfg, num_layers=PALI_F32_LAYERS, param_dtype="float32",
                                compute_dtype="float32")
    zero_lm_launches()
    with torch.inference_mode():
        model = CausalLM(cfg32, torch.Generator(device=dev).manual_seed(1))
        toks = torch.randint(0, cfg32.vocab_size, (2, PALI_PROMPT + 1), generator=gen,
                             device=dev)
        emb = torch.randn((2, cfg32.prefix_len, cfg32.d_model), generator=gen, device=dev)
        cache_len = cfg32.prefix_len + PALI_PROMPT + 1
        _, cache = model.prefill(toks[:, :PALI_PROMPT], cache_len, emb)
        dec_logits, _ = model.decode_step(toks[:, PALI_PROMPT], cache,
                                          cfg32.prefix_len + PALI_PROMPT)
        full_logits, _ = model.prefill(toks, cache_len, emb)
    del model, cache
    f32_by_route = dict(FA.flash_attention.launches_by_route)
    cons_err = float((dec_logits - full_logits).abs().max())
    cons_scale = float(full_logits.abs().max())
    check(bool(torch.isfinite(dec_logits).all()), "paligemma f32: non-finite logits")
    check(f32_by_route == {"tensor_cores": 0, "cuda_cores": 2 * PALI_F32_LAYERS},
          f"paligemma f32: flash launches by route {f32_by_route}")
    check(cons_err <= CONSISTENCY_ATOL,
          f"paligemma f32: max |decode - prefill(S+1)| {cons_err} > {CONSISTENCY_ATOL}")
    print(f"[12] (c) float32, full width, depth {PALI_F32_LAYERS}, prefix "
          f"{cfg32.prefix_len} + {PALI_PROMPT} tokens: max |decode logits - prefill(S+1) "
          f"logits| = {cons_err} (largest |logit| {cons_scale}; atol {CONSISTENCY_ATOL}); "
          f"flash launches by route {f32_by_route}", flush=True)
    torch.cuda.empty_cache()

    # (d) the topic-conditioned LM: the port's sampler on the card (hdp_z),
    # its mixtures as a one-position prefix of a small LM
    zero_lm_launches()
    z_before = hdp_z_cuda.launches
    t0 = time.perf_counter()
    topic = TOPIC.run("cuda")
    topic_s = time.perf_counter() - t0
    topic["hdp_z_launches"] = hdp_z_cuda.launches - z_before
    topic["flash_launches_by_route"] = dict(FA.flash_attention.launches_by_route)
    check(topic["hdp_z_launches"] == 100, f"topic LM: {topic['hdp_z_launches']} sweeps")
    check(np.isfinite(topic["conditioned_loss"]) and np.isfinite(topic["unconditioned_loss"]),
          f"topic LM: losses {topic}")
    check(topic["conditioned_loss"] < topic["unconditioned_loss"],
          f"topic LM: conditioned loss {topic['conditioned_loss']} is not below the "
          f"unconditioned {topic['unconditioned_loss']}")
    print(f"[12] (d) topic-conditioned LM on the card: {topic['active_topics']} active "
          f"topics after 100 Gibbs iterations ({topic['hdp_z_launches']} hdp_z sweeps); "
          f"loss unconditioned {topic['unconditioned_loss']:.4f}, topic-conditioned "
          f"{topic['conditioned_loss']:.4f}, gain {topic['gain']:.4f}; flash launches by "
          f"route {topic['flash_launches_by_route']}; {topic_s:.1f} s", flush=True)
    phase_s = time.perf_counter() - t_phase
    print(f"[12] phase 12 took {phase_s:.1f} s", flush=True)
    main_t = timed[0]
    return {"launches": launches, "launches_by_route": by_route,
            "max_abs_err": errs[(256, str(bf16))], "timed": timed, "main": main_t,
            "errs": {f"D={d} {dt.replace('torch.', '')}": e for (d, dt), e in errs.items()},
            "serve": {k: served[k] for k in ("prefill_tok_s", "decode_tok_s",
                                              "prefill_tok_s_per_batch",
                                              "decode_tok_s_per_batch", "sample_output")}
            | {"peak_mem_gib": peak_gib, "parameters": n_params},
            "consistency_f32_depth4": {"max_abs_err": cons_err, "max_abs_logit": cons_scale,
                                       "launches_by_route": f32_by_route},
            "topic_lm": topic, "seconds": phase_s}


def phase13_shapes() -> dict:
    """Arch: (B, Hq, Hkv, S, D) of 13 (a), each attention config's
    prefill (S the prompt and the config's prefix)."""
    return {arch: (MOE_B, c.num_heads, c.num_kv_heads, MOE_PROMPT + c.prefix_len, c.head_dim)
            for arch in PHASE13_ATTN for c in [get_config(arch)]}


def mamba2_ssd_shape() -> tuple:
    """(B, S, H, P, N, chunk) of mamba2-780m's intra-chunk pass at the
    serving batch and prompt."""
    c = get_config("mamba2-780m")
    return (MOE_B, MOE_PROMPT, c.ssm_expand * c.d_model // c.ssm_head_dim,
            c.ssm_head_dim, c.ssm_state, c.ssd_chunk)


def time_ssd(gen, b, s, h, p, n, cl) -> dict:
    """13 (a): the SSD kernel of the route ``SSD.route`` gives and, on the
    same inputs, the CUDA-core kernel (the earlier design), on dt and A
    as the model at init feeds them: by profiler device time and by
    events, in turns (kernel, CUDA-core, CUDA-core, kernel), the plain
    version by events, and the bound."""
    args = ssd_inputs(gen, b, s, h, p, n, shared=True, model=True)
    r = SSD.route(cl, n, p)
    kern = lambda: SSD._launch(r, *args, cl)  # noqa: E731
    core = lambda: SSD._launch("cuda_cores", *args, cl)  # noqa: E731
    runs = {f: [] for f in ("ms", "event_ms", "earlier_ms", "earlier_event_ms")}
    for fn, key in ((kern, ""), (core, "earlier_"), (core, "earlier_"), (kern, "")):
        runs[f"{key}ms"].append(device_time_ms(fn, 20, per_call=1, phase="13"))
        runs[f"{key}event_ms"].append(cuda_time_ms(fn, 20))
    t = dict(route=r, shape=f"B={b} S={s} H={h} P={p} N={n} chunk={cl} f32, model dt and A",
             **{k: min(v) for k, v in runs.items()}, runs=runs,
             plain_ms=cuda_time_ms(lambda: ssd_intra_chunk_ref(*args, chunk=cl), 3),
             library_ms=None)
    t["bound_ms"], t["bound_by"] = ssd_bound_ms(b, s, h, p, n, cl)
    print(f"[13] (a) ssd {r} {t['shape']}: device time {t['ms']:.4f} ms (events "
          f"{t['event_ms']:.4f}), bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
          f"{t['ms'] / t['bound_ms']:.1f}x; the CUDA-core kernel on the same inputs "
          f"{t['earlier_ms']:.4f} ms (events {t['earlier_event_ms']:.4f}), "
          f"{t['earlier_ms'] / t['ms']:.1f}x the kernel's; plain {t['plain_ms']:.4f} ms; "
          f"in turns {runs}", flush=True)
    return t


def phase13_timings() -> None:
    """13 (a)'s timings, in a process of their own as ``flash_timings``:
    flash bf16 on the tensor cores at the attention configs' prefill
    shapes, the wide tensor-core SSD and the CUDA-core one at
    mamba2-780m's. Prints the [13] lines,
    then one JSON object."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(13)
    out = {"flash": {arch: time_flash(gen, *shape, torch.bfloat16, "tensor_cores",
                                      phase="13 (a)")
                     for arch, shape in phase13_shapes().items()},
           "ssd": time_ssd(gen, *mamba2_ssd_shape())}
    print(json.dumps(out), flush=True)


def serve_args(arch: str):
    """``launch/serve.py``'s arguments for phase 13's serving runs."""
    return SV.build_parser().parse_args([
        "--arch", arch, "--requests", str(MOE_REQUESTS), "--batch", str(MOE_B),
        "--prompt-len", str(MOE_PROMPT), "--gen", str(MOE_GEN), "--seed", "0"])


def check_served(tag: str, cfg, outputs, served) -> None:
    check(served["logits_finite"], f"{tag}: a logit is not finite")
    check(len(outputs) == MOE_REQUESTS and all(len(o) == MOE_GEN for o in outputs),
          f"{tag}: not {MOE_REQUESTS} requests of {MOE_GEN} tokens")
    check(all(0 <= t < cfg.vocab_size for o in outputs for t in o),
          f"{tag}: a token outside the vocabulary")


def moe_phase(dev) -> dict:
    """Phase 13: the LM kernels at the new configs' shapes, deepseek-moe-16b
    served at full width and depth, float32 decode and both dispatches at
    depth 4, and four more configs served (see the docstring)."""
    from repro_torch.models import moe as MOE

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(13)
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = get_config("deepseek-moe-16b")
    shapes = phase13_shapes()
    ssd_shape = mamba2_ssd_shape()
    check(shapes["deepseek-moe-16b"] == (4, 16, 16, 512, 128),
          f"deepseek-moe-16b's prefill shape {shapes['deepseek-moe-16b']}")
    check(ssd_shape == (4, 512, 48, 64, 128, 128)
          and SSD.route(128, 128, 64) == "tensor_cores_wide",
          f"mamba2-780m's SSD shape {ssd_shape}, route {SSD.route(128, 128, 64)}")
    ssd_ptxas = {src.stem: [line.strip() for line in _build.ptxas_report(src).splitlines()
                            if re.search(r"registers|spill", line)]
                 for src in (SSD.WIDE_SOURCE, SSD.SOURCE)}
    for stem, lines in ssd_ptxas.items():
        for line in lines:
            print(f"[13] {stem} ptxas: {line}", flush=True)

    # (a) the kernels at the new shapes against their plain versions, timed
    # in a child process
    errs = {}
    for arch, shape in shapes.items():
        check(FA.route(bf16, shape[-1]) == "tensor_cores", f"{arch}: flash route")
        errs[arch], _ = check_flash(gen, *shape, bf16, True, None, sdpa=True, phase="13")
    errs["deepseek-moe-16b float32"], _ = check_flash(
        gen, *shapes["deepseek-moe-16b"], f32, True, None, phase="13")
    ssd_err = max(check_ssd(gen, *ssd_shape, shared=shared, model=model, phase="13",
                            also=("cuda_cores",))
                  for shared in (True, False) for model in (False, True))
    ssd_oracle_err = check_ssd_oracle(
        "[13] ssd at mamba2-780m's shape, model dt and A",
        ssd_inputs(gen, *ssd_shape[:5], shared=True, model=True), ssd_shape[5])
    child = subprocess.run(
        [sys.executable, "-c", "import chip_smoke as C; C.phase13_timings()"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = child.stdout.strip().splitlines()
    print("\n".join(lines[:-1]), flush=True)
    check(child.returncode == 0, f"13 (a) timings: exit {child.returncode}\n"
          f"{child.stdout[-2000:]}\n{child.stderr[-4000:]}")
    timed = json.loads(lines[-1])
    torch.cuda.empty_cache()

    # (b) the main path: launch/serve.py at full width and depth; the
    # experts' dropped share read from the aux that every moe call returns
    # (a wrapper on the module's function: the model keeps no state)
    dropped = {"prefill": [], "decode": []}
    moe_fn = MOE.moe

    def recorded(p, c, x, **kw):
        out, aux = moe_fn(p, c, x, **kw)
        dropped["prefill" if x.shape[1] > 1 else "decode"].append(aux["dropped"])
        return out, aux

    torch.cuda.reset_peak_memory_stats()
    zero_lm_launches()
    MOE.moe = recorded
    try:
        outputs, served = SV.serve(serve_args(cfg.name))
    finally:
        MOE.moe = moe_fn
    launches = FA.flash_attention.launches
    by_route = dict(FA.flash_attention.launches_by_route)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    batches = MOE_REQUESTS // MOE_B
    want = cfg.num_layers * batches
    check(launches == want and by_route == {"tensor_cores": want, "cuda_cores": 0},
          f"deepseek serve: flash {launches} launches, by route {by_route}, expected "
          f"{want} on tensor_cores")
    check(SSD.ssd_intra_chunk.launches == 0, "deepseek serve: an SSD launch")
    check_served("deepseek serve", cfg, outputs, served)
    share = {k: torch.stack(v).float().cpu().numpy() for k, v in dropped.items()}
    check(len(share["prefill"]) == want and len(share["decode"]) == want * MOE_GEN,
          f"deepseek serve: {len(share['prefill'])} prefill and {len(share['decode'])} "
          f"decode moe calls recorded")
    check(all(((v >= 0) & (v < 1)).all() for v in share.values()),
          "deepseek serve: a dropped share outside [0, 1)")
    caps = {"prefill": MOE.capacity(cfg, MOE_B * MOE_PROMPT), "decode": MOE.capacity(cfg, MOE_B)}
    drop = {k: {"capacity": caps[k], "mean": float(v.mean()), "max": float(v.max())}
            for k, v in share.items()}
    print(f"[13] (b) served deepseek-moe-16b ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads at D={cfg.head_dim}, "
          f"{cfg.num_experts} experts top-{cfg.top_k} of d_ff {cfg.expert_d_ff} + "
          f"{cfg.shared_experts} shared, vocab {cfg.vocab_size}, {served['parameters']:,} "
          f"parameters, bf16, seed 0): {MOE_REQUESTS} requests, batch {MOE_B}, prompt "
          f"{MOE_PROMPT}, gen {MOE_GEN}; flash launches {launches} (by route {by_route}); "
          f"prefill {served['prefill_tok_s']} tok/s, decode {served['decode_tok_s']} tok/s "
          f"({batches - 1} timed batch after 1 warm-up); peak {peak_gib:.3f} GiB "
          f"(torch.cuda.max_memory_allocated); dropped share of the experts' slots at "
          f"prefill (capacity {caps['prefill']}) mean {drop['prefill']['mean']:.4f}, max "
          f"{drop['prefill']['max']:.4f} over {len(share['prefill'])} calls; at decode "
          f"(capacity {caps['decode']}) mean {drop['decode']['mean']:.4f}, max "
          f"{drop['decode']['max']:.4f} over {len(share['decode'])} calls; sample "
          f"{served['sample_output']}", flush=True)
    torch.cuda.empty_cache()

    # (c) float32 at full width, depth 4, capacity E/K (= T: no slot drops):
    # decode logits against a prefill one token longer; both dispatches on
    # one layer's input, at that capacity and at the reference's; no moe
    # call reads back to the host
    nodrop = cfg.num_experts / cfg.top_k
    cfg32 = dataclasses.replace(cfg, num_layers=MOE_F32_LAYERS, param_dtype="float32",
                                compute_dtype="float32", capacity_factor=nodrop)
    zero_lm_launches()
    with torch.inference_mode():
        model = CausalLM(cfg32, torch.Generator(device=dev).manual_seed(1))
        toks = torch.randint(0, cfg32.vocab_size, (2, MOE_PROMPT + 1), generator=gen,
                             device=dev)
        _, cache = model.prefill(toks[:, :MOE_PROMPT], MOE_PROMPT + 1)
        dec_logits, _ = model.decode_step(toks[:, MOE_PROMPT], cache, MOE_PROMPT)
        full_logits, _ = model.prefill(toks, MOE_PROMPT + 1)
        f32_by_route = dict(FA.flash_attention.launches_by_route)
        x = torch.randn((2, MOE_PROMPT + 1, cfg32.d_model), generator=gen, device=dev)
        layer = model.blocks[0].moe
        disp = {}
        for cf in (nodrop, cfg.capacity_factor, MOE_DROP_FACTOR):
            c = dataclasses.replace(cfg32, capacity_factor=cf)
            (a, aux), (b, _) = (MOE.moe(layer, c, x, mode=m) for m in ("scatter", "dense"))
            disp[cf] = {"max_abs_diff": float((a - b).abs().max()),
                        "dropped": float(aux["dropped"]), "capacity": MOE.capacity(c, x.shape[0] * x.shape[1])}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as syncs:
                warnings.simplefilter("always")
                for m in MOE.DISPATCHES:
                    for xs in (x, x[:, :1]):
                        MOE.moe(layer, cfg32, xs, mode=m)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    del model, cache, layer
    cons_err = float((dec_logits - full_logits).abs().max())
    cons_scale = float(full_logits.abs().max())
    check(bool(torch.isfinite(dec_logits).all()), "deepseek f32: non-finite logits")
    check(f32_by_route == {"tensor_cores": 0, "cuda_cores": 2 * MOE_F32_LAYERS},
          f"deepseek f32: flash launches by route {f32_by_route}")
    check(cons_err <= CONSISTENCY_ATOL,
          f"deepseek f32: max |decode - prefill(S+1)| {cons_err} > {CONSISTENCY_ATOL}")
    check(disp[nodrop]["dropped"] == 0.0 and disp[MOE_DROP_FACTOR]["dropped"] > 0,
          f"deepseek f32: dropped shares {disp}")
    check(all(d["max_abs_diff"] <= MOE_DISPATCH_ATOL for d in disp.values()),
          f"deepseek f32: scatter against dense {disp}")
    check(not syncs, "deepseek f32: a moe call synchronized with the host: "
          + "; ".join(str(w.message)[:200] for w in syncs[:3]))
    print(f"[13] (c) float32, full width, depth {MOE_F32_LAYERS}, capacity factor {nodrop} "
          f"(nothing drops): max |decode logits - prefill(S+1) logits| = {cons_err} "
          f"(largest |logit| {cons_scale}; atol {CONSISTENCY_ATOL}); flash launches by route "
          f"{f32_by_route}; scatter against dense on layer 0 at (2, {MOE_PROMPT + 1}): "
          + ", ".join(f"capacity factor {cf} (capacity {d['capacity']}, dropped "
                      f"{d['dropped']:.4f}) max |diff| {d['max_abs_diff']}"
                      for cf, d in disp.items())
          + f"; host syncs in 4 moe calls under torch.cuda.set_sync_debug_mode: {len(syncs)}",
          flush=True)
    torch.cuda.empty_cache()

    # (d) the other configs, a batch each after the warm-up batch
    others = {}
    for arch, layers in PHASE13_SERVED:
        c = get_config(arch)
        if layers:
            c = dataclasses.replace(c, num_layers=layers)
        torch.cuda.reset_peak_memory_stats()
        zero_lm_launches()
        outs, srv = SV.serve(serve_args(arch), c)
        fa, ssd = (dict(FA.flash_attention.launches_by_route),
                   dict(SSD.ssd_intra_chunk.launches_by_route))
        want = c.num_layers * batches
        if c.attn_active:
            check(fa == {"tensor_cores": want, "cuda_cores": 0} and sum(ssd.values()) == 0,
                  f"{arch} serve: flash {fa}, ssd {ssd}; expected {want} flash on tensor_cores")
        else:
            check(ssd == {**dict.fromkeys(SSD.ROUTES, 0), "tensor_cores_wide": want}
                  and sum(fa.values()) == 0,
                  f"{arch} serve: ssd {ssd}, flash {fa}; expected {want} SSD on "
                  f"tensor_cores_wide")
        check_served(f"{arch} serve", c, outs, srv)
        others[arch] = {"layers": c.num_layers, "of_layers": get_config(arch).num_layers,
                        "parameters": srv["parameters"],
                        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                        "flash_launches_by_route": fa, "ssd_launches_by_route": ssd,
                        **{k: srv[k] for k in ("prefill_tok_s", "decode_tok_s")}}
        print(f"[13] (d) served {arch} at {c.num_layers} of {get_config(arch).num_layers} "
              f"layers ({srv['parameters']:,} parameters, bf16, seed 0): prefill "
              f"{srv['prefill_tok_s']} tok/s, decode {srv['decode_tok_s']} tok/s; peak "
              f"{others[arch]['peak_mem_gib']:.3f} GiB; flash launches {fa}, SSD launches "
              f"{ssd}", flush=True)
        torch.cuda.empty_cache()

    # (e) the new configs trained whole through launch/train.py
    trained = {arch: train_whole(arch) for arch in PHASE13_TRAINED}
    phase_s = time.perf_counter() - t_phase
    print(f"[13] phase 13 took {phase_s:.1f} s", flush=True)
    return {"launches": launches, "launches_by_route": by_route, "errs": errs,
            "timed": timed, "ssd_err": ssd_err, "ssd_oracle_err": ssd_oracle_err,
            "ssd_ptxas": ssd_ptxas, "ssd_launches": others["mamba2-780m"]["ssd_launches_by_route"],
            "serve": {k: served[k] for k in ("prefill_tok_s", "decode_tok_s",
                                              "prefill_tok_s_per_batch",
                                              "decode_tok_s_per_batch", "sample_output",
                                              "parameters")}
            | {"peak_mem_gib": peak_gib, "dropped": drop},
            "consistency_f32_depth4": {"max_abs_err": cons_err, "max_abs_logit": cons_scale,
                                       "capacity_factor": nodrop,
                                       "launches_by_route": f32_by_route},
            "dispatch_f32": {str(cf): d for cf, d in disp.items()}, "host_syncs": len(syncs),
            "served": others, "trained": trained, "seconds": phase_s}


def train_whole(arch: str) -> dict:
    """13 (e): ``launch/train.py --arch arch`` at full width and depth,
    ``PHASE13_TRAIN_STEPS`` steps at B=4, S=512 (see the docstring)."""
    c = get_config(arch)
    layers = c.num_layers
    per_step, plain_calls = [], {"attention": 0, "ssd": 0}
    torch.cuda.empty_cache()
    zero_lm_launches()
    before_gib = torch.cuda.memory_allocated() / 2**30  # held by earlier phases
    _, hist, summary = train_cli(
        ["--arch", arch, "--steps", str(PHASE13_TRAIN_STEPS), "--batch", str(TRAIN_B),
         "--seq", str(TRAIN_S), "--log-every", "1"], per_step, plain_calls)
    by_route = dict(FA.flash_attention.launches_by_route)
    losses = [h["loss"] for h in hist]
    check(len(hist) == PHASE13_TRAIN_STEPS and all(np.isfinite(losses)),
          f"{arch} train: losses {losses}")
    check(all(h["skipped"] == 0 for h in hist), f"{arch} train: a step skipped")
    want_step = (2 * layers, 0, layers, 0)
    check(per_step == [want_step] * PHASE13_TRAIN_STEPS,
          f"{arch} train: per step (flash, ssd launches, plain attention, plain ssd "
          f"calls) {per_step}, expected {want_step} each")
    want = 2 * layers * PHASE13_TRAIN_STEPS
    check(by_route == {"tensor_cores": want, "cuda_cores": 0},
          f"{arch} train: flash launches by route {by_route}, expected {want} on tensor_cores")
    secs = [h["sec"] for h in hist[1:]]
    ms_step = 1e3 * float(np.median(secs))
    print(f"[13] (e) launch/train.py --arch {arch} ({layers} layers, d_model {c.d_model}, "
          f"{c.num_heads}/{c.num_kv_heads} heads at D={c.head_dim}, prefix {c.prefix_len}, "
          f"bf16, seed 0) --steps {PHASE13_TRAIN_STEPS} --batch {TRAIN_B} --seq {TRAIN_S}: "
          f"losses {[round(x, 4) for x in losses]}, none skipped; every step launched "
          f"flash {2 * layers} times (all tensor-core) and called the plain attention "
          f"{layers} times; {summary['tokens_per_s']:.1f} tok/s over the run, "
          f"{ms_step:.1f} ms a step (median of steps 2-{PHASE13_TRAIN_STEPS}), peak "
          f"{summary['peak_mem_gib']:.3f} GiB (torch.cuda.max_memory_allocated)", flush=True)
    torch.cuda.empty_cache()
    return {"layers": layers, "losses": losses, "tokens_per_s": summary["tokens_per_s"],
            "ms_per_step": ms_step, "sec_per_step": secs,
            "peak_mem_gib": summary["peak_mem_gib"], "memory_before_gib": before_gib,
            "launches_by_route": by_route}


@contextlib.contextmanager
def recording_moe():
    """Within it, every call of ``models.moe.moe`` that returns records its
    dropped share, and every routing its expert choices, under its layer (the id of the layer's
    parameters; a dict keeps the layers in the order of their first call):
    {id: {"dropped": [...], "idx": [...]}}, tensors left on the card. The
    model keeps no state, so the records come from wrappers on the
    module's functions, which read nothing back to the host."""
    from repro_torch.models import moe as MOE

    rec = {}
    moe_fn, routing_fn = MOE.moe, MOE.routing

    def layer(p):
        return rec.setdefault(id(p), {"dropped": [], "idx": []})

    def moe(p, c, x, **kw):
        out, aux = moe_fn(p, c, x, **kw)
        layer(p)["dropped"].append(aux["dropped"])
        return out, aux

    def routing(p, c, xf):
        idx, gates = routing_fn(p, c, xf)
        layer(p)["idx"].append(idx)
        return idx, gates

    MOE.moe, MOE.routing = moe, routing
    try:
        yield rec
    finally:
        MOE.moe, MOE.routing = moe_fn, routing_fn


def dropped_by_layer(rec) -> list:
    """[(mean, max) of the dropped share] of each moe layer's calls. A
    block's recompute in the backward pass stops once it has what the
    backward needs, before the share is taken: it records a forward's
    share only."""
    return [(float(torch.stack(r["dropped"]).float().mean()),
             float(torch.stack(r["dropped"]).float().max())) for r in rec.values()]


def moe_train_phase(dev) -> dict:
    """Phase 14: deepseek-moe-16b training at full width, depth 6 of 28
    (see the docstring)."""
    from repro_torch.models import moe as MOE

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    start_gib = torch.cuda.memory_allocated(dev) / 2**30
    print(f"[14] allocated on the card as the phase starts: {start_gib:.4f} GiB "
          f"(torch.cuda.memory_allocated; bar {PHASE14_START_GIB} GiB)", flush=True)
    check(start_gib < PHASE14_START_GIB,
          f"phase 14 starts with {start_gib:.3f} GiB of earlier phases on the card")
    full = get_config("deepseek-moe-16b")
    cfg = dataclasses.replace(full, num_layers=MOE_TRAIN_LAYERS)
    layers = cfg.num_layers
    check((cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (16, 16, 128)
          and FA.route(torch.bfloat16, cfg.head_dim) == "tensor_cores",
          f"deepseek-moe-16b's heads {cfg.num_heads}/{cfg.num_kv_heads} at D={cfg.head_dim}")
    gen = torch.Generator(device=dev).manual_seed(14)

    # (a) the backward Function at the layer's shape
    fn = check_flash_fn(gen, cfg, phase="14")
    torch.cuda.empty_cache()

    # (b) one warm step of the model the main path trains (seed 0, the
    # stream's first batch): gradients, launches, the recompute's routing
    state = TT.init_train_state(0, cfg, dev)
    params = state.params
    n_params = sum(p.numel() for p in params.values())
    stream = LMD.SyntheticLMStream(cfg.vocab_size, TRAIN_B, TRAIN_S)
    bt = TT.batch_tensors(stream.batch(0), dev)
    inputs = (bt["tokens"], bt["targets"], bt["mask"])
    zero_lm_launches()
    with recording_moe() as rec:
        loss = TLM.lm_loss(state.model, *inputs)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    warm_by_route = dict(FA.flash_attention.launches_by_route)
    check(bool(torch.isfinite(loss)), f"moe train: loss {float(loss.detach())}")
    missing = [n for n, g in zip(params, grads) if g is None]
    check(not missing, f"moe train: no gradient for {missing[:5]} ({len(missing)})")
    bad = [n for n, g in zip(params, grads) if not torch.isfinite(g).all()]
    check(not bad, f"moe train: non-finite gradients in {bad[:5]} ({len(bad)})")
    named = dict(zip(params, grads))
    watched = [f"blocks.{i}.{leaf}" for i in range(layers)
               for leaf in ("moe.router", "moe.wi", "moe.wo", "attn.wq")]
    zero = [n for n in watched if float(named[n].abs().max()) == 0.0]
    check(not zero, f"moe train: zero gradients in {zero}")
    check(warm_by_route == {"tensor_cores": 2 * layers, "cuda_cores": 0}
          and SSD.ssd_intra_chunk.launches == 0,
          f"moe train: flash launches by route {warm_by_route}, expected {2 * layers} "
          f"on tensor_cores (forward + recompute)")
    calls = list(rec.values())
    check(len(calls) == layers and all(len(c["idx"]) == 2 for c in calls),
          f"moe train: routing calls by layer {[len(c['idx']) for c in calls]}, expected 2 each")
    check(all(torch.equal(*c["idx"]) for c in calls),
          "moe train: the recompute routed otherwise than the forward")
    warm_dropped = [d for d, _ in dropped_by_layer(rec)]
    warm_loss = float(loss.detach())
    print(f"[14] (b) deepseek-moe-16b at full width, depth {layers} of {full.num_layers} "
          f"({n_params:,} parameters, bf16, float32 router, seed 0), B={TRAIN_B} "
          f"S={TRAIN_S}: loss {warm_loss:.4f}; all {len(params)} gradients present and "
          f"finite, moe.router, moe.wi, moe.wo and attn.wq non-zero in every block; flash "
          f"launches {warm_by_route} (forward + recompute); the recompute routed as the "
          f"forward in every layer; dropped share by layer "
          f"{[round(d, 4) for d in warm_dropped]}", flush=True)
    del loss, grads, named, rec, calls

    opt = TO.AdamWConfig(lr=1e-3, warmup=20)
    split = {}
    for i in range(3):
        loss, split["forward_ms"] = synced_ms(lambda: TLM.lm_loss(state.model, *inputs))
        grads, split["backward_ms"] = synced_ms(
            lambda: torch.autograd.grad(loss, list(params.values())))
        _, split["adamw_ms"] = synced_ms(lambda: TO.adamw_update(
            opt, dict(zip(params, grads)), state.mu, state.nu, params, i))
        del loss, grads
    step = TT.make_train_step(cfg, opt)
    state, _ = step(state, bt)  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as syncs:
            warnings.simplefilter("always")
            state, m = step(state, bt)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(int(m["skipped"]) == 0 and bool(torch.isfinite(m["loss"])),
          f"moe train: the watched step skipped or lost its loss {m}")
    check(not syncs, "moe train: a make_train_step call synchronized with the host: "
          + "; ".join(str(w.message)[:200] for w in syncs[:3]))
    state, prof_split = profiled_step(step, state, bt)
    print(f"[14] (b) a warm step's split, synchronized: forward + loss "
          f"{split['forward_ms']:.2f} ms, backward (recompute + VJPs) "
          f"{split['backward_ms']:.2f} ms, AdamW {split['adamw_ms']:.2f} ms over "
          f"{len(params)} leaves; host syncs in one make_train_step call under "
          f"torch.cuda.set_sync_debug_mode: {len(syncs)}", flush=True)
    print(f"[14] (b) one profiled step: wall {prof_split['wall_ms']:.2f} ms, device busy "
          f"{prof_split['device_busy_ms']:.2f} ms, idle {prof_split['idle_share']:.1%}; "
          f"flash_fwd_sm90 {prof_split['flash_fwd_sm90_ms']:.3f} ms "
          f"({prof_split['flash_records']} records of {2 * layers} launches), "
          f"{prof_split['launches']} device records in all; largest: " + "; ".join(
              f"{k} {ms:.2f} ms x{c}" for k, ms, c in prof_split["top"]), flush=True)
    del state, m, params, step
    torch.cuda.empty_cache()

    # (c) the main path: launch/train.py's train_lm on the depth cut
    per_step, plain_calls = [], {"attention": 0, "ssd": 0}
    argv = ["--arch", cfg.name, "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_B),
            "--seq", str(TRAIN_S), "--log-every", "1"]
    zero_lm_launches()
    before_gib = torch.cuda.memory_allocated(dev) / 2**30  # held by earlier phases
    with recording_moe() as rec:
        trained, hist, summary = train_cli(argv, per_step, plain_calls, cfg)
    launches = dict(FA.flash_attention.launches_by_route)
    del trained
    check(len(hist) == TRAIN_STEPS and all(np.isfinite(h["loss"]) for h in hist),
          f"moe train: losses {[h['loss'] for h in hist]}")
    check(all(h["skipped"] == 0 for h in hist),
          f"moe train: skipped {[h['skipped'] for h in hist]}")
    want_step = (2 * layers, 0, layers, 0)
    check(per_step == [want_step] * TRAIN_STEPS,
          f"moe train: per step (flash, ssd launches, plain attention, plain ssd calls) "
          f"{per_step}, expected {want_step} each")
    want = 2 * layers * TRAIN_STEPS
    check(launches == {"tensor_cores": want, "cuda_cores": 0},
          f"moe train: flash launches by route {launches}, expected {want} on tensor_cores")
    # the recompute routes again, but stops (checkpoint's early stop) once
    # it has what the backward needs, before the dropped share
    check(len(rec) == layers and all(len(r["idx"]) == 2 * TRAIN_STEPS
                                     and len(r["dropped"]) == TRAIN_STEPS for r in rec.values()),
          f"moe train: routing and moe calls by layer "
          f"{[(len(r['idx']), len(r['dropped'])) for r in rec.values()]}")
    dropped = dropped_by_layer(rec)
    cap = MOE.capacity(cfg, TRAIN_B * TRAIN_S)
    del rec
    secs = [h["sec"] for h in hist[1:]]
    ms_step = 1e3 * float(np.median(secs))
    card = nvidia_smi()
    print(f"[14] (c) launch/train.py train_lm, --arch {cfg.name} at depth {layers} of "
          f"{full.num_layers} (the config from the caller), --steps {TRAIN_STEPS} --batch "
          f"{TRAIN_B} --seq {TRAIN_S}: losses {[round(h['loss'], 4) for h in hist]}, none "
          f"skipped; every step launched flash {2 * layers} times (forward + recompute, "
          f"all tensor-core) and called the plain attention {layers} times (the "
          f"backward's VJPs); {summary['tokens_per_s']:.1f} tok/s over the run, "
          f"{ms_step:.1f} ms a step (median of steps 2-{TRAIN_STEPS}, spread "
          f"{min(secs) * 1e3:.1f}-{max(secs) * 1e3:.1f}), peak "
          f"{summary['peak_mem_gib']:.3f} GiB (torch.cuda.max_memory_allocated); dropped "
          f"share of the experts' slots (capacity {cap}) by layer, mean (max) over the "
          f"run's calls: " + ", ".join(f"{a:.4f} ({b:.4f})" for a, b in dropped)
          + f"; {card}", flush=True)
    torch.cuda.empty_cache()

    # (d) float32 at full width, depth 2, capacity factor 0.5 (slots drop):
    # both dispatches' gradients on the card
    cfg32 = dataclasses.replace(full, num_layers=MOE_GRAD_LAYERS, param_dtype="float32",
                                compute_dtype="float32", capacity_factor=MOE_DROP_FACTOR)
    model = CausalLM(cfg32, torch.Generator(device=dev).manual_seed(1)).requires_grad_(True)
    ps = dict(model.named_parameters())
    got = {}
    zero_lm_launches()
    with recording_moe() as rec:
        for mode in MOE.DISPATCHES:
            model.cfg = dataclasses.replace(cfg32, moe_dispatch=mode)
            loss = TLM.lm_loss(model, *inputs)
            got[mode] = (float(loss.detach()), torch.autograd.grad(loss, list(ps.values())))
            del loss
    f32_by_route = dict(FA.flash_attention.launches_by_route)
    f32_dropped = [a for a, _ in dropped_by_layer(rec)]
    del rec
    rel = dict(zip(ps, grad_rel_errs(got["scatter"][1], got["dense"][1])))
    worst = max(rel, key=rel.get)
    finite = all(bool(torch.isfinite(g).all()) for m in got.values() for g in m[1])
    del model, ps, got
    torch.cuda.empty_cache()
    check(finite, "moe train f32: a non-finite gradient")
    check(f32_by_route == {"tensor_cores": 0, "cuda_cores": 4 * MOE_GRAD_LAYERS},
          f"moe train f32: flash launches by route {f32_by_route}")
    check(min(f32_dropped) > 0, f"moe train f32: dropped shares {f32_dropped}")
    check(rel[worst] <= MOE_GRAD_REL,
          f"moe train f32: scatter against dense, {worst} {rel[worst]} of its max-abs")
    print(f"[14] (d) float32, full width, depth {MOE_GRAD_LAYERS}, capacity factor "
          f"{MOE_DROP_FACTOR} (dropped share by layer {[round(d, 4) for d in f32_dropped]}): "
          f"every gradient of the scatter dispatch within {rel[worst]:.3g} of its leaf's "
          f"max-abs from the dense dispatch's (largest at {worst}; bar {MOE_GRAD_REL})",
          flush=True)
    phase_s = time.perf_counter() - t_phase
    print(f"[14] phase 14 took {phase_s:.1f} s", flush=True)
    return {"fn": fn, "launches_by_route": launches, "train": {
        "arch": cfg.name, "layers": layers, "of_layers": full.num_layers,
        "parameters": n_params, "memory_at_start_gib": start_gib,
        "warm_loss": warm_loss, "losses": [h["loss"] for h in hist],
        "tokens_per_s": summary["tokens_per_s"], "ms_per_step": ms_step,
        "sec_per_step": secs, "peak_mem_gib": summary["peak_mem_gib"],
        "memory_before_gib": before_gib, "split": split,
        "profiled_step": prof_split, "host_syncs": len(syncs), "capacity": cap,
        "dropped_by_layer": dropped, "warm_dropped_by_layer": warm_dropped,
        "dispatch_f32": {"layers": MOE_GRAD_LAYERS, "capacity_factor": MOE_DROP_FACTOR,
                         "max_rel_err": rel[worst], "worst_leaf": worst,
                         "dropped_by_layer": f32_dropped},
        "card": card, "seconds": phase_s}}


def shard_argv() -> list[str]:
    """``launch/train.py``'s arguments for phase 15's main path (phase 3's)."""
    return ["--hdp", "pubmed", "--scale", "0.01", "--iters", str(SHARD_ITERS),
            "--topics", "1000", "--max-len", "256", "--bucket", "256",
            "--log-every", "1", "--seed", "0"]


def zero_hdp_z_launches() -> None:
    hdp_z_cuda.launches = 0
    hdp_z_cuda.launches_by_route.update(dict.fromkeys(HZ.ROUTES, 0))


def timed_iterations(sh, state, tokens, mask) -> dict:
    """Iterations on the state's own draws: one to warm up, then
    ``SHARD_TIMED_ITERS`` timed (the card synchronized around each), then
    one split by sub-step (``ShardedHDP.iteration``'s ``timings``)."""
    state = sh.iteration(state, tokens, mask)
    secs = []
    for _ in range(SHARD_TIMED_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = sh.iteration(state, tokens, mask)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    ms: dict = {}
    sh.iteration(state, tokens, mask, timings=ms)
    return {"timed_s": secs, "ms": ms}


def compact_twin(sh):
    """``sh``'s grid and config in table mode with compact (bf16/int16)
    tables: phase 15's second z-step."""
    return SH.ShardedHDP(sh.comm, sh.cfg._replace(alias_in_kernel="off"),
                         compact_tables=True)


def fed_result(sh, state) -> dict:
    """What (b) holds bitwise to world 1's: z, n, dh, l and Psi."""
    return {"z": state.z.cpu(), "n": state.n.cpu(), "dh": sh.last["dh"].cpu(),
            "l": state.l.cpu(), "psi": state.psi.cpu()}


def shard_world1(work: str) -> None:
    """Phase 15 (a), in a child process with torchrun's environment at world
    size 1: ``launch/train.py`` over NCCL, each iteration checked; after
    the last, one iteration on its own draws in prologue mode and one on
    compact tables, saved with the draws and the results to
    ``work/world1.pt`` for (b), then the timed iterations. Writes
    ``work/world1.json``."""
    work = Path(work)
    rec = {"iterations": []}

    def on_iteration(sh, state, tokens, mask):
        it, cfg = state.it, sh.cfg
        z, n = sh.gather_state(state)
        by_route = dict(hdp_z_cuda.launches_by_route)
        check(hdp_z_cuda.launches == it and by_route["lanes"] == it,
              f"15 (a) iteration {it}: launches {hdp_z_cuda.launches}, by route "
              f"{by_route}, expected {it} on lanes")
        check(torch.equal(n, H.count_n(z, tokens, mask, cfg.K, cfg.V)),
              f"15 (a) iteration {it}: n != count_n(z)")
        check(int(n.sum()) == int(mask.sum()), f"15 (a) iteration {it}: n.sum() != tokens")
        check(int(n[-1].sum()) == 0, f"15 (a) iteration {it}: flag topic holds tokens")
        check(abs(float(state.psi.sum()) - 1.0) < 1e-4,
              f"15 (a) iteration {it}: psi off the simplex")
        rec["iterations"].append({"it": it, "launches_by_route": by_route,
                                  "bytes": sh.last["bytes"]})
        rec["cfg"], rec["corpus_shape"] = cfg._asdict(), list(tokens.shape)
        if it < SHARD_ITERS:
            return
        varphi = sh.draw_varphi(state)
        u = sh.draw_uniforms(state, tokens.shape)
        nxt = sh.iteration(state, tokens, mask, varphi=varphi, u=u)
        want = {"prologue": fed_result(sh, nxt)}
        rec["fed_bytes"] = sh.last["bytes"]
        twin = compact_twin(sh)
        after = twin.iteration(state, tokens, mask, varphi=varphi, u=u)
        want["compact"] = fed_result(twin, after)
        rec["fed_bytes_compact"] = twin.last["bytes"]
        check(dict(hdp_z_cuda.launches_by_route) == {"lanes": it + 2, "warp": 0},
              f"15 (a): the fed iterations' sweeps {hdp_z_cuda.launches_by_route}")
        torch.save({
            "cfg": cfg._asdict(), "tokens": tokens.cpu(), "mask": mask.cpu(),
            "z": state.z.cpu(), "n": state.n.cpu(), "psi": state.psi.cpu(),
            "l": state.l.cpu(), "seed": state.seed, "it": state.it,
            "varphi": varphi.cpu(), "u": u.cpu(), "next": want}, work / "world1.pt")
        rec.update(timed_iterations(sh, nxt, tokens, mask))

    zero_hdp_z_launches()
    _, history, summary = T.train_hdp(T.build_parser().parse_args(shard_argv()),
                                      on_iteration=on_iteration)
    check(len(rec["iterations"]) == SHARD_ITERS, f"15 (a): {len(rec['iterations'])} iterations")
    rec.update(summary=summary, history=history,
               launches_by_route=dict(hdp_z_cuda.launches_by_route))
    (work / "world1.json").write_text(json.dumps(rec))


def shard_rank(work: str, rank: int, world: int, shape: tuple,
               backend: str = "gloo") -> None:
    """Phase 15 (b), one rank of ``world``: on gloo, every rank on the one
    card; on NCCL (a host with a card a rank), rank r on ``cuda:r``.
    (a)'s saved state and draws, sliced to the rank's documents and
    columns (documents padded with empty rows to a multiple of the
    ranks), one iteration in each of (a)'s two modes held bitwise to
    (a)'s, then the timed iterations. Writes
    ``work/rank{world}.{rank}.json``."""
    work = Path(work)
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    MESH.init_distributed(backend, dev, rank=rank, world_size=world,
                          init_method=f"file://{work / f'pg{world}'}",
                          local_rank=rank, local_world_size=world)
    try:
        w1 = torch.load(work / "world1.pt")
        grid = MESH.Grid(tuple(shape), MESH.AXES_2D, rank)
        cfg1 = H.HDPConfig(**w1["cfg"])
        m = grid.size("model")
        cfg = cfg1._replace(V=-(-cfg1.V // m) * m)  # as launch/train.py pads V
        sh = SH.ShardedHDP(Collectives(grid, backend, dev), cfg)
        d1 = w1["tokens"].shape[0]
        d = -(-d1 // world) * world

        def rows_of(t):  # documents padded with empty rows, the rank's block
            t = torch.cat([t, t.new_zeros((d - d1,) + tuple(t.shape[1:]))])
            return t[sh.doc_rows(d)].to(dev)

        def cols_of(t):  # words padded with absent ones (no tokens, no PPU
            # count), the rank's columns
            t = torch.cat([t, t.new_zeros((t.shape[0], cfg.V - cfg1.V))], 1)
            return t[:, sh.vocab_cols].contiguous().to(dev)

        tokens, mask = rows_of(w1["tokens"]), rows_of(w1["mask"])
        n = cols_of(w1["n"])
        state = SH.ShardState(z=rows_of(w1["z"]), n=n, phi=torch.zeros(n.shape, device=dev),
                              varphi=torch.zeros_like(n), psi=w1["psi"].to(dev),
                              l=w1["l"].to(dev), seed=w1["seed"], it=w1["it"])
        zero_hdp_z_launches()
        varphi, u = cols_of(w1["varphi"]), rows_of(w1["u"])
        after = {}
        for mode, s in (("prologue", sh), ("compact", compact_twin(sh))):
            tag = f"15 (b) {world} ranks, rank {rank}, {mode}"
            nxt = after[mode] = s.iteration(state, tokens, mask, varphi=varphi, u=u)
            want = w1["next"][mode]
            got = s.gather_state(nxt)
            if got is not None:
                z, n_all = (t.cpu() for t in got)
                check(torch.equal(z[:d1], want["z"]) and not z[d1:].any(),
                      f"{tag}: z differs from world 1's")
                check(torch.equal(n_all[:, :cfg1.V], want["n"])
                      and not n_all[:, cfg1.V:].any(), f"{tag}: n differs from world 1's")
            for name, a in (("dh", s.last["dh"]), ("l", nxt.l), ("psi", nxt.psi)):
                check(torch.equal(a.cpu(), want[name]),
                      f"{tag}: {name} differs from world 1's")
        by_route = dict(hdp_z_cuda.launches_by_route)
        check(by_route == {"lanes": 2, "warp": 0} and tokens.is_cuda,
              f"15 (b) {world} ranks, rank {rank}: sweep launches by route "
              f"{by_route}, expected 2 on lanes (prologue, compact tables)")
        rec = {"launches_by_route": by_route, "bytes": sh.last["bytes"],
               "docs": int(tokens.shape[0]), "cols": int(n.shape[1]), "V": cfg.V,
               **timed_iterations(sh, after["prologue"], tokens, mask)}
        (work / f"rank{world}.{rank}.json").write_text(json.dumps(rec))
    finally:
        torch.distributed.destroy_process_group()


def run_children(work: Path, name: str, calls: list[str], env: dict) -> None:
    """Run ``python -c call`` for each call at once (the ranks of one
    run), each logging to ``work/name.i.log``; fail with the log of the
    first that does not exit 0. Every child is stopped before it returns."""
    procs, logs = [], []
    try:
        for i, call in enumerate(calls):
            log = open(work / f"{name}.{i}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", f"import chip_smoke as C; {call}"],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + SHARD_CHILD_TIMEOUT_S
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                fail(f"{name}: still running after {SHARD_CHILD_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for i, p in enumerate(procs):
        if p.returncode != 0:
            text = (work / f"{name}.{i}.log").read_text()
            fail(f"{name} child {i} exited {p.returncode}:\n{text[-4000:]}")


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def sharded_phase(dev, phase3: dict, backend: str = "gloo") -> dict:
    """Phase 15, the data-parallel sampler; see the module docstring.
    ``backend="nccl"`` runs (b)'s ranks a card each, on a host with 4
    cards (not part of ``main``: the script needs one card)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_phase15_"))
    env = dict(os.environ, PYTHONPATH=str(SRC))
    try:
        # (a) world size 1 over NCCL, through launch/train.py
        run_children(work, "world1", [f"C.shard_world1({str(work)!r})"], dict(
            env, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port())))
        w1 = json.loads((work / "world1.json").read_text())
        summary = w1["summary"]
        check(summary["backend"] == "nccl" and summary["ranks"] == 1,
              f"15 (a): ran {summary['ranks']} rank(s) on {summary['backend']}")
        main_by_route = w1["iterations"][-1]["launches_by_route"]
        print(f"[15] (a) launch/train.py under torchrun's environment, world size 1, "
              f"NCCL, {summary['device']}: {SHARD_ITERS} iterations, n == count_n(z), "
              f"tokens, flag topic empty and psi on the simplex after each; hdp_z "
              f"launches by route {main_by_route}; {summary['tokens_per_s']} tok/s, "
              f"{summary['sec_per_iter']} s/iter (phase 3, one process: "
              f"{phase3['tokens_per_s']} tok/s, {phase3['sec_per_iter']} s/iter)",
              flush=True)
        for rec in w1["iterations"]:
            print(f"[15] (a) iteration {rec['it']} collective bytes a rank: "
                  f"{rec['bytes']}", flush=True)
        runs = {1: {"ms": w1["ms"], "bytes": w1["fed_bytes"], "timed_s": w1["timed_s"]}}

        # (b) 2 and 4 ranks on the one card over gloo, bitwise world 1
        for world, shape in SHARD_GRIDS:
            run_children(work, f"ranks{world}", [
                f"C.shard_rank({str(work)!r}, {r}, {world}, {tuple(shape)!r}, "
                f"{backend!r})" for r in range(world)], env)
            recs = [json.loads((work / f"rank{world}.{r}.json").read_text())
                    for r in range(world)]
            runs[world] = {
                "grid": dict(zip(MESH.AXES_2D, shape)), "backend": backend,
                "ms": {k: max(r["ms"][k] for r in recs) for k in recs[0]["ms"]},
                "bytes": recs[0]["bytes"],
                "timed_s": [max(r["timed_s"][i] for r in recs)
                            for i in range(SHARD_TIMED_ITERS)],
                "launches_by_route": [r["launches_by_route"] for r in recs],
                "docs_per_rank": recs[0]["docs"], "cols_per_rank": recs[0]["cols"],
                "V": recs[0]["V"]}
            where = ("gloo on the one card (host-staged collectives)" if backend == "gloo"
                     else "NCCL, a card a rank")
            print(f"[15] (b) {world} ranks, (data, model) = {tuple(shape)}, V = "
                  f"{runs[world]['V']}, {where}: one iteration on world 1's "
                  f"draws bitwise world 1's (z, n, dh, l, psi), in prologue mode and "
                  f"on compact tables; every rank's sweeps on the card, launches by "
                  f"route {runs[world]['launches_by_route']}",
                  flush=True)

        # (c) bytes, sub-step ms and s/iter by rank count
        for world, run in runs.items():
            run["s_per_iter"] = sum(run["timed_s"]) / len(run["timed_s"])
            print(f"[15] (c) {world} rank(s): {run['s_per_iter']:.4f} s/iter (the "
                  f"slowest rank's, mean of {SHARD_TIMED_ITERS} after a warm-up: "
                  f"{run['timed_s']}); wall ms by sub-step, one more iteration "
                  f"synchronized at each (the slowest rank's): {run['ms']}; "
                  f"collective bytes a rank: {run['bytes']}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    print(f"[15] phase 15 took {phase_s:.1f} s", flush=True)
    return {"launches": sum(main_by_route.values()), "launches_by_route": main_by_route,
            "launches_ranks": {w: r["launches_by_route"] for w, r in runs.items() if w > 1},
            "summary": summary, "runs": runs, "seconds": phase_s,
            # (a)'s config and each iteration's bytes a collective, for phase 17
            "world1": {"cfg": w1["cfg"], "corpus_shape": w1["corpus_shape"],
                       "iteration_bytes": [r["bytes"] for r in w1["iterations"]]}}


# ---- 16. the sharded LM trainer, the sampler's --ckpt, compression ------------------

def lm_argv(steps: int, *extra: str) -> list[str]:
    """``launch/train.py`` arguments of deepseek-moe-16b training at phase
    14's batch and sequence (the depth cut comes from the caller)."""
    return ["--arch", "deepseek-moe-16b", "--steps", str(steps), "--batch", str(TRAIN_B),
            "--seq", str(TRAIN_S), "--log-every", "1", *extra]


def hdp_argv(iters: int, *extra: str) -> list[str]:
    """Phase 3's main path for ``iters`` iterations."""
    return ["--hdp", "pubmed", "--scale", "0.01", "--iters", str(iters), "--topics",
            "1000", "--max-len", "256", "--bucket", "256", "--log-every", str(iters),
            "--seed", "0", *extra]


def hdp_state_fields(state) -> dict:
    return {f: getattr(state, f).cpu() for f in ("z", "n", "phi", "varphi", "psi", "l")}


def same_fields(a: dict, b: dict) -> list[str]:
    """The fields of two states that differ."""
    return [f for f in a if not torch.equal(a[f], b[f])]


def torchrun_env(rank: int, world: int, port: int, local_rank: int | None = None) -> dict:
    """The environment ``torchrun`` gives rank ``rank`` of ``world`` on one
    host (``MASTER_*`` on localhost)."""
    return dict(RANK=str(rank), WORLD_SIZE=str(world),
                LOCAL_RANK=str(rank if local_rank is None else local_rank),
                LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port))


def check_compressed_psum(comm, n: int, tag: str) -> dict:
    """``compressed_psum`` of a random (n,) float32 tensor over ``pod``: the
    mean against the sum of every pod's dequantized int8 (gathered in
    float32), the residual exactly x - deq, the wire's bytes 2 an element;
    both the compressed and a plain float32 psum timed by events."""
    from repro_torch.train import compression as COMP

    dev = comm.device
    gen = torch.Generator(device=dev).manual_seed(16 + comm.grid.rank)
    x = torch.randn((n,), generator=gen, device=dev)
    resid = torch.zeros_like(x)
    comm.sent.clear()
    mean, new_resid = COMP.compressed_psum(comm, x, "pod", resid)
    wire = comm.sent[COMP.BYTES_WIRE]
    amax = comm.pmax(x.abs().max().reshape(1), "pod")[0]
    scale = torch.clamp_min(amax, 1e-30) / 127.0
    q = COMP.quantize_int8(x, scale)
    deq = q.float() * scale
    pods = comm.grid.size("pod")
    total = comm.psum(q.to(torch.int32), "pod")  # the sum the wire must carry
    check(torch.equal(mean, total.float() * scale / pods),
          f"{tag}: the int64-lane sum differs from the int32 sum of q")
    check(torch.equal(new_resid, x - deq), f"{tag}: residual != x - deq")
    check(wire == 2 * n, f"{tag}: {wire} wire bytes for {n} elements")
    for _ in range(2):  # warm
        COMP.compressed_psum(comm, x, "pod", resid)
        comm.psum(x, "pod")
    if dev.type == "cuda":
        ms_c = cuda_time_ms(lambda: COMP.compressed_psum(comm, x, "pod", resid), 5)
        ms_p = cuda_time_ms(lambda: comm.psum(x, "pod"), 5)
    else:  # the dry run on the CPU
        ms_c = ms_p = None
    return {"elements": n, "pods": pods, "wire_bytes_a_rank": wire,
            "float32_bytes_a_rank": 4 * n, "ms": ms_c, "plain_float32_psum_ms": ms_p,
            "backend": comm.backend}


def resumed_chain(step, save, restore, fresh) -> list[str]:
    """``RESUME_ITERS`` iterations, a save, a restore and ``RESUME_ITERS``
    more, against ``2 * RESUME_ITERS`` uninterrupted from the same start:
    the state fields that differ. ``fresh()`` gives the start, ``step``
    an iteration, ``save``/``restore`` the checkpoint's round trip."""
    whole = fresh()
    for _ in range(2 * RESUME_ITERS):
        whole = step(whole)
    part = fresh()
    for _ in range(RESUME_ITERS):
        part = step(part)
    save(part)
    part = restore()
    for _ in range(RESUME_ITERS):
        part = step(part)
    differ = same_fields(hdp_state_fields(part), hdp_state_fields(whole))
    if getattr(whole, "gen", None) is not None and not torch.equal(
            part.gen.get_state(), whole.gen.get_state()):
        differ.append("gen")
    return differ + ([] if part.it == whole.it == 2 * RESUME_ITERS else ["it"])


def sharded_world1(work: str) -> None:
    """Phase 16 (a)-(c) in a child process with torchrun's environment at
    world size 1 over NCCL; writes ``work/world1.json``."""
    from repro_torch.core.collectives import Collectives as Comm
    from repro_torch.data.corpus import shard_balanced

    work = Path(work)
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), num_layers=MOE_TRAIN_LAYERS)
    rec = {}
    # (a) train_lm under torchrun at world 1
    zero_lm_launches()
    _, hist, summary = T.train_lm(T.build_parser().parse_args(lm_argv(SHARDED_LM_STEPS)), cfg)
    rec["lm"] = {"history": hist, "summary": summary,
                 "launches_by_route": dict(FA.flash_attention.launches_by_route)}
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    MESH.init_distributed("nccl", dev, rank=0, world_size=1,
                          init_method=f"tcp://127.0.0.1:{free_port()}")
    try:
        comm = Comm(MESH.Grid((1, 1, 1), MESH.AXES_3D, 0), "nccl", dev,
                    axis_sets=[("pod",)])
        # (b) the sharded sampler's checkpoint round trip at world 1
        corpus, hcfg = T.hdp_corpus_config(T.build_parser().parse_args(hdp_argv(1)))
        corpus = shard_balanced(corpus, 1)
        sh = SH.ShardedHDP(comm, hcfg)
        tokens = torch.from_numpy(corpus.tokens).to(dev)
        mask = torch.from_numpy(corpus.mask).to(dev)
        ck = str(work / "hdp_sharded")
        rec["hdp_differ"] = resumed_chain(
            lambda st: sh.iteration(st, tokens, mask), lambda st: sh.save(ck, st),
            lambda: sh.restore(ck, tokens.shape[1], doc_ranks=1),
            lambda: sh.init_state(0, tokens, mask))
        shutil.rmtree(ck, ignore_errors=True)
        # (c) compressed_psum over NCCL at world 1
        rec["compression"] = check_compressed_psum(comm, COMP_ELEMENTS, "16 (c)")
    finally:
        torch.distributed.destroy_process_group()
    (work / "world1.json").write_text(json.dumps(rec))


def sharded_lm_phase(dev, phase14_losses: list) -> dict:
    """Phase 16: the sharded LM trainer at world 1, the sampler's --ckpt
    without --stream, and compression over NCCL (see the docstring)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_phase16_"))
    env = dict(os.environ, PYTHONPATH=str(SRC))
    try:
        run_children(work, "world1", [f"C.sharded_world1({str(work)!r})"],
                     dict(env, **torchrun_env(0, 1, free_port())))
        w1 = json.loads((work / "world1.json").read_text())
        lm, summary = w1["lm"], w1["lm"]["summary"]
        losses = [h["loss"] for h in lm["history"]]
        check(summary["backend"] == "nccl" and summary["ranks"] == 1,
              f"16 (a): ran {summary['ranks']} rank(s) on {summary['backend']}")
        check(losses == phase14_losses[:SHARDED_LM_STEPS],
              f"16 (a): losses {losses} differ from phase 14's one-process "
              f"{phase14_losses[:SHARDED_LM_STEPS]}")
        want = 2 * MOE_TRAIN_LAYERS * SHARDED_LM_STEPS
        check(lm["launches_by_route"] == {"tensor_cores": want, "cuda_cores": 0},
              f"16 (a): flash launches {lm['launches_by_route']}, expected {want}")
        secs = [h["sec"] for h in lm["history"][1:]]
        ms_step = 1e3 * float(np.median(secs))
        print(f"[16] (a) launch/train.py train_lm under torchrun's environment, world "
              f"size 1, NCCL, deepseek-moe-16b depth {MOE_TRAIN_LAYERS}, B={TRAIN_B} "
              f"S={TRAIN_S}, {SHARDED_LM_STEPS} steps: losses {losses}, bitwise phase "
              f"14's one-process run; flash launches {lm['launches_by_route']}; "
              f"{summary['tokens_per_s']:.1f} tok/s, {ms_step:.1f} ms a step (median "
              f"of steps 2-{SHARDED_LM_STEPS}), peak {summary['peak_mem_gib']:.3f} GiB",
              flush=True)
        check(not w1["hdp_differ"],
              f"16 (b): sharded resume at world 1 differs in {w1['hdp_differ']}")
        # (b) the one-process sampler's checkpoint round trip
        _, hcfg, tokens, mask, _ = T.prepare_hdp(T.build_parser().parse_args(hdp_argv(1)))
        ck = str(work / "hdp")

        def fresh():
            return H.init_state(H.make_generator(0, dev), tokens, mask, hcfg)

        differ = resumed_chain(lambda st: H.gibbs_iteration(st, tokens, mask, hcfg),
                               lambda st: T.save_hdp(ck, st),
                               lambda: T.restore_hdp(ck, fresh()), fresh)
        check(not differ, f"16 (b): one-process resume differs in {differ}")
        print(f"[16] (b) the sampler's --ckpt round trip (launch/train.py's save_hdp "
              f"and restore_hdp; ShardedHDP.save and restore at world size 1 over "
              f"NCCL in the child) on phase 3's corpus (PubMed 0.01, K=1000, W=256): "
              f"{RESUME_ITERS} + {RESUME_ITERS} iterations bitwise {2 * RESUME_ITERS} "
              f"in one run (z, n, phi, varphi, psi, l; in one process the generator "
              f"too)", flush=True)
        comp = w1["compression"]
        print(f"[16] (c) compressed_psum at world 1 over NCCL, {comp['elements']:,} "
              f"float32: NCCL took the int64 lanes and the MAX; {comp['wire_bytes_a_rank']:,} "
              f"wire bytes a rank (float32: {comp['float32_bytes_a_rank']:,}); "
              f"{comp['ms']:.3f} ms (plain float32 psum {comp['plain_float32_psum_ms']:.3f} "
              f"ms; one rank: the reductions move nothing)", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    print(f"[16] phase 16 took {phase_s:.1f} s", flush=True)
    return {"launches_by_route": lm["launches_by_route"], "losses": losses,
            "tokens_per_s": summary["tokens_per_s"], "ms_per_step": ms_step,
            "peak_mem_gib": summary["peak_mem_gib"],
            "bytes_by_collective": summary["bytes_by_collective"],
            "compression_world1": comp, "seconds": phase_s}


# ---- the four-card run (not part of main: the script needs one card) ------------------

def four_card_rank(work: str, rank: int, spec: dict) -> None:
    """One rank of ``four_cards``: the runs of the docstring there, in
    order, on ``cuda:{rank}`` (or the CPU over gloo for a dry run).
    Writes ``work/rank{rank}.json``."""
    from repro_torch.train import sharding as SHD

    work = Path(work)
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = spec["device"] == "cpu"
    dev = torch.device("cpu") if cpu else torch.device("cuda", rank)
    backend = "gloo" if cpu else "nccl"
    world = spec["world"]
    full = get_config("deepseek-moe-16b", smoke=cpu)
    extra = ["--device", "cpu"] if cpu else []
    rec = {}

    def env_for(port):
        os.environ.update(torchrun_env(rank, world, port))

    def lm_run(name, layers, steps, *more):
        env_for(spec["ports"][name])
        cfg = dataclasses.replace(full, num_layers=layers)
        if not cpu:
            torch.cuda.empty_cache()
        zero_lm_launches()
        state, hist, s = T.train_lm(T.build_parser().parse_args(
            lm_argv(steps, *extra, *more)), cfg)
        rec[name] = {"history": hist, "summary": s, "layers": layers,
                     "flash_launches_by_route": dict(FA.flash_attention.launches_by_route)}
        return state

    lm_run("depth", spec["depth"], spec["steps"])
    lm_run("full", full.num_layers, spec["steps"])
    # a save on (2, 2) at logical shape, restored on (4, 1)
    ck = str(work / "ckpt")
    t0 = time.perf_counter()
    saved = lm_run("ckpt", spec["ckpt_layers"], 1, "--ckpt", ck, "--ckpt-every", "1")
    rec["ckpt"]["train_and_save_s"] = time.perf_counter() - t0
    grid22 = MESH.Grid((2, 2), MESH.AXES_2D, rank)
    mine = {g: {k: v.detach().clone() for k, v in getattr(saved, g).items()}
            for g in ("params", "mu", "nu")}
    del saved
    MESH.init_distributed(backend, dev, rank=rank, world_size=world,
                          init_method=f"file://{work / 'pg_restore'}",
                          local_rank=0 if cpu else rank, local_world_size=world)
    try:
        grid41 = MESH.Grid((4, 1), MESH.AXES_2D, rank)
        layout = SHD.Layout(dataclasses.replace(full, num_layers=spec["ckpt_layers"]),
                            SHD.make_comm(grid41, backend, dev))
        t0 = time.perf_counter()
        restored = SHD.restore_sharded(ck, layout, dev)
        rec["ckpt"]["restore_s"] = time.perf_counter() - t0
        differ = []
        for g in ("params", "mu", "nu"):
            for k, shard in getattr(restored, g).items():
                whole = layout.gather(k, shard.detach(), label=None)
                own = whole[MESH.shard_slices(whole.shape, SHD.param_specs(
                    layout.cfg, grid22)[k], grid22)]
                if not torch.equal(own, mine[g][k]):
                    differ.append(f"{g}/{k}")
        rec["ckpt"]["restored_on"] = [4, 1]
        rec["ckpt"]["differ"] = differ
        del restored, mine
        # compressed_psum on (pod, data, model) = (2, 1, 2)
        comm = Collectives(MESH.Grid((2, 1, 2), MESH.AXES_3D, rank), backend, dev,
                           axis_sets=[("pod",)])
        rec["compression"] = check_compressed_psum(comm, spec["comp_elements"],
                                                   f"four cards rank {rank}")
    finally:
        torch.distributed.destroy_process_group()
    (work / f"rank{rank}.json").write_text(json.dumps(rec))


def four_cards(device: str = "cuda") -> dict:
    """deepseek-moe-16b trained sharded on (data, model) = (2, 2), a card a
    rank over NCCL (run with four cards; ``device="cpu"`` is a dry run of
    the same code at smoke size on gloo):

      * depth 6, 3 steps, against the same run at world size 1 (a child
        on card 0): the losses within ``FOUR_CARD_LOSS_REL``;
      * the full depth, 28 layers, B=4 S=512, 3 steps: ms a step, tok/s,
        each card's peak memory (under 80 GB) and finite losses;
      * a save at logical shape on (2, 2) at depth ``FOUR_CARD_CKPT_LAYERS``,
        restored on (4, 1): every rank's (2, 2) shards of the parameters and
        moments bitwise what it held;
      * ``compressed_psum`` on (2, 1, 2) over NCCL, with its bytes a rank.

    Prints one JSON line and returns it."""
    t0 = time.perf_counter()
    cpu = device == "cpu"
    if not cpu:
        _build.build_all([*FA.SOURCES, *SSD.SOURCES])
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_four_cards_"))
    env = dict(os.environ, PYTHONPATH=str(SRC))
    depth = 1 if cpu else MOE_TRAIN_LAYERS
    try:
        spec = {"world": 4, "device": device, "depth": depth, "steps": SHARDED_LM_STEPS,
                "ckpt_layers": 1 if cpu else FOUR_CARD_CKPT_LAYERS,
                "comp_elements": 4096 if cpu else COMP_ELEMENTS,
                "ports": {k: free_port() for k in ("depth", "full", "ckpt")}}
        # the same depth at world size 1, on the first card
        one = ["--device", "cpu"] if cpu else []
        call = (f"import json, dataclasses; cfg = dataclasses.replace(C.get_config("
                f"'deepseek-moe-16b', smoke={cpu}), num_layers={depth}); "
                f"_, h, s = C.T.train_lm(C.T.build_parser().parse_args("
                f"C.lm_argv({SHARDED_LM_STEPS}, *{one!r})), cfg); "
                f"open({str(work / 'world1.json')!r}, 'w').write(json.dumps(s))")
        run_children(work, "world1", [call], dict(env, **torchrun_env(0, 1, free_port())))
        w1 = json.loads((work / "world1.json").read_text())
        (work / "spec.json").write_text(json.dumps(spec))
        run_children(work, "ranks", [
            f"C.four_card_rank({str(work)!r}, {r}, __import__('json').loads(open("
            f"{str(work / 'spec.json')!r}).read()))" for r in range(4)], env)
        recs = [json.loads((work / f"rank{r}.json").read_text()) for r in range(4)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    lead = recs[0]
    full_layers = lead["full"]["layers"]
    one_losses = [h["loss"] for h in w1["history"]]
    four_losses = [h["loss"] for h in lead["depth"]["history"]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(four_losses, one_losses))
    check(rel <= FOUR_CARD_LOSS_REL, f"four cards: depth {depth} losses {four_losses} "
          f"against world 1's {one_losses}: {rel}")
    fs = lead["full"]["summary"]
    peaks = fs["peak_mem_gib_by_rank"]
    check(all(np.isfinite(h["loss"]) and h["skipped"] == 0 for h in lead["full"]["history"]),
          f"four cards: full depth losses {lead['full']['history']}")
    check(cpu or max(peaks) * 2**30 < 80e9, f"four cards: peak memory {peaks} GiB")
    want = {"tensor_cores": 0 if cpu else 2 * full_layers * SHARDED_LM_STEPS,
            "cuda_cores": 0}
    got = [r["full"]["flash_launches_by_route"] for r in recs]
    check(cpu or all(g == want for g in got),
          f"four cards: full depth flash launches by rank {got}, expected {want}")
    differ = sorted({d for r in recs for d in r["ckpt"]["differ"]})
    check(not differ, f"four cards: restored on (4, 1), shards differ: {differ[:5]}")
    secs = [h["sec"] for h in lead["full"]["history"][1:]]
    depth_secs = [h["sec"] for h in lead["depth"]["history"][1:]]
    out = {
        "card": nvidia_smi() if not cpu else "cpu",
        "depth": {"layers": depth, "losses": four_losses, "world1_losses": one_losses,
                  "max_rel": rel, "ms_per_step": 1e3 * float(np.median(depth_secs)),
                  "world1_ms_per_step": 1e3 * float(np.median(
                      [h["sec"] for h in w1["history"][1:]])),
                  "summary": {k: lead["depth"]["summary"][k] for k in (
                      "tokens_per_s", "peak_mem_gib_by_rank", "grid",
                      "bytes_by_collective")}},
        "full": {"layers": lead["full"]["layers"],
                 "losses": [h["loss"] for h in lead["full"]["history"]],
                 "ms_per_step": 1e3 * float(np.median(secs)), "sec_per_step": secs,
                 "tokens_per_s": fs["tokens_per_s"], "peak_mem_gib_by_rank": peaks,
                 "flash_launches_by_route": [r["full"]["flash_launches_by_route"]
                                             for r in recs],
                 "grid": fs["grid"], "bytes_by_collective": fs["bytes_by_collective"]},
        "ckpt": {"layers": lead["ckpt"]["layers"], "saved_on": [2, 2],
                 "restored_on": lead["ckpt"]["restored_on"], "bitwise": not differ,
                 "train_1_step_and_save_s": lead["ckpt"]["train_and_save_s"],
                 "restore_s": max(r["ckpt"]["restore_s"] for r in recs)},
        "compression": [r["compression"] for r in recs]}
    out["dryrun"] = four_card_prediction(get_config("deepseek-moe-16b", smoke=cpu),
                                         fs["bytes_by_collective"], peaks)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return out


def four_card_prediction(cfg, measured_bytes: dict, peaks) -> dict:
    """The dry run's rank-0 trace of ``four_cards``' full-depth step on
    (2, 2) beside what the ranks measured: the bytes a collective over the
    run's steps must equal the trace's times the steps; the peak is
    printed beside each card's (and held within ``DRYRUN_PEAK_REL`` of the
    largest on the card; the CPU has no peak)."""
    from repro_torch.launch import dryrun as DR

    t0 = time.perf_counter()
    rec = DR.trace_lm(cfg, "train", MESH.Grid((2, 2), MESH.AXES_2D, 0), TRAIN_B, TRAIN_S)
    want = {k: v * SHARDED_LM_STEPS for k, v in rec["collectives"].items()}
    check(measured_bytes == want, f"four cards: bytes over {SHARDED_LM_STEPS} steps "
          f"{measured_bytes}, the dry run's {want}")
    pred = rec["memory"]["peak_bytes"] / 2**30
    print(f"[four cards] the dry run's trace of the full-depth step on (2, 2), rank 0 "
          f"({time.perf_counter() - t0:.1f} s on the host): bytes a step "
          f"{rec['collectives']}, equal to each rank's over {SHARDED_LM_STEPS} steps / "
          f"{SHARDED_LM_STEPS}; peak {pred:.3f} GiB against the cards' {peaks}", flush=True)
    if peaks is not None:
        rel = abs(pred - max(peaks)) / max(peaks)
        check(rel <= DRYRUN_PEAK_REL, f"four cards: predicted peak {pred} GiB, measured "
              f"{peaks}")
    return {"bytes_per_step": rec["collectives"], "predicted_peak_gib": pred,
            "measured_peak_gib_by_rank": peaks}


# ---- 17. the dry run against this run's measurements --------------------------------

# phase 17 (b): the configs whose train step the dry run predicts, each at
# the depth this run trains it (None: whole), and the phase that measures it
DRYRUN_TRAINED = (("deepseek-moe-16b", MOE_TRAIN_LAYERS, "14 (c)"),
                  ("hymba-1.5b", None, "11 (c)"), ("starcoder2-3b", None, "13 (e)"))


def dryrun_predictions(path: str) -> None:
    """Phase 17 (b)'s predictions, in a child process that sees no card:
    the dry run's traced train step of each ``DRYRUN_TRAINED`` config at
    world 1, B=4, S=512, on fake tensors. Writes JSON to ``path``."""
    from repro_torch.launch import dryrun as DR

    out = {}
    for arch, layers, _ in DRYRUN_TRAINED:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        t0 = time.perf_counter()
        rec = DR.trace_lm(cfg, "train", MESH.Grid((1, 1), MESH.AXES_2D, 0), TRAIN_B,
                          TRAIN_S + cfg.prefix_len)
        out[arch] = {"layers": cfg.num_layers, "peak_bytes": rec["memory"]["peak_bytes"],
                     "state_bytes": rec["memory"]["state_bytes"], "flops": rec["flops"],
                     "collectives": rec["collectives"],
                     "trace_s": time.perf_counter() - t0}
    Path(path).write_text(json.dumps(out))


def start_dryrun_predictions(work: Path) -> subprocess.Popen:
    """``dryrun_predictions`` in a child process on the host's CPU (no
    card visible to it), while the card runs the phases before 17."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    with open(work / "predictions.log", "w") as log:
        return subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke as C; "
             f"C.dryrun_predictions({str(work / 'predictions.json')!r})"],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)


def dryrun_phase(dev, child: subprocess.Popen, work: Path, world1: dict,
                 measured: dict) -> dict:
    """Phase 17 (see the docstring). ``world1`` is phase 15 (a)'s config
    and bytes, ``measured`` each ``DRYRUN_TRAINED`` config's peak GiB and
    the GiB the script's earlier phases held on the card as its training
    began (which the peak includes and the dry run does not)."""
    from repro_torch.configs.shapes import HDPCell
    from repro_torch.launch import dryrun as DR

    t_phase = time.perf_counter()
    # (a) one Gibbs iteration's bytes a collective at world 1
    cfg = world1["cfg"]
    d, length = world1["corpus_shape"]
    rec = DR.hdp_record(HDPCell("pubmed-0.01", V=cfg["V"], D=d, max_len=length, K=cfg["K"]),
                        MESH.Grid((1, 1), MESH.AXES_2D, 0), z_impl=cfg["z_impl"],
                        bucket=cfg["bucket"], device=dev)
    check(rec["config"] == cfg, f"17 (a): the dry run's config {rec['config']}, phase "
          f"15 (a)'s {cfg}")
    for i, got in enumerate(world1["iteration_bytes"]):
        check(got == rec["collectives"], f"17 (a): iteration {i + 1}'s bytes {got}, the "
              f"dry run's {rec['collectives']}")
    print(f"[17] (a) the dry run's bytes a collective of one Gibbs iteration at world 1 "
          f"(hdp_record: K={cfg['K']}, V={cfg['V']}, W={cfg['bucket']}, alias in the "
          f"kernel {rec['alias_in_kernel']}) equal ShardedHDP.last['bytes'] of each of "
          f"phase 15 (a)'s {len(world1['iteration_bytes'])} iterations, label by label: "
          f"{rec['collectives']}", flush=True)

    # (b) the traced peak of a train step against the card's
    try:
        child.wait(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    check(child.returncode == 0, f"17 (b): the dry run's child exited "
          f"{child.returncode}:\n{(work / 'predictions.log').read_text()[-4000:]}")
    preds = json.loads((work / "predictions.json").read_text())
    peaks = {}
    for arch, _, phase in DRYRUN_TRAINED:
        p = preds[arch]["peak_bytes"] / 2**30
        m, before = measured[arch]
        rel = abs(p - m) / m
        peaks[arch] = {"layers": preds[arch]["layers"], "predicted_gib": p,
                       "measured_gib": m, "rel": rel, "measured_in": phase,
                       "held_before_gib": before, "rel_beside_held": abs(p + before - m) / m,
                       "state_bytes": preds[arch]["state_bytes"],
                       "trace_s": preds[arch]["trace_s"]}
        print(f"[17] (b) {arch} at {preds[arch]['layers']} layers, world 1, B={TRAIN_B} "
              f"S={TRAIN_S}: the dry run's traced peak {p:.3f} GiB (state "
              f"{sum(preds[arch]['state_bytes'].values()) / 2**30:.3f} GiB, traced in "
              f"{preds[arch]['trace_s']:.1f} s on the host), phase {phase}'s "
              f"torch.cuda.max_memory_allocated {m:.3f} GiB: {rel:.2%} apart "
              f"(bar {DRYRUN_PEAK_REL:.0%}); the earlier phases held {before:.3f} GiB on "
              f"the card as that training began, and the prediction with them is "
              f"{peaks[arch]['rel_beside_held']:.2%} apart", flush=True)
        check(rel <= DRYRUN_PEAK_REL, f"17 (b) {arch}: predicted {p} GiB, measured {m} GiB")
    phase_s = time.perf_counter() - t_phase
    print(f"[17] phase 17 took {phase_s:.1f} s", flush=True)
    return {"hdp_bytes": rec["collectives"], "peaks": peaks, "seconds": phase_s}


def phases_1_to_13(dev) -> dict:
    """Phases 1-13. Returns the object of the kernels line, which holds
    plain numbers only: nothing of these phases stays on the card once
    it returns."""
    # ---- 1. environment and build -------------------------------------
    card = nvidia_smi()
    print(f"[1] card: {card}", flush=True)
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    sources = [*HZ.SOURCES, *FA.SOURCES, *SSD.SOURCES]
    paths = _build.build_all(sources)
    print(f"[1] built {', '.join(p.name for p in paths)} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc " + ", ".join(
              f"{src.name} {_build.BUILD_SECONDS.get(src.name, 0.0):.2f} s"
              for src in sources) + ")", flush=True)
    for src in (HZ.LANES_SOURCE, FA.SM90_SOURCE, SSD.SM90_SOURCE, SSD.WIDE_SOURCE):
        report = _build.ptxas_report(src)
        check("registers" in report, f"no ptxas report for {src.name}")
        for line in report.splitlines():
            if re.search(r"registers|spill|smem", line):
                print(f"[1] {src.stem} ptxas: {line.strip()}", flush=True)
    limit = HZ.smem_limit(dev)
    warps = HZ.lanes_warps(1000, True, limit)
    print(f"[1] hdp_z_lanes dynamic shared memory per block at K=1000, prologue "
          f"mode: {warps} warps, {HZ.lanes_smem_bytes(1000, True, warps)} B of the "
          f"card's {limit} B", flush=True)
    print("[1] flash_fwd_sm90 dynamic shared memory per CTA: " + ", ".join(
        f"D={d} {FA.sm90_smem_bytes(d)} B" for d in FA.TENSOR_CORE_HEAD_DIMS),
        flush=True)
    lm_cfg = get_config("hymba-1.5b")
    n_ssd = lm_cfg.ssm_state
    h_ssd = lm_cfg.ssm_expand * lm_cfg.d_model // lm_cfg.ssm_head_dim
    ssd_shape = (lm_cfg.ssd_chunk, n_ssd, lm_cfg.ssm_head_dim)
    ssd_smem = SSD._lib_sm90().ssd_chunk_sm90_smem_bytes(*ssd_shape)
    check(ssd_smem == SSD.sm90_smem_bytes(*ssd_shape),
          f"ssd_chunk_sm90 shared memory {ssd_smem} B, the wrapper counts "
          f"{SSD.sm90_smem_bytes(*ssd_shape)}")
    print(f"[1] ssd_chunk_sm90 at chunk {ssd_shape[0]}, N={n_ssd}, "
          f"P={lm_cfg.ssm_head_dim}: {ssd_smem} B of dynamic shared memory a CTA, "
          f"{SSD.sm90_ctas_per_sm(*ssd_shape)} CTAs an SM", flush=True)
    wide = mamba2_ssd_shape()
    wide_cnp = (wide[5], wide[4], wide[3])  # chunk, N, P
    wide_smem = SSD._lib_wide().ssd_chunk_sm90_wide_smem_bytes(*wide_cnp)
    check(wide_smem == SSD.wide_smem_bytes(*wide_cnp),
          f"ssd_chunk_sm90_wide shared memory {wide_smem} B, the wrapper counts "
          f"{SSD.wide_smem_bytes(*wide_cnp)}")
    print(f"[1] ssd_chunk_sm90_wide at mamba2-780m's chunk {wide[5]}, N={wide[4]}, "
          f"P={wide[3]}: {wide_smem} B of dynamic shared memory a CTA; plan at B={wide[0]} "
          f"S={wide[1]} H={wide[2]}: B and C shared {SSD.wide_plan(*wide, True)}, per "
          f"head {SSD.wide_plan(*wide, False)}", flush=True)

    # ---- 2. kernel against plain version, small shapes -----------------
    rng = np.random.default_rng(0)
    worst = 0
    t0 = time.perf_counter()
    for kk in KS:
        for w in WS:
            # L=23 at W=33: positions and rows read in scalars, not 16 bytes
            phi, psi, tokens, mask, z0, u = small_problem(rng, kk, w, dev,
                                                          l=23 if w == 33 else 24)
            for order in ("value", "topic"):
                worst = max(worst, compare_variants(
                    tokens, mask, z0, u, phi, psi, 0.3, min(w, kk), kk, order, "lanes"))
    phi, psi, tokens, mask, z0, u = small_problem(rng, WARP_ROUTE_K, WARP_ROUTE_W, dev)
    worst = max(worst, compare_variants(tokens, mask, z0, u, phi, psi, 0.3, WARP_ROUTE_W,
                                        WARP_ROUTE_K, "value", "warp"))
    print(f"[2] kernel == plain, bitwise, in 6 variants (float32, compact and "
          f"prologue, +- emit_delta) at {len(KS) * len(WS)} (K, W) shapes x 2 table "
          f"orders on the lanes route, and at K={WARP_ROUTE_K} W={WARP_ROUTE_W} on "
          f"the warp route ({time.perf_counter() - t0:.1f} s)", flush=True)

    # ---- 3. main path ----------------------------------------------------
    args = T.build_parser().parse_args([
        "--hdp", "pubmed", "--scale", "0.01", "--iters", "3",
        "--topics", "1000", "--max-len", "256", "--bucket", "256",
        "--log-every", "1", "--seed", "0",
    ])
    seen = {"count": 0}

    def on_iteration(state, tokens, mask, cfg):
        seen["count"] += 1
        it = seen["count"]
        check(hdp_z_cuda.launches == it,
              f"iteration {it}: kernel launches {hdp_z_cuda.launches}, expected {it}")
        check(hdp_z_cuda.launches_by_route["lanes"] == it,
              f"iteration {it}: launches by route {hdp_z_cuda.launches_by_route}, "
              f"expected {it} on lanes")
        check(torch.equal(state.n, H.count_n(state.z, tokens, mask, cfg.K, cfg.V)),
              f"iteration {it}: n != count_n(z)")
        check(int(state.n.sum()) == int(mask.sum()),
              f"iteration {it}: n.sum() != token count")
        check(abs(float(state.psi.sum()) - 1.0) < 1e-4,
              f"iteration {it}: psi off the simplex")
        check(int(H.flag_topic_tokens(state)) == 0,
              f"iteration {it}: flag topic holds tokens")
        seen.update(state=state, tokens=tokens, mask=mask, cfg=cfg)

    hdp_z_cuda.launches = 0
    hdp_z_cuda.launches_by_route.update(dict.fromkeys(HZ.ROUTES, 0))
    state, history, summary = T.train_hdp(args, on_iteration=on_iteration)
    main_launches = hdp_z_cuda.launches
    main_by_route = dict(hdp_z_cuda.launches_by_route)
    check(seen["count"] == 3 and main_launches == 3,
          f"main path: {seen['count']} iterations, {main_launches} launches")
    check(main_by_route == {"lanes": 3, "warp": 0},
          f"main path: launches by route {main_by_route}, expected 3 on lanes")
    active = int(H.active_topics(state))
    check(active > 1, f"main path: {active} active topics after 3 iterations")
    tokens, mask, cfg = seen["tokens"], seen["mask"], seen["cfg"]
    live = int(mask.sum())
    d, l = tokens.shape
    print(f"[3] main path: D={d} L={l} V={cfg.V} K={cfg.K} W={cfg.bucket} "
          f"tokens={live}; {summary['sec_per_iter']} s/iter, "
          f"{summary['tokens_per_s']} tok/s (Gibbs iterations alone, "
          f"iteration 1 included); log_lik {history[-1]['log_lik']}; "
          f"active topics {active}; kernel launches {main_launches} (by route "
          f"{main_by_route})", flush=True)

    # ---- 4. one sweep at the main shape: bitwise + timing ----------------
    # From the trained state (few topics, most tokens keep theirs), from
    # random topics (m spread, many tokens take the global branch), and
    # with a dense phi (every word's W slots live) and random topics.
    gen = H.make_generator(1, dev)
    u = torch.rand((d, l, 3), generator=gen, device=dev)
    z_rand = torch.where(mask, torch.randint(0, cfg.K, (d, l), generator=gen,
                                             device=dev, dtype=torch.int32), 0)
    phi, psi = state.phi, state.psi
    phi_dense = torch.rand((cfg.K, cfg.V), generator=gen, device=dev) + 0.01
    phi_dense /= phi_dense.sum(1, keepdim=True)
    apsi = torch.tensor(cfg.alpha, dtype=torch.float32, device=dev) * psi
    vals, ids = zops.build_word_sparse_supports(phi, cfg.bucket)
    q_a, fpack, ipack = zops.build_word_sparse_tables(phi, psi, cfg.alpha, cfg.bucket)
    q_c, fpack_c, ipack_c = zops.build_word_sparse_tables(phi, psi, cfg.alpha,
                                                          cfg.bucket, compact=True)
    vals_d, ids_d = zops.build_word_sparse_supports(phi_dense, cfg.bucket)
    w = vals.shape[1]
    tables = dict(q_a=q_a, fpack=fpack, ipack=ipack)
    compact = dict(q_a=q_c, fpack=fpack_c, ipack=ipack_c)
    supports = dict(apsi=apsi, vals=vals, ids=ids)
    dense = dict(apsi=apsi, vals=vals_d, ids=ids_d)
    check(bool((vals_d != 0).all()), "dense phi: a support slot is zero")
    timing = {}
    for label, in_kernel, z, args_k in (("prologue", True, state.z, supports),
                                        ("table", False, state.z, tables),
                                        ("table_compact", False, state.z, compact),
                                        ("prologue_random_z", True, z_rand, supports),
                                        ("dense_phi", True, z_rand, dense)):
        def kern():
            return hdp_z_cuda(tokens, mask, z, u, kk=cfg.K, emit_delta=True, **args_k)

        def earlier():
            return HZ._launch("warp", tokens, mask, z, u, kk=cfg.K, emit_delta=True,
                              **args_k)

        plain_fn = hdp_z_ref_prologue if in_kernel else hdp_z_ref
        before = dict(hdp_z_cuda.launches_by_route)
        got = kern()
        check(hdp_z_cuda.launches_by_route["lanes"] == before["lanes"] + 1,
              f"main shape {label}: not launched on the lanes route")
        got_warp = earlier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain_fn(tokens, mask, z, u, *args_k.values(), kk=cfg.K,
                        emit_delta=True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        for name, a, b, c in zip(("z", "m", "dn"), got, want, got_warp):
            err = max(max_int_err(a, b), max_int_err(c, b))
            worst = max(worst, err)
            check(torch.equal(a, b), f"main shape {label}: {name} differs (max {err})")
            check(torch.equal(c, b), f"main shape {label}: warp route's {name} differs")
        n_in = H.count_n(z, tokens, mask, cfg.K, cfg.V)
        check(torch.equal(n_in + got[2], H.count_n(got[0], tokens, mask, cfg.K, cfg.V)),
              f"main shape {label}: n + dn != count_n(z_new)")
        # the live slots of each word, and of each live token's word
        live_w = (HZ.live_slots(args_k["vals"], apsi, args_k["ids"]) if in_kernel
                  else HZ.live_slots(args_k["fpack"][:, 0].float())).to(torch.int64)
        live_t = live_w[tokens.to(torch.int64)][mask]
        # the first walk reads 4-slot pieces of values and of ids
        elem = 2 if label == "table_compact" else 4
        row_bytes = int(((live_t + 3) // 4).sum()) * 4 * 2 * elem
        ms = cuda_time_ms(kern, 5)
        earlier_ms = cuda_time_ms(earlier, 3)
        bound, by = sweep_bound_ms(d, l, cfg.K, cfg.V, w, tokens[mask].to(torch.int64),
                                   live_w, in_kernel, True, elem)
        changed = int((got[0] != z)[mask].sum())
        timing[label] = dict(
            ms=ms, earlier_ms=earlier_ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, changed_tokens=changed,
            live_slots_mean=float(live_t.float().mean()), live_slots_max=int(live_t.max()),
            row_bytes_first_walk=row_bytes, row_bytes_warp=live * w * 2 * elem)
        print(f"[4] sweep at main shape, {label}, emit_delta: kernel {ms:.3f} ms, "
              f"earlier (warp route) {earlier_ms:.3f} ms, plain {plain_ms:.1f} ms, "
              f"bound {bound:.4f} ms ({by}); live slots a token mean "
              f"{timing[label]['live_slots_mean']:.2f}, max "
              f"{timing[label]['live_slots_max']}; first walk reads {row_bytes} B of "
              f"rows (warp route {live * w * 2 * elem} B); changed tokens {changed} "
              f"of {live}",
              flush=True)

    # The whole z-step of one iteration in either mode: supports and
    # prologue sweep, or tables (sort, alias build, q_a) and table sweep.
    z_step_ms, z_step_out = {}, {}
    for mode in ("on", "off"):
        def z_step():
            return zops.z_step_cuda(tokens, mask, state.z, phi, psi, cfg.alpha, u,
                                    cfg.bucket, emit_delta=True, alias_in_kernel=mode)
        z_step_out[mode] = z_step()
        z_step_ms[mode] = cuda_time_ms(z_step, 3)
    for name, a, b in zip(("z", "m", "dn"), z_step_out["on"], z_step_out["off"]):
        check(torch.equal(a, b), f"z_step alias_in_kernel on/off: {name} differs")
    print(f"[4] z_step at main shape, emit_delta: alias in kernel "
          f"{z_step_ms['on']:.3f} ms, tables built first {z_step_ms['off']:.3f} ms; "
          f"bitwise equal", flush=True)

    # ---- 5. LM kernels against their plain versions ----------------------
    gen = torch.Generator(device=dev).manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    hq, hkv, hd, win = (lm_cfg.num_heads, lm_cfg.num_kv_heads, lm_cfg.head_dim,
                        lm_cfg.window)
    # the prefill shape; window 2048 > S, so SDPA's causal attention is
    # the same function
    fa_err, fa_sdpa_err = check_flash(gen, SERVE_B, hq, hkv, SERVE_S, hd, bf16,
                                      True, win, sdpa=True)
    fa_err = max([fa_err] + [check_flash(gen, *case)[0] for case in (
        (SERVE_B, hq, hkv, SERVE_S, hd, f32, True, win),
        (1, hq, hkv, 4096, hd, bf16, True, win),            # window bites
        (1, hq, hkv, 300, hd, bf16, True, win),             # ragged S < window
        (2, 8, 2, 300, hd, f32, True, 1000),
        (2, 4, 4, 300, 32, f32, False, None),               # non-causal, group 1
        (1, 4, 4, 256, 128, f32, True, 48),                 # group 1, D=128
        (2, 4, 2, 64, 16, f32, True, None),
        # the tensor-core route's edges
        (2, hq, hkv, 64, hd, bf16, True, None),             # one tile
        (2, 4, 2, 37, hd, bf16, True, None),                # S below one tile
        (2, 4, 2, 300, hd, bf16, False, None),              # non-causal
        (2, 4, 4, 300, hd, bf16, True, 100),                # group 1, window
        (1, 4, 4, 256, 128, bf16, True, 48),                # D=128, window
        (2, 8, 2, 200, 128, bf16, False, None),             # D=128, non-causal
        # bf16 below D=64 stays on the CUDA cores
        (2, 4, 2, 300, 32, bf16, True, 100),
        (1, 6, 3, 70, 16, bf16, False, None),
    )])
    p_ssd, cl_ssd = lm_cfg.ssm_head_dim, lm_cfg.ssd_chunk
    ssd_err = max(check_ssd(gen, *case[:6], **case[6]) for case in (
        (2, 1024, h_ssd, p_ssd, n_ssd, cl_ssd, {}),
        # the serving shape, B and C stride 0 and per head; model dt, A
        (SERVE_B, SERVE_S, h_ssd, p_ssd, n_ssd, cl_ssd, {}),
        (SERVE_B, SERVE_S, h_ssd, p_ssd, n_ssd, cl_ssd, {"shared": False}),
        (SERVE_B, SERVE_S, h_ssd, p_ssd, n_ssd, cl_ssd, {"model": True}),
        (2, cl_ssd, h_ssd, p_ssd, n_ssd, cl_ssd, {}),         # one chunk
        (2, SERVE_S, h_ssd, p_ssd, n_ssd, 64, {"model": True}),   # chunk 64
        (1, 200, 3, 24, 12, 40, {}),                          # odd shape
        (1, 100, 3, 10, 6, 20, {}),                           # CUDA-core route
        (1, 200, 3, 36, 44, 40, {"shared": False}),           # wide route
    ))
    check(SSD.route(*ssd_shape) == "tensor_cores" and SSD.route(20, 6, 10) == "cuda_cores"
          and SSD.route(40, 44, 36) == "tensor_cores_wide", "ssd: unexpected routes")

    # ---- 6. LM main path: hymba-1.5b serving at full width --------------
    serve_args = SV.build_parser().parse_args([
        "--arch", "hymba-1.5b", "--requests", "8", "--batch", str(SERVE_B),
        "--prompt-len", str(SERVE_S), "--gen", "32", "--seed", "0"])
    FA.flash_attention.launches = 0
    FA.flash_attention.launches_by_route.update(dict.fromkeys(FA.ROUTES, 0))
    SSD.ssd_intra_chunk.launches = 0
    SSD.ssd_intra_chunk.launches_by_route.update(dict.fromkeys(SSD.ROUTES, 0))
    outputs, served = SV.serve(serve_args)
    fa_launches = FA.flash_attention.launches
    fa_by_route = dict(FA.flash_attention.launches_by_route)
    ssd_launches = SSD.ssd_intra_chunk.launches
    ssd_by_route = dict(SSD.ssd_intra_chunk.launches_by_route)
    want_launches = lm_cfg.num_layers * 2  # layers x batches
    check(fa_launches == want_launches and ssd_launches == want_launches,
          f"serve: flash {fa_launches}, ssd {ssd_launches} launches, "
          f"expected {want_launches} each")
    check(fa_by_route["tensor_cores"] == want_launches,
          f"serve: flash launches by route {fa_by_route}, expected all "
          f"{want_launches} on tensor_cores")
    check(ssd_by_route == {**dict.fromkeys(SSD.ROUTES, 0), "tensor_cores": want_launches},
          f"serve: ssd launches by route {ssd_by_route}, expected all "
          f"{want_launches} on tensor_cores")
    check(served["logits_finite"], "serve: a logit is not finite")
    check(len(outputs) == 8 and all(len(o) == 32 for o in outputs),
          "serve: not 8 requests of 32 tokens")
    check(all(0 <= t < lm_cfg.vocab_size for o in outputs for t in o),
          "serve: a token outside the vocabulary")
    print(f"[6] served hymba-1.5b (32 layers, d_model 1600, bf16): 8 requests, "
          f"batch {SERVE_B}, prompt {SERVE_S}, gen 32; launches flash "
          f"{fa_launches} (by route {fa_by_route}), ssd {ssd_launches} (by route "
          f"{ssd_by_route})", flush=True)

    # The serving rates: one warm-up batch off the clock, then
    # RATE_BATCHES timed batches, each batch's rate listed.
    rate_args = SV.build_parser().parse_args([
        "--arch", "hymba-1.5b", "--requests", str(SERVE_B * (1 + RATE_BATCHES)),
        "--batch", str(SERVE_B), "--prompt-len", str(SERVE_S), "--gen", "32",
        "--seed", "0"])
    _, rates = SV.serve(rate_args)
    check(rates["logits_finite"], "serve rates: a logit is not finite")
    spread = {k: (max(v) - min(v)) / (sum(v) / len(v)) for k, v in (
        ("prefill", rates["prefill_tok_s_per_batch"]),
        ("decode", rates["decode_tok_s_per_batch"]))}
    print(f"[6] rates over {RATE_BATCHES} batches after 1 warm-up batch: prefill "
          f"{rates['prefill_tok_s']} tok/s (per batch {rates['prefill_tok_s_per_batch']}, "
          f"spread {spread['prefill']:.1%}), decode {rates['decode_tok_s']} tok/s "
          f"(per batch {rates['decode_tok_s_per_batch']}, spread "
          f"{spread['decode']:.1%})", flush=True)

    cfg32 = dataclasses.replace(lm_cfg, num_layers=4, param_dtype="float32",
                                compute_dtype="float32")
    with torch.inference_mode():
        model = CausalLM(cfg32, torch.Generator(device=dev).manual_seed(1))
        toks = torch.randint(0, cfg32.vocab_size, (2, SERVE_S + 1), generator=gen,
                             device=dev)
        _, cache = model.prefill(toks[:, :SERVE_S], SERVE_S + 1)
        dec_logits, _ = model.decode_step(toks[:, SERVE_S], cache, SERVE_S)
        full_logits, _ = model.prefill(toks, SERVE_S + 1)
    del model, cache
    cons_err = float((dec_logits - full_logits).abs().max())
    cons_scale = float(full_logits.abs().max())
    check(bool(torch.isfinite(dec_logits).all()), "consistency: non-finite logits")
    check(cons_err <= CONSISTENCY_ATOL,
          f"consistency: max |decode - prefill(S+1)| {cons_err} > {CONSISTENCY_ATOL}")
    print(f"[6] float32, full width, depth 4: max |decode logits - prefill(S+1) "
          f"logits| = {cons_err} (largest |logit| {cons_scale}; atol "
          f"{CONSISTENCY_ATOL})", flush=True)

    # ---- 7. LM kernels timed at the serving shape -----------------------
    q, k, v = flash_inputs(gen, SERVE_B, hq, hkv, SERVE_S, hd, bf16)
    fa_out = FA.flash_attention(q, k, v, causal=True, window=win)
    lib_out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             enable_gqa=True)
    # window 2048 > S = 512, so causal attention is the same function
    lib_err = float((fa_out.float() - lib_out.float()).abs().max())
    check(lib_err <= FLASH_ATOL[bf16], f"SDPA differs from the kernel by {lib_err}")
    # the CUDA-core kernel on the same bf16 inputs: the earlier design,
    # timed in this call (these launches are off the main path)
    core_out = FA._launch("cuda_cores", q, k, v, True, win)
    core_err = float((core_out.float() - fa_out.float()).abs().max())
    check(core_err <= FLASH_ATOL[bf16], f"the two flash kernels differ by {core_err}")
    # The kernel's and SDPA's host costs a call exceed their device
    # times, so back-to-back events time the host: ms, library_ms and
    # cuda_core_ms are device times (profiler), the event times beside.
    fa_fn = lambda: FA.flash_attention(q, k, v, causal=True, window=win)  # noqa: E731
    sdpa_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, enable_gqa=True)
    core_fn = lambda: FA._launch("cuda_cores", q, k, v, True, win)  # noqa: E731
    fa_t = dict(
        ms=device_time_ms(fa_fn, 50, per_call=1),
        plain_ms=cuda_time_ms(lambda: attention_ref(q, k, v, causal=True, window=win), 5),
        library_ms=device_time_ms(sdpa_fn, 50),
        host_ms=host_time_ms(fa_fn, 20),
        event_ms=cuda_time_ms(fa_fn, 20),
        library_event_ms=cuda_time_ms(sdpa_fn, 20),
        cuda_core_ms=device_time_ms(core_fn, 20, per_call=1),
        # the earlier design by events, the yardstick its time was
        # taken by before the tensor-core kernel took bf16 at D 64, 128
        earlier_ms=cuda_time_ms(core_fn, 20))
    fa_t["bound_ms"], fa_t["bound_by"] = flash_bound_ms(
        SERVE_B, hq, hkv, SERVE_S, hd, 2, True, win)
    print(f"[7] flash_attention B={SERVE_B} S={SERVE_S} {hq}/{hkv} heads D={hd} "
          f"bf16, device time: kernel {fa_t['ms']:.4f} ms, SDPA "
          f"{fa_t['library_ms']:.4f} ms (kernel / SDPA "
          f"{fa_t['ms'] / fa_t['library_ms']:.2f}), CUDA-core kernel "
          f"{fa_t['cuda_core_ms']:.4f} ms, bound {fa_t['bound_ms']:.4f} ms "
          f"({fa_t['bound_by']}); by events back to back: kernel "
          f"{fa_t['event_ms']:.4f} ms (host {fa_t['host_ms']:.4f} ms a call), "
          f"SDPA {fa_t['library_event_ms']:.4f} ms, CUDA-core kernel "
          f"{fa_t['earlier_ms']:.4f} ms, plain {fa_t['plain_ms']:.4f} ms",
          flush=True)

    cl = lm_cfg.ssd_chunk
    sargs = ssd_inputs(gen, SERVE_B, SERVE_S, h_ssd, p_ssd, n_ssd)
    margs = ssd_inputs(gen, SERVE_B, SERVE_S, h_ssd, p_ssd, n_ssd, model=True)
    for label, args_ in (("the serving shape", sargs), ("the model's dt and A", margs)):
        want = ssd_intra_chunk_ref(*args_, chunk=cl)
        got = SSD.ssd_intra_chunk(*args_, chunk=cl)
        # the CUDA-core kernel on the same inputs: the earlier design,
        # timed in this call (these launches are off the main path)
        core = SSD._launch("cuda_cores", *args_, cl)
        for name, a, c, w in zip(("y", "st", "dec"), got, core, want):
            e = float((a - w).abs().max())
            check(e <= SSD_ATOL, f"ssd at {label}: {name} max error {e}")
            e_core = float((c - w).abs().max())
            check(e_core <= SSD_ATOL, f"ssd_chunk.cu at {label}: {name} max error {e_core}")
            ssd_err = max(ssd_err, e)
    ssd_oracle_err = check_ssd_oracle("[7] ssd, the model's dt and A, serving shape",
                                      margs, cl)
    ssd_fn = lambda: SSD.ssd_intra_chunk(*sargs, chunk=cl)  # noqa: E731
    ssd_core_fn = lambda: SSD._launch("cuda_cores", *sargs, cl)  # noqa: E731
    # ms is the kernel's device time under the profiler: its host cost a
    # call may exceed it, as flash's does; the event times stand beside
    ssd_t = dict(
        ms=device_time_ms(ssd_fn, 50, per_call=1),
        event_ms=cuda_time_ms(ssd_fn, 20),
        plain_ms=cuda_time_ms(lambda: ssd_intra_chunk_ref(*sargs, chunk=cl), 5),
        library_ms=None,
        host_ms=host_time_ms(ssd_fn, 20),
        model_inputs_ms=device_time_ms(
            lambda: SSD.ssd_intra_chunk(*margs, chunk=cl), 50, per_call=1),
        model_inputs_event_ms=cuda_time_ms(
            lambda: SSD.ssd_intra_chunk(*margs, chunk=cl), 20),
        # the earlier design (ssd_chunk.cu) on the same inputs, by events
        # (the yardstick its 0.3280 ms was taken by) and device time
        earlier_ms=cuda_time_ms(ssd_core_fn, 20),
        earlier_device_ms=device_time_ms(ssd_core_fn, 20, per_call=1))
    ssd_t["device_time_ms"] = ssd_t["ms"]
    ssd_t["bound_ms"], ssd_t["bound_by"] = ssd_bound_ms(
        SERVE_B, SERVE_S, h_ssd, p_ssd, n_ssd, cl)
    print(f"[7] ssd_chunk_sm90 B={SERVE_B} S={SERVE_S} H={h_ssd} P={p_ssd} "
          f"N={n_ssd} chunk={cl} f32, device time: kernel {ssd_t['ms']:.4f} ms, "
          f"{ssd_t['model_inputs_ms']:.4f} ms on the model's dt and A, CUDA-core "
          f"kernel {ssd_t['earlier_device_ms']:.4f} ms, bound {ssd_t['bound_ms']:.5f} "
          f"ms ({ssd_t['bound_by']}; products at {TF32_PASSES} TF32 passes on the "
          f"tensor cores); by events back to back: kernel {ssd_t['event_ms']:.4f} "
          f"ms (host {ssd_t['host_ms']:.4f} ms a call), "
          f"{ssd_t['model_inputs_event_ms']:.4f} ms on the model's dt and A, "
          f"CUDA-core kernel {ssd_t['earlier_ms']:.4f} ms, plain "
          f"{ssd_t['plain_ms']:.4f} ms", flush=True)

    # ---- 8. the streamed main path ----------------------------------------
    corpus = Corpus(seen["tokens"].cpu().numpy(), seen["mask"].cpu().numpy(), cfg.V)
    del seen, state, phi_dense, vals_d, ids_d, z_rand, u
    torch.cuda.empty_cache()
    streamed = stream_phase(corpus, cfg, dev, seed=0)

    # ---- 9. HDP serving ------------------------------------------------------
    served = serve_phase(corpus, cfg, dev, seed=0)

    # ---- 10. the streamed trainer's sweep lanes ---------------------------------
    laned = lanes_phase(corpus, cfg, dev, 0, served.pop("snap"), served.pop("docs"),
                        served.pop("mixtures"))

    # ---- 11. hymba-1.5b training at full width ---------------------------------
    torch.cuda.empty_cache()
    trained = train_phase(dev, lm_cfg)

    # ---- 12. paligemma-3b serving, the flash kernels at D 192 and 256 --------
    torch.cuda.empty_cache()
    pali = paligemma_phase(dev)

    # ---- 13. deepseek-moe-16b serving, the other configs, D=128 and N=128 ----
    torch.cuda.empty_cache()
    moe = moe_phase(dev)

    main = timing["prologue"]
    return {"kernels": [{
        "name": "hdp_z", "route": "cuda",
        "source": "src/repro_torch/kernels/hdp_z/csrc/hdp_z_lanes.cu",
        "replaces": "src/repro/kernels/hdp_z/hdp_z.py:71",
        "launches": main_launches, "launches_by_route": main_by_route,
        # the streamed main path's sweeps (phase 8 (b))
        "launches_streamed": streamed["launches"],
        "launches_streamed_by_route": streamed["launches_by_route"],
        # the serving engine's sweeps (phase 9 (c))
        "launches_served": served["launches"],
        "launches_served_by_route": served["launches_by_route"],
        # the streamed trainer's 4 sweep lanes through launch/train.py (phase 10 (a))
        "launches_lanes": laned["launches"],
        "launches_lanes_by_route": laned["launches_by_route"],
        "max_abs_err": worst,
        "ms": main["ms"], "earlier_ms": main["earlier_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        # the earlier design, the warp route where the lanes one does not fit
        "warp_source": "src/repro_torch/kernels/hdp_z/csrc/hdp_z.cu",
        "live_slots_mean": main["live_slots_mean"], "live_slots_max": main["live_slots_max"],
        "other_inputs": {k: v for k, v in timing.items() if k != "prologue"},
        "z_step_ms": {"alias_in_kernel": z_step_ms["on"],
                      "tables_built_first": z_step_ms["off"]},
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:27",
        "launches": fa_launches, "launches_by_route": fa_by_route,
        "max_abs_err": fa_err, "sdpa_max_abs_err": fa_sdpa_err, **fa_t,
        # training (phase 11 (c)): launches over the CLI's steps, forward
        # and recompute, and the backward Function at the layer's shape
        "launches_train": trained["launches"]["flash"]["tensor_cores"],
        "launches_train_per_step": 2 * lm_cfg.num_layers,
        "train_backward": trained["fn"]["flash"],
        # float32, and bf16 at D in {16, 32}, stay on the CUDA cores
        "cuda_core_source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "shape": f"B={SERVE_B} S={SERVE_S} Hq={hq} Hkv={hkv} D={hd} bf16 causal window={win}",
    }, {
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd_chunk_sm90.cu",
        "replaces": "src/repro/kernels/ssd/ssd.py:31",
        "launches": ssd_launches, "launches_by_route": ssd_by_route,
        "max_abs_err": ssd_err, "oracle_max_abs_err": ssd_oracle_err, **ssd_t,
        "launches_train": trained["launches"]["ssd"]["tensor_cores"],
        "launches_train_per_step": 2 * lm_cfg.num_layers,
        "train_backward": trained["fn"]["ssd"],
        # the earlier design, the route of shapes the tensor-core one refuses
        "cuda_core_source": "src/repro_torch/kernels/ssd/csrc/ssd_chunk.cu",
        "shape": f"B={SERVE_B} S={SERVE_S} H={h_ssd} P={p_ssd} N={n_ssd} chunk={cl} f32",
    }, {
        # phase 12: the same kernels at paligemma-3b's head dim on its
        # main path, and at nemotron-4-340b's (192) off any path
        "name": "flash_attention_d256", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:27",
        "launches": pali["launches"], "launches_by_route": pali["launches_by_route"],
        "max_abs_err": pali["max_abs_err"], "max_abs_err_by_case": pali["errs"],
        **{k: pali["main"][k] for k in ("ms", "event_ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms", "library_event_ms",
                                         "shape")},
        "head_dims": pali["timed"],
        "cuda_core_source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    }, {
        # phase 13: the tensor-core kernel at D=128 on deepseek-moe-16b's
        # main path, and at the other attention configs' prefill shapes
        "name": "flash_attention_d128", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:27",
        "launches": moe["launches"], "launches_by_route": moe["launches_by_route"],
        "launches_other_configs": {a: o["flash_launches_by_route"]
                                   for a, o in moe["served"].items()},
        "max_abs_err": moe["errs"]["deepseek-moe-16b"], "max_abs_err_by_case": moe["errs"],
        **{k: moe["timed"]["flash"]["deepseek-moe-16b"][k] for k in (
            "ms", "event_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_event_ms", "shape")},
        "configs": moe["timed"]["flash"],
        # 13 (e): starcoder2-3b trained whole, forward and recompute
        "launches_train_starcoder2": moe["trained"]["starcoder2-3b"]["launches_by_route"],
    }, {
        # phase 13: the tensor-core kernel at D=64 on musicgen-medium's main
        # path (a 256-position prefix before the prompt), served and trained
        "name": "flash_attention_d64", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:27",
        "launches": sum(moe["served"]["musicgen-medium"]["flash_launches_by_route"].values()),
        "launches_by_route": moe["served"]["musicgen-medium"]["flash_launches_by_route"],
        "launches_train": moe["trained"]["musicgen-medium"]["launches_by_route"]["tensor_cores"],
        "launches_train_by_route": moe["trained"]["musicgen-medium"]["launches_by_route"],
        "max_abs_err": moe["errs"]["musicgen-medium"],
        **{k: moe["timed"]["flash"]["musicgen-medium"][k] for k in (
            "ms", "event_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_event_ms", "shape")},
    }, {
        # phase 13: the wide tensor-core SSD kernel at mamba2-780m's state
        # (N=128) on its main path; the CUDA-core kernel, the earlier
        # design there, timed beside it in the same child
        "name": "ssd_chunk_n128", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd_chunk_sm90_wide.cu",
        "replaces": "src/repro/kernels/ssd/ssd.py:31",
        "launches": sum(moe["ssd_launches"].values()), "launches_by_route": moe["ssd_launches"],
        "max_abs_err": moe["ssd_err"], "oracle_max_abs_err": moe["ssd_oracle_err"],
        **{k: moe["timed"]["ssd"][k] for k in (
            "ms", "event_ms", "earlier_ms", "earlier_event_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "shape")},
        "earlier_source": "src/repro_torch/kernels/ssd/csrc/ssd_chunk.cu",
        "ptxas": moe["ssd_ptxas"]["ssd_chunk_sm90_wide"],
        "earlier_ptxas": moe["ssd_ptxas"]["ssd_chunk"],
    }], "serve": {**{k: rates[k] for k in (
        "prefill_tok_s", "decode_tok_s", "prefill_tok_s_per_batch",
        "decode_tok_s_per_batch", "warmup_batches")},
        "spread": spread},
        "consistency_f32_depth4": {"max_abs_err": cons_err, "max_abs_logit": cons_scale},
        "stream_tiled": streamed["tiled"], "serve_hdp": served["serve_hdp"],
        "train": trained["train"],
        "paligemma": {k: pali[k] for k in ("serve", "consistency_f32_depth4", "topic_lm",
                                           "seconds")},
        "deepseek_moe": {k: moe[k] for k in ("serve", "consistency_f32_depth4",
                                             "dispatch_f32", "host_syncs", "seconds")},
        "served_phase13": moe["served"], "trained_phase13": moe["trained"],
        "hdp_main": {k: summary[k] for k in ("tokens_per_s", "sec_per_iter")},
        "stream_lanes": {k: laned[k] for k in (
            "sec_per_iter", "delta_reduce_mb_per_iter", "block_exchange", "metrics",
            "tiled_threads")}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = phases_1_to_13(dev)
    work17 = Path(tempfile.mkdtemp(prefix="chip_smoke_phase17_"))
    predictions = start_dryrun_predictions(work17)
    try:
        phases_14_to_17(dev, out, predictions, work17)
    finally:
        if predictions.poll() is None:
            predictions.kill()
            predictions.wait()
        shutil.rmtree(work17, ignore_errors=True)
    print(json.dumps(out), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phases_14_to_17(dev, out: dict, predictions: subprocess.Popen, work17: Path) -> None:
    """Phases 14-17, adding their numbers to ``out``, the kernels line's
    object."""
    # ---- 14. deepseek-moe-16b training at full width, depth 6 -------------------
    moe_train = moe_train_phase(dev)
    d128 = next(k for k in out["kernels"] if k["name"] == "flash_attention_d128")
    d128.update({
        # training (phase 14 (c)): launches over train_lm's steps, forward
        # and recompute, and the backward Function at the layer's shape
        "launches_train": moe_train["launches_by_route"]["tensor_cores"],
        "launches_train_by_route": moe_train["launches_by_route"],
        "launches_train_per_step": 2 * MOE_TRAIN_LAYERS,
        "train_backward": moe_train["fn"]})
    out["deepseek_moe_train"] = moe_train["train"]

    # ---- 15. the data-parallel sampler ---------------------------------------------
    sharded = sharded_phase(dev, out["hdp_main"])
    hdp_z = next(k for k in out["kernels"] if k["name"] == "hdp_z")
    hdp_z.update({
        # the sharded main path through launch/train.py at world size 1
        # (phase 15 (a)), and each rank's sweep at 2 and 4 ranks (15 (b))
        "launches_sharded": sharded["launches"],
        "launches_sharded_by_route": sharded["launches_by_route"],
        "launches_sharded_ranks": sharded["launches_ranks"]})
    out["sharded"] = {k: sharded[k] for k in ("summary", "runs", "seconds")}

    # ---- 16. the sharded LM trainer, --ckpt without --stream, compression ---------
    sharded_lm = sharded_lm_phase(dev, out["deepseek_moe_train"]["losses"])
    d128.update({
        # launch/train.py's train_lm under torchrun at world size 1 (16 (a))
        "launches_sharded_train": sharded_lm["launches_by_route"]["tensor_cores"],
        "launches_sharded_train_by_route": sharded_lm["launches_by_route"]})
    out["sharded_lm"] = {k: v for k, v in sharded_lm.items() if k != "launches_by_route"}

    # ---- 17. the dry run against this run's measurements ---------------------------
    out["dryrun"] = dryrun_phase(dev, predictions, work17, sharded["world1"], {
        arch: (run["peak_mem_gib"], run["memory_before_gib"]) for arch, run in (
            ("deepseek-moe-16b", moe_train["train"]), ("hymba-1.5b", out["train"]),
            ("starcoder2-3b", out["trained_phase13"]["starcoder2-3b"]))})


if __name__ == "__main__":
    sys.exit(main())
