#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, none wrapped in a ``try``; any failure exits non-zero:
  1. environment: the card (nvidia-smi), torch and CUDA versions, and the
     hdp_z kernel built from ``src/repro_torch/kernels/hdp_z/csrc``;
  2. kernel against plain version on the card: every variant of
     emit_delta x prologue (in-kernel alias) mode at K in {2, 3, 257,
     1000} and W in {8, 33, 64, 256}, odd D, ragged masked padding and
     words with zero mass; z, m and dn must be bitwise equal and
     n + dn == count_n(z_new);
  3. main path: ``repro_torch.launch.train`` takes 3 Gibbs iterations
     on the synthetic PubMed replica at --scale 0.01 (81,999 documents,
     K=1000, W=256, alias built in the kernel); after every iteration
     n == count_n(z), n.sum() == tokens, |sum(psi) - 1| < 1e-4, the
     flag topic is empty and the kernel's launch count rose by 1;
  4. one sweep at the main path's shape from the trained state: kernel
     against plain version (bitwise), both timed with CUDA events, with
     the bound the card's memory rate and float32 rate set; then the
     whole z-step (table or support build plus sweep) with the alias
     built in the kernel and with tables built first, bitwise equal and
     both timed.
The last lines are the ``kernels`` JSON, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
sys.path.insert(0, str(SRC))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Without the repository's sources beside this script, these fail and
# the script exits non-zero before any phase.
from repro_torch.core import hdp as H  # noqa: E402
from repro_torch.core.polya_urn import ppu_sample  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.hdp_z import hdp_z as HZ  # noqa: E402
from repro_torch.kernels.hdp_z import ops as zops  # noqa: E402
from repro_torch.kernels.hdp_z.hdp_z import hdp_z_cuda  # noqa: E402
from repro_torch.kernels.hdp_z.ref import (  # noqa: E402
    hdp_z_ref, hdp_z_ref_prologue)
from repro_torch.launch import train as T  # noqa: E402

# H100 SXM data sheet: HBM3 bandwidth and float32 (non-tensor) peak.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

KS = (2, 3, 257, 1000)
WS = (8, 33, 64, 256)


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
    ragged documents with masked padding, random z and uniforms."""
    n = torch.from_numpy(rng.poisson(0.8, size=(k, v)).astype(np.int32)).to(device)
    gen = H.make_generator(int(rng.integers(1 << 30)), device)
    phi, _ = ppu_sample(gen, n, 0.01)
    zero_words = rng.choice(v, size=3, replace=False)
    phi[:, torch.from_numpy(zero_words).to(device)] = 0.0
    psi = torch.from_numpy(rng.dirichlet(np.ones(k)).astype(np.float32)).to(device)
    tok = rng.integers(0, v, (d, l)).astype(np.int32)
    tok[:, :3] = zero_words  # every document meets the zero-mass words
    lens = rng.integers(0, l + 1, d)
    msk = (np.arange(l)[None, :] < lens[:, None]) & (rng.random((d, l)) > 0.1)
    z0 = rng.integers(0, k, (d, l)).astype(np.int32)
    u = rng.random((d, l, 3)).astype(np.float32)
    to = lambda x: torch.from_numpy(x).to(device)
    return phi, psi, to(tok), to(msk), to(z0), to(u)


def compare_variants(tokens, mask, z0, u, phi, psi, alpha, w, kk):
    """Kernel against plain version in all four emit_delta x prologue
    variants on the same inputs; returns the largest integer error."""
    vv = phi.shape[1]
    n0 = H.count_n(z0, tokens, mask, kk, vv)
    q_a, fpack, ipack = zops.build_word_sparse_tables(phi, psi, alpha, w)
    vals, ids = zops.build_word_sparse_supports(phi, w)
    apsi = torch.tensor(alpha, dtype=torch.float32, device=psi.device) * psi
    worst = 0
    for in_kernel in (False, True):
        for emit in (False, True):
            before = hdp_z_cuda.launches
            if in_kernel:
                got = hdp_z_cuda(tokens, mask, z0, u, kk=kk, apsi=apsi,
                                 vals=vals, ids=ids, emit_delta=emit)
                want = hdp_z_ref_prologue(tokens, mask, z0, u, apsi, vals,
                                          ids, kk=kk, emit_delta=emit)
            else:
                got = hdp_z_cuda(tokens, mask, z0, u, kk=kk, q_a=q_a,
                                 fpack=fpack, ipack=ipack, emit_delta=emit)
                want = hdp_z_ref(tokens, mask, z0, u, q_a, fpack, ipack,
                                 kk=kk, emit_delta=emit)
            torch.cuda.synchronize()
            tag = f"K={kk} W={w} in_kernel={in_kernel} emit_delta={emit}"
            check(hdp_z_cuda.launches == before + 1, f"{tag}: no launch")
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


def sweep_bound_ms(d, l, kk, vv, w, live, in_kernel, emit):
    """Least time for one sweep: each byte the sweep needs read once and
    each output byte written once over the memory rate, against the
    float32 work every live token needs whichever branch it takes over
    the float32 rate.

    Bytes: mask, z in and z out over all D*L positions (padding keeps its
    z); tokens and uniforms only at the ``live`` positions; m (D, K); the
    supports and apsi, or the tables and q_a, over their full shapes; dn
    (K, V) with emit. Operations per live token: W products and W prefix
    adds for term (b); prologue mode also W products and W adds for wa
    and q_a."""
    nbytes = d * l * (1 + 4 + 4) + live * (4 + 12) + d * kk * 4
    nbytes += (vv * w * 8 + kk * 4) if in_kernel else (vv * 4 + vv * w * 16)
    nbytes += kk * vv * 4 if emit else 0
    ops = live * w * (4 if in_kernel else 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 1. environment and build -------------------------------------
    card = nvidia_smi()
    print(f"[1] card: {card}", flush=True)
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    lib_path = _build.build(HZ.SOURCE)
    print(f"[1] built {lib_path.name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.BUILD_SECONDS.get(HZ.SOURCE.name, 0.0):.2f} s)",
          flush=True)

    # ---- 2. kernel against plain version, small shapes -----------------
    rng = np.random.default_rng(0)
    worst = 0
    t0 = time.perf_counter()
    for kk in KS:
        for w in WS:
            phi, psi, tokens, mask, z0, u = small_problem(rng, kk, w, dev)
            worst = max(worst, compare_variants(
                tokens, mask, z0, u, phi, psi, 0.3, min(w, kk), kk))
    print(f"[2] kernel == plain, bitwise, in 4 variants at {len(KS) * len(WS)} "
          f"(K, W) shapes ({time.perf_counter() - t0:.1f} s)", flush=True)

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
    state, history, summary = T.train_hdp(args, on_iteration=on_iteration)
    main_launches = hdp_z_cuda.launches
    check(seen["count"] == 3 and main_launches == 3,
          f"main path: {seen['count']} iterations, {main_launches} launches")
    active = int(H.active_topics(state))
    check(active > 1, f"main path: {active} active topics after 3 iterations")
    tokens, mask, cfg = seen["tokens"], seen["mask"], seen["cfg"]
    live = int(mask.sum())
    d, l = tokens.shape
    print(f"[3] main path: D={d} L={l} V={cfg.V} K={cfg.K} W={cfg.bucket} "
          f"tokens={live}; {summary['sec_per_iter']} s/iter, "
          f"{summary['tokens_per_s']} tok/s (Gibbs iterations alone, "
          f"iteration 1 included); log_lik {history[-1]['log_lik']}; "
          f"active topics {active}; kernel launches {main_launches}",
          flush=True)

    # ---- 4. one sweep at the main shape: bitwise + timing ----------------
    # From the trained state (few topics, most tokens keep theirs), and
    # from random topics (m spread, many tokens take the global branch).
    gen = H.make_generator(1, dev)
    u = torch.rand((d, l, 3), generator=gen, device=dev)
    z_rand = torch.where(mask, torch.randint(0, cfg.K, (d, l), generator=gen,
                                             device=dev, dtype=torch.int32), 0)
    phi, psi = state.phi, state.psi
    apsi = torch.tensor(cfg.alpha, dtype=torch.float32, device=dev) * psi
    vals, ids = zops.build_word_sparse_supports(phi, cfg.bucket)
    q_a, fpack, ipack = zops.build_word_sparse_tables(phi, psi, cfg.alpha, cfg.bucket)
    w = vals.shape[1]
    tables = dict(q_a=q_a, fpack=fpack, ipack=ipack)
    supports = dict(apsi=apsi, vals=vals, ids=ids)
    timing = {}
    for label, in_kernel, z in (("prologue", True, state.z),
                                ("table", False, state.z),
                                ("prologue_random_z", True, z_rand)):
        args_k = supports if in_kernel else tables

        def kern():
            return hdp_z_cuda(tokens, mask, z, u, kk=cfg.K, emit_delta=True, **args_k)

        plain_fn = hdp_z_ref_prologue if in_kernel else hdp_z_ref
        got = kern()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain_fn(tokens, mask, z, u, *args_k.values(), kk=cfg.K,
                        emit_delta=True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        for name, a, b in zip(("z", "m", "dn"), got, want):
            err = max_int_err(a, b)
            worst = max(worst, err)
            check(torch.equal(a, b), f"main shape {label}: {name} differs (max {err})")
        n_in = H.count_n(z, tokens, mask, cfg.K, cfg.V)
        check(torch.equal(n_in + got[2], H.count_n(got[0], tokens, mask, cfg.K, cfg.V)),
              f"main shape {label}: n + dn != count_n(z_new)")
        ms = cuda_time_ms(kern, 5)
        bound, by = sweep_bound_ms(d, l, cfg.K, cfg.V, w, live, in_kernel, True)
        changed = int((got[0] != z)[mask].sum())
        timing[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                             bound_by=by, changed_tokens=changed)
        print(f"[4] sweep at main shape, {label}, emit_delta: kernel {ms:.3f} ms, "
              f"plain {plain_ms:.1f} ms, bound {bound:.4f} ms ({by}); "
              f"changed tokens {changed} of {live}", flush=True)

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

    main = timing["prologue"]
    print(json.dumps({"kernels": [{
        "name": "hdp_z", "route": "cuda",
        "source": "src/repro_torch/kernels/hdp_z/csrc/hdp_z.cu",
        "replaces": "src/repro/kernels/hdp_z/hdp_z.py:71",
        "launches": main_launches, "max_abs_err": worst,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "other_inputs": {k: v for k, v in timing.items() if k != "prologue"},
        "z_step_ms": {"alias_in_kernel": z_step_ms["on"],
                      "tables_built_first": z_step_ms["off"]},
    }]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
