"""What each lever of the lanes hdp_z kernel is worth, on the card.

  PYTHONPATH=src python -m repro_torch.launch.ablate_hdp_z

Takes 3 Gibbs iterations of the main path (``repro_torch.launch.train``
at PubMed 0.01, K=1000, W=256) as ``chip_smoke.py`` phase 3 does, then
times ``csrc/hdp_z_lanes.cu`` at that shape against copies of it with
one lever undone, each built from a text patch of the source:

- ``recompute_line``: the second walk gathers and adds its first 20
  prefixes again instead of reading the first walk's;
- ``index_order``: documents go to lanes in index order, not longest
  first;
- ``group16``: 16 slots a position in registers, not 20.

Each copy must give bitwise the kernel's z, m and dn. Inputs: the
trained state in prologue and table mode, and random z in prologue
mode. Each copy is timed by CUDA events over 5 launches, in two rounds,
kernel and copies in turns. Prints one JSON line per round and copy.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.core import hdp as H
from repro_torch.kernels import _build
from repro_torch.kernels.hdp_z import hdp_z as HZ
from repro_torch.kernels.hdp_z import ops as zops
from repro_torch.launch import train as T

PATCHES = {
    "recompute_line": [(
        """            Count r{c0[(kGroup - 1) * kLanes], 0, z_old, false};
#pragma unroll
            for (int j = 0; j < kGroup; ++j) {  // straight-line, as above
              const bool on = !r.hit && j < n;
              const bool below = c0[j * kLanes] < t;""",
        """            Count r{0.f, 0, z_old, false};
#pragma unroll
            for (int j = 0; j < kGroup; ++j) {
              const bool on = !r.hit && j < n;
              const int idj = j < n ? first.id[j] : 0;
              const float wbj =
                  __fmul_rn(first.f[j], count_f(mcol[idj * kLanes]));
              const float cj = j == 0 ? wbj : __fadd_rn(r.c, wbj);
              r.c = j < n ? cj : r.c;
              const bool below = cj < t;""")],
    "index_order": [(
        "const int doc = doc0 + lane < D ? __ldg(order + doc0 + lane) : D;",
        "const int doc = doc0 + lane < D ? doc0 + lane : D;")],
    "group16": [("constexpr int kGroup = 20;", "constexpr int kGroup = 16;")],
}


def patch_copies(source: Path, patches: dict, subdir: str) -> dict[str, Path]:
    """``source`` and its copies with each patch of ``patches`` (name to
    a list of (old, new) text edits, each old text found once) applied,
    each in its own directory under the build directory's ``subdir``
    (the build flags go by file name, so every copy keeps the
    source's)."""
    text = source.read_text()
    out = {"kernel": source}
    for name, edits in patches.items():
        body = text
        for old, new in edits:
            if body.count(old) != 1:
                raise SystemExit(f"error: patch {name!r} does not apply to {source.name}")
            body = body.replace(old, new)
        path = _build.BUILD_DIR / subdir / name / source.name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(body)
        out[name] = path
    return out


def patched_sources() -> dict[str, Path]:
    """The lanes kernel's source and its patched copies."""
    return patch_copies(HZ.LANES_SOURCE, PATCHES, "ablate")


def cuda_time_ms(fn, reps: int) -> float:
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


def use(source: Path) -> None:
    """Route the lanes launches of this process to ``source``'s build."""
    HZ.LANES_SOURCE = source
    HZ._lib_lanes.cache_clear()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("error: ablate_hdp_z measures the card; no CUDA device")
    sources = patched_sources()
    _build.build_all([*sources.values(), HZ.SOURCE])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    args = T.build_parser().parse_args([
        "--hdp", "pubmed", "--scale", "0.01", "--iters", "3", "--topics",
        "1000", "--max-len", "256", "--bucket", "256", "--log-every", "3",
        "--seed", "0"])
    state, _, _ = T.train_hdp(args)
    _, cfg, tokens, mask, _ = T.prepare_hdp(args)
    dev = tokens.device
    gen = H.make_generator(1, dev)
    u = torch.rand(tokens.shape + (3,), generator=gen, device=dev)
    z_rand = torch.where(mask, torch.randint(
        0, cfg.K, tokens.shape, generator=gen, device=dev, dtype=torch.int32), 0)
    apsi = torch.tensor(cfg.alpha, dtype=torch.float32, device=dev) * state.psi
    vals, ids = zops.build_word_sparse_supports(state.phi, cfg.bucket)
    q_a, fpack, ipack = zops.build_word_sparse_tables(
        state.phi, state.psi, cfg.alpha, cfg.bucket)
    inputs = {"prologue": (state.z, dict(apsi=apsi, vals=vals, ids=ids)),
              "table": (state.z, dict(q_a=q_a, fpack=fpack, ipack=ipack)),
              "prologue_random_z": (z_rand, dict(apsi=apsi, vals=vals, ids=ids))}

    def launch(label):
        z, kw = inputs[label]
        return HZ._launch("lanes", tokens, mask, z, u, kk=cfg.K,
                          emit_delta=True, **kw)

    use(sources["kernel"])
    want = {label: launch(label) for label in inputs}
    for rnd in range(2):
        for name, path in sources.items():
            use(path)
            row = {"round": rnd, "copy": name}
            for label in inputs:
                got = launch(label)
                if not all(torch.equal(a, b) for a, b in zip(got, want[label])):
                    raise SystemExit(f"error: {name} differs from the kernel on {label}")
                row[f"{label}_ms"] = cuda_time_ms(lambda: launch(label), 5)
            row["card"] = card
            print(json.dumps(row), flush=True)
    use(HZ.CSRC / "hdp_z_lanes.cu")


if __name__ == "__main__":
    sys.exit(main())
