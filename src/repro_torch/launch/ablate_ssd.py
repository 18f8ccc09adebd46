"""What each lever of the tensor-core SSD kernels is worth, on the card.

  PYTHONPATH=src python -m repro_torch.launch.ablate_ssd [--shape hymba|mamba2|both]

Times each tensor-core SSD kernel at its model's serving shape against
copies of it with one lever undone, each built from a text patch of the
source. B and C are shared by the heads as stride-0 views, as the
models pass them.

``csrc/ssd_chunk_sm90.cu`` at hymba-1.5b's shape (B=4, S=512, H=50,
P=64, N=16, chunk 128):

- ``cvt_split``: hi and lo rounded by ``cvt.rna.tf32.f32``, not hi by
  two integer operations and lo left for the tensor core to truncate;
- ``direct_accumulate``: each k-step's three passes add straight into
  the running sum, not through a zeroed accumulator;
- ``one_block``: a row tile's 16-column blocks one at a time, not two;
- ``exp2f``: the scores' exp by ``exp2f``, not ``ex2.approx``;
- ``one_pass``: one TF32 pass (hi.hi) instead of three: what float32
  accuracy costs. Its error is reported, not held.

``csrc/ssd_chunk_sm90_wide.cu`` at mamba2-780m's shape (B=4, S=512,
H=48, P=64, N=128, chunk 128):

- ``g_per_head``: C B^T computed for every head, one head a CTA's
  unit, not once for a group of heads that share B and C;
- ``no_slice_prefetch``: each slice of B and C waited for before the
  one before it is computed: no copy in flight during G's k-steps;
- ``no_head_prefetch``: the next head's x and dt waited for before this
  head computes;
- ``rounded_lo``: lo rounded to tf32 as hi is (two integer operations),
  not left for the tensor core to truncate. Its error is reported, not
  held;
- ``one_pass``: as above, reported, not held.

At hymba's shape the wide kernel (``tensor_cores_wide``, which takes any
N from 4 to 128) is held and timed beside the N <= 32 kernel: the
measure of whether one tensor-core kernel could serve both models.

First it holds the kernel, each copy and the other routes on the same
inputs (the CUDA-core kernel, and at hymba's shape the wide kernel)
against the plain version and against a float64 oracle (decays from
float64 segment sums) on ``DRAWS`` draws of the model's dt and A, B and
C shared and drawn per head, and prints each draw's errors, the plain
version's own among them (at N=128 and |y| near 300 every float32
implementation is a few ulps, 3e-5 each, from the oracle), then the
largest of each over the draws.

Inputs: dt and A as in tests/test_ssd.py, and as the model at init feeds
them (A = -linspace(1, 16, H), dt the softplus of a unit normal). Every
held copy must agree with the plain version within 2e-4 on y, st and
dec. Each copy is timed by CUDA events over 20 launches, in two rounds,
kernel and copies in turns, beside the CUDA-core kernel
(``csrc/ssd_chunk.cu``) and the other routes on the same inputs. Prints
one JSON line per shape, round and copy.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels.ssd import ssd as SSD
from repro_torch.kernels.ssd.ref import decay_to_end, segsum, ssd_intra_chunk_ref
from repro_torch.launch.ablate_hdp_z import cuda_time_ms, patch_copies

ATOL = 2e-4
DRAWS = 4
ONE_PASS = ("  mma(d, al, bh);\n  mma(d, ah, bl);\n  mma(d, ah, bh);", "  mma(d, ah, bh);")
PATCHES = {
    "cvt_split": [(
        """  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));""",
        """  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(v));
  const float r = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(r));""")],
    "direct_accumulate": [(
        """  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(d, ah, al, bh, bl);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];""",
        "  mma3(acc, ah, al, bh, bl);")],
    "one_block": [(
        "#pragma unroll 2\n        for (int m = 0; m < rt; ++m)",
        "#pragma unroll 1\n        for (int m = 0; m < rt; ++m)")],
    "exp2f": [(
        "  asm(\"ex2.approx.ftz.f32 %0, %1;\\n\" : \"=f\"(y) : \"f\"(x));",
        "  y = exp2f(x);")],
    "one_pass": [ONE_PASS],
}
HELD = ("kernel", "cvt_split", "direct_accumulate", "one_block", "exp2f")
WIDE_PATCHES = {
    "g_per_head": [(
        "  const bool shared = pr.sd.b[2] == 0 && pr.sd.c[2] == 0;",
        "  const bool shared = false;")],
    "no_slice_prefetch": [(
        "      if (s + 1 < L.NS) load_slice(pr, L, un, s + 1, smem);\n"
        "      cp_async_commit();\n",
        "      if (s + 1 < L.NS) load_slice(pr, L, un, s + 1, smem);\n"
        "      cp_async_commit();\n      cp_async_wait_all();\n")],
    "no_head_prefetch": [(
        "      cp_async_commit();\n      const float* xst",
        "      cp_async_commit();\n      cp_async_wait_all();\n      const float* xst")],
    "rounded_lo": [(
        "  lo = __float_as_uint(v - __uint_as_float(hi));",
        "  lo = (__float_as_uint(v - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;")],
    "one_pass": [ONE_PASS],
}
WIDE_HELD = ("kernel", "g_per_head", "no_slice_prefetch", "no_head_prefetch")


@dataclass(frozen=True)
class Kernel:
    """A tensor-core SSD kernel: its model, route, source, patches, the
    copies held to the tolerance, and the other routes held and timed on
    the same inputs."""
    arch: str
    route: str
    attr: str      # the module attribute naming its source
    lib: str       # the module's cached loader of it
    patches: dict
    held: tuple
    subdir: str
    rivals: tuple


KERNELS = {
    "hymba": Kernel("hymba-1.5b", "tensor_cores", "SM90_SOURCE", "_lib_sm90", PATCHES,
                    HELD, "ablate_ssd", ("tensor_cores_wide", "cuda_cores")),
    "mamba2": Kernel("mamba2-780m", "tensor_cores_wide", "WIDE_SOURCE", "_lib_wide",
                     WIDE_PATCHES, WIDE_HELD, "ablate_ssd_wide", ("cuda_cores",)),
}


def patched_sources(kernel: Kernel = KERNELS["hymba"]) -> dict[str, Path]:
    """A tensor-core kernel's source and its patched copies."""
    return patch_copies(getattr(SSD, kernel.attr), kernel.patches, kernel.subdir)


def use(source: Path, kernel: Kernel = KERNELS["hymba"]) -> None:
    """Route ``kernel``'s launches of this process to ``source``'s build."""
    setattr(SSD, kernel.attr, source)
    getattr(SSD, kernel.lib).cache_clear()


def serving_inputs(gen, model: bool, arch: str = "hymba-1.5b"):
    """x, dt, a, B, C at ``arch``'s serving shape (B=4, S=512), B and C
    (B, S, N) shared by the heads as stride-0 views; with ``model`` dt
    and A as the model at init feeds them."""
    cfg = get_config(arch)
    b, s, p, n = 4, 512, cfg.ssm_head_dim, cfg.ssm_state
    h = cfg.ssm_expand * cfg.d_model // p
    x = torch.randn((b, s, h, p), generator=gen, device="cuda")
    if model:
        dt = torch.nn.functional.softplus(
            torch.randn((b, s, h), generator=gen, device="cuda"))
        a = -torch.linspace(1.0, 16.0, h, device="cuda")
    else:
        dt = torch.rand((b, s, h), generator=gen, device="cuda") * 0.19 + 0.01
        a = -(torch.rand((h,), generator=gen, device="cuda") * 1.5 + 0.5)
    bm, cm = (torch.randn((b, s, n), generator=gen, device="cuda")[:, :, None, :]
              .expand(b, s, h, n) for _ in range(2))
    return (x, dt, a, bm, cm), cfg.ssd_chunk


def oracle(x, dt, a, bm, cm, chunk):
    """The intra-chunk pass in float64 from the float32 inputs, its
    decays from float64 segment sums of the exact products dt * A."""
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


def accuracy(name: str, kernel: Kernel, sources: dict[str, Path], draws: int,
             card: str) -> None:
    """``kernel``, each of its copies and its rival routes against the
    plain version and the float64 oracle on ``draws`` draws of the
    model's dt and A, B and C shared and per head; one JSON line a draw,
    then one with the largest of each error over the draws."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    most: dict[str, float] = {}
    try:
        for draw in range(draws):
            for shared in (True, False):
                args, cl = serving_inputs(gen, True, kernel.arch)
                if not shared:  # B and C drawn for each head, contiguous
                    args = (*args[:3], *(torch.randn(args[3].shape, generator=gen,
                                                     device="cuda") for _ in range(2)))
                want = ssd_intra_chunk_ref(*args, chunk=cl)
                exact = oracle(*args, cl)
                row = {"shape": name, "draw": draw, "b_c_shared": shared, "card": card,
                       "plain_to_oracle": max(float((w.double() - o).abs().max())
                                              for w, o in zip(want, exact))}
                runs = [(copy, kernel.route, path) for copy, path in sources.items()]
                runs += [(r, r, None) for r in kernel.rivals]
                for label, r, path in runs:
                    if path is not None:
                        use(path, kernel)
                    got = SSD._launch(r, *args, cl)
                    row[f"{label}_to_plain"] = max(float((g - w).abs().max())
                                                   for g, w in zip(got, want))
                    row[f"{label}_to_oracle"] = max(float((g.double() - o).abs().max())
                                                    for g, o in zip(got, exact))
                for k, v in row.items():
                    if k.endswith(("_to_plain", "_to_oracle")):
                        most[k] = max(most.get(k, 0.0), v)
                print(json.dumps(row), flush=True)
    finally:
        use(sources["kernel"], kernel)
    print(json.dumps({"shape": name, "largest_over_draws": draws, "card": card, **most}),
          flush=True)


def ablate(name: str, kernel: Kernel, sources: dict[str, Path], card: str) -> None:
    """Hold and time ``kernel`` and its copies at its model's shape, two
    rounds, beside its rival routes; one JSON line per round and copy."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {label: serving_inputs(gen, model, kernel.arch)
              for label, model in (("test_inputs", False), ("model_inputs", True))}
    want = {label: ssd_intra_chunk_ref(*args, chunk=cl)
            for label, (args, cl) in inputs.items()}
    try:
        for rnd in range(2):
            for copy, path in sources.items():
                use(path, kernel)
                row = {"shape": name, "arch": kernel.arch, "round": rnd, "copy": copy}
                for label, (args, cl) in inputs.items():
                    got = SSD._launch(kernel.route, *args, cl)
                    err = max(float((g - w).abs().max()) for g, w in zip(got, want[label]))
                    if copy in kernel.held and err > ATOL:
                        raise SystemExit(f"error: {name} {copy} misses {ATOL} on {label}: {err}")
                    row[f"{label}_max_abs_err"] = err
                    row[f"{label}_ms"] = cuda_time_ms(
                        lambda: SSD._launch(kernel.route, *args, cl), 20)
                args, cl = inputs["model_inputs"]
                for r in kernel.rivals:
                    row[f"{r}_ms"] = cuda_time_ms(lambda: SSD._launch(r, *args, cl), 20)
                row["card"] = card
                print(json.dumps(row), flush=True)
    finally:
        use(sources["kernel"], kernel)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shape", choices=("hymba", "mamba2", "both"), default="both")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("error: ablate_ssd measures the card; no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    for name in (("hymba", "mamba2") if args.shape == "both" else (args.shape,)):
        kernel = KERNELS[name]
        sources = patched_sources(kernel)
        _build.build_all([*sources.values(), *SSD.SOURCES])
        accuracy(name, kernel, sources, DRAWS, card)
        ablate(name, kernel, sources, card)


if __name__ == "__main__":
    sys.exit(main())
