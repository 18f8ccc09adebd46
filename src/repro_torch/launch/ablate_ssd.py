"""What each lever of the tensor-core SSD kernel is worth, on the card.

  PYTHONPATH=src python -m repro_torch.launch.ablate_ssd

Times ``csrc/ssd_chunk_sm90.cu`` at hymba's serving shape (B=4, S=512,
H=50, P=64, N=16, chunk 128; B and C shared by the heads as stride-0
views) against copies of it with one lever undone, each built from a
text patch of the source:

- ``cvt_split``: hi and lo rounded by ``cvt.rna.tf32.f32``, not hi by
  two integer operations and lo left for the tensor core to truncate;
- ``direct_accumulate``: each k-step's three passes add straight into
  the running sum, not through a zeroed accumulator;
- ``one_block``: a row tile's 16-column blocks one at a time, not two;
- ``exp2f``: the scores' exp by ``exp2f``, not ``ex2.approx``;
- ``one_pass``: one TF32 pass (hi.hi) instead of three: what float32
  accuracy costs. Its error is reported, not held.

Inputs: dt and A as in tests/test_ssd.py, and as the model at init feeds
them (A = -linspace(1, 16, H), dt the softplus of a unit normal). Every
copy but ``one_pass`` must agree with the plain version within 2e-4 on
y, st and dec. Each copy is timed by CUDA events over 20 launches, in
two rounds, kernel and copies in turns, beside the CUDA-core kernel
(``csrc/ssd_chunk.cu``) on the same inputs. Prints one JSON line per
round and copy.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels.ssd import ssd as SSD
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref
from repro_torch.launch.ablate_hdp_z import cuda_time_ms, patch_copies

ATOL = 2e-4
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
    "one_pass": [(
        "  mma(d, al, bh);\n  mma(d, ah, bl);\n  mma(d, ah, bh);",
        "  mma(d, ah, bh);")],
}
HELD = ("kernel", "cvt_split", "direct_accumulate", "one_block", "exp2f")


def patched_sources() -> dict[str, Path]:
    """The tensor-core kernel's source and its patched copies."""
    return patch_copies(SSD.SM90_SOURCE, PATCHES, "ablate_ssd")


def use(source: Path) -> None:
    """Route the tensor-core launches of this process to ``source``'s
    build."""
    SSD.SM90_SOURCE = source
    SSD._lib_sm90.cache_clear()


def serving_inputs(gen, model: bool):
    """x, dt, a, B, C at hymba's serving shape, B and C (B, S, N) shared
    by the heads as stride-0 views; with ``model`` dt and A as the model
    at init feeds them."""
    cfg = get_config("hymba-1.5b")
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("error: ablate_ssd measures the card; no CUDA device")
    sources = patched_sources()
    _build.build_all([*sources.values(), SSD.SOURCE])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {label: serving_inputs(gen, model)
              for label, model in (("test_inputs", False), ("model_inputs", True))}
    want = {label: ssd_intra_chunk_ref(*args, chunk=cl)
            for label, (args, cl) in inputs.items()}
    for rnd in range(2):
        for name, path in sources.items():
            use(path)
            row = {"round": rnd, "copy": name}
            for label, (args, cl) in inputs.items():
                got = SSD._launch("tensor_cores", *args, cl)
                err = max(float((g - w).abs().max()) for g, w in zip(got, want[label]))
                if name in HELD and err > ATOL:
                    raise SystemExit(f"error: {name} misses {ATOL} on {label}: {err}")
                row[f"{label}_max_abs_err"] = err
                row[f"{label}_ms"] = cuda_time_ms(
                    lambda: SSD._launch("tensor_cores", *args, cl), 20)
            args, cl = inputs["model_inputs"]
            row["cuda_cores_ms"] = cuda_time_ms(
                lambda: SSD._launch("cuda_cores", *args, cl), 20)
            row["card"] = card
            print(json.dumps(row), flush=True)
    use(SSD.CSRC / "ssd_chunk_sm90.cu")


if __name__ == "__main__":
    sys.exit(main())
