"""Build and load the port's CUDA kernels at first use.

Each kernel is one ``.cu`` file with a plain C interface. It is compiled
with ``nvcc`` for ``sm_90a`` into a shared library and loaded with
``ctypes``; no PyTorch headers are included, so a build takes seconds.
Libraries go to ``kernels/_build/`` beside this file (listed in
``.gitignore``), named by a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no multiply-add contraction, so that hdp_z matches its plain
    # version bit for bit (never --use_fast_math); the LM kernels are
    # held to their plain versions within stated tolerances
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

BUILD_DIR = Path(__file__).resolve().parent / "_build"

_LOADED: dict[str, ctypes.CDLL] = {}
# seconds spent compiling, per source, in this process (0 when cached)
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels are compiled at first use and need the CUDA toolkit"
    )


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build(source: Path) -> Path:
    """Compile ``source`` unless a library for its current hash exists."""
    source = Path(source).resolve()
    out = library_path(source)
    if out.exists():
        BUILD_SECONDS.setdefault(source.name, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}) on {source.name}:\n"
            f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    BUILD_SECONDS[source.name] = time.perf_counter() - t0
    return out


def build_all(sources: Iterable[Path]) -> list[Path]:
    """Build several sources at once, one ``nvcc`` each, all started
    together; raises the first build's error."""
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return list(pool.map(build, sources))


def load(source: Path) -> ctypes.CDLL:
    """Build if needed, then load once per process: later calls return
    the loaded library without reading the source again."""
    key = str(Path(source).resolve())
    lib = _LOADED.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        _LOADED[key] = lib
    return lib
