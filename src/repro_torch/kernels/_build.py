"""Build and load the port's CUDA kernels at first use.

Each kernel is one ``.cu`` file with a plain C interface. It is compiled
with ``nvcc`` for ``sm_90a`` into a shared library and loaded with
``ctypes``; no PyTorch headers are included, so a build takes seconds.
Libraries go to ``kernels/_build/`` beside this file (listed in
``.gitignore``), named by a hash of the source and its own flags
(``nvcc_flags``), so an edited source or a changed flag is rebuilt and
an unchanged one is loaded as it is. ``ptxas``'s report (registers,
shared memory and spills of each kernel) is kept beside each library
and read by ``ptxas_report``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
# Each source's own flags, after NVCC_FLAGS. Both hdp_z kernels build
# without multiply-add contraction, so that they match their plain
# version bit for bit (never --use_fast_math); the two CUDA-core LM
# kernels keep the flags they were measured with. The two tensor-core SSD
# kernels contract (their segment sums use _rn intrinsics, which never
# fuse), and so do other sources (the tensor-core flash kernel): they
# are held to their plain versions within stated tolerances.
SOURCE_FLAGS = {
    "hdp_z.cu": ("--fmad=false",),
    "hdp_z_lanes.cu": ("--fmad=false",),
    "flash_attention.cu": ("--fmad=false",),
    "ssd_chunk.cu": ("--fmad=false",),
    "ssd_chunk_sm90.cu": ("--fmad=true",),
    "ssd_chunk_sm90_wide.cu": ("--fmad=true",),
}
DEFAULT_SOURCE_FLAGS = ("--fmad=true",)

BUILD_DIR = Path(__file__).resolve().parent / "_build"

_LOADED: dict[str, ctypes.CDLL] = {}
# sweep lanes and fleet workers may reach a library first from several threads
_LOAD_LOCK = threading.Lock()
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


def nvcc_flags(source: Path) -> tuple[str, ...]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(Path(source).name, DEFAULT_SOURCE_FLAGS)


def library_path(source: Path) -> Path:
    """Where ``source`` built with its own flags lives."""
    digest = hashlib.sha256(
        Path(source).read_bytes() + " ".join(nvcc_flags(source)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def ptxas_report(source: Path) -> str:
    """What nvcc printed building ``source`` (``ptxas -v``'s registers,
    spills and static shared memory per kernel), or "" before it is
    built."""
    path = library_path(Path(source).resolve()).with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else ""


def build(source: Path) -> Path:
    """Compile ``source`` with its own flags unless a library for their
    current hash exists."""
    source = Path(source).resolve()
    out = library_path(source)
    if out.exists():
        BUILD_SECONDS.setdefault(source.name, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # processes that reach one build together (the ranks of a sharded run)
    # compile it once: the first holds the lock, the others wait for it
    # and then find the library; the lock ends with its holder's process
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            BUILD_SECONDS.setdefault(source.name, 0.0)
            return out
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        cmd = [_nvcc(), *nvcc_flags(source), "-o", tmp, str(source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({res.returncode}) on {source.name}:\n"
                f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}"
            )
        out.with_suffix(".ptxas.txt").write_text(res.stdout + res.stderr)
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
    with _LOAD_LOCK:
        lib = _LOADED.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _LOADED[key] = lib
    return lib
