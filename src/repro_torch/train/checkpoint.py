"""Checkpoints with atomic commit and retention (counterpart of
``repro/train/checkpoint.py``), in the port's own format.

Layout:  <dir>/step_<N>/
            manifest.json   flat key -> {shape, dtype}
            <key>.npy       one array (a "/" in the key becomes "__")

A payload is a nested dict whose leaves are torch tensors (on any
device), numpy arrays or Python/numpy scalars; every leaf is stored as a
numpy array on the host (bfloat16 tensors as their 16 bits, dtype
"bfloat16" in the manifest). ``restore`` rebuilds a template's structure
and gives each leaf its template's kind: a tensor (with the template's
dtype and device) or a numpy array.

Arrays are stored at their logical (global) shape. A sharded state is
saved leaf by leaf (``save_items`` takes the leaves from an iterator,
so the saver gathers one leaf at a time), and ``load_slice`` reads a
rank's slice of one stored array without reading the rest, so a
checkpoint restores onto any grid (``train/sharding.py``,
``train/elastic.py``).

A save writes ``.tmp-step_<N>`` and renames it only when complete, so a
crash never corrupts the latest checkpoint; ``keep`` bounds how many are
retained. A payload may pin files stored beside it instead of embedding
them (the streaming driver's ``z_versions``): those files are written
before the commit, and ``arrays_across_steps`` lets their owner keep
whatever any retained manifest pins.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Iterable, Optional

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _path(ckpt_dir: str, step: int, key: str) -> str:
    return os.path.join(ckpt_dir, f"step_{step}", key.replace("/", "__") + ".npy")


def save(ckpt_dir: str, step: int, state: dict, *, keep: int = 3) -> str:
    return save_items(ckpt_dir, step, _flatten(state).items(), keep=keep)


def save_items(ckpt_dir: str, step: int, items: Iterable[tuple[str, Any]], *,
               keep: int = 3) -> str:
    """``save`` of flat ``(key, leaf)`` pairs, each written as it comes
    and dropped before the next is asked for."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = os.path.join(ckpt_dir, f".tmp-step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {}
    for key, leaf in items:
        arr, dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp, key.replace("/", "__") + ".npy"), arr)
        manifest[key] = {"shape": list(arr.shape), "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "arrays": manifest}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    _apply_retention(ckpt_dir, keep)
    return final


def _apply_retention(ckpt_dir: str, keep: int):
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _manifest(ckpt_dir: str, step: int) -> dict:
    with open(os.path.join(ckpt_dir, f"step_{step}", "manifest.json")) as f:
        return json.load(f)["arrays"]


def manifest_keys(ckpt_dir: str, step: int) -> list[str]:
    """Flat array keys stored in one checkpoint, without loading them."""
    return list(_manifest(ckpt_dir, step).keys())


def stored_shapes(ckpt_dir: str, step: int) -> dict[str, tuple[int, ...]]:
    """Every stored array's logical shape, from the manifest alone."""
    return {k: tuple(m["shape"]) for k, m in _manifest(ckpt_dir, step).items()}


def load_array(ckpt_dir: str, step: int, key: str) -> np.ndarray:
    """One stored array by flat key, as saved (bfloat16 as its bits)."""
    return np.load(_path(ckpt_dir, step, key))


def load_slice(ckpt_dir: str, step: int, key: str,
               index: tuple[slice, ...]) -> torch.Tensor:
    """``index`` of one stored array as a CPU tensor of its dtype, read
    through a memory map (only the slice's pages are read)."""
    meta = _manifest(ckpt_dir, step)[key]
    raw = np.load(_path(ckpt_dir, step, key), mmap_mode="r")
    return _decode(meta, raw[index] if raw.ndim else raw)


def _decode(meta: dict, raw: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.array(raw))  # a writable copy; 0-d stays 0-d
    return t.view(torch.bfloat16) if meta["dtype"] == "bfloat16" else t


def arrays_across_steps(ckpt_dir: str, key: str) -> dict[int, np.ndarray]:
    """``{step: stored array}`` for every retained checkpoint whose
    manifest carries ``key`` (others are skipped): the scan by which the
    owner of files a payload pins keeps everything still pinned."""
    return {s: load_array(ckpt_dir, s, key) for s in all_steps(ckpt_dir)
            if key in manifest_keys(ckpt_dir, s)}


def restore_flat(ckpt_dir: str, step: Optional[int] = None) -> dict[str, torch.Tensor]:
    """A checkpoint as a flat {key: CPU tensor} dict, without a template;
    ``step`` defaults to the latest."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir!r}")
    return {key: _decode(meta, load_array(ckpt_dir, step, key))
            for key, meta in _manifest(ckpt_dir, step).items()}


def restore(ckpt_dir: str, step: int, template: dict) -> dict:
    """Rebuild ``template``'s structure from checkpoint ``step``: a tensor
    leaf comes back as a tensor of its dtype on its device, anything else
    as a numpy array of the stored dtype."""
    flat = restore_flat(ckpt_dir, step)

    def build(tpl, prefix):
        if isinstance(tpl, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in tpl.items()}
        val = flat[prefix[:-1]]
        if isinstance(tpl, torch.Tensor):
            return val.to(device=tpl.device, dtype=tpl.dtype)
        return val.numpy()

    return build(template, "")


def restore_latest(ckpt_dir: str, template: dict):
    """``restore`` of the most recent checkpoint, or None when there is
    none."""
    step = latest_step(ckpt_dir)
    return None if step is None else restore(ckpt_dir, step, template)
