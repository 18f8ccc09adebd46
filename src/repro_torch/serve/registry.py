"""Versioned snapshot registry (counterpart of
``repro/serve/registry.py``): the publish/subscribe seam between a live
training run and a serving fleet.

A registry directory holds immutable, monotonically numbered snapshot
versions plus one manifest:

    <dir>/registry.json        committed versions + latest pointer
    <dir>/v3/step_0/...        one ModelSnapshot artifact per version
    <dir>/v4/step_0/...        (serve/snapshot.py save layout)

Publish protocol (single writer — the training run; any number of
readers — fleet workers):

  1. the snapshot is written under ``.tmp-v<N>`` (never visible);
  2. the tmp dir is renamed to ``v<N>`` (atomic on POSIX);
  3. ``registry.json`` is rewritten via tmp-file + ``os.replace``
     (atomic), now listing version N and pointing ``latest`` at it.

Readers trust ONLY versions listed in the manifest, so a crash at any
point leaves at worst an orphan directory — never a half-readable
"latest". Retention (``keep``) drops old versions from the manifest
first and deletes their directories after the commit, so a reader
holding a stale manifest can at worst hit a FileNotFoundError and
re-read — it can never load torn data.

Version numbers are never reused (next = max ever published + 1, orphans
included), which is what makes the fleet's hot-swap check ("did latest
move?") and the ensemble determinism contract ("deterministic given the
registry version set") meaningful.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Optional

import torch

from repro_torch.serve import snapshot as SNAP

_MANIFEST = "registry.json"
_SCHEMA = 1


class SnapshotRegistry:
    """Directory-backed registry of published ``ModelSnapshot`` versions."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)

    # -- manifest ----------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.path, _MANIFEST)

    def manifest(self) -> dict:
        """The committed manifest (empty registry => no versions)."""
        try:
            with open(self._manifest_path()) as f:
                return json.load(f)
        except FileNotFoundError:
            return {"schema": _SCHEMA, "latest": None, "versions": {}}

    def _commit(self, manifest: dict):
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, self._manifest_path())  # atomic commit

    def versions(self) -> list[int]:
        """Committed version numbers, ascending."""
        return sorted(int(v) for v in self.manifest()["versions"])

    def latest_version(self) -> Optional[int]:
        return self.manifest()["latest"]

    def _vdir(self, version: int) -> str:
        return os.path.join(self.path, f"v{version}")

    # -- publish / load ----------------------------------------------------
    def _next_version(self) -> int:
        """One past the highest version ever written — committed or
        orphaned — so a crashed publish can never be silently overwritten
        by the retry."""
        top = max((int(v) for v in self.manifest()["versions"]), default=0)
        for name in os.listdir(self.path):
            base = name[len(".tmp-"):] if name.startswith(".tmp-") else name
            if base.startswith("v") and base[1:].isdigit():
                top = max(top, int(base[1:]))
        return top + 1

    def publish(self, snap: SNAP.ModelSnapshot, *,
                keep: Optional[int] = None) -> int:
        """Atomically publish one snapshot; returns its version number.

        ``keep``: retain only the newest ``keep`` versions (older ones
        leave the manifest before their directories are deleted).
        """
        version = self._next_version()
        tmp = os.path.join(self.path, f".tmp-v{version}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        SNAP.save(tmp, snap)
        os.rename(tmp, self._vdir(version))

        manifest = self.manifest()
        manifest["schema"] = _SCHEMA
        manifest["versions"][str(version)] = {
            "it": int(snap.it), "K": snap.K, "V": snap.V, "W": snap.W,
            "compact": bool(snap.compact),
            "nbytes": int(snap.nbytes()),
            "published_unix": round(time.time(), 3),
        }
        manifest["latest"] = version
        dropped = []
        if keep is not None and keep > 0:
            live = sorted(int(v) for v in manifest["versions"])
            dropped = live[:-keep]
            for v in dropped:
                del manifest["versions"][str(v)]
        self._commit(manifest)
        for v in dropped:  # after commit: readers never see torn dirs
            shutil.rmtree(self._vdir(v), ignore_errors=True)
        return version

    def load(self, version: Optional[int] = None, *,
             device: torch.device | str = "cuda") -> SNAP.ModelSnapshot:
        """Load one committed version (default: latest) onto ``device``."""
        manifest = self.manifest()
        if version is None:
            version = manifest["latest"]
            if version is None:
                raise FileNotFoundError(
                    f"registry {self.path!r} has no published versions"
                )
        if str(version) not in manifest["versions"]:
            raise FileNotFoundError(
                f"version {version} is not committed in registry "
                f"{self.path!r} (have {self.versions()})"
            )
        return SNAP.load(self._vdir(int(version)), device=device)

    def latest_versions(self, n: int) -> list[int]:
        """The newest ``n`` committed versions, ascending — the ensemble
        fan-out set. Raises when fewer than ``n`` are published."""
        have = self.versions()
        if len(have) < n:
            raise ValueError(
                f"registry {self.path!r} has {len(have)} published "
                f"version(s); ensemble needs {n}"
            )
        return have[-n:]
