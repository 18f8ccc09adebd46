"""Frozen-model snapshots: the deployable artifact of an HDP run
(counterpart of ``repro/serve/snapshot.py``).

A ``ModelSnapshot`` is one posterior sample (Phi, Psi) plus everything
query inference needs, computed once:

  phi    (K, V) f32|bf16 : topic-word probabilities (PPU-normalized)
  psi    (K,)   f32      : global topic distribution
  q_a    (V,)   f32      : per-word term-(a) mass sum_k phi[k,v] alpha psi_k
  fpack  (V, 2, W)       : word-sparse [phi values, alias probs]
  ipack  (V, 2, W)       : word-sparse [topic ids, alias donor slots]
  alpha  ()     f32      : document DP concentration used in training
  it     ()     i32      : source Gibbs iteration (provenance)

Training rebuilds these tables every iteration because Phi moves; a
frozen (Phi, Psi) makes them exact for the snapshot's lifetime. Tables
are built with ``order="topic"``, so fold-in inherits the z-step
conformance contract (``core/conformance.py``): its dense, sparse and
cuda strategies are bitwise equal.

``compact=True`` stores phi and fpack in bf16 and ipack in int16 (valid
for K <= 32768, enforced at build and at load), about halving the
artifact and its device memory; both hdp_z routes read compact tables.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.hdp_z import ops as zops
from repro_torch.train import checkpoint as CKPT


class ModelSnapshot(NamedTuple):
    phi: torch.Tensor     # (K, V)
    psi: torch.Tensor     # (K,)
    q_a: torch.Tensor     # (V,)
    fpack: torch.Tensor   # (V, 2, W)
    ipack: torch.Tensor   # (V, 2, W)
    alpha: torch.Tensor   # () f32
    it: torch.Tensor      # () i32

    @property
    def K(self) -> int:
        return self.phi.shape[0]

    @property
    def V(self) -> int:
        return self.phi.shape[1]

    @property
    def W(self) -> int:
        return self.fpack.shape[-1]

    @property
    def compact(self) -> bool:
        return self.fpack.dtype == torch.bfloat16

    @property
    def device(self) -> torch.device:
        return self.phi.device

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)

    def to(self, device: torch.device | str) -> "ModelSnapshot":
        """A copy on ``device``, or this snapshot where it already lies
        there."""
        device = torch.device(device)
        if all(t.device == device for t in self):
            return self
        return ModelSnapshot(*(t.to(device) for t in self))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def validate_compact(k: int, where: str):
    """The compact layout's hard precondition: int16 ``ipack`` holds
    topic ids 0..K-1, which would wrap past 32767 and corrupt every draw
    that touches a high topic. Checked at build and at load (an artifact
    may come from other code)."""
    if k > 2**15:
        raise ValueError(
            f"compact int16 topic ids are only valid for K <= 32768; "
            f"{where} has K={k}. Rebuild without compact=True."
        )


def build_snapshot(
    phi: torch.Tensor, psi: torch.Tensor, alpha: float, *,
    w: Optional[int] = None, compact: bool = False, it: int = 0,
) -> ModelSnapshot:
    """Distill (Phi, Psi) into a snapshot on Phi's device.

    ``w`` defaults to the exact table width: the largest per-word topic
    support in Phi, rounded up to a multiple of 8 (at most K). A smaller
    ``w`` drops each word's smallest-phi topics beyond W: a lossy,
    smaller artifact.
    """
    phi = phi.to(torch.float32)
    psi = psi.to(torch.float32)
    k = phi.shape[0]
    if w is None:
        w = max(_round_up(zops.max_column_nnz(phi), 8), 8)
    w = min(w, k)
    if compact:
        validate_compact(k, "build_snapshot(phi)")
    q_a, fpack, ipack = zops.build_word_sparse_tables(
        phi, psi, float(alpha), w, compact=compact, order="topic")
    dev = phi.device
    return ModelSnapshot(
        phi=(phi.to(torch.bfloat16) if compact else phi).contiguous(),
        psi=psi.contiguous(), q_a=q_a, fpack=fpack, ipack=ipack,
        alpha=torch.tensor(float(alpha), dtype=torch.float32, device=dev),
        it=torch.tensor(int(it), dtype=torch.int32, device=dev),
    )


def snapshot_from_state(state, cfg, *, w: Optional[int] = None,
                        compact: bool = False) -> ModelSnapshot:
    """From a monolithic ``HDPState`` or a ``StreamingState`` (both carry
    phi, psi and it) and its ``HDPConfig``."""
    return build_snapshot(state.phi, state.psi, cfg.alpha, w=w,
                          compact=compact, it=int(state.it))


# -- persistence --------------------------------------------------------------
# A snapshot directory holds one checkpoint at the fixed step 0: save()
# replaces it through checkpoint.py's atomic rename, so a crash mid-save
# never leaves load() a stale artifact picked by step number (provenance
# lives in the ``it`` field). Loading needs no template: shapes and
# dtypes come from the manifest.

_STEP = 0


def save(path: str, snap: ModelSnapshot) -> str:
    return CKPT.save(path, _STEP, snap._asdict(), keep=0)


def load(path: str, *, device: torch.device | str = "cuda") -> ModelSnapshot:
    """The snapshot saved at ``path``, on ``device`` (the card unless the
    caller asks for the CPU)."""
    dev = resolve_device(device)
    if not os.path.exists(os.path.join(path, f"step_{_STEP}", "manifest.json")):
        raise FileNotFoundError(f"no model snapshot at {path!r}")
    flat = CKPT.restore_flat(path, _STEP)
    missing = [f for f in ModelSnapshot._fields if f not in flat]
    if missing:
        raise ValueError(f"{path!r} is not a model snapshot: missing {missing}")
    snap = ModelSnapshot(**{f: flat[f] for f in ModelSnapshot._fields})
    if snap.ipack.dtype == torch.int16:
        validate_compact(snap.K, f"snapshot at {path!r}")
    return snap.to(dev)
