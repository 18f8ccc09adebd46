"""Carry a sampler state or a serving snapshot across between the
reference and the port.

The reference's ``HDPState``, ``StreamingState`` and ``ModelSnapshot``
fields travel as numpy arrays (a JAX array converts with
``np.asarray``; bfloat16 arrays keep their bits); its PRNG key does not
carry over, since the two frameworks draw different bits, so the port's
state gets a fresh ``torch.Generator`` from ``seed``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Mapping

import numpy as np
import torch

from repro_torch.core.hdp import HDPState, make_generator
from repro_torch.device import resolve_device

if TYPE_CHECKING:  # streaming and serving sit above this module
    from repro_torch.core.streaming import StreamingHDP, StreamingState
    from repro_torch.serve.snapshot import ModelSnapshot

_DTYPES = {"z": torch.int32, "n": torch.int32, "phi": torch.float32,
           "varphi": torch.int32, "psi": torch.float32, "l": torch.int32}


def state_from_numpy(
    arrays: Mapping[str, Any] | Any, *, seed: int,
    device: torch.device | str = "cuda",
) -> HDPState:
    """Build the port's ``HDPState`` from ``z, n, phi, varphi, psi, l,
    it`` given as a mapping or as attributes (a reference ``HDPState``).
    Arrays are copied, never shared with their source."""
    get = (arrays.__getitem__ if isinstance(arrays, Mapping)
           else lambda k: getattr(arrays, k))
    dev = torch.device(device)
    fields = {
        k: torch.tensor(np.array(get(k)), dtype=dt, device=dev)
        for k, dt in _DTYPES.items()
    }
    return HDPState(**fields, gen=make_generator(seed, dev),
                    it=int(np.asarray(get("it"))))


def state_to_numpy(state: HDPState) -> dict[str, Any]:
    """The state's arrays as numpy (and ``it`` as an int)."""
    out = {k: getattr(state, k).detach().cpu().numpy() for k in _DTYPES}
    out["it"] = int(state.it)
    return out


def streaming_state_from_numpy(
    arrays: Mapping[str, Any] | Any, z_blocks, stream: StreamingHDP, *,
    seed: int,
) -> StreamingState:
    """The port's ``StreamingState`` for ``stream`` from a reference
    streaming state's ``n, phi, varphi, psi, l, it`` (a mapping or
    attributes) and its z slabs ``z_blocks`` ((B, DB, L), an array or
    anything ``np.asarray`` takes, such as a reference ``ZSlabStore``),
    written into a new slab store of ``stream``'s kind. Arrays are
    copied."""
    from repro_torch.core.streaming import StreamingState

    get = (arrays.__getitem__ if isinstance(arrays, Mapping)
           else lambda k: getattr(arrays, k))
    dev = stream.device
    fields = {k: torch.tensor(np.array(get(k)), dtype=dt, device=dev)
              for k, dt in _DTYPES.items() if k != "z"}
    z = np.asarray(z_blocks)
    slabs = stream._make_slab_store()
    if z.shape != (slabs.num_blocks,) + slabs.block_shape:
        raise ValueError(f"z slabs of shape {z.shape}, the store holds "
                         f"{(slabs.num_blocks,) + slabs.block_shape}")
    for b in range(slabs.num_blocks):
        slabs.write(b, z[b])
    return StreamingState(**fields, gen=make_generator(seed, dev),
                          it=int(np.asarray(get("it"))), z_blocks=slabs)


def _tensor(x, device: torch.device) -> torch.Tensor:
    """A copy of ``x`` as a tensor on ``device``; a bfloat16 array (numpy
    has no such dtype of its own) crosses as its 16 bits."""
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def snapshot_from_numpy(
    arrays: Mapping[str, Any] | Any, *, device: torch.device | str = "cuda",
) -> ModelSnapshot:
    """The port's ``ModelSnapshot`` from a reference snapshot's ``phi,
    psi, q_a, fpack, ipack, alpha, it`` (a mapping or attributes), the
    compact layout (bf16 phi and fpack, int16 ipack) included. Arrays are
    copied, bit for bit."""
    from repro_torch.serve.snapshot import ModelSnapshot, validate_compact

    get = (arrays.__getitem__ if isinstance(arrays, Mapping)
           else lambda k: getattr(arrays, k))
    dev = resolve_device(device)
    snap = ModelSnapshot(**{f: _tensor(get(f), dev).contiguous()
                            for f in ModelSnapshot._fields})
    if snap.ipack.dtype == torch.int16:
        validate_compact(snap.K, "snapshot_from_numpy")
    return snap
