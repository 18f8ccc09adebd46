"""Carry a sampler state across between the reference and the port.

The reference's ``HDPState`` fields travel as numpy arrays (a JAX array
converts with ``np.asarray``); its PRNG key does not carry over, since
the two frameworks draw different bits, so the port's state gets a fresh
``torch.Generator`` from ``seed``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.hdp import HDPState, make_generator

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
