"""PyTorch and CUDA port of the doubly sparse HDP Gibbs sampler.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``data``, ``core``, ``kernels``, ``launch``) so that every module
has a named counterpart there. Plain code is PyTorch on explicit devices
with explicit ``torch.Generator``s; the z-sweep, which ``repro`` runs as
a Pallas TPU kernel, is a CUDA kernel written for Hopper
(``kernels/hdp_z/csrc/hdp_z_lanes.cu``, one document per lane, and
``hdp_z.cu``, one per warp, where the first does not fit).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see ``repro_torch.device``).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
