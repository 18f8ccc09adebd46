"""Architecture registry (counterpart of ``repro.configs``).

``ARCHS`` lists every architecture the reference supports, and the port
has them all: ``get_config(name)`` returns the full published
``LMConfig``, ``get_config(name, smoke=True)`` its reduced same-family
config. An unknown name raises ``KeyError``.
"""

from __future__ import annotations

import importlib

ARCHS = [
    "mamba2-780m",
    "starcoder2-3b",
    "qwen1.5-32b",
    "chatglm3-6b",
    "nemotron-4-340b",
    "hymba-1.5b",
    "deepseek-moe-16b",
    "llama4-scout-17b-a16e",
    "musicgen-medium",
    "paligemma-3b",
]

# arch name -> module of this package that holds its CONFIG
PORTED = {name: name.replace("-", "_").replace(".", "_") for name in ARCHS}


def get_config(name: str, smoke: bool = False):
    if name not in PORTED:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    cfg = importlib.import_module(f"repro_torch.configs.{PORTED[name]}").CONFIG
    return cfg.smoke() if smoke else cfg
