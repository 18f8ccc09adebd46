"""Architecture registry (counterpart of ``repro.configs``).

``ARCHS`` lists every architecture the reference supports;
``get_config(name)`` returns the full published ``LMConfig`` of one the
port has ported, ``get_config(name, smoke=True)`` its reduced
same-family config. An architecture not yet ported raises.
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

PORTED = {
    "hymba-1.5b": "hymba_1_5b",
    "musicgen-medium": "musicgen_medium",
    "paligemma-3b": "paligemma_3b",
    "starcoder2-3b": "starcoder2_3b",
}


def get_config(name: str, smoke: bool = False):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    if name not in PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ported: {sorted(PORTED)}); "
            "see ROADMAP.md, section A"
        )
    cfg = importlib.import_module(f"repro_torch.configs.{PORTED[name]}").CONFIG
    return cfg.smoke() if smoke else cfg
