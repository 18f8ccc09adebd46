"""Input-shape cells for the LM architectures and the HDP corpora
(counterpart of ``repro/configs/shapes.py``).

Every (arch x shape) pair names the step ``launch/dryrun.py`` traces:
  train_4k    -> the sharded train step (seq 4096,   global batch 256)
  prefill_32k -> prefill                (seq 32768,  global batch 32)
  decode_32k  -> one decode step        (KV/state cache of 32768, batch 128)
  long_500k   -> one decode step        (cache 524288, batch 1; sub-quadratic
                                         archs only)

HDP cells are one Gibbs iteration at the paper's corpus scales.
"""

from __future__ import annotations

from typing import NamedTuple


class ShapeCell(NamedTuple):
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

SMOKE_SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 64, 4),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 64, 2),
    "decode_32k": ShapeCell("decode_32k", "decode", 64, 4),
    "long_500k": ShapeCell("long_500k", "decode", 128, 1),
}


def cell_applicable(cfg, cell: ShapeCell) -> tuple[bool, str]:
    """(runs?, reason). long_500k only for sub-quadratic archs."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "pure full-attention arch: 524k dense KV cache infeasible and "
            "no sub-quadratic mode in the published config (DESIGN.md)"
        )
    return True, ""


class HDPCell(NamedTuple):
    name: str
    V: int           # padded to a multiple of 512 for vocab sharding
    D: int           # padded document rows
    max_len: int     # packed row length
    K: int


# Paper Table 2 corpora at published scale (D padded to 512 multiple).
HDP_CELLS = {
    "hdp-ap": HDPCell("hdp-ap", V=7168, D=2560, max_len=512, K=1000),
    "hdp-cgcbib": HDPCell("hdp-cgcbib", V=6144, D=6144, max_len=256, K=1000),
    "hdp-neurips": HDPCell("hdp-neurips", V=12800, D=1536, max_len=2048, K=1000),
    "hdp-pubmed": HDPCell("hdp-pubmed", V=90112, D=8200192, max_len=256, K=1000),
}
