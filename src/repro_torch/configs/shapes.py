"""Assigned input-shape suites and the (arch x shape) cell matrix.

LM transformer shapes are seq_len x global_batch. ``decode_*`` / ``long_*``
lower ``serve_step`` (one new token against a KV cache of seq_len), NOT
``train_step``. ``long_500k`` requires sub-quadratic attention; encoder-only
archs have no decode step. Skips are recorded here so the dry-run matrix and
DESIGN.md stay consistent.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class ShapeSuite:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSuite("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSuite("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSuite("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSuite("long_500k", "decode", 524_288, 1),
}


def cell_skip_reason(cfg: ModelConfig, shape: ShapeSuite) -> Optional[str]:
    """None if the (arch, shape) cell runs; otherwise the documented skip."""
    if shape.kind == "decode" and cfg.is_encoder_only:
        return "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "long_500k needs sub-quadratic attention (pure/partial full-attn arch)"
    return None


def runnable_cells(configs) -> list:
    """All runnable (arch_id, shape_name) pairs, in deterministic order."""
    cells = []
    for arch_id, cfg in configs.items():
        for shape_name, shape in SHAPES.items():
            if cell_skip_reason(cfg, shape) is None:
                cells.append((arch_id, shape_name))
    return cells
