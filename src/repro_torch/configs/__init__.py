"""Assigned architecture registry: ``get_config(arch_id)`` and, per arch,
``reduced_config()`` (CPU smoke) and the set of runnable shape cells.

Every full config matches the assignment block verbatim; deviations/notes
live in DESIGN.md §Arch-applicability.

Copied, with the ten ``<arch>.py`` files, from ``src/repro/configs/``.  Every
family's config is here, and the port's model substrate runs every family
(``repro_torch.models.transformer``).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import LONG_CONTEXT_OK, SHAPES, ModelConfig, ShapeConfig

ARCH_IDS = [
    "llama3_2_1b",
    "granite_34b",
    "tinyllama_1_1b",
    "qwen2_5_14b",
    "qwen3_moe_30b_a3b",
    "deepseek_v2_lite_16b",
    "zamba2_1_2b",
    "whisper_medium",
    "internvl2_76b",
    "mamba2_1_3b",
]

def _module(arch: str):
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f".{arch}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_reduced_config(arch: str) -> ModelConfig:
    return _module(arch).reduced_config()


def shape_cells(arch: str) -> List[ShapeConfig]:
    """The shape cells this arch runs (skips per DESIGN.md noted here)."""
    cfg = get_config(arch)
    cells = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.name in LONG_CONTEXT_OK:
        cells.append(SHAPES["long_500k"])
    return cells


def all_cells():
    for arch in ARCH_IDS:
        for shape in shape_cells(arch):
            yield arch, shape
