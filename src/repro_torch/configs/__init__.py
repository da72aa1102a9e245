"""Config registry: ``get_config(name)`` / ``get_config(name + ':smoke')``."""
from __future__ import annotations

from repro_torch.configs.archs import ARCHS, smoke_config
from repro_torch.configs.base import (SHAPES, ModelConfig,  # noqa: F401
                                      ShapeCell, cell_applicable)


def get_config(name: str) -> ModelConfig:
    smoke = False
    if name.endswith(":smoke"):
        name, smoke = name[: -len(":smoke")], True
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(ARCHS)}")
    cfg = ARCHS[name]
    return smoke_config(cfg) if smoke else cfg


def list_archs():
    return sorted(ARCHS)
