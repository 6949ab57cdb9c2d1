"""--arch registry: one entry per assigned architecture.

Each ``ArchEntry`` carries the FULL published config, a REDUCED config of
the same family for CPU tests, and metadata (family, sub-quadratic
applicability).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from ..models.blocks import ModelConfig


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    config: Callable[[], ModelConfig]
    reduced: Callable[[], ModelConfig]
    sub_quadratic: bool = False    # long_500k applicability
    notes: str = ""


_REGISTRY: Dict[str, ArchEntry] = {}


def register(entry: ArchEntry) -> ArchEntry:
    _REGISTRY[entry.name] = entry
    return entry


def get(name: str) -> ArchEntry:
    if name not in _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def names() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    # only the configurations ported so far
    from . import smollm_135m  # noqa: F401
