"""Architecture registry: name -> full-size and smoke-test configs.

The port registers only the architectures its slices serve; the others
come with ROADMAP item A13.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

_REGISTRY: dict[str, "ArchEntry"] = {}


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    name: str
    full: ModelConfig
    smoke: ModelConfig
    notes: str = ""


def register(entry: ArchEntry) -> ArchEntry:
    if entry.name in _REGISTRY:
        raise ValueError(f"duplicate arch {entry.name}")
    _REGISTRY[entry.name] = entry
    return entry


def get(name: str) -> ArchEntry:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; known: {sorted(_REGISTRY)}") from None


def _ensure_loaded() -> None:
    # Importing the modules runs their register() calls (once: a second
    # import of a module is a no-op).
    from repro_torch.configs import llama3_2_1b  # noqa: F401
