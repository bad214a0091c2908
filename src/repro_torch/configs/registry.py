"""Architecture registry: ``--arch <id>`` resolution.

Every architecture registers a full-size :class:`ModelConfig`, a reduced
smoke-test config of the same family, and its default
:class:`ParallelConfig` for each shape kind (the reference's values; the
sharding fields are inert on one device).

The port registers the architectures its slices serve: the dense
llama3.2-1b, granite-8b, mistral-nemo-12b and minitron-4b, the MoE
moonshot-v1-16b-a3b and deepseek-v2-236b, the SSM mamba2-2.7b, the
hybrid zamba2-1.2b, the VLM llama-3.2-vision-90b, the encoder
hubert-xlarge and the paper's own resnet50 / resnet101 / resnet152: every
architecture the reference registers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import (LRDConfig, ModelConfig, ParallelConfig,
                                      RunConfig)

_REGISTRY: dict[str, "ArchEntry"] = {}


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    name: str
    full: ModelConfig
    smoke: ModelConfig
    parallel: Callable[[str], ParallelConfig]  # shape kind -> ParallelConfig
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


def names() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def assigned_names() -> list[str]:
    """The 10 assigned LM-family architectures (without the ResNets)."""
    _ensure_loaded()
    return [n for n in sorted(_REGISTRY) if not n.startswith("resnet")]


def run_config(name: str, shape_kind: str = "train",
               lrd: LRDConfig | None = None) -> RunConfig:
    e = get(name)
    return RunConfig(model=e.full, parallel=e.parallel(shape_kind),
                     lrd=lrd or LRDConfig())


def _ensure_loaded() -> None:
    # Importing the modules runs their register() calls (once: a second
    # import of a module is a no-op).
    from repro_torch.configs import deepseek_v2_236b  # noqa: F401
    from repro_torch.configs import granite_8b  # noqa: F401
    from repro_torch.configs import hubert_xlarge  # noqa: F401
    from repro_torch.configs import llama3_2_1b  # noqa: F401
    from repro_torch.configs import llama_3_2_vision_90b  # noqa: F401
    from repro_torch.configs import mamba2_2_7b  # noqa: F401
    from repro_torch.configs import minitron_4b  # noqa: F401
    from repro_torch.configs import mistral_nemo_12b  # noqa: F401
    from repro_torch.configs import moonshot_v1_16b_a3b  # noqa: F401
    from repro_torch.configs import resnet  # noqa: F401
    from repro_torch.configs import zamba2_1_2b  # noqa: F401
