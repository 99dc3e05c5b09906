"""Architecture registry of the port: ``get_config(arch)`` resolves here.

Holds only the configurations ported so far (the JAX package's
``src/repro/configs`` has the full zoo; the rest waits for ROADMAP M12).
"""
from __future__ import annotations

from typing import Dict

from ..models.config import ModelConfig

from . import stablelm_1_6b

_MODULES = {
    "stablelm-1.6b": stablelm_1_6b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    try:
        return _MODULES[arch].config()
    except KeyError as e:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}") from e


def all_configs() -> Dict[str, ModelConfig]:
    return {k: m.config() for k, m in _MODULES.items()}
