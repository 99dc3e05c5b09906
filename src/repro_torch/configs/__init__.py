"""Architecture registry of the port: ``get_config(arch)`` resolves here.

A copy of the JAX package's ``src/repro/configs`` (the port imports nothing
of it): each module carries the published spec (cited in its docstring)
and a reduced ``smoke()`` variant for CPU tests.  Every config loads;
building mamba2-130m raises naming ROADMAP M12b and whisper-large-v3
naming M12c.
"""
from __future__ import annotations

from typing import Dict

from ..models.config import ModelConfig

from . import (deepseek_v2_236b, gemma3_4b, granite_20b, internvl2_76b,
               mamba2_130m, mixtral_8x22b, qwen1_5_110b, recurrentgemma_9b,
               stablelm_1_6b, whisper_large_v3)

_MODULES = {
    "qwen1.5-110b": qwen1_5_110b,
    "internvl2-76b": internvl2_76b,
    "granite-20b": granite_20b,
    "gemma3-4b": gemma3_4b,
    "deepseek-v2-236b": deepseek_v2_236b,
    "stablelm-1.6b": stablelm_1_6b,
    "whisper-large-v3": whisper_large_v3,
    "mixtral-8x22b": mixtral_8x22b,
    "mamba2-130m": mamba2_130m,
    "recurrentgemma-9b": recurrentgemma_9b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    try:
        return _MODULES[arch].config()
    except KeyError as e:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}") from e


def all_configs() -> Dict[str, ModelConfig]:
    return {k: m.config() for k, m in _MODULES.items()}
