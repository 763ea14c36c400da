"""Architecture registry: ``--arch <id>`` → config module.

Lists the architectures the port can run.  ``NOT_PORTED`` names, for an
id whose full config the port cannot run yet, the ROADMAP item that will:
``get_config`` raises for it, naming that item, and ``get_smoke_config``
still returns its smoke config where the port runs that (jamba's).
"""

from __future__ import annotations

from typing import List

from . import (chatglm3_6b, deepseek_v2_lite, jamba_1_5_large,
               llama32_vision_11b, llama3_8b, llama4_scout_17b, minitron_4b,
               whisper_medium, xlstm_1_3b, yi_9b)
from .base import ModelConfig

_MODULES = {
    "llama3-8b": llama3_8b,
    "llama4-scout-17b-a16e": llama4_scout_17b,
    "xlstm-1.3b": xlstm_1_3b,
    "yi-9b": yi_9b,
    "chatglm3-6b": chatglm3_6b,
    "minitron-4b": minitron_4b,
    "deepseek-v2-lite-16b": deepseek_v2_lite,
    "whisper-medium": whisper_medium,
    "llama-3.2-vision-11b": llama32_vision_11b,
}

# arch id → the ROADMAP.md item that ports what its full config needs
NOT_PORTED = {
    "jamba-1.5-large-398b": "Queue 1 item 15 (its full-width MoE layers, "
                            "19.3 GB each in bf16, need more than one "
                            "card; its smoke config is served)",
}
_SMOKE_ONLY = {"jamba-1.5-large-398b": jamba_1_5_large}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"{arch} is not ported to repro_torch yet; see ROADMAP.md "
            f"{NOT_PORTED[arch]}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return _MODULES[arch].CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    module = _MODULES.get(arch) or _SMOKE_ONLY.get(arch)
    if module is None:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return module.smoke_config()


__all__ = ["ARCH_IDS", "NOT_PORTED", "get_config", "get_smoke_config"]
