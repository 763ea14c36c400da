"""Architecture registry: ``--arch <id>`` → config module.

Lists only the architectures the port can run.  The JAX package's other
ids are known here so that asking for one names the ROADMAP item that will
port it instead of reading as a typo.
"""

from __future__ import annotations

from typing import List

from . import (chatglm3_6b, deepseek_v2_lite, llama3_8b, llama4_scout_17b,
               minitron_4b, xlstm_1_3b, yi_9b)
from .base import ModelConfig

_MODULES = {
    "llama3-8b": llama3_8b,
    "llama4-scout-17b-a16e": llama4_scout_17b,
    "xlstm-1.3b": xlstm_1_3b,
    "yi-9b": yi_9b,
    "chatglm3-6b": chatglm3_6b,
    "minitron-4b": minitron_4b,
    "deepseek-v2-lite-16b": deepseek_v2_lite,
}

# arch id → the ROADMAP.md item that ports what it needs
NOT_PORTED = {
    "whisper-medium": "Queue 1 item 8 (encoder-decoder attention)",
    "llama-3.2-vision-11b": "Queue 1 item 8 (cross-attention)",
    "jamba-1.5-large-398b": "Queue 1 item 15 (its full-width MoE layers, "
                            "19.3 GB each in bf16, need more than one "
                            "card; its Mamba and MoE layers are ported)",
}

ARCH_IDS: List[str] = list(_MODULES)


def _module(arch: str):
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"{arch} is not ported to repro_torch yet; see ROADMAP.md "
            f"{NOT_PORTED[arch]}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return _MODULES[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


__all__ = ["ARCH_IDS", "NOT_PORTED", "get_config", "get_smoke_config"]
