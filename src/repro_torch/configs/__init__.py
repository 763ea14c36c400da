"""Architecture configs for the port: the schema plus the ported archs."""

from .base import ModelConfig, torch_dtype

__all__ = ["ModelConfig", "torch_dtype"]
