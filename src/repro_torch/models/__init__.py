"""Model definitions of the port: dense GQA decoder-only LMs."""

from .model import Model

__all__ = ["Model"]
