"""Public wrappers around the port's kernels — the counterpart of
``repro.kernels.ops``.  ``stable_argsort`` is the stable sort's entry
point: it runs on the device of the keys (the kernels for a CUDA tensor,
the plain twins for a CPU tensor)."""

from __future__ import annotations

import torch

from .merge_sort import argsort


def stable_argsort(keys: torch.Tensor, *, num_key_bits: int = 12,
                   tile: int = 1024) -> torch.Tensor:
    """Stable argsort of (n,) integer keys in [0, 2^num_key_bits): the (n,)
    int32 order, bit-identical to ``torch.argsort(keys, stable=True)``."""
    return argsort(keys, num_key_bits=num_key_bits, tile=tile)


__all__ = ["stable_argsort"]
