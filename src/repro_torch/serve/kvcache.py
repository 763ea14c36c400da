"""KV-cache utilities: byte accounting, the page table, slot insertion —
the counterpart of ``repro.serve.kvcache``.  The mesh-sharded
``alloc_cache`` comes with the ``dist`` port."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch

from ..models.model import Model
from ..models.transformer import layer_cache_shape


def cache_bytes(model: Model, batch: int, max_seq: int, *,
                cross_len: int = 0) -> int:
    """Total cache bytes for (batch, max_seq) — admission-control
    arithmetic: the prefix layers' caches once, the stage's ``repeats``
    times, cross-attention K/V of ``cross_len`` positions."""
    total = 0
    for specs, n in ((model.prefix_specs, 1),
                     (model.period_specs, model.repeats)):
        for spec in specs:
            for shape, dt in layer_cache_shape(
                    model.cfg, spec, batch, max_seq,
                    cross_len=cross_len).values():
                itemsize = torch.empty((), dtype=dt).element_size()
                total += n * math.prod(shape) * itemsize
    return total


@dataclasses.dataclass
class PageTable:
    """Fixed-size page accounting for cache reuse across requests.

    Pages are aligned to the prefill chunk alignment so a by_blocks chunk
    never straddles an unallocated page.
    """

    page_size: int
    num_pages: int

    def __post_init__(self):
        self.free: List[int] = list(range(self.num_pages))
        self.owner: Dict[int, List[int]] = {}

    def pages_needed(self, seq_len: int) -> int:
        return -(-seq_len // self.page_size)

    def allocate(self, rid: int, seq_len: int) -> Optional[List[int]]:
        n = self.pages_needed(seq_len)
        if len(self.free) < n:
            return None
        pages = [self.free.pop() for _ in range(n)]
        self.owner[rid] = pages
        return pages

    def extend(self, rid: int, new_seq_len: int) -> bool:
        have = len(self.owner.get(rid, []))
        need = self.pages_needed(new_seq_len)
        while have < need:
            if not self.free:
                return False
            self.owner[rid].append(self.free.pop())
            have += 1
        return True

    def release(self, rid: int) -> None:
        self.free.extend(self.owner.pop(rid, []))

    @property
    def utilization(self) -> float:
        return 1.0 - len(self.free) / self.num_pages


def cache_slot_insert(big: Any, small: Any, slot: int) -> Any:
    """Copy a batch=1 cache into row ``slot`` of a batched cache, in place
    (one row copy instead of a new batched cache), and return ``big``.

    Both caches share the ``Model.init_cache`` layout and width: 'prefix'
    leaves carry batch on axis 0, 'stage' leaves are stacked over repeats
    and carry batch on axis 1.  The whole slot row is overwritten, so stale
    state a previous occupant left behind is erased.
    """
    for layer, s in zip(big.get("prefix", []), small.get("prefix", [])):
        for k, b in layer.items():
            b[slot].copy_(s[k][0])
    for layer, s in zip(big["stage"], small["stage"]):
        for k, b in layer.items():
            b[:, slot].copy_(s[k][:, 0])
    return big


__all__ = ["cache_bytes", "PageTable", "cache_slot_insert"]
