"""Chunked prefill — the by_blocks scheduler (paper §3.5) on the serving
path, the counterpart of ``repro.serve.prefill``.

A long prompt is processed as a sequence of blocks of geometrically growing
size; between blocks the host regains control — the interruption point for
cancellation and preemption.  O(log S) blocks; wasted work on interruption
bounded by growth/(1+growth).  PyTorch runs eagerly, so there is no
per-chunk-length compilation to bound: the block start is a plain int.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..core import ByBlocks, SeqWork
from ..models.model import Model


@dataclasses.dataclass
class PrefillStats:
    blocks: int = 0
    tokens: int = 0
    cancelled: bool = False
    preempted: bool = False       # budget exhausted at a block boundary
    next_start: int = 0           # resume offset (valid when preempted)
    last_block: int = 0           # size of the last block that ran


class ChunkedPrefill:
    def __init__(self, model: Model, *, first_block: int = 128,
                 growth: float = 2.0, align: int = 128,
                 max_block: Optional[int] = 4096):
        self.model = model
        self.policy = ByBlocks(first=first_block, growth=growth, align=align,
                               cap=max_block)

    def run(self, params: Any, tokens: torch.Tensor, cache: Any, *,
            batch: Optional[Dict[str, torch.Tensor]] = None,
            should_cancel: Callable[[], bool] = lambda: False,
            start: int = 0, max_blocks: Optional[int] = None,
            row_lengths: Optional[Sequence[int]] = None,
            gathered: Optional[torch.Tensor] = None
            ) -> Tuple[Optional[torch.Tensor], Any, PrefillStats]:
        """tokens: (B, S).  Returns (logits | None-if-cancelled, cache,
        stats); the cache is updated in place.  ``batch`` carries the
        modality stub of a cross-attention model (``frames`` or
        ``image_embeds``): at ``start == 0`` its cross K/V are filled into
        the cache first (:meth:`Model.encode_to_cache`).

        Without ``row_lengths`` the logits are the last *padded* position's
        (B, V).  With ``row_lengths`` (true per-row prompt lengths) each
        chunk computes all-position logits and each row's last *real*
        position is gathered as it streams past; ``gathered`` carries the
        partial gather across a preemption.  ``start`` resumes a preempted
        prefill (the cache holds positions < start); ``max_blocks`` bounds
        the blocks run in this call, and ``stats.next_start`` says where the
        residual begins."""
        B, S = tokens.shape
        if batch is not None and start == 0:
            cache = self.model.encode_to_cache(params, batch, cache)
        stats = PrefillStats()
        logits = gathered
        sel = None
        if row_lengths is not None:
            sel = torch.as_tensor(list(row_lengths), dtype=torch.int64,
                                  device=tokens.device) - 1
            rows = torch.arange(B, device=tokens.device)
        for blk in self.policy.blocks(SeqWork(start, S)):
            c = blk.size()
            out, cache = self.model.prefill_chunk(
                params, tokens[:, blk.start:blk.stop], cache, blk.start,
                all_logits=sel is not None)
            if sel is None:
                logits = out
            else:
                local = torch.clamp(sel - blk.start, 0, c - 1)
                hit = ((sel >= blk.start) & (sel < blk.stop))[:, None]
                picked = out[rows, local]                     # (B, V)
                prev = torch.zeros_like(picked) if logits is None else logits
                logits = torch.where(hit, picked, prev)
            stats.blocks += 1
            stats.tokens += c
            stats.last_block = c
            if should_cancel():
                stats.cancelled = True
                return None, cache, stats
            if (max_blocks is not None and stats.blocks >= max_blocks
                    and blk.stop < S):
                stats.preempted = True
                stats.next_start = blk.stop
                return logits, cache, stats
        return logits, cache, stats


__all__ = ["ChunkedPrefill", "PrefillStats"]
