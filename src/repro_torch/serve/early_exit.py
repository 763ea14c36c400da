"""Early-exit decoding — ``find_first`` (paper §4.1) as EOS detection, the
counterpart of ``repro.serve.early_exit``.

``make_decode_block`` runs n decode steps per call; finished sequences keep
stepping until their block ends (the waste is counted and reported).
``make_decode_tick`` is the continuous-batching variant with per-slot
budgets, and ``make_gated_decode_tick`` adds the entropy gate.  The steps
stay on the device: the host reads results only at block ends.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from ..core import geometric_blocks
from ..models.model import Model


@dataclasses.dataclass
class DecodeStats:
    blocks: int = 0
    steps_run: int = 0            # decode steps executed (per sequence)
    useful_tokens: int = 0        # tokens up to & including EOS
    wasted_tokens: int = 0        # tokens decoded past EOS
    all_finished: bool = False
    early_exit: bool = False      # retired by the entropy gate, not EOS

    @property
    def wasted_fraction(self) -> float:
        total = self.useful_tokens + self.wasted_tokens
        return self.wasted_tokens / total if total else 0.0


def _greedy(model: Model, logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, :model.cfg.vocab_size],
                        dim=-1).to(torch.int32)


def make_decode_block(model: Model, eos_id: int):
    """Returns fn(params, tokens, cache, lengths, finished, n) →
    (tokens, cache, lengths, finished, out_block (B,n), wasted (B,))."""

    def block(params, tokens, cache, lengths, finished, n: int):
        B = tokens.shape[0]
        out = torch.full((B, n), -1, dtype=torch.int32, device=tokens.device)
        wasted = torch.zeros((B,), dtype=torch.int32, device=tokens.device)
        for i in range(n):
            logits, cache = model.decode_step(params, tokens, cache, lengths)
            nxt = _greedy(model, logits)
            wasted = wasted + finished.to(torch.int32)
            out[:, i] = torch.where(finished, -1, nxt)
            finished = finished | (nxt == eos_id)
            lengths = lengths + 1
            tokens = nxt
        return tokens, cache, lengths, finished, out, wasted

    return block


def make_decode_tick(model: Model, eos_id: int):
    """Decode tick for the continuous-batching engine: each slot carries
    ``remaining`` (its per-request ``max_new`` budget), so rows retire
    independently on EOS or budget exhaustion.

    Returns fn(params, tokens, cache, lengths, finished, remaining, n) →
    (tokens, cache, lengths, finished, remaining, out (B, n), wasted (B,)).
    Emitted tokens for already-finished rows (or empty slots) are -1;
    ``lengths`` advances only for live rows, so slot KV stays aligned.
    """

    def tick(params, tokens, cache, lengths, finished, remaining, n: int):
        B = tokens.shape[0]
        out = torch.full((B, n), -1, dtype=torch.int32, device=tokens.device)
        wasted = torch.zeros((B,), dtype=torch.int32, device=tokens.device)
        for i in range(n):
            live = ~finished
            logits, cache = model.decode_step(params, tokens, cache, lengths)
            nxt = _greedy(model, logits)
            wasted = wasted + finished.to(torch.int32)
            out[:, i] = torch.where(finished, -1, nxt)
            remaining = remaining - live.to(torch.int32)
            finished = finished | (nxt == eos_id) | (remaining <= 0)
            lengths = lengths + live.to(torch.int32)
            tokens = torch.where(live, nxt, tokens)
        return tokens, cache, lengths, finished, remaining, out, wasted

    return tick


def make_gated_decode_tick(model: Model, eos_id: int, *, tau: float,
                           patience: int = 2):
    """Uncertainty-gated decode tick: EOS retirement plus an entropy gate.

    A lane whose predictive entropy stays below ``tau`` nats for
    ``patience`` consecutive live steps retires early, so its lane (and its
    state slot) backfills from the queue.  Gating only stops emission:
    every token emitted before the gate fires is the greedy token the
    ungated tick produces, so a gated stream is an exact prefix of the
    ungated one.

    Returns fn(params, tokens, cache, lengths, finished, remaining, streak,
    n) → (tokens, cache, lengths, finished, remaining, streak, gated,
    out (B, n), wasted (B,)).
    """
    V = model.cfg.vocab_size

    def tick(params, tokens, cache, lengths, finished, remaining, streak,
             n: int):
        B = tokens.shape[0]
        dev = tokens.device
        out = torch.full((B, n), -1, dtype=torch.int32, device=dev)
        wasted = torch.zeros((B,), dtype=torch.int32, device=dev)
        gated = torch.zeros((B,), dtype=torch.bool, device=dev)
        for i in range(n):
            live = ~finished
            logits, cache = model.decode_step(params, tokens, cache, lengths)
            lg = logits[:, :V]
            p = torch.softmax(lg, dim=-1)
            ent = -torch.sum(p * torch.log(p + 1e-9), dim=-1)   # (B,) nats
            nxt = torch.argmax(lg, dim=-1).to(torch.int32)
            wasted = wasted + finished.to(torch.int32)
            out[:, i] = torch.where(finished, -1, nxt)
            remaining = remaining - live.to(torch.int32)
            streak = torch.where(live & (ent < tau), streak + 1, 0)
            gate = live & (streak >= patience)
            finished = finished | (nxt == eos_id) | (remaining <= 0) | gate
            gated = gated | gate
            lengths = lengths + live.to(torch.int32)
            tokens = torch.where(live, nxt, tokens)
        return (tokens, cache, lengths, finished, remaining, streak, gated,
                out, wasted)

    return tick


def decode_until_eos(model: Model, params: Any, first_tokens: torch.Tensor,
                     cache: Any, lengths: torch.Tensor, *, eos_id: int,
                     max_new: int = 256, use_blocks: bool = True,
                     first_block: Optional[int] = None,
                     growth: float = 2.0, blockfn: Optional[Callable] = None
                     ) -> Tuple[torch.Tensor, Any, DecodeStats]:
    """Greedy-decode until every sequence hits EOS (or max_new), in
    by_blocks blocks with a host check between them.  use_blocks=False is
    the naive schedule (one block of max_new)."""
    B = first_tokens.shape[0]
    stats = DecodeStats()
    if blockfn is None:
        blockfn = make_decode_block(model, eos_id)
    tokens = first_tokens
    finished = tokens == eos_id
    outs = []
    bounds = (geometric_blocks(max_new, first=first_block or max(8, B // 4),
                               growth=growth)
              if use_blocks else [(0, max_new)])
    wasted_total = 0
    for (lo, hi) in bounds:
        n = hi - lo
        tokens, cache, lengths, finished, out, wasted = blockfn(
            params, tokens, cache, lengths, finished, n)
        outs.append(out)
        stats.blocks += 1
        stats.steps_run += n
        wasted_total += int(wasted.sum())
        if bool(finished.all()):
            stats.all_finished = True
            break
    gen = torch.cat(outs, dim=1)
    useful = int((gen >= 0).sum())
    stats.useful_tokens = useful
    stats.wasted_tokens = wasted_total
    if wasted_total != stats.steps_run * B - useful:
        raise RuntimeError(f"waste accounting broke: {wasted_total} != "
                           f"{stats.steps_run}*{B} - {useful}")
    return gen, cache, stats


__all__ = ["decode_until_eos", "make_decode_block", "make_decode_tick",
           "make_gated_decode_tick", "DecodeStats"]
