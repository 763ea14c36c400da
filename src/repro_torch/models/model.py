"""The Model facade for a decoder-only LM (dense GQA, MLA, MoE, recurrent
xLSTM / Mamba stacks): init / prefill / chunked prefill / decode — the
decoder-only subset of ``repro.models.model``.

Parameter and cache trees have the JAX package's layout: ``"prefix"`` (the
unrolled leading layers, deepseek's dense layer) is a list of one dict a
layer, and ``"stage"`` a list with one dict per period position whose
leaves are stacked over the period ``repeats``
(``params["stage"][p]["mixer"]["wq"]`` is (R, d, H·hd)), so weights convert
between the packages by name (``repro_torch.weights``).

The model lives on one explicit device, ``"cuda"`` by default; only the
tests pass ``"cpu"``.  ``calls`` counts prefill, chunked-prefill and decode
calls, so a run can check each layer call launched exactly one kernel.
``scan_impl`` picks the SSM recurrence backend for full-sequence paths, as
in the reference: ``"lax"`` (the sequential chunk loop) or ``"pallas"``
(the chunk-parallel form around one K4 launch; the name is the
reference's).  ``moe_strategy`` picks the MoE dispatch, as the reference's
(``"einsum"``, GShard with capacity drops, or ``"sort"``, dropless), and
``moe_sort_fn`` is the ``sort_fn`` of the sort dispatch: ``None`` (the
reference's behaviour: ``torch.argsort(stable=True)`` plus a gather),
``"pallas"`` (K3, the sort and row gather in one kernel entry) or a stable
argsort callable.  The reference's ``Model`` has no such argument and
always routes with ``jnp.argsort``; K3 gives the same routing bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from .layers import Params, embed, embedding_init, rmsnorm, rmsnorm_init
from .transformer import (SSM_KINDS, check_ported, layer_apply,
                          layer_cache_shape, layer_decode, layer_init,
                          layer_prefill_chunk, stage_layout)


def resolve_device(device) -> torch.device:
    """The device an entry point was asked for; "cuda" without a card
    raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           f"torch.cuda.is_available() is False")
    return dev


def _index(tree: Any, r: int) -> Any:
    """Slice repeat ``r`` out of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda", *,
                 scan_impl: str = "lax", moe_strategy: str = "einsum",
                 moe_sort_fn=None):
        if scan_impl not in ("lax", "pallas"):
            raise ValueError(
                f"scan_impl must be 'lax' or 'pallas', got {scan_impl!r}")
        if moe_strategy not in ("einsum", "sort"):
            raise ValueError(f"unknown MoE strategy {moe_strategy!r}")
        self.cfg = cfg
        self.scan_impl = scan_impl
        self.moe = {"strategy": moe_strategy, "sort_fn": moe_sort_fn}
        self.device = resolve_device(device)
        self.prefix_specs, self.period_specs, self.repeats = stage_layout(cfg)
        for s in self.prefix_specs + self.period_specs:
            check_ported(cfg, s)
        self.calls = {"prefill": 0, "prefill_chunk": 0, "decode_step": 0}

    @property
    def recurrent_only(self) -> bool:
        """True when decode state is O(1) per layer (no attention KV grows
        with the sequence): serving then needs a constant page span per
        request instead of prompt + max_new cache positions."""
        return (not self.cfg.is_encdec
                and all(s.kind in SSM_KINDS and not s.has_cross
                        for s in self.prefix_specs + self.period_specs))

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0) -> Params:
        """Random weights on the model's device from ``seed`` (the JAX
        package's distributions; not its random numbers)."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params: Params = {
            "embed": embedding_init(gen, cfg.padded_vocab, cfg.d_model,
                                    cfg.pdtype()),
        }
        if not cfg.tie_embeddings:
            params["head"] = embedding_init(gen, cfg.padded_vocab,
                                            cfg.d_model, cfg.pdtype())
        params["final_norm"] = rmsnorm_init(cfg.d_model, cfg.pdtype(),
                                            self.device)
        if self.prefix_specs:
            params["prefix"] = [layer_init(gen, cfg, s)
                                for s in self.prefix_specs]
        params["stage"] = [layer_init(gen, cfg, s, lead=(self.repeats,))
                           for s in self.period_specs]
        return params

    # ------------------------------------------------------------- internals
    def _layers(self, params: Params, cache: Optional[Any] = None):
        """(spec, layer params, layer cache) in layer order: the prefix
        layers, then the stage's repeats."""
        for i, spec in enumerate(self.prefix_specs):
            yield spec, params["prefix"][i], \
                None if cache is None else cache["prefix"][i]
        for r in range(self.repeats):
            for pos, spec in enumerate(self.period_specs):
                lc = None if cache is None else \
                    _index(cache["stage"][pos], r)
                yield spec, _index(params["stage"][pos], r), lc

    def _embed_in(self, params: Params, tokens: torch.Tensor):
        return embed(params["embed"], tokens).to(self.cfg.dtype())

    def _logits_head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        table = params["embed" if cfg.tie_embeddings else "head"]["table"]
        logits = (x @ table.T).float()
        if cfg.vocab_padding:
            logits[..., cfg.vocab_size:] = -1e30
        return logits

    # --------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_seq: int) -> Any:
        """Zero-filled cache: a 'prefix' list of dicts (batch on axis 0)
        when the model has prefix layers, and a 'stage' list of dicts
        stacked (R, ...)."""
        def alloc(spec, lead):
            shapes = layer_cache_shape(self.cfg, spec, batch, max_seq)
            return {name: torch.zeros(lead + shape, dtype=dt,
                                      device=self.device)
                    for name, (shape, dt) in shapes.items()}

        cache: Dict[str, Any] = {}
        if self.prefix_specs:
            cache["prefix"] = [alloc(s, ()) for s in self.prefix_specs]
        cache["stage"] = [alloc(s, (self.repeats,))
                          for s in self.period_specs]
        return cache

    def prefill(self, params: Params, tokens: torch.Tensor,
                max_seq: Optional[int] = None) -> Tuple[torch.Tensor, Any]:
        """Full prompt prefill.  tokens (B, S) → (last-token logits (B, V),
        cache of width ``max_seq``)."""
        self.calls["prefill"] += 1
        B, S = tokens.shape
        max_seq = max_seq or S
        cache = self.init_cache(B, max_seq)
        x = self._embed_in(params, tokens)
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        for spec, lp, lc in self._layers(params, cache):
            x, payload = layer_apply(self.cfg, spec, lp, x, positions,
                                     collect_cache=True,
                                     scan_impl=self.scan_impl, moe=self.moe)
            for name, arr in payload.items():
                if name in ("k", "v", "latent"):     # by position
                    lc[name][:, :S] = arr
                else:                       # recurrent state: O(1) per row
                    lc[name].copy_(arr)
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        return self._logits_head(params, x[:, -1:])[:, 0], cache

    def prefill_chunk(self, params: Params, tokens: torch.Tensor, cache: Any,
                      pos0: int, *, all_logits: bool = False
                      ) -> Tuple[torch.Tensor, Any]:
        """One by_blocks prefill chunk: tokens (B, c) at positions
        [pos0, pos0+c).  Updates ``cache`` in place and returns it with the
        last position's logits (B, V), or the chunk's (B, c, V) with
        ``all_logits=True``."""
        self.calls["prefill_chunk"] += 1
        pos0 = int(pos0)
        x = self._embed_in(params, tokens)
        for spec, lp, lc in self._layers(params, cache):
            x = layer_prefill_chunk(self.cfg, spec, lp, x, lc, pos0,
                                    scan_impl=self.scan_impl, moe=self.moe)
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        if all_logits:
            return self._logits_head(params, x), cache
        return self._logits_head(params, x[:, -1:])[:, 0], cache

    def decode_step(self, params: Params, tokens: torch.Tensor, cache: Any,
                    lengths: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        """One token per sequence.  tokens: (B,), lengths: (B,) current
        valid prefix length.  Updates ``cache`` in place; returns (logits
        (B, vocab), cache)."""
        self.calls["decode_step"] += 1
        x = self._embed_in(params, tokens[:, None])
        for spec, lp, lc in self._layers(params, cache):
            x = layer_decode(self.cfg, spec, lp, x, lc, lengths, lengths,
                             moe=self.moe)
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        return self._logits_head(params, x)[:, 0], cache


__all__ = ["Model", "resolve_device"]
