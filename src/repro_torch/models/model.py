"""The Model facade (dense GQA, MLA, MoE, recurrent xLSTM / Mamba
stacks, image cross-attention, the whisper encoder-decoder): init /
prefill / chunked prefill / decode — the serving side of
``repro.models.model``.

Parameter and cache trees have the JAX package's layout: ``"prefix"`` (the
unrolled leading layers, deepseek's dense layer) is a list of one dict a
layer, and ``"stage"`` a list with one dict per period position whose
leaves are stacked over the period ``repeats``
(``params["stage"][p]["mixer"]["wq"]`` is (R, d, H·hd)), so weights convert
between the packages by name (``repro_torch.weights``).  An
encoder-decoder model adds ``"enc_stage"`` (one dict stacked over the
encoder layers), ``"enc_final_norm"`` and ``"dec_pos"`` (the learned
decoder positions, ``max_decoder_positions`` rows, 4096 by default).

Cross-attention models take their modality stubs as the reference's batch
dict does: ``frames`` (B, S_enc, D) for the encoder-decoder (whisper),
``image_embeds`` (B, N_img, D) for the vision model.  ``prefill`` reads
them from its ``batch`` argument; chunked prefill fills the cross K/V once
with :meth:`Model.encode_to_cache` before its first chunk.

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
from .layers import Params, embed, embedding_init
from .transformer import (SSM_KINDS, LayerSpec, check_spec, cross_kv,
                          layer_apply, layer_cache_shape, layer_decode,
                          layer_init, layer_prefill_chunk, norm, norm_init,
                          stage_layout)


def resolve_device(device) -> torch.device:
    """The device an entry point was asked for; "cuda" without a card
    raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           f"torch.cuda.is_available() is False")
    return dev


def sinusoidal_positions(seq: int, d: int, dtype: torch.dtype,
                         device=None) -> torch.Tensor:
    """(seq, d): [sin | cos] of pos / 10000^(2i/d), concatenated (not
    interleaved), computed in fp32 and cast to ``dtype``."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2.0 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _index(tree: Any, r: int) -> Any:
    """Slice repeat ``r`` out of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda", *,
                 scan_impl: str = "lax", moe_strategy: str = "einsum",
                 moe_sort_fn=None, max_decoder_positions: int = 0):
        if scan_impl not in ("lax", "pallas"):
            raise ValueError(
                f"scan_impl must be 'lax' or 'pallas', got {scan_impl!r}")
        if moe_strategy not in ("einsum", "sort"):
            raise ValueError(f"unknown MoE strategy {moe_strategy!r}")
        self.cfg = cfg
        self.scan_impl = scan_impl
        self.moe = {"strategy": moe_strategy, "sort_fn": moe_sort_fn}
        self.device = resolve_device(device)
        self.max_decoder_positions = max_decoder_positions
        self.prefix_specs, self.period_specs, self.repeats = stage_layout(cfg)
        self.enc_spec = LayerSpec("attn", False, False, True) \
            if cfg.is_encdec else None
        for s in self.prefix_specs + self.period_specs:
            check_spec(cfg, s)
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
        params["final_norm"] = norm_init(cfg, self.device)
        if self.prefix_specs:
            params["prefix"] = [layer_init(gen, cfg, s)
                                for s in self.prefix_specs]
        params["stage"] = [layer_init(gen, cfg, s, lead=(self.repeats,))
                           for s in self.period_specs]
        if cfg.is_encdec:
            params["enc_stage"] = layer_init(gen, cfg, self.enc_spec,
                                             lead=(cfg.encoder_layers,))
            params["enc_final_norm"] = norm_init(cfg, self.device)
            npos = self.max_decoder_positions or 4096
            params["dec_pos"] = torch.randn(
                (npos, cfg.d_model), generator=gen, device=self.device,
                dtype=torch.float32).mul_(0.01).to(cfg.pdtype())
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

    def _dec_pos(self, params: Params, positions: torch.Tensor, hi: int
                 ) -> torch.Tensor:
        """The learned decoder positions' rows at ``positions`` (any
        shape, none past ``hi``), in the compute dtype.  ``hi`` past the
        table raises: the reference's gather clamps it to the last row."""
        table = params["dec_pos"]
        if hi >= table.shape[0]:
            raise ValueError(f"decoder position {hi} is past the "
                             f"{table.shape[0]}-row dec_pos table "
                             f"(max_decoder_positions)")
        return table[positions.long()].to(self.cfg.dtype())

    def _encode(self, params: Params, frames: torch.Tensor) -> torch.Tensor:
        """The whisper encoder over stub frame embeddings (B,S,D): frames
        in the compute dtype plus sinusoidal positions, the encoder layers
        non-causal (RoPE at positions 0..S-1, as in the reference), then
        ``enc_final_norm``."""
        cfg = self.cfg
        B, S, D = frames.shape
        x = frames.to(cfg.dtype()) + sinusoidal_positions(
            S, D, cfg.dtype(), frames.device)
        positions = torch.arange(S, device=frames.device).expand(B, S)
        for i in range(cfg.encoder_layers):
            x, _ = layer_apply(cfg, self.enc_spec,
                               _index(params["enc_stage"], i), x, positions,
                               causal=False)
        return norm(cfg, params["enc_final_norm"], x)

    def _kv_states(self, params: Params, batch: Optional[Dict[str, Any]]
                   ) -> Optional[torch.Tensor]:
        """What cross-attention attends to: the image embeddings (vision)
        or the encoder output over ``frames`` (encoder-decoder), from the
        reference's batch dict; None for a model without cross-attention."""
        cfg = self.cfg
        if cfg.family == "vlm":
            return _require(batch, "image_embeds").to(cfg.dtype())
        if cfg.is_encdec:
            return self._encode(params, _require(batch, "frames"))
        return None

    def _logits_head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        table = params["embed" if cfg.tie_embeddings else "head"]["table"]
        logits = (x @ table.T).float()
        if cfg.vocab_padding:
            logits[..., cfg.vocab_size:] = -1e30
        return logits

    # --------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_seq: int, *,
                   cross_len: int = 0) -> Any:
        """Zero-filled cache: a 'prefix' list of dicts (batch on axis 0)
        when the model has prefix layers, and a 'stage' list of dicts
        stacked (R, ...); cross-attention layers hold ``ck`` / ``cv`` of
        ``cross_len`` positions."""
        def alloc(spec, lead):
            shapes = layer_cache_shape(self.cfg, spec, batch, max_seq,
                                       cross_len=cross_len)
            return {name: torch.zeros(lead + shape, dtype=dt,
                                      device=self.device)
                    for name, (shape, dt) in shapes.items()}

        cache: Dict[str, Any] = {}
        if self.prefix_specs:
            cache["prefix"] = [alloc(s, ()) for s in self.prefix_specs]
        cache["stage"] = [alloc(s, (self.repeats,))
                          for s in self.period_specs]
        return cache

    def prefill(self, params: Params, batch, max_seq: Optional[int] = None
                ) -> Tuple[torch.Tensor, Any]:
        """Full prompt prefill.  ``batch``: tokens (B, S), or the
        reference's dict {"tokens": (B, S)} plus the modality stub
        (``frames`` or ``image_embeds``) → (last-token logits (B, V), cache
        of width ``max_seq``, its cross K/V as long as the stub)."""
        self.calls["prefill"] += 1
        if not isinstance(batch, dict):
            batch = {"tokens": batch}
        tokens = batch["tokens"]
        B, S = tokens.shape
        max_seq = max_seq or S
        kv_states = self._kv_states(params, batch)
        cache = self.init_cache(B, max_seq, cross_len=0 if kv_states is None
                                else kv_states.shape[1])
        x = self._embed_in(params, tokens)
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        if self.cfg.is_encdec:
            x = x + self._dec_pos(params, positions[0], S - 1)
        for spec, lp, lc in self._layers(params, cache):
            x, payload = layer_apply(self.cfg, spec, lp, x, positions,
                                     kv_states=kv_states, collect_cache=True,
                                     scan_impl=self.scan_impl, moe=self.moe)
            for name, arr in payload.items():
                if name in ("k", "v", "latent"):     # by position
                    lc[name][:, :S] = arr
                else:    # recurrent state, cross K/V: whole
                    lc[name].copy_(arr)
        x = norm(self.cfg, params["final_norm"], x)
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
        if self.cfg.is_encdec:
            c = tokens.shape[1]
            x = x + self._dec_pos(params, pos0 + torch.arange(
                c, device=tokens.device), pos0 + c - 1)
        for spec, lp, lc in self._layers(params, cache):
            x = layer_prefill_chunk(self.cfg, spec, lp, x, lc, pos0,
                                    scan_impl=self.scan_impl, moe=self.moe)
        x = norm(self.cfg, params["final_norm"], x)
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
        if self.cfg.is_encdec:
            # a row's position is its length, below the cache's width while
            # the row writes: the width is held to the table on the host,
            # with no sync (a full row's position past it fails the gather)
            x = x + self._dec_pos(params, lengths,
                                  _cache_width(cache, "k") - 1)[:, None]
        cross_len = _cache_width(cache, "ck")
        cross_lengths = None if cross_len is None else torch.full(
            lengths.shape, cross_len, dtype=torch.int32,
            device=lengths.device)
        for spec, lp, lc in self._layers(params, cache):
            x = layer_decode(self.cfg, spec, lp, x, lc, lengths, lengths,
                             cross_lengths=cross_lengths, moe=self.moe)
        x = norm(self.cfg, params["final_norm"], x)
        return self._logits_head(params, x)[:, 0], cache

    def encode_to_cache(self, params: Params, batch: Dict[str, Any],
                        cache: Any) -> Any:
        """Fill the cross-attention K/V (``ck`` / ``cv``) of ``cache`` in
        place from the image embeddings or the encoder output over
        ``frames``, and return it: run once before the chunked prefill of
        a cross-attention model.  The cache's ``cross_len`` must be the
        stub's length.  A model without cross-attention returns ``cache``
        as it is."""
        kv_states = self._kv_states(params, batch)
        if kv_states is None:
            return cache
        for spec, lp, lc in self._layers(params, cache):
            if not spec.has_cross:
                continue
            for name, t in cross_kv(self.cfg, lp, kv_states).items():
                if lc[name].shape != t.shape:
                    raise ValueError(
                        f"encode_to_cache: {name} of the cache is "
                        f"{tuple(lc[name].shape)}, the stub gives "
                        f"{tuple(t.shape)} (init_cache cross_len)")
                lc[name].copy_(t)
        return cache


def _cache_width(cache: Any, name: str) -> Optional[int]:
    """Positions along ``name`` (``k`` or ``ck``) in the first layer cache
    that holds it, or None when none does."""
    for lc in cache.get("prefix", []) + cache["stage"]:
        if name in lc:
            return lc[name].shape[-3]
    return None


def _require(batch: Optional[Dict[str, Any]], key: str) -> torch.Tensor:
    if batch is None or key not in batch:
        raise ValueError(f"this model cross-attends: its batch needs "
                         f"{key!r}")
    return batch[key]


__all__ = ["Model", "resolve_device", "sinusoidal_positions"]
