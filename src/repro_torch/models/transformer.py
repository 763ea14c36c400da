"""Layer specs, periods and the layers — GQA and MLA attention, Mamba,
mLSTM and sLSTM, an optional cross-attention sublayer (vision's every 5th
layer, every whisper decoder layer), a dense (SwiGLU, relu² or GELU) or
MoE FFN, RMSNorm or LayerNorm as ``cfg.norm`` says — the counterpart of
``repro.models.transformer``.

Layers are grouped into *periods* (the smallest repeating unit of specs) and
parameters are stacked over period repeats, as in the JAX package, so a
weight tree converts between the two packages by name alone.  A Python loop
over repeats takes the place of ``lax.scan``.

Caches are updated in place: the prefill chunk writes its K/V (MLA: its
latent payload) into the cache slice, and the decode step writes the new
token's at each row's length (rows already at the cache width write
nothing, the JAX package's mask-select semantics).  Recurrent layers
overwrite their O(1) state.  A cross-attention layer's cache holds the
projected keys and values of the encoder output / image embeddings
(``ck``, ``cv``, written whole once); chunks attend to them through K1 and
decode steps through K2 at their full length, non-causal.  The JAX
versions return new arrays instead.
MLA scores chunks and decode steps in the absorbed form, against the
latent cache (plain einsums, as in the reference), and full sequences
through K1 at q/k head dim nd + rd, v head dim vd.

An MoE layer runs ``moe_apply`` with the caller's ``moe`` options
(``strategy``, ``sort_fn``) and the reference's ``group_size``: 256 in a
full-sequence pass, ``min(256, B)`` in a decode step and ``min(256, c)``
in a prefill chunk.  The auxiliary loss is dropped: nothing here trains.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from .attention import (attn_chunk_sizes, blockwise_attention,
                        cross_attention, decode_attention, gqa_init,
                        gqa_project_kv, gqa_project_qkv, gqa_self_attention,
                        mla_absorbed, mla_cache_payload, mla_decode,
                        mla_init, mla_queries, mla_self_attention,
                        plain_attention)
from .layers import (Params, gelu_mlp, gelu_mlp_init, layernorm,
                     layernorm_init, rmsnorm, rmsnorm_init, rope_table,
                     swiglu, swiglu_init)
from .moe import moe_apply, moe_init
from .ssm import (mamba_forward, mamba_init, mamba_step, mlstm_forward,
                  mlstm_init, mlstm_step, slstm_forward, slstm_init,
                  slstm_step)

SSM_KINDS = ("mamba", "mlstm", "slstm")
FFN_TYPES = ("swiglu", "relu2", "gelu")
NORMS = {"rmsnorm": (rmsnorm_init, rmsnorm),
         "layernorm": (layernorm_init, layernorm)}
_MIXER_INIT = {"attn": gqa_init, "mla": mla_init, "mamba": mamba_init,
               "mlstm": mlstm_init, "slstm": slstm_init}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str          # attn | mla | mamba | mlstm | slstm
    is_moe: bool
    has_cross: bool
    has_ffn: bool


def layer_specs(cfg: ModelConfig) -> List[LayerSpec]:
    specs = []
    for i in range(cfg.num_layers):
        kind = cfg.layer_kind(i)
        if kind == "attn" and cfg.attn_type == "mla":
            kind = "mla"
        has_cross = bool(cfg.cross_attn_period) and \
            (i % cfg.cross_attn_period == cfg.cross_attn_period - 1)
        has_ffn = cfg.d_ff > 0 or (cfg.is_moe and cfg.layer_is_moe(i))
        specs.append(LayerSpec(kind, cfg.layer_is_moe(i), has_cross, has_ffn))
    return specs


def stage_layout(cfg: ModelConfig
                 ) -> Tuple[List[LayerSpec], List[LayerSpec], int]:
    """Returns (prefix_specs, period_specs, n_repeats)."""
    specs = layer_specs(cfg)
    pre = cfg.first_dense_layers
    prefix, rest = specs[:pre], specs[pre:]
    for p in range(1, len(rest) + 1):
        if len(rest) % p != 0:
            continue
        if all(rest[i] == rest[i % p] for i in range(len(rest))):
            return prefix, rest[:p], len(rest) // p
    return prefix, rest, 1


def check_spec(cfg: ModelConfig, spec: LayerSpec) -> None:
    """Raise for a layer kind, norm or FFN type neither package has."""
    if spec.kind not in _MIXER_INIT:
        raise ValueError(f"unknown layer kind {spec.kind!r}")
    if cfg.norm not in NORMS:
        raise ValueError(f"unknown norm {cfg.norm!r}")
    if spec.has_ffn and not spec.is_moe and cfg.ffn_type not in FFN_TYPES:
        raise ValueError(f"unknown FFN type {cfg.ffn_type!r}")


def norm_init(cfg: ModelConfig, device, *,
              lead: Tuple[int, ...] = ()) -> Params:
    """``cfg.norm``'s parameters (RMSNorm: scale; LayerNorm: scale, bias)."""
    return NORMS[cfg.norm][0](cfg.d_model, cfg.pdtype(), device, lead=lead)


def norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return NORMS[cfg.norm][1](p, x, cfg.norm_eps)


def layer_init(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec, *,
               lead: Tuple[int, ...] = ()) -> Params:
    """One layer's parameters, stacked over ``lead`` (the period repeats)."""
    check_spec(cfg, spec)
    dev = gen.device
    p: Params = {"ln1": norm_init(cfg, dev, lead=lead),
                 "mixer": _MIXER_INIT[spec.kind](gen, cfg, lead=lead)}
    if spec.has_cross:
        p["ln_cross"] = norm_init(cfg, dev, lead=lead)
        p["cross"] = gqa_init(gen, cfg, lead=lead, cross=True)
    if spec.has_ffn:
        p["ln2"] = norm_init(cfg, dev, lead=lead)
        if spec.is_moe:
            p["moe"] = moe_init(gen, cfg, lead=lead)
        else:
            p["ffn"] = _ffn_init(gen, cfg, cfg.dense_ffn_dim, lead=lead)
    return p


def _ffn_init(gen: torch.Generator, cfg: ModelConfig, d_ff: int, *,
              lead: Tuple[int, ...] = ()) -> Params:
    if cfg.ffn_type == "swiglu":
        return swiglu_init(gen, cfg.d_model, d_ff, cfg.pdtype(), lead=lead)
    return gelu_mlp_init(gen, cfg.d_model, d_ff, cfg.pdtype(), lead=lead)


def _ffn_apply(cfg: ModelConfig, params: Params, x: torch.Tensor
               ) -> torch.Tensor:
    """The dense FFN: SwiGLU, relu² (relu(x·up + up_b)²·down + down_b,
    minitron's) or GELU (whisper's)."""
    if cfg.ffn_type == "swiglu":
        return swiglu(params, x)
    if cfg.ffn_type == "relu2":
        h = torch.relu(x @ params["up"] + params["up_b"]).square()
        return h @ params["down"] + params["down_b"]
    return gelu_mlp(params, x)


def _ffn(cfg: ModelConfig, spec: LayerSpec, lp: Params, x: torch.Tensor,
         moe: Optional[Dict[str, Any]], group_size: int) -> torch.Tensor:
    """x + the layer's FFN (dense, or MoE with the ``moe`` options
    ``strategy`` and ``sort_fn``)."""
    if not spec.has_ffn:
        return x
    h = norm(cfg, lp["ln2"], x)
    if spec.is_moe:
        y, _ = moe_apply(lp["moe"], cfg, h, group_size=group_size,
                         **(moe or {}))
        return x + y
    return x + _ffn_apply(cfg, lp["ffn"], h)


def _ssm_forward(cfg: ModelConfig, spec: LayerSpec, lp: Params,
                 h: torch.Tensor, state, scan_impl: str):
    """The recurrent mixer over a sequence, entering ``state`` (None: zero
    state).  Returns (mix, new state)."""
    if spec.kind == "mamba":
        return mamba_forward(
            lp["mixer"], cfg, h, scan_impl=scan_impl,
            h0=None if state is None else state["ssm"],
            conv_buf=None if state is None else state["conv"])
    if spec.kind == "mlstm":
        return mlstm_forward(lp["mixer"], cfg, h, state=state,
                             scan_impl=scan_impl)
    return slstm_forward(lp["mixer"], cfg, h, state=state)


def cross_kv(cfg: ModelConfig, lp: Params, kv_states: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
    """The cross-attention cache payload: kv_states (B,Skv,D) projected
    by the layer's ``cross`` wk and wv to (B,Skv,KV,hd)."""
    B, Skv, _ = kv_states.shape
    shape = (B, Skv, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"ck": (kv_states @ lp["cross"]["wk"]).reshape(shape),
            "cv": (kv_states @ lp["cross"]["wv"]).reshape(shape)}


def _cross_query(cfg: ModelConfig, lp: Params, x: torch.Tensor
                 ) -> torch.Tensor:
    """The cross sublayer's queries (B,S,H,hd), from the ``ln_cross``
    norm of x (B,S,D): no RoPE."""
    B, S, _ = x.shape
    hc = norm(cfg, lp["ln_cross"], x)
    return (hc @ lp["cross"]["wq"]).reshape(B, S, cfg.num_heads,
                                            cfg.resolved_head_dim)


def layer_apply(cfg: ModelConfig, spec: LayerSpec, lp: Params,
                x: torch.Tensor, positions: torch.Tensor, *,
                causal: bool = True,
                kv_states: Optional[torch.Tensor] = None,
                collect_cache: bool = False, scan_impl: str = "lax",
                moe: Optional[Dict[str, Any]] = None):
    """Full-sequence layer (prefill, and the encoder with ``causal``
    False).  A cross-attention layer attends to ``kv_states`` (B,Skv,D)
    and, with ``collect_cache``, adds their projections ``ck`` / ``cv`` to
    the payload.  Returns (x, cache payload or None)."""
    h = norm(cfg, lp["ln1"], x)
    payload = None
    if spec.kind in SSM_KINDS:
        mix, st = _ssm_forward(cfg, spec, lp, h, None, scan_impl)
        x = x + mix
        if collect_cache:
            payload = st
    elif spec.kind == "mla":
        x = x + mla_self_attention(lp["mixer"], cfg, h, positions,
                                   causal=causal)
        if collect_cache:
            payload = {"latent": mla_cache_payload(lp["mixer"], cfg, h,
                                                   positions)}
    else:
        x = x + gqa_self_attention(lp["mixer"], cfg, h, positions,
                                   causal=causal)
        if collect_cache:
            k, v = gqa_project_kv(lp["mixer"], cfg, h, positions)
            payload = {"k": k, "v": v}
    if spec.has_cross:
        if kv_states is None:
            raise ValueError("a cross-attention layer needs kv_states")
        hc = norm(cfg, lp["ln_cross"], x)
        x = x + cross_attention(lp["cross"], cfg, hc, kv_states)
        if collect_cache:
            payload = {**(payload or {}), **cross_kv(cfg, lp, kv_states)}
    return _ffn(cfg, spec, lp, x, moe, 256), payload


_STEPS = {"mamba": mamba_step, "mlstm": mlstm_step, "slstm": slstm_step}


def layer_decode(cfg: ModelConfig, spec: LayerSpec, lp: Params,
                 x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 positions: torch.Tensor, lengths: torch.Tensor, *,
                 cross_lengths: Optional[torch.Tensor] = None,
                 moe: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """x: (B,1,D).  Attention writes the token's K/V into ``cache`` in
    place (it attends to itself), then attends over lengths + 1 positions;
    a recurrent layer advances its state in ``cache`` in place; a
    cross-attention sublayer attends to all of ``ck`` / ``cv``:
    ``cross_lengths`` (B,) int32, each row ``ck``'s width, made once a
    step by the caller."""
    B = x.shape[0]
    h = norm(cfg, lp["ln1"], x)
    if spec.kind in SSM_KINDS:
        y, _ = _STEPS[spec.kind](lp["mixer"], cfg, h, cache)
    elif spec.kind == "mla":
        y, _ = mla_decode(lp["mixer"], cfg, h, cache["latent"], positions,
                          lengths)
    else:
        q, k_new, v_new = gqa_project_qkv(lp["mixer"], cfg, h,
                                          positions[:, None])
        kc, vc = cache["k"], cache["v"]
        S_max = kc.shape[1]
        rows = torch.arange(B, device=x.device)
        at = lengths.clamp(max=S_max - 1).long()
        keep = (lengths < S_max)[:, None, None]  # a full row writes nothing
        # in place: one cache row per sequence, instead of a new cache array
        kc[rows, at] = torch.where(keep, k_new[:, 0], kc[rows, at])
        vc[rows, at] = torch.where(keep, v_new[:, 0], vc[rows, at])
        o = decode_attention(q[:, 0], kc, vc, lengths + 1)
        y = (o.reshape(B, -1) @ lp["mixer"]["wo"])[:, None]
    x = x + y
    if spec.has_cross:
        o = decode_attention(_cross_query(cfg, lp, x)[:, 0], cache["ck"],
                             cache["cv"], cross_lengths)
        x = x + (o.reshape(B, -1) @ lp["cross"]["wo"])[:, None]
    return _ffn(cfg, spec, lp, x, moe, min(256, B))


def layer_prefill_chunk(cfg: ModelConfig, spec: LayerSpec, lp: Params,
                        x: torch.Tensor, cache: Dict[str, torch.Tensor],
                        pos0: int, *, scan_impl: str = "lax",
                        moe: Optional[Dict[str, Any]] = None
                        ) -> torch.Tensor:
    """Process chunk positions [pos0, pos0+c) against cached history.
    Attention writes the chunk's K/V (MLA: its latent payload) into
    ``cache`` in place and runs over the full cache width with the causal
    mask doing the windowing (K1 prunes the kv loop at pos0 + c); a
    recurrent layer continues from the state in ``cache`` and overwrites
    it; a cross-attention sublayer attends to all of ``ck`` / ``cv``
    (``plain_attention``, non-causal, as in the reference)."""
    B, c, D = x.shape
    h = norm(cfg, lp["ln1"], x)
    if spec.kind in SSM_KINDS:
        y, st = _ssm_forward(cfg, spec, lp, h, cache, scan_impl)
        for name, t in st.items():
            cache[name].copy_(t)
    else:
        S_max = cache["latent" if spec.kind == "mla" else "k"].shape[1]
        if pos0 < 0 or pos0 + c > S_max:
            raise ValueError(f"chunk [{pos0}, {pos0 + c}) outside the "
                             f"cache width {S_max}")
        positions = pos0 + torch.arange(c, device=x.device).expand(B, c)
        if spec.kind == "mla":
            # in place into the latent slice, then absorbed chunk attention
            cache["latent"][:, pos0:pos0 + c] = mla_cache_payload(
                lp["mixer"], cfg, h, positions)
            y = _mla_chunk_absorbed(lp["mixer"], cfg, h, cache["latent"],
                                    positions, pos0, c)
        else:
            q, k, v = gqa_project_qkv(lp["mixer"], cfg, h, positions)
            cache["k"][:, pos0:pos0 + c] = k  # in place into the cache slice
            cache["v"][:, pos0:pos0 + c] = v
            kc, vc = cache["k"], cache["v"]
            if c <= 256 and S_max <= 1024:
                o = plain_attention(q, kc, vc, causal=True, q_offset=pos0)
            else:
                qc, kvc = attn_chunk_sizes(c, S_max)
                o = blockwise_attention(q, kc, vc, causal=True, q_chunk=qc,
                                        kv_chunk=kvc, q_offset=pos0)
            y = o.reshape(B, c, -1) @ lp["mixer"]["wo"]
    x = x + y
    if spec.has_cross:
        o = plain_attention(_cross_query(cfg, lp, x), cache["ck"],
                            cache["cv"], causal=False)
        x = x + o.reshape(B, c, -1) @ lp["cross"]["wo"]
    return _ffn(cfg, spec, lp, x, moe, min(256, c))


def _mla_chunk_absorbed(params: Params, cfg: ModelConfig, h: torch.Tensor,
                        latent: torch.Tensor, positions: torch.Tensor,
                        pos0: int, c: int) -> torch.Tensor:
    """MLA chunk attention in absorbed form, scoring the chunk's queries
    against the whole latent buffer (B,S,r+rd), which already holds the
    chunk: the causal mask (query pos0 + i sees keys ≤ pos0 + i) does the
    windowing, as in the reference."""
    cos, sin = rope_table(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    q_nope, q_rope = mla_queries(params, cfg, h, cos, sin)
    q_pos = pos0 + torch.arange(c, device=h.device)
    valid = (q_pos[:, None] >= torch.arange(latent.shape[1],
                                            device=h.device)[None, :])[None]
    o = mla_absorbed(params, cfg, q_nope, q_rope, latent, valid, h.dtype)
    return o @ params["wo"]


def layer_cache_shape(cfg: ModelConfig, spec: LayerSpec, batch: int,
                      max_seq: int, *, cross_len: int = 0
                      ) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """Returns {name: (shape, dtype)} for one layer's decode state; a
    cross-attention layer adds ``ck`` / ``cv`` of ``cross_len`` positions
    (the encoder output's or the image embeddings' length), whatever
    ``max_seq`` is."""
    check_spec(cfg, spec)
    dt, d = cfg.dtype(), cfg.d_model
    di = cfg.ssm_expand * d
    conv = (batch, cfg.ssm_conv_dim - 1)
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
    if spec.kind == "mamba":
        out = {"ssm": ((batch, di, cfg.ssm_state_dim), torch.float32),
               "conv": (conv + (di,), dt)}
    elif spec.kind == "mlstm":
        H = cfg.num_heads
        dh = di // H
        out = {"C": ((batch, H, dh, dh), torch.float32),
               "n": ((batch, H, dh), torch.float32),
               "m": ((batch, H), torch.float32),
               "conv": (conv + (di,), dt)}
    elif spec.kind == "slstm":
        out = {**{k: ((batch, d), torch.float32)
                  for k in ("c", "n", "h", "m")},
               "conv": (conv + (d,), dt)}
    elif spec.kind == "mla":
        out = {"latent": ((batch, max_seq,
                           cfg.kv_lora_rank + cfg.qk_rope_head_dim), dt)}
    else:
        out = {"k": ((batch, max_seq, kv, hd), dt),
               "v": ((batch, max_seq, kv, hd), dt)}
    if spec.has_cross:
        out["ck"] = ((batch, cross_len, kv, hd), dt)
        out["cv"] = ((batch, cross_len, kv, hd), dt)
    return out


__all__ = [
    "LayerSpec", "layer_specs", "stage_layout", "check_spec", "norm_init",
    "norm", "layer_init",
    "layer_apply", "layer_decode", "layer_prefill_chunk", "layer_cache_shape",
    "cross_kv",
    "FFN_TYPES",
]
