"""Shared layers: RMSNorm, LayerNorm, RoPE (full and ``rotary_dims``),
SwiGLU, the 2-matrix FFN (GELU's, whisper's; relu²'s params), embedding.

Plain functions over explicit parameter trees (nested dicts of tensors), the
counterpart of ``repro.models.layers``.  Initializers draw from an explicit
``torch.Generator`` and return parameters in the requested dtype;
computation runs in the caller's dtype with fp32 statistics where the JAX
package keeps them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, *, lead: Tuple[int, ...] = ()
               ) -> torch.Tensor:
    """N(0, 1/d_in) weights of shape lead + (d_in, d_out); drawn in fp32 and
    cast, one leading slice at a time so the fp32 temporary stays small."""
    out = torch.empty(lead + (d_in, d_out), dtype=dtype, device=gen.device)
    flat = out.view(-1, d_in, d_out)
    scale = 1.0 / math.sqrt(d_in)
    for i in range(flat.shape[0]):
        flat[i] = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                              dtype=torch.float32).mul_(scale)
    return out


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, device=gen.device,
                       dtype=torch.float32).mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype: torch.dtype, device, *,
                 lead: Tuple[int, ...] = ()) -> Params:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def layernorm_init(d: int, dtype: torch.dtype, device, *,
                   lead: Tuple[int, ...] = ()) -> Params:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device),
            "bias": torch.zeros(lead + (d,), dtype=dtype, device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    """Mean and population variance (``jnp.var``'s, correction 0) in fp32,
    the result cast back to x's dtype."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE — full and half ("2d" RoPE rotates the first ``rotary_dims`` dims)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for a rotary table over ``head_dim`` dims."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def rope_table(positions: torch.Tensor, head_dim: int, theta: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables of shape positions.shape + (head_dim//2,)."""
    inv = rope_freqs(head_dim, theta, device=positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               *, rotary_dims: Optional[int] = None) -> torch.Tensor:
    """Rotate the first ``rotary_dims`` dims of the head dimension.

    x: (..., seq, heads, head_dim); cos/sin: (..., seq, rotary_dims//2).
    """
    hd = x.shape[-1]
    rd = rotary_dims or hd
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = xr.chunk(2, dim=-1)
    c = cos[..., None, :].to(x.dtype)  # broadcast over heads
    s = sin[..., None, :].to(x.dtype)
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    if rd < hd:
        out = torch.cat([out, xp], dim=-1)
    return out


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def swiglu_init(gen: torch.Generator, d: int, d_ff: int, dtype: torch.dtype,
                *, lead: Tuple[int, ...] = ()) -> Params:
    return {"gate": dense_init(gen, d, d_ff, dtype, lead=lead),
            "up": dense_init(gen, d, d_ff, dtype, lead=lead),
            "down": dense_init(gen, d_ff, d, dtype, lead=lead)}


def swiglu(params: Params, x: torch.Tensor) -> torch.Tensor:
    g = x @ params["gate"]
    u = x @ params["up"]
    return (F.silu(g) * u) @ params["down"]


def gelu_mlp_init(gen: torch.Generator, d: int, d_ff: int,
                  dtype: torch.dtype, *, lead: Tuple[int, ...] = ()
                  ) -> Params:
    """The 2-matrix FFN with biases (zero at init), as the reference's:
    whisper's GELU FFN and minitron's relu² FFN take these params."""
    dev = gen.device
    return {"up": dense_init(gen, d, d_ff, dtype, lead=lead),
            "up_b": torch.zeros(lead + (d_ff,), dtype=dtype, device=dev),
            "down": dense_init(gen, d_ff, d, dtype, lead=lead),
            "down_b": torch.zeros(lead + (d,), dtype=dtype, device=dev)}


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (``F.gelu``'s
    default is the erf form, up to ~1e-3 away)."""
    return F.gelu(x, approximate="tanh")


def gelu_mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    """gelu(x·up + up_b)·down + down_b."""
    h = gelu(x @ params["up"] + params["up_b"])
    return h @ params["down"] + params["down_b"]


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embedding_init(gen: torch.Generator, vocab: int, d: int,
                   dtype: torch.dtype) -> Params:
    return {"table": embed_init(gen, vocab, d, dtype)}


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens.long()]


__all__ = [
    "Params", "dense_init", "embed_init", "rmsnorm_init", "rmsnorm",
    "layernorm_init", "layernorm",
    "rope_freqs", "rope_table", "apply_rope", "swiglu_init", "swiglu",
    "gelu_mlp_init", "gelu", "gelu_mlp", "embedding_init", "embed",
]
