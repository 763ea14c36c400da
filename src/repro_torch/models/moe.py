"""Mixture-of-Experts: routing, dispatch, expert FFNs, shared experts — the
counterpart of ``repro.models.moe``.

Two dispatch strategies, as in the reference:

* ``einsum`` (the ``Model`` default): GShard-style grouped one-hot dispatch
  with a per-group capacity; tokens over capacity are dropped (the residual
  carries them).  Plain ``torch.einsum``: the reference runs it outside any
  Pallas kernel.
* ``sort`` (dropless, the serving path): the (T·K,) expert assignments are
  stably sorted by expert id and the activation rows gathered into that
  order (``sort_route``), each expert's contiguous segment goes through its
  FFN, and ``sort_combine`` puts the results back in token order.
  ``sort_fn="pallas"`` routes through K3 (``kernels.radix_sort.
  moe_dispatch_sort``, the sort and the row gather in one kernel entry).

The reference computes the expert FFNs as a one-hot einsum over all
experts (``te`` masks); here they are a grouped matmul over the expert
segments, one ``torch.matmul`` per non-empty segment, whose bounds come
from the per-expert counts (K3 returns them; the other routes count with
``torch.bincount``).  Reading the counts costs one host sync per MoE layer.
The combine is deterministic: for top-1 it is a permutation, and for
top-k > 1 each token's k contributions are summed in a fixed order (its
slots in sorted order), never with atomics.

Router: softmax → top-k → renormalize; the load-balance auxiliary loss is
returned as in the reference.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.merge_sort import argsort as kernel_argsort
from ..kernels.radix_sort import moe_dispatch_sort
from .layers import Params, dense_init, swiglu, swiglu_init


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def moe_init(gen: torch.Generator, cfg: ModelConfig, *,
             lead: Tuple[int, ...] = ()) -> Params:
    """Router, expert banks (E, d, f) / (E, f, d) and the shared experts,
    stacked over ``lead``: the reference's distributions (N(0, 1/fan_in)),
    not its random numbers."""
    d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.num_experts
    dt = cfg.pdtype()
    params: Params = {
        "router": dense_init(gen, d, e, dt, lead=lead),
        "gate": dense_init(gen, d, f, dt, lead=lead + (e,)),
        "up": dense_init(gen, d, f, dt, lead=lead + (e,)),
        "down": dense_init(gen, f, d, dt, lead=lead + (e,)),
    }
    if cfg.num_shared_experts > 0:
        params["shared"] = swiglu_init(gen, d, f * cfg.num_shared_experts,
                                       dt, lead=lead)
    return params


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def route_topk(router_w: torch.Tensor, x: torch.Tensor, top_k: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (..., D) → (probs (..., k) in x's dtype, experts (..., k) int32,
    aux_loss fp32 scalar).

    The router product runs in the compute dtype and is then cast to fp32,
    as the reference's.  Ties go to the lower expert index, as
    ``jax.lax.top_k``'s: a stable descending sort (``torch.topk`` promises
    no order among equal values).
    """
    logits = (x @ router_w).float()
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p = top.values[..., :top_k]
    top_e = top.indices[..., :top_k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    e = router_w.shape[-1]
    # fraction of tokens routed to each expert (first choice) & mean prob
    first = F.one_hot(top_e[..., 0], e).float()
    f_e = first.reshape(-1, e).mean(0)
    p_e = probs.reshape(-1, e).mean(0)
    aux = e * torch.sum(f_e * p_e)
    return top_p.to(x.dtype), top_e.to(torch.int32), aux


def capacity_per_group(group_size: int, num_experts: int, top_k: int,
                       capacity_factor: float) -> int:
    c = math.ceil(group_size * top_k * capacity_factor / num_experts)
    return max(4, ((c + 3) // 4) * 4)


# ---------------------------------------------------------------------------
# einsum (GShard) dispatch
# ---------------------------------------------------------------------------

def moe_einsum(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
               group_size: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (out (B, S, D), aux_loss).  Tokens are regrouped to
    (G, group_size, D); capacity overflows drop, as in the reference."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    g = min(group_size, S)
    G = B * S // g
    xg = x.reshape(G, g, D)
    dt = x.dtype

    probs, experts, aux = route_topk(params["router"], xg, K)   # (G, g, K)
    C = capacity_per_group(g, E, K, cfg.capacity_factor)

    dispatch = torch.zeros(G, g, E, C, dtype=dt, device=x.device)
    combine = torch.zeros(G, g, E, C, dtype=torch.float32, device=x.device)
    counts = torch.zeros(G, E, dtype=torch.int64, device=x.device)
    for j in range(K):
        onehot = F.one_hot(experts[..., j].long(), E)            # (G, g, E)
        pos = torch.cumsum(onehot, dim=1) - 1 + counts[:, None, :]
        counts = counts + onehot.sum(dim=1)
        keep = (pos < C) & (onehot > 0)
        pos_oh = F.one_hot(torch.where(keep, pos, 0), C).to(dt)
        sel = keep.to(dt)[..., None] * pos_oh * onehot.to(dt)[..., None]
        dispatch = dispatch + sel
        combine = combine + sel.float() * \
            probs[..., j].float()[..., None, None]

    xe = torch.einsum("gsd,gsec->egcd", xg, dispatch)             # (E,G,C,D)
    h = torch.einsum("egcd,edf->egcf", xe, params["gate"])
    u = torch.einsum("egcd,edf->egcf", xe, params["up"])
    h = F.silu(h) * u
    ye = torch.einsum("egcf,efd->egcd", h, params["down"])
    out = torch.einsum("egcd,gsec->gsd", ye, combine.to(dt))
    out = out.reshape(B, S, D)

    if cfg.num_shared_experts > 0:
        out = out + swiglu(params["shared"], x)
    return out, aux


# ---------------------------------------------------------------------------
# sort-based dispatch (the paper's stable sort at work)
# ---------------------------------------------------------------------------

def _sort_route(params: Params, cfg: ModelConfig, x: torch.Tensor, sort_fn):
    """``sort_route`` plus the (E,) int32 per-expert counts."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    T = B * S
    xf = x.reshape(T, D)
    probs, experts, aux = route_topk(params["router"], xf, K)     # (T, K)
    if sort_fn == "pallas":
        if E <= 256:
            xd, sorted_e, sorted_tok, sorted_p, counts = moe_dispatch_sort(
                xf, experts, probs, num_experts=E)
            return xd, sorted_e, sorted_tok, sorted_p, aux, counts
        bits = max(1, math.ceil(math.log2(max(2, E))))
        sort_fn = functools.partial(kernel_argsort, num_key_bits=bits)

    flat_e = experts.reshape(T * K)
    flat_p = probs.reshape(T * K)
    order = (sort_fn(flat_e) if sort_fn is not None
             else torch.argsort(flat_e, stable=True)).long()
    sorted_e = flat_e[order]
    sorted_tok = torch.div(order, K, rounding_mode="floor").to(torch.int32)
    counts = torch.bincount(sorted_e.long(), minlength=E)[:E].to(torch.int32)
    return (xf[sorted_tok], sorted_e, sorted_tok, flat_p[order], aux,
            counts)


def sort_route(params: Params, cfg: ModelConfig, x: torch.Tensor,
               sort_fn=None):
    """Route, flatten to (T·K,) assignments and sort them stably by expert
    id.  Returns ``(xd, sorted_e, sorted_tok, sorted_p, aux)`` with ``xd``
    the permuted activations (T·K, D).

    ``sort_fn(keys) -> order`` must be a *stable* argsort; ``None`` is
    ``torch.argsort(stable=True)``.  ``"pallas"`` (the reference's name)
    routes through K3, the sort and the row gather in one kernel entry,
    for at most 256 experts; above that through the port's radix
    ``argsort`` (K5–K8) with ``ceil(log2 E)`` key bits and a gather."""
    return _sort_route(params, cfg, x, sort_fn)[:5]


def sort_combine(params: Params, cfg: ModelConfig, x: torch.Tensor,
                 y: torch.Tensor, sorted_tok: torch.Tensor,
                 sorted_p: torch.Tensor) -> torch.Tensor:
    """Scale by the combine weights, return to token order, add the shared
    experts.  Deterministic: top-1 is a permutation (each token written
    once); for top-k > 1 each token's k rows, in sorted order, are summed
    one after another (the reference's scatter-add order on one device)."""
    B, S, D = x.shape
    T = B * S
    y = y * sorted_p[:, None].to(y.dtype)
    tok = sorted_tok.long()
    if y.shape[0] == T:
        out = torch.empty_like(y)
        out[tok] = y
    else:
        K = y.shape[0] // T
        g = y[torch.argsort(tok, stable=True)].reshape(T, K, D)
        out = g[:, 0]
        for k in range(1, K):
            out = out + g[:, k]
    out = out.reshape(B, S, D).to(x.dtype)
    if cfg.num_shared_experts > 0:
        out = out + swiglu(params["shared"], x)
    return out


def _grouped_ffn(params: Params, xd: torch.Tensor,
                 counts: torch.Tensor) -> torch.Tensor:
    """The expert SwiGLU over the expert segments of the sorted rows, one
    matmul per non-empty segment (one host sync reads the bounds)."""
    y = torch.empty_like(xd)
    start = 0
    for e, c in enumerate(counts.tolist()):
        if c:
            seg = xd[start:start + c]
            h = F.silu(seg @ params["gate"][e]) * (seg @ params["up"][e])
            y[start:start + c] = h @ params["down"][e]
            start += c
    return y


def moe_sort_dispatch(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
                      sort_fn=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based MoE: dropless; every token goes through its experts."""
    xd, _, sorted_tok, sorted_p, aux, counts = _sort_route(params, cfg, x,
                                                           sort_fn)
    y = _grouped_ffn(params, xd, counts)
    return sort_combine(params, cfg, x, y, sorted_tok, sorted_p), aux


def moe_apply(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
              strategy: str = "einsum", group_size: int = 256,
              sort_fn=None) -> Tuple[torch.Tensor, torch.Tensor]:
    if strategy == "einsum":
        return moe_einsum(params, cfg, x, group_size=group_size)
    if strategy == "sort":
        return moe_sort_dispatch(params, cfg, x, sort_fn=sort_fn)
    raise ValueError(f"unknown MoE strategy {strategy!r}")


__all__ = ["moe_init", "route_topk", "capacity_per_group", "moe_einsum",
           "sort_route", "sort_combine", "moe_sort_dispatch", "moe_apply"]
