"""State-space / recurrent mixers: Mamba (Jamba), mLSTM + sLSTM (xLSTM) —
the counterpart of ``repro.models.ssm``.

Prefill paths are chunked: the sequence is cut into ``mlstm_chunk`` chunks,
each processed in an intra-chunk parallel form, with a small recurrent state
carried between chunks.  ``scan_impl="pallas"`` carries it with one K4
launch (``kernels/ssm_scan.py``): every chunk's summary in parallel, one
scan of the carries entering each chunk, then every chunk's outputs in
parallel.  ``"lax"`` is the reference's sequential chunk loop (Mamba: a
log-depth associative scan inside each chunk).  Both agree to fp32
reassociation.

Decode paths are O(1) per token.  ``*_step`` update the state dict they are
given in place (the matrix memory is the size of a KV cache; the JAX
versions return new arrays) and return it.  sLSTM is sequential: its
prefill is a Python loop over time, as the reference's ``lax.scan`` is.

Every fp32 expression keeps the reference's order of operations, so fp32
serving tokens can be exact.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.ssm_scan import (affine_combine, associative_scan,
                                logspace_affine_combine, mamba_assoc_scan,
                                mlstm_carry_scan)
from .layers import Params, dense_init, gelu

F32 = torch.float32
State = Dict[str, torch.Tensor]


def _randn(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=F32).mul_(scale).to(dtype)


def _conv_buf(conv_buf: Optional[torch.Tensor], xin: torch.Tensor,
              width: int) -> torch.Tensor:
    """The last ``width - 1`` inputs after this call (the decode conv tail)."""
    B, S, D = xin.shape
    if S >= width - 1:
        return xin[:, S - (width - 1):]
    base = conv_buf if conv_buf is not None else \
        torch.zeros((B, width - 1, D), dtype=xin.dtype, device=xin.device)
    return torch.cat([base, xin], dim=1)[:, -(width - 1):]


# ---------------------------------------------------------------------------
# causal depthwise conv (shared by mamba / xlstm blocks)
# ---------------------------------------------------------------------------

def causal_conv_init(gen: torch.Generator, dim: int, width: int, dtype, *,
                     lead=()) -> Params:
    return {"w": _randn(gen, lead + (width, dim), 1.0 / math.sqrt(width),
                        dtype),
            "b": torch.zeros(lead + (dim,), dtype=dtype, device=gen.device)}


def causal_conv(params: Params, x: torch.Tensor,
                conv_buf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B,S,Di) depthwise causal conv, width = params['w'].shape[0];
    ``conv_buf`` (B,width-1,Di) holds the inputs before x (zeros if None)."""
    w = params["w"]
    width = w.shape[0]
    S = x.shape[1]
    if conv_buf is None:
        conv_buf = torch.zeros(x.shape[:1] + (width - 1,) + x.shape[2:],
                               dtype=x.dtype, device=x.device)
    xp = torch.cat([conv_buf, x], dim=1)
    out = torch.zeros_like(x)
    for i in range(width):   # width is 4: unrolled taps
        out = out + xp[:, i:i + S] * w[i]
    return out + params["b"]


def causal_conv_step(params: Params, x: torch.Tensor, buf: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,Di); buf: (B,width-1,Di) past inputs → (y (B,Di), new buf)."""
    full = torch.cat([buf, x[:, None, :]], dim=1)          # (B,width,Di)
    y = torch.einsum("bwd,wd->bd", full, params["w"]) + params["b"]
    return y, full[:, 1:]


# ---------------------------------------------------------------------------
# Mamba (S6) block
# ---------------------------------------------------------------------------

def mamba_init(gen: torch.Generator, cfg: ModelConfig, *, lead=()) -> Params:
    """A_log and D are fp32 at every parameter dtype, as in the reference."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state_dim
    dt_rank = max(1, d // 16)
    dt, dev = cfg.pdtype(), gen.device
    a_log = torch.log(torch.arange(1, n + 1, dtype=F32, device=dev))
    return {
        "in_proj": dense_init(gen, d, 2 * di, dt, lead=lead),
        "conv": causal_conv_init(gen, di, cfg.ssm_conv_dim, dt, lead=lead),
        "x_proj": dense_init(gen, di, dt_rank + 2 * n, dt, lead=lead),
        "dt_proj": dense_init(gen, dt_rank, di, dt, lead=lead),
        "dt_bias": torch.zeros(lead + (di,), dtype=dt, device=dev),
        "A_log": a_log.expand(lead + (di, n)).contiguous(),
        "D": torch.ones(lead + (di,), dtype=F32, device=dev),
        "out_proj": dense_init(gen, di, d, dt, lead=lead),
    }


def _mamba_inner(params: Params, cfg: ModelConfig, xc: torch.Tensor,
                 h0: torch.Tensor, *, scan_impl: str = "lax"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the selective scan.  xc: (B,c,Di) post-conv activations,
    h0: (B,Di,N) carry → (y (B,c,Di), h_final)."""
    n = cfg.ssm_state_dim
    dt_rank = max(1, cfg.d_model // 16)
    proj = xc @ params["x_proj"]
    dt_in, Bs, Cs = torch.split(proj, [dt_rank, n, n], dim=-1)
    delta = F.softplus(dt_in @ params["dt_proj"]
                       + params["dt_bias"]).to(F32)             # (B,c,Di)
    A = -torch.exp(params["A_log"])                             # (Di,N)
    dA = torch.exp(delta[..., None] * A)
    dBx = (delta * xc.to(F32))[..., None] * Bs.to(F32)[:, :, None, :]
    if scan_impl == "pallas":
        states = mamba_assoc_scan(dA, dBx, h0)                  # (B,c,Di,N)
    else:
        prefA, within = associative_scan(affine_combine, (dA, dBx), dim=1)
        states = within + prefA * h0[:, None]
    y = torch.einsum("bcdn,bcn->bcd", states, Cs.to(F32))
    y = y + params["D"] * xc.to(F32)
    return y.to(xc.dtype), states[:, -1]


def mamba_forward(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
                  h0: Optional[torch.Tensor] = None,
                  conv_buf: Optional[torch.Tensor] = None,
                  scan_impl: str = "lax") -> Tuple[torch.Tensor, State]:
    """x: (B,S,D) → (y (B,S,D), state {ssm, conv})."""
    B, S, D = x.shape
    di = cfg.ssm_expand * D
    n = cfg.ssm_state_dim
    chunk = min(cfg.mlstm_chunk, S)
    xin, z = torch.chunk(x @ params["in_proj"], 2, dim=-1)
    xc = F.silu(causal_conv(params["conv"], xin, conv_buf))
    h0 = h0 if h0 is not None else \
        torch.zeros((B, di, n), dtype=F32, device=x.device)
    if S % chunk == 0 and S > chunk:
        ys = []
        h = h0
        for k in range(S // chunk):
            y, h = _mamba_inner(params, cfg, xc[:, k * chunk:(k + 1) * chunk],
                                h, scan_impl=scan_impl)
            ys.append(y)
        y, hF = torch.cat(ys, dim=1), h
    else:
        y, hF = _mamba_inner(params, cfg, xc, h0, scan_impl=scan_impl)
    y = y * F.silu(z)
    out = y @ params["out_proj"]
    width = params["conv"]["w"].shape[0]
    return out, {"ssm": hF, "conv": _conv_buf(conv_buf, xin, width)}


def mamba_step(params: Params, cfg: ModelConfig, x: torch.Tensor,
               state: State) -> Tuple[torch.Tensor, State]:
    """x: (B,1,D) decode step; updates ``state`` {ssm, conv} in place."""
    n = cfg.ssm_state_dim
    dt_rank = max(1, cfg.d_model // 16)
    xin, z = torch.chunk(x[:, 0] @ params["in_proj"], 2, dim=-1)
    xc, new_buf = causal_conv_step(params["conv"], xin, state["conv"])
    xc = F.silu(xc)
    dt_in, Bs, Cs = torch.split(xc @ params["x_proj"], [dt_rank, n, n],
                                dim=-1)
    delta = F.softplus(dt_in @ params["dt_proj"]
                       + params["dt_bias"]).to(F32)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(delta[..., None] * A)                        # (B,Di,N)
    dBx = (delta * xc.to(F32))[..., None] * Bs.to(F32)[:, None, :]
    h = state["ssm"].mul_(dA).add_(dBx)          # dA*h + dBx, in place
    y = torch.einsum("bdn,bn->bd", h, Cs.to(F32)) + params["D"] * xc.to(F32)
    y = y.to(x.dtype) * F.silu(z)
    state["conv"].copy_(new_buf)
    return (y @ params["out_proj"])[:, None], state


# ---------------------------------------------------------------------------
# mLSTM (xLSTM's matrix-memory block) — stabilized chunkwise parallel form
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg: ModelConfig, *, lead=()) -> Params:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    h = cfg.num_heads
    dh = di // h
    dt = cfg.pdtype()
    return {
        "up": dense_init(gen, d, 2 * di, dt, lead=lead),
        "conv": causal_conv_init(gen, di, cfg.ssm_conv_dim, dt, lead=lead),
        # block-diagonal per-head projections
        "wq": _randn(gen, lead + (h, dh, dh), 1.0 / math.sqrt(dh), dt),
        "wk": _randn(gen, lead + (h, dh, dh), 1.0 / math.sqrt(dh), dt),
        "wv": _randn(gen, lead + (h, dh, dh), 1.0 / math.sqrt(dh), dt),
        "wi": dense_init(gen, di, h, dt, lead=lead),
        "wf": dense_init(gen, di, h, dt, lead=lead),
        "norm_scale": torch.ones(lead + (di,), dtype=dt, device=gen.device),
        "down": dense_init(gen, di, d, dt, lead=lead),
    }


def _headwise_rmsnorm(x: torch.Tensor, scale: torch.Tensor, nheads: int,
                      eps: float = 1e-5) -> torch.Tensor:
    B, S, di = x.shape
    xh = x.reshape(B, S, nheads, di // nheads).to(F32)
    var = xh.square().mean(dim=-1, keepdim=True)
    xh = xh * torch.rsqrt(var + eps)
    return (xh.reshape(B, S, di) * scale.to(F32)).to(x.dtype)


def _mlstm_intra(q, k, v, log_i, log_f, carry):
    """Chunk outputs given the state ENTERING the chunk.

    q,k,v: (B,c,H,dh); log_i/log_f: (B,c,H) fp32.
    carry = (C (B,H,dh,dh), n (B,H,dh), m (B,H)) fp32.
    Returns (h (B,c,H,dh), F (B,c,H) inclusive gate cumsum, F_tot (B,H)).
    """
    B, c, H, dh = q.shape
    Chat, nhat, m_prev = carry
    scale = 1.0 / math.sqrt(dh)

    Fc = torch.cumsum(log_f, dim=1)                  # (B,c,H) inclusive
    F_tot = Fc[:, -1]
    # b_ij = (F_i - F_j) + log_i_j for j <= i
    b = Fc[:, :, None, :] - Fc[:, None, :, :] + log_i[:, None, :, :]
    tri = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    b = torch.where(tri[None, :, :, None], b, float("-inf"))

    g = Fc + m_prev[:, None, :]                      # inter gain (B,c,H)
    m_intra = b.amax(dim=2)                          # (B,c,H)
    m_i = torch.maximum(m_intra, g)
    m_i = torch.clamp(m_i, min=-1e30)                # guard all -inf rows

    P = torch.exp(b - m_i[:, :, None, :])            # (B,c,c,H)
    qf, kf, vf = q.to(F32), k.to(F32), v.to(F32)
    qk = torch.einsum("bihd,bjhd->bijh", qf, kf) * scale
    W = P * qk
    num_intra = torch.einsum("bijh,bjhd->bihd", W, vf)
    den_intra = torch.einsum("bijh,bjhd->bihd", P, kf * scale)
    den_intra = torch.einsum("bihd,bihd->bih", qf, den_intra)

    inter_gain = torch.exp(g - m_i)                  # (B,c,H)
    num_inter = torch.einsum("bihd,bhde->bihe", qf * scale, Chat) \
        * inter_gain[..., None]
    den_inter = torch.einsum("bihd,bhd->bih", qf * scale, nhat) * inter_gain

    num = num_intra + num_inter
    den = den_intra + den_inter
    h = num / torch.maximum(den.abs(), torch.exp(-m_i))[..., None]
    return h, Fc, F_tot


def _mlstm_chunk(q, k, v, log_i, log_f, carry):
    """One stabilized chunk: intra outputs + sequential carry update — one
    application of ``logspace_affine_combine`` to the chunk's summary.
    Returns (h (B,c,H,dh), new carry)."""
    Chat, nhat, m_prev = carry
    h, Fc, F_tot = _mlstm_intra(q, k, v, log_i, log_f, carry)

    decay_k = F_tot[:, None, :] - Fc + log_i         # (B,c,H): gate j→end
    m_next = torch.maximum(F_tot + m_prev, decay_k.amax(dim=1))
    kv_gain = torch.exp(decay_k - m_next[:, None, :])
    kf, vf = k.to(F32), v.to(F32)
    carry_gain = torch.exp(F_tot + m_prev - m_next)
    C_new = carry_gain[:, :, None, None] * Chat + torch.einsum(
        "bjhd,bjhe->bhde", kv_gain[..., None] * kf, vf)
    n_new = carry_gain[:, :, None] * nhat + torch.einsum(
        "bjh,bjhd->bhd", kv_gain, kf)
    return h, (C_new, n_new, m_next)


def _mlstm_chunk_summary(k, v, log_i, log_f):
    """The chunk's element of the log-space affine monoid.

    k,v: (B,c,H,dh); log_i/log_f: (B,c,H) fp32 → (la, m_loc, Ĉ, n̂): the
    chunk acts on the entering state as
    ``(C, n) ↦ exp(la)·(C, n) + exp(m_loc)·(Ĉ, n̂)``.  Independent of the
    carry, so every chunk computes its summary in parallel.
    """
    Fc = torch.cumsum(log_f, dim=1)
    F_tot = Fc[:, -1]
    decay_k = F_tot[:, None, :] - Fc + log_i         # (B,c,H)
    m_loc = torch.clamp(decay_k.amax(dim=1), min=-1e30)
    gain = torch.exp(decay_k - m_loc[:, None, :])
    kf = k.to(F32)
    Chat = torch.einsum("bjhd,bjhe->bhde", gain[..., None] * kf, v.to(F32))
    nhat = torch.einsum("bjh,bjhd->bhd", gain, kf)
    return F_tot, m_loc, Chat, nhat


def mlstm_forward(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
                  state: Optional[State] = None, scan_impl: str = "lax"
                  ) -> Tuple[torch.Tensor, State]:
    """x: (B,S,D) → (y (B,S,D), new state {C, n, m, conv}); ``state`` is
    the state entering x (zeros if None) and is not modified."""
    B, S, D = x.shape
    di = cfg.ssm_expand * D
    H = cfg.num_heads
    dh = di // H
    chunk = min(cfg.mlstm_chunk, S)

    xin, z = torch.chunk(x @ params["up"], 2, dim=-1)
    conv_buf = state["conv"] if state is not None else None
    xc = F.silu(causal_conv(params["conv"], xin, conv_buf))

    xch = xc.reshape(B, S, H, dh)
    q = torch.einsum("bshd,hde->bshe", xch, params["wq"])
    k = torch.einsum("bshd,hde->bshe", xch, params["wk"])
    v = torch.einsum("bshd,hde->bshe", xin.reshape(B, S, H, dh), params["wv"])
    log_i = (xc @ params["wi"]).to(F32)
    log_f = F.logsigmoid((xc @ params["wf"]).to(F32))

    if state is not None:
        carry = (state["C"], state["n"], state["m"])
    else:
        carry = (torch.zeros((B, H, dh, dh), dtype=F32, device=x.device),
                 torch.zeros((B, H, dh), dtype=F32, device=x.device),
                 torch.zeros((B, H), dtype=F32, device=x.device))

    if S % chunk == 0 and S > chunk:
        nc = S // chunk

        def rs(t):   # (B,S,...) → (nc, B, chunk, ...)
            return t.reshape((B, nc, chunk) + t.shape[2:]).transpose(0, 1)

        qs, ks_, vs, lis, lfs = (rs(t) for t in (q, k, v, log_i, log_f))
        if scan_impl == "pallas":
            # chunk-parallel form: (1) every chunk's monoid summary at once,
            # (2) ONE K4 launch scans the carries entering each chunk,
            # (3) every chunk's outputs at once against its entering carry
            def flat(t):   # (nc, B, ...) → (nc*B, ...)
                return t.reshape((nc * B,) + t.shape[2:])

            def unflat(t):
                return t.reshape((nc, B) + t.shape[1:])

            C0, n0, m0 = carry
            la, mS, CS, nS = (unflat(t) for t in _mlstm_chunk_summary(
                flat(ks_), flat(vs), flat(lis), flat(lfs)))
            la_e, m_e, C_e, n_e = mlstm_carry_scan(la, mS, CS, nS,
                                                   (m0, C0, n0))
            hs, _, _ = _mlstm_intra(flat(qs), flat(ks_), flat(vs), flat(lis),
                                    flat(lfs), (flat(C_e), flat(n_e),
                                                flat(m_e)))
            hs = unflat(hs)
            _, mF, CF, nF = logspace_affine_combine(
                (la_e[-1], m_e[-1], C_e[-1], n_e[-1]),
                (la[-1], mS[-1], CS[-1], nS[-1]))
            carry = (CF, nF, mF)
        else:
            outs = []
            for j in range(nc):
                hj, carry = _mlstm_chunk(qs[j], ks_[j], vs[j], lis[j],
                                         lfs[j], carry)
                outs.append(hj)
            hs = torch.stack(outs)
        h = hs.transpose(0, 1).reshape(B, S, H, dh)
    else:
        h, carry = _mlstm_chunk(q, k, v, log_i, log_f, carry)

    h = h.reshape(B, S, di).to(x.dtype)
    h = _headwise_rmsnorm(h, params["norm_scale"], H)
    h = h * F.silu(z)
    out = h @ params["down"]
    width = params["conv"]["w"].shape[0]
    C_, n_, m_ = carry
    return out, {"C": C_, "n": n_, "m": m_,
                 "conv": _conv_buf(conv_buf, xin, width)}


def mlstm_step(params: Params, cfg: ModelConfig, x: torch.Tensor,
               state: State) -> Tuple[torch.Tensor, State]:
    """x: (B,1,D) decode step; updates ``state`` {C, n, m, conv} in place."""
    B = x.shape[0]
    D = x.shape[-1]
    di = cfg.ssm_expand * D
    H = cfg.num_heads
    dh = di // H
    scale = 1.0 / math.sqrt(dh)

    xin, z = torch.chunk(x[:, 0] @ params["up"], 2, dim=-1)
    xc, new_buf = causal_conv_step(params["conv"], xin, state["conv"])
    xc = F.silu(xc)
    q = torch.einsum("bhd,hde->bhe", xc.reshape(B, H, dh), params["wq"])
    k = torch.einsum("bhd,hde->bhe", xc.reshape(B, H, dh), params["wk"])
    v = torch.einsum("bhd,hde->bhe", xin.reshape(B, H, dh), params["wv"])
    log_i = (xc @ params["wi"]).to(F32)
    log_f = F.logsigmoid((xc @ params["wf"]).to(F32))

    m_prev = state["m"]
    m_t = torch.maximum(log_f + m_prev, log_i)
    f_t = torch.exp(log_f + m_prev - m_t)
    i_t = torch.exp(log_i - m_t)
    kf, vf, qf = k.to(F32), v.to(F32), q.to(F32) * scale
    # f*C + i*outer(k, v), each product rounded as in the reference, in place
    C_t = state["C"].mul_(f_t[..., None, None]).add_(
        i_t[..., None, None] * (kf[..., :, None] * vf[..., None, :]))
    n_t = state["n"].mul_(f_t[..., None]).add_(i_t[..., None] * kf)
    num = torch.einsum("bhd,bhde->bhe", qf, C_t)
    den = torch.einsum("bhd,bhd->bh", qf, n_t)
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    state["m"].copy_(m_t)
    state["conv"].copy_(new_buf)
    h = h.reshape(B, 1, di).to(x.dtype)
    h = _headwise_rmsnorm(h, params["norm_scale"], H)
    h = h[:, 0] * F.silu(z)
    return (h @ params["down"])[:, None], state


# ---------------------------------------------------------------------------
# sLSTM — honest sequential recurrence
# ---------------------------------------------------------------------------

def slstm_ffn_dim(d: int) -> int:
    return int(round(4 * d / 3 / 64)) * 64 or 64


def slstm_init(gen: torch.Generator, cfg: ModelConfig, *, lead=()) -> Params:
    d = cfg.d_model
    h = cfg.num_heads
    dh = d // h
    ff = slstm_ffn_dim(d)
    dt = cfg.pdtype()
    return {
        "conv": causal_conv_init(gen, d, cfg.ssm_conv_dim, dt, lead=lead),
        "w": dense_init(gen, d, 4 * d, dt, lead=lead),  # z,i,f,o inputs
        "r": _randn(gen, lead + (4, h, dh, dh), 1.0 / math.sqrt(dh), dt),
        "b": torch.zeros(lead + (4 * d,), dtype=dt, device=gen.device),
        "norm_scale": torch.ones(lead + (d,), dtype=dt, device=gen.device),
        "up": dense_init(gen, d, 2 * ff, dt, lead=lead),
        "down": dense_init(gen, ff, d, dt, lead=lead),
    }


def _slstm_cell(r32: torch.Tensor, b32: torch.Tensor, nheads: int,
                wx: torch.Tensor, st: Tuple[torch.Tensor, ...]):
    """wx: (B,4D) precomputed input contribution; state (c,n,h,m) each
    (B,D); ``r32``/``b32`` the recurrent weights and bias in fp32."""
    B, d4 = wx.shape
    d = d4 // 4
    dh = d // nheads
    c, n, hprev, m = st
    rh = torch.einsum("bhd,khde->bkhe", hprev.reshape(B, nheads, dh).to(F32),
                      r32).reshape(B, 4 * d)
    pre = wx.to(F32) + rh + b32
    z_, i_, f_, o_ = torch.chunk(pre, 4, dim=-1)
    z = torch.tanh(z_)
    o = torch.sigmoid(o_)
    logf = F.logsigmoid(f_)
    m_t = torch.maximum(logf + m, i_)
    i_g = torch.exp(i_ - m_t)
    f_g = torch.exp(logf + m - m_t)
    c_t = f_g * c + i_g * z
    n_t = f_g * n + i_g
    h_t = o * c_t / torch.clamp(n_t, min=1.0)
    return (c_t, n_t, h_t, m_t)


def _slstm_out(params: Params, cfg: ModelConfig, h: torch.Tensor
               ) -> torch.Tensor:
    """Headwise norm + GEGLU projection of the cell outputs (B,S,D)."""
    h = _headwise_rmsnorm(h, params["norm_scale"], cfg.num_heads)
    a, g = torch.chunk(h @ params["up"], 2, dim=-1)
    return (a * gelu(g)) @ params["down"]


def slstm_forward(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
                  state: Optional[State] = None
                  ) -> Tuple[torch.Tensor, State]:
    """x: (B,S,D) → (y, new state {c, n, h, m, conv}); ``state`` is not
    modified."""
    B, S, D = x.shape
    conv_buf = state["conv"] if state is not None else None
    xc = F.silu(causal_conv(params["conv"], x, conv_buf))
    wx = xc @ params["w"]                                  # (B,S,4D)

    if state is not None:
        st = (state["c"], state["n"], state["h"], state["m"])
    else:
        zero = torch.zeros((B, D), dtype=F32, device=x.device)
        st = (zero, zero, zero, torch.full((B, D), -1e30, dtype=F32,
                                           device=x.device))
    # cast once, not per step: the same values the reference casts
    wx32, r32, b32 = wx.to(F32), params["r"].to(F32), params["b"].to(F32)
    hs = []
    for t in range(S):
        st = _slstm_cell(r32, b32, cfg.num_heads, wx32[:, t], st)
        hs.append(st[2])
    h = torch.stack(hs, dim=1).to(x.dtype)                 # (B,S,D)
    out = _slstm_out(params, cfg, h)
    width = params["conv"]["w"].shape[0]
    c, n, hh, m = st
    return out, {"c": c, "n": n, "h": hh, "m": m,
                 "conv": _conv_buf(conv_buf, x, width)}


def slstm_step(params: Params, cfg: ModelConfig, x: torch.Tensor,
               state: State) -> Tuple[torch.Tensor, State]:
    """x: (B,1,D) decode step; updates ``state`` {c, n, h, m, conv} in
    place."""
    xc, new_buf = causal_conv_step(params["conv"], x[:, 0], state["conv"])
    wx = F.silu(xc) @ params["w"]
    st = (state["c"], state["n"], state["h"], state["m"])
    new = _slstm_cell(params["r"].to(F32), params["b"].to(F32),
                      cfg.num_heads, wx, st)
    for name, t in zip(("c", "n", "h", "m"), new):
        state[name].copy_(t)
    state["conv"].copy_(new_buf)
    out = _slstm_out(params, cfg, new[2].to(x.dtype)[:, None])
    return out, state


__all__ = [
    "causal_conv_init", "causal_conv", "causal_conv_step",
    "mamba_init", "mamba_forward", "mamba_step",
    "mlstm_init", "mlstm_forward", "mlstm_step",
    "slstm_init", "slstm_forward", "slstm_step",
]
