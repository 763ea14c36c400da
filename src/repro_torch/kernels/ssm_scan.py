"""The SSM recurrences as monoid scans over K4 — the counterpart of
``repro.kernels.ssm_scan``.

A linear recurrence ``h_t = a_t · h_{t-1} + b_t`` is the composition of
affine maps, a monoid::

    (a1, b1) ∘ (a2, b2) = (a1·a2,  b2 + a2·b1)      unit (1, 0)

so the whole recurrence is one scan, one launch of K4
(``kernels/tile_scan.py``) at any length.

* ``affine_combine`` — Mamba's selective scan over ``(dA_t, dBx_t)``;
  seeding the carry with ``(1, h0)`` makes the scanned second component the
  hidden states (:func:`mamba_assoc_scan`).
* ``logspace_affine_combine`` — the mLSTM chunk carry.  Elements
  ``(la, m, Ĉ, n̂)`` stand for ``X ↦ exp(la)·X + exp(m)·(Ĉ, n̂)``; the
  combine max-rebases ``m`` so nothing overflows.  The unit uses
  ``LOG_ZERO``, never −inf: ``-inf − -inf = nan`` inside ``exp`` would
  poison the unit (:func:`mlstm_carry_scan`).

The ``*_ref`` functions are the oracles the reference keeps beside them:
``mamba_assoc_scan_ref`` is a log-depth associative scan (the "lax" model
path), the others sequential folds.  None of this runs in an interpret
mode: CPU tensors take the plain fold, CUDA tensors the kernels.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .tile_scan import affine_scan, batched_scan, fold, tree_scan

LOG_ZERO = -1e30   # the repo-wide "log of zero" that survives exp/arith


# ---------------------------------------------------------------------------
# monoids
# ---------------------------------------------------------------------------

def affine_combine(a: Tuple[torch.Tensor, torch.Tensor],
                   b: Tuple[torch.Tensor, torch.Tensor]):
    """(gain, offset) pair monoid of ``h ↦ gain·h + offset`` maps."""
    a1, b1 = a
    a2, b2 = b
    return (a1 * a2, b2 + a2 * b1)


AFFINE_UNITS = (1.0, 0.0)


def logspace_affine_combine(a, b):
    """Stabilized log-space affine monoid for the mLSTM matrix memory.

    Elements ``(la, m, C, n)`` denote ``X ↦ exp(la)·X + exp(m)·(C, n)``;
    the combine rebases both terms onto ``m' = max(m1 + la2, m2)``, so
    every exponent is <= 0.  ``la`` never enters an exp by itself.
    """
    la1, m1, C1, n1 = a
    la2, m2, C2, n2 = b
    m = torch.maximum(m1 + la2, m2)
    s1 = torch.exp(m1 + la2 - m)
    s2 = torch.exp(m2 - m)
    C = s1[..., None, None] * C1 + s2[..., None, None] * C2
    n = s1[..., None] * n1 + s2[..., None] * n2
    return (la1 + la2, m, C, n)


LOGSPACE_UNITS = (0.0, LOG_ZERO, 0.0, 0.0)


def associative_scan(combine: Callable, elems, dim: int):
    """Inclusive scan in log2(L) rounds of ``combine`` on shifted halves
    (Hillis–Steele), the counterpart of ``jax.lax.associative_scan``."""
    elems = tuple(elems)
    L = elems[0].shape[dim]
    shift = 1
    while shift < L:
        prev = tuple(x.narrow(dim, 0, L - shift) for x in elems)
        cur = tuple(x.narrow(dim, shift, L - shift) for x in elems)
        elems = tuple(torch.cat([x.narrow(dim, 0, shift), c], dim)
                      for x, c in zip(elems, combine(prev, cur)))
        shift *= 2
    return elems


# ---------------------------------------------------------------------------
# the model-facing scans
# ---------------------------------------------------------------------------

def mamba_assoc_scan(dA: torch.Tensor, dBx: torch.Tensor, h0: torch.Tensor
                     ) -> torch.Tensor:
    """Chunked selective scan ``h_t = dA_t · h_{t-1} + dBx_t`` over axis 1.

    dA, dBx: (B, c, Di, N) fp32;  h0: (B, Di, N) → states (B, c, Di, N).
    One launch on CUDA, which writes the states only (the gains are not
    needed); the plain fold on the CPU."""
    if dA.device.type == "cpu":
        _, states = batched_scan(
            (dA, dBx), combine=affine_combine, units=AFFINE_UNITS,
            carry0=(torch.ones_like(h0), h0), inclusive=True)
        return states
    _, states = affine_scan(dA.contiguous(), dBx.contiguous(),
                            torch.ones_like(h0), h0.contiguous(),
                            inclusive=True, gains=False)
    return states


def mamba_assoc_scan_ref(dA: torch.Tensor, dBx: torch.Tensor,
                         h0: torch.Tensor) -> torch.Tensor:
    """Associative-scan oracle (the "lax" model path)."""
    prefA, within = associative_scan(affine_combine, (dA, dBx), dim=1)
    return within + prefA * h0[:, None]


def mamba_seq_scan_ref(dA: torch.Tensor, dBx: torch.Tensor,
                       h0: torch.Tensor) -> torch.Tensor:
    """Honest per-step fold — the launch-per-step baseline."""
    _, states = fold((dA, dBx), affine_combine, (torch.ones_like(h0), h0),
                     inclusive=True, axis=1)
    return states


def mlstm_carry_scan(la: torch.Tensor, mS: torch.Tensor, Chat: torch.Tensor,
                     nhat: torch.Tensor, carry0):
    """Exclusive monoid scan over the chunk axis → state ENTERING each chunk.

    la, mS: (nc, B, H);  Chat: (nc, B, H, dh, dh);  nhat: (nc, B, H, dh) —
    per-chunk summaries.  ``carry0 = (m0, C0, n0)`` is the state entering
    chunk 0.  Returns (la_ent, m_ent, C_ent, n_ent) with
    ``ent[k] = carry0 ∘ e_0 ∘ … ∘ e_{k-1}`` — one launch on CUDA.
    """
    m0, C0, n0 = carry0
    return tree_scan((la, mS, Chat, nhat), combine=logspace_affine_combine,
                     units=LOGSPACE_UNITS,
                     carry0=(torch.zeros_like(m0), m0, C0, n0),
                     inclusive=False)


def mlstm_carry_scan_ref(la, mS, Chat, nhat, carry0):
    """Sequential-fold oracle for the exclusive carry scan."""
    m0, C0, n0 = carry0
    return fold((la, mS, Chat, nhat), logspace_affine_combine,
                (torch.zeros_like(m0), m0, C0, n0), inclusive=False, axis=0)


__all__ = [
    "LOG_ZERO", "affine_combine", "AFFINE_UNITS",
    "logspace_affine_combine", "LOGSPACE_UNITS", "associative_scan",
    "mamba_assoc_scan", "mamba_assoc_scan_ref", "mamba_seq_scan_ref",
    "mlstm_carry_scan", "mlstm_carry_scan_ref",
]
