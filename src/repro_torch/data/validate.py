"""Tensor auditing with by_blocks early abort (the paper's ``all``).

Production duty: before committing a checkpoint or serving a set of
weights, verify tensors are finite / token ids are in range.  The naive
reduction scans everything; the by_blocks schedule aborts at the first bad
block and bounds wasted verification work.

The audit runs on the tensor's own device: each geometric block's predicate
is a device reduction (``torch.isfinite(seg).all()``) and one bool crosses
to the host per block, O(log n) of them; the tensor itself never leaves the
device.  Results (``ok``, ``first_bad_block``, ``BlockStats``) equal
``repro.data.validate``'s on the same values.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..core import BlockStats, WorkRange, by_blocks

# float dtypes whose cast to fp32 is exact, so finiteness is read on the
# tensor as it is; any other (fp64) is cast block by block, as the
# reference casts the whole array
_EXACT_IN_FP32 = (torch.float32, torch.bfloat16, torch.float16)


@dataclasses.dataclass
class AuditResult:
    ok: bool
    first_bad_block: Optional[Tuple[int, int]] = None
    stats: Optional[BlockStats] = None


def _flat(x) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.reshape(-1)


def audit_array(x, predicate: Callable[[torch.Tensor], Any], *,
                first_block: int = 1 << 14) -> AuditResult:
    """Check ``predicate`` on geometric blocks of flat(x); abort on failure.
    ``predicate(seg)`` may return a 0-d tensor: its ``bool()`` is the one
    host synchronisation per block."""
    flat = _flat(x)
    bad: list = [None]
    bb = by_blocks(first=first_block)

    def block_fn(blk, carry):
        seg = flat[blk.start:blk.stop]
        if not bool(predicate(seg)):
            bad[0] = (blk.start, blk.stop)
            return True
        return carry

    _, stats = bb.run(WorkRange(0, flat.shape[0]), block_fn, False,
                      should_stop=lambda c: c)
    return AuditResult(ok=bad[0] is None, first_bad_block=bad[0], stats=stats)


def _finite(seg: torch.Tensor) -> torch.Tensor:
    if seg.is_floating_point() and seg.dtype not in _EXACT_IN_FP32:
        seg = seg.to(torch.float32)
    return torch.isfinite(seg).all()


def all_finite(x) -> AuditResult:
    return audit_array(x, _finite)


def tokens_in_range(tokens, vocab_size: int) -> AuditResult:
    return audit_array(tokens, lambda seg: ((seg >= -1)
                                            & (seg < vocab_size)).all())


def _leaves(tree: Any, path: str = ""):
    """(path, leaf) pairs in the order and spelling of JAX's
    ``tree_flatten_with_path`` + ``keystr``: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def audit_pytree(tree: Any) -> Tuple[bool, List[str]]:
    """All-finite audit over every float leaf of a params tree (nested
    dicts and lists of tensors); returns (ok, bad_leaf_paths)."""
    bad = []
    for path, leaf in _leaves(tree):
        t = leaf if isinstance(leaf, torch.Tensor) else \
            torch.as_tensor(np.asarray(leaf))
        if t.is_floating_point() and not all_finite(t).ok:
            bad.append(path)
    return (not bad), bad


__all__ = ["AuditResult", "audit_array", "all_finite", "tokens_in_range",
           "audit_pytree"]
