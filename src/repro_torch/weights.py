"""Carry weights across from the JAX package.

* :func:`from_numpy_params` turns a parameter tree of numpy arrays (the JAX
  package's params after ``np.asarray`` on each leaf, same nested dicts and
  lists) into the port's tree of tensors.  Both packages stack period
  params over repeats and keep unrolled prefix layers (deepseek's dense
  layer) as a 'prefix' list, so this is a leaf-by-leaf conversion with no
  renaming: the MLA mixer (``wq``, ``wkv_down``, ``wk_rope``, ``wkv_up``,
  ``wo``), the 2-matrix FFN's biases (``up_b``, ``down_b``), LayerNorm's
  ``scale`` / ``bias``, a cross-attention layer's ``ln_cross`` /
  ``cross`` and the encoder-decoder's ``enc_stage`` (one dict stacked over
  the encoder layers), ``enc_final_norm`` and ``dec_pos`` carry by name
  like every other leaf.
* :func:`load_checkpoint` reads a checkpoint directory written by
  ``repro.train.checkpoint`` with numpy alone: ``manifest.json`` plus one
  ``arr_*.npy`` per leaf, each leaf's sha256 checked against the manifest.
  bf16 leaves are stored as ``<u2`` and viewed back as ``torch.bfloat16``.
"""

from __future__ import annotations

import hashlib
import json
import re
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from .configs.base import ModelConfig

# numpy has no bf16/fp8: their bytes are stored and carried as unsigned ints
_VIEWS = {"bfloat16": (np.uint16, torch.bfloat16),
          "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
          "float8_e5m2": (np.uint8, torch.float8_e5m2)}


def _to_tensor(a: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    if dtype_name in _VIEWS:
        raw, tdt = _VIEWS[dtype_name]
        t = torch.from_numpy(np.array(a).view(raw)).view(tdt)
    else:
        t = torch.from_numpy(np.array(a))     # a writable copy
    return t.to(device)


# leaves the reference keeps in fp32 at every param_dtype: Mamba's A_log
# and D (repro/models/ssm.py mamba_init), keyed by (parent, leaf) name
FP32_LEAVES = {("mixer", "A_log"), ("mixer", "D")}


def from_numpy_params(tree: Any, cfg: ModelConfig, device="cuda",
                      _path: tuple = ()) -> Any:
    """numpy leaves → tensors on ``device``, checking the float leaves are
    in ``cfg.param_dtype`` (``FP32_LEAVES`` in fp32)."""
    if isinstance(tree, dict):
        return {k: from_numpy_params(v, cfg, device, _path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_numpy_params(v, cfg, device, _path + (i,))
                for i, v in enumerate(tree)]
    a = np.asarray(tree)
    name = a.dtype.name
    if a.dtype.kind == "f" or name in _VIEWS:
        want = "float32" if tuple(_path[-2:]) in FP32_LEAVES \
            else cfg.param_dtype
        if name != want:
            raise TypeError(f"leaf {list(_path)} dtype {name} != {want} "
                            f"(cfg.param_dtype {cfg.param_dtype})")
    return _to_tensor(a, name, device)


_TOKEN = re.compile(r"\[<flat index (\d+)>\]|\['([^']*)'\]|\[(\d+)\]|\.(\w+)")


def _parse_path(path: str) -> List[Any]:
    """``[<flat index 0>]['stage'][0]['mixer']['wq']`` → [0, 'stage', 0,
    'mixer', 'wq'] (ints index lists, strings key dicts)."""
    keys: List[Any] = []
    pos = 0
    for m in _TOKEN.finditer(path):
        if m.start() != pos:
            raise ValueError(f"unparsable checkpoint path {path!r}")
        flat, key, idx, attr = m.groups()
        keys.append(int(flat) if flat is not None else
                    key if key is not None else
                    int(idx) if idx is not None else attr)
        pos = m.end()
    if pos != len(path):
        raise ValueError(f"unparsable checkpoint path {path!r}")
    return keys


def _insert(root: Dict, keys: List[Any], value: Any) -> None:
    node = root
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _listify(node: Any) -> Any:
    """Dicts keyed 0..n-1 by ints become lists (the JAX tree's lists)."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        if sorted(out) != list(range(len(out))):
            raise ValueError(f"sparse list indices {sorted(out)}")
        return [out[i] for i in range(len(out))]
    return out


def load_checkpoint(directory, device="cuda") -> Any:
    """Read a checkpoint step directory into a tree of tensors.  A training
    checkpoint holds the train state ``(params, optimizer state)``, so the
    result is a list whose element 0 is the parameter tree."""
    d = Path(directory)
    manifest = json.loads((d / "manifest.json").read_text())
    root: Dict = {}
    for i, meta in enumerate(manifest["leaves"]):
        raw = np.load(d / f"arr_{i:05d}.npy")
        want = meta.get("sha256")
        if want:
            got = hashlib.sha256(raw.tobytes()).hexdigest()
            if got != want:
                raise ValueError(
                    f"checkpoint corruption: leaf {i} ({meta['path']}) "
                    f"sha256 {got[:12]}... != manifest {want[:12]}... in {d}")
        if list(raw.shape) != list(meta["shape"]):
            raise ValueError(f"leaf {i} ({meta['path']}): shape "
                             f"{raw.shape} != manifest {meta['shape']}")
        _insert(root, _parse_path(meta["path"]),
                _to_tensor(raw, meta["dtype"], device))
    return _listify(root)


__all__ = ["from_numpy_params", "load_checkpoint"]
