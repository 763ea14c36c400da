"""Build, bind and count the hand-written CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` is compiled on first use by ``nvcc``
for ``sm_90a`` into its own shared library under ``<repo>/build/kernels/``,
named by a hash of the source and the shared ``*.cuh`` headers so an edit
rebuilds it, and bound with ``ctypes``: every pointer and the stream go as
``c_void_p``, ints as ``c_int`` (``c_longlong`` for a byte count).  Each
source exposes plain C entry points that launch on the stream they are
given and return ``cudaGetLastError()``.

Nothing here runs at import: the CPU tests import every module, and a
machine without a card may have no ``nvcc``.  :func:`build_all` starts one
``nvcc`` per source at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
U = ctypes.c_uint
F = ctypes.c_float
LL = ctypes.c_longlong

# C signature of every entry point: (source stem, function) → argtypes
SIGNATURES: Dict[str, Dict[str, Sequence]] = {
    "flash_attention": {
        # q, k, v, o, m, l, acc (null unless split), arrive (null unless
        # the merge is fused), B, Sq, Sk, H, KV, hd (q/k), hdv, causal,
        # scale, q_offset, is_bf16, tensor_cores, nsplit, stream
        "flash_attention_fwd": [P] * 8 + [I] * 8 + [F, I, I, I, I, P],
        # m, l, acc, o, rows, hd, nsplit, stream
        "flash_attention_merge": [P, P, P, P, I, I, I, P],
    },
    "flash_decode": {
        # q, k, v, lengths, m, l, acc, out and arrive (null: partials
        # only), B, S, H, KV, hd, block_k, nsplit, scale, is_bf16,
        # tensor_cores, stream
        "flash_decode_partials": [P] * 9 + [I, I, I, I, I, I, I, F, I, I,
                                            P],
        # m, l, acc, out, B, H, hd, nsplit, is_bf16, stream
        "flash_decode_combine": [P, P, P, P, I, I, I, I, I, P],
    },
    "tile_scan": {
        # la, m, C, n, la0, m0, C0, n0, la_out, m_out, C_out, n_out,
        # L, G, FC, FN, inclusive, stream
        "tile_scan_logspace": [P] * 12 + [I, I, I, I, I, P],
        # a, b, a0, h0, gain_out (or null), h_out, B, L, F, inclusive, stream
        "tile_scan_affine": [P] * 6 + [I, I, I, I, P],
        # x, out, n, nt, r, inclusive, cluster (0: the rule), stream
        "tile_scan_add": [P, P, I, I, I, I, I, P],
    },
    "radix_sort": {
        # x, out, nt, tile, key_shift, total_bits, digit_bits, stream
        "radix_tile_sort": [P, P, I, I, I, I, I, P],
        # keys, out, nt, tile, n, idx_bits, sort_bits, digit_bits, unpack,
        # v2, threads (0: the rule), stream
        "radix_tile_sort_packed": [P, P] + [I] * 9 + [P],
        # x, local, hist, nt, tile, shift, bits, pack, idx_bits, stream
        "radix_mt_local": [P, P, P, I, I, I, I, I, I, P],
        # local, hist, base, out, nt, tile, radix, unpack_mask, unpack,
        # stream
        "radix_mt_scatter": [P, P, P, P, I, I, I, U, I, P],
    },
    "merge_sort": {
        # x, out, n, run, block, unpack_mask, unpack, v2, stream
        "merge_level": [P, P, I, I, I, U, I, I, P],
        # x, out, n, tile, stream
        "bitonic_tile_sort": [P, P, I, I, P],
        # keys, out, m, n, idx_bits, stream
        "pack_keys": [P, P, I, I, I, P],
        # x, out, m, idx_mask, stream
        "unpack_order": [P, P, I, U, P],
    },
    "moe_dispatch": {
        # x, experts, probs, hist, xd, sorted_e, sorted_tok, sorted_p,
        # counts, T, K, E, tile, bits, row_bytes, vec, p_size, counting,
        # stream
        "moe_dispatch": [P] * 9 + [I, I, I, I, I, LL, I, I, I, P],
    },
}


class Kernel:
    """One C entry point plus its launch counter.  ``launches`` counts the
    calls that launched the kernel on the card, and nothing else;
    ``tags`` counts the launches a wrapper tagged, among them (K1's fused
    split and non-causal launches, K2's GQA group); a launch may carry
    several tags."""

    def __init__(self, source: str, func: str):
        self.source, self.func = source, func
        self.launches = 0
        self.tags: Dict[str, int] = {}
        self._lib = self._fn = None

    def __call__(self, *args, tag: Union[str, Tuple[str, ...]] = ()
                 ) -> None:
        if self._fn is None:
            lib = ctypes.CDLL(str(build(self.source)))
            fn = getattr(lib, self.func)
            fn.argtypes = list(SIGNATURES[self.source][self.func])
            fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        err = self._fn(*args)
        if err != 0:
            name = self._lib.repro_error_string(err).decode()
            raise RuntimeError(
                f"{self.func} launch failed: cudaError {err} ({name})")
        self.launches += 1
        for t in (tag,) if isinstance(tag, str) else tag:
            self.tags[t] = self.tags.get(t, 0) + 1


KERNELS: Dict[str, Kernel] = {
    func: Kernel(src, func)
    for src, funcs in SIGNATURES.items() for func in funcs}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.tags.clear()


def launches() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built on the machine with the card")


def _lib_path(source: str) -> Path:
    """The library's path carries a hash of the source, the shared headers
    and the flags, so an edit to any of them builds a new library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [CSRC / f"{source}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{source}_{h.hexdigest()[:16]}.so"


def _start(source: str) -> "subprocess.Popen | None":
    out = _lib_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{source}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.out_path, proc.tmp_path = out, tmp
    return proc


def _finish(source: str, proc: "subprocess.Popen | None") -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(proc.tmp_path, proc.out_path)   # atomic: no half-written .so
    return log


def build(source: str) -> Path:
    """Build one source if its library is missing; return the library."""
    _finish(source, _start(source))
    return _lib_path(source)


# what every ``*_attrs`` entry point writes first (csrc/common.cuh
# ``kernel_attrs``)
ATTRIBUTES = ("registers", "spill_bytes", "static_smem", "dynamic_smem",
              "ctas_per_sm")


def attributes(source: str, func: str, *args: int,
               extra: Sequence[str] = ()) -> Dict[str, int]:
    """Call a source's attribute entry point ``func(int..., int* out)``:
    what the compiler and the occupancy calculator give one kernel, by
    name (:data:`ATTRIBUTES`, then the entry's ``extra`` fields)."""
    keys = ATTRIBUTES + tuple(extra)
    fn = getattr(ctypes.CDLL(str(build(source))), func)
    fn.argtypes = [I] * len(args) + [ctypes.POINTER(I)]
    fn.restype = I
    vals = (I * len(keys))()
    err = fn(*args, vals)
    if err:
        raise RuntimeError(f"{func}{args}: cudaError {err}")
    return dict(zip(keys, vals))


def build_all() -> Dict[str, str]:
    """Compile every kernel source in parallel (one ``nvcc`` each).  Returns
    each source's compiler log (``-Xptxas -v``: registers, shared memory,
    spills); empty for a library that was already built."""
    sources: List[str] = list(SIGNATURES)
    procs = {s: _start(s) for s in sources}
    return {s: _finish(s, procs[s]) for s in sources}


__all__ = ["Kernel", "KERNELS", "build", "build_all", "attributes",
           "reset_launches", "launches", "ATTRIBUTES", "BUILD_DIR"]
