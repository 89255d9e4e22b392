"""ctypes bindings for the native host-side data engine
(``daspeech_native.cpp`` beside this file), and its plain numpy versions.

Counterpart of ``daspeech_tpu/data/native.py``, with two differences:

- the library is built from this package's own copy of the source, with
  ``g++``, into ``build/daspeech_torch/`` at the root of the checkout
  (never beside the source), under a name that carries a hash of the source
  and flags; each build writes a temporary file and commits it with
  ``os.replace``, so concurrent builds (test workers) never load a
  half-written library;
- a failed build raises. The numpy versions (``batch_by_size_plain``,
  ``pack_frames_plain``, ``pack_tokens_plain``) are called by name only.

The build runs at first use, never at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "daspeech_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "daspeech_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)


def library_path(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(source.read_bytes())
    return build_dir / f"libdaspeech_native_{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``source`` into ``build_dir`` unless a library for it exists;
    raises ``RuntimeError`` if ``g++`` is missing or fails."""
    out = library_path(source, build_dir)
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *GXX_FLAGS, str(source), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building the native data engine failed: "
                           f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native data engine failed "
                           f"({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)        # atomic: a half-written .so never loads
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded native library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    lib.batch_by_size.restype = ctypes.c_int64
    lib.batch_by_size.argtypes = (_I64P, _I64P, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int64, _I64P)
    lib.pack_frames.restype = None
    lib.pack_frames.argtypes = (_F32P, _I64P, ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_int64, _F32P)
    lib.pack_tokens.restype = None
    lib.pack_tokens.argtypes = (_I32P, _I64P, ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_int32, _I32P)
    return lib


def batch_by_size(
    indices: np.ndarray,
    num_tokens: np.ndarray,
    max_tokens: int = 0,
    max_sentences: int = 0,
    bsz_mult: int = 1,
) -> List[np.ndarray]:
    """fairseq-style token-budget batching (``data_utils_fast.pyx``):
    ``num_tokens`` is indexed by sample id; ``indices`` gives the
    (typically length-sorted) visit order. Returns a list of index arrays.
    """
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    num_tokens = np.ascontiguousarray(num_tokens, dtype=np.int64)
    n = len(indices)
    if n == 0:
        return []
    out = np.empty(n, dtype=np.int64)
    n_batches = library().batch_by_size(
        indices.ctypes.data_as(_I64P), num_tokens.ctypes.data_as(_I64P),
        n, max_tokens, max_sentences, max(bsz_mult, 1),
        out.ctypes.data_as(_I64P))
    return [indices[out == b] for b in range(n_batches)]


def batch_by_size_plain(indices, num_tokens, max_tokens=0, max_sentences=0,
                        bsz_mult=1) -> List[np.ndarray]:
    """The plain version of :func:`batch_by_size`."""
    indices = np.asarray(indices, dtype=np.int64)
    bsz_mult = max(bsz_mult, 1)
    batches: List[np.ndarray] = []
    start = 0
    max_len = 0
    i = 0
    n = len(indices)
    while i < n:
        tok = int(num_tokens[indices[i]])
        cand_max = max(max_len, tok)
        count = i - start + 1
        full = ((max_sentences and count > max_sentences)
                or (max_tokens and count * cand_max > max_tokens))
        if full and count > 1:
            size = i - start
            mod = size % bsz_mult
            keep = size - mod if (size > bsz_mult and mod) else size
            keep = keep or size
            batches.append(np.asarray(indices[start:start + keep]))
            start += keep
            max_len = max((int(num_tokens[j])
                           for j in indices[start:i + 1]), default=0)
        else:
            max_len = cand_max
        i += 1
    if start < n:
        batches.append(np.asarray(indices[start:]))
    return batches


def pack_frames(mats: Sequence[np.ndarray], t_cap: int) -> np.ndarray:
    """Collate [Ti, F] float32 matrices into zero-padded [B, t_cap, F]."""
    B = len(mats)
    F = mats[0].shape[1]
    out = np.zeros((B, t_cap, F), dtype=np.float32)
    flat = np.concatenate(
        [np.ascontiguousarray(m, dtype=np.float32).reshape(-1) for m in mats])
    offsets = np.zeros(B + 1, dtype=np.int64)
    np.cumsum([m.size for m in mats], out=offsets[1:])
    library().pack_frames(flat.ctypes.data_as(_F32P),
                          offsets.ctypes.data_as(_I64P), B, F, t_cap,
                          out.ctypes.data_as(_F32P))
    return out


def pack_frames_plain(mats: Sequence[np.ndarray], t_cap: int) -> np.ndarray:
    """The plain version of :func:`pack_frames`."""
    out = np.zeros((len(mats), t_cap, mats[0].shape[1]), dtype=np.float32)
    for b, m in enumerate(mats):
        rows = min(len(m), t_cap)
        out[b, :rows] = m[:rows]
    return out


def pack_tokens(seqs: Sequence[np.ndarray], t_cap: int,
                pad_value: int) -> np.ndarray:
    """Collate int32 token sequences into pad-filled [B, t_cap]."""
    B = len(seqs)
    out = np.full((B, t_cap), pad_value, dtype=np.int32)
    flat = np.concatenate(
        [np.ascontiguousarray(s, dtype=np.int32).reshape(-1)
         for s in seqs]) if B else np.zeros(0, np.int32)
    offsets = np.zeros(B + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    library().pack_tokens(flat.ctypes.data_as(_I32P),
                          offsets.ctypes.data_as(_I64P), B, t_cap,
                          pad_value, out.ctypes.data_as(_I32P))
    return out


def pack_tokens_plain(seqs: Sequence[np.ndarray], t_cap: int,
                      pad_value: int) -> np.ndarray:
    """The plain version of :func:`pack_tokens`."""
    out = np.full((len(seqs), t_cap), pad_value, dtype=np.int32)
    for b, s in enumerate(seqs):
        n = min(len(s), t_cap)
        out[b, :n] = s[:n]
    return out
