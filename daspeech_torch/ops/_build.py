"""Build and load the port's CUDA kernels.

Every ``.cu`` under ``daspeech_torch/csrc/`` (with the ``.cuh`` headers) is
compiled by ``nvcc`` for ``sm_90a``, one ``nvcc`` process per source, all
started together, and the objects are linked into ONE shared library with a
plain C interface, loaded with ``ctypes``. The library's file name carries
a hash of the sources and flags, so an edited kernel rebuilds and an
unchanged one is reused. The build runs at first use (never at import) into
``build/daspeech_torch/`` at the root of the checkout.

Each C entry point returns a ``cudaError_t`` (0 on success): the caller
raises on anything else, because a refused launch never runs and a later
``torch.cuda.synchronize()`` would not report it. An entry point whose name
ends in ``_bf16`` is the bf16 variant of the one without: the same
arguments, its operands and outputs bf16 in device memory (:func:`entry`),
except where the Pallas kernel keeps a tensor fp32: the MRF level's bf16
variant takes bf16 weights and fp32 activations, biases and output (and
bf16 scratch where the fp32 one takes ``ybuf``); the full-bias attention's
keeps its bias and dS fp32; the fused FFN's keeps LayerNorm's parameters
and the parameter gradients fp32 (and takes bf16 scratch). Every bf16
variant runs bf16 tensor-core kernels of its own: the packed, head-major
and full-bias attention's (``csrc/attention_bf16.cuh``), the rel-pos
attention's (``csrc/relpos_bf16.cuh``), the link extraction's
(``csrc/links_bf16.cuh``), the fused FFN's (``csrc/ffn_bf16.cuh``) and the
MRF level's (``csrc/mrf_bf16.cuh``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "daspeech_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float
# C signatures of the entry points in csrc/*.cu
SIGNATURES = {
    "daspeech_attention_fwd": (_P, _P, _P, _P, _P, _U, _F, _P, _P, _I, _I, _I,
                               _I, _I, _F, _P),
    "daspeech_attention_bwd": (_P, _P, _P, _P, _P, _U, _F, _P, _P, _P, _P,
                               _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "daspeech_attention_hm_fwd": (_P, _P, _P, _P, _P, _U, _F, _P, _P, _I, _I,
                                  _I, _I, _I, _F, _P),
    "daspeech_attention_hm_bwd": (_P, _P, _P, _P, _P, _U, _F, _P, _P, _P, _P,
                                  _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "daspeech_relpos_fwd": (_P, _P, _P, _P, _P, _P, _P, _U, _F, _P, _P, _I,
                            _I, _I, _I, _I, _F, _P),
    "daspeech_relpos_bwd": (_P, _P, _P, _P, _P, _P, _P, _U, _F, _P, _P, _P,
                            _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "daspeech_links_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                           _P),
    "daspeech_links_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                           _I, _I, _F, _I, _P),
    "daspeech_dag_fb_cluster": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "daspeech_dag_fb_max_clusters": (_I, _I, _I, _P),
    "daspeech_dag_viterbi_cluster": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                     _P),
    "daspeech_dag_viterbi_max_clusters": (_I, _I, _I, _P),
    "daspeech_dag_block": (_I, _I, _P, _P),
    "daspeech_mrf_level": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I,
                           _P, _I, _P),
    "daspeech_attention_fb_fwd": (_P, _P, _P, _P, _P, _U, _F, _P, _P, _I, _I,
                                  _I, _I, _I, _F, _P),
    "daspeech_attention_fb_bwd": (_P, _P, _P, _P, _P, _U, _F, _P, _P, _P, _P,
                                  _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "daspeech_ffn_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _U, _F, _I, _U,
                         _F, _P, _I, _I, _I, _I, _P),
    "daspeech_ffn_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _U, _F, _I,
                         _U, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _P, _I, _I, _I, _I, _I, _P),
}
# the bf16 variants (every kernel): the fp32 entry points' arguments, and
# in an attention forward the pointer of the fp32 output (out32) after the
# statistics'
BF16_ENTRIES = ("daspeech_attention_fwd", "daspeech_attention_bwd",
                "daspeech_attention_hm_fwd", "daspeech_attention_hm_bwd",
                "daspeech_relpos_fwd", "daspeech_relpos_bwd",
                "daspeech_links_fwd", "daspeech_links_bwd",
                "daspeech_mrf_level", "daspeech_attention_fb_fwd",
                "daspeech_attention_fb_bwd", "daspeech_ffn_fwd",
                "daspeech_ffn_bwd")
OUT32_AT = {"daspeech_attention_fwd": 9, "daspeech_attention_hm_fwd": 9,
            "daspeech_relpos_fwd": 11, "daspeech_attention_fb_fwd": 9}
SIGNATURES.update({
    f"{n}_bf16": (SIGNATURES[n] if n not in OUT32_AT else
                  SIGNATURES[n][:OUT32_AT[n]] + (_P,)
                  + SIGNATURES[n][OUT32_AT[n]:])
    for n in BF16_ENTRIES})


class Build(NamedTuple):
    path: Path
    seconds: float      # nvcc wall time (compiles and link); 0.0 when the
    #                     library existed
    ptxas: str          # nvcc's -Xptxas -v report (registers, spills, smem)


def _sources(csrc: Path):
    return sorted(csrc.glob("*.cu")), sorted(csrc.glob("*.cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "daspeech_torch cannot be built")


def _library_path(csrc: Path, build_dir: Path) -> Path:
    cu, cuh = _sources(csrc)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return build_dir / f"libdaspeech_kernels_{h.hexdigest()[:16]}.so"


def _run(procs) -> str:
    """Wait for every (cmd, Popen) pair; after all have ended, raise with
    the output of the first that failed. Returns their stderr, joined."""
    outs = [(cmd, p, *p.communicate()) for cmd, p in procs]
    for cmd, p, so, se in outs:
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{so}\n{se}")
    return "".join(se for _, _, _, se in outs)


def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Build:
    """Compile the kernels of ``csrc`` into ``build_dir`` unless a library
    for these sources exists: one ``nvcc -c`` per source, in parallel, then
    one link."""
    out = _library_path(csrc, build_dir)
    if out.exists():
        return Build(out, 0.0, "")
    build_dir.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources(csrc)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [build_dir / f"{tag}.{src.stem}.o" for src in cu]
    t0 = time.perf_counter()
    compiles = []
    for src, obj in zip(cu, objs):
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(csrc), "-c", "-o", str(obj),
               str(src)]
        compiles.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    ptxas = _run(compiles)
    tmp = out.with_name(f"{tag}.tmp.so")
    link = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(tmp), *map(str, objs)]
    _run([(link, subprocess.Popen(link, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True))])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)            # atomic: a half-written .so never loads
    return Build(out, time.perf_counter() - t0, ptxas)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    return load(build().path)


def load(path: Path, strict: bool = True) -> ctypes.CDLL:
    """Load a built kernel library and declare its entry points. Another
    tree's library (``chip_smoke.py --parent``) may lack entry points that
    this tree added (the ``_bf16`` variants before they existed): with
    ``strict=False`` those are left undeclared, and calling one raises
    AttributeError."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        try:
            fn = getattr(lib, name)
        except AttributeError:
            if strict:
                raise
            continue
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def entry(name: str, dtype: torch.dtype):
    """The C entry point ``name`` for operands of ``dtype``: its ``_bf16``
    variant for bfloat16."""
    lib = library()
    return getattr(lib, name if dtype == torch.float32 else f"{name}_bf16")


def check_inputs(name: str, *tensors, int32=(),
                 dtype=torch.float32) -> None:
    """Raise unless every tensor is contiguous, on one CUDA device and of
    its dtype — ``dtype`` is one dtype for all of ``tensors`` or a sequence
    of one per tensor — and every ``int32`` tensor is int32: what the
    kernels take."""
    dev = tensors[0].device
    for t in (*tensors, *int32):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel takes contiguous inputs")
    dtypes = ([dtype] * len(tensors) if isinstance(dtype, torch.dtype)
              else list(dtype))
    if len(dtypes) != len(tensors):
        raise ValueError(f"{name}: {len(dtypes)} dtypes for "
                         f"{len(tensors)} tensors")
    for t, want in zip(tensors, dtypes):
        if t.dtype != want:
            raise TypeError(f"{name}: kernel takes {want}, got {t.dtype}")
    for t in int32:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: kernel takes int32 lengths, got {t.dtype}")


def ptr(t) -> int:
    """``t.data_ptr()``, or 0 (NULL) for None."""
    return 0 if t is None else t.data_ptr()


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} failed with cudaError_t {rc}")


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
