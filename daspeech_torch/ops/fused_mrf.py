"""One HiFi-GAN MRF level: plain PyTorch version and the CUDA kernel.

Counterpart of ``daspeech_tpu/ops/fused_mrf.py``. A level of the vocoder is
its ResBlock1 modules (config_v1: kernels 3/7/11, dilations 1/3/5 each) run
on the same input and averaged: 18 chained 1-D convs with leaky-ReLU
pre-activations and residual adds. The CUDA kernel (``csrc/fused_mrf.cu``)
replaces the Pallas ``mrf_level`` (``fused_mrf.py:156``; ``_mrf_kernel`` at
:87); it computes in the port's ``[B, C, T]`` layout, not the TPU's folded
``[B, T/f, f*C]`` view, one launch per conv, each an implicit GEMM on the
tensor cores over per-tap shifted views of a staged input tile.

Two modes, picked by the weights' dtype. fp32 weights: every product in
3xTF32, which keeps fp32's accuracy. bf16 weights (a bf16 vocoder; JAX's
TPU kernel always takes these, ``fused_mrf.py:120``, ``:178``): each conv's
input activation rounded to bf16, native bf16 products with fp32 sums;
the residual spine, biases, sequence masking, the average and the output
stay fp32, as in the Pallas kernel. The bf16 mode has kernels of its own
(``csrc/mrf_bf16.cuh``): inside the level each conv's input is a bf16
``[B, T, C]`` tensor of lrelu'd, rounded values that the conv before it
wrote, a tap contracts all input channels at once on the bf16 tensor
cores, and the taps are read in their ``[in, out]`` layout
(:func:`pack_bf16_taps`).

Inference only, as in JAX: neither version has a gradient. CPU tensors take
the plain version (:func:`mrf_level_ref`, the convs through ``F.conv1d``);
CUDA tensors launch the kernel, which raises on what it does not take.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from daspeech_torch.ops import _build

LRELU_SLOPE = 0.1
TILES = (64, 128)           # output frames per block the kernel is built for
MAX_KERNEL = 17             # largest conv kernel size the kernel takes
MAX_CHANNELS = 128
BF16_MIN_CHANNELS = 16      # the bf16 kernel's channels (a k-step of 16)


def prepare_level(resblocks, dtype: torch.dtype = torch.float32
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack a level's ResBlock1 conv weights and biases for :func:`mrf_level`:
    ``W [n_taps, C, C]`` in ``dtype`` (each conv's taps in order, each tap
    ``[in, out]``) and fp32 ``biases [n_convs, C]``, convs in the order
    block, dilation, (``convs1``, ``convs2``) — the order of
    ``fused_mrf.prepare_level``."""
    mats, biases = [], []
    for blk in resblocks:
        for c1, c2 in zip(blk.convs1, blk.convs2):
            for conv in (c1, c2):
                mats.append(conv.weight.permute(2, 1, 0))
                biases.append(conv.bias)
    return (torch.cat(mats).to(dtype).contiguous(),
            torch.stack(biases).contiguous())


def pack_bf16_taps(W: torch.Tensor) -> torch.Tensor:
    """The bf16 taps ``[n_taps, C, C]`` (in, out) as the bf16 kernel reads
    them: ``[n_taps, CP, CP]`` with CP = max(C, 16), zero beyond C (a k-step
    of the bf16 products is 16 input channels, and the tile of a tap 16
    output channels at least). The layout is unchanged: its rows are the
    contraction, which ldmatrix.trans turns into the products' fragments,
    so for C >= 16 this is ``W`` itself."""
    n, C, _ = W.shape
    if C >= BF16_MIN_CHANNELS:
        return W.contiguous()
    Wp = W.new_zeros(n, BF16_MIN_CHANNELS, BF16_MIN_CHANNELS)
    Wp[:, :C, :C] = W
    return Wp


def mrf_level_ref(x: torch.Tensor, W: torch.Tensor, biases: torch.Tensor,
                  kernel_sizes: Sequence[int],
                  dilations: Sequence[Sequence[int]]) -> torch.Tensor:
    """The average over blocks of the ResBlock1 chains, x ``[B, C, T]`` ->
    ``[B, C, T]``, with ``F.conv1d`` (SAME zero padding at every conv). With
    bf16 ``W`` each conv's input activation is rounded to bf16 and the
    products summed in fp32 (the Pallas kernel's ``operand_dtype``); the
    rest stays fp32."""
    conv1d = F.conv1d
    if W.dtype == torch.bfloat16:
        W = W.float()

        def conv1d(a, w, b, **kw):
            return F.conv1d(a.to(torch.bfloat16).float(), w, b, **kw)
    tap, conv, out = 0, 0, None
    for k, ds in zip(kernel_sizes, dilations):
        cur = x
        for d in ds:
            w1 = W[tap:tap + k].permute(2, 1, 0)
            w2 = W[tap + k:tap + 2 * k].permute(2, 1, 0)
            xt = conv1d(F.leaky_relu(cur, LRELU_SLOPE), w1, biases[conv],
                        padding=(k - 1) // 2 * d, dilation=d)
            xt = conv1d(F.leaky_relu(xt, LRELU_SLOPE), w2,
                        biases[conv + 1], padding=(k - 1) // 2)
            cur = cur + xt
            tap, conv = tap + 2 * k, conv + 2
        out = cur if out is None else out + cur
    return out / len(kernel_sizes)


def _check(x, W, biases, kernel_sizes, dilations, tile):
    _build.check_inputs("mrf_level", x, W, biases,
                        dtype=(torch.float32, W.dtype, torch.float32))
    if x.dim() != 3:
        raise ValueError(f"mrf_level: x must be [B, C, T], got {tuple(x.shape)}")
    B, C, T = x.shape
    n_dil = len(dilations[0]) if dilations else 0
    if C > MAX_CHANNELS or C & (C - 1) or B < 1 or T < 1:
        raise ValueError(f"mrf_level: x {tuple(x.shape)} unsupported (the "
                         f"kernel takes C a power of two <= {MAX_CHANNELS})")
    if (not kernel_sizes or len(dilations) != len(kernel_sizes) or n_dil < 1
            or any(len(ds) != n_dil for ds in dilations)
            or any(k < 1 or k > MAX_KERNEL or k % 2 == 0
                   for k in kernel_sizes)
            or any(d < 1 for ds in dilations for d in ds)):
        raise ValueError(f"mrf_level: kernel sizes {tuple(kernel_sizes)} / "
                         f"dilations {tuple(map(tuple, dilations))} "
                         f"unsupported (odd sizes <= {MAX_KERNEL}, the same "
                         "number of dilations >= 1 in every block)")
    n_taps = 2 * n_dil * sum(kernel_sizes)
    n_convs = 2 * n_dil * len(kernel_sizes)
    if W.shape != (n_taps, C, C) or biases.shape != (n_convs, C):
        raise ValueError(f"mrf_level: bad shapes W{tuple(W.shape)} "
                         f"biases{tuple(biases.shape)}, expected "
                         f"({n_taps}, {C}, {C}) and ({n_convs}, {C})")
    if tile is not None and tile not in TILES:
        raise ValueError(f"mrf_level: tile {tile} not in {TILES}")


def pick_tile(B: int, T: int, device) -> int:
    """The kernel's tile for x ``[B, C, T]``: 128 output frames a block
    (each staged weight slice serves more frames) when the batch's
    128-frame tiles fill the card's SMs twice over, else 64 (the most
    blocks: a chunk window of one utterance)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return 128 if B * -(-T // 128) >= 2 * sms else 64


def mrf_level_kernel(x: torch.Tensor, W: torch.Tensor, biases: torch.Tensor,
                     kernel_sizes: Sequence[int],
                     dilations: Sequence[Sequence[int]],
                     tile: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel: x ``[B, C, T]`` -> the level's output."""
    _check(x, W, biases, kernel_sizes, dilations, tile)
    B, C, T = x.shape
    if tile is None:
        tile = pick_tile(B, T, x.device)
    n_dil = len(dilations[0])
    out = torch.empty_like(x)
    tmp = [torch.empty_like(x) if n_dil > i + 1 else None for i in range(2)]
    if W.dtype == torch.bfloat16:
        # the convs' bf16 inputs [B, T, CP]: the level's, the dilated
        # conv's output's and the running value's
        W = pack_bf16_taps(W)
        scratch = torch.empty(3, B, T, W.shape[1], dtype=torch.bfloat16,
                              device=x.device)
    else:
        scratch = torch.empty_like(x)    # each dilated conv's output
    ks = (ctypes.c_int * len(kernel_sizes))(*kernel_sizes)
    ds = (ctypes.c_int * (len(kernel_sizes) * n_dil))(
        *(d for blk in dilations for d in blk))
    with torch.cuda.device(x.device):
        rc = _build.entry("daspeech_mrf_level", W.dtype)(
            x.data_ptr(), W.data_ptr(), biases.data_ptr(), out.data_ptr(),
            _build.ptr(tmp[0]), _build.ptr(tmp[1]), scratch.data_ptr(), B, C,
            T, len(kernel_sizes), ks, n_dil, ds, tile, _build.stream_of(x))
    _build.check(rc, "daspeech_mrf_level")
    mrf_level.launches += 1
    mrf_level.bf16_launches += W.dtype == torch.bfloat16
    return out


def mrf_level(x: torch.Tensor, W: torch.Tensor, biases: torch.Tensor,
              kernel_sizes: Sequence[int],
              dilations: Sequence[Sequence[int]],
              tile: Optional[int] = None) -> torch.Tensor:
    """One MRF level (see :func:`mrf_level_ref`) from the stacked weights of
    :func:`prepare_level`; ``tile`` is the kernel's output frames per block
    (one of ``TILES``; None: :func:`pick_tile`).

    ``x`` and ``biases`` are fp32; ``W`` is fp32 (3xTF32 products) or bf16
    (each conv's input rounded to bf16, bf16 products with fp32 sums: the
    bf16 vocoder's level and the TPU kernel's arithmetic, on kernels of its
    own); the output is fp32. CPU tensors take the plain version. CUDA tensors launch the
    kernel, which takes contiguous inputs with C a power of two <= 128
    (C < 32 padded with zero channels inside it) and odd kernel sizes
    <= 17, and raises on anything else. Neither has a gradient: under
    autograd with an input that requires one, this raises. The fused MRF
    never quantizes (``hifigan.py:696-722``), so it has no int8 mode."""
    if (x.dtype != torch.float32 or biases.dtype != torch.float32
            or W.dtype not in (torch.float32, torch.bfloat16)):
        raise TypeError(f"mrf_level takes fp32 x and biases and fp32 or "
                        f"bf16 W, got {x.dtype}, {biases.dtype}, {W.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, W, biases)):
        raise RuntimeError("mrf_level is inference only: run it under "
                           "torch.no_grad() or torch.inference_mode()")
    if x.device.type == "cpu":
        return mrf_level_ref(x, W, biases, kernel_sizes, dilations)
    return mrf_level_kernel(x, W, biases, kernel_sizes, dilations, tile)


mrf_level.launches = 0
mrf_level.bf16_launches = 0     # of launches, those with bf16 W
