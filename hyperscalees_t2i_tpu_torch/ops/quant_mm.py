"""The int8 dequant-matmul ``x @ (q8 · scale)`` and its CUDA kernel.

Port of ``hyperscalees_t2i_tpu/ops/quant_mm.py``. There the Pallas kernel
``_int8_mm_kernel`` dequantizes the whole s8 ``[din, dout]`` kernel in VMEM
for each 256-token tile. Here the kernel is ``csrc/int8_matmul.cu`` (see the
note at its top for what bounds it and how it is tiled), built by ``nvcc`` at
first use and called through ``ctypes`` on PyTorch's current stream.

- :func:`int8_matmul` — the wrapper. A CPU tensor takes the plain version
  :func:`int8_matmul_reference`; a CUDA tensor launches the kernel or raises.
  ``int8_matmul.launches`` counts kernel launches (and nothing else).
- :func:`dequant_matmul` — the contract every int8 dense site resolves
  through (``models.nn.dense``, the 1×1 and patch convs of
  ``ops.fused_qlora.conv_kernel_q8_matmul``): 2D per-channel nodes go to
  :func:`int8_matmul`; GGUF block-scale nodes dequantize and use
  ``torch.matmul``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .quant import dequantize_kernel

_KERNEL_SOURCE = "int8_matmul"
_ENTRY = {torch.bfloat16: "hses_int8_matmul_bf16", torch.float32: "hses_int8_matmul_f32"}


def int8_matmul_reference(x: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 dequant, f32 ``torch.matmul``, cast to x's dtype."""
    w = q8.to(torch.float32) * scale.to(torch.float32)
    return torch.matmul(x.to(torch.float32), w).to(x.dtype)


def _entry(dtype: torch.dtype):
    from ._build import entry

    return entry(_KERNEL_SOURCE, _ENTRY[dtype], [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def int8_matmul(x: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x @ (q8 · scale)`` for one 2D per-output-channel int8 node.

    ``x``: ``[..., din]`` bf16 or f32, contiguous; ``q8``: s8 ``[din, dout]``
    contiguous; ``scale``: f32 ``[1, dout]``. Returns ``[..., dout]`` in x's
    dtype. On the CPU this is the plain version; on CUDA the kernel runs on
    the current stream, and anything it does not take raises."""
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q8, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cuda or cpu tensors, got {x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"int8_matmul takes bf16 or f32 activations, got {x.dtype}")
    if q8.dtype != torch.int8 or q8.ndim != 2:
        raise TypeError(f"q8 must be a 2D int8 tensor, got {q8.dtype} {tuple(q8.shape)}")
    din, dout = q8.shape
    if scale.dtype != torch.float32 or tuple(scale.shape) != (1, dout):
        raise TypeError(f"scale must be f32 [1, {dout}], got {scale.dtype} {tuple(scale.shape)}")
    if x.shape[-1] != din:
        raise ValueError(f"x has {x.shape[-1]} input features, the kernel {din}")
    if not (x.is_contiguous() and q8.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int8_matmul needs contiguous x, q8 and scale")
    if not (q8.device == x.device == scale.device):
        raise ValueError(f"x, q8, scale on different devices: {x.device}, {q8.device}, {scale.device}")
    lead = x.shape[:-1]
    rows = x.numel() // din if din else 0
    out = torch.empty(*lead, dout, dtype=x.dtype, device=x.device)
    if rows == 0 or dout == 0:
        return out
    if rows >= 2**31 or din >= 2**31 or dout >= 2**31:
        raise ValueError("int8_matmul dimensions must fit in 32 bits")
    with torch.cuda.device(x.device):
        err = _entry(x.dtype)(
            x.data_ptr(), q8.data_ptr(), scale.data_ptr(), out.data_ptr(),
            rows, din, dout, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: cudaError {err}")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def dequant_matmul(x: torch.Tensor, qk: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``x @ dequant(qk)``: 2D per-channel nodes through :func:`int8_matmul`,
    block-scale nodes through dequantize + ``torch.matmul``."""
    q8, scale = qk["q8"], qk["scale"]
    if q8.ndim == 2 and tuple(scale.shape) == (1, q8.shape[-1]):
        return int8_matmul(x.contiguous(), q8, scale)
    return x @ dequantize_kernel(qk, x.dtype)
