"""The int8 dequant-matmul ``x @ (q8 · scale)`` and its CUDA kernel.

Port of ``hyperscalees_t2i_tpu/ops/quant_mm.py``. There the Pallas kernel
``_int8_mm_kernel`` dequantizes the whole s8 ``[din, dout]`` kernel in VMEM
for each 256-token tile. Here the kernel is ``csrc/int8_matmul.cu`` (see the
note at its top for what bounds it and how it is tiled), built by ``nvcc`` at
first use and called through ``ctypes`` on PyTorch's current stream.

- :func:`int8_matmul` — the wrapper. A CPU tensor takes the plain version
  :func:`int8_matmul_reference`; a CUDA tensor launches the kernel or raises.
  ``int8_matmul.launches`` counts kernel launches (and nothing else: not a
  CUDA graph's capture, whose replays run the kernel without the wrapper).
- :func:`_plan` — the kernel's route for one call (tile, depth of a stage of
  the k sum, copy widths), a pure function of the shape, dtype and pointers
  so that the CPU tests can hold it to the kernel's batch-invariance rule.
- :func:`dequant_matmul` — the contract every int8 dense site resolves
  through (``models.nn.dense``, the 1×1 and patch convs of
  ``ops.fused_qlora.conv_kernel_q8_matmul``): 2D per-channel nodes go to
  :func:`int8_matmul`; GGUF block-scale nodes dequantize and use
  ``torch.matmul``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from ..obs.program_cost import kernel_cost, tensor_bytes
from .quant import dequantize_kernel

_KERNEL_SOURCE = "int8_matmul"
_ENTRY = {torch.bfloat16: "hses_int8_matmul_bf16", torch.float32: "hses_int8_matmul_f32"}


# Tile ids of csrc/int8_matmul.cu's C entries
F32_ROWS8, F32_TILE, MMA_128x128, MMA_64x64, MMA_16x64 = range(5)
_SMS = 132  # streaming multiprocessors of an H100 SXM
# (id, BM, BN, least blocks): 128×128 from 0.9 of a wave, 64×64 from 100 blocks
_MMA_TILES = ((MMA_128x128, 128, 128, int(0.9 * _SMS)), (MMA_64x64, 64, 64, 100))


class Plan(NamedTuple):
    tile: int
    bk: int     # depth of one stage of each output's k sum; the C entry refuses any but its own
    a_vec: int  # elements of x per copy (8: 16-byte, 4: 8-byte cp.async, 1: element loads); 0 for f32
    b_vec: int  # bytes of q8 per copy (16: cp.async, 1: element loads); 0 for f32


def mma_tile(rows_per_lane: int, lanes: int, N: int, tiles=_MMA_TILES) -> int:
    """The first of ``tiles`` (id, BM, BN, least blocks) whose grid of
    ``lanes × ⌈rows_per_lane / BM⌉ × ⌈N / BN⌉`` blocks reaches its least
    count, else the 16×64 tile."""
    for tid, bm, bn, least in tiles:
        if lanes * -(-rows_per_lane // bm) * -(-N // bn) >= least:
            return tid
    return MMA_16x64


def copy_widths(K: int, N: int, x_ptr: int, q_ptr: int):
    """``(a_vec, b_vec)``: 16-byte copies of bf16 x need K % 8 and a
    16-byte-aligned x, 8-byte copies K % 4 and 8-byte alignment, else
    element loads; 16-byte copies of q8 need N % 16 and a 16-byte-aligned
    q8, else byte loads."""
    if K % 8 == 0 and x_ptr % 16 == 0:
        a_vec = 8
    elif K % 4 == 0 and x_ptr % 8 == 0:
        a_vec = 4
    else:
        a_vec = 1
    return a_vec, 16 if N % 16 == 0 and q_ptr % 16 == 0 else 1


def _plan(M: int, K: int, N: int, dtype: torch.dtype, x_ptr: int = 0, q_ptr: int = 0) -> Plan:
    """The kernel's route for ``x[M, K] @ q8[K, N]``.

    The tile may follow M: bf16 takes the 128×128 tile where it gives at
    least 0.9 of a wave of the card's SMs (≥ 118 blocks), else 64×64 where
    that gives ≥ 100 blocks, else 16×64 (M ≤ 50 lands there); f32 takes
    the 8-row layout at M ≤ 8, else 64×64.
    The order of each output's sum over k may not: bf16 sums 16-deep mma
    steps in ascending k through 64-deep stages, f32 sums 32-deep FMA chunks
    in ascending order, whatever the tile; ``bk`` is that depth, and the C
    entry runs only at its own. Copy widths as :func:`copy_widths`."""
    if dtype == torch.float32:
        return Plan(F32_ROWS8 if M <= 8 else F32_TILE, 32, 0, 0)
    if dtype != torch.bfloat16:
        raise TypeError(f"int8_matmul takes bf16 or f32 activations, got {dtype}")
    return Plan(mma_tile(M, 1, N), 64, *copy_widths(K, N, x_ptr, q_ptr))


def int8_matmul_reference(x: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 dequant, f32 ``torch.matmul``, cast to x's dtype."""
    w = q8.to(torch.float32) * scale.to(torch.float32)
    return torch.matmul(x.to(torch.float32), w).to(x.dtype)


def _entry(dtype: torch.dtype):
    from ._build import entry

    return entry(_KERNEL_SOURCE, _ENTRY[dtype], [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def _launch(x: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor, out: torch.Tensor, rows: int,
            plan: Plan) -> None:
    """One launch of the kernel by ``plan`` on x's device and current stream."""
    din, dout = q8.shape
    with torch.cuda.device(x.device):
        err = _entry(x.dtype)(
            x.data_ptr(), q8.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, din, dout,
            plan.tile, plan.bk, plan.a_vec, plan.b_vec, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: cudaError {err}")


def int8_matmul_cost(x: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor) -> Tuple[int, int]:
    """``(FLOPs, bytes)`` of one call: ``2·M·N·K``; x, q8 and scale read
    once, the output written once."""
    din, dout = q8.shape[-2:]
    rows = x.numel() // din if din else 0
    return 2 * rows * din * dout, tensor_bytes(x, q8, scale) + rows * dout * x.element_size()


@kernel_cost(int8_matmul_cost)
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
    _launch(x, q8, scale, out, rows, _plan(rows, din, dout, x.dtype, x.data_ptr(), q8.data_ptr()))
    if not torch.cuda.is_current_stream_capturing():  # a graph's replays run what a capture records
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
