"""Fused int8 base + perturbed-LoRA matmul (K3), and the matmul-equivalent
int8 convs routed to the dequant-matmul contract.

Port of ``hyperscalees_t2i_tpu/ops/fused_qlora.py``. There the Pallas kernel
``_qlora_kernel`` dequantizes one ``[din, bn]`` s8 base tile in VMEM and
runs the member's perturbed-LoRA chain against the same token tile. Here the
kernel is ``csrc/fused_qlora.cu`` (its note says what bounds it and how it
is tiled): the base term on K1's tensor-core mainloop (``csrc/int8_tile.cuh``)
with the thin products as extra mma columns, built by ``nvcc`` at first use
and called through ``ctypes`` on PyTorch's current stream. It tiles ``din``
itself, so the JAX package's VMEM budget (``_fit_blocks``) has no
counterpart. The routing switch ``HSES_FUSED_QLORA`` is not ported: routing
is always on.

- :func:`fused_qlora_applies` / :func:`fused_qlora_dense` — what
  ``models.nn.dense`` calls at an int8 site whose adapter leaf carries both
  factors as ``lora.FactoredDelta``: 2D per-channel nodes go to the kernel;
  any other layout (GGUF block scales, one factor raw) to the composition
  ``dequant_matmul + lora.fused_lora_delta``.
- :func:`fused_qlora_matmul` — the kernel's wrapper. A CPU tensor takes the
  plain version :func:`fused_qlora_reference`; a CUDA tensor launches the
  kernel once or raises. ``fused_qlora_matmul.launches`` counts kernel
  launches (not a CUDA graph's capture, whose replays run the kernel
  without the wrapper).
- :func:`_plan` — the kernel's route for one call, a pure function of the
  shape, lanes, dtype and pointers, so that the CPU tests can hold it to the
  kernel's batch- and lane-invariance rule.
- :func:`conv_kernel_q8_matmul` — 1×1 and patch convs as int8 matmuls.

ES needs no gradient, so there is no backward kernel: the step runs under
``torch.inference_mode()``.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..obs.program_cost import kernel_cost, tensor_bytes
from .fused_lora import CHAIN_ARGTYPES, DTYPE_NAMES, chain_cost, chain_launch_args, chain_reference
from .quant_mm import F32_ROWS8, F32_TILE, Plan, copy_widths, dequant_matmul, mma_tile


def _plan(rows_per_lane: int, lanes: int, K: int, N: int, dtype: torch.dtype, x_ptr: int = 0,
          q_ptr: int = 0) -> Plan:
    """The kernel's route for ``lanes`` groups of ``x[rows_per_lane, K]``
    against ``q8[K, N]``.

    The tile may follow the rows, the lanes and N: bf16 takes K1's rule
    (``quant_mm.mma_tile``) over ``lanes × ⌈rows_per_lane / BM⌉ × ⌈N / BN⌉``
    blocks: 128×128 at T = 1024 (144 blocks at N = 2240), 16×64 at T = 32
    (70); f32 the 8-row layout at ≤ 8 rows a lane, else 64×64. The order of
    each output's sum over k may not: ``bk`` is the depth of one stage of it
    (64: k16 mma steps in ascending k; 32: FMA chunks added in order), and
    the C entry runs only at its own. Copy widths as K1's."""
    if dtype == torch.float32:
        return Plan(F32_ROWS8 if rows_per_lane <= 8 else F32_TILE, 32, 0, 0)
    if dtype != torch.bfloat16:
        raise TypeError(f"fused_qlora_matmul takes bf16 or f32 activations, got {dtype}")
    return Plan(mma_tile(rows_per_lane, lanes, N), 64, *copy_widths(K, N, x_ptr, q_ptr))


def fused_qlora_reference(x: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor,
                          a: Any, b: Any, lora_scale: float) -> torch.Tensor:
    """Plain version: f32 dequant matmul plus ``lora_scale`` times the f32
    chain, cast to x's dtype."""
    n = max(a.c.shape[0] if a.c.ndim else 0, 1)
    x3 = x.reshape(n, -1, x.shape[-1]).to(torch.float32)
    w = q8.to(torch.float32) * scale.to(torch.float32)
    y = x3 @ w + lora_scale * chain_reference(x3, a, b)
    return y.reshape(*x.shape[:-1], q8.shape[-1]).to(x.dtype)


def _launch(x: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor, out: torch.Tensor, args: List[Any],
            ndt: torch.dtype, lora_scale: float, plan: Plan) -> None:
    """One launch of the kernel by ``plan`` on x's device and current stream;
    ``args`` are :func:`chain_launch_args`'s."""
    from ._build import entry

    fn = entry("fused_qlora", f"hses_fused_qlora_{DTYPE_NAMES[x.dtype]}_{DTYPE_NAMES[ndt]}",
               [ctypes.c_void_p] * 4 + CHAIN_ARGTYPES + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), q8.data_ptr(), scale.data_ptr(), out.data_ptr(), *args, float(lora_scale),
                 plan.tile, plan.bk, plan.a_vec, plan.b_vec, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_qlora kernel launch failed: cudaError {err}")


def fused_qlora_cost(x: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor,
                     a: Any, b: Any, lora_scale: float) -> Tuple[int, int]:
    """``(FLOPs, bytes)`` of one call: K1's ``2·M·N·K`` plus the chain's
    (``fused_lora.chain_cost``); x, q8, scale and the factors read once,
    the output written once."""
    din, dout = q8.shape[-2:]
    flops, nbytes, rows = chain_cost(x, a, b)
    return 2 * rows * din * dout + flops, nbytes + tensor_bytes(q8, scale) + rows * dout * x.element_size()


@kernel_cost(fused_qlora_cost)
def fused_qlora_matmul(x: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor,
                       a: Any, b: Any, lora_scale: float) -> torch.Tensor:
    """``x @ (q8·scale) + lora_scale·(x@a_k)@b_k`` for one 2D per-channel
    int8 node and one member's (or a lane group's) factored adapter leaf.

    ``x``: ``[..., din]`` bf16 or f32; ``q8`` s8 ``[din, dout]``; ``scale``
    f32 ``[1, dout]``; ``a``/``b``: ``lora.FactoredDelta`` with ``a.w
    [din, r_l]``, ``b.w [r_l, dout]``. Returns ``[..., dout]`` in x's dtype.
    On the CPU this is the plain version; on CUDA the kernel runs on the
    current stream, and anything it does not take raises."""
    if x.device.type == "cpu":
        return fused_qlora_reference(x, q8, scale, a, b, lora_scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_qlora_matmul runs on cuda or cpu tensors, got {x.device}")
    if x.dtype not in DTYPE_NAMES:
        raise TypeError(f"fused_qlora_matmul takes bf16 or f32 activations, got {x.dtype}")
    if q8.dtype != torch.int8 or q8.ndim != 2:
        raise TypeError(f"q8 must be a 2D int8 tensor, got {q8.dtype} {tuple(q8.shape)}")
    din, dout = q8.shape
    if scale.dtype != torch.float32 or tuple(scale.shape) != (1, dout):
        raise TypeError(f"scale must be f32 [1, {dout}], got {scale.dtype} {tuple(scale.shape)}")
    if tuple(b.w.shape[-1:]) != (dout,):
        raise ValueError(f"b.w {tuple(b.w.shape)} does not match the base's {dout} outputs")
    if not (q8.device == x.device == scale.device):
        raise ValueError(f"x, q8, scale on different devices: {x.device}, {q8.device}, {scale.device}")
    x = x.contiguous()
    q8, scale = q8.contiguous(), scale.contiguous()
    rows = x.numel() // din if din else 0
    if rows >= 2**31 or din >= 2**31 or dout >= 2**31:
        raise ValueError("fused_qlora_matmul dimensions must fit in 32 bits")
    args, ndt, _keep = chain_launch_args(x, a, b, rows)
    out = torch.empty(*x.shape[:-1], dout, dtype=x.dtype, device=x.device)
    if rows == 0 or dout == 0:
        return out
    rows_per_lane, lanes = args[8:10]  # after the factors' 8 pointers
    plan = _plan(rows_per_lane, lanes, din, dout, x.dtype, x.data_ptr(), q8.data_ptr())
    _launch(x, q8, scale, out, args, ndt, lora_scale, plan)
    if not torch.cuda.is_current_stream_capturing():  # a graph's replays run what a capture records
        fused_qlora_matmul.launches += 1
    return out


fused_qlora_matmul.launches = 0


def fused_qlora_applies(leaf: Dict[str, Any]) -> bool:
    """True when the adapter leaf at an int8 dense site carries both factors
    as ``lora.FactoredDelta`` (the ``pop_fuse`` member path): the site then
    resolves through :func:`fused_qlora_dense`."""
    from ..lora import FactoredDelta

    return isinstance(leaf.get("a"), FactoredDelta) and isinstance(leaf.get("b"), FactoredDelta)


def fused_qlora_dense(x: torch.Tensor, qk: Dict[str, torch.Tensor], leaf: Dict[str, Any],
                      lora_scale: float) -> torch.Tensor:
    """``x @ dequant(qk) + lora_scale·(x@a_k)@b_k`` for one member's factored
    adapter leaf over an int8 node: 2D per-output-channel nodes with 2D
    factors through :func:`fused_qlora_matmul` (K3); every other layout
    through ``dequant_matmul`` plus ``lora.fused_lora_delta``, as the JAX
    package composes it."""
    from ..lora import FactoredDelta, fused_lora_delta

    a, b = leaf["a"], leaf["b"]
    q8, scale = qk["q8"], qk["scale"]
    if (isinstance(a, FactoredDelta) and isinstance(b, FactoredDelta)
            and a.w.ndim == 2 and b.w.ndim == 2
            and q8.ndim == 2 and tuple(scale.shape) == (1, q8.shape[-1])):
        return fused_qlora_matmul(x, q8, scale, a, b, lora_scale)
    return dequant_matmul(x, qk) + fused_lora_delta(x, leaf, lora_scale)


def conv_kernel_q8_matmul(
    x: torch.Tensor,
    qk: Dict[str, torch.Tensor],
    stride: int,
    padding: str,
    groups: int,
) -> Optional[torch.Tensor]:
    """An int8 conv that is a matmul, computed as one; ``None`` otherwise.

    ``x`` is NHWC and ``qk["q8"]`` HWIO. Two exact rewrites:

    - 1×1 stride 1: a per-pixel matmul over the channel axis;
    - p×p stride p on a p-divisible grid (patch embed): non-overlapping
      patches, so im2col is a reshape/transpose to ``[B, H/p, W/p, p·p·cin]``
      against the kernel reshaped to ``[p·p·cin, cout]`` (HWIO order is the
      patch's (h, w, c) order).

    Grouped convs, overlapping windows, explicit padding and block scales
    return ``None``."""
    if groups != 1:
        return None
    if not isinstance(padding, str) or padding.upper() not in ("SAME", "VALID"):
        return None
    q8, scale = qk["q8"], qk["scale"]
    if q8.ndim != 4 or tuple(scale.shape[:-1]) != (1, 1, 1):
        return None
    kh, kw, cin, cout = q8.shape
    flat_scale = scale.reshape(1, cout)
    if kh == 1 and kw == 1 and stride == 1:
        return dequant_matmul(x, {"q8": q8.reshape(cin, cout), "scale": flat_scale})
    B, H, W, C = x.shape
    if kh == kw == stride and H % kh == 0 and W % kw == 0 and C == cin:
        p = kh
        xp = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
        xp = xp.reshape(B, H // p, W // p, p * p * C)
        return dequant_matmul(xp, {"q8": q8.reshape(p * p * cin, cout), "scale": flat_scale})
    return None
