"""Int8 weight-only quantization of the frozen base (port of
``hyperscalees_t2i_tpu/ops/quant.py``).

Per-output-channel symmetric int8: ``w ≈ q · scale`` with ``q ∈ int8`` and
``scale = max|w| / 127`` per output channel. Kernel layouts (the JAX
package's, kept at every public function of the port):

- 2D ``[din, dout]`` dense                      → scale ``[1, dout]``
- 3D ``[L, din, dout]`` stacked dense           → scale ``[L, 1, dout]``
- 4D ``[kh, kw, cin, cout]`` conv HWIO          → scale ``[1, 1, 1, cout]``
- 5D ``[L, kh, kw, cin, cout]`` stacked conv    → scale ``[L, 1, 1, 1, cout]``

Odd ranks carry a leading stack axis whose layers keep their own scales.
:func:`dequantize_kernel` also takes GGUF Q8_0 *block* scales
(``scale [..., nb, dout]`` with ``nb·block == din``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch

Params = Dict[str, Any]

# Layers below this many parameters stay float (counted over the whole,
# possibly stacked, tensor — as the JAX package counts them).
DEFAULT_MIN_SIZE = 1 << 16
# the environment variable that overrides DEFAULT_MIN_SIZE for the base_quant knob
MIN_SIZE_ENV = "HSES_BASE_QUANT_MIN_SIZE"

BASE_QUANT_MODES = ("off", "int8")


def _scale_axes(ndim: int) -> Tuple[int, ...]:
    """Reduction axes of the per-output-channel amax: all but the last and,
    for odd ranks, the leading stack axis."""
    if ndim < 2:
        raise ValueError(f"kernel must be at least 2D, got ndim={ndim}")
    lead = 1 if ndim % 2 else 0
    return tuple(range(lead, ndim - 1))


def quantize_kernel(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """float kernel → ``{"q8": int8, "scale": f32}`` (layouts above). A
    stacked kernel is quantized one layer at a time (the same numbers, with
    one layer's f32 temporaries instead of the stack's)."""
    if w.ndim % 2:
        q8 = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        scales = []
        for i in range(w.shape[0]):
            layer = quantize_kernel(w[i])
            q8[i] = layer["q8"]
            scales.append(layer["scale"])
        return {"q8": q8, "scale": torch.stack(scales)}
    w32 = w.to(torch.float32)
    amax = w32.abs().amax(dim=_scale_axes(w.ndim), keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q8": q, "scale": scale}


def dequantize_kernel(qk: Dict[str, torch.Tensor], dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``q · scale`` in f32, cast to ``dtype``; per-channel or block scales."""
    q, scale = qk["q8"], qk["scale"]
    nb = scale.shape[-2]
    if nb > 1 and nb != q.shape[-2]:
        if q.shape[-2] % nb:
            raise ValueError(f"block scales {tuple(scale.shape)} do not tile kernel {tuple(q.shape)}")
        block = q.shape[-2] // nb
        qb = q.reshape(*q.shape[:-2], nb, block, q.shape[-1])
        w = qb.to(torch.float32) * scale.unsqueeze(-2)
        return w.reshape(q.shape).to(dtype)
    return (q.to(torch.float32) * scale).to(dtype)


def quantize_tree(params: Params, min_size: int = DEFAULT_MIN_SIZE) -> Params:
    """Replace every ``{"kernel": w}`` node with at least ``min_size``
    elements by ``{"kernel_q8": {...}, "bias": ...}``. Already-quantized
    nodes pass through."""
    if isinstance(params, dict):
        w = params.get("kernel")
        if torch.is_tensor(w) and w.ndim >= 2 and w.numel() >= min_size:
            out = {k: v for k, v in params.items() if k != "kernel"}
            out["kernel_q8"] = quantize_kernel(w)
            return out
        return {k: quantize_tree(v, min_size) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(quantize_tree(v, min_size) for v in params)
    return params


def resolve_base_quant_min_size(min_size: Optional[int] = None) -> int:
    """The ``min_size`` the ``base_quant`` knob applies: an explicit value,
    else ``HSES_BASE_QUANT_MIN_SIZE`` from the environment, else
    :data:`DEFAULT_MIN_SIZE` (the JAX package's order)."""
    if min_size is not None:
        return min_size
    return int(os.environ.get(MIN_SIZE_ENV, DEFAULT_MIN_SIZE))


def maybe_quantize_tree(tree: Params, base_quant: str, min_size: Optional[int] = None) -> Params:
    """The ``base_quant`` knob on one frozen tree: ``off`` returns the tree
    unchanged (same object); ``int8`` quantizes every kernel node of at
    least :func:`resolve_base_quant_min_size` elements."""
    if base_quant in (None, "", "off", False):
        return tree
    if base_quant != "int8":
        raise ValueError(f"base_quant must be one of {BASE_QUANT_MODES}, got {base_quant!r}")
    return quantize_tree(tree, resolve_base_quant_min_size(min_size))
