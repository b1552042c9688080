"""``jax.image.resize`` on NHWC tensors, as separable weight matrices.

``jax.image.resize`` (``scale_and_translate``) samples at half-pixel
centres, widens the kernel by the downsampling factor (antialiasing), and
renormalizes each output's weights to sum to 1, so near the edges it
reweights the taps that fall inside the image instead of clamping the way
``F.interpolate`` does. :func:`resize_weights` builds the same ``[in, out]``
weights along one axis in f32 for the Keys cubic kernel (``"cubic"``, the
CLIP preprocessing and the VQ pyramid's upsampling) and the triangle kernel
(``"linear"``, the VQ pyramid's non-integer downsampling), once per size,
method, device and dtype; :func:`resize` applies them along H and W.
"""

from __future__ import annotations

import functools
from typing import Any

import torch


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


_KERNELS = {"cubic": _keys_cubic, "linear": _triangle}


@functools.lru_cache(maxsize=256)
def resize_weights(in_size: int, out_size: int, method: str = "cubic", device: Any = None,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``[in_size, out_size]`` weights of ``jax.image.resize(..., method)``
    with antialiasing along one axis: half-pixel centres, the kernel widened
    by the downsampling factor, each output's weights normalized to sum to
    1, outputs whose sample falls outside the input zeroed, computed in f32
    as ``jax.image.scale_and_translate`` computes them, then cast to
    ``dtype`` on ``device``. Cached: the scale loop asks for the same few
    matrices at every step, and callers must not write into them."""
    f32 = torch.float32
    kernel = _KERNELS[method]
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=f32)
    kernel_scale = torch.maximum(inv_scale, torch.tensor(1.0))
    sample_f = (torch.arange(out_size, dtype=f32) + 0.5) * inv_scale - 0.0 - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32)[:, None]).abs() / kernel_scale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device=device, dtype=dtype)


def resize(x: torch.Tensor, height: int, width: int, method: str = "cubic") -> torch.Tensor:
    """``[B, h, w, C]`` → ``[B, height, width, C]`` in x's dtype (the weights
    cast to it, as ``jax.image.resize`` casts them); an axis already at its
    size is left alone."""
    if x.shape[1] != height:
        x = torch.einsum("bhwc,hy->bywc", x, resize_weights(x.shape[1], height, method, x.device, x.dtype))
    if x.shape[2] != width:
        x = torch.einsum("bywc,wx->byxc", x, resize_weights(x.shape[2], width, method, x.device, x.dtype))
    return x
