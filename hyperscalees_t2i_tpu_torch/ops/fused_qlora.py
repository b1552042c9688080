"""Matmul-equivalent int8 convs routed to the dequant-matmul contract.

Port of ``conv_kernel_q8_matmul`` from
``hyperscalees_t2i_tpu/ops/fused_qlora.py``. The fused int8+LoRA kernel of
that module is training-only and is not part of this package yet. Routing is
always on here (the JAX package's ``HSES_FUSED_QLORA`` switch is not ported).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .quant_mm import dequant_matmul


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
