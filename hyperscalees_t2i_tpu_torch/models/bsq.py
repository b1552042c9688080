"""Binary spherical quantization (BSQ) over the next-scale pyramid: the
Infinity tokenizer's math.

Port of ``hyperscalees_t2i_tpu/models/bsq.py``. A token is the sign
pattern of ``bits`` channels, each ±1/√C (vocab 2 a bit). The residual
pyramid is the VAR one (``models/msvq.py``'s ``up_bicubic`` and
``down_area``, the same functions the JAX package shares between its two
quantizers); φ is picked by the nearest rounded tick ``round(si/(S-1)·(K-1))``.

:func:`init_bsq` builds the JAX package's tree (φ convs ``[K, 3, 3, C, C]``
and the native norm-free decoder); :class:`BSQ` holds a tree as buffers.
A decoder subtree that carries a ``mid`` stack is a converted CompVis
decoder and runs through ``msvq.CompVisDecoder``. Under the int8 base the
decoder's convs at or above the quantization floor are int8 nodes
(``nn.Conv``); φ must stay float, as the JAX package's ``phi_apply``
reads its float kernel (:class:`BSQ` raises otherwise).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn as tnn

from ..utils import threefry
from . import nn
from .msvq import CompVisDecoder, down_area, up_bicubic

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class BSQConfig:
    bits: int = 16  # channels of the spherical code (vocab 2^bits implicit)
    patch_nums: Tuple[int, ...] = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)
    phi_partial: int = 4
    # decoder widths deepest → shallowest; each stage but the last doubles the grid
    dec_ch: Tuple[int, ...] = (512, 256, 256, 128, 128)
    dec_blocks: int = 1
    compute_dtype: Any = torch.bfloat16

    @property
    def num_scales(self) -> int:
        return len(self.patch_nums)

    @property
    def seq_len(self) -> int:
        return int(sum(p * p for p in self.patch_nums))

    @property
    def grid(self) -> int:
        return self.patch_nums[-1]


def init_bsq(cfg: BSQConfig, key: torch.Tensor) -> Params:
    """Random f32 parameters in the JAX package's tree layout (φ blend convs
    and the native decoder; no codebook: the code is the sign map), drawn on
    the key's device from its key tree (``init_bsq(key, cfg)``)."""
    C = cfg.bits
    ks = threefry.split(key, 3 + len(cfg.dec_ch) * (3 * cfg.dec_blocks + 1))
    params: Params = {
        "phi": {
            "kernel": threefry.normal(ks[0], (cfg.phi_partial, 3, 3, C, C)) / math.sqrt(9 * C),
            "bias": torch.zeros((cfg.phi_partial, C), device=key.device),
        }
    }
    dec: Params = {"conv_in": nn.conv_init(ks[1], 3, 3, C, cfg.dec_ch[0])}
    ki = 2
    stages: List[Params] = []
    prev = cfg.dec_ch[0]
    for s, ch in enumerate(cfg.dec_ch):
        stage: Params = {"blocks": []}
        for b in range(cfg.dec_blocks):
            cin = prev if b == 0 else ch
            stage["blocks"].append({
                "conv1": nn.conv_init(ks[ki], 3, 3, cin, ch),
                "conv2": nn.conv_init(ks[ki + 1], 3, 3, ch, ch),
                "skip": nn.conv_init(ks[ki + 2], 1, 1, cin, ch, bias=False) if cin != ch else None,
            })
            ki += 3
        if s < len(cfg.dec_ch) - 1:
            stage["up"] = nn.conv_init(ks[ki], 3, 3, ch, ch)
            ki += 1
        stages.append(stage)
        prev = ch
    dec["stages"] = stages
    dec["norm_out"] = nn.norm_init(cfg.dec_ch[-1], key.device)
    dec["conv_out"] = nn.conv_init(ks[ki], 3, 3, cfg.dec_ch[-1], 3)
    params["decoder"] = dec
    return params


class _Block(tnn.Module):
    """``x + conv2(silu(conv1(silu(x))))``, a 1×1 skip where channels change."""

    def __init__(self, p: Params):
        super().__init__()
        self.conv1, self.conv2 = nn.Conv(p["conv1"]), nn.Conv(p["conv2"])
        self.skip = nn.Conv(p["skip"]) if p.get("skip") is not None else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(F.silu(self.conv1(F.silu(x))))
        return (x if self.skip is None else self.skip(x)) + h


class NativeDecoder(tnn.Module):
    """The norm-free decoder of :func:`init_bsq`: conv_in, stages of
    residual blocks each followed (all but the last) by a nearest ×2 and a
    3×3 conv, LayerNorm over channels, SiLU, conv_out."""

    def __init__(self, dec: Params, compute_dtype: Any):
        super().__init__()
        self.dt = compute_dtype
        self.conv_in = nn.Conv(dec["conv_in"])
        self.stages = tnn.ModuleList()
        for stage in dec["stages"]:
            m = tnn.Module()
            m.blocks = tnn.ModuleList(_Block(b) for b in stage["blocks"])
            m.up = nn.Conv(stage["up"]) if "up" in stage else None
            self.stages.append(m)
        self.register_buffer("norm_scale", dec["norm_out"]["scale"])
        self.register_buffer("norm_bias", dec["norm_out"]["bias"])
        self.conv_out = nn.Conv(dec["conv_out"])

    def forward(self, f_hat: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(f_hat.to(self.dt))
        for stage in self.stages:
            for blk in stage.blocks:
                x = blk(x)
            if stage.up is not None:
                x = stage.up(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))
        x = nn.layer_norm(x, {"scale": self.norm_scale, "bias": self.norm_bias})
        x = self.conv_out(F.silu(x))
        return (x.to(torch.float32).clamp(-1.0, 1.0) + 1.0) / 2.0


class BSQ(tnn.Module):
    """φ convs and decoder of one BSQ parameter tree, as buffers."""

    def __init__(self, cfg: BSQConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        phi = params["phi"]
        if "kernel" not in phi:
            q8 = phi.get("kernel_q8", {}).get("q8")
            raise ValueError(
                f"the BSQ φ convs are stored int8 ({tuple(q8.shape) if q8 is not None else sorted(phi)}): φ must "
                "stay float, as the JAX package's phi_apply reads params['phi']['kernel']; keep the base_quant "
                f"min_size above φ's {q8.numel() if q8 is not None else 0} elements")
        self.phi = tnn.ModuleList(nn.Conv({"kernel": phi["kernel"][k], "bias": phi["bias"][k]})
                                  for k in range(phi["kernel"].shape[0]))
        dec = params["decoder"]
        self.decoder = (CompVisDecoder(dec, cfg.compute_dtype) if "mid" in dec
                        else NativeDecoder(dec, cfg.compute_dtype))


def bits_to_vec(bits: torch.Tensor, C: int) -> torch.Tensor:
    """{0, 1} bits ``[..., C]`` → the spherical code ±1/√C, f32."""
    return (2.0 * bits.to(torch.float32) - 1.0) / math.sqrt(C)


def vec_to_bits(v: torch.Tensor) -> torch.Tensor:
    """Sign-quantize features to {0, 1} bits (int32)."""
    return (v > 0).to(torch.int32)


def phi_index(cfg: BSQConfig, si: int) -> int:
    """φ conv of scale ``si``: ``round(si / (S-1) · (K-1))``, Python's
    rounding (half to even)."""
    S, K = cfg.num_scales, cfg.phi_partial
    if S <= 1:
        return 0
    return int(round(si / (S - 1) * (K - 1)))


def phi_apply(vq: BSQ, h: torch.Tensor, si: int) -> torch.Tensor:
    """Residual blend ``0.5·h + 0.5·conv_k(h)``, ``k = phi_index(si)``."""
    return 0.5 * h + 0.5 * vq.phi[phi_index(vq.cfg, si)](h)


def accumulate_scale(vq: BSQ, f_hat: torch.Tensor, bits: torch.Tensor, si: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One generation-side pyramid step: scale ``si``'s bits ``[B, pn², C]``
    upsampled to the full grid, blended by φ and added to f̂ ``[B, pN, pN,
    C]`` → ``(f̂', next scale's input)`` (f̂' itself after the last scale)."""
    cfg = vq.cfg
    B, pn = f_hat.shape[0], cfg.patch_nums[si]
    h = up_bicubic(bits_to_vec(bits, cfg.bits).reshape(B, pn, pn, cfg.bits), cfg.grid)
    f_hat = f_hat + phi_apply(vq, h.to(f_hat.dtype), si)
    nxt = down_area(f_hat, cfg.patch_nums[si + 1]) if si + 1 < cfg.num_scales else f_hat
    return f_hat, nxt


def encode_to_scales(vq: BSQ, f: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Greedy residual bitwise encoding of ``f [B, pN, pN, C]`` → (per-scale
    bits ``[B, pn², C]``, f̂)."""
    cfg = vq.cfg
    B = f.shape[0]
    f_hat = torch.zeros_like(f)
    out: List[torch.Tensor] = []
    for si, pn in enumerate(cfg.patch_nums):
        bits = vec_to_bits(down_area(f - f_hat, pn)).reshape(B, pn * pn, cfg.bits)
        out.append(bits)
        f_hat, _ = accumulate_scale(vq, f_hat, bits, si)
    return out, f_hat


def decode_img(vq: BSQ, f_hat: torch.Tensor) -> torch.Tensor:
    """f̂ ``[B, pN, pN, C]`` → images ``[B, H, W, 3]`` in [0, 1], f32."""
    return vq.decoder(f_hat)
