"""KL-VAE decoder (SD-style f8) with conv LoRA on its convs.

Port of ``hyperscalees_t2i_tpu/models/vaekl.py``: the decoder of the
diffusers ``AutoencoderKL`` that Z-Image decodes through, GroupNorm
res-blocks, a single-head mid self-attention, nearest ×2 up-stages, every
``conv1``/``conv2``/``conv_out`` a target of the second evolvable adapter
(``VAE_DECODER_LORA_TARGETS``; ``models.nn.conv_lora_delta``).

:func:`init_decoder` builds the JAX package's tree; :class:`KLDecoder` holds
it as buffers. On the int8 base the 1×1 convs (res-block skips, the mid
attention's fused q/k/v and its projection, ``post_quant``) run K1, the 3×3
convs dequantize at the use site (``models.nn.Conv``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn as tnn

from ..lora import LoRASpec, lookup
from ..utils import threefry
from . import nn
from .msvq import GroupNorm

Params = Dict[str, Any]

VAE_DECODER_LORA_TARGETS: Tuple[str, ...] = (r"conv1", r"conv2", r"conv_out")


@dataclasses.dataclass(frozen=True)
class VAEDecoderConfig:
    latent_channels: int = 16
    ch: Tuple[int, ...] = (512, 512, 256, 128)  # deepest → shallowest
    blocks_per_stage: int = 2
    mid_attn: bool = True
    scaling_factor: float = 0.3611
    shift_factor: float = 0.1159
    compute_dtype: Any = torch.bfloat16

    @property
    def spatial_factor(self) -> int:
        return 2 ** (len(self.ch) - 1)

    def lora_spec(self, rank: int = 4, alpha: float = 8.0) -> LoRASpec:
        return LoRASpec(rank=rank, alpha=alpha, targets=VAE_DECODER_LORA_TARGETS)


def _res_init(key: torch.Tensor, cin: int, cout: int) -> Params:
    k1, k2, k3 = threefry.split(key, 3)
    dev = key.device
    p = {
        "norm1": nn.norm_init(cin, dev),
        "conv1": nn.conv_init(k1, 3, 3, cin, cout),
        "norm2": nn.norm_init(cout, dev),
        "conv2": nn.conv_init(k2, 3, 3, cout, cout),
    }
    if cin != cout:
        p["skip"] = nn.conv_init(k3, 1, 1, cin, cout, bias=False)
    return p


def init_decoder(cfg: VAEDecoderConfig, key: torch.Tensor) -> Params:
    """The JAX package's ``init_decoder`` draws on the key's device."""
    ks = iter(threefry.split(key, 64))
    c0 = cfg.ch[0]
    dev = key.device
    p: Params = {"conv_in": nn.conv_init(next(ks), 3, 3, cfg.latent_channels, c0)}
    p["mid"] = {"res1": _res_init(next(ks), c0, c0), "res2": _res_init(next(ks), c0, c0)}
    if cfg.mid_attn:
        p["mid"]["attn"] = {
            "norm": nn.norm_init(c0, dev),
            "qkv": nn.conv_init(next(ks), 1, 1, c0, 3 * c0),
            "proj": nn.conv_init(next(ks), 1, 1, c0, c0),
        }
    stages = []
    prev = c0
    for s, c in enumerate(cfg.ch):
        stage: Params = {"blocks": [_res_init(next(ks), prev if b == 0 else c, c) for b in range(cfg.blocks_per_stage)]}
        if s < len(cfg.ch) - 1:
            stage["up"] = nn.conv_init(next(ks), 3, 3, c, c)
        stages.append(stage)
        prev = c
    p["stages"] = stages
    p["norm_out"] = nn.norm_init(cfg.ch[-1], dev)
    p["conv_out"] = nn.conv_init(next(ks), 3, 3, cfg.ch[-1], 3)
    return p


class ResBlock(tnn.Module):
    """GroupNorm → SiLU → conv (LoRA-adaptable), twice; a 1×1 skip where
    channels change. ``path`` is the block's adapter path prefix."""

    def __init__(self, p: Params, path: str):
        super().__init__()
        self.path = path
        self.norm1, self.conv1 = GroupNorm(p["norm1"]), nn.Conv(p["conv1"])
        self.norm2, self.conv2 = GroupNorm(p["norm2"]), nn.Conv(p["conv2"])
        self.skip = nn.Conv(p["skip"]) if "skip" in p else None

    def forward(self, x: torch.Tensor, lora: Optional[Params], lora_scale: float) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)), lookup(lora, f"{self.path}/conv1"), lora_scale)
        h = self.conv2(F.silu(self.norm2(h)), lookup(lora, f"{self.path}/conv2"), lora_scale)
        return (x if self.skip is None else self.skip(x)) + h


class MidAttn(tnn.Module):
    """Single-head self-attention over H·W: fused 1×1 q/k/v (output channels
    grouped (q, k, v)), f32 logits and softmax scaled by ``1/√C``, the
    probabilities in x's dtype against v, a 1×1 projection, residual."""

    def __init__(self, p: Params):
        super().__init__()
        self.norm, self.qkv, self.proj = GroupNorm(p["norm"]), nn.Conv(p["qkv"]), nn.Conv(p["proj"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        qkv = self.qkv(self.norm(x)).reshape(B, H * W, 3, C)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        f32 = torch.float32
        # f32(√C) is the f64 root rounded once (the JAX package's jnp.sqrt(f32(C)))
        logits = torch.einsum("bqc,bkc->bqk", q.to(f32), k.to(f32)) / math.sqrt(C)
        attn = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bqk,bkc->bqc", attn, v).reshape(B, H, W, C)
        return x + self.proj(out)


class Stage(tnn.Module):
    def __init__(self, p: Params, s: int):
        super().__init__()
        self.blocks = tnn.ModuleList(ResBlock(b, f"stages/{s}/blocks/{i}") for i, b in enumerate(p["blocks"]))
        self.up = nn.Conv(p["up"]) if "up" in p else None

    def forward(self, x: torch.Tensor, lora: Optional[Params], lora_scale: float) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x, lora, lora_scale)
        if self.up is not None:
            # nearest ×2 (jax.image.resize "nearest" at an integer ratio)
            x = self.up(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))
        return x


class KLDecoder(tnn.Module):
    """The decoder of one parameter tree (``post_quant`` optional)."""

    def __init__(self, cfg: VAEDecoderConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self.post_quant = nn.Conv(params["post_quant"]) if "post_quant" in params else None
        self.conv_in = nn.Conv(params["conv_in"])
        mid = params["mid"]
        self.res1 = ResBlock(mid["res1"], "mid/res1")
        self.attn = MidAttn(mid["attn"]) if "attn" in mid else None
        self.res2 = ResBlock(mid["res2"], "mid/res2")
        self.stages = tnn.ModuleList(Stage(st, s) for s, st in enumerate(params["stages"]))
        self.norm_out = GroupNorm(params["norm_out"])
        self.conv_out = nn.Conv(params["conv_out"])


def decode(model: KLDecoder, latents: torch.Tensor, lora: Optional[Params] = None,
           lora_scale: float = 1.0) -> torch.Tensor:
    """Scaled latents ``[R, h, w, C]`` → images ``[R, 8h, 8w, 3]`` f32 in
    [0, 1]; ``lora`` the decoder's adapter (one, or lane-stacked over ``R``'s
    lane-major rows)."""
    cfg = model.cfg
    z = (latents.to(torch.float32) / cfg.scaling_factor + cfg.shift_factor).to(cfg.compute_dtype)
    if model.post_quant is not None:
        z = model.post_quant(z)
    x = model.conv_in(z)
    x = model.res1(x, lora, lora_scale)
    if model.attn is not None:
        x = model.attn(x)
    x = model.res2(x, lora, lora_scale)
    for stage in model.stages:
        x = stage(x, lora, lora_scale)
    x = F.silu(model.norm_out(x))
    x = model.conv_out(x, lookup(lora, "conv_out"), lora_scale)
    return (torch.clamp(x.to(torch.float32), -1.0, 1.0) + 1.0) / 2.0
